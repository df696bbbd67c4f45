"""The port's kernels (repro_torch.kernels) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX Pallas kernel
in interpret mode and through the port's wrapper. Here, on the CPU, the
wrapper runs its plain PyTorch version, because the tensors lie on the
CPU. Tolerances are those of tests/test_kernels.py:18-19, rtol 2e-5 for
float32 and 2e-2 for bfloat16, with that file's atol. The CUDA kernels are
held against the plain versions on the card in tests/test_torch_gpu.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.com_matmul import com_matmul as jax_com_matmul
from repro.kernels.com_matmul import com_matmul_padded as jax_com_matmul_padded
from repro.kernels.conv2d_com import conv2d_com as jax_conv2d_com
from repro.kernels.flash_attention import flash_attention_gqa as jax_flash_attention_gqa
from repro.models.attention import flash_attention as jax_model_flash_attention
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.com_matmul import com_matmul, com_matmul_padded
from repro_torch.kernels.conv2d_com import conv2d_com
from repro_torch.kernels.flash_attention import flash_attention


def rtol_for(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _both(a, dtype):
    """One float32 numpy array as a JAX array and a torch tensor holding the
    same values (both round to bfloat16 to nearest even)."""
    a = np.asarray(a, dtype=np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y.astype(jnp.float32))


# (m, n, k, block_m, dtype, activation): the shape/epilogue space of
# tests/test_kernels.py:22-41, walked deterministically
COM_CASES = [
    (64, 64, 64, 32, "float32", None),
    (128, 128, 384, 64, "float32", "relu"),
    (256, 64, 128, 128, "float32", "silu"),
    (128, 128, 128, 128, "float32", "gelu"),
    (64, 128, 384, 32, "bfloat16", None),
    (256, 128, 64, 64, "bfloat16", "relu"),
    (128, 64, 128, 128, "bfloat16", "silu"),
    (64, 64, 384, 64, "bfloat16", "gelu"),
]


@pytest.mark.parametrize("m,n,k,bm,dtype,act", COM_CASES)
def test_com_matmul_matches_jax_kernel(m, n, k, bm, dtype, act):
    rng = np.random.default_rng(m * n + k)
    xj, xt = _both(rng.normal(size=(m, k)), dtype)
    wj, wt = _both(rng.normal(size=(k, n)), dtype)
    bj, bt = _both(rng.normal(size=(n,)), dtype)
    want = jax_com_matmul(xj, wj, bias=bj, activation=act, block_m=bm, interpret=True)
    got = com_matmul(xt, wt, bias=bt, activation=act)
    assert got.dtype == xt.dtype and got.shape == (m, n)
    np.testing.assert_allclose(
        _np(got), _np(want), rtol=rtol_for(dtype),
        atol=k * (0.05 if dtype == "bfloat16" else 1e-4))


def test_com_matmul_residual_epilogue_matches_jax_kernel():
    rng = np.random.default_rng(0)
    (xj, xt), (wj, wt), (rj, rt) = (
        _both(rng.normal(size=(128, 128)), "float32") for _ in range(3))
    want = jax_com_matmul(xj, wj, residual=rj, activation="relu", interpret=True)
    got = com_matmul(xt, wt, residual=rt, activation="relu")
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=128 * 1e-4)


def test_com_matmul_padded_unaligned_matches_jax_kernel():
    rng = np.random.default_rng(3)
    xj, xt = _both(rng.normal(size=(100, 70)), "float32")
    wj, wt = _both(rng.normal(size=(70, 50)), "float32")
    want = jax_com_matmul_padded(xj, wj, activation="relu", block_m=32, block_n=32,
                                 block_k=32, interpret=True)
    got = com_matmul_padded(xt, wt, activation="relu")
    assert got.shape == (100, 50)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=70 * 1e-4)


def test_gelu_is_the_tanh_form():
    # jax.nn.gelu defaults to the tanh approximation; torch's default is erf
    v = np.linspace(-4, 4, 257, dtype=np.float32)
    x = torch.from_numpy(v)[:, None]
    one = torch.ones((1, 1))
    got = ref.com_matmul_ref(x, one, activation="gelu")[:, 0].numpy()
    np.testing.assert_allclose(got, np.asarray(jax.nn.gelu(v, approximate=True)),
                               rtol=2e-5, atol=1e-6)
    exact = np.asarray(jax.nn.gelu(v, approximate=False))
    assert np.abs(got - exact).max() > 1e-4


# (h, w, c, m, k, stride, padding, dtype, activation): the space of
# tests/test_kernels.py:88-110, walked deterministically
CONV_CASES = [
    (8, 8, 3, 8, 3, 1, 1, "float32", None),
    (12, 10, 8, 32, 5, 2, 2, "float32", "relu"),
    (16, 8, 16, 8, 1, 1, 0, "float32", None),
    (16, 10, 3, 32, 3, 2, 0, "float32", "relu"),
    (12, 8, 16, 32, 3, 1, 2, "bfloat16", None),
    (8, 10, 8, 8, 5, 1, 1, "bfloat16", "relu"),
    (16, 10, 16, 32, 1, 2, 1, "bfloat16", None),
    (12, 10, 3, 8, 3, 2, 1, "bfloat16", "relu"),
]


@pytest.mark.parametrize("h,w,c,m,k,s,p,dtype,act", CONV_CASES)
def test_conv2d_com_matches_jax_kernel(h, w, c, m, k, s, p, dtype, act):
    rng = np.random.default_rng(h * w + c)
    xj, xt = _both(rng.normal(size=(h, w, c)), dtype)
    wj, wt = _both(rng.normal(size=(k, k, c, m)), dtype)
    want = jax_conv2d_com(xj, wj, stride=s, padding=p, activation=act, interpret=True)
    got = conv2d_com(xt, wt, stride=s, padding=p, activation=act)
    assert got.dtype == xt.dtype and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(
        _np(got), _np(want), rtol=rtol_for(dtype),
        atol=0.25 if dtype == "bfloat16" else 1e-4)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(32, 16)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    img = torch.from_numpy(rng.normal(size=(6, 6, 4)).astype(np.float32))
    wc = torch.from_numpy(rng.normal(size=(3, 3, 4, 5)).astype(np.float32))
    before = (com_matmul.launches, conv2d_com.launches)
    for backend in (None, "ref"):
        assert torch.equal(ops.com_matmul(x, w, activation="relu", backend=backend),
                           ref.com_matmul_ref(x, w, activation="relu"))
        assert torch.equal(ops.conv2d(img, wc, backend=backend), ref.conv2d_com_ref(img, wc))
    assert (com_matmul.launches, conv2d_com.launches) == before


def test_cuda_backend_request_raises_for_cpu_tensors():
    x, w = torch.ones((4, 4)), torch.ones((4, 4))
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.com_matmul(x, w, backend="cuda")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.conv2d(torch.ones((4, 4, 2)), torch.ones((3, 3, 2, 2)), backend="cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        ops.com_matmul(x, w, backend="interpret")


def test_wrappers_reject_what_the_kernels_do_not_take():
    x = torch.ones((4, 3))
    with pytest.raises(ValueError, match="unknown activation"):
        com_matmul(x, torch.ones((3, 2)), activation="tanh")
    with pytest.raises(ValueError, match="do not chain"):
        com_matmul(x, torch.ones((4, 2)))
    with pytest.raises(ValueError, match="activation"):
        conv2d_com(torch.ones((4, 4, 2)), torch.ones((3, 3, 2, 2)), activation="gelu")
    with pytest.raises(ValueError, match="not"):
        conv2d_com(torch.ones((4, 4, 2)), torch.ones((3, 3, 3, 2)))
    with pytest.raises(ValueError, match="does not fit"):
        conv2d_com(torch.ones((2, 2, 1)), torch.ones((5, 5, 1, 1)), padding=0)


def test_build_names_each_library_by_its_source_and_needs_nvcc(monkeypatch, tmp_path):
    assert _build.all_kernels() == ("com_matmul", "conv2d_com", "flash_attention")
    targets = {_build._target(n) for n in _build.all_kernels()}
    assert len(targets) == 3
    assert all(t.parent == _build.BUILD_DIR and t.suffix == ".so" for t in targets)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(_build.all_kernels(), force=True)


def _flash_inputs(seed, b, sq, skv, h, kvh, hd, dtype):
    rng = np.random.default_rng(seed)
    return (_both(rng.normal(size=(b, sq, h, hd)), dtype),
            _both(rng.normal(size=(b, skv, kvh, hd)), dtype),
            _both(rng.normal(size=(b, skv, kvh, hd)), dtype))


def _flash_tols(dtype):
    return dict(rtol=2e-2, atol=0.05) if dtype == "bfloat16" else dict(rtol=2e-5, atol=1e-5)


# (b, s, h, kvh, hd, block, causal, dtype): lengths that divide the Pallas
# kernel's block, GQA and MHA, causal and not (tests/test_kernels.py:55-74)
FLASH_KERNEL_CASES = [
    (1, 128, 4, 2, 64, 64, True, "float32"),
    (2, 128, 2, 2, 32, 128, False, "float32"),
    (1, 256, 6, 3, 64, 128, True, "bfloat16"),
    (2, 64, 4, 1, 128, 64, False, "bfloat16"),
]


@pytest.mark.parametrize("b,s,h,kvh,hd,blk,causal,dtype", FLASH_KERNEL_CASES)
def test_flash_attention_matches_jax_kernel(b, s, h, kvh, hd, blk, causal, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(s + hd, b, s, s, h, kvh, hd, dtype)
    want = jax_flash_attention_gqa(qj, kj, vj, causal=causal, block_q=blk, block_kv=blk,
                                   interpret=True)
    got = ops.flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_flash_tols(dtype))


# ragged lengths, which the Pallas kernel does not take: held to the model's
# blockwise attention, whose causal mask is also top-left aligned
FLASH_RAGGED_CASES = [
    (1, 77, 77, 9, 3, 64, True, "float32"),
    (2, 45, 45, 4, 4, 32, False, "float32"),
    (1, 20, 50, 6, 2, 64, True, "float32"),
    (2, 130, 130, 9, 3, 64, True, "bfloat16"),
    (1, 33, 70, 4, 2, 128, False, "bfloat16"),
]


@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal,dtype", FLASH_RAGGED_CASES)
def test_flash_attention_ragged_matches_jax_model_attention(b, sq, skv, h, kvh, hd, causal,
                                                            dtype):
    (qj, qt), (kj, kt), (vj, vt) = _flash_inputs(sq * skv, b, sq, skv, h, kvh, hd, dtype)
    want = jax_model_flash_attention(qj, kj, vj, causal=causal, block_kv=32)
    got = flash_attention(qt, kt, vt, causal=causal)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(_np(got), _np(want), **_flash_tols(dtype))


def test_flash_attention_on_cpu_is_the_plain_version_and_checks_shapes():
    (_, q), (_, k), (_, v) = _flash_inputs(0, 1, 9, 9, 4, 2, 32, "float32")
    before = flash_attention.launches
    for backend in (None, "ref"):
        assert torch.equal(ops.flash_attention(q, k, v, backend=backend),
                           ref.flash_attention_ref(q, k, v))
    assert flash_attention.launches == before
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.flash_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="does not serve"):
        kv3 = k[:, :, :1].expand(1, 9, 3, 32)  # 4 query heads do not group onto 3
        flash_attention(q, kv3, kv3)
    with pytest.raises(ValueError, match="empty"):
        flash_attention(q[:, :0], k, v)
