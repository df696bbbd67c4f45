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
from repro.kernels.slstm import hbm_traffic_model as jax_hbm_traffic_model
from repro.kernels.slstm import slstm_fused as jax_slstm_fused
from repro.models import xlstm as jax_xlstm
from repro.models.attention import flash_attention as jax_model_flash_attention
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.com_matmul import com_matmul, com_matmul_padded
from repro_torch.kernels.conv2d_com import conv2d_com
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.slstm import hbm_traffic_model, slstm_fused


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
    assert _build.all_kernels() == ("com_matmul", "conv2d_com", "flash_attention", "slstm")
    targets = {_build._target(n) for n in _build.all_kernels()}
    assert len(targets) == 4
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


# ---------------- the sLSTM recurrence ----------------


def _slstm_inputs(seed, b, s, d, h, dtype="float32"):
    """x (B, S, D) and the reference's init_slstm parameters, as numpy, and
    the gate pre-activations gx = x @ wg + bg in ``dtype`` on both sides."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    params, _ = jax_xlstm.init_slstm(jax.random.PRNGKey(seed), d, h)
    p = {k: np.array(v) for k, v in params.items()}
    (xj, xt), (wj, wt), (bj, bt) = (_both(a, dtype) for a in (x, p["wg"], p["bg"]))
    gx_j = (jnp.einsum("bsd,dk->bsk", xj, wj) + bj).reshape(b, s, 4, d)
    gx_t = (xt @ wt + bt).reshape(b, s, 4, d)
    return params, p, (xj, xt), (gx_j, gx_t)


# (s, d, h, chunk): the space tests/test_kernels.py:125-142 samples from, S a
# multiple of the Pallas kernel's chunk
SLSTM_KERNEL_CASES = [(32, 32, 2, 8), (64, 64, 4, 16), (32, 64, 2, 32), (64, 32, 4, 8)]


@pytest.mark.parametrize("s,d,h,chunk", SLSTM_KERNEL_CASES)
def test_slstm_ref_matches_jax_kernel(s, d, h, chunk):
    params, _, _, (gx_j, gx_t) = _slstm_inputs(s + d, 2, s, d, h)
    want = jax_slstm_fused(gx_j, params["rg"], h, chunk=chunk, interpret=True)
    got, state = ops.slstm(gx_t, torch.from_numpy(np.array(params["rg"])), h)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, s, d)
    assert all(t.shape == (2, h, d // h) and t.dtype == torch.float32 for t in state)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-4, atol=2e-4)
    # the final h of the state is the last step's output, before rounding
    np.testing.assert_allclose(state[2].reshape(2, d).numpy(), _np(want)[:, -1],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 2e-2)])
def test_slstm_ref_matches_jax_scan_at_a_ragged_length(dtype, tol):
    """S = 37 (no chunk divides it): the output projection of h and the final
    (c, n, h, m) against xlstm.slstm_forward(return_state=True)."""
    b, s, d, h = 2, 37, 64, 4
    params, p, (xj, _), (_, gx_t) = _slstm_inputs(7, b, s, d, h, dtype)
    want, want_state = jax_xlstm.slstm_forward(params, xj, h, return_state=True)
    hs, state = ref.slstm_ref(gx_t, torch.from_numpy(p["rg"]), h)
    assert hs.dtype == gx_t.dtype
    got = hs @ _both(p["wo"], dtype)[1]
    for g, w in [(got, want)] + [(t, want_state[k]) for t, k in zip(state, "cnhm")]:
        g, w = _np(g), _np(w)
        assert g.shape == w.shape and np.isfinite(g).all()
        assert np.abs(g - w).max() <= tol * np.abs(w).max()


def test_log_sigmoid_is_stable_and_matches_jax():
    x = np.array([-1000.0, -100.0, -88.5, -20.0, -1.0, 0.0, 1.0, 30.0, 1000.0], np.float32)
    got = ref.log_sigmoid(torch.from_numpy(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(jax.nn.log_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


def test_slstm_on_cpu_is_the_plain_version_and_checks_shapes():
    _, p, _, (_, gx) = _slstm_inputs(1, 1, 9, 32, 2)
    rg = torch.from_numpy(p["rg"])
    before = slstm_fused.launches
    want_h, want_state = ref.slstm_ref(gx, rg, 2)
    for backend in (None, "ref"):
        h, state = ops.slstm(gx, rg, 2, backend=backend)
        assert torch.equal(h, want_h) and all(map(torch.equal, state, want_state))
    assert slstm_fused.launches == before
    with pytest.raises(RuntimeError, match="CUDA device"):
        ops.slstm(gx, rg, 2, backend="cuda")
    with pytest.raises(ValueError, match="not \\(B, S, 4, D\\)"):
        slstm_fused(gx[:, :, :3], rg, 2)
    with pytest.raises(ValueError, match="split"):
        slstm_fused(gx, rg, 3)
    with pytest.raises(ValueError, match="rg"):
        slstm_fused(gx, rg[:, :1], 2)
    with pytest.raises(ValueError, match="empty"):
        slstm_fused(gx[:, :0], rg, 2)


@pytest.mark.parametrize("b,s,d,h,dtype_bytes", [(16, 4096, 1024, 4, 2), (1, 517, 1024, 4, 4),
                                                 (2, 37, 128, 4, 2)])
def test_slstm_traffic_model_is_the_reference(b, s, d, h, dtype_bytes):
    assert hbm_traffic_model(b, s, d, h, dtype_bytes) == jax_hbm_traffic_model(
        b, s, d, h, dtype_bytes)
