"""The port's whole-program executor against the JAX package's.

The port's ``"reference"`` backend (float64 block chains) on the CPU is
held against the JAX ``"numpy"`` oracle on VGG-11 at B=2 with
tests/test_executor.py:79's rtol 1e-9 / atol 1e-12, and against the JAX
``"jax"`` backend (the Pallas kernel in interpret mode) on a small
multi-block workload with tests/test_executor.py:87's
``atol = 2e-5 · max|ref|``. The port's float32 kernel path
(``com_forward``) runs here on its plain ``com_matmul`` version and is
held to the same bound. The ``"cuda"`` backend is held against the
``"reference"`` backend on the card in tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

import repro.core.executor as jex
import repro.core.mapping as jmap
import repro.core.program as jprog
import repro.core.simulator as jsim
import repro_torch.core.executor as tex
import repro_torch.core.mapping as tmap
import repro_torch.core.program as tprog
import repro_torch.core.simulator as tsim
from repro.core.arch import DEFAULT_ARCH as J_ARCH
from repro_torch.convert import from_port, kernel_shape, to_port
from repro_torch.core.arch import DEFAULT_ARCH as T_ARCH

SMALL = dict(n_c=8, n_m=8)


def _multiblock(m):
    """conv(pool)→conv→flatten→FC→FC with C > n_c and M > n_m at n_c =
    n_m = 8 (tests/test_executor.py:49-61)."""
    return m.ConvSpec("c0", 3, 3, 12, 8, 8, pool_k=2), m.ConvSpec("c1", 3, 12, 10, 4, 4), \
        m.FCSpec("f0", 160, 20), m.FCSpec("f1", 20, 5)


@pytest.fixture(scope="module")
def vgg11():
    jp = jprog.compile_program(jmap.vgg11_cifar())
    tp = tprog.compile_program(tmap.vgg11_cifar())
    weights = jex.random_weights(jp, seed=1)
    images = np.random.default_rng(0).normal(size=(2, 32, 32, 3))
    want = jp.execute(images, weights, backend="numpy")
    return jp, tp, weights, images, want


@pytest.fixture(scope="module")
def multiblock():
    jp = jprog.compile_program(jprog.Workload("mb", _multiblock(jmap)), J_ARCH.replace(**SMALL))
    tp = tprog.compile_program(tprog.Workload("mb", _multiblock(tmap)), T_ARCH.replace(**SMALL))
    assert any(lp.c_blocks > 1 for lp in tp.layer_programs)
    assert any(lp.m_blocks > 1 for lp in tp.layer_programs)
    weights = jex.random_weights(jp, seed=100)
    images = np.random.default_rng(42).normal(size=(3, 8, 8, 3))
    want_np = jp.execute(images, weights, backend="numpy").outputs
    want_jax = jp.execute(images, weights, backend="jax", interpret=True).outputs
    return jp, tp, weights, images, want_np, want_jax


def test_vgg11_reference_matches_jax_numpy_oracle(vgg11):
    jp, tp, weights, images, want = vgg11
    res = tp.execute(images, weights, backend="reference", device="cpu")
    assert res.outputs.dtype == torch.float64 and tuple(res.outputs.shape) == (2, 10)
    np.testing.assert_allclose(res.outputs.numpy(), want.outputs, rtol=1e-9, atol=1e-12)
    assert res.events == dict(want.events) == dict(tp.event_totals)
    assert res.events["pool_cmp"] > 0


def test_vgg11_kernel_path_on_cpu_matches_jax_numpy_oracle(vgg11):
    jp, tp, weights, images, want = vgg11
    ws = to_port(tp.workload, weights, dtype=torch.float32, device="cpu")
    got = tex.com_forward(tp, ws, torch.as_tensor(images, dtype=torch.float32))
    assert got.dtype == torch.float32
    scale = np.abs(want.outputs).max()
    np.testing.assert_allclose(got.double().numpy(), want.outputs, atol=2e-5 * scale)


def test_multiblock_reference_matches_both_jax_backends(multiblock):
    jp, tp, weights, images, want_np, want_jax = multiblock
    got = tp.execute(images, weights, backend="reference", device="cpu").outputs.numpy()
    np.testing.assert_allclose(got, want_np, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got, want_jax, atol=2e-5 * max(np.abs(got).max(), 1e-30))


def test_multiblock_kernel_path_on_cpu_matches_jax_kernel_backend(multiblock):
    jp, tp, weights, images, want_np, want_jax = multiblock
    ws = to_port(tp.workload, weights, dtype=torch.float32, device="cpu")
    got = tex.com_forward(tp, ws, torch.as_tensor(images, dtype=torch.float32))
    scale = max(np.abs(want_np).max(), 1e-30)
    np.testing.assert_allclose(got.double().numpy(), want_jax, atol=2e-5 * scale)
    np.testing.assert_allclose(got.double().numpy(), want_np, atol=2e-5 * scale)


def test_block_chain_helpers_match_jax_oracle():
    rng = np.random.default_rng(9)
    tl, jl = tmap.ConvSpec("solo", 3, 12, 10, 6, 6), jmap.ConvSpec("solo", 3, 12, 10, 6, 6)
    tp = tprog.compile_program(tprog.Workload("solo", (tl,)), T_ARCH.replace(**SMALL))
    jp = jprog.compile_program(jprog.Workload("solo", (jl,)), J_ARCH.replace(**SMALL))
    w, x = rng.normal(size=(3, 3, 12, 10)), rng.normal(size=(2, 6, 6, 12))
    got = tsim.run_conv_block_chain(tp.layer_programs[0], torch.from_numpy(w), torch.from_numpy(x))
    want = jsim.run_conv_block_chain(jp.layer_programs[0], w, x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    tf = tprog.compile_program(tprog.Workload("fc", (tmap.FCSpec("f", 20, 11),)), T_ARCH.replace(**SMALL))
    jf = jprog.compile_program(jprog.Workload("fc", (jmap.FCSpec("f", 20, 11),)), J_ARCH.replace(**SMALL))
    w, x = rng.normal(size=(20, 11)), rng.normal(size=(3, 20))
    got = tsim.run_fc_block_chain(tf.layer_programs[0], torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), jsim.run_fc_block_chain(jf.layer_programs[0], w, x),
                               rtol=1e-12, atol=1e-12)
    assert vars(tsim.conv_block_events(tp.layer_programs[0], tp.arch)) == vars(
        jsim.conv_block_events(jp.layer_programs[0], jp.arch))
    assert vars(tsim.fc_block_events(tf.layer_programs[0], tf.arch)) == vars(
        jsim.fc_block_events(jf.layer_programs[0], jf.arch))


@pytest.mark.parametrize("name,seed", [("vgg11-cifar", 0), ("vgg11-cifar", 7),
                                       ("vgg16-imagenet", 0), ("mb", 0), ("mb", 7)])
def test_random_weights_equal_jax_bit_for_bit(name, seed):
    if name == "mb":
        jw, tw = _multiblock(jmap), _multiblock(tmap)
    else:
        jw, tw = jmap.NETWORKS[name](), tmap.NETWORKS[name]()
    want = jex.random_weights(jw, seed=seed)
    got = tex.random_weights(tw, seed=seed)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k])


def test_convert_round_trips_and_uses_the_kernel_layout(vgg11):
    jp, tp, weights, _, _ = vgg11
    layers = tp.workload.layers
    ts = to_port(layers, weights, dtype=torch.float64, device="cpu")
    for l, t in zip(layers, ts):
        assert tuple(t.shape) == kernel_shape(l) and t.is_contiguous()
        assert np.array_equal(t.numpy(), weights[l.name].reshape(kernel_shape(l)))
    back = from_port(layers, ts)
    assert list(back) == list(weights)
    for k in weights:
        assert np.array_equal(back[k], weights[k])
    aligned = to_port(layers, [weights[l.name] for l in layers], dtype=torch.float64, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(aligned, ts))
    f32 = to_port(layers, weights, dtype=torch.float32, device="cpu")
    assert all(t.dtype == torch.float32 for t in f32)
    # the same float64 -> float32 rounding as the JAX package's jnp.asarray
    assert np.array_equal(f32[0].numpy(), weights[layers[0].name].reshape(-1, 64).astype(np.float32))


def test_executor_validates_weights_and_inputs(vgg11):
    _, tp, weights, _, _ = vgg11
    wl = tp.workload
    bad = dict(weights)
    del bad[wl[0].name]
    with pytest.raises(KeyError, match="missing"):
        tp.executor(bad, backend="reference", device="cpu")
    bad = dict(weights)
    bad[wl[0].name] = np.zeros((3, 3, 3, 7))
    with pytest.raises(ValueError, match="weights shape"):
        tp.executor(bad, backend="reference", device="cpu")
    with pytest.raises(ValueError, match="weight arrays for"):
        tp.executor([weights[wl[0].name]], backend="reference", device="cpu")
    ex = tp.executor(weights, backend="reference", device="cpu")
    with pytest.raises(ValueError, match="images shape"):
        ex.run(np.zeros((2, 16, 16, 3)))
    with pytest.raises(ValueError, match="unknown executor backend"):
        tp.executor(weights, backend="numpy", device="cpu")


def test_non_chaining_workload_rejected():
    wl = tprog.Workload("broken", (tmap.ConvSpec("c0", 3, 3, 8, 8, 8),
                                   tmap.ConvSpec("c1", 3, 9, 8, 8, 8)))
    with pytest.raises(ValueError, match="not an executable"):
        tprog.compile_program(wl).executor(tex.random_weights(wl), backend="reference",
                                           device="cpu")


def test_residual_workloads_are_rejected_for_now():
    program = tprog.compile_program(tmap.resnet18_cifar())
    with pytest.raises(NotImplementedError, match="residual"):
        program.executor(tex.random_weights(program), backend="reference", device="cpu")


def test_cuda_backend_never_runs_on_the_cpu(vgg11, monkeypatch):
    _, tp, weights, _, _ = vgg11
    with pytest.raises(ValueError, match="CUDA device"):
        tp.executor(weights, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("cuda", "reference"):  # device=None means the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.executor(weights, backend=backend)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        to_port(tp.workload, weights)


def test_batched_equals_stacked_and_single_image_convenience(vgg11):
    _, tp, weights, images, _ = vgg11
    ex = tp.executor(weights, backend="reference", device="cpu")
    batched = ex(images)
    stacked = torch.cat([ex(images[i]) for i in range(len(images))])
    assert torch.allclose(batched, stacked, rtol=0, atol=1e-12)
    assert ex.run(images[0]).batch == 1


def test_fc_only_program():
    wl = tprog.Workload("fcs", (tmap.FCSpec("a", 12, 7), tmap.FCSpec("b", 7, 3)))
    program = tprog.compile_program(wl)
    weights = tex.random_weights(program, seed=3)
    x = np.random.default_rng(1).normal(size=(12,))
    res = program.execute(x, weights, backend="reference", device="cpu")
    assert tuple(res.outputs.shape) == (1, 3)
    want = np.maximum(np.maximum(x @ weights["a"], 0) @ weights["b"], 0)
    np.testing.assert_allclose(res.outputs[0].numpy(), want, rtol=1e-12)


# -------------------- the batch split over devices (shard=) --------------------
CPU = torch.device("cpu")


@pytest.mark.parametrize("n_dev", [2, 3])
def test_sharded_com_forward_pads_and_matches_both_references(vgg11, n_dev):
    """The split path on [cpu] * n_dev with B = 5 (padded to a multiple):
    each shard's rows are com_forward's on that shard bit for bit, and the
    whole is within the executor tolerance of the unsharded path and of the
    JAX package's numpy backend."""
    jp, tp, weights, _, _ = vgg11
    images = np.random.default_rng(5).normal(size=(5, 32, 32, 3))
    want = jp.execute(images, weights, backend="numpy").outputs
    ws = to_port(tp.workload, weights, dtype=torch.float32, device="cpu")
    x = torch.as_tensor(images, dtype=torch.float32)
    got = tex.sharded_forward(tex.com_forward, tp, {CPU: ws}, x, [CPU] * n_dev)
    assert tuple(got.shape) == (5, 10) and got.dtype == torch.float32
    per = -(-5 // n_dev)
    padded = torch.cat([x, x.new_zeros((per * n_dev - 5,) + tuple(x.shape[1:]))])
    for i in range(n_dev):
        shard = tex.com_forward(tp, ws, padded[i * per:(i + 1) * per])
        assert torch.equal(got[i * per:(i + 1) * per], shard[:max(0, min(per, 5 - i * per))])
    scale = np.abs(want).max()
    full = tex.com_forward(tp, ws, x)
    np.testing.assert_allclose(got.double().numpy(), full.double().numpy(), atol=2e-5 * scale)
    np.testing.assert_allclose(got.double().numpy(), want, atol=2e-5 * scale)


def test_sharded_reference_forward_matches_the_jax_oracle(multiblock):
    """The split logic is the forward's own: the float64 chain split over
    [cpu, cpu] keeps the reference's 1e-9 agreement (B = 3: one pad row)."""
    jp, tp, weights, images, want_np, _ = multiblock
    ws = to_port(tp.workload, weights, dtype=torch.float64, device="cpu")
    got = tex.sharded_forward(tex.reference_forward, tp, {CPU: ws},
                              torch.as_tensor(images), [CPU, CPU])
    np.testing.assert_allclose(got.numpy(), want_np, rtol=1e-9, atol=1e-12)


def test_shard_options_resolve_as_the_reference(vgg11, monkeypatch):
    """None/False are off; the reference backend refuses shard (the message
    names "cuda"); a bad value raises; "auto" on a one-card machine falls
    back to the unsharded path; n_shards rides on the result."""
    _, tp, weights, images, want = vgg11
    for off in (None, False):
        ex = tp.executor(weights, backend="reference", device="cpu", shard=off)
        assert ex.n_shards == 1 and ex.run(images).n_shards == 1
    for on in ("auto", "data", True, [CPU, CPU]):
        with pytest.raises(ValueError, match="requires backend='cuda'"):
            tp.executor(weights, backend="reference", device="cpu", shard=on)
    assert jex.ExecutionResult(outputs=None, events={}, backend="numpy", batch=1,
                               wall_s=1.0).n_shards == tex.ExecutionResult(
        outputs=None, events={}, backend="cuda", batch=1, wall_s=1.0).n_shards == 1
    # the "cuda" executor's resolution, without a card: a stand-in object
    stub = object.__new__(tex.ProgramExecutor)
    stub.backend, stub.device = "cuda", torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert stub._resolve_shard("auto") is None and stub._resolve_shard(True) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert stub._resolve_shard("data") == [torch.device("cuda", i) for i in range(4)]
    assert stub._resolve_shard(["cuda:0", "cuda:0"]) == [torch.device("cuda", 0)] * 2
    assert stub._resolve_shard([torch.device("cuda", 1)]) is None  # one device: fallback
    for bad in ("mesh", [CPU, CPU], []):
        with pytest.raises(ValueError, match="shard="):
            stub._resolve_shard(bad)
