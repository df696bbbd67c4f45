"""The port's CUDA kernels and its ``"cuda"`` executor backend on the card.

Every test here is marked ``gpu`` and takes the ``cuda`` fixture, which
skips where there is no card (the fixture decides, never the import). This
file imports nothing of JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py

Each kernel is held against its plain PyTorch version on the same inputs,
within 2e-5 (float32) or 2e-2 (bfloat16) of the plain result's largest
magnitude (tests/test_kernels.py:18-19); the executor's logits are held
against its float64 reference backend within 2e-5 · max|ref|
(tests/test_executor.py:87). ``slstm_fused`` is held within 2e-4 · max|plain|
(tests/test_kernels.py:142) in float32 and its final state, and each
bfloat16 element of h within one bfloat16 rounding plus that. TF32 is off in
the plain versions.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.arch import DEFAULT_ARCH
from repro_torch.core.executor import random_weights
from repro_torch.core.mapping import ConvSpec, FCSpec, vgg11_cifar
from repro_torch.core.program import Workload, compile_program
from repro_torch.kernels import ops, ref
from repro_torch.kernels.com_matmul import com_matmul
from repro_torch.kernels.com_matmul import plan as com_matmul_plan
from repro_torch.kernels.conv2d_com import conv2d_com
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.slstm import slstm_fused
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.serve.engine import Engine, Request

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run: "
                    "python -m pytest -m gpu tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _within(got, want, dtype):
    scale = want.double().abs().max().item()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    err = (got.double() - want.double()).abs().max().item()
    assert torch.isfinite(got).all() and err <= tol * scale, (err, tol, scale)


# one shape for each tile the kernel picks: skinny M, N <= 64, the full tile
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 300, 100), (100, 70, 50), (257, 129, 130)])
def test_com_matmul_kernel_matches_plain_version(cuda, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(m + k + n)
    x, w, b, r = (torch.randn(s, generator=gen, device=cuda).to(dtype)
                  for s in ((m, k), (k, n), (n,), (m, n)))
    for act in (None, "relu", "silu", "gelu"):
        for kw in (dict(), dict(bias=b, residual=r)):
            launches = com_matmul.launches
            got = com_matmul(x, w, activation=act, **kw)
            torch.cuda.synchronize()
            assert com_matmul.launches == launches + 1
            assert got.dtype == dtype and tuple(got.shape) == (m, n)
            _within(got, ref.com_matmul_ref(x, w, activation=act, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h,w,c,m,k,s,p", [(16, 10, 3, 8, 3, 1, 1), (12, 12, 20, 70, 5, 2, 2),
                                           (9, 13, 8, 64, 1, 1, 0)])
def test_conv2d_com_kernel_matches_plain_version(cuda, h, w, c, m, k, s, p, dtype):
    gen = torch.Generator(device=cuda).manual_seed(h * w + c)
    x = torch.randn((h, w, c), generator=gen, device=cuda).to(dtype)
    wt = torch.randn((k, k, c, m), generator=gen, device=cuda).to(dtype)
    for act in (None, "relu"):
        launches = conv2d_com.launches
        got = conv2d_com(x, wt, stride=s, padding=p, activation=act)
        torch.cuda.synchronize()
        assert conv2d_com.launches == launches + 1
        _within(got, ref.conv2d_com_ref(x, wt, stride=s, padding=p, activation=act), dtype)


# one shape for each path of the redesigned kernels: the streaming path with
# split-K (FC1), the tensor-core path with split-K (conv5's im2col product),
# a K = 27 tail (conv1's, whose rows are not 16-byte aligned), ragged N (1000,
# 70), and bf16 on the tensor cores
@pytest.mark.parametrize("m,k,n,dtype", [(8, 25088, 4096, torch.float32),
                                         (1568, 4608, 512, torch.float32),
                                         (1000, 27, 64, torch.float32),
                                         (300, 200, 1000, torch.float32),
                                         (130, 96, 70, torch.float32),
                                         (600, 512, 384, torch.bfloat16),
                                         (1568, 4608, 512, torch.bfloat16)],
                         ids=["fc-split-k", "mma-split-k", "k27", "n1000", "n70", "bf16",
                              "bf16-split-k"])
def test_com_matmul_paths_match_plain_version(cuda, m, k, n, dtype):
    gen = torch.Generator(device=cuda).manual_seed(k + n)
    x = torch.randn((m, k), generator=gen, device=cuda).relu().to(dtype)
    w = (torch.randn((k, n), generator=gen, device=cuda) * (2.0 / k) ** 0.5).to(dtype)
    b = torch.randn((n,), generator=gen, device=cuda).to(dtype)
    got = com_matmul(x, w, bias=b, activation="relu")
    torch.cuda.synchronize()
    _within(got, ref.com_matmul_ref(x, w, bias=b, activation="relu"), dtype)


@pytest.mark.parametrize("h,w,c,m,dtype", [(14, 14, 512, 512, torch.float32),
                                           (224, 224, 3, 64, torch.float32),
                                           (14, 14, 512, 512, torch.bfloat16)],
                         ids=["conv5", "conv1", "conv5-bf16"])
def test_conv2d_com_vgg16_layers_match_plain_version(cuda, h, w, c, m, dtype):
    gen = torch.Generator(device=cuda).manual_seed(h + c)
    x = torch.randn((h, w, c), generator=gen, device=cuda).to(dtype)
    wt = (torch.randn((3, 3, c, m), generator=gen, device=cuda) * (2.0 / (9 * c)) ** 0.5).to(dtype)
    got = conv2d_com(x, wt, activation="relu")
    torch.cuda.synchronize()
    _within(got, ref.conv2d_com_ref(x, wt, activation="relu"), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [8, 200], ids=["skinny", "mma"])
def test_com_matmul_carries_an_infinite_operand_like_the_plain_version(cuda, m, dtype):
    """An inf in x and a -inf in w, each meeting an exact 1.0 (whose 3xTF32
    small half is 0), and a near-overflow value: the same infinities, NaNs
    and finite values as com_matmul_ref, on the streaming (M <= 32) and the
    tensor-core (M > 32) paths."""
    k, n = 96, 40
    gen = torch.Generator(device=cuda).manual_seed(m)
    x = torch.randn((m, k), generator=gen, device=cuda)
    w = torch.randn((k, n), generator=gen, device=cuda) * 1e-3
    w[7, 3] = 1.0
    x[5, 7] = float("inf")
    x[6, 9] = 3.4028e38
    w[11, 20] = float("-inf")
    x, w = x.to(dtype), w.to(dtype)
    assert com_matmul_plan(m, n, k, dtype).path == ("skinny" if m <= 32 else "mma")
    got = com_matmul(x, w)
    torch.cuda.synchronize()
    want = ref.com_matmul_ref(x, w)
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    assert got[5].isinf().any() and got[:, 20].isinf().any()
    fin = want.isfinite()
    scale = want[fin].double().abs().max()
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert (got[fin].double() - want[fin].double()).abs().max() <= tol * scale


def test_split_k_calls_return_identical_bits(cuda):
    """Split-K adds its slices in a fixed order, with no atomics."""
    from repro_torch.kernels.com_matmul import plan
    from repro_torch.kernels.conv2d_com import plan as conv_plan

    gen = torch.Generator(device=cuda).manual_seed(7)
    x, w = torch.randn((1568, 4608), generator=gen, device=cuda), \
        torch.randn((4608, 512), generator=gen, device=cuda)
    fx, fw = torch.randn((8, 25088), generator=gen, device=cuda), \
        torch.randn((25088, 4096), generator=gen, device=cuda)
    img, wc = torch.randn((14, 14, 512), generator=gen, device=cuda), \
        torch.randn((3, 3, 512, 512), generator=gen, device=cuda)
    assert plan(1568, 512, 4608, torch.float32).splits > 1
    assert plan(8, 4096, 25088, torch.float32).splits > 1
    assert conv_plan(14, 14, 512, 3, 512, 1, 1, torch.float32).splits > 1
    for call in (lambda: com_matmul(x, w), lambda: com_matmul(fx, fw),
                 lambda: conv2d_com(img, wc)):
        first, second = call(), call()
        torch.cuda.synchronize()
        assert torch.equal(first, second)


def test_ops_route_cuda_tensors_to_the_kernels(cuda):
    x, w = torch.randn((64, 32), device=cuda), torch.randn((32, 16), device=cuda)
    img, wc = torch.randn((8, 8, 4), device=cuda), torch.randn((3, 3, 4, 8), device=cuda)
    before = (com_matmul.launches, conv2d_com.launches)
    ops.com_matmul(x, w)
    ops.conv2d(img, wc, backend="cuda")
    assert (com_matmul.launches, conv2d_com.launches) == (before[0] + 1, before[1] + 1)
    ops.com_matmul(x, w, backend="ref")
    ops.conv2d(img, wc, backend="ref")
    assert (com_matmul.launches, conv2d_com.launches) == (before[0] + 1, before[1] + 1)


def test_kernel_wrappers_check_layout_and_types(cuda):
    x = torch.ones((8, 8), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        com_matmul(x.t(), torch.ones((8, 4), device=cuda))
    with pytest.raises(TypeError):
        com_matmul(x, torch.ones((8, 4), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        com_matmul(x.double(), torch.ones((8, 4), device=cuda, dtype=torch.float64))
    with pytest.raises(ValueError, match="contiguous"):
        conv2d_com(torch.ones((4, 6, 2), device=cuda).transpose(0, 1),
                   torch.ones((3, 3, 2, 2), device=cuda))


def _programs():
    small = Workload("mb", (ConvSpec("c0", 3, 3, 12, 8, 8, pool_k=2),
                            ConvSpec("c1", 3, 12, 10, 4, 4),
                            FCSpec("f0", 160, 20), FCSpec("f1", 20, 5)))
    return [(compile_program(vgg11_cifar()), (2, 32, 32, 3)),
            (compile_program(small, DEFAULT_ARCH.replace(n_c=8, n_m=8)), (3, 8, 8, 3))]


@pytest.mark.parametrize("case", [0, 1], ids=["vgg11-cifar", "multiblock"])
def test_cuda_executor_matches_reference_on_the_card(cuda, case):
    program, shape = _programs()[case]
    weights = random_weights(program, seed=1)
    images = np.random.default_rng(0).normal(size=shape)
    want = program.execute(images, weights, backend="reference", device=cuda)
    com_matmul.launches = 0
    res = program.execute(images, weights)
    assert com_matmul.launches == len(program.layer_programs)
    assert res.outputs.device.type == "cuda" and res.outputs.dtype == torch.float32
    _within(res.outputs, want.outputs, torch.float32)
    assert res.events == dict(program.event_totals) == want.events


def _faulted_and_searched():
    """A multi-block program compiled around a fault set with weight faults,
    one compiled from a custom-blocked candidate, and the searched one."""
    from repro_torch.faults import BlockFault, FaultSet
    from repro_torch.search import greedy_candidate

    arch = DEFAULT_ARCH.replace(n_c=8, n_m=8)
    wl = _programs()[1][0].workload
    fs = FaultSet(dead_tiles=(2, 30), dead_links=(11,), cell_rate=0.03, cell_seed=4,
                  dead_blocks=(BlockFault(2, 0, 1, 2),), arch=arch)
    g = greedy_candidate(wl.layers, arch)
    halved = dataclasses.replace(g, block_c=(g.block_c[0], 4) + g.block_c[2:])
    return {"faulted": compile_program(wl, arch, faults=fs),
            "custom-blocking": compile_program(wl, arch, mapping=halved),
            "searched": compile_program(wl, arch, mapping="searched")}


@pytest.mark.parametrize("case", ["faulted", "custom-blocking", "searched"])
def test_faulted_and_searched_programs_on_the_card(cuda, case):
    program = _faulted_and_searched()[case]
    weights = random_weights(program, seed=100)
    images = np.random.default_rng(42).normal(size=(3, 8, 8, 3))
    ref_ex = program.executor(weights, backend="reference", device=cuda)
    want = ref_ex.run(images)
    com_matmul.launches = 0
    ex = program.executor(weights)
    res = ex.run(images)
    assert com_matmul.launches == len(program.layer_programs)
    # both backends consume the same faulted float64 list
    assert ex.fault_info == ref_ex.fault_info
    assert (ex.fault_info is not None) == (case == "faulted")
    for a, b in zip(ex.weights, ref_ex.weights):
        assert torch.equal(a, b.float())
    _within(res.outputs, want.outputs, torch.float32)
    assert res.events == dict(program.event_totals) == want.events


# (B, Sq, Skv, H, KVH, hd, causal): ragged lengths, GQA, causal and not, the
# three head sizes, Sq != Skv (top-left causal mask), and shapes whose plan
# splits the KV range (a second pass combines the splits)
FLASH_CASES = [
    (1, 128, 128, 9, 3, 64, True),
    (1, 77, 77, 9, 3, 64, True),
    (2, 200, 200, 4, 1, 64, False),
    (2, 130, 130, 4, 4, 128, True),
    (1, 65, 65, 2, 2, 128, False),
    (2, 50, 130, 6, 2, 64, True),
    (1, 130, 50, 6, 3, 128, True),
    (1, 100, 100, 4, 2, 32, True),
    (2, 70, 33, 2, 1, 32, False),
    (1, 1024, 1024, 9, 3, 64, True),
    (1, 1100, 1100, 2, 2, 32, True),
    (1, 1000, 1000, 2, 1, 128, False),
]
SPLIT_CASES = [c for c in FLASH_CASES if c[1] >= 700]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal", FLASH_CASES)
def test_flash_attention_kernel_matches_plain_version(cuda, b, sq, skv, h, kvh, hd, causal,
                                                      dtype):
    gen = torch.Generator(device=cuda).manual_seed(sq * skv + h)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, skv, kvh, hd), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    launches = flash_attention.launches
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    _within(got, want, dtype)
    if dtype == torch.bfloat16:  # both round one f32 result: within one rounding each element
        diff = (got.double() - want.double()).abs()
        limit = 2.0 ** -7 * want.double().abs() + 2e-5 * want.double().abs().max()
        assert (diff <= limit).all(), (diff / limit).max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd,causal", SPLIT_CASES)
def test_flash_attention_split_calls_return_identical_bits(cuda, b, sq, skv, h, kvh, hd, causal,
                                                           dtype):
    """The splits' partials are combined in split order, with no atomics."""
    from repro_torch.kernels.flash_attention import plan

    for dt in (torch.float32, torch.bfloat16):  # every split case splits in both types
        assert plan(b, sq, skv, h, kvh, hd, dt, causal).splits > 1
    gen = torch.Generator(device=cuda).manual_seed(sq + hd)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, skv, kvh, hd), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    first = flash_attention(q, k, v, causal=causal)
    second = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_flash_attention_routes_and_rejects(cuda):
    q = torch.randn((1, 16, 4, 64), device=cuda)
    k = torch.randn((1, 16, 2, 64), device=cuda)
    before = flash_attention.launches
    ops.flash_attention(q, k, k)
    ops.flash_attention(q, k, k, backend="ref")
    assert flash_attention.launches == before + 1
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                        k[..., :48].contiguous())
    with pytest.raises(ValueError, match="block_kv 128"):
        flash_attention(q, k, k, block_kv=128)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention(q.transpose(1, 2), k, k)
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), k)
    assert flash_attention.launches == before + 1


def test_greedy_batched_matches_sequential_on_the_card(cuda):
    # the reduced smollm as it is: head_dim 32
    cfg = get_config("smollm-135m").reduced()
    assert cfg.head_dim == 32
    model = build_model(cfg, CallConfig(), device=cuda, seed=0)
    rng = np.random.default_rng(0)

    def wave():
        return [Request(prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                        max_new_tokens=m) for n, m in ((5, 6), (70, 3), (9, 8), (33, 5), (1, 4))]

    eng = Engine(model, batch=2, max_seq=96)
    reqs = wave()
    ref_reqs = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens) for r in reqs]
    flash_attention.launches = 0
    got = eng.generate(reqs, seed=0)
    assert flash_attention.launches == cfg.num_layers * len(reqs)
    want = eng.generate_sequential(ref_reqs, seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == r.max_new_tokens for r in got)


# (B, S, H, hd): ragged S, B = 2, S = 1, the reduced test config's hd 32
# (a cluster of 1), hd 128 (a cluster of 2), xlstm-350m's hd 256 (a cluster
# of 8), an hd that is no multiple of a warp, and hd 512 (the stream path)
SLSTM_CASES = [(1, 37, 4, 32), (2, 130, 4, 32), (1, 1, 4, 32), (1, 517, 4, 256),
               (2, 64, 4, 256), (1, 1, 4, 256), (2, 45, 2, 128), (2, 19, 3, 40),
               (1, 20, 1, 512)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hd", SLSTM_CASES)
def test_slstm_fused_kernel_matches_plain_version(cuda, b, s, h, hd, dtype):
    gen = torch.Generator(device=cuda).manual_seed(s * hd + b)
    gx = torch.randn((b, s, 4, h * hd), generator=gen, device=cuda).to(dtype)
    rg = torch.randn((4, h, hd, hd), generator=gen, device=cuda) / hd ** 0.5
    launches = slstm_fused.launches
    got, state = slstm_fused(gx, rg, h)
    torch.cuda.synchronize()
    assert slstm_fused.launches == launches + 1
    assert got.dtype == dtype and tuple(got.shape) == (b, s, h * hd)
    want, want_state = ref.slstm_ref(gx, rg, h)
    diff = (got.double() - want.double()).abs()
    scale = want.double().abs().max()
    assert torch.isfinite(got).all()
    if dtype == torch.bfloat16:  # both round one f32 value a step
        limit = 2.0 ** -7 * want.double().abs() + 2e-4 * scale
        assert (diff <= limit).all(), (diff / limit).max().item()
    else:
        assert diff.max() <= 2e-4 * scale, (diff.max() / scale).item()
    for g, w in zip(state, want_state):  # c, n, h, m: float32 whatever gx's type
        assert g.dtype == torch.float32 and g.shape == (b, h, hd)
        assert (g.double() - w.double()).abs().max() <= 2e-4 * w.double().abs().max()


def test_slstm_plan_paths_on_the_card(cuda):
    from repro_torch.kernels.slstm import plan

    assert (plan(1, 9, 4, 32, torch.float32).cluster, plan(1, 9, 4, 256, torch.float32).cluster,
            plan(1, 9, 4, 512, torch.float32).path) == (1, 8, "stream")


def test_slstm_routes_and_rejects(cuda):
    gx = torch.randn((1, 8, 4, 64), device=cuda)
    rg = torch.randn((4, 2, 32, 32), device=cuda)
    before = slstm_fused.launches
    ops.slstm(gx, rg, 2)
    ops.slstm(gx, rg, 2, backend="ref")
    assert slstm_fused.launches == before + 1
    with pytest.raises(TypeError):
        slstm_fused(gx, rg.bfloat16(), 2)
    with pytest.raises(TypeError):
        slstm_fused(gx.double(), rg, 2)
    with pytest.raises(ValueError, match="contiguous"):
        slstm_fused(torch.randn((1, 8, 4, 128), device=cuda)[..., :64], rg, 2)
    with pytest.raises(ValueError, match="head_dim"):
        slstm_fused(torch.randn((1, 2, 4, 2048), device=cuda),
                    torch.randn((4, 1, 2048, 2048), device=cuda), 1)
    assert slstm_fused.launches == before + 1


def test_xlstm_greedy_batched_matches_sequential_on_the_card(cuda):
    cfg = get_config("xlstm-350m").reduced()
    model = build_model(cfg, CallConfig(), device=cuda, seed=0)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=m) for n, m in ((5, 6), (70, 3), (9, 8), (33, 5), (1, 4))]
    ref_reqs = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens) for r in reqs]
    eng = Engine(model, batch=2, max_seq=96)
    slstm_fused.launches = 0
    got = eng.generate(reqs, seed=0)
    assert slstm_fused.launches == cfg.num_layers // 2 * len(reqs)
    want = eng.generate_sequential(ref_reqs, seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == r.max_new_tokens for r in got)


# ---------------------------------------------------------------------------
# the Tab. IV evaluation and the sweep engine on the card (float64)
# ---------------------------------------------------------------------------

SWEEP_GRID = dict(networks=("vgg11-cifar", "resnet18-cifar", "llm:smollm-135m"),
                  chip_counts=(1, 7, 24), precisions=(8, 16), e_mac_pj=(0.02, 0.1),
                  tiles_per_chip=(120, 240), n_c=(128, 256), n_m=(64, 256),
                  node_nm=(45.0, 16.0), dataflow=("com", "minimal_buffer"))


@pytest.mark.parametrize("chunk_size", [None, 1000])
def test_torch_sweep_backend_on_the_card_matches_numpy(cuda, chunk_size):
    """The float64 column math on the card against the NumPy oracle within
    tests/test_sweep_backends.py:26's 1e-6, full grid and chunked; with no
    backend or device named, ``run_sweep`` is that backend on the card."""
    from repro_torch.sweep import COLUMNS, SweepGrid, make_torch_backend, run_sweep

    grid = SweepGrid(**SWEEP_GRID)
    want = run_sweep(grid, backend="numpy")
    for got in (run_sweep(grid, chunk_size=chunk_size),
                run_sweep(grid, backend=make_torch_backend(cuda), chunk_size=chunk_size)):
        assert got.backend == "torch"
        for c in COLUMNS:
            a, b = got.columns[c], want.columns[c]
            assert a.dtype == np.float64 and a.shape == (grid.n_scenarios,)
            err = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))
            assert err < 1e-6, (c, err)


def test_com_grid_sim_on_the_card_matches_reference_conv(cuda):
    """One VGG-16 conv at full width (14 x 14 x 512 -> 512, two C-blocks
    and two M-blocks) in float64 on the card, held to reference_conv at
    tests/test_simulator.py:39's rtol = atol = 1e-10."""
    from repro_torch.core.mapping import vgg16_imagenet
    from repro_torch.core.simulator import COMGridSim, conv_events, reference_conv

    program = compile_program(vgg16_imagenet())
    lp = program.layer_programs[10]
    L = lp.layer
    assert (L.h_in, L.c_in, L.c_out, lp.c_blocks, lp.m_blocks) == (14, 512, 512, 2, 2)
    rng = np.random.default_rng(5)
    w = rng.normal(size=(3, 3, 512, 512)) * (2.0 / (9 * 512)) ** 0.5
    x = rng.normal(size=(14, 14, 512))
    sim = COMGridSim.from_program(program, L.name, w)
    got = sim.run(x)
    assert got.device.type == "cuda" and got.dtype == torch.float64
    want = reference_conv(torch.as_tensor(x, device=cuda), torch.as_tensor(w, device=cuda), L)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    assert sim.ev == conv_events(L)
