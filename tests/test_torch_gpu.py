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
import math

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
from repro_torch.models.frontend import synth_image_embeds, synth_tokens
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
    (1, 128, 128, 48, 8, 128, True),    # dbrx-132b's prefill attention
    (1, 512, 512, 48, 8, 128, True),
    (1, 1024, 1024, 32, 32, 64, True),  # zamba2-1.2b's shared block
    (2, 1, 1601, 64, 8, 128, False),    # llama-3.2-vision's cross layer, a decode step
    (1, 40, 1601, 8, 1, 128, False),    # a cross-layer prefill, GQA 8:1
    (1, 512, 512, 32, 32, 64, True),    # musicgen-large's prefill attention
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


def _ragged_wave(cfg):
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(1, cfg.vocab_size, size=n).astype(np.int32),
                    max_new_tokens=m) for n, m in ((5, 6), (70, 3), (9, 8), (33, 5), (2, 4))]


@pytest.mark.parametrize("arch", ["dbrx-132b", "zamba2-1.2b"])
def test_moe_and_hybrid_greedy_batched_matches_sequential_on_the_card(cuda, arch):
    """Reduced dbrx (drop-free capacity_factor = num_experts, as
    tests/test_serve.py:185 serves it) and reduced zamba2 on the card:
    Engine.generate == generate_sequential, every prefill through
    flash_attention (dbrx: one launch a layer; zamba2: one a group)."""
    cfg = get_config(arch).reduced()
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=float(cfg.moe.num_experts)))
    per_prefill = (cfg.num_layers // cfg.hybrid_attn_every if cfg.family == "hybrid"
                   else cfg.num_layers)
    model = build_model(cfg, CallConfig(), device=cuda, seed=0)
    eng = Engine(model, batch=2, max_seq=96)
    reqs = _ragged_wave(cfg)
    flash_attention.launches = 0
    got = eng.generate(reqs, seed=0)
    assert flash_attention.launches == per_prefill * len(reqs)
    oracle = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens) for r in reqs]
    want = eng.generate_sequential(oracle, seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]


@pytest.mark.parametrize("arch", ["llama-3.2-vision-90b", "musicgen-large"])
def test_vlm_and_audio_prefill_and_decode_on_the_card(cuda, arch):
    """Reduced llama-3.2-vision (4 layers: two groups of [self, cross], hd
    32) and reduced musicgen on the card: a prefill and two decode steps
    through the flash kernel against the same model with the plain attention
    (kernel_backend="ref"), every step's logits within 2e-5 (float32) or
    2e-2 (bfloat16) of max|plain|. flash_attention launches once for every
    attention layer of a prefill and, at Sq = 1, for every vlm cross layer of
    a decode step. The vlm also runs float32 on a bfloat16 cache: a decode
    step's cross K/V are then a cast copy of the cache slice."""
    cfg = get_config(arch).reduced()
    vlm = cfg.family == "vlm"
    if vlm:
        cfg = dataclasses.replace(cfg, num_layers=4)
    gen = torch.Generator(device=cuda).manual_seed(1)
    toks = synth_tokens(gen, cfg, 2, 18)
    kw = {"image_embeds": synth_image_embeds(gen, cfg, 2)} if vlm else {}
    per_step = cfg.num_layers // cfg.cross_attn_every if vlm else 0
    dtypes = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16)]
    if vlm:
        dtypes.append((torch.float32, torch.bfloat16))
    for compute, cache_dtype in dtypes:
        model = build_model(cfg, CallConfig(compute_dtype=compute, cache_dtype=cache_dtype),
                            device=cuda, seed=0)
        runs = {}
        for backend in (None, "ref"):
            model.cc = dataclasses.replace(model.cc, kernel_backend=backend)
            flash_attention.launches = 0
            lg, cache = model.prefill(toks[:, :16], model.init_cache(2, 24), **kw)
            launches = [flash_attention.launches]
            steps = [lg]
            for t in (16, 17):
                lg, cache = model.decode_step(toks[:, t:t + 1], cache, t)
                steps.append(lg)
                launches.append(flash_attention.launches)
            runs[backend] = steps, launches
        assert runs[None][1] == [cfg.num_layers, cfg.num_layers + per_step,
                                 cfg.num_layers + 2 * per_step]
        assert runs["ref"][1] == [0, 0, 0]
        for got, want in zip(runs[None][0], runs["ref"][0]):
            assert got.dtype == compute
            _within(got, want, compute)


def test_paged_zamba2_matches_contiguous_on_the_card(cuda):
    """A paged pool (KV rows in pages, Mamba2 states dense per slot) against
    the contiguous pool on the card: the same greedy tokens, and a decode
    step's logits bit for bit from the same prefills."""
    from repro_torch.serve import PagedSlotCache, init_slots

    cfg = get_config("zamba2-1.2b").reduced()
    model = build_model(cfg, CallConfig(), device=cuda, seed=0)
    runs = []
    for kw in ({}, dict(page_size=8, pool_pages=20)):
        runs.append([r.out_tokens for r in Engine(model, batch=2, max_seq=96, **kw)
                     .generate(_ragged_wave(cfg), seed=0)])
    assert runs[0] == runs[1]
    dense, paged = init_slots(model, 3, 40), PagedSlotCache(model, 3, 40, 8)
    rng = np.random.default_rng(1)
    for b, n in ((0, 17), (2, 30)):
        prompt = torch.as_tensor(rng.integers(1, cfg.vocab_size, size=(1, n)), device=cuda)
        _, one = model.prefill(prompt, model.init_cache(1, 40))
        paged.ensure_rows(b, n + 1)
        paged.write_prefill(b, one)
        dense.write_prefill(b, one)
    tok = torch.ones((3, 1), dtype=torch.long, device=cuda)
    pos = torch.tensor([17, 40, 30], device=cuda)
    view = paged.gather_dense()
    lp, _ = model.decode_step(tok, view, pos)
    paged.scatter_dense(view)
    ld, _ = model.decode_step(tok, dense.cache, pos)
    assert torch.equal(lp, ld)
    assert all(torch.equal(a, b) for a, b in zip(dense.cache, paged.gather_dense()))


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


# -------------------- streaming serving and the sharded batch --------------------
def _burst(n, **over):
    from repro_torch.serve import TrafficProfile

    base = dict(name="gpu-burst", num_requests=n, arrival="burst", burst_size=5, num_users=4,
                requests_per_user_tick=0.1, prompt_lens=[20, 40, 70], output_lens=[4, 8, 12],
                temperature=0.0, seed=0)
    base.update(over)
    return TrafficProfile.from_dict(base)


def test_paged_serve_matches_sequential_on_the_card(cuda):
    """Engine.serve on a paged cache smaller than the contiguous one, the
    reduced smollm on the card: the oracle replay is token-identical, and
    every prefill of the served run goes through flash_attention."""
    from repro_torch.serve import simulate

    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, CallConfig(), device=cuda, seed=0)
    profile = _burst(10, deadline=None)
    eng = Engine(model, batch=4, max_seq=profile.max_rows, page_size=8, pool_pages=16)
    assert eng.slots.pool_pages < 4 * eng.slots.pages_per_slot
    flash_attention.launches = 0
    payload = simulate(eng, profile, check=True)
    assert payload["matches_sequential"] and payload["n_accepted"] == 10
    # the served run's prefills and the oracle's, 2 layers each
    assert flash_attention.launches == cfg.num_layers * (payload["prefills"] + 10)
    assert eng.slots.allocator.n_held == 0


def test_faulted_float32_serve_is_identical_on_the_card(cuda):
    """In float32 a re-prefill's KV rows round within ~1e-6 of the decode
    steps' on the card: a faulted run gives the fault-free run's tokens."""
    from repro_torch.faults import TransientFaults
    from repro_torch.runtime.fault_tolerance import RestartPolicy
    from repro_torch.serve import AdmissionQueue, generate_arrivals

    cfg = get_config("smollm-135m").reduced()
    model = build_model(cfg, CallConfig(compute_dtype=torch.float32, cache_dtype=torch.float32),
                        device=cuda, seed=0)
    profile = _burst(10, deadline=None)
    eng = Engine(model, batch=4, max_seq=profile.max_rows, page_size=8, pool_pages=16)
    runs = []
    # chip_smoke.py's fault rates: 5 faults on this traffic, none three times
    # at one token (which the restart policy halts on, as a deterministic fault)
    for faults in (None, TransientFaults(slot_rate=0.05, page_rate=0.002, seed=0)):
        arrivals = generate_arrivals(profile, cfg.vocab_size)
        eng.serve(AdmissionQueue(arrivals, max_seq=eng.max_seq), seed=0, do_sample=False,
                  faults=faults, restart_policy=RestartPolicy(max_restarts=10_000,
                                                              backoff_mult=1.0))
        runs.append(([a.request.out_tokens for a in arrivals], dict(eng.last_stats)))
    assert runs[1][1]["faults_injected"] > 0
    assert runs[1][1]["makespan_ticks"] > runs[0][1]["makespan_ticks"]
    assert runs[0][0] == runs[1][0]


def test_sharded_executor_on_the_card(cuda):
    """shard=[cuda:0, cuda:0] drives the split path on one card (B = 5: a
    pad row): n_shards 2, a com_matmul launch per layer per shard, logits
    within the executor tolerance of the float64 reference; "auto" takes
    every visible card."""
    program, _ = _programs()[0]
    weights = random_weights(program, seed=1)
    images = np.random.default_rng(3).normal(size=(5, 32, 32, 3))
    want = program.execute(images, weights, backend="reference", device=cuda)
    dev = torch.device("cuda", 0)
    ex = program.executor(weights, shard=[dev, dev])
    com_matmul.launches = 0
    res = ex.run(images)
    assert ex.n_shards == res.n_shards == 2
    assert com_matmul.launches == 2 * len(program.layer_programs)
    assert tuple(res.outputs.shape) == (5, 10) and res.outputs.device.type == "cuda"
    _within(res.outputs, want.outputs, torch.float32)
    auto = program.executor(weights, shard="auto")
    count = torch.cuda.device_count()
    assert auto.n_shards == (count if count > 1 else 1)
    _within(auto.run(images).outputs, want.outputs, torch.float32)


# ---- training: the attention backward kernel and train steps on the card -------------

BWD_CASES = [
    (2, 517, 9, 3, 64, True),    # smollm-135m's heads, ragged S
    (1, 300, 4, 2, 32, True),    # the reduced configs' hd 32
    (1, 200, 4, 1, 128, True),   # hd 128, GQA 4:1
    (2, 130, 6, 3, 64, False),   # non-causal
    (1, 2048, 9, 3, 64, True),   # the train shape at B = 1
    (2, 333, 9, 3, 64, True),    # S neither a multiple of 64 nor of 128
    (1, 256, 4, 4, 64, True),    # G = 1
    (2, 517, 32, 32, 64, True),  # zamba2-1.2b's shared block: 32 heads, G = 1
    (2, 517, 48, 8, 128, True),  # dbrx-132b's attention: 48 heads, G = 6, hd 128
]


def _grad_within(got, want, dtype):
    """float32: rtol 1e-3, atol 1e-4 max|plain| (tests/test_layers.py:121);
    bfloat16: 2e-2 max|plain|."""
    w = want.double()
    err = (got.double() - w).abs()
    scale = w.abs().max().item()
    if dtype == torch.float32:
        limit = 1e-3 * w.abs() + 1e-4 * scale
        assert (err <= limit).all(), (err / limit).max().item()
    else:
        assert err.max().item() <= 2e-2 * scale, (err.max().item(), scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kvh,hd,causal", BWD_CASES)
def test_flash_attention_bwd_kernel_matches_plain_version(cuda, b, s, h, kvh, hd, causal, dtype):
    """dq, dk, dv of the backward kernels against flash_attention_bwd_ref on
    the same (q, k, v, out, lse, dout); a second call gives the same bits;
    the forward's out is the same with and without lse, and lse within f32
    rounding of the plain lse."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    gen = torch.Generator(device=cuda).manual_seed(s * h + hd)
    q = torch.randn((b, s, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, s, kvh, hd), generator=gen, device=cuda).to(dtype) for _ in range(2))
    dout = torch.randn((b, s, h, hd), generator=gen, device=cuda).to(dtype)
    plain_out = flash_attention(q, k, v, causal=causal)
    out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out) and lse.dtype == torch.float32
    _, want_lse = ref.flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    assert (lse - want_lse).abs().max().item() <= 1e-5 * want_lse.abs().max().item() + 1e-5
    launches = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == launches + 2
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        _grad_within(g, w, dtype)


# (B, Sq, Skv, H, KVH, hd) of the backward against fewer or more keys than
# queries, non-causal: llama-3.2-vision-90b's cross layer in training (Sq
# 2,048 against its 1,601 = 25 x 64 + 1 image tokens, 64 heads over 8, hd
# 128), a small ragged pair, reduced vlm's 16 image tokens, one key past a
# 64-key tile and more keys than queries
CROSS_BWD_CASES = [
    (8, 2048, 1601, 64, 8, 128),
    (2, 300, 77, 8, 2, 128),
    (2, 37, 16, 4, 2, 32),
    (1, 70, 65, 8, 8, 128),
    (2, 64, 200, 6, 3, 64),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kvh,hd", CROSS_BWD_CASES)
def test_flash_attention_bwd_at_the_cross_shapes(cuda, b, sq, skv, h, kvh, hd, dtype):
    """The backward kernels at Sq != Skv, non-causal, against
    flash_attention_bwd_ref on the same inputs (float32 rtol 1e-3, atol
    1e-4 max; bfloat16 2e-2 max); two calls give the same bits; the
    forward's out is the same with and without lse."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    gen = torch.Generator(device=cuda).manual_seed(sq + skv + hd)
    q = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    k, v = (torch.randn((b, skv, kvh, hd), generator=gen, device=cuda).to(dtype)
            for _ in range(2))
    dout = torch.randn((b, sq, h, hd), generator=gen, device=cuda).to(dtype)
    out, lse = flash_attention(q, k, v, causal=False, return_lse=True)
    assert torch.equal(out, flash_attention(q, k, v, causal=False))
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    torch.cuda.synchronize()
    want = ref.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=False)
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert torch.equal(g, a)
        _grad_within(g, w, dtype)
    del want
    torch.cuda.empty_cache()


def test_flash_attention_bwd_rejects(cuda):
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q = torch.randn((1, 16, 4, 64), device=cuda)
    k = torch.randn((1, 16, 2, 64), device=cuda)
    out, lse = flash_attention(q, k, k, return_lse=True)
    before = flash_attention_bwd.launches
    with pytest.raises(ValueError, match="head_dim 48"):
        q48, k48 = q[..., :48].contiguous(), k[..., :48].contiguous()
        flash_attention_bwd(q48, k48, k48, out[..., :48].contiguous(), lse, q48)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, k, out, lse.cpu(), q)
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd(q.cpu(), k.cpu(), k.cpu(), out.cpu(), lse.cpu(), q)
    with pytest.raises(TypeError):
        flash_attention_bwd(q, k, k, out, lse.double(), q)
    assert flash_attention_bwd.launches == before


def test_attention_function_runs_the_kernels_both_ways(cuda):
    """ops.flash_attention with grad: the forward kernel with lse and the
    backward kernel; with backend="ref" neither."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    q = torch.randn((2, 100, 4, 32), device=cuda, requires_grad=True)
    k = torch.randn((2, 100, 2, 32), device=cuda, requires_grad=True)
    f0, b0 = flash_attention.launches, flash_attention_bwd.launches
    g = torch.autograd.grad(ops.flash_attention(q, k, k).sum(), (q, k))
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) == (1, 1)
    w = torch.autograd.grad(ops.flash_attention(q, k, k, backend="ref").sum(), (q, k))
    assert (flash_attention.launches - f0, flash_attention_bwd.launches - b0) == (1, 1)
    for a, b in zip(g, w):
        _grad_within(a, b, torch.float32)


# (B, S, H, hd) of the sLSTM backward: hd 32 (a cluster of 1), 16 (units
# and terms padded), 128 (a cluster of 4), 256 (xlstm-350m's, a cluster of
# 16), 40 (no power of two), ragged S, S = 1; B = 3 (zero columns of the
# group) and B = 12 (two groups of rows, the second half empty)
SLSTM_BWD_CASES = [(2, 37, 4, 32), (1, 20, 2, 16), (2, 45, 2, 128), (2, 130, 4, 256),
                   (1, 1, 4, 256), (2, 19, 3, 40), (3, 70, 4, 256), (12, 33, 2, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,hd", SLSTM_BWD_CASES)
def test_slstm_fused_bwd_kernel_matches_plain_version(cuda, b, s, h, hd, dtype):
    """The forward's h bitwise with and without save, its saved state
    within 2e-4 of the plain one's; dgx and dR of the backward kernel
    against slstm_bwd_ref on the same saved state and dh (float32 rtol 1e-3,
    atol 1e-4 max; bfloat16 2e-2 max); a second call gives the same bits."""
    from repro_torch.kernels.slstm import slstm_fused_bwd

    gen = torch.Generator(device=cuda).manual_seed(s * hd + b + 7)
    gx = torch.randn((b, s, 4, h * hd), generator=gen, device=cuda).to(dtype)
    rg = torch.randn((4, h, hd, hd), generator=gen, device=cuda) / hd ** 0.5
    dh = torch.randn((b, s, h * hd), generator=gen, device=cuda).to(dtype)
    h0, _ = slstm_fused(gx, rg, h)
    h1, _, saved = slstm_fused(gx, rg, h, save=True)
    torch.cuda.synchronize()
    assert torch.equal(h0, h1)
    _, _, want_saved = ref.slstm_ref(gx, rg, h, save=True)
    for row in range(7):
        w = want_saved[:, :, row].double()
        assert (saved[:, :, row].double() - w).abs().max() <= 2e-4 * w.abs().max(), row
    launches = slstm_fused_bwd.launches
    got = slstm_fused_bwd(rg, saved, dh, h)
    again = slstm_fused_bwd(rg, saved, dh, h)
    torch.cuda.synchronize()
    assert slstm_fused_bwd.launches == launches + 2
    want = ref.slstm_bwd_ref(rg, saved, dh, h)
    for g, a, w in zip(got, again, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, a)
        _grad_within(g, w, dtype if g.dtype == dtype else torch.float32)


def test_slstm_bwd_train_shape_runs_in_one_wave(cuda):
    """xlstm-350m's train shape (8, 2048, 4, 256): the card holds all of the
    backward's clusters at once (cudaOccupancyMaxActiveClusters), in both
    types."""
    from repro_torch.kernels.slstm import active_clusters, plan_bwd

    for dtype in (torch.float32, torch.bfloat16):
        p = plan_bwd(8, 2048, 4, 256, dtype)
        assert p.clusters == 4 and active_clusters(p, dtype) >= p.clusters


def test_slstm_bwd_routes_and_rejects(cuda):
    """ops.slstm under grad: one forward (saving) and one backward launch,
    none with backend="ref"; the stream path (hd 512) refuses to save."""
    from repro_torch.kernels.slstm import slstm_fused_bwd

    gx = torch.randn((2, 30, 4, 64), device=cuda, requires_grad=True)
    rg = (torch.randn((4, 2, 32, 32), device=cuda) / 32 ** 0.5).requires_grad_()
    f0, b0 = slstm_fused.launches, slstm_fused_bwd.launches
    g = torch.autograd.grad(ops.slstm(gx, rg, 2)[0].sum(), (gx, rg))
    assert (slstm_fused.launches - f0, slstm_fused_bwd.launches - b0) == (1, 1)
    w = torch.autograd.grad(ops.slstm(gx, rg, 2, backend="ref")[0].sum(), (gx, rg))
    assert (slstm_fused.launches - f0, slstm_fused_bwd.launches - b0) == (1, 1)
    for a, b in zip(g, w):
        _grad_within(a, b, torch.float32)
    with pytest.raises(ValueError, match="ROADMAP"):
        slstm_fused(torch.randn((1, 4, 4, 512), device=cuda),
                    torch.randn((4, 1, 512, 512), device=cuda), 1, save=True)
    with pytest.raises(ValueError, match="saved"):
        slstm_fused_bwd(rg.detach(), torch.zeros((2, 30, 6, 64), device=cuda),
                        torch.zeros((2, 30, 64), device=cuda), 2)


def _train_setup(cuda, kernel_backend=None, dtype=torch.float32, arch="smollm-135m", opt=None,
                 **changes):
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_step import make_train_state, make_train_step

    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    model = build_model(cfg, CallConfig(compute_dtype=dtype, kernel_backend=kernel_backend),
                        device=cuda, seed=0)
    ocfg = OptConfig(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=8, **(opt or {}))
    return model, make_train_state(model, None, ocfg), make_train_step(model, ocfg)


def _train_batches(n, arch="smollm-135m", **changes):
    """``n`` batches of 4 x 128 tokens (an audio arch's x its codebooks); a
    vlm arch's with each step's image embeddings as the launcher draws
    them, on the card."""
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens
    from repro_torch.launch.train import image_embeds_at

    cfg = dataclasses.replace(get_config(arch).reduced(), **changes)
    data = SyntheticTokens(DataConfig(vocab_size=512, seq_len=128, global_batch=4, seed=0,
                                      num_codebooks=cfg.num_codebooks))
    batches = [data.batch_at(i) for i in range(n)]
    if cfg.family == "vlm":
        for i, b in enumerate(batches):
            b["image_embeds"] = image_embeds_at(cfg, 4, 0, i, "cuda")
    return batches


def _kernel_steps_match_plain(cuda, dtype, arch, kernels, per_step, opt=None, **changes):
    """Three steps of reduced ``arch`` through ``kernels`` (forward,
    backward) against the same steps with their plain versions: losses and
    grad norms within 2e-5 / 1e-4 relative in float32, 2e-2 in bfloat16;
    ``per_step`` (forward, backward) launches a step, none plain. ``opt``:
    OptConfig changes (bf16 masters)."""
    runs = []
    for backend in (None, "ref"):
        model, state, step = _train_setup(cuda, backend, dtype, arch, opt, **changes)
        before = [k.launches for k in kernels]
        mets = []
        for batch in _train_batches(3, arch, **changes):
            state, m = step(state, batch)
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        torch.cuda.synchronize()
        runs.append((mets, tuple(k.launches - b for k, b in zip(kernels, before))))
    assert runs[0][1] == tuple(3 * n for n in per_step) and runs[1][1] == (0, 0)
    tl, tg = (2e-5, 1e-4) if dtype == torch.float32 else (2e-2, 2e-2)
    for (lk, gk), (lr_, gr) in zip(runs[0][0], runs[1][0]):
        assert math.isfinite(lk) and math.isfinite(gk)
        assert abs(lk - lr_) <= tl * abs(lr_) and abs(gk - gr) <= tg * abs(gr)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_smollm_train_steps_through_the_kernels(cuda, dtype):
    """Reduced smollm-135m (hd 32) through the attention kernels against the
    plain attention; under remat 2 forward and 1 backward launch a layer and
    step."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    L = get_config("smollm-135m").reduced().num_layers
    _kernel_steps_match_plain(cuda, dtype, "smollm-135m", (flash_attention, flash_attention_bwd),
                              (2 * L, L))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_xlstm_train_steps_through_the_kernels(cuda, dtype):
    """Reduced xlstm-350m (1 pair, hd 32) through the sLSTM kernels against
    the plain recurrence; under remat 2 forward and 1 backward launch a pair
    and step."""
    from repro_torch.kernels.slstm import slstm_fused_bwd

    P = get_config("xlstm-350m").reduced().num_layers // 2
    _kernel_steps_match_plain(cuda, dtype, "xlstm-350m", (slstm_fused, slstm_fused_bwd),
                              (2 * P, P))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_zamba2_train_steps_through_the_kernels(cuda, dtype):
    """Reduced zamba2-1.2b at 5 layers (two groups of two Mamba2 blocks, each
    followed by the shared attention block, and a tail block) through the
    attention kernels against the plain attention; under remat 2 forward and
    1 backward launch a use of the shared block and step."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    _kernel_steps_match_plain(cuda, dtype, "zamba2-1.2b", (flash_attention, flash_attention_bwd),
                              (2 * 2, 2), num_layers=5)


# reduced dbrx-132b widened to hd 128 and G = 6, so the hd 128 kernels run:
# 2 layers of 6 heads over 1 KV head, 4 experts top-2 at the published
# capacity factor 1.25 (the dispatch drops choices)
DBRX_HD128 = dict(d_model=768, num_heads=6, num_kv_heads=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_dbrx_train_steps_through_the_kernels(cuda, dtype):
    """Reduced dbrx-132b (DBRX_HD128) through the attention kernels against
    the plain attention; under remat 2 forward and 1 backward launch a layer
    and step."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    L = get_config("dbrx-132b").reduced().num_layers
    _kernel_steps_match_plain(cuda, dtype, "dbrx-132b", (flash_attention, flash_attention_bwd),
                              (2 * L, L), **DBRX_HD128)


# reduced llama-3.2-vision-90b widened to hd 128 and G = 8 (the published
# ratio), so the hd 128 kernels run at both of its shapes: one group of a
# self layer and a cross layer over 16 image tokens
VLM_HD128 = dict(d_model=1024, num_heads=8, num_kv_heads=1)


@pytest.mark.parametrize("changes", [{}, VLM_HD128], ids=["hd32", "hd128"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_vlm_train_steps_through_the_kernels(cuda, dtype, changes):
    """Reduced llama-3.2-vision-90b through the attention kernels, its cross
    layer non-causal against the image tokens, against the plain attention,
    with each step's image embeddings; under remat 2 forward and 1 backward
    launch a layer and step."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    L = get_config("llama-3.2-vision-90b").reduced().num_layers
    _kernel_steps_match_plain(cuda, dtype, "llama-3.2-vision-90b",
                              (flash_attention, flash_attention_bwd), (2 * L, L), **changes)


def test_reduced_vlm_bf16_master_steps_through_the_kernels(cuda):
    """The train-vlm recipe at the reduced size: bf16 masters and bf16
    moments (every parameter bfloat16 after the state is made), bf16
    compute, through the kernels against the plain attention."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    opt = dict(param_dtype="bf16", moment_dtype="bf16")
    model, _, _ = _train_setup(cuda, None, torch.bfloat16, "llama-3.2-vision-90b", opt,
                               **VLM_HD128)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    del model
    L = get_config("llama-3.2-vision-90b").reduced().num_layers
    _kernel_steps_match_plain(cuda, torch.bfloat16, "llama-3.2-vision-90b",
                              (flash_attention, flash_attention_bwd), (2 * L, L), opt,
                              **VLM_HD128)


# reduced musicgen-large widened to musicgen's hd 64 (4 heads of 64, G = 1)
AUDIO_HD64 = dict(d_model=256)


@pytest.mark.parametrize("changes", [{}, AUDIO_HD64], ids=["hd32", "hd64"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reduced_musicgen_train_steps_through_the_kernels(cuda, dtype, changes):
    """Reduced musicgen-large (4 codebooks, (B, S, K) tokens and targets)
    through the attention kernels against the plain attention; under remat
    2 forward and 1 backward launch a layer and step."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    L = get_config("musicgen-large").reduced().num_layers
    _kernel_steps_match_plain(cuda, dtype, "musicgen-large",
                              (flash_attention, flash_attention_bwd), (2 * L, L), **changes)


def test_reduced_musicgen_bf16_train_steps_give_the_same_bits_twice(cuda):
    """Two runs of the same two bfloat16 musicgen train steps (the codebook
    lookups' backward, an accumulating index_put_ of Zipf tokens, among
    them): the same losses, grad norms and parameters, bit for bit."""
    runs = []
    for _ in range(2):
        model, state, step = _train_setup(cuda, None, torch.bfloat16, "musicgen-large")
        mets = []
        for batch in _train_batches(2, "musicgen-large"):
            state, m = step(state, batch)
            mets.append((float(m["loss"]), float(m["grad_norm"])))
        runs.append((mets, [p.detach().clone() for p in model.parameters()]))
        del model, state, step
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_reduced_dbrx_bf16_train_steps_give_the_same_bits_twice(cuda):
    """Two runs of the same two bfloat16 train steps (the dispatch's
    index_add_ and its backward's index_put_ on the card among them): the
    same losses, grad norms and parameters, bit for bit."""
    runs = []
    for _ in range(2):
        model, state, step = _train_setup(cuda, None, torch.bfloat16, "dbrx-132b", **DBRX_HD128)
        mets = []
        for batch in _train_batches(2):
            state, m = step(state, batch)
            mets.append((float(m["loss"]), float(m["grad_norm"]), float(m["aux"])))
        runs.append((mets, [p.detach().clone() for p in model.parameters()]))
        del model, state, step
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_train_resume_is_bitwise_on_the_card(cuda, tmp_path):
    """Save after 2 of 5 steps, restore into a fresh state, take the last 3:
    losses and parameters bitwise the uninterrupted run's."""
    from repro_torch.checkpoint import checkpoint as ck
    from repro_torch.train.train_step import load_state_tree, state_tree

    batches = _train_batches(5)
    model, state, step = _train_setup(cuda)
    losses = []
    for i, batch in enumerate(batches):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 1:
            ck.save(str(tmp_path), 2, state_tree(state))
    fresh_model, fresh, fstep = _train_setup(cuda)
    tree, _ = ck.restore(str(tmp_path), state_tree(fresh))
    load_state_tree(fresh, tree)
    for batch, want in zip(batches[2:], losses[2:]):
        fresh, m = fstep(fresh, batch)
        assert float(m["loss"]) == want
    for (n, a), (_, b) in zip(fresh_model.named_parameters(), model.named_parameters()):
        assert torch.equal(a, b), n


def test_com_matmul_over_ranks_on_the_card(cuda, tmp_path):
    """Ranks on cuda:0 in a gloo group (NCCL refuses two ranks on one
    GPU, so the hops go through pinned host memory): make_com_matmul with
    silu in float32 and bfloat16 within 2e-5 / 2e-2 of the dense product's
    largest magnitude, each rank's shard on the card, the counted bytes
    equal to wire_bytes."""
    import json

    import _torch_ranks as ranks
    from repro_torch.parallel.collectives import wire_bytes

    world = 2
    ranks.spawn(ranks.gpu_com_rank, world, tmp_path, timeout=300)
    for r in range(world):
        info = json.loads((tmp_path / f"gpu_{r}.json").read_text())
        for dtype in (torch.float32, torch.bfloat16):
            line = info[str(dtype)]
            assert line["device"].startswith("cuda") and line["dtype"] == str(dtype)
            assert line["shape"] == [96, 128 // world]
            assert line["err"] <= (2e-2 if dtype == torch.bfloat16 else 2e-5), line
            assert line["sent"]["bytes_sent"] == wire_bytes("com", line["out_bytes"], world)
            assert line["sent"]["sends"] == world - 1 and line["sent"]["all_reduces"] == 0



@pytest.fixture
def one_rank(cuda, tmp_path):
    """A gloo group of this process alone, and a (data=1, model=1) mesh on the card."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        yield make_debug_mesh(data=1, model=1)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_through_local_map_on_one_rank_is_the_direct_call(one_rank, dtype):
    """DTensor q, k, v on a one-rank mesh run the kernels through local_map:
    the output and the gradients bitwise the direct call's, one forward and
    one backward launch each."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import flash_attention_bwd

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((2, 300, 4, 64), (2, 300, 2, 64), (2, 300, 2, 64),
                                   (2, 300, 4, 64)))
    runs = []
    for placed in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        args = [DTensor.from_local(t, one_rank, [Replicate(), Replicate()]) for t in leaves] \
            if placed else leaves
        flash_attention.launches = flash_attention_bwd.launches = 0
        with torch.enable_grad():
            out = ops.flash_attention(*args)
            if placed:
                out = out.to_local()
            out.backward(dout)
        runs.append((out.detach(), [t.grad for t in leaves],
                     (flash_attention.launches, flash_attention_bwd.launches)))
    (out, grads, launches), (out_p, grads_p, launches_p) = runs
    assert torch.equal(out, out_p) and all(torch.equal(a, b) for a, b in zip(grads, grads_p))
    assert launches == launches_p == (1, 1)


def test_place_params_refuses_a_mesh_off_the_models_device(cuda, tmp_path):
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel.sharding import place_params

    model = build_model(get_config("smollm-135m").reduced(), CallConfig(), device="cuda")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", world_size=1, rank=0)
    try:
        with pytest.raises(ValueError, match="mesh is over 'cpu'"):
            place_params(model, make_debug_mesh(data=1, model=1, device_type="cpu"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_non_causal_flash_through_local_map_is_the_direct_call(one_rank, dtype):
    """The vlm cross layer's case: 300 text queries against 77 image keys,
    non-causal, on a one-rank mesh through _flash_local: the output and the
    gradients bitwise the direct call's, one forward and one backward launch."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.kernels.flash_attention import flash_attention_bwd

    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, dout = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                     for shape in ((2, 300, 4, 64), (2, 77, 2, 64), (2, 77, 2, 64),
                                   (2, 300, 4, 64)))
    runs = []
    for placed in (False, True):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        args = [DTensor.from_local(t, one_rank, [Replicate(), Replicate()]) for t in leaves] \
            if placed else leaves
        flash_attention.launches = flash_attention_bwd.launches = 0
        with torch.enable_grad():
            out = ops.flash_attention(*args, causal=False)
            if placed:
                out = out.to_local()
            out.backward(dout)
        runs.append((out.detach(), [t.grad for t in leaves],
                     (flash_attention.launches, flash_attention_bwd.launches)))
    (out, grads, launches), (out_p, grads_p, launches_p) = runs
    assert torch.equal(out, out_p) and all(torch.equal(a, b) for a, b in zip(grads, grads_p))
    assert launches == launches_p == (1, 1)


@pytest.mark.parametrize("ep_split", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_through_local_map_is_the_direct_call(one_rank, dtype, ep_split):
    """moe_forward of a DTensor on a one-rank mesh (the dispatch, the expert
    products and the combine through local_map, shard_fn placing xg, ebuf or
    ebuf_ep and out): y and aux bitwise the direct call's, a dropping
    capacity factor."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.models import moe
    from repro_torch.parallel.sharding import act_rules, make_shard_fn

    gen = torch.Generator(device="cuda").manual_seed(9)
    params = moe.init_moe(gen, 64, 96, 4, ep_split=ep_split)
    x = torch.randn((4, 16, 64), generator=gen, device="cuda").to(dtype)
    kw = dict(top_k=2, num_experts=4, capacity_factor=1.0, dp_size=2, ep_split=ep_split)
    y, aux = moe.moe_forward(params, x, **kw)
    whole = [Replicate(), Replicate()]
    placed = {n: DTensor.from_local(p, one_rank, whole) for n, p in params.items()}
    yp, auxp = moe.moe_forward(placed, DTensor.from_local(x, one_rank, whole),
                               shard_fn=make_shard_fn(one_rank, act_rules(one_rank)), **kw)
    assert torch.equal(yp.to_local(), y) and torch.equal(auxp.to_local(), aux)
