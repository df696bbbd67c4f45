"""Launch plans and numerics of the port's tensor-core kernels, on the CPU.

``com_matmul`` and ``conv2d_com`` run on the card only, so what surrounds
them is held here: the launch plan of every VGG-16 product and per-image
convolution (shared memory within the 227 KB a block may use, every split
owning part of K, the card filled), plain PyTorch models of the order in
which split-K adds its slices and of the 3xTF32 arithmetic of
``csrc/com_mma.cuh``, and the build cache's key. The models are held to
the JAX package's float32 tolerance, ``2e-5 · max|ref|``
(tests/test_executor.py:87), against float64.
"""
import math

import numpy as np
import pytest
import torch

import repro_torch.core.executor as tex
from repro_torch.convert import to_port
from repro_torch.core.mapping import ConvSpec, _vgg, vgg16_imagenet
from repro_torch.core.program import Workload, compile_program
from repro_torch.kernels import _build, ops
from repro_torch.kernels.com_matmul import BK, SMEM_LIMIT, SMS, plan
from repro_torch.kernels.conv2d_com import plan as conv_plan
from repro_torch.kernels.ref import _epilogue, com_matmul_ref, conv2d_com_ref

TOL = 2e-5
BATCH = 8
VGG16 = vgg16_imagenet().layers
GEMMS = [(BATCH * l.h_out * l.w_out, l.k * l.k * l.c_in, l.c_out) if isinstance(l, ConvSpec)
         else (BATCH, l.c_in, l.c_out) for l in VGG16]
CONVS = [(l.h_in, l.w_in, l.c_in, l.k, l.c_out, l.stride, l.padding)
         for l in VGG16 if isinstance(l, ConvSpec)]


@pytest.mark.parametrize("m,k,n", GEMMS, ids=[l.name for l in VGG16])
def test_plan_of_every_vgg16_product_fits_and_fills_the_card(m, k, n):
    for dtype in (torch.float32, torch.bfloat16):
        p = plan(m, n, k, dtype)
        assert p.path == ("skinny" if m <= 32 else "mma")
        assert p.smem <= SMEM_LIMIT
        assert p.splits * p.kchunk >= k and (p.splits - 1) * p.kchunk < k  # no empty split
        if p.path == "mma":
            assert p.kchunk % p.bk == 0
            assert p.grid == (math.ceil(m / p.bm), math.ceil(n / p.bn), p.splits)
        assert p.blocks >= SMS or p.splits == p.max_splits
        assert p.workspace == (4 * p.splits * m * n if p.splits > 1 else 0)


@pytest.mark.parametrize("h,w,c,k,m,s,pad", CONVS,
                         ids=[l.name for l in VGG16 if isinstance(l, ConvSpec)])
def test_plan_of_every_vgg16_convolution_fits_and_fills_the_card(h, w, c, k, m, s, pad):
    for dtype in (torch.float32, torch.bfloat16):
        p = conv_plan(h, w, c, k, m, s, pad, dtype)
        assert p.smem <= SMEM_LIMIT
        assert p.k_tiles == math.ceil(c / p.bk) * k * k
        assert p.splits * p.kps >= p.k_tiles and (p.splits - 1) * p.kps < p.k_tiles
        assert p.blocks >= SMS or p.splits == p.max_splits
        ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
        assert p.grid[0] == math.ceil(ho / p.tile[0]) * math.ceil(wo / p.tile[1])
        assert p.workspace == (4 * p.splits * ho * wo * m if p.splits > 1 else 0)


def test_conv_plan_narrows_the_halo_or_raises_where_shared_memory_runs_out():
    p = conv_plan(112, 112, 64, 5, 128, 2, 2, torch.float32)  # 19 x 35 halo pixels
    assert p.smem <= SMEM_LIMIT and p.halo_stride == p.bk + 4  # not + 8: that does not fit
    with pytest.raises(ValueError, match="shared memory"):
        conv_plan(64, 64, 8, 11, 8, 4, 0, torch.float32)


# ---- split-K: the slices added in the kernel's fixed order -------------------

def _split_k_model(x, w, p, **epilogue):
    """com_matmul as the kernel orders it: each split's f32 product over its
    K slice, the slices added in split order (0 + s0 + s1 + ...), then the
    epilogue, one cast."""
    total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    for s in range(p.splits):
        ks = slice(s * p.kchunk, (s + 1) * p.kchunk)
        total = total + x[:, ks].float() @ w[ks].float()
    return _epilogue(total, epilogue.get("bias"), epilogue.get("activation"),
                     epilogue.get("residual")).to(x.dtype)


@pytest.mark.parametrize("m,k,n,path", [(200, 4096, 64, "mma"), (1568, 4608, 64, "mma"),
                                        (8, 3000, 200, "skinny"), (20, 700, 70, "skinny")])
def test_split_k_order_matches_the_plain_version(m, k, n, path):
    p = plan(m, n, k, torch.float32)
    assert p.path == path and p.splits > 1
    rng = np.random.default_rng(m + k)
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(k, n)) * (2 / k) ** 0.5).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    got = _split_k_model(x, w, p, bias=b, activation="gelu")
    want = com_matmul_ref(x, w, bias=b, activation="gelu")
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= 1e-5 * scale


def test_conv_split_order_over_channel_chunks_and_positions_matches_the_plain_version():
    """conv2d_com's k-tiles are (channel chunk, kernel position) pairs; a
    split owns a run of them, and the slices are added in split order."""
    H, W, C, K, M = 14, 14, 96, 3, 64
    p = conv_plan(H, W, C, K, M, 1, 1, torch.float32)
    assert p.splits > 1 and p.kps % (K * K) != 0  # a split starts inside a chunk
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(H, W, C)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(K, K, C, M)) * (2 / (K * K * C)) ** 0.5)
                         .astype(np.float32))
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    total = torch.zeros((H, W, M))
    for s in range(p.splits):
        part = torch.zeros((H, W, M))
        for kt in range(s * p.kps, min((s + 1) * p.kps, p.k_tiles)):
            chunk, pos = divmod(kt, K * K)
            cs = slice(chunk * p.bk, (chunk + 1) * p.bk)
            kr, kc = divmod(pos, K)
            part = part + xp[kr:kr + H, kc:kc + W, cs] @ w[kr, kc, cs]
        total = total + part
    want = conv2d_com_ref(x, w, activation="relu")
    assert (total.relu() - want).abs().max().item() <= 1e-5 * want.abs().max().item()


# ---- 3xTF32: the arithmetic of csrc/com_mma.cuh -----------------------------

MASK = -8192  # 0xFFFFE000: the 19 bits of a TF32 number
TF32_MAX = 3.40116213e38  # 0x7F7FE000, the largest finite TF32


def _tf32_split(t):
    """big = t rounded to TF32 and saturated at TF32_MAX (t clamped to
    +-TF32_MAX, half a TF32 ulp added, 13 low bits cleared: cvt.rna.satfinite
    done with a clamp and integer bit operations), small = t - big, read as
    the MMA reads it (truncated to TF32). This is csrc/com_mma.cuh's
    saturating split. The kernel runs a faster split first and takes this
    one only for a block whose sums come out non-finite; wherever the fast
    split's sums are finite the two give the same bits, so this one split
    models the kernel everywhere."""
    bits = t.clamp(-TF32_MAX, TF32_MAX).nan_to_num(-TF32_MAX).contiguous().view(torch.int32)
    big = ((bits + 0x1000) & MASK).view(torch.float32)
    small = ((t - big).contiguous().view(torch.int32) & MASK).view(torch.float32)
    return big, small


def _add_toward_zero(acc, s):
    """acc + s (s exact in float64) rounded toward zero to float32: the
    tensor cores' accumulation, modelled without round-to-nearest."""
    f = (acc.double() + s).float()
    over = f.double().abs() > (acc.double() + s).abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def mma_3xtf32(x, w, *, promote=True, bk=BK[torch.float32]):
    """(M,K) @ (K,N) in float32 as the kernel computes it: per k8 step the
    passes big x small', small x big', big x big' (products exact, each MMA's
    sum truncated into the accumulator); with ``promote`` each k-tile of
    ``bk`` starts a fresh accumulator that is then added (round to nearest)
    to the float32 sum."""
    xb, xs = _tf32_split(x.float())
    wb, ws = _tf32_split(w.float())
    total = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
    part = torch.zeros_like(total)
    for k0 in range(0, x.shape[1], 8):
        g = slice(k0, k0 + 8)
        for a, b in ((xb, ws), (xs, wb), (xb, wb)):
            part = _add_toward_zero(part, a[:, g].double() @ b[g].double())
        if promote and ((k0 + 8) % bk == 0 or k0 + 8 >= x.shape[1]):
            total, part = total + part, torch.zeros_like(part)
    return total + part


def _rel_err(got, want):
    return ((got.double() - want.double()).abs().max() / want.double().abs().max()).item()


def test_3xtf32_model_holds_a_k4608_product_within_the_f32_tolerance():
    rng = np.random.default_rng(0)
    # post-ReLU activations (all >= 0) against He-scaled weights: conv5's K
    x = torch.from_numpy(np.maximum(rng.normal(size=(48, 4608)), 0).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(4608, 40)) * (2 / 4608) ** 0.5).astype(np.float32))
    want = x.double() @ w.double()
    err = _rel_err(mma_3xtf32(x, w), want)
    unpromoted = _rel_err(mma_3xtf32(x, w, promote=False), want)
    print(f"3xTF32 model, K = 4608: {err:.3e} of max|ref| (limit {TOL}, headroom "
          f"{TOL / err:.1f}x); without promotion {unpromoted:.3e}")
    assert err <= TOL


def test_3xtf32_model_holds_the_full_depth_vgg16_executor_at_reduced_width(monkeypatch):
    """Every layer of VGG-16 (13 convolutions, 3 FC), widths / 8 on 32 x 32
    images: the executor's kernel path with each product computed by the
    3xTF32 model, against the float64 reference backend."""
    layers = _vgg([8, 8, "M", 16, 16, "M", 32, 32, 32, "M", 64, 64, 64, "M", 64, 64, 64, "M"],
                  32, 32, [(64, 512), (512, 512), (512, 10)], "vgg16w8")
    program = compile_program(Workload("vgg16-width8", tuple(layers)))
    weights = tex.random_weights(program, seed=0)
    images = np.random.default_rng(1).normal(size=(2, 32, 32, 3))
    want = program.execute(images, weights, backend="reference", device="cpu").outputs

    def model(x, w, *, bias=None, activation=None, residual=None, backend=None):
        return _epilogue(mma_3xtf32(x, w), bias, activation, residual)

    monkeypatch.setattr(ops, "com_matmul", model)
    w32 = to_port(program.workload.layers, weights, dtype=torch.float32, device="cpu")
    got = tex.com_forward(program, w32, torch.as_tensor(images, dtype=torch.float32))
    err = _rel_err(got, want)
    print(f"3xTF32 model, VGG-16 / 8 executor: {err:.3e} of max|ref| (limit {TOL}, "
          f"headroom {TOL / err:.1f}x)")
    assert got.shape == (2, 10) and err <= TOL


def _same_non_finite_and_close(got, want):
    """NaN where ``want`` is NaN, the same infinities, and the finite rest
    within the float32 tolerance of the finite part's largest magnitude."""
    assert torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isinf(), want.isinf())
    assert torch.equal(got[got.isinf()], want[want.isinf()])
    fin = want.isfinite()
    scale = want[fin].double().abs().max()
    assert (got[fin].double() - want[fin].double()).abs().max() <= TOL * scale


@pytest.mark.parametrize("x0", [float("inf"), float("-inf"), 3.4028e38, -3.4028e38,
                                3.4028235e38, float("nan")],
                         ids=["inf", "-inf", "3.4028e38", "-3.4028e38", "flt-max", "nan"])
def test_3xtf32_model_gives_the_plain_result_at_the_edges_of_the_range(x0):
    """The split keeps an infinite operand infinite (no inf x 0 in the cross
    terms), a near-overflow one exact, and a NaN a NaN: one such operand of x
    and one of w, against com_matmul_ref."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(24, 64)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(64, 16)) * 1e-3).astype(np.float32))
    w[7, 3] = 1.0  # exact in TF32: its small half is 0
    edge = torch.tensor(np.float32(x0))
    x[5, 7] = edge  # meets row 7 of w, the exact 1.0 among it
    x[9, 2] = edge
    _same_non_finite_and_close(mma_3xtf32(x, w), com_matmul_ref(x, w))
    xt, wt = w.t().contiguous(), x.t().contiguous()  # the edge value on the other side
    _same_non_finite_and_close(mma_3xtf32(xt, wt), com_matmul_ref(xt, wt))
    assert torch.isfinite(_tf32_split(edge[None])[0]).all()  # big never overflows


def test_3xtf32_model_of_inf_times_inf_is_inf():
    x = torch.zeros((16, 8))
    w = torch.zeros((8, 8))
    x[0, 0], w[0, 0], w[0, 1], x[1, 0] = float("inf"), float("inf"), float("-inf"), 2.0
    _same_non_finite_and_close(mma_3xtf32(x, w), com_matmul_ref(x, w))


# ---- the build cache ----------------------------------------------------------

def test_build_target_covers_included_headers_and_flags(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\nextern "C" int f() { return g(); }\n')
    (tmp_path / "shared.cuh").write_text('#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("inline int g() { return 1; }\n")
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build._target("k")
    (tmp_path / "unrelated.cuh").write_text("// edited\n")
    assert _build._target("k") == first
    (tmp_path / "inner.cuh").write_text("inline int g() { return 2; }\n")
    second = _build._target("k")
    assert second != first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-Iinclude",))
    assert _build._target("k") not in (first, second)
    assert [f.name for f in _build._sources(tmp_path / "k.cu")] == ["k.cu", "shared.cuh",
                                                                    "inner.cuh"]
