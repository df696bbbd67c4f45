"""Launch plans and numerics of the port's flash_attention and slstm_fused
kernels, on the CPU.

Both kernels run on the card only, so what surrounds them is held here:
their pure-Python launch plans (``kernels/flash_attention.py:plan``,
``kernels/slstm.py:plan``), and plain PyTorch models of the arithmetic the
CUDA sources do in another order than the plain versions: flash_attention's
split KV range with its ordered combine, its three-way bfloat16 split of the
probabilities P, slstm_fused's cluster-path sums over k slices, and its
backward's 3xTF32 tensor-core sums over 4 hd terms for a group of rows
(``kernels/slstm.py:plan_bwd``). The
models are held against the JAX package's kernels in interpret mode (the
same numpy inputs) within the JAX package's float32 tolerances, rtol 2e-5
for attention (tests/test_kernels.py:18-19) and 2e-4 for the recurrence
(tests/test_kernels.py:142).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention_gqa as jax_flash_attention_gqa
from repro.models.attention import flash_attention as jax_model_flash_attention
from repro.kernels.slstm import slstm_fused as jax_slstm_fused
from repro_torch.kernels.com_matmul import SMEM_LIMIT, SMS
from repro_torch.kernels.flash_attention import (BLOCK_KV, BLOCK_Q, BWD_STAGES, HEAD_DIMS,
                                                 MAX_SPLITS, bwd_smem_bytes, bwd_workspace,
                                                 kv_tiles_of, occupancy, smem_bytes)
from repro_torch.kernels.flash_attention import plan as flash_plan
from repro_torch.kernels.flash_attention import plan_bwd as flash_plan_bwd
from repro_torch.kernels.ref import flash_attention_ref, log_sigmoid, slstm_bwd_ref, slstm_ref
from repro_torch.kernels.slstm import (BWD_R_REGS, BWD_ROWS, BWD_TILES_K, BWD_WARPS,
                                       CLUSTER_THREADS, MAX_BWD_CLUSTER, MAX_CLUSTER, REG_KPT,
                                       _cluster_plan, bwd_smem, plan_bwd)
from repro_torch.kernels.slstm import plan as slstm_plan

NEG_INF = -1e30

# ---- flash_attention: the plan -------------------------------------------------

SERVED = [int(n) for n in np.random.default_rng(2).integers(128, 1025, size=16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 77, 128, 1024, 2048] + SERVED[:4])
def test_flash_plan_covers_every_tile_and_fits(S, hd, dtype):
    for B, H, KVH, causal in ((1, 9, 3, True), (2, 4, 1, False), (8, 9, 3, True)):
        p = flash_plan(B, S, S, H, KVH, hd, dtype, causal)
        assert (p.block_q, p.block_kv, p.threads) == (BLOCK_Q, BLOCK_KV, 128)
        assert p.q_tiles == math.ceil(S / BLOCK_Q) and p.kv_tiles == math.ceil(S / BLOCK_KV)
        assert p.grid == (p.q_tiles, H, B * p.splits)
        longest = max(kv_tiles_of(i, S, causal) for i in range(p.q_tiles))
        assert 1 <= p.splits <= min(MAX_SPLITS, longest)
        # a grid already two waves deep is not split
        if B * H * p.q_tiles >= 2 * occupancy(hd, dtype) * SMS:
            assert p.splits == 1
        assert p.smem == smem_bytes(hd, dtype) <= SMEM_LIMIT
        assert p.workspace == (4 * p.splits * B * H * S * (hd + 2) if p.splits > 1 else 0)


def test_flash_plan_splits_short_grids_and_rejects_unbuilt_head_dims():
    served = [flash_plan(1, S, S, 9, 3, 64, torch.bfloat16, True) for S in SERVED]
    assert all(p.splits > 1 for p in served)  # 9 heads x <= 16 q tiles: under a wave
    # causal, Sq = Skv: the last q tile walks all q_tiles KV tiles
    assert all(p.splits == min(MAX_SPLITS, p.q_tiles) for p in served)
    assert flash_plan(1, 64, 64, 9, 3, 64, torch.bfloat16, True).splits == 1  # one tile
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_plan(1, 64, 64, 2, 2, 48, torch.bfloat16, True)
    # blocks an SM: the launch bound's 4 where bf16 hd <= 64, 2 by registers
    # elsewhere, fewer where shared memory runs out (1 KB reserved a block)
    want = {(torch.bfloat16, 32): 4, (torch.bfloat16, 64): 4, (torch.bfloat16, 128): 2,
            (torch.float32, 32): 2, (torch.float32, 64): 2, (torch.float32, 128): 1}
    assert {k: occupancy(k[1], k[0]) for k in want} == want
    for (dtype, hd), n in want.items():
        assert n * (smem_bytes(hd, dtype) + 1024) <= 233_472
    # f32 hd 128 (168 KB a block): one block an SM, so fewer splits fill the card
    assert [flash_plan(1, 1024, 1024, 9, 3, 128, dt, True).splits
            for dt in (torch.float32, torch.bfloat16)] == [2, 4]


def test_causal_kv_tiles_are_those_at_or_before_the_last_row():
    # top-left mask: q tile i (rows 64 i .. 64 i + 63) needs keys <= 64 i + 63
    assert [kv_tiles_of(i, 300, True) for i in range(5)] == [1, 2, 3, 4, 5]
    assert [kv_tiles_of(i, 100, True) for i in range(5)] == [1, 2, 2, 2, 2]  # Sq > Skv
    assert kv_tiles_of(0, 300, False) == 5


# ---- flash_attention: the backward's plan and its tile walks -------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("S", [1, 77, 517, 2048])
def test_flash_bwd_plan_covers_every_tile_and_fits(S, hd, dtype):
    wgmma = dtype == torch.bfloat16
    for B, H, KVH, causal in ((1, 9, 3, True), (2, 4, 1, False), (8, 9, 3, True)):
        p = flash_plan_bwd(B, S, S, H, KVH, hd, dtype, causal)
        # bf16 on wgmma with TMA, p and ds rounded once: 7 passes a pair; f32
        # on mma.sync 3xTF32: the same 7 products, three passes each
        assert p.path == ("wgmma" if wgmma else "mma_sync_3xtf32")
        assert p.mma_passes_per_pair == (7 if wgmma else 21)
        assert (p.block_q, p.block_kv) == (BLOCK_Q, BLOCK_KV) == (64, 64)
        assert p.threads == 128  # bf16: one warpgroup of 64 rows
        assert p.stages == (BWD_STAGES[hd] if wgmma else 2) >= 2
        # the grids cover every key and every q row, and no block lies past S
        blocks = math.ceil(S / 64)
        assert p.grid_dkdv == (blocks, KVH, B) and p.grid_dq == (blocks, H, B)
        assert (blocks - 1) * 64 < S <= blocks * 64
        # the longest walks: the first key block's over G heads of q tiles, the
        # last q block's up to its last row's diagonal (or every key tile)
        tiles = math.ceil(S / 64)
        assert p.q_tiles_dkdv == H // KVH * tiles and p.kv_tiles_dq == tiles
        # the row statistics: a warp a row; bf16 rows padded to a multiple of 64
        rows = B * H * (64 * tiles if wgmma else S)
        assert p.delta_blocks == math.ceil(rows / 8)
        assert p.workspace == bwd_workspace(B, S, H, dtype) == (8 if wgmma else 4) * rows
        assert (p.smem_dkdv, p.smem_dq) == bwd_smem_bytes(hd, dtype)
        assert p.smem_dq < p.smem_dkdv <= SMEM_LIMIT
    if wgmma:  # the shared memory of csrc/flash_attention.cu's BwdSmem<hd>
        tile, stages = 128 * hd, BWD_STAGES[hd]
        walked = 2 * tile + stages * 2 * tile
        assert bwd_smem_bytes(hd, dtype) == (walked + stages * 512 + 8 * (1 + stages) + 1024,
                                             walked + 8 * (1 + stages) + 1024)
    with pytest.raises(ValueError, match="head_dim 48"):
        flash_plan_bwd(1, 64, 64, 2, 2, 48, torch.bfloat16, True)


def _bwd_by_tiles(q, k, v, dout, causal, one_rounding=False):
    """csrc/flash_attention.cu's backward walks in plain float32 torch: a
    dK/dV block of 64 keys per KV head over the G query heads and the
    64-row q tiles from the causal diagonal of its first key on, a dQ block
    of 64 q rows per head over the 64-key tiles up to the diagonal of its
    last row; p from the saved lse, masked to 0. With ``one_rounding`` (the bfloat16
    kernels, given bfloat16 inputs) p and ds are rounded once to bfloat16
    before the accumulating products, and dq, dk, dv once at the end."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G, scale = H // KVH, 1.0 / math.sqrt(hd)
    out, lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    q, k, v, dout, out = (t.float() for t in (q, k, v, dout, out))
    delta = (dout * out).sum(-1).permute(0, 2, 1)  # (B, H, Sq)
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    nq, nk = math.ceil(Sq / 64), math.ceil(Skv / 64)

    def rnd(x):
        return x.to(torch.bfloat16).float() if one_rounding else x

    def tile(qi, kt, h):
        rows, cols = torch.arange(qi * 64, min(Sq, qi * 64 + 64)), \
            torch.arange(kt * 64, min(Skv, kt * 64 + 64))
        kvh = h // G
        s = q[:, rows, h] @ k[:, cols, kvh].transpose(1, 2) * scale
        keep = ~(cols[None, :] > rows[:, None]) if causal else torch.ones(len(rows), len(cols),
                                                                          dtype=torch.bool)
        p = torch.where(keep, torch.exp(s - lse[:, h, rows][..., None]), torch.zeros(()))
        dp = dout[:, rows, h] @ v[:, cols, kvh].transpose(1, 2)
        ds = p * (dp - delta[:, h, rows][..., None])
        return rows, cols, kvh, rnd(p), rnd(ds)

    for kvh in range(KVH):
        for kt in range(nk):
            for h in range(kvh * G, kvh * G + G):
                for qi in range(min(nq, kt) if causal else 0, nq):
                    rows, cols, _, p, ds = tile(qi, kt, h)
                    dv[:, cols, kvh] += p.transpose(1, 2) @ dout[:, rows, h]
                    dk[:, cols, kvh] += ds.transpose(1, 2) @ q[:, rows, h] * scale
    for h in range(H):
        for qi in range(nq):
            for kt in range(min(nk, qi + 1) if causal else nk):
                rows, cols, kvh, _, ds = tile(qi, kt, h)
                dq[:, rows, h] += ds @ k[:, cols, kvh] * scale
    if one_rounding:
        return tuple(t.to(torch.bfloat16) for t in (dq, dk, dv))
    return dq, dk, dv


@pytest.mark.parametrize("S,H,KVH,causal", [(1, 2, 2, True), (100, 6, 2, True),
                                            (130, 3, 1, False), (193, 4, 4, True)])
def test_flash_bwd_tile_walks_give_the_custom_vjp_gradient(S, H, KVH, causal):
    """The kernels' walks (which tiles each block visits, the masks) give
    the gradient of the model attention's custom_vjp (rtol 1e-3, atol 1e-4,
    tests/test_layers.py:121)."""
    rng = np.random.default_rng(S + H)
    qn = rng.normal(size=(2, S, H, 32)).astype(np.float32)
    kn, vn = (rng.normal(size=(2, S, KVH, 32)).astype(np.float32) for _ in range(2))
    dn = rng.normal(size=(2, S, H, 32)).astype(np.float32)
    _, vjp = jax.vjp(lambda q, k, v: jax_model_flash_attention(q, k, v, causal=causal),
                     jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want = vjp(jnp.asarray(dn))
    got = _bwd_by_tiles(*(torch.from_numpy(a) for a in (qn, kn, vn, dn)), causal)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("S,H,KVH,causal", [(77, 9, 3, True), (200, 9, 3, True),
                                            (130, 9, 3, False), (64, 9, 3, True),
                                            (150, 4, 4, True), (100, 4, 1, False)])
def test_flash_bwd_one_bf16_rounding_holds_the_custom_vjp_gradient(S, H, KVH, causal):
    """The bfloat16 kernels' walks, p and ds rounded once to bf16: dq, dk,
    dv within the card's bf16 gate, 2e-2 max|reference| (chip_smoke.py,
    tests/test_torch_gpu.py), of jax.vjp of the model attention's custom_vjp
    on the same bfloat16 inputs at hd 64; smollm's heads (G = 3) at a ragged
    S and at one whole tile, then G = 1 and G = 4."""
    rng = np.random.default_rng(S + H)
    arrays = [rng.normal(size=(2, S, h, 64)).astype(np.float32) for h in (H, KVH, KVH, H)]
    jq, jk, jv, jd = (jnp.asarray(a, dtype=jnp.bfloat16) for a in arrays)
    _, vjp = jax.vjp(lambda q, k, v: jax_model_flash_attention(q, k, v, causal=causal), jq, jk, jv)
    want = vjp(jd)
    got = _bwd_by_tiles(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays), causal,
                        one_rounding=True)
    for a, b in zip(got, want):
        w = np.asarray(b, dtype=np.float32)
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        err = np.abs(a.float().numpy() - w).max()
        assert 0 < err <= 2e-2 * np.abs(w).max(), (err, np.abs(w).max())


# ---- flash_attention: the split KV range and its ordered combine -------------

def _split_kv_model(q, k, v, causal, splits):
    """csrc/flash_attention.cu's arithmetic in plain float32 torch: each q
    tile's KV tiles cut into ``splits`` shares; each share an online softmax
    over its 64-key tiles (m from NEG_INF, masked scores NEG_INF, keys past
    Skv -inf, the scale applied to the f32 scores); the shares combined in
    share order, each weighed by exp(m_s - max m); l clamped at 1e-30."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    G, scale = H // KVH, 1.0 / math.sqrt(hd)
    out = torch.empty((B, Sq, H, hd), dtype=torch.float32)
    for qt in range(math.ceil(Sq / BLOCK_Q)):
        rows = torch.arange(qt * BLOCK_Q, min(Sq, (qt + 1) * BLOCK_Q))
        n = kv_tiles_of(qt, Skv, causal)
        per = math.ceil(n / splits)
        qh = q[:, rows].float()  # (B, R, H, hd)
        parts = []
        for s in range(splits):
            t0, t1 = min(n, s * per), min(n, (s + 1) * per)
            m = torch.full((B, len(rows), H), NEG_INF)
            l = torch.zeros((B, len(rows), H))
            acc = torch.zeros((B, len(rows), H, hd))
            if t1 <= t0:
                parts.append((torch.full_like(m, -math.inf), l, acc))
                continue
            for t in range(t0, t1):
                cols = torch.arange(t * BLOCK_KV, (t + 1) * BLOCK_KV)
                ok = cols < Skv
                kt = torch.zeros((B, BLOCK_KV, KVH, hd))
                vt = torch.zeros((B, BLOCK_KV, KVH, hd))
                kt[:, ok], vt[:, ok] = k[:, cols[ok]].float(), v[:, cols[ok]].float()
                kt, vt = kt.repeat_interleave(G, 2), vt.repeat_interleave(G, 2)
                sc = torch.einsum("brhd,bchd->brhc", qh, kt) * scale
                if causal:
                    sc = sc.masked_fill((cols[None, :] > rows[:, None])[None, :, None, :],
                                        NEG_INF)
                sc = sc.masked_fill(~ok[None, None, None, :], -math.inf)
                m_new = torch.maximum(m, sc.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(sc - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum("brhc,bchd->brhd", p, vt)
                m = m_new
            parts.append((m, l, acc))
        mx = torch.stack([pm for pm, _, _ in parts]).amax(0)
        lt, at = torch.zeros_like(mx), torch.zeros((B, len(rows), H, hd))
        for pm, pl, pa in parts:  # share order
            w = torch.exp(pm - mx)
            lt, at = lt + w * pl, at + w[..., None] * pa
        out[:, rows] = at / torch.clamp(lt, min=1e-30)[..., None]
    return out


@pytest.mark.parametrize("splits", [1, 2, 3, 4])
@pytest.mark.parametrize("b,s,h,kvh,causal", [(1, 150, 4, 2, True), (2, 77, 2, 1, False),
                                               (1, 200, 2, 2, True)])
def test_split_kv_combine_matches_the_jax_kernel(b, s, h, kvh, causal, splits):
    """hd 32, ragged S (the Pallas kernel takes it as one block), several
    KV tiles: every share count, empty shares included, gives the JAX
    kernel's attention within the float32 tolerance."""
    rng = np.random.default_rng(s + splits)
    qn, kn, vn = (rng.normal(size=shape).astype(np.float32)
                  for shape in ((b, s, h, 32), (b, s, kvh, 32), (b, s, kvh, 32)))
    want = np.asarray(jax_flash_attention_gqa(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn),
                                              causal=causal, block_q=s, block_kv=s,
                                              interpret=True))
    got = _split_kv_model(torch.from_numpy(qn), torch.from_numpy(kn), torch.from_numpy(vn),
                          causal, splits).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
    plain = flash_attention_ref(torch.from_numpy(qn), torch.from_numpy(kn),
                                torch.from_numpy(vn), causal=causal).numpy()
    np.testing.assert_allclose(got, plain, rtol=2e-5, atol=1e-6)


# ---- flash_attention: bfloat16 P against bfloat16 V ---------------------------

def _bf16_terms(p, n):
    """p as the sum of ``n`` bfloat16 terms, each the rounding of what the
    ones before left (csrc/flash_attention.cu:split_bf16 for n = 3)."""
    terms, rest = [], p.double()
    for _ in range(n):
        t = rest.float().to(torch.bfloat16).double()
        terms.append(t)
        rest = rest - t
    return terms


def _pv_model(p, v, n):
    """(sum_k p v) / l with P in ``n`` bfloat16 terms against bfloat16 V, each
    product exact and the sum exact (float64), then one rounding to bfloat16."""
    acc = sum(t @ v.double() for t in _bf16_terms(p, n))
    return (acc / p.double().sum(-1, keepdim=True)).float().to(torch.bfloat16)


def _cancelling_case():
    """64 query rows over 512 keys: softmax probabilities of unit-scale
    scores, and a bfloat16 V whose column 0 nearly cancels under every row's
    P (a mean-removed sign pattern) while column 1 is all ones, so max|out|
    is 1 and the cancelling outputs are ~1e-3 of it."""
    rng = np.random.default_rng(11)
    p = torch.softmax(torch.from_numpy(rng.normal(size=(64, 512))).float(), -1)
    v = torch.from_numpy(rng.normal(size=(512, 8))).float()
    sign = torch.from_numpy(np.where(rng.random(512) < 0.5, -1.0, 1.0)).float()
    v[:, 0] = sign * (1 + 0.01 * torch.from_numpy(rng.random(512)).float())
    v[:, 1] = 1.0
    v = v.to(torch.bfloat16)
    col0 = p.double() @ v[:, 0].double()
    assert col0.abs().max() < 0.2  # column 0 cancels
    return p, v


def _one_rounding_ratio(got, want):
    """chip_smoke.py's per-element check: |got - want| over one bfloat16
    rounding of want plus 2e-5 of max|want| (at most 1 to pass)."""
    diff = (got.double() - want.double()).abs()
    limit = 2.0 ** -7 * want.double().abs() + 2e-5 * want.double().abs().max()
    return (diff / limit).max().item()


def test_three_bf16_terms_of_p_hold_one_rounding_where_one_term_fails():
    p, v = _cancelling_case()
    exact = ((p.double() @ v.double()) / p.double().sum(-1, keepdim=True)).float()
    want = exact.to(torch.bfloat16)  # the plain version: f32 result, one rounding
    ratios = {n: _one_rounding_ratio(_pv_model(p, v, n), want) for n in (1, 2, 3)}
    print(f"one-rounding ratio with P in 1, 2, 3 bf16 terms: {ratios}")
    assert ratios[1] > 1.0  # a single bf16 P fails the check on a cancelling sum
    assert ratios[2] <= 1.0 and ratios[3] <= 1.0
    # how far each form sits from the f32 result, before the final rounding
    err = {n: (sum(t @ v.double() for t in _bf16_terms(p, n))
               / p.double().sum(-1, keepdim=True) - exact.double()).abs().max().item()
           for n in (1, 2, 3)}
    assert err[3] < 1e-7 < err[2] < err[1]


# ---- slstm_fused: the plan ---------------------------------------------------

@pytest.mark.parametrize("hd", [1, 8, 16, 32, 40, 64, 96, 128, 200, 256, 320, 330, 512, 1024])
def test_slstm_plan_paths_fit_their_budgets(hd):
    p = slstm_plan(2, 100, 4, hd, torch.bfloat16)
    if p.path == "stream":
        assert p.grid == (4, 2, 1) and p.r_bytes == 16 * hd * hd
        # eight CTAs cannot hold this R in registers
        assert _cluster_plan(2, 4, hd, MAX_CLUSTER) is None
        return
    C, U, KS = p.cluster, p.units, p.k_slices
    assert C in (1, 2, 4, 8) and C <= MAX_CLUSTER and C * U == hd
    assert p.threads == 4 * U * KS <= CLUSTER_THREADS and p.threads % 32 == 0
    assert 32 % (4 * KS) == 0  # a unit's 4 x KS lanes sit in one warp
    assert KS * p.kpt >= hd and p.kpt in REG_KPT
    assert p.grid == (C, 4, 2) and p.r_bytes == 16 * hd * U
    assert p.smem == 4 * 2 * KS * p.kpt <= SMEM_LIMIT
    # C is the smallest power of two that fits: half of it does not
    if C > 1:
        assert _cluster_plan(2, 4, hd, C // 2) is None


def test_slstm_plan_picks_the_cluster_by_shape():
    p32, p256 = (slstm_plan(1, 9, 4, hd, torch.bfloat16) for hd in (32, 256))
    assert (p32.path, p32.cluster) == ("cluster", 1)
    assert (p256.path, p256.cluster, p256.threads, p256.kpt) == ("cluster", 8, 512, 64)
    assert p256.r_bytes == 128 * 1024  # xlstm-350m: 1 MiB of R, 128 KB a CTA
    assert slstm_plan(1, 9, 4, 128, torch.bfloat16).cluster == 2
    assert slstm_plan(1, 9, 4, 320, torch.bfloat16).path == "stream"  # > 64 registers a thread
    assert slstm_plan(1, 9, 4, 330, torch.bfloat16).path == "stream"  # 8 does not divide 330
    assert slstm_plan(1, 9, 4, 512, torch.bfloat16).path == "stream"  # 512 KB a CTA at C = 8
    # the plan depends on the shape alone: not on S, B or the type
    assert {(p.path, p.cluster, p.kpt) for p in (
        slstm_plan(b, s, 4, 256, dt) for b in (1, 3) for s in (1, 999)
        for dt in (torch.float32, torch.bfloat16))} == {("cluster", 8, 64)}


# ---- slstm_fused: the cluster path's sums --------------------------------------

def _cluster_model(gx, rg, num_heads, ks, kpt):
    """The cluster path's arithmetic in plain float32 torch: thread (unit j,
    gate q, slice s) sums h[k] R[q, k, j] over k = 4 (ks m + s) + e into four
    accumulators (e), gx added into slice 0's first; the accumulators are
    added pairwise, the slices by an xor butterfly; then the cell."""
    B, S, _, D = gx.shape
    H, hd = num_heads, D // num_heads
    hp = ks * kpt
    r = torch.zeros((4, H, hp, hd))
    r[:, :, :hd] = rg.float()
    c = torch.zeros((B, H, hd))
    n, h, m = torch.zeros_like(c), torch.zeros_like(c), torch.full_like(c, -1e30)
    out = torch.empty((B, S, D))
    kidx = torch.tensor([[[4 * (ks * mm + s) + e for mm in range(kpt // 4)] for e in range(4)]
                         for s in range(ks)])  # (ks, 4, kpt / 4)
    for t in range(S):
        hpad = torch.zeros((B, H, hp))
        hpad[..., :hd] = h
        g = gx[:, t].float().reshape(B, 4, H, hd)
        # acc[b, q, head, j, s, e] = sum_mm h[k] r[q, head, k, j]
        prod = hpad[:, None, :, kidx, None] * r[None][:, :, :, kidx, :]  # b q H s e mm j
        acc = prod.sum(-2).permute(0, 1, 2, 5, 3, 4).contiguous()  # b q H j s e
        acc[..., 0, 0] += g
        part = (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])  # b q H j s
        off = 1
        while off < ks:  # butterfly: slice s adds slice s ^ off
            part = part + part[..., [s ^ off for s in range(ks)]]
            off *= 2
        it, ft, zt, ot = part[..., 0].unbind(1)
        logf = log_sigmoid(ft)
        m_new = torch.maximum(logf + m, it)
        i, f = torch.exp(it - m_new), torch.exp(logf + m - m_new)
        c = f * c + i * torch.tanh(zt)
        n = f * n + i
        h = torch.sigmoid(ot) * c / torch.clamp(n, min=1e-6)
        m = m_new
        out[:, t] = h.reshape(B, D)
    return out, (c, n, h, m)


@pytest.mark.parametrize("b,s,h,hd", [(1, 37, 2, 32), (2, 16, 1, 64)])
def test_cluster_sum_order_matches_the_jax_kernel(b, s, h, hd):
    """The plan's k slices and k a thread at the shape, against the Pallas
    sLSTM kernel in interpret mode (chunk = S), within the recurrence's
    float32 tolerance."""
    p = slstm_plan(b, s, h, hd, torch.float32)
    assert p.path == "cluster"
    rng = np.random.default_rng(hd + s)
    gx = rng.normal(size=(b, s, 4, h * hd)).astype(np.float32)
    rg = (rng.normal(size=(4, h, hd, hd)) / np.sqrt(hd)).astype(np.float32)
    want = np.asarray(jax_slstm_fused(jnp.asarray(gx), jnp.asarray(rg), h, chunk=s,
                                      interpret=True))
    got, _ = _cluster_model(torch.from_numpy(gx), torch.from_numpy(rg), h, p.k_slices, p.kpt)
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= 2e-4 * scale


# ---- slstm_fused_bwd: the plan and its sums --------------------------------------

@pytest.mark.parametrize("hd", [1, 8, 16, 32, 40, 64, 96, 128, 200, 256, 320, 512])
def test_slstm_bwd_plan_fits_and_follows_the_forward(hd):
    """Every shape the forward runs on a cluster has a backward cluster that
    fits its budgets: a group of 8 rows (the MMA's N), 16 m-tile rows of
    units a CTA and k-tiles of 8 terms covering hd and 4 hd with zero
    padding, R's halves in at most 64 registers a thread, a tiling the
    kernel is built for, one (unit, row) cell for every 4 / m_tiles
    threads, shared memory within 227 KB; the stream path's shapes have
    none."""
    fwd = slstm_plan(2, 100, 4, hd, torch.bfloat16)
    p = plan_bwd(2, 100, 4, hd, torch.bfloat16)
    if fwd.path == "stream":
        assert p is None
        return
    C, U, mt, kt = p.cluster, p.units, p.m_tiles, p.k_tiles
    assert C in (1, 2, 4, 8, MAX_BWD_CLUSTER) and p.rows == BWD_ROWS == 8
    assert U == 16 * mt and C * U >= hd and (C == 1 or C // 2 * U < hd)  # the smallest C
    assert kt in BWD_TILES_K and mt == min(4, BWD_R_REGS // (8 * kt))
    assert p.mnk == (U, 8, BWD_WARPS * kt * 8)
    assert p.mnk[2] >= 4 * hd and (kt == 1 or p.mnk[2] // 2 < 4 * hd)  # the fewest k-tiles
    assert 8 * mt * kt <= BWD_R_REGS  # A's big and small fragments a thread
    assert p.r_bytes == 4 * 8 * mt * kt * p.threads == 8 * U * p.mnk[2]
    assert p.threads == 32 * p.warps == 512 and U * p.rows * (4 // mt) == p.threads
    assert p.grid == (C, 4, 1) and p.smem == bwd_smem(mt, kt) <= SMEM_LIMIT


def test_slstm_bwd_plan_at_the_model_shapes():
    """xlstm-350m's train shape (8, 2048, 4, 256): 16-CTA clusters of 16
    units, 8 k-tiles a warp, 4 clusters of 64 CTAs in all, one CTA an SM
    (512 threads of up to 128 registers fill its register file), so one
    wave where the card holds 4 such clusters (asserted on the card,
    tests/test_torch_gpu.py); the rows of a batch share a cluster, B past 8
    takes more; the reduced configs' hd 32, a cluster of one."""
    p256 = plan_bwd(8, 2048, 4, 256, torch.bfloat16)
    assert (p256.cluster, p256.rows, p256.units, p256.m_tiles, p256.k_tiles, p256.threads) == (
        16, 8, 16, 1, 8, 512)
    assert p256.grid == (16, 4, 1) and p256.clusters == 4 and p256.ctas == 64 <= SMS
    assert p256.smem == 90240 and p256.r_bytes == 128 * 1024  # 64 KB of R a CTA, two halves
    assert p256.mnk == (16, 8, 1024) and p256.product == "mma_sync_3xtf32"
    assert {plan_bwd(b, s, 4, 256, dt).grid for b in (1, 3, 8) for s in (1, 999)
            for dt in (torch.float32, torch.bfloat16)} == {(16, 4, 1)}
    assert plan_bwd(12, 5, 4, 256, torch.float32).grid == (16, 4, 2)
    assert plan_bwd(17, 5, 4, 256, torch.float32).clusters == 12
    p32 = plan_bwd(2, 24, 4, 32, torch.float32)
    assert (p32.cluster, p32.m_tiles, p32.k_tiles, p32.grid) == (1, 4, 1, (1, 4, 1))


BF_MASK = -8192  # 0xFFFFE000: the 19 bits of a TF32 number
BF_TF32_MAX = 3.40116213e38  # 0x7F7FE000, the largest finite TF32


def _tf32_split(t):
    """csrc/com_mma.cuh's saturating split, as tests/test_torch_plan.py
    models it: big = t rounded to TF32 and saturated at TF32_MAX, small =
    t - big, read by the MMA truncated to TF32."""
    bits = t.clamp(-BF_TF32_MAX, BF_TF32_MAX).nan_to_num(-BF_TF32_MAX).contiguous().view(torch.int32)
    big = ((bits + 0x1000) & BF_MASK).view(torch.float32)
    small = ((t - big).contiguous().view(torch.int32) & BF_MASK).view(torch.float32)
    return big, small


def _add_toward_zero(acc, s):
    """acc + s (s exact in float64) rounded toward zero to float32: the
    tensor cores' accumulation (tests/test_torch_plan.py)."""
    f = (acc.double() + s).float()
    over = f.double().abs() > (acc.double() + s).abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _bwd_mma_model(rg, saved, dh, num_heads, p):
    """The backward kernel's arithmetic in plain float32 torch at plan
    ``p``: per head a (C U) x K matrix of R's rows (zero past hd units and
    4 hd terms, k-tile kt holding the 4 gates of units 2 kt and 2 kt + 1)
    times the group's (K, 8) dg_{t+1} (zero columns past B); each k-tile's
    three 3xTF32 passes (big x small', small x big', big x big') on a fresh
    accumulator that truncates, added in order over the warp's k-tiles; the
    16 warps' tiles summed by quarter (warps in order) and the 4 / m_tiles
    quarters by an xor butterfly; then the cell's backward of
    slstm_bwd_ref on its factors (so / n, f sigmoid(-ft), ...). Returns dg
    (B, S, 4, D)."""
    B, S, _, D = saved.shape
    H, hd = num_heads, D // num_heads
    C, U, kt_w, warps = p.cluster, p.units, p.k_tiles, p.warps
    M, N, K = C * U, p.rows, p.mnk[2]
    G = p.grid[2]
    Bp = G * N  # rows padded to whole groups: zero columns
    kt = torch.arange(K) // 8
    u, q = (torch.arange(K) % 8) // 4, torch.arange(K) % 4
    m = 2 * kt + u  # the unit and gate of term k
    ok = m < hd
    a = torch.zeros((H, M, K))  # a[head, j, k] = R[q, head, j, m]
    a[:, :hd, ok] = rg.permute(1, 2, 0, 3)[:, :, q[ok], m[ok]]
    ab, asm = _tf32_split(a)
    ab, asm = (x.double().reshape(H, M, K // 8, 8) for x in (ab, asm))
    sv = torch.zeros((Bp, S, 7, H, hd))
    sv[:B] = saved.reshape(B, S, 7, H, hd)
    dhp = torch.zeros((Bp, S, H, hd))
    dhp[:B] = dh.float().reshape(B, S, H, hd)
    tpc = 4 // p.m_tiles
    wpq = warps // tpc
    dg = torch.zeros((Bp, S, 4, H, hd))
    zero = torch.zeros((Bp, H, hd))
    dc, dn, f_next = zero, zero, zero
    bmat = torch.zeros((Bp, H, K))  # dg_{t+1} by term: zero at S and past hd
    for t in reversed(range(S)):
        bb, bs = (x.double().reshape(Bp, H, K // 8, 8) for x in _tf32_split(bmat))
        d = None
        for x, y in ((ab, bs), (asm, bb), (ab, bb)):  # (b, head, j, k-tile)
            prod = torch.einsum("hjtk,bhtk->bhjt", x, y)
            d = _add_toward_zero(torch.zeros_like(prod, dtype=torch.float32) if d is None else d,
                                 prod)
        d = d.reshape(Bp, H, M, warps, kt_w)
        warp = d[..., 0]
        for j in range(1, kt_w):
            warp = warp + d[..., j]
        quarters = []
        for r in range(tpc):
            s_ = warp[..., r * wpq]
            for v in range(1, wpq):
                s_ = s_ + warp[..., r * wpq + v]
            quarters.append(s_)
        if tpc == 4:
            tot = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])
        elif tpc == 2:
            tot = quarters[0] + quarters[1]
        else:
            tot = quarters[0]
        dht = dhp[:, t] + tot[..., :hd]
        it, ft, zt, ot, c, n, m_t = sv[:, t].unbind(1)
        c_prev, n_prev, m_prev = (sv[:, t - 1, 4:].unbind(1) if t > 0
                                  else (zero, zero, torch.full_like(zero, -1e30)))
        i, f = torch.exp(it - m_t), torch.exp(log_sigmoid(ft) + m_prev - m_t)
        tz, so = torch.tanh(zt), torch.sigmoid(ot)
        dc = dht * (so / n) + dc * f_next
        dn = dht * (-so * c / (n * n)) + dn * f_next
        g = torch.stack(((dc * tz + dn) * i, (dc * c_prev + dn * n_prev) * (f * torch.sigmoid(-ft)),
                         dc * (i * (1 - tz * tz)), dht * ((c / n) * so * (1 - so))), 1)  # b q H j
        g = torch.where(torch.arange(Bp)[:, None, None, None] < B, g, 0.0)  # zero columns
        dg[:, t] = g
        bmat = torch.zeros((Bp, H, K))
        bmat[..., ok] = g[:, q[ok], :, m[ok]].permute(1, 2, 0)
        f_next = f
    return dg[:B].reshape(B, S, 4, D)


@pytest.mark.parametrize("b,s,h,hd", [(1, 37, 2, 32), (3, 16, 1, 64), (8, 20, 2, 16),
                                      (12, 9, 1, 40), (2, 11, 1, 128), (8, 6, 1, 256)])
def test_bwd_cluster_sum_order_matches_the_plain_backward(b, s, h, hd):
    """The backward plan's tiling at the shape (B 3 and 12: zero columns;
    hd 16 and 40: terms past 4 hd and units past hd padded; hd 128 and 256:
    clusters of 4 and 16), the kernel's 3xTF32 products and fixed sum
    order, against slstm_bwd_ref on the same saved state, within the
    reference's gradient tolerance (rtol 1e-3, atol 1e-4 max,
    tests/test_layers.py:121)."""
    p = plan_bwd(b, s, h, hd, torch.float32)
    rng = np.random.default_rng(hd + s + 1)
    gx = torch.from_numpy(rng.normal(size=(b, s, 4, h * hd)).astype(np.float32))
    rg = torch.from_numpy((rng.normal(size=(4, h, hd, hd)) / np.sqrt(hd)).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=(b, s, h * hd)).astype(np.float32))
    _, _, saved = slstm_ref(gx, rg, h, save=True)
    want, _ = slstm_bwd_ref(rg, saved, dh, h)
    got = _bwd_mma_model(rg, saved, dh, h, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-4 * want.abs().max().item())
