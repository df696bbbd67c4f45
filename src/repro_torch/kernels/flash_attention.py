"""``flash_attention``: online-softmax (flash) attention forward, as a CUDA
kernel on the tensor cores, and its backward (:func:`flash_attention_bwd`).

Scores never reach device memory: each block keeps its running max, sum
and f32 accumulator on chip while it walks the KV tiles, the attention
analogue of COM partial sums staying on the ROFM plane. GQA is read in
place: query head ``h`` reads KV head ``h // (H / KVH)``. Where the q tiles
alone leave the card idle, the KV range of each q tile is split over
several blocks, and a second pass combines their partials in a fixed
order, so two calls give the same bits. Asked for it (``return_lse``, what
training does), the forward also writes each row's log-sum-exp, from which
the backward recomputes the weights: a block per (batch row, KV head, key
tile) accumulates dK and dV over the G query heads of its KV head, and a
block per (batch row, head, q tile) accumulates dQ, both without atomics.
In bfloat16 the backward runs on wgmma with its tiles brought by TMA; in
float32 on mma.sync 3xTF32 (:func:`plan_bwd` names the path).

Counterpart of ``repro.kernels.flash_attention`` (``flash_attention`` and
``flash_attention_gqa``) and of the backward of the model's attention
(``repro.models.attention._flash_vjp_bwd``); the kernels are
``src/repro_torch/csrc/flash_attention.cu``, launched as :func:`plan` and
:func:`plan_bwd` say. For a tensor on the CPU the wrappers run the plain
versions (:func:`repro_torch.kernels.ref.flash_attention_ref`,
:func:`~repro_torch.kernels.ref.flash_attention_bwd_ref`); for a CUDA tensor
they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.com_matmul import SMEM_LIMIT, SMS
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (32, 64, 128)  # the head sizes the kernel is instantiated for
BLOCK_Q = 64   # q rows a block (4 warps of 16)
BLOCK_KV = 64  # the kernel's KV tile
THREADS = 128
MAX_SPLITS = 4  # KV splits of a q tile at most
SM_SMEM = 233_472  # shared memory of an SM (228 KB); each block also takes 1 KB
# q, k, v, out, ws_acc, ws_ml, lse, B, Sq, Skv, H, KVH, hd, causal, scale,
# dtype, splits, stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
# q, k, v, out, dout, lse, delta, dq, dk, dv, B, Sq, Skv, H, KVH, hd, causal,
# scale, dtype, stream
_BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


@dataclass(frozen=True)
class Plan:
    """How one attention call is launched: a block of ``threads`` owns a
    ``block_q``-row q tile of one (batch row, head) and walks its share of
    the ``kv_tiles`` KV tiles of ``block_kv`` rows; the KV range of each q
    tile is cut into ``splits`` shares. With more than one, the partials go
    to a ``workspace``-byte buffer that a second kernel combines. ``smem``
    is shared memory a block."""
    block_q: int
    block_kv: int
    threads: int
    q_tiles: int
    kv_tiles: int
    splits: int
    grid: Tuple[int, int, int]
    smem: int
    workspace: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def smem_bytes(hd: int, dtype: torch.dtype) -> int:
    """Shared memory of one block: the q tile and two slots of K and V tiles,
    rows padded as csrc/flash_attention.cu pads them."""
    es = torch.empty((), dtype=dtype).element_size()
    qs, vs = hd + 8, hd + (4 if dtype == torch.float32 else 8)
    return es * (BLOCK_Q * qs + 2 * BLOCK_KV * (qs + vs))


def occupancy(hd: int, dtype: torch.dtype) -> int:
    """Blocks of the kernel an SM is sure to hold: the launch bound's 4
    for bf16 at hd <= 64 (128 registers a thread), else the 2 that a thread's
    255 registers at most leave room for, and no more than the SM's shared
    memory holds (1 at f32 hd 128)."""
    regs = 4 if dtype == torch.bfloat16 and hd <= 64 else 2
    return max(1, min(regs, SM_SMEM // (smem_bytes(hd, dtype) + 1024)))


def kv_tiles_of(q_tile: int, Skv: int, causal: bool) -> int:
    """KV tiles the q tile walks: all of them, or (causal, top-left) those
    that hold a key at or before its last row."""
    n = math.ceil(Skv / BLOCK_KV)
    return min(n, ((q_tile + 1) * BLOCK_Q - 1) // BLOCK_KV + 1) if causal else n


@functools.lru_cache(maxsize=4096)
def plan(B: int, Sq: int, Skv: int, H: int, KVH: int, hd: int, dtype: torch.dtype,
         causal: bool) -> Plan:
    """The launch of one attention call on an H100 (pure: no device is
    asked). A block's KV tiles run one after another, at about the same
    rate whether it has the SM to itself or shares it, so the KV range of
    each q tile is split until the grid holds two waves of
    :func:`occupancy` blocks an SM (the longest q tile's chain of tiles is what a short grid
    waits for), at most ``MAX_SPLITS`` ways and never into more shares than
    the longest q tile has tiles: past four, the combine pass's reads cost
    more than the shorter chains save."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd}; the kernel is built for {HEAD_DIMS}")
    q_tiles = math.ceil(Sq / BLOCK_Q)
    longest = max(kv_tiles_of(i, Skv, causal) for i in range(q_tiles))
    base = B * H * q_tiles
    splits = max(1, min(MAX_SPLITS, longest, math.ceil(2 * occupancy(hd, dtype) * SMS / base),
                        65535 // B))
    return Plan(BLOCK_Q, BLOCK_KV, THREADS, q_tiles, math.ceil(Skv / BLOCK_KV), splits,
                (q_tiles, H, B * splits), smem_bytes(hd, dtype),
                4 * splits * B * H * Sq * (hd + 2) if splits > 1 else 0)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_kv: int, name: str):
    """Raise on what the kernels do not take; returns (B, Sq, Skv, H, KVH, hd)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)} and "
                         f"v {tuple(v.shape)} are not (B, Sq, H, hd) and (B, Skv, KVH, hd)")
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != hd or KVH < 1 or H % KVH:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not serve q {tuple(q.shape)}")
    if Sq < 1 or Skv < 1:
        raise ValueError(f"{name}: empty sequence (Sq={Sq}, Skv={Skv})")
    if q.device.type == "cpu":
        return B, Sq, Skv, H, KVH, hd
    if q.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {q.device}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd}; the kernel is built for {HEAD_DIMS}")
    if block_kv != BLOCK_KV:
        raise ValueError(f"{name}: block_kv {block_kv}; the kernel is built for {BLOCK_KV}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: q, k, v are {q.dtype}, {k.dtype}, {v.dtype}; the "
                        f"kernel takes one of {list(_DTYPES)} for all three")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"{name}: q, k, v are on {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q, k and v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start on a 16-byte boundary")
    if H > 65535:
        raise ValueError(f"{name}: H={H} exceeds the grid's 65535")
    return B, Sq, Skv, H, KVH, hd


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
                    block_kv: int = BLOCK_KV, return_lse: bool = False):
    """q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd) -> (B, Sq, H, hd) in
    ``q.dtype`` (float32 or bfloat16, hd 32, 64 or 128 on the card). The
    causal mask is top-left aligned (``k_pos <= q_pos``). ``block_kv``
    names the kernel's KV tile, which is built as ``BLOCK_KV`` only; the
    plain version has none. With ``return_lse``, returns ``(out, lse)``,
    ``lse`` each row's float32 log-sum-exp of the scaled scores ``(B, H,
    Sq)``; ``out`` has the same bits either way."""
    B, Sq, Skv, H, KVH, hd = _check(q, k, v, block_kv, "flash_attention")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, return_lse=return_lse)
    return _launch(q, k, v, bool(causal), plan(B, Sq, Skv, H, KVH, hd, q.dtype, bool(causal)),
                   return_lse)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, p: Plan,
            return_lse: bool):
    """Launch the kernel (and, split, its combine pass) as ``p`` says on
    checked inputs; with ``return_lse`` it also writes lse."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    ws = (torch.empty(p.workspace // 4, dtype=torch.float32, device=q.device)
          if p.workspace else None)
    rows = B * H * Sq
    kernel = _build.function("flash_attention", "repro_flash_attention", _ARGTYPES)
    err = _build.call(
        kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if ws is None else ws.data_ptr() + 4 * p.splits * rows * hd,
        None if lse is None else lse.data_ptr(),
        B, Sq, Skv, H, KVH, hd, int(causal), 1.0 / math.sqrt(hd), _DTYPES[q.dtype], p.splits)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


# wrapper calls that launched the kernel (the combine pass included) since the
# last reset (plain integer; set it to 0 to reset)
flash_attention.launches = 0


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------


# the bfloat16 backward (csrc/flash_attention.cu, flash_bwd_*_wgmma_kernel)
BWD_STAGES = {32: 3, 64: 3, 128: 2}  # TMA ring slots by head dim (WT<HD>::STAGES)
BWD_PATHS = {torch.bfloat16: "wgmma", torch.float32: "mma_sync_3xtf32"}
# tensor-core passes over an unmasked (q, k) pair and head: 7 products (s and
# dp in both kernels, dv, dk, dq), once each in bf16 (p and ds rounded once),
# three TF32 passes each in f32
BWD_PASSES = {torch.bfloat16: 7, torch.float32: 21}


@dataclass(frozen=True)
class BwdPlan:
    """How one backward call is launched. ``path`` names the kernels:
    ``"wgmma"`` (bfloat16: every product on wgmma, the walked tiles brought
    by TMA into a ring of ``stages`` slots, p and ds rounded once to bf16)
    or ``"mma_sync_3xtf32"`` (float32: mma.sync 3xTF32, a two-slot cp.async
    ring). A ``delta`` pass of ``delta_blocks`` blocks (a warp a row) runs
    first (for bfloat16 it also writes lse * log2(e), both on rows padded to
    a multiple of 64). Then the dK/dV kernel on ``grid_dkdv`` (blocks of
    ``block_kv`` keys, KV heads, batch rows), each block walking up to
    ``q_tiles_dkdv`` (head, ``block_q``-row q tile) pairs, and the dQ kernel
    on ``grid_dq`` (blocks of ``block_q`` q rows, heads, batch rows), each
    walking up to ``kv_tiles_dq`` ``block_kv``-key tiles; ``threads`` a
    block (bfloat16: one warpgroup). ``smem_*`` is shared memory a block,
    ``workspace`` the bytes of those rows, and ``mma_passes_per_pair`` the
    tensor-core passes over each unmasked (q, k) pair and head."""
    path: str
    block_q: int
    block_kv: int
    threads: int
    stages: int
    delta_blocks: int
    grid_dkdv: Tuple[int, int, int]
    grid_dq: Tuple[int, int, int]
    q_tiles_dkdv: int
    kv_tiles_dq: int
    smem_dkdv: int
    smem_dq: int
    workspace: int
    mma_passes_per_pair: int


def bwd_smem_bytes(hd: int, dtype: torch.dtype) -> Tuple[int, int]:
    """Shared memory of a dK/dV block and of a dQ block.

    bfloat16 (``BwdSmem`` in the source): the block's own two kinds of
    tiles (K and V; q and dout), ``BWD_STAGES[hd]`` ring slots of two walked
    tiles (q and dout; K and V), for dK/dV each slot's 64 lse and 64 delta
    values, an mbarrier for the own tiles and one a slot, and 1024 bytes
    that aligning the swizzled tiles may skip; a tile is 64 rows of hd bf16.
    float32: six [64][hd + 8] tiles each (the dK/dV block's K and V and two
    slots of q and dout; the dQ block's q and dout and two slots of K and V),
    plus two slots of 64 lse and 64 delta values for the dK/dV block."""
    if dtype == torch.bfloat16:
        tile, stages = 2 * BLOCK_Q * hd, BWD_STAGES[hd]
        walked = 2 * tile + stages * 2 * tile
        bars = 8 * (1 + stages) + 1024
        return walked + stages * 2 * BLOCK_Q * 4 + bars, walked + bars
    es = torch.empty((), dtype=dtype).element_size()
    tiles = 6 * es * BLOCK_Q * (hd + 8)
    return tiles + 2 * 2 * BLOCK_Q * 4, tiles


def bwd_workspace(B: int, Sq: int, H: int, dtype: torch.dtype) -> int:
    """Bytes of the backward's workspace: float32 delta (B, H, Sq); for
    bfloat16 delta and lse * log2(e), each (B, H, SqP) with the rows padded
    with zeros to SqP = 64 * ceil(Sq / 64), so that every 64-float TMA box
    starts 256-byte aligned."""
    if dtype == torch.bfloat16:
        return 2 * 4 * B * H * BLOCK_Q * math.ceil(Sq / BLOCK_Q)
    return 4 * B * H * Sq


@functools.lru_cache(maxsize=4096)
def plan_bwd(B: int, Sq: int, Skv: int, H: int, KVH: int, hd: int, dtype: torch.dtype,
             causal: bool) -> BwdPlan:
    """The launch of one backward call on an H100 (pure: no device is
    asked). No split: the dK/dV grid has ``B * KVH * ceil(Skv / 64)``
    blocks and the dQ grid ``B * H * ceil(Sq / 64)``, each summing its
    tiles in a fixed order, with no atomics."""
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {hd}; the kernel is built for "
                         f"{HEAD_DIMS}")
    if dtype not in BWD_PATHS:
        raise TypeError(f"flash_attention_bwd: no kernel for {dtype}")
    wgmma = dtype == torch.bfloat16
    q_blocks, kv_blocks = math.ceil(Sq / BLOCK_Q), math.ceil(Skv / BLOCK_KV)
    G = H // KVH
    # the longest walks: the first key block's (causal: from the diagonal
    # down) and the last q block's (up to the diagonal of its last row)
    walk_dq = math.ceil(Skv / BLOCK_KV)
    if causal:
        walk_dq = min(walk_dq, (q_blocks * BLOCK_Q - 1) // BLOCK_KV + 1)
    smem_dkdv, smem_dq = bwd_smem_bytes(hd, dtype)
    stat_rows = bwd_workspace(B, Sq, H, dtype) // (8 if wgmma else 4)  # a warp a row
    return BwdPlan(BWD_PATHS[dtype], BLOCK_Q, BLOCK_KV, THREADS,
                   BWD_STAGES[hd] if wgmma else 2, math.ceil(stat_rows / 8),
                   (kv_blocks, KVH, B), (q_blocks, H, B), G * math.ceil(Sq / BLOCK_Q), walk_dq,
                   smem_dkdv, smem_dq, bwd_workspace(B, Sq, H, dtype), BWD_PASSES[dtype])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
                        lse: torch.Tensor, dout: torch.Tensor, *, causal: bool = True,
                        block_kv: int = BLOCK_KV) -> Tuple[torch.Tensor, ...]:
    """The gradient of :func:`flash_attention`: ``(dq, dk, dv)`` in the
    inputs' dtype from q, k, v, the forward's ``out`` and float32 ``lse``
    ``(B, H, Sq)`` (``return_lse=True``), and ``dout`` (B, Sq, H, hd). For
    CPU tensors the plain version; for CUDA tensors the kernels or a raise."""
    B, Sq, Skv, H, KVH, hd = _check(q, k, v, block_kv, "flash_attention_bwd")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    if tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"flash_attention_bwd: lse {tuple(lse.shape)} is not (B, H, Sq) = "
                         f"{(B, H, Sq)}")
    if q.device.type == "cpu":
        for name, t in (("out", out), ("lse", lse), ("dout", dout)):
            if t.device.type != "cpu":
                raise ValueError(f"flash_attention_bwd: q is on the CPU, {name} on {t.device}")
        return flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
    for name, t in (("out", out), ("lse", lse), ("dout", dout)):
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: q is on {q.device}, {name} on {t.device}")
    if out.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: out {out.dtype}, dout {dout.dtype} must be "
                        f"{q.dtype} and lse {lse.dtype} float32")
    out, dout, lse = out.contiguous(), dout.contiguous(), lse.contiguous()
    if any(t.data_ptr() % 16 for t in (out, dout)):
        raise ValueError("flash_attention_bwd: out and dout must start on a 16-byte boundary")
    p = plan_bwd(B, Sq, Skv, H, KVH, hd, q.dtype, bool(causal))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty(p.workspace // 4, dtype=torch.float32, device=q.device)
    kernel = _build.function("flash_attention", "repro_flash_attention_bwd", _BWD_ARGTYPES)
    err = _build.call(
        kernel, q.device, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, Sq, Skv, H, KVH, hd, int(bool(causal)), 1.0 / math.sqrt(hd),
        _DTYPES[q.dtype])
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


# wrapper calls that launched the backward (its three kernels) since the last
# reset (plain integer; set it to 0 to reset)
flash_attention_bwd.launches = 0
