"""``com_matmul``: tiled matmul with the fused ROFM epilogue, as a CUDA kernel.

Domino's PE (CIM crossbar MAC) + ROFM inter-memory functions (Tab. II):
the K loop accumulates partial sums in f32 registers (the analogue of
partial sums riding the ROFM plane), and the epilogue (Add = bias, Act =
relu/silu/gelu, Bp = residual) is applied after the last K step, before
the single store. Where the output tiles alone leave SMs idle, K is split:
each split's f32 partial sums go to a workspace and a second pass adds
them in a fixed order before the epilogue, so two calls give the same bits.

Counterpart of ``repro.kernels.com_matmul``; the kernel is
``src/repro_torch/csrc/com_matmul.cu`` on the tensor-core mainloop of
``csrc/com_mma.cuh``, launched as :func:`plan` says. For a tensor on the
CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.com_matmul_ref`); for a CUDA tensor it
launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ACTIVATIONS, com_matmul_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, w, bias, residual, out, workspace, M, N, K, act, dtype, path, stages,
# splits, kchunk, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

# the geometry of csrc/com_mma.cuh and the card it is planned for
SMS = 132                # SMs of an H100 SXM
SMEM_LIMIT = 232_448     # shared memory a block may use (227 KB)
BM, BN = 128, 64         # block tile of the tensor-core path
BK = {torch.float32: 64, torch.bfloat16: 64}   # k-tile of the tensor-core path
A_PAD = 8                # A row padding (elements)
B_PAD = {torch.float32: 4, torch.bfloat16: 8}  # B row padding (elements)
SKINNY_M = 32            # M at or below this streams w on CUDA cores
SKINNY_COLS = 128        # w columns a streaming block owns
SKINNY_MIN_ROWS = 64     # fewest K rows a streaming split walks
SKINNY_BLOCKS = 2 * SMS  # streaming blocks: one full wave at two an SM (a tail wave
                         # would stream its slices at a fraction of the card's rate)


@dataclass(frozen=True)
class Plan:
    """How one product is launched. ``path`` is ``"mma"`` (tensor-core
    tiles of ``bm`` x ``bn``, two an SM, a ring of ``stages`` k-tiles of
    ``bk``) or
    ``"skinny"`` (M <= 32: a ``bn``-column panel of w a block, streamed on
    CUDA cores). K is cut into ``splits`` slices of ``kchunk`` elements;
    with more than one, each writes f32 partials into a ``workspace``-byte
    buffer and a second kernel sums them in order. ``max_splits`` is the
    most the planner would take; ``smem`` is shared memory a block."""
    path: str
    bm: int
    bn: int
    bk: int
    stages: int
    splits: int
    kchunk: int
    max_splits: int
    grid: Tuple[int, int, int]
    smem: int
    workspace: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def split_k(tiles: int, k_tiles: int, tile_us: float, out_bytes: int, per_sm: int,
            min_k_tiles: int = 4) -> Tuple[int, int, int]:
    """``(k-tiles a split, splits, max splits)`` for ``tiles`` output tiles
    over ``k_tiles`` k-tiles, ``per_sm`` blocks an SM. Each split keeps at least
    ``min_k_tiles`` (so the ring fills), and the splits give at least
    ``SMS`` blocks where the K range allows. Among those, the least modelled
    time: waves x (k-tiles a block + 2 for the ring's fill and the epilogue)
    x ``tile_us``, plus the split-K traffic (``splits`` f32 slices of
    ``out_bytes`` written and read back, the output written) at 3.35 TB/s;
    ties go to fewer splits."""
    s_max = max(1, min(64, k_tiles // min_k_tiles))
    options = []
    for s in range(1, s_max + 1):
        chunk = max(1, math.ceil(k_tiles / s))
        splits = max(1, math.ceil(k_tiles / chunk))
        us = math.ceil(tiles * splits / (per_sm * SMS)) * (chunk + 2) * tile_us * per_sm
        if splits > 1:
            us += (2 * splits + 1) * out_bytes / 3.35e6
        options.append((tiles * splits < SMS, us, splits, chunk))
    _, _, splits, chunk = min(options)
    return chunk, splits, s_max


def tile_us(bk: int, dtype: torch.dtype) -> float:
    """Modelled time of one k-tile (``bk`` deep) of a block alone on an SM:
    its MMAs (three TF32 passes for float32) at half the card's tensor-core
    peak shared by the SMs."""
    passes, peak = (3, 495e12) if dtype == torch.float32 else (1, 989e12)
    return 2 * BM * BN * bk * passes / (0.5 * peak / SMS) * 1e6


def ring(stage_bytes: int) -> Tuple[int, int]:
    """``(stages, bytes)``: the deepest ring of 2-4 slots that keeps two blocks
    an SM (an SM has 228 KB, 1 KB of it reserved a block), else 2."""
    for stages in (4, 3, 2):
        if 2 * (stages * stage_bytes + 1024) <= 233_472:
            break
    return stages, stages * stage_bytes


def blocks_per_sm(smem: int) -> int:
    """Blocks of the tensor-core path an SM holds: 8 warps within 128
    registers each, so two where their shared memory fits (an SM has 228 KB,
    1 KB of it reserved a block)."""
    return 2 if 2 * (smem + 1024) <= 233_472 else 1


@functools.lru_cache(maxsize=1024)
def plan(M: int, N: int, K: int, dtype: torch.dtype) -> Plan:
    """The launch of ``(M, K) @ (K, N)`` in ``dtype`` on an H100 (pure: no
    device is asked)."""
    es = torch.empty((), dtype=dtype).element_size()
    if M <= SKINNY_M:
        panels = math.ceil(N / SKINNY_COLS)
        s_max = max(1, math.ceil(K / SKINNY_MIN_ROWS))
        splits = min(max(1, SKINNY_BLOCKS // panels), s_max)  # one wave: no tail
        kchunk = max(1, math.ceil(K / splits))
        splits = max(1, math.ceil(K / kchunk))
        return Plan("skinny", M, SKINNY_COLS, 1, 1, splits, kchunk, s_max, (panels, splits, 1),
                    8 * 8 * SKINNY_COLS * 4, 4 * splits * M * N if splits > 1 else 0)
    bk = BK[dtype]
    tiles = math.ceil(M / BM) * math.ceil(N / BN)
    stages, smem = ring((BM * (bk + A_PAD) + bk * (BN + B_PAD[dtype])) * es)
    kps, splits, s_max = split_k(tiles, math.ceil(K / bk), tile_us(bk, dtype), 4 * M * N,
                                 blocks_per_sm(smem))
    return Plan("mma", BM, BN, bk, stages, splits, kps * bk, s_max,
                (math.ceil(M / BM), math.ceil(N / BN), splits), smem,
                4 * splits * M * N if splits > 1 else 0)


def _check(name, t, want_shape, dtype, device):
    if t.shape != want_shape:
        raise ValueError(f"com_matmul: {name} has shape {tuple(t.shape)}, expected {want_shape}")
    if t.dtype != dtype:
        raise TypeError(f"com_matmul: {name} is {t.dtype}, x is {dtype}")
    if t.device != device:
        raise ValueError(f"com_matmul: {name} is on {t.device}, x is on {device}")
    if not t.is_contiguous():
        raise ValueError(f"com_matmul: {name} must be contiguous")


def com_matmul(x: torch.Tensor, w: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
               activation: Optional[str] = None,
               residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (M, K), w: (K, N) -> (M, N) in ``x.dtype`` (float32 or bfloat16),
    ``act(x @ w + bias) + residual`` with an f32 accumulator."""
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; expected one of {ACTIVATIONS}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"com_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)} do not chain")
    if x.device.type == "cpu":
        return com_matmul_ref(x, w, bias=bias, activation=activation, residual=residual)
    if x.device.type != "cuda":
        raise ValueError(f"com_matmul: no kernel for device {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"com_matmul: x is {x.dtype}; the kernel takes {list(_DTYPES)}")
    M, K = x.shape
    N = w.shape[1]
    _check("x", x, (M, K), x.dtype, x.device)
    _check("w", w, (K, N), x.dtype, x.device)
    if bias is not None:
        _check("bias", bias, (N,), x.dtype, x.device)
    if residual is not None:
        _check("residual", residual, (M, N), x.dtype, x.device)
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = plan(M, N, K, x.dtype)
    ws = (torch.empty(p.workspace // 4, dtype=torch.float32, device=x.device)
          if p.workspace else None)
    kernel = _build.function("com_matmul", "repro_com_matmul", _ARGTYPES)
    err = _build.call(
        kernel, x.device, x.data_ptr(), w.data_ptr(),
        None if bias is None else bias.data_ptr(),
        None if residual is None else residual.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        M, N, K, ACTIVATIONS.index(activation), _DTYPES[x.dtype],
        int(p.path == "skinny"), p.stages, p.splits, p.kchunk)
    if err != 0:
        raise RuntimeError(f"com_matmul kernel launch failed: CUDA error {err}")
    com_matmul.launches += 1
    return out


# wrapper calls that launched the kernel (the split-K pass included) since the
# last reset (plain integer; set it to 0 to reset)
com_matmul.launches = 0


def com_matmul_padded(x: torch.Tensor, w: torch.Tensor, *, bias: Optional[torch.Tensor] = None,
                      activation: Optional[str] = None) -> torch.Tensor:
    """:func:`com_matmul` for arbitrary (unaligned) shapes — the name the
    JAX package's executor calls. The kernel masks its ragged edges
    itself, so nothing is padded."""
    return com_matmul(x, w, bias=bias, activation=activation)
