"""``conv2d_com``: direct convolution WITHOUT im2col (paper §III-B), as a
CUDA kernel.

Domino's central dataflow claim: convolution as K² kernel-position partial
sums accumulated on the move — the Toeplitz/im2col matrix is never
materialized. The kernel holds an input halo tile in shared memory and
re-slices it for every kernel position (the RIFM's in-buffer shift), the
partial sums of the K² shifted products accumulating in f32 registers with
one store and a fused activation at the end.

Counterpart of ``repro.kernels.conv2d_com``; the kernel is
``src/repro_torch/csrc/conv2d_com.cu``, an implicit GEMM on the tensor-core
mainloop of ``csrc/com_mma.cuh``, launched as :func:`plan` says. For a tensor on the CPU the
wrapper runs the plain version (:func:`repro_torch.kernels.ref.conv2d_com_ref`);
for a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.com_matmul import (
    A_PAD, B_PAD, BN, SMEM_LIMIT, blocks_per_sm, split_k, tile_us)
from repro_torch.kernels.ref import conv2d_com_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, w, out, workspace, H, W, C, K, M, stride, pad, H_out, W_out, relu, dtype,
# stages, splits, k-tiles a split, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
TILE = (8, 16)  # output pixels of a block (rows, columns): BM in all
BK = {torch.float32: 32, torch.bfloat16: 64}  # channels of a chunk (ConvLayout in the .cu)


@dataclass(frozen=True)
class ConvPlan:
    """How one convolution is launched: blocks of ``tile`` output pixels x
    ``bn`` output channels; the k-tiles are (channel chunk of ``bk``, kernel
    position) pairs, ``k_tiles`` of them, cut into ``splits`` slices of
    ``kps``; ``halo_buffers`` input halo tiles (pixels ``halo_stride``
    elements apart) and ``stages`` weight slots in ``smem`` bytes of shared
    memory; ``workspace`` bytes of f32 partials
    where ``splits`` > 1. ``max_splits`` is the most the planner would take."""
    bn: int
    bk: int
    tile: Tuple[int, int]
    stages: int
    halo_buffers: int
    halo_stride: int
    k_tiles: int
    splits: int
    kps: int
    max_splits: int
    grid: Tuple[int, int, int]
    smem: int
    workspace: int

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


@functools.lru_cache(maxsize=1024)
def plan(H: int, W: int, C: int, K: int, M: int, stride: int, padding: int,
         dtype: torch.dtype) -> ConvPlan:
    """The launch of one (H, W, C) image through (K, K, C, M) weights on an
    H100 (pure: no device is asked). Takes the deepest weight ring (4 slots,
    else 3, else 2) whose halo buffers and slots fit in shared memory, and
    raises ``ValueError`` where none does (a large kernel at a large stride)."""
    es = torch.empty((), dtype=dtype).element_size()
    bk = BK[dtype]
    th, tw = TILE
    Ho = (H + 2 * padding - K) // stride + 1
    Wo = (W + 2 * padding - K) // stride + 1
    pixels = ((th - 1) * stride + K) * ((tw - 1) * stride + K)
    # as conv_smem() in csrc/conv2d_com.cu: the deepest ring that fits, its
    # halo pixels padded by 8 elements, else (float32) by 4
    fits = [(stages, pad) for stages in (4, 3, 2) for pad in (A_PAD, 4)
            if pad == A_PAD or es == 4]
    for stages, pad in fits:
        nh = (stages - 2) // (K * K) + 2  # as halo_buffers() in csrc/conv2d_com.cu
        smem = (nh * pixels * (bk + pad) + stages * bk * (BN + B_PAD[dtype])) * es
        if smem <= SMEM_LIMIT:
            break
    else:
        raise ValueError(f"conv2d_com: a {K}x{K} kernel at stride {stride} needs {smem} bytes "
                         f"of shared memory a block, more than {SMEM_LIMIT}")
    pixel_tiles = math.ceil(Ho / th) * math.ceil(Wo / tw)
    tiles = pixel_tiles * math.ceil(M / BN)
    k_tiles = math.ceil(C / bk) * K * K
    kps, splits, s_max = split_k(tiles, k_tiles, tile_us(bk, dtype), 4 * Ho * Wo * M,
                                 blocks_per_sm(smem))
    return ConvPlan(BN, bk, TILE, stages, nh, bk + pad, k_tiles, splits, kps, s_max,
                    (pixel_tiles, math.ceil(M / BN), splits), smem,
                    4 * splits * Ho * Wo * M if splits > 1 else 0)


def conv2d_com(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, padding: int = 1,
               activation: Optional[str] = None) -> torch.Tensor:
    """x: (H, W, C); w: (K, K, C, M) -> (H_out, W_out, M) in ``x.dtype``
    (float32 or bfloat16). ``activation`` is ``"relu"`` or ``None``."""
    if activation not in (None, "relu"):
        raise ValueError(f"conv2d_com: activation {activation!r}; expected 'relu' or None")
    if x.dim() != 3 or w.dim() != 4 or w.shape[0] != w.shape[1] or w.shape[2] != x.shape[2]:
        raise ValueError(
            f"conv2d_com: x {tuple(x.shape)} and w {tuple(w.shape)} are not (H, W, C) "
            "and (K, K, C, M)")
    H, W, C = x.shape
    K, M = w.shape[0], w.shape[3]
    if stride < 1 or padding < 0:
        raise ValueError(f"conv2d_com: stride {stride} and padding {padding}")
    H_out = (H + 2 * padding - K) // stride + 1
    W_out = (W + 2 * padding - K) // stride + 1
    if H_out < 1 or W_out < 1:
        raise ValueError(f"conv2d_com: a {K}x{K} kernel does not fit a padded {H}x{W} image")
    if x.device.type == "cpu":
        return conv2d_com_ref(x, w, stride=stride, padding=padding, activation=activation)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_com: no kernel for device {x.device}")
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"conv2d_com: x is {x.dtype}, w is {w.dtype}; the kernel takes "
                        f"one of {list(_DTYPES)} for both")
    if w.device != x.device:
        raise ValueError(f"conv2d_com: w is on {w.device}, x is on {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("conv2d_com: x and w must be contiguous")
    out = torch.empty((H_out, W_out, M), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    p = plan(H, W, C, K, M, stride, padding, x.dtype)
    ws = (torch.empty(p.workspace // 4, dtype=torch.float32, device=x.device)
          if p.workspace else None)
    kernel = _build.function("conv2d_com", "repro_conv2d_com", _ARGTYPES)
    err = _build.call(
        kernel, x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), H, W, C, K, M, stride, padding, H_out, W_out,
        int(activation == "relu"), _DTYPES[x.dtype], p.stages, p.splits, p.kps)
    if err != 0:
        raise RuntimeError(f"conv2d_com kernel launch failed: CUDA error {err}")
    conv2d_com.launches += 1
    return out


# wrapper calls that launched the kernel (the split-K pass included) since the
# last reset (plain integer; set it to 0 to reset)
conv2d_com.launches = 0
