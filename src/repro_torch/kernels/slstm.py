"""``slstm_fused``: the sLSTM recurrence of xLSTM, as a CUDA kernel.

A thread-block cluster owns one (batch row, head) for the whole sequence:
its CTAs load the head's recurrent weights R once, keep them in registers
and trade each step's ``h`` through distributed shared memory, one cluster
barrier a step; the cell state stays on chip and only the gate
pre-activations in and ``h`` out cross device memory, the recurrence's
analogue of COM partial sums staying on the ROFM plane. A head whose R
cannot fit the registers of eight CTAs takes the second path, one block per
(row, head) streaming R from L2 every step. :func:`plan` picks the path by
shape. The input-side projection ``gx = x @ wg + bg`` stays
outside the kernel, as in the reference.

Counterpart of ``repro.kernels.slstm`` (``slstm_fused`` and
``hbm_traffic_model``); the kernel is ``src/repro_torch/csrc/slstm.cu``.
Unlike the Pallas kernel it also returns the final ``(c, n, h, m)`` state,
which a prefill writes into the model's cache, and it takes any ``S >= 1``.
For a tensor on the CPU the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.slstm_ref`); for a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import slstm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 1024  # the stream path: one thread a hidden unit
MAX_CLUSTER = 8      # CTAs a cluster (the portable limit)
CLUSTER_THREADS = 512  # threads of a cluster CTA at most (128 registers each)
REG_KPT = (8, 16, 32, 64)  # k a thread is built for (R in at most 64 registers)
# gx, R, h_out, c, n, h, m, B, S, H, hd, dtype, path, C, KS, kpt, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


@dataclass(frozen=True)
class Plan:
    """How one recurrence is launched. ``path`` is ``"cluster"`` (a cluster
    of ``cluster`` CTAs per (row, head); CTA r owns ``units`` hidden units,
    its ``threads`` threads each sum ``kpt`` k of one gate of one unit, the
    ``k_slices`` slices of a gate meeting by warp shuffles; R lives in
    registers, ``r_bytes`` a CTA) or ``"stream"`` (one block per (row,
    head) streams R from L2 every step). ``smem`` is dynamic shared memory
    a CTA (the stream path sizes its own)."""
    path: str
    cluster: int
    units: int
    k_slices: int
    kpt: int
    threads: int
    grid: Tuple[int, int, int]
    smem: int
    r_bytes: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _cluster_plan(B: int, H: int, hd: int, C: int):
    """The cluster launch with ``C`` CTAs a head, or None where a CTA's
    slice of R does not fit its threads' registers."""
    if hd % C:
        return None
    units = hd // C
    ks = next((k for k in (8, 4, 2, 1) if 4 * units * k <= CLUSTER_THREADS), None)
    if ks is None or (4 * units * ks) % 32:
        return None
    threads = 4 * units * ks
    kpt = next((k for k in REG_KPT if k >= hd / ks), None)
    if kpt is None:
        return None
    return Plan("cluster", C, units, ks, kpt, threads, (C, H, B), 4 * 2 * ks * kpt,
                16 * hd * units)


@functools.lru_cache(maxsize=1024)
def plan(B: int, S: int, H: int, hd: int, dtype: torch.dtype) -> Plan:
    """The launch of a ``(B, S, 4, H*hd)`` recurrence on an H100 (pure: no
    device is asked; ``S`` and ``dtype`` do not change it). The cluster path
    with C the smallest power of two <= 8 whose CTA slice of R fits its
    threads' registers (64 a thread at 512 threads, 128 KB); where eight CTAs
    are not enough (hd above 256), the stream path."""
    C = 1
    while C <= MAX_CLUSTER:
        p = _cluster_plan(B, H, hd, C)
        if p is not None:
            return p
        C *= 2
    # the stream kernel's own sizing (csrc/slstm.cu, launch): float4 rows of R,
    # k slices of at least 8 rows, at most 512 workers
    jg = hd // 4 if hd % 4 == 0 else hd
    ks = max(1, min(512 // jg, hd // 8))
    return Plan("stream", 1, hd, ks, math.ceil(hd / ks),
                32 * math.ceil(max(jg * ks, hd) / 32), (H, B, 1),
                4 * (4 * math.ceil(hd / 4) + ks * 4 * hd), 16 * hd * hd)


def slstm_fused(gx: torch.Tensor, rg: torch.Tensor, num_heads: int
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """gx: ``(B, S, 4, D)`` gate pre-activations (float32 or bfloat16 on
    the card); rg: ``(4, H, hd, hd)`` float32 recurrent weights. Returns
    ``h`` ``(B, S, D)`` in ``gx.dtype`` and the final state ``(c, n, h, m)``,
    each float32 ``(B, H, hd)``."""
    if gx.dim() != 4 or gx.shape[2] != 4:
        raise ValueError(f"slstm_fused: gx {tuple(gx.shape)} is not (B, S, 4, D)")
    B, S, _, D = gx.shape
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"slstm_fused: D={D} does not split into {num_heads} heads")
    hd = D // num_heads
    if tuple(rg.shape) != (4, num_heads, hd, hd):
        raise ValueError(f"slstm_fused: rg {tuple(rg.shape)} is not "
                         f"{(4, num_heads, hd, hd)} for gx {tuple(gx.shape)}")
    if B < 1 or S < 1:
        raise ValueError(f"slstm_fused: empty batch or sequence (B={B}, S={S})")
    if gx.device.type == "cpu":
        return slstm_ref(gx, rg, num_heads)
    if gx.device.type != "cuda":
        raise ValueError(f"slstm_fused: no kernel for device {gx.device}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"slstm_fused: head_dim {hd} > {MAX_HEAD_DIM}")
    if gx.dtype not in _DTYPES or rg.dtype != torch.float32:
        raise TypeError(f"slstm_fused: gx is {gx.dtype} and rg {rg.dtype}; the kernel takes "
                        f"gx in one of {list(_DTYPES)} and rg in torch.float32")
    if rg.device != gx.device:
        raise ValueError(f"slstm_fused: gx is on {gx.device}, rg on {rg.device}")
    if not (gx.is_contiguous() and rg.is_contiguous()):
        raise ValueError("slstm_fused: gx and rg must be contiguous")
    if B > 65535:
        raise ValueError(f"slstm_fused: B={B} exceeds the grid's 65535")
    if num_heads > 65535:
        raise ValueError(f"slstm_fused: H={num_heads} exceeds the grid's 65535")
    return _launch(gx, rg, plan(B, S, num_heads, hd, gx.dtype))


def _launch(gx: torch.Tensor, rg: torch.Tensor, p: Plan):
    """Launch the kernel as ``p`` says on checked inputs."""
    B, S, _, D = gx.shape
    H = rg.shape[1]
    hd = D // H
    h_out = torch.empty((B, S, D), dtype=gx.dtype, device=gx.device)
    state = tuple(torch.empty((B, H, hd), dtype=torch.float32, device=gx.device)
                  for _ in range(4))
    kernel = _build.function("slstm", "repro_slstm", _ARGTYPES)
    err = _build.call(kernel, gx.device, gx.data_ptr(), rg.data_ptr(), h_out.data_ptr(),
                      *(t.data_ptr() for t in state), B, S, H, hd, _DTYPES[gx.dtype],
                      int(p.path == "stream"), p.cluster, p.k_slices, p.kpt)
    if err != 0:
        raise RuntimeError(f"slstm_fused kernel launch failed: CUDA error {err}")
    slstm_fused.launches += 1
    return h_out, state


# kernel launches since the last reset (plain integer; set it to 0 to reset)
slstm_fused.launches = 0


def hbm_traffic_model(B, S, D, num_heads, dtype_bytes=2):
    """Analytic HBM bytes per layer per sequence: baseline scan vs fused."""
    hd = D // num_heads
    r_bytes = 4 * num_heads * hd * hd * 4
    state_bytes = 4 * num_heads * hd * B * 4
    baseline = S * (r_bytes + 2 * state_bytes + 4 * D * B * dtype_bytes)
    fused = B * S * 4 * D * dtype_bytes + B * S * D * dtype_bytes + r_bytes
    return {"baseline_bytes": baseline, "fused_bytes": fused,
            "reduction_x": baseline / fused}
