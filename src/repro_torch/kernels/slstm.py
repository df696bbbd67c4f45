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
With ``save=True`` (training) the cluster path also writes the per-step
state its backward reads, and :func:`slstm_fused_bwd` is that backward: a
second kernel of ``csrc/slstm.cu`` walks the sequence in reverse, one
cluster per (head, group of 8 batch rows) sharing the head's R, the step's
product on the tensor cores (its launch is :func:`plan_bwd`), where the
reference differentiates its ``lax.scan``. For a tensor on the CPU the
wrappers run the plain versions (:func:`repro_torch.kernels.ref.slstm_ref`,
``slstm_bwd_ref``); for a CUDA tensor they launch the kernels or raise.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import SAVED_ROWS, slstm_bwd_ref, slstm_dr, slstm_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 1024  # the stream path: one thread a hidden unit
MAX_CLUSTER = 8      # CTAs a cluster (the portable limit)
CLUSTER_THREADS = 512  # threads of a cluster CTA at most (128 registers each)
REG_KPT = (8, 16, 32, 64)  # k a thread is built for (R in at most 64 registers)
# the backward (csrc/slstm.cu, "the backward")
BWD_ROWS = 8            # batch rows a cluster: the MMA's N
BWD_WARPS = 16          # warps a CTA
BWD_RING = 4            # steps of saved state a CTA holds in shared memory
BWD_R_REGS = 64         # registers a thread for R's big and small halves, at most
BWD_TILES_K = (1, 2, 4, 8)  # k-tiles a warp the kernel is built for, m-tiles min(4, 8 / kt)
MAX_BWD_CLUSTER = 16    # a non-portable cluster size, asked for at launch
# gx, R, h_out, c, n, h, m, saved, B, S, H, hd, dtype, path, C, KS, kpt, stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
# saved, R, dh, dg, xbuf, B, S, H, hd, dtype, C, mt, kt, stream
_BWD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# xbuf, B, S, H, hd, C, mt, kt, rows, stream
_FLOOR_ARGTYPES = [ctypes.c_void_p] + [ctypes.c_int] * 8 + [ctypes.c_void_p]
# backward, B, H, hd, dtype, C, a, b (KS, kpt or mt, kt), clusters (out)
_CLUSTERS_ARGTYPES = [ctypes.c_int] * 8 + [ctypes.c_void_p]
NO_BACKWARD = ("slstm_fused: the stream path (head_dim {hd}: R does not fit the registers of "
               "eight CTAs) has no backward yet (ROADMAP Queue 2); it serves, it does not train")


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


@dataclass(frozen=True)
class BwdPlan:
    """How one backward is launched (:func:`plan_bwd`): a cluster of
    ``cluster`` CTAs walks one head for a group of ``rows`` batch rows
    (grid ``(cluster, H, ceil(B / rows))``); CTA r owns ``units`` = 16
    ``m_tiles`` hidden units (zero rows of R past ``head_dim``) and its
    ``warps`` warps each sum ``k_tiles`` k-tiles of 8 of the 4 hd terms
    (zero past 4 hd) with ``mma.sync`` in 3xTF32 (``product``), R's rows
    held as big and small halves in registers (``r_bytes`` a CTA, 8
    ``m_tiles k_tiles`` registers a thread). The product of a step is
    ``(m, n, k)``: ``units x rows x 4 hd`` padded to the tiles. ``smem``
    is dynamic shared memory a CTA: dg twice, the warps' partial tiles and
    a ring of ``BWD_RING`` steps of saved state. Each step's gate gradients
    cross the cluster through a global buffer of ``xbuf_floats`` (each
    CTA's slice written there, then multicast into every CTA)."""
    head_dim: int
    cluster: int
    rows: int
    units: int
    m_tiles: int
    k_tiles: int
    warps: int
    threads: int
    grid: Tuple[int, int, int]
    smem: int
    r_bytes: int
    mnk: Tuple[int, int, int]
    product: str = "mma_sync_3xtf32"

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    @property
    def clusters(self) -> int:
        return self.grid[1] * self.grid[2]

    @property
    def xbuf_floats(self) -> int:
        return self.clusters * 2 * self.mnk[2] * self.rows


def bwd_smem(m_tiles: int, k_tiles: int) -> int:
    """A backward CTA's shared memory in bytes (``bwd_smem_floats`` of
    csrc/slstm.cu): dg twice ``[k-tile][row][8]``, the warps' partial
    tiles ``[warp][row][unit + 4]`` (+ 2 a warp), the saved-state ring
    ``[step][field][row][unit]``."""
    units = 16 * m_tiles
    return 4 * (2 * BWD_WARPS * k_tiles * 64 + BWD_WARPS * (BWD_ROWS * (units + 4) + 2)
                + BWD_RING * SAVED_ROWS * BWD_ROWS * units)


@functools.lru_cache(maxsize=1024)
def plan_bwd(B: int, S: int, H: int, hd: int, dtype: torch.dtype) -> Optional[BwdPlan]:
    """The backward's launch (pure, like :func:`plan`; ``S`` and ``dtype``
    do not change it), or None where the forward takes the stream path (hd
    above 256), whose backward is not written. ``k_tiles`` the fewest (a
    power of two) whose 16 warps cover the 4 hd terms; ``m_tiles`` the most
    whose R halves fit 64 registers a thread (at most 4); ``cluster`` the
    smallest power of two whose CTAs cover hd units: 16 at hd 256."""
    if plan(B, S, H, hd, dtype).path != "cluster":
        return None
    kt = next(k for k in BWD_TILES_K if BWD_WARPS * k * 8 >= 4 * hd)
    mt = min(4, BWD_R_REGS // (8 * kt))
    C = next(c for c in (1, 2, 4, 8, MAX_BWD_CLUSTER) if 16 * mt * c >= hd)
    units = 16 * mt
    return BwdPlan(hd, C, BWD_ROWS, units, mt, kt, BWD_WARPS, 32 * BWD_WARPS,
                   (C, H, -(-B // BWD_ROWS)), bwd_smem(mt, kt),
                   2 * 4 * units * BWD_WARPS * kt * 8,
                   (units, BWD_ROWS, BWD_WARPS * kt * 8))


def _check(name: str, B: int, S: int, D: int, rg: torch.Tensor, num_heads: int) -> int:
    """Check a (B, S, ., D) recurrence against its recurrent weights; returns hd."""
    if num_heads < 1 or D % num_heads:
        raise ValueError(f"{name}: D={D} does not split into {num_heads} heads")
    hd = D // num_heads
    if tuple(rg.shape) != (4, num_heads, hd, hd):
        raise ValueError(f"{name}: rg {tuple(rg.shape)} is not {(4, num_heads, hd, hd)} "
                         f"for D={D}")
    if B < 1 or S < 1:
        raise ValueError(f"{name}: empty batch or sequence (B={B}, S={S})")
    return hd


def _check_card(name: str, x: torch.Tensor, rg: torch.Tensor, num_heads: int, hd: int) -> None:
    """What the kernels take on the card, beyond the shapes."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head_dim {hd} > {MAX_HEAD_DIM}")
    if x.dtype not in _DTYPES or rg.dtype != torch.float32:
        raise TypeError(f"{name}: the input is {x.dtype} and rg {rg.dtype}; the kernel takes "
                        f"the input in one of {list(_DTYPES)} and rg in torch.float32")
    if rg.device != x.device:
        raise ValueError(f"{name}: the input is on {x.device}, rg on {rg.device}")
    if not (x.is_contiguous() and rg.is_contiguous()):
        raise ValueError(f"{name}: the input and rg must be contiguous")
    if x.shape[0] > 65535:
        raise ValueError(f"{name}: B={x.shape[0]} exceeds the grid's 65535")
    if num_heads > 65535:
        raise ValueError(f"{name}: H={num_heads} exceeds the grid's 65535")


def slstm_fused(gx: torch.Tensor, rg: torch.Tensor, num_heads: int, *, save: bool = False):
    """gx: ``(B, S, 4, D)`` gate pre-activations (float32 or bfloat16 on
    the card); rg: ``(4, H, hd, hd)`` float32 recurrent weights. Returns
    ``h`` ``(B, S, D)`` in ``gx.dtype`` and the final state ``(c, n, h, m)``,
    each float32 ``(B, H, hd)``; with ``save``, also the per-step state
    float32 ``(B, S, 7, D)`` that :func:`slstm_fused_bwd` reads (``h`` is
    bitwise the same). ``save`` raises on the stream path (hd above 256)."""
    if gx.dim() != 4 or gx.shape[2] != 4:
        raise ValueError(f"slstm_fused: gx {tuple(gx.shape)} is not (B, S, 4, D)")
    B, S, _, D = gx.shape
    hd = _check("slstm_fused", B, S, D, rg, num_heads)
    if gx.device.type == "cpu":
        return slstm_ref(gx, rg, num_heads, save=save)
    _check_card("slstm_fused", gx, rg, num_heads, hd)
    p = plan(B, S, num_heads, hd, gx.dtype)
    if save and p.path != "cluster":
        raise ValueError(NO_BACKWARD.format(hd=hd))
    return _launch(gx, rg, p, save)


def _launch(gx: torch.Tensor, rg: torch.Tensor, p: Plan, save: bool):
    """Launch the kernel as ``p`` says on checked inputs."""
    B, S, _, D = gx.shape
    H = rg.shape[1]
    hd = D // H
    h_out = torch.empty((B, S, D), dtype=gx.dtype, device=gx.device)
    state = tuple(torch.empty((B, H, hd), dtype=torch.float32, device=gx.device)
                  for _ in range(4))
    saved = (torch.empty((B, S, SAVED_ROWS, D), dtype=torch.float32, device=gx.device)
             if save else None)
    kernel = _build.function("slstm", "repro_slstm", _ARGTYPES)
    err = _build.call(kernel, gx.device, gx.data_ptr(), rg.data_ptr(), h_out.data_ptr(),
                      *(t.data_ptr() for t in state), None if saved is None else saved.data_ptr(),
                      B, S, H, hd, _DTYPES[gx.dtype], int(p.path == "stream"), p.cluster,
                      p.k_slices, p.kpt)
    if err != 0:
        raise RuntimeError(f"slstm_fused kernel launch failed: CUDA error {err}")
    slstm_fused.launches += 1
    return (h_out, state, saved) if save else (h_out, state)


# kernel launches since the last reset (plain integer; set it to 0 to reset)
slstm_fused.launches = 0


def slstm_fused_bwd(rg: torch.Tensor, saved: torch.Tensor, dh: torch.Tensor, num_heads: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The gradient of :func:`slstm_fused`'s ``h``: ``(dgx, dR)`` from rg,
    the forward's per-step state ``saved`` (``save=True``) and ``dh`` ``(B,
    S, D)`` in ``gx.dtype``. ``dgx`` ``(B, S, 4, D)`` is in ``dh.dtype``,
    ``dR`` float32 ``(4, H, hd, hd)``. The kernel writes the float32 gate
    gradients; ``dR`` is one product over the ``B * S`` rows outside it
    (:func:`repro_torch.kernels.ref.slstm_dr`)."""
    if dh.dim() != 3:
        raise ValueError(f"slstm_fused_bwd: dh {tuple(dh.shape)} is not (B, S, D)")
    B, S, D = dh.shape
    if tuple(saved.shape) != (B, S, SAVED_ROWS, D) or saved.dtype != torch.float32:
        raise ValueError(f"slstm_fused_bwd: saved {tuple(saved.shape)} {saved.dtype} is not "
                         f"float32 {(B, S, SAVED_ROWS, D)} for dh {tuple(dh.shape)}")
    hd = _check("slstm_fused_bwd", B, S, D, rg, num_heads)
    if dh.device.type == "cpu":
        return slstm_bwd_ref(rg, saved, dh, num_heads)
    _check_card("slstm_fused_bwd", dh, rg, num_heads, hd)
    if saved.device != dh.device or not saved.is_contiguous():
        raise ValueError("slstm_fused_bwd: saved must be contiguous, on dh's device")
    p = plan_bwd(B, S, num_heads, hd, dh.dtype)
    if p is None:
        raise ValueError(NO_BACKWARD.format(hd=hd))
    dg = torch.empty((B, S, 4, D), dtype=torch.float32, device=dh.device)
    xbuf = torch.empty(p.xbuf_floats, dtype=torch.float32, device=dh.device)
    kernel = _build.function("slstm", "repro_slstm_bwd", _BWD_ARGTYPES)
    err = _build.call(kernel, dh.device, saved.data_ptr(), rg.data_ptr(), dh.data_ptr(),
                      dg.data_ptr(), xbuf.data_ptr(), B, S, num_heads, hd, _DTYPES[dh.dtype],
                      p.cluster, p.m_tiles, p.k_tiles)
    if err != 0:
        raise RuntimeError(f"slstm_fused_bwd kernel launch failed: CUDA error {err}")
    slstm_fused_bwd.launches += 1
    return dg.to(dh.dtype), slstm_dr(saved, dg, num_heads)


# kernel launches since the last reset (plain integer; set it to 0 to reset)
slstm_fused_bwd.launches = 0


def active_clusters(p: Union[Plan, BwdPlan], dtype: torch.dtype) -> int:
    """How many of ``p``'s clusters (a cluster :class:`Plan` of the forward,
    or a :class:`BwdPlan`) the current device runs at once
    (``cudaOccupancyMaxActiveClusters``; no launch): a grid of more clusters
    runs in waves."""
    out = ctypes.c_int(0)
    fn = _build.function("slstm", "repro_slstm_clusters", _CLUSTERS_ARGTYPES)
    if isinstance(p, BwdPlan):
        args = (1, p.grid[2] * p.rows, p.grid[1], p.head_dim, _DTYPES[dtype], p.cluster,
                p.m_tiles, p.k_tiles)
    else:
        args = (0, p.grid[2], p.grid[1], p.units * p.cluster, _DTYPES[dtype], p.cluster,
                p.k_slices, p.kpt)
    err = fn(*args, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: CUDA error {err}")
    return out.value


def bwd_step_floor(p: BwdPlan, S: int, xbuf: torch.Tensor, rows: int = BWD_ROWS) -> None:
    """Launch the step floor of ``p`` on ``xbuf``'s device and current
    stream: the backward's grid, clusters and shared memory running S steps
    of its exchange for ``rows`` rows a group, no arithmetic (csrc/slstm.cu,
    ``slstm_bwd_floor_kernel``); ``xbuf`` float32, ``p.xbuf_floats`` long.
    For timing; it counts no launch and computes nothing."""
    fn = _build.function("slstm", "repro_slstm_bwd_floor", _FLOOR_ARGTYPES)
    err = _build.call(fn, xbuf.device, xbuf.data_ptr(), p.grid[2] * p.rows, S, p.grid[1],
                      p.head_dim, p.cluster, p.m_tiles, p.k_tiles, rows)
    if err != 0:
        raise RuntimeError(f"slstm backward step floor launch failed: CUDA error {err}")


def hbm_traffic_model(B, S, D, num_heads, dtype_bytes=2):
    """Analytic HBM bytes per layer per sequence: baseline scan vs fused."""
    hd = D // num_heads
    r_bytes = 4 * num_heads * hd * hd * 4
    state_bytes = 4 * num_heads * hd * B * 4
    baseline = S * (r_bytes + 2 * state_bytes + 4 * D * B * dtype_bytes)
    fused = B * S * 4 * D * dtype_bytes + B * S * D * dtype_bytes + r_bytes
    return {"baseline_bytes": baseline, "fused_bytes": fused,
            "reduction_x": baseline / fused}
