"""Domino block-chain simulator, event counts and the Tab. IV evaluation.

The PyTorch port's counterpart of ``repro.core.simulator``:

* the block-chain execution itself (:func:`run_conv_block_chain`,
  :func:`run_fc_block_chain`) as plain float64 PyTorch, the counterpart of
  the JAX package's NumPy oracle. It runs on whatever device its tensors
  live on and is the reference the CUDA kernel path is held against;
* :class:`COMGridSim` — one layer's compiled block chain run on a real
  input in float64, on the card unless the caller passes another device,
  with its event counts; :func:`reference_conv` / :func:`reference_fc`
  are the independent float64 oracles it is held against;
* the per-image event counts — the vectorized closed forms
  (:func:`batched_layer_events`, :func:`network_event_totals`,
  :func:`conv_events`, :func:`fc_events`) and the recount from an explicit
  block grid (:func:`conv_block_events`, :func:`fc_block_events`). These
  are integer arithmetic in NumPy and give the same integers as the JAX
  package;
* the Tab. III energy model over those counts
  (:func:`onchip_pj_from_events`, :func:`offchip_values_img`) and
  :class:`DominoModel`, the full-network Tab. IV columns. This is host-side
  NumPy/Python arithmetic, the same operations in the same order as the
  JAX package, so the columns are the same float64 values.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.core.mapping import ConvSpec, FCSpec, TileAlloc
from repro_torch.core.schedule import conv_period, conv_period_cols

# bound on the gathered conv MAC-operand grid per einsum (the oy axis is
# processed in row chunks of at most this many bytes; results and event
# counts are chunking-invariant)
_CONV_CHUNK_BYTES = 32e6


@dataclass
class Events:
    ps_hops: int = 0          # partial/group-sum tile-to-tile transfers
    ps_bits: int = 0          # bits moved by those hops (actual M channels)
    ifm_hops: int = 0         # IFM segment transfers between RIFMs
    ifm_bits: int = 0         # bits moved (actual C channels)
    adds: int = 0             # ROFM adder firings (per value-vector)
    buf_push: int = 0         # ROFM data-buffer writes (group-sum queue)
    buf_pop: int = 0
    act: int = 0
    pool_cmp: int = 0
    pe_macs: int = 0          # MAC *vector* ops executed by PEs
    cycles: int = 0

    def merge(self, o: "Events"):
        for f in self.__dataclass_fields__:
            setattr(self, f, getattr(self, f) + getattr(o, f))


EVENT_FIELDS: Tuple[str, ...] = tuple(Events.__dataclass_fields__)


# ---------------------------------------------------------------------------
# Block-chain execution (plain float64 PyTorch)
# ---------------------------------------------------------------------------


def run_conv_block_chain(lp, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Execute one conv layer's compiled block chain, batched over a leading
    image axis: ``(B, H, W, C) -> (B, H_out, W_out, M)`` float64.

    ``w`` is ``(K, K, C, M)``. Partial sums accumulate across chained
    C-blocks, outputs concatenate across M-blocks, and the last C-block
    activates (ReLU). Each block evaluates as one full-image einsum over
    the ``oy`` axis; the gather is chunked over ``oy`` to bound the MAC
    operand grid (``_CONV_CHUNK_BYTES``) — results are chunking-invariant.
    """
    L = lp.layer
    K, P, S = L.k, L.padding, L.stride
    B, H, W, C = x.shape
    Ho, Wo, M = L.h_out, L.w_out, L.c_out
    w = w.to(torch.float64)
    xp = F.pad(x.to(torch.float64), (0, 0, P, P, P, P))
    out = torch.empty((B, Ho, Wo, M), dtype=torch.float64, device=x.device)
    # patches[b, oy, kr, ox, kc, c] is the MAC operand grid — the oy loop
    # of the per-row walk, vectorized
    row_idx = (torch.arange(Ho)[:, None] * S + torch.arange(K)[None, :]).to(x.device)
    col_idx = (torch.arange(Wo)[:, None] * S + torch.arange(K)[None, :]).to(x.device)
    bytes_per_row = B * K * Wo * K * C * 8
    chunk = max(1, min(Ho, int(_CONV_CHUNK_BYTES // max(bytes_per_row, 1))))
    for y0 in range(0, Ho, chunk):
        patches = xp[:, row_idx[y0:y0 + chunk, :, None, None],
                     col_idx[None, None, :, :], :]
        for mi in range(lp.m_blocks):
            acc = None
            for ci in range(lp.c_blocks):
                blk = lp.block(ci, mi)
                (cs, ce), (ms, me) = blk.c_range, blk.m_range
                # this block's K² chain: PE MACs + kernel-row psum chain
                # (E) + group-sum chain (S), a row-chunk at once
                part = torch.einsum(
                    "byrxkc,rkcm->byxm",
                    patches[..., cs:ce], w[:, :, cs:ce, ms:me],
                )
                acc = part if acc is None else acc + part
            # chain closed: the last C-block's M-type tile activates
            out[:, y0:y0 + chunk, :, ms:me] = torch.clamp_min(acc, 0.0)
    return out


def run_fc_block_chain(lp, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Execute one FC layer's systolic block columns, batched over a leading
    image axis: ``(B, C_in) -> (B, C_out)`` float64.

    Each M-block is a column of chained C-block rows, each row adding its
    MVM slice to the arriving sum and forwarding S; the last row
    activates (M-type ACT).
    """
    L = lp.layer
    x = x.to(torch.float64)
    w = w.to(torch.float64)
    out = torch.empty((x.shape[0], L.c_out), dtype=torch.float64, device=x.device)
    for mi in range(lp.m_blocks):
        acc = None
        for ci in range(lp.c_blocks):
            blk = lp.block(ci, mi)
            (cs, ce), (ms, me) = blk.c_range, blk.m_range
            part = x[:, cs:ce] @ w[cs:ce, ms:me]
            acc = part if acc is None else acc + part
        (ms, me) = lp.block(0, mi).m_range
        out[:, ms:me] = torch.clamp_min(acc, 0.0)
    return out


# ---------------------------------------------------------------------------
# Event counts recounted from an explicit block grid
# ---------------------------------------------------------------------------


def conv_block_events(lp, arch: ArchSpec) -> Events:
    """Per-image event counts of one conv layer's block-chain execution.

    Recounted from the explicit block grid (NOT copied from the closed
    forms), uniform over the grid — a CIM array fires whole rows/cols, so
    ragged last blocks hold zeros — exactly the ``batched_layer_events``
    convention, independent of batch size.
    """
    L = lp.layer
    K, P = L.k, L.padding
    Ho, W = L.h_out, L.w_in
    px = Ho * L.w_out
    (cs, ce), (ms, me) = lp.block(0, 0).c_range, lp.block(0, 0).m_range
    m_bits = (me - ms) * 8
    c_bits = (ce - cs) * 8
    ev = Events()
    for _mi in range(lp.m_blocks):
        for ci in range(lp.c_blocks):
            chain_adds = px * (K * K + K - 1)
            ev.pe_macs += px * K * K
            ev.adds += chain_adds
            ev.ps_hops += chain_adds
            ev.ps_bits += chain_adds * m_bits
            # row end: every kernel row queues one group-sum
            # (WR_BUF/PUSH) popped by the S-direction combine
            ev.buf_push += px * K
            ev.buf_pop += px * K
            if ci > 0:
                # cross-block handoff: the chained C-block receives the
                # previous block's partial sum (ADD_RX) per output px
                ev.ps_hops += px
                ev.ps_bits += px * m_bits
                ev.adds += px
        ev.act += px
        if L.pool_k > 0:
            # fused pooling: the M-type CMP chain compares every window
            # value once per pooled output (energy-model event)
            ev.pool_cmp += (px // max(L.pool_stride ** 2, 1)) * L.pool_k ** 2
    # IFM streaming: each input row segment visits one C-block's K² chain
    # once per output row; M-blocks of the same C-slice share the stream
    ev.ifm_hops += lp.c_blocks * Ho * K * K * (W + 2 * P)
    ev.ifm_bits += lp.c_blocks * Ho * K * K * (W + 2 * P) * c_bits
    # every output row is one schedule period p = 2(P+W)
    ev.cycles += Ho * conv_period(L)
    return ev


def fc_block_events(lp, arch: ArchSpec) -> Events:
    """Per-image event counts of one FC layer's systolic column execution
    (recounted from the block grid; see :func:`conv_block_events`)."""
    (cs, ce), (ms, me) = lp.block(0, 0).c_range, lp.block(0, 0).m_range
    m_bits = (me - ms) * 8
    c_bits = (ce - cs) * 8
    ev = Events()
    for _mi in range(lp.m_blocks):
        for ci in range(lp.c_blocks):
            ev.pe_macs += 1       # one MVM vector op per block
            ev.ifm_hops += 1      # IFM slice into this row
            ev.ifm_bits += c_bits
            if ci > 0:            # arriving column sum (ADD_RX)
                ev.ps_hops += 1
                ev.ps_bits += m_bits
                ev.adds += 1
        ev.act += 1
        ev.ps_hops += 1           # column egress hop
        ev.ps_bits += m_bits
    ev.cycles += lp.c_blocks + 2  # fill + egress of the column
    return ev


# ---------------------------------------------------------------------------
# One layer's block chain on a real input, and its float64 oracles
# ---------------------------------------------------------------------------


class COMGridSim:
    """Executes the COM dataflow of one layer's ``CompiledProgram`` block
    chain — conv *or* FC, including multi-block layers (``C > n_c`` and/or
    ``M > n_m``) — following the compiled schedule semantics. Computes real
    outputs in float64 and counts events.

    For every M-block (output-channel slice) the partial sums accumulate
    across the chained C-blocks (the cross-block ADD_RX handoff), and the
    last C-block's M-type tile applies the activation; M-block outputs
    concatenate on the output-channel axis. The chain is the module's
    :func:`run_conv_block_chain` / :func:`run_fc_block_chain` at a batch of
    one, so it runs on ``device`` (``None`` means the card) and event
    counts come from the explicit block grid.

    Pooling fused onto a conv layer (``pool_k > 0``) is counted as an
    energy-model event (``pool_cmp``) but is not part of the functional
    output: the sim returns the pre-pool activation.

    ``weights`` and the input may be NumPy arrays or tensors; they are
    copied to ``device`` as float64.
    """

    def __init__(self, layer, weights, arch: Optional[ArchSpec] = None, *,
                 program=None, device=None):
        # late imports: repro_torch.core.program imports this module, and
        # repro_torch.convert imports repro_torch.core
        from repro_torch.convert import resolve_device
        from repro_torch.core.program import Workload, compile_program

        if program is None:
            program = compile_program(
                Workload(f"sim:{layer.name}", (layer,)), arch or DEFAULT_ARCH)
        elif arch is not None and arch != program.arch:
            raise ValueError(
                "conflicting architectures: an explicit arch was passed "
                "alongside a program compiled for a different ArchSpec — "
                "recompile the program for the intended arch instead"
            )
        arch = program.arch
        self.program = program
        self.lp = next(
            (lp for lp in program.layer_programs if lp.layer == layer), None)
        if self.lp is None:
            raise KeyError(f"layer {layer.name!r} is not in the program")
        expect = (
            (layer.k, layer.k, layer.c_in, layer.c_out)
            if isinstance(layer, ConvSpec) else (layer.c_in, layer.c_out)
        )
        w = torch.as_tensor(weights)
        if tuple(w.shape) != expect:
            raise ValueError(
                f"weights shape {tuple(w.shape)} != {expect} for {layer.name!r}")
        self.device = resolve_device(device)
        self.layer = layer
        self.arch = arch
        self.w = w.to(device=self.device, dtype=torch.float64)
        self.ev = Events()

    @classmethod
    def from_program(cls, program, layer_name: str, weights, *,
                     device=None) -> "COMGridSim":
        """Simulate one layer of a compiled *network* program (the block
        chain, schedules, and event forms all come from the program)."""
        lp = program.layer_program(layer_name)
        return cls(lp.layer, weights, program.arch, program=program, device=device)

    def run(self, ifm) -> torch.Tensor:
        """Execute the layer's block chain on a real input.

        Conv: ``(H, W, C) -> (H_out, W_out, M)``; FC: ``(C_in,) ->
        (C_out,)``, float64 on the sim's device. Event counts mirror the
        data movement and match the closed forms in
        ``batched_layer_events`` exactly.
        """
        x = torch.as_tensor(ifm).to(device=self.device, dtype=torch.float64)
        if isinstance(self.layer, ConvSpec):
            return self._run_conv(x)
        return self._run_fc(x)

    def _run_conv(self, x: torch.Tensor) -> torch.Tensor:
        out = run_conv_block_chain(self.lp, self.w, x[None])[0]
        self.ev.merge(conv_block_events(self.lp, self.arch))
        # the bounded ROFM queues hold at most one group-sum per kernel
        # row: each output step pushes K and pops K
        L = self.layer
        self.max_queue_depth = 1 if (L.h_out > 0 and L.w_out > 0) else 0
        return out

    def _run_fc(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != (self.layer.c_in,):
            raise ValueError(
                f"FC input shape {tuple(x.shape)} != ({self.layer.c_in},)")
        out = run_fc_block_chain(self.lp, self.w, x[None])[0]
        self.ev.merge(fc_block_events(self.lp, self.arch))
        self.max_queue_depth = 0
        return out


def reference_conv(ifm, w, layer: ConvSpec) -> torch.Tensor:
    """Float64 conv oracle, one output pixel at a time: ``relu`` of each
    ``K x K x C`` patch contracted with ``w``. Runs on the device of
    ``ifm`` (NumPy inputs run on the CPU)."""
    x = torch.as_tensor(ifm).to(torch.float64)
    w = torch.as_tensor(w).to(device=x.device, dtype=torch.float64)
    P, S = layer.padding, layer.stride
    x = F.pad(x, (0, 0, P, P, P, P))
    Ho, Wo = layer.h_out, layer.w_out
    out = torch.zeros((Ho, Wo, layer.c_out), dtype=torch.float64, device=x.device)
    for oy in range(Ho):
        for ox in range(Wo):
            patch = x[oy * S : oy * S + layer.k, ox * S : ox * S + layer.k, :]
            out[oy, ox] = torch.einsum("klc,klcm->m", patch, w)
    return torch.clamp_min(out, 0.0)


def reference_fc(x, w) -> torch.Tensor:
    """Float64 FC oracle: ``relu(x @ w)`` (the FC systolic column
    semantics — ACT fires at the last row), on the device of ``x``."""
    x = torch.as_tensor(x).to(torch.float64)
    w = torch.as_tensor(w).to(device=x.device, dtype=torch.float64)
    return torch.clamp_min(x @ w, 0.0)


# ---------------------------------------------------------------------------
# Analytic event counts — vectorized closed forms over layer batches
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerTable:
    """Columnar (n_layers,) int64 feature arrays for a layer sequence (FC
    rows carry zeros in the conv-only columns)."""

    is_conv: np.ndarray
    k: np.ndarray
    c_in: np.ndarray
    c_out: np.ndarray
    h_out: np.ndarray
    w_out: np.ndarray
    w_in: np.ndarray
    padding: np.ndarray
    pool_k: np.ndarray
    pool_stride: np.ndarray
    ops: np.ndarray

    @property
    def n_layers(self) -> int:
        return int(self.is_conv.shape[0])


@lru_cache(maxsize=1024)
def layer_table(layers: Tuple) -> LayerTable:
    """Build (and cache, keyed by the frozen layer specs) the feature table."""
    def col(conv_val, fc_val):
        return np.array(
            [conv_val(l) if isinstance(l, ConvSpec) else fc_val(l) for l in layers],
            dtype=np.int64,
        )

    return LayerTable(
        is_conv=np.array([isinstance(l, ConvSpec) for l in layers], dtype=bool),
        k=col(lambda l: l.k, lambda l: 0),
        c_in=col(lambda l: l.c_in, lambda l: l.c_in),
        c_out=col(lambda l: l.c_out, lambda l: l.c_out),
        h_out=col(lambda l: l.h_out, lambda l: 0),
        w_out=col(lambda l: l.w_out, lambda l: 0),
        w_in=col(lambda l: l.w_in, lambda l: 0),
        padding=col(lambda l: l.padding, lambda l: 0),
        pool_k=col(lambda l: l.pool_k, lambda l: 0),
        pool_stride=col(lambda l: l.pool_stride, lambda l: 1),
        ops=col(lambda l: l.ops, lambda l: l.ops),
    )


def batched_layer_events(t: LayerTable, arch: ArchSpec = DEFAULT_ARCH,
                         n_c_eff=None, n_m_eff=None) -> Dict[str, np.ndarray]:
    """Per-layer event counts, (n_layers,) int64 per Events field — the
    closed forms validated against the block-grid recount. The ``arch``
    geometry (``n_c`` x ``n_m``) sets the block factors and on-chip value
    widths; ``n_c_eff``/``n_m_eff`` (broadcastable int arrays, per layer
    ``(n_layers,)`` or per population ``(P, n_layers)``) override them with
    a candidate mapping's per-layer blocking. ``None`` keeps ``arch``'s."""
    conv = t.is_conv
    K = t.k
    K2 = K * K
    nc = arch.n_c if n_c_eff is None else np.asarray(n_c_eff, dtype=np.int64)
    nm = arch.n_m if n_m_eff is None else np.asarray(n_m_eff, dtype=np.int64)
    cb = -(-t.c_in // nc)                  # ceil-div
    mb = -(-t.c_out // nm)
    px = t.h_out * t.w_out
    chains = cb * mb                       # parallel accumulation chains
    m_bits = np.minimum(t.c_out, nm) * 8
    c_bits = np.minimum(t.c_in, nc) * 8
    conv_hops = px * chains * (K2 + K - 1) + px * mb * (cb - 1)
    fc_hops = mb * (cb - 1) + mb           # column accumulation + egress
    ps_hops = np.where(conv, conv_hops, fc_hops)
    ifm_hops = np.where(conv, t.h_out * K2 * (t.w_in + 2 * t.padding) * cb, cb * mb)
    return dict(
        ps_hops=ps_hops,
        ps_bits=ps_hops * m_bits,
        ifm_hops=ifm_hops,
        ifm_bits=ifm_hops * c_bits,
        adds=np.where(conv, conv_hops, mb * (cb - 1)),
        buf_push=np.where(conv, px * chains * K, 0),
        buf_pop=np.where(conv, px * chains * K, 0),
        act=np.where(conv, px * mb, mb),
        pool_cmp=np.where(
            conv & (t.pool_k > 0),
            (px // np.maximum(t.pool_stride ** 2, 1)) * t.pool_k ** 2 * mb,
            0,
        ),
        pe_macs=np.where(conv, px * K2 * chains, cb * mb),
        cycles=np.where(conv, t.h_out * conv_period_cols(t.padding, t.w_in), cb + 2),
    )


@lru_cache(maxsize=4096)
def _network_event_totals(layers: Tuple, arch: ArchSpec) -> Dict[str, int]:
    per_layer = batched_layer_events(layer_table(layers), arch)
    return {f: int(per_layer[f].sum()) for f in EVENT_FIELDS}


def network_event_totals(layers: Tuple, arch: ArchSpec = DEFAULT_ARCH) -> Dict[str, int]:
    """Summed per-image event counts, cached per ``(layers, arch)``."""
    return _network_event_totals(tuple(layers), arch)


def events_for_layers(layers, arch: ArchSpec = DEFAULT_ARCH) -> Events:
    """Deprecated: compile the workload instead and read its event totals.

    Thin shim over :func:`repro_torch.core.program.compile_program` — the
    returned counts are the program's own ``event_totals``::

        program = compile_program(Workload.of(layers), arch)
        totals = program.event_totals
    """
    warnings.warn(
        "events_for_layers() is deprecated; use repro_torch.core.program."
        "compile_program(workload, arch) and read CompiledProgram"
        ".event_totals (or network_event_totals for the raw closed forms)",
        DeprecationWarning, stacklevel=2,
    )
    layers = tuple(layers)
    if not layers:
        return Events()
    from repro_torch.core.program import Workload, compile_program

    return Events(**compile_program(Workload.of(layers), arch).event_totals)


def conv_events(layer: ConvSpec, arch: ArchSpec = DEFAULT_ARCH) -> Events:
    """Closed-form per-image event counts of one conv layer (a one-row
    view of the batched closed forms)."""
    return Events(**network_event_totals((layer,), arch))


def fc_events(layer: FCSpec, arch: ArchSpec = DEFAULT_ARCH) -> Events:
    return Events(**network_event_totals((layer,), arch))


def onchip_pj_from_events(ev: Dict[str, "np.ndarray | int | float"],
                          arch: ArchSpec = DEFAULT_ARCH):
    """Tab. III on-chip energy (pJ) from event counts.

    Accepts scalars or broadcastable NumPy arrays. Component energies come
    from ``arch.energy`` and are rescaled to the spec's technology corner
    by ``arch.energy_scale()`` (x1.0 at 45nm/1V).
    """
    en = arch.energy
    # partial-sum movement: wormhole pass-through — wire/register energy
    # per bit-hop + the ROFM adder on arrival (no per-chunk buffering)
    pj = ev["ps_bits"] * en.link_pj_per_bit
    pj = pj + ev["adds"] * arch.n_m * en.adder_pj_8b
    # control + schedule-table read per executed instruction (per hop;
    # clock-gated when no packet in flight)
    pj = pj + (ev["ps_hops"] + ev["ifm_hops"]) * (
        en.rofm_ctrl_pj + en.rifm_ctrl_pj + en.sched_table_pj
    )
    # IFM streaming: wire energy per hop + one RIFM 256B buffer access
    # per K-row reuse window (in-buffer shifting, paper §II-B)
    pj = pj + ev["ifm_bits"] * en.link_pj_per_bit
    pj = pj + (ev["ifm_hops"] / 3.0) * en.rifm_buffer_pj
    # group-sum queueing in the 16KiB ROFM data buffer
    pj = pj + (ev["buf_push"] + ev["buf_pop"]) * en.data_buffer_pj
    # inter-memory computing (Tab. II functions)
    pj = pj + ev["act"] * arch.n_m * en.act_pj_8b
    pj = pj + ev["pool_cmp"] * arch.n_m * en.pool_pj_8b
    return pj * arch.energy_scale()


def offchip_values_img(allocs) -> float:
    """Feature-map values crossing a chip boundary per image (bit-width
    independent; multiply by the precision to get off-chip bits)."""
    vals = 0.0
    for prev, a in zip(allocs, allocs[1:]):
        same_chip = set(prev.chip_ids) & set(a.chip_ids)
        if not same_chip or a.crosses_chip:
            l = prev.layer
            if isinstance(l, ConvSpec):
                vals += l.h_out * l.w_out * l.c_out
            else:
                vals += l.c_out
    return vals


# ---------------------------------------------------------------------------
# Energy/power/CE for full networks
# ---------------------------------------------------------------------------


@dataclass
class PowerBreakdown:
    onchip_w: float
    offchip_w: float
    cim_w: float

    @property
    def total_w(self) -> float:
        return self.onchip_w + self.offchip_w + self.cim_w


class DominoModel:
    """Full-network Domino evaluation (paper Tab. IV columns).

    Consumes a :class:`~repro_torch.core.program.CompiledProgram`: pass one
    directly (its ``arch`` applies; passing a *conflicting* explicit
    ``arch`` raises), or pass a ``Workload``/layer sequence and the model
    compiles it via ``compile_program`` — either way the mapping, block
    partition, and event totals come from the shared compile cache.

    ``arch`` carries every architecture knob (geometry, tiles/chip, clocks,
    energy table); ``precision_bits`` overrides ``arch.precision_bits``.
    """

    def __init__(self, layers, *, arch: Optional[ArchSpec] = None,
                 precision_bits: Optional[int] = None):
        # late import: repro_torch.core.program imports this module
        from repro_torch.core.program import CompiledProgram, Workload, compile_program

        if isinstance(layers, CompiledProgram):
            if arch is not None and arch != layers.arch:
                raise ValueError(
                    "conflicting architectures: an explicit arch was passed "
                    "alongside a program compiled for a different ArchSpec — "
                    "recompile the program for the intended arch instead"
                )
            self.program = layers
            arch = layers.arch
        else:
            arch = DEFAULT_ARCH if arch is None else arch
            self.program = compile_program(Workload.of(layers), arch)
        self.workload = self.program.workload
        self.layers = list(self.workload.layers)
        self.arch = arch
        # shared frozen allocations (the program is the cache line)
        self.allocs: List[TileAlloc] = list(self.program.allocs)
        self.n_tiles = self.program.n_tiles
        self.n_chips = self.program.n_chips
        self.bits = arch.precision_bits if precision_bits is None else precision_bits

    # ---- structure ----
    def tiles_per_network(self) -> int:
        return self.n_tiles

    def copies(self, n_chips: Optional[int] = None) -> float:
        """Network replicas on the given chips (>=1)."""
        chips = n_chips or self.n_chips
        return max(1.0, (chips * self.arch.tiles_per_chip) / self.n_tiles)

    # ---- time ----
    def exec_time_us(self) -> float:
        """Latency of one image through the pipe at the instruction step clock."""
        fill = 0.0
        steady = 0.0
        for l in self.layers:
            if isinstance(l, ConvSpec):
                fill += conv_period(l) / 2
                steady = max(steady, float(l.h_out * l.w_out))
            else:
                cb = math.ceil(l.c_in / self.arch.n_c)
                mb = math.ceil(l.c_out / self.arch.n_m)
                fill += cb + mb * 2
        return (steady + fill) / self.arch.step_hz * 1e6

    def bottleneck_px(self) -> float:
        """Steady-state cycles/img: output pixels of the largest conv."""
        return float(max(
            (l.h_out * l.w_out for l in self.layers if isinstance(l, ConvSpec)),
            default=1024,
        ))

    def skip_stall(self) -> float:
        """Residual skip joins stall the pipeline while both operands
        synchronize (§IV-B1); calibrated stall factor."""
        return self.arch.skip_stall if any(
            isinstance(l, ConvSpec) and l.residual_from for l in self.layers
        ) else 1.0

    def throughput_img_s(self, n_chips: Optional[int] = None) -> float:
        per_copy = self.arch.fdm_factor * self.arch.step_hz / self.bottleneck_px()
        return per_copy * self.copies(n_chips) * self.arch.pipeline_eff \
            * self.skip_stall()

    # ---- optional functional cross-check ----
    def functional_forward(self, images, weights, *, backend: str = "cuda",
                           device=None):
        """Run the model's compiled program image→logits through the
        whole-program executor (:mod:`repro_torch.core.executor`): the CUDA
        ``com_matmul`` path on the card by default, or ``backend=
        "reference"`` (float64 block chains) on ``device``. Returns the
        :class:`~repro_torch.core.executor.ExecutionResult`; its per-image
        ``events`` equal this model's ``program.event_totals``."""
        from repro_torch.core.executor import ProgramExecutor

        return ProgramExecutor(
            self.program, weights, backend=backend, device=device).run(images)

    # ---- energy ----
    def events(self) -> Events:
        return Events(**self.program.event_totals)

    def onchip_energy_img_j(self) -> float:
        return float(
            onchip_pj_from_events(self.program.event_totals, self.arch)
        ) * 1e-12

    def offchip_bits_img(self) -> float:
        return offchip_values_img(self.allocs) * self.bits

    def offchip_energy_img_j(self) -> float:
        return self.offchip_bits_img() * self.arch.energy.interchip_pj_per_bit \
            * self.arch.energy_scale() * 1e-12

    def total_ops(self) -> float:
        return float(sum(l.ops for l in self.layers))

    # ---- Tab. IV style evaluation against a counterpart ----
    def evaluate(self, e_mac_pj: float, *, n_chips: Optional[int] = None,
                 area_mm2: Optional[float] = None) -> Dict[str, float]:
        """e_mac_pj: substituted CIM array energy per (8b) OP, normalized to
        45nm/1V — the plug-in parameter (paper: 'Domino adopts existing CIM
        arrays', CIM power not listed). ``n_chips``/``area_mm2`` may be pinned
        to the paper's evaluation setup."""
        chips = n_chips or self.n_chips
        img_s = self.throughput_img_s(chips)
        e_on = self.onchip_energy_img_j()
        e_off = self.offchip_energy_img_j()
        ops = self.total_ops()
        e_cim = ops * e_mac_pj * 1e-12
        e_total = e_on + e_off + e_cim
        ce = ops / e_total / 1e12  # TOPS/W
        area = area_mm2 if area_mm2 else self.n_tiles * self.arch.tile_area_um2() / 1e6
        return dict(
            exec_us=self.exec_time_us(),
            img_s=img_s,
            power_w=e_total * img_s,
            onchip_w=e_on * img_s,
            offchip_w=e_off * img_s,
            cim_w=e_cim * img_s,
            ce_tops_w=ce,
            ops=ops,
            area_mm2=area,
            thr_tops_mm2=ops * img_s / 1e12 / area,
            img_s_per_core=img_s / (chips * self.arch.tiles_per_chip),
            n_chips=chips,
            n_tiles=self.n_tiles,
        )
