"""Block-chain semantics and event counts of a compiled program.

The PyTorch port's counterpart of the parts of ``repro.core.simulator``
the whole-program executor needs:

* the per-image event counts — the vectorized closed forms
  (:func:`batched_layer_events`, :func:`network_event_totals`) and the
  recount from an explicit block grid (:func:`conv_block_events`,
  :func:`fc_block_events`). These are integer arithmetic in NumPy and give
  the same integers as the JAX package;
* the block-chain execution itself (:func:`run_conv_block_chain`,
  :func:`run_fc_block_chain`) as plain float64 PyTorch, the counterpart of
  the JAX package's NumPy oracle. It runs on whatever device its tensors
  live on and is the reference the CUDA kernel path is held against.

``COMGridSim``, ``DominoModel`` and the energy model are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.core.mapping import ConvSpec
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
    xp = torch.nn.functional.pad(x.to(torch.float64), (0, 0, P, P, P, P))
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
    )


def batched_layer_events(t: LayerTable, arch: ArchSpec = DEFAULT_ARCH) -> Dict[str, np.ndarray]:
    """Per-layer event counts, (n_layers,) int64 per Events field — the
    closed forms validated against the block-grid recount. The ``arch``
    geometry (``n_c`` x ``n_m``) sets the block factors and on-chip value
    widths."""
    conv = t.is_conv
    K = t.k
    K2 = K * K
    nc, nm = arch.n_c, arch.n_m
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
