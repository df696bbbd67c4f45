"""Periodic instruction schedule compiler (paper §II-C, §III-B).

The PyTorch port's own copy of ``repro.core.schedule``'s compiler: the
same instruction streams, so every schedule word is the same integer.

Derives each tile's C-type/M-type instruction stream from the DNN layer
configuration alone (no global controller at runtime — "dataflow is
controlled by distributed local instructions"):

* CONV, stride 1:  period  p = 2 (P + W)   [paper §II-C]
  The factor 2 is the IFM-row / partial-sum-row interleave on the two
  router planes; P is padding, W the IFM width.
* CONV, stride S>1: same table with shielded control bits — actions in
  skipped cycles are masked out (we emit NOP-masked instructions).
* Pooling / M-type: period p = 2·S_p.
* FC: one C-type accumulate-and-forward instruction per column hop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Dict, List

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.core.isa import Buf, CInstr, Dir, Func, MInstr, ScheduleTable, Sum
from repro_torch.core.mapping import ConvSpec, FCSpec


@dataclass
class TileSchedule:
    role: str                 # "conv" | "conv_last" | "fc" | "fc_last"
    table: ScheduleTable
    active_frac: float        # fraction of cycles with real work (stride shield)


def conv_period_cols(padding, w_in):
    """Vectorized ``conv_period``: p = 2(P+W) over scalar or column arrays —
    the single source of the schedule-period formula."""
    return 2 * (padding + w_in)


def conv_period(layer: ConvSpec) -> int:
    return int(conv_period_cols(layer.padding, layer.w_in))


def pool_period(layer: ConvSpec) -> int:
    return 2 * layer.pool_stride


def compile_conv_tile(layer: ConvSpec, kpos: int, is_last_row: bool) -> TileSchedule:
    """Schedule for the tile holding kernel pixel ``kpos`` (row-major)."""
    p = conv_period(layer)
    k = layer.k
    krow, kcol = divmod(kpos, k)
    instrs: List = []
    # Steady state: alternate (receive IFM row segment / emit partial sums).
    # Tile at kernel pixel (krow,kcol): receives the partial-sum stream from
    # its predecessor (W neighbour within a kernel row; group-sum from N at
    # row boundaries), adds the local PE result, forwards E/S.
    first_in_row = kcol == 0
    last_in_row = kcol == k - 1
    for phase in range(p):
        if phase % 2 == 0:  # IFM movement phase (RIFM plane)
            instrs.append(CInstr(rx=Dir.W, sum=Sum.NONE, buf=Buf.HOLD, tx=Dir.E))
        else:  # partial-sum phase (ROFM plane)
            rx = Dir.PE if first_in_row else (Dir.W | Dir.PE)
            s = Sum.ADD_PE if first_in_row else (Sum.ADD_RX | Sum.ADD_PE)
            if last_in_row:
                # row-wise addition complete -> group-sum: queue in buffer
                # and/or combine with queued group-sum from previous rows
                s |= Sum.WR_BUF if krow < k - 1 else Sum.ADD_BUF
                tx = Dir.S
                buf = Buf.PUSH if krow < k - 1 else Buf.POP
            else:
                tx = Dir.E
                buf = Buf.HOLD
            instrs.append(CInstr(rx=rx, sum=s, buf=buf, tx=tx))
    active = 1.0 / (layer.stride * layer.stride)  # shielded cycles for S>1
    role = "conv_last" if is_last_row else "conv"
    if p <= ScheduleTable.MAX_ENTRIES:
        table = ScheduleTable(instrs, period=p)
    else:
        # wide layers (e.g. ImageNet W=224 -> p=450) exceed the 16b x 128
        # store; the steady-state stream is 2-periodic in *content* (the
        # IFM/psum phases alternate two fixed instructions), so the table
        # holds the compressed loop — at_cycle(c) is unchanged for all c,
        # and the row timing period stays conv_period(layer)
        table = ScheduleTable(instrs[:2], period=2)
    return TileSchedule(role=role, table=table, active_frac=active)


def compile_last_row_mtype(layer: ConvSpec) -> TileSchedule:
    """M-type stream for the last-row tile: activation (+ pooling)."""
    instrs: List = [MInstr(rx=Dir.PE, func=Func.ACT, tx=Dir.S)]
    if layer.pool_k:
        p = pool_period(layer)
        # Cmp chain across the pooling window; emit result every p cycles
        for _ in range(p - 1):
            instrs.append(MInstr(rx=Dir.W, func=Func.CMP, tx=Dir.NONE))
        instrs.append(MInstr(rx=Dir.W, func=Func.CMP, tx=Dir.S))
    if layer.residual_from is not None:
        instrs.append(MInstr(rx=Dir.W, func=Func.BP, tx=Dir.S))  # skip path
    table = ScheduleTable(instrs, period=max(len(instrs), 1))
    return TileSchedule(role="conv_last", table=table, active_frac=1.0)


def fc_rows(c_in: int, arch: ArchSpec = DEFAULT_ARCH) -> int:
    """Systolic FC column depth: ceil(c_in / n_c) accumulate-and-forward
    rows, each holding an ``arch.n_c``-wide MVM slice."""
    return max(1, math.ceil(c_in / arch.n_c))


def compile_fc_tile(layer: FCSpec, row: int, n_rows: int) -> TileSchedule:
    """FC systolic column: add own MVM slice to arriving sum, forward S."""
    last = row == n_rows - 1
    s = Sum.ADD_PE if row == 0 else (Sum.ADD_RX | Sum.ADD_PE)
    rx = Dir.PE if row == 0 else (Dir.N | Dir.PE)
    instrs: List = [CInstr(rx=rx, sum=s, buf=Buf.HOLD, tx=Dir.S)]
    if last:
        instrs.append(MInstr(rx=Dir.PE, func=Func.ACT, tx=Dir.S))
    return TileSchedule(
        role="fc_last" if last else "fc",
        table=ScheduleTable(instrs, period=len(instrs)),
        active_frac=1.0,
    )


def layer_schedules(layer, arch: ArchSpec = DEFAULT_ARCH) -> Dict[str, TileSchedule]:
    """All distinct tile schedules of one layer (tiles sharing a role share
    a schedule — this is what keeps NoC instruction bandwidth tiny).

    Role keys: ``k0..k{K²-1}`` + ``mtype_last`` for conv, ``r{row}`` for
    FC. Memoized on the frozen ``(layer, arch)`` pair; callers must treat
    the returned dict as read-only.
    """
    return _layer_schedules(layer, arch)


# Bounded: one entry per distinct (layer, arch) pair.
@lru_cache(maxsize=4096)
def _layer_schedules(layer, arch: ArchSpec) -> Dict[str, TileSchedule]:
    out: Dict[str, TileSchedule] = {}
    if isinstance(layer, ConvSpec):
        k2 = layer.k * layer.k
        for kpos in range(k2):
            out[f"k{kpos}"] = compile_conv_tile(layer, kpos, kpos == k2 - 1)
        out["mtype_last"] = compile_last_row_mtype(layer)
    else:
        n_rows = fc_rows(layer.c_in, arch)
        for r in range(n_rows):
            out[f"r{r}"] = compile_fc_tile(layer, r, n_rows)
    return out
