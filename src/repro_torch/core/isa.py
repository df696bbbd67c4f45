"""Domino's 16-bit distributed instruction set (paper Tab. I / Tab. II).

The PyTorch port's own copy of ``repro.core.isa``: the same encodings, so
compiled schedule words are equal integers in both packages.

Two instruction types, distinguished by bit 0:

  C-type (bit0=0) — convolution/FC steady-state dataflow control::

      15    11 10    7 6     5 4     1 0
      [RxCtrl] [ Sum ] [Buffer] [TxCtrl] [0]

  M-type (bit0=1) — last-row tiles: activation / pooling / bypass::

      15    11 10          5 4     1 0
      [RxCtrl] [   Func     ] [TxCtrl] [1]

Field semantics (concrete bit assignment chosen here; the paper fixes the
field widths, not the encodings):

  RxCtrl (5 bits): one-hot {N, E, S, W, PE} receive enables.
  Sum    (4 bits): {add_rx (accumulate arriving partial-sum into register),
                    add_pe (add local PE result), add_buf (pop group-sum from
                    ROFM buffer and add), wr_buf (queue register to buffer)}.
  Buffer (2 bits): 0=hold, 1=push, 2=pop, 3=clear.
  TxCtrl (4 bits): one-hot {N, E, S, W} transmit enables.
  Func   (6 bits): M-type inter-memory function (Tab. II):
                    1=Add, 2=Act, 3=Cmp(max-pool), 4=Mul(avg-pool), 5=Bp.

A schedule table holds <=128 instructions (Tab. III: "16b x 128"); the
counter indexes it modulo the period -> periodic execution.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import List, Optional, Tuple


class Dir(enum.IntFlag):
    NONE = 0
    N = 1
    E = 2
    S = 4
    W = 8
    PE = 16  # receive from local PE (RxCtrl only)


class Sum(enum.IntFlag):
    NONE = 0
    ADD_RX = 1   # accumulate arriving partial sum
    ADD_PE = 2   # add local PE (CIM) output
    ADD_BUF = 4  # pop queued group-sum and add
    WR_BUF = 8   # queue current register into ROFM buffer


class Buf(enum.IntEnum):
    HOLD = 0
    PUSH = 1
    POP = 2
    CLEAR = 3


class Func(enum.IntEnum):
    NONE = 0
    ADD = 1   # partial-sum accumulation
    ACT = 2   # non-linear activation
    CMP = 3   # comparison -> max pooling
    MUL = 4   # scaling -> average pooling
    BP = 5    # direct transmission ("skip" connection)


def _check_field(value: int, width: int, label: str) -> int:
    v = int(value)
    if not 0 <= v < (1 << width):
        raise ValueError(
            f"{label} field {value!r} does not fit in {width} bits "
            f"(valid range 0..{(1 << width) - 1})"
        )
    return v


@dataclass(frozen=True)
class CInstr:
    rx: Dir = Dir.NONE
    sum: Sum = Sum.NONE
    buf: Buf = Buf.HOLD
    tx: Dir = Dir.NONE

    def encode(self) -> int:
        rx = _check_field(self.rx, 5, "CInstr.rx")
        s = _check_field(self.sum, 4, "CInstr.sum")
        buf = _check_field(self.buf, 2, "CInstr.buf")
        tx = _check_field(self.tx, 4, "CInstr.tx (no PE)")
        return (rx << 11) | (s << 7) | (buf << 5) | (tx << 1) | 0


@dataclass(frozen=True)
class MInstr:
    rx: Dir = Dir.NONE
    func: Func = Func.NONE
    tx: Dir = Dir.NONE

    def encode(self) -> int:
        rx = _check_field(self.rx, 5, "MInstr.rx")
        func = _check_field(self.func, 6, "MInstr.func")
        tx = _check_field(self.tx, 4, "MInstr.tx (no PE)")
        return (rx << 11) | (func << 5) | (tx << 1) | 1


Instr = "CInstr | MInstr"


def decode(word: int):
    if not 0 <= word < (1 << 16):
        raise ValueError(f"not a 16-bit word: {word}")
    rx = Dir((word >> 11) & 0x1F)
    tx = Dir((word >> 1) & 0xF)
    if word & 1:  # M-type
        return MInstr(rx=rx, func=Func((word >> 5) & 0x3F), tx=tx)
    return CInstr(rx=rx, sum=Sum((word >> 7) & 0xF), buf=Buf((word >> 5) & 0x3), tx=tx)


@dataclass
class ScheduleTable:
    """Per-tile periodic instruction store (16b x 128, Tab. III)."""

    MAX_ENTRIES = 128
    words: List[int]
    period: int

    def __init__(self, instrs: List, period: Optional[int] = None):
        words = [i.encode() if not isinstance(i, int) else i for i in instrs]
        if len(words) > self.MAX_ENTRIES:
            raise ValueError(
                f"schedule table overflow: {len(words)} > {self.MAX_ENTRIES}"
            )
        if period is not None and not 1 <= period <= len(words):
            # the counter indexes words modulo the period: a period longer
            # than the store would read past the loaded instructions
            raise ValueError(
                f"schedule period {period} must be in 1..{len(words)} "
                f"(the table holds {len(words)} instruction words)"
            )
        self.words = words
        self.period = period if period is not None else len(words)

    def at_cycle(self, cycle: int):
        if not self.words:
            return None
        return decode(self.words[cycle % self.period])

    def __len__(self):
        return len(self.words)
