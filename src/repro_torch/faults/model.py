"""The fault model: a frozen, seeded description of a degraded fabric.

The PyTorch port's own copy of ``repro.faults.model``: the same fields,
the same validation messages and the same seeded draws, so a fault set
sampled here equals the JAX package's field for field.

A CIM fleet at scale is never the perfect array the paper evaluates —
tiles die, serpentine NoC links break, whole chips fall out of the fleet,
and CIM weight cells get stuck. :class:`FaultSet` is the one frozen,
hashable record of all of it, consumed by every layer of the stack:

* **fabric faults** (``dead_tiles`` / ``dead_links`` / ``dead_chips`` /
  ``n_chips``) constrain *placement*: the fault-aware compile path
  (``compile_program(..., faults=...)``) places layers only on healthy
  contiguous serpentine runs, spilling to spare chips — priced by the
  existing off-chip cost model — or raising
  :class:`FaultCapacityError` when a bounded fleet cannot absorb the
  damage.
* **workload faults** (``weight_faults`` / ``cell_rate`` /
  ``dead_blocks``) corrupt *execution*: stuck-at / sign-flip weight
  cells and whole logical-tile dropout, realized once on the resolved
  float64 weights (``repro_torch.faults.inject``) so the float64
  reference and the CUDA kernel path consume byte-identical faulted
  weights.

Sampling (:meth:`FaultSet.sample`) is **nested-monotone**: one fixed-size
uniform draw per fabric element, thresholded at the rate. The same seed at
a higher rate therefore produces a *superset* of faults — which is what
makes the benchmark's yield curve monotone non-increasing by construction
instead of by luck.

Geometry: flat tile positions index the chip sequence
(``chip = pos // tiles_per_chip``); link ``p`` joins positions ``p`` and
``p + 1`` on one chip's serpentine (boustrophedon) chain, so a dead link
splits the chain and a layer span cannot cross it. A chip contributes its
*longest* healthy segment to placement (tiles stranded in shorter
fragments are wasted — the conservative degradation model).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec

# weight-cell fault kinds: stuck-at-0, stuck-at-full-scale (the cell's
# conductance saturates at the layer's max magnitude), and a sign flip
# (the MSB/sign bit-flip of a signed cell)
CELL_KINDS: Tuple[str, ...] = ("stuck0", "stuck1", "flip")


class FaultCapacityError(ValueError):
    """A bounded fleet cannot hold the workload after degradation."""


@dataclass(frozen=True)
class WeightFault:
    """One faulted CIM weight cell: flat ``index`` into the layer's
    canonical weight array (conv ``(K, K, C, M)``, FC ``(C_in, C_out)``,
    row-major), corrupted per ``kind``."""

    layer: int
    index: int
    kind: str = "stuck0"


@dataclass(frozen=True)
class BlockFault:
    """One dropped logical tile: the ``(k_index, c_index, m_index)`` cell
    of layer ``layer``'s block grid (``k_index`` is the kernel pixel for
    conv layers, 0 for FC). Execution zeroes the weight slice that tile
    holds — the whole-array analogue of a dead CIM macro."""

    layer: int
    k_index: int
    c_index: int
    m_index: int


@dataclass(frozen=True)
class FaultSet:
    """Frozen, hashable fault description — the compile/execute key.

    ``dead_tiles``/``dead_links`` are flat fabric positions (link ``p``
    joins tiles ``p`` and ``p+1`` on one chip — cross-chip indices are
    rejected); ``dead_chips`` removes whole chips. ``n_chips`` bounds the
    physical fleet: ``None`` means unlimited spare chips (placement always
    succeeds), an int makes :class:`FaultCapacityError` reachable.

    ``weight_faults`` are explicit cell faults; ``cell_rate``/``cell_seed``
    describe a seeded random cell-fault field expanded deterministically
    per layer at injection time (compact, so a million-cell fault field
    stays hashable); ``dead_blocks`` drop whole logical tiles.
    """

    dead_tiles: Tuple[int, ...] = ()
    dead_links: Tuple[int, ...] = ()
    dead_chips: Tuple[int, ...] = ()
    n_chips: Optional[int] = None
    weight_faults: Tuple[WeightFault, ...] = ()
    cell_rate: float = 0.0
    cell_seed: int = 0
    dead_blocks: Tuple[BlockFault, ...] = ()
    arch: ArchSpec = field(default=DEFAULT_ARCH, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "dead_tiles",
                           tuple(sorted(set(int(t) for t in self.dead_tiles))))
        object.__setattr__(self, "dead_links",
                           tuple(sorted(set(int(l) for l in self.dead_links))))
        object.__setattr__(self, "dead_chips",
                           tuple(sorted(set(int(c) for c in self.dead_chips))))
        object.__setattr__(self, "weight_faults", tuple(self.weight_faults))
        object.__setattr__(self, "dead_blocks", tuple(self.dead_blocks))
        problems: List[str] = []
        tpc = self.arch.tiles_per_chip
        for t in self.dead_tiles:
            if t < 0:
                problems.append(f"negative dead tile position {t}")
        for l in self.dead_links:
            if l < 0:
                problems.append(f"negative dead link position {l}")
            elif l % tpc == tpc - 1:
                problems.append(
                    f"dead link {l} crosses a chip boundary (link p joins "
                    f"tiles p and p+1 on one chip; p % {tpc} must be < "
                    f"{tpc - 1})")
        for c in self.dead_chips:
            if c < 0:
                problems.append(f"negative dead chip id {c}")
        if self.n_chips is not None and self.n_chips < 1:
            problems.append(f"n_chips={self.n_chips} < 1")
        if not (0.0 <= self.cell_rate < 1.0):
            problems.append(f"cell_rate={self.cell_rate} outside [0, 1)")
        for wf in self.weight_faults:
            if wf.kind not in CELL_KINDS:
                problems.append(
                    f"unknown weight-fault kind {wf.kind!r} "
                    f"(choose from {CELL_KINDS})")
            if wf.layer < 0 or wf.index < 0:
                problems.append(f"negative weight-fault coordinate {wf}")
        for bf in self.dead_blocks:
            if min(bf.layer, bf.k_index, bf.c_index, bf.m_index) < 0:
                problems.append(f"negative block-fault coordinate {bf}")
        if problems:
            raise ValueError("invalid FaultSet:\n" + "\n".join(problems))

    # -------------------- constructors --------------------
    @classmethod
    def empty(cls, arch: ArchSpec = DEFAULT_ARCH) -> "FaultSet":
        """The no-fault FaultSet: every consumer treats it exactly like
        ``faults=None`` (bitwise-identical compile/execute/serve paths —
        the golden contract tests/test_faults.py pins)."""
        return cls(arch=arch)

    @property
    def is_empty(self) -> bool:
        """True when nothing is faulted and the fleet is unbounded — the
        normalization predicate ``compile_program`` uses to route to the
        unfaulted (cached, bitwise-identical) compile path."""
        return (not self.dead_tiles and not self.dead_links
                and not self.dead_chips and self.n_chips is None
                and not self.weight_faults and self.cell_rate == 0.0
                and not self.dead_blocks)

    @property
    def has_workload_faults(self) -> bool:
        """True when execution-level injection has anything to do."""
        return bool(self.weight_faults or self.cell_rate > 0.0
                    or self.dead_blocks)

    @classmethod
    def sample(cls, rate: float, seed: int, *,
               arch: ArchSpec = DEFAULT_ARCH,
               n_chips: int = 8,
               tile_rate: Optional[float] = None,
               link_rate: Optional[float] = None,
               chip_rate: Optional[float] = None,
               cell_rate: float = 0.0,
               bounded: bool = True) -> "FaultSet":
        """Seeded fabric fault sampler, nested-monotone in ``rate``.

        One ``default_rng(seed)`` draws a fixed-size uniform per fabric
        element (all ``n_chips * tiles_per_chip`` tile positions, then
        every intra-chip link, then every chip) and thresholds it at the
        element's rate — so for a fixed seed the fault set at rate r1 is a
        subset of the set at r2 > r1 (the monotone coupling the yield
        curve's non-increasing guarantee rests on). Default sub-rates:
        tiles fail at ``rate``, links at ``rate / 2``, chips at
        ``rate / 8``. ``cell_rate`` is recorded (with ``seed``) for
        execution-time weight-cell injection. ``bounded=False`` leaves the
        fleet unbounded (placement may spill past ``n_chips``).
        """
        if not (0.0 <= rate < 1.0):
            raise ValueError(f"fault rate {rate} outside [0, 1)")
        tile_rate = rate if tile_rate is None else tile_rate
        link_rate = rate / 2.0 if link_rate is None else link_rate
        chip_rate = rate / 8.0 if chip_rate is None else chip_rate
        tpc = arch.tiles_per_chip
        rng = np.random.default_rng(seed)
        u_tiles = rng.random(n_chips * tpc)
        u_links = rng.random(n_chips * max(tpc - 1, 0))
        u_chips = rng.random(n_chips)
        dead_tiles = tuple(int(i) for i in np.flatnonzero(u_tiles < tile_rate))
        # link j of chip c is the hop between local tiles j and j+1,
        # i.e. global positions c*tpc + j and c*tpc + j + 1
        dead_links = tuple(
            int(c * tpc + j)
            for c in range(n_chips)
            for j in range(tpc - 1)
            if u_links[c * (tpc - 1) + j] < link_rate
        )
        dead_chips = tuple(int(i) for i in np.flatnonzero(u_chips < chip_rate))
        return cls(
            dead_tiles=dead_tiles, dead_links=dead_links,
            dead_chips=dead_chips,
            n_chips=n_chips if bounded else None,
            cell_rate=float(cell_rate), cell_seed=seed, arch=arch,
        )


# ---------------------------------------------------------------------------
# fabric geometry: healthy serpentine segments per chip
# ---------------------------------------------------------------------------


@lru_cache(maxsize=4096)
def chip_segments(faults: FaultSet, chip: int,
                  arch: ArchSpec = DEFAULT_ARCH) -> Tuple[Tuple[int, int], ...]:
    """Healthy serpentine segments of one chip, as local ``[start, stop)``
    runs. A segment breaks at every dead tile and at every dead link (the
    COM chain needs distance-1 serpentine hops, so a span cannot step over
    either). A dead chip has no segments; a pristine chip has one full
    ``[0, tiles_per_chip)`` run."""
    tpc = arch.tiles_per_chip
    if chip in faults.dead_chips:
        return ()
    base = chip * tpc
    dead = {t - base for t in faults.dead_tiles if base <= t < base + tpc}
    cut = {l - base for l in faults.dead_links if base <= l < base + tpc - 1}
    segments: List[Tuple[int, int]] = []
    start: Optional[int] = None
    for p in range(tpc):
        if p in dead:
            if start is not None:
                segments.append((start, p))
                start = None
            continue
        if start is None:
            start = p
        if p in cut or p == tpc - 1:  # link p -> p+1 broken, or chip edge
            segments.append((start, p + 1))
            start = None
    return tuple(segments)


def usable_tiles(faults: FaultSet, chip: int,
                 arch: ArchSpec = DEFAULT_ARCH) -> int:
    """Tiles one chip contributes to placement: its longest healthy
    serpentine segment (shorter fragments are stranded — conservative)."""
    segs = chip_segments(faults, chip, arch)
    return max((b - a for a, b in segs), default=0)


def fleet_capacity(faults: FaultSet, n_chips: int,
                   arch: ArchSpec = DEFAULT_ARCH) -> int:
    """Usable tiles across the first ``n_chips`` chips of the fleet."""
    return sum(usable_tiles(faults, c, arch) for c in range(n_chips))


def span_conflicts(start: int, n: int, faults: FaultSet,
                   arch: ArchSpec = DEFAULT_ARCH) -> List[str]:
    """Why the flat tile span ``[start, start + n)`` cannot be used on this
    faulted fabric (empty list = clean). The candidate-legality hook:
    ``repro_torch.search.space.validate_candidate(..., faults=...)`` runs every
    realized span through this, so the search engines' legality model can
    express unavailable resources."""
    tpc = arch.tiles_per_chip
    stop = start + n
    problems: List[str] = []
    if faults.n_chips is not None and stop > faults.n_chips * tpc:
        problems.append(
            f"span [{start}, {stop}) runs past the bounded fleet of "
            f"{faults.n_chips} chips ({faults.n_chips * tpc} tiles)")
    for t in faults.dead_tiles:
        if start <= t < stop:
            problems.append(f"span [{start}, {stop}) covers dead tile {t}")
    for c in faults.dead_chips:
        lo, hi = c * tpc, (c + 1) * tpc
        if start < hi and stop > lo:
            problems.append(f"span [{start}, {stop}) touches dead chip {c}")
    for l in faults.dead_links:
        # the span walks link l iff both endpoints l, l+1 are inside it
        if start <= l and l + 1 < stop:
            problems.append(
                f"span [{start}, {stop}) crosses dead serpentine link {l}")
    return problems
