"""Mapping search space: candidate encoding + the shared legality checker.

The PyTorch port's own copy of ``repro.search.space`` (host-side Python
and NumPy, the same validators and messages, the same mutation draws).

A :class:`MappingCandidate` is a frozen, hashable description of one point
in the mapping/dataflow space ``compile_program`` can realize — per layer:

* ``gaps``      — idle tiles inserted *before* the layer's span. The layer
  start positions are the cumulative sum of tiles + gaps, so any
  non-negative gap vector is placement-legal by construction (mutations
  cannot produce overlapping spans). Gap 0 everywhere is exactly the
  committed greedy contiguous placement.
* ``block_c`` / ``block_m`` — the layer's CIM blocking (rows/cols actually
  used per tile, ``1..arch.n_c`` / ``1..arch.n_m``); the block grid becomes
  ``ceil(c_in/block_c) × ceil(c_out/block_m)``. The greedy candidate uses
  the full array (``arch.n_c``/``arch.n_m``) — the committed partition.
* ``order``     — the NoC tile layout of the layer's block grid:
  ``"block"`` is the committed row-major ``(c_index, m_index)`` order
  (``_blocks_for`` / ``TileAlloc`` order); ``"chain"`` lays each M-chain's
  C-blocks contiguously (COM partial-sum chain order).
* ``egress_rot`` — which C-block closes the layer's accumulation chain
  (adds commute, so any rotation is functionally identical); rotating
  moves the egress tile on the NoC grid. ``0`` is the committed schedule.

The legality rules that used to live implicitly inside
``mapping.greedy_place`` are the explicit validators here —
:func:`validate_allocs` (capacity, span overlap, chip-id consistency) and
:func:`validate_blocks` (channel-range coverage without gap/overlap) —
shared by ``greedy_place`` (which now asserts them) and the search engines
(every emitted candidate must pass :func:`validate_candidate`).

Tile positions are flat indices into the chip sequence; chips lay their
``tiles_per_chip`` tiles out on a serpentine (boustrophedon) grid, so
consecutive positions are always Manhattan-adjacent —
:func:`tile_coords` / :func:`tile_distance` give the cost model its NoC
geometry.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.core.mapping import ConvSpec, TileAlloc

ORDERS: Tuple[str, ...] = ("block", "chain")


@dataclass(frozen=True)
class MappingCandidate:
    """One point in the mapping space — frozen and hashable, so compiled
    candidate programs memoize on ``(workload, arch, candidate)``."""

    gaps: Tuple[int, ...]          # idle tiles before each layer's span
    block_c: Tuple[int, ...]       # CIM rows used per tile (<= arch.n_c)
    block_m: Tuple[int, ...]       # CIM cols used per tile (<= arch.n_m)
    order: Tuple[str, ...]         # per-layer NoC layout: "block" | "chain"
    egress_rot: Tuple[int, ...]    # C-block rotation closing the chain

    @property
    def n_layers(self) -> int:
        return len(self.gaps)


def candidate_tiles(layer, block_c: int, block_m: int) -> Tuple[int, Tuple[int, int, int]]:
    """Tile count and ``(K², c_blocks, m_blocks)`` grid of one layer under a
    candidate blocking — ``mapping.tiles_for`` generalized off the full
    ``arch.n_c × arch.n_m`` array."""
    cb = -(-layer.c_in // block_c)
    mb = -(-layer.c_out // block_m)
    if isinstance(layer, ConvSpec):
        return layer.k * layer.k * cb * mb, (layer.k * layer.k, cb, mb)
    return cb * mb, (1, cb, mb)


def greedy_candidate(layers: Sequence, arch: ArchSpec = DEFAULT_ARCH) -> MappingCandidate:
    """The committed greedy mapping as a candidate: contiguous placement,
    full-array blocking, committed block order, unrotated chains.
    :func:`candidate_allocs` of this candidate reproduces
    ``mapping.greedy_place`` bitwise (same ``TileAlloc`` fields)."""
    n = len(layers)
    return MappingCandidate(
        gaps=(0,) * n,
        block_c=tuple(min(l.c_in, arch.n_c) for l in layers),
        block_m=tuple(min(l.c_out, arch.n_m) for l in layers),
        order=("block",) * n,
        egress_rot=(0,) * n,
    )


def candidate_starts(layers: Sequence, arch: ArchSpec,
                     cand: MappingCandidate) -> Tuple[int, ...]:
    """Flat start position of every layer's tile span (gap-cumulative)."""
    starts: List[int] = []
    pos = 0
    for layer, gap, bc, bm in zip(layers, cand.gaps, cand.block_c, cand.block_m):
        pos += gap
        starts.append(pos)
        n, _ = candidate_tiles(layer, bc, bm)
        pos += n
    return tuple(starts)


def _span_chips(start: int, n: int, tiles_per_chip: int) -> Tuple[int, ...]:
    """Chip ids covered by the flat tile span ``[start, start + n)``."""
    return tuple(range(start // tiles_per_chip,
                       (start + n - 1) // tiles_per_chip + 1))


def candidate_allocs(layers: Sequence, arch: ArchSpec,
                     cand: MappingCandidate) -> Tuple[Tuple[TileAlloc, ...], Tuple[int, ...]]:
    """Realize a candidate's placement: ``(allocs, starts)``.

    The flat-position model reproduces ``greedy_place`` exactly on the
    greedy candidate, including its boundary convention: a zero-gap layer
    whose span begins on a fresh chip right after the previous content
    filled one exactly is marked ``crosses_chip`` (its IFM arrives from
    the previous chip). A layer deliberately displaced by a positive gap
    starts a fresh span, so it crosses only if it actually spans more
    than one chip.
    """
    if cand.n_layers != len(layers):
        raise ValueError(
            f"candidate describes {cand.n_layers} layers, workload has "
            f"{len(layers)}")
    tpc = arch.tiles_per_chip
    starts = candidate_starts(layers, arch, cand)
    allocs: List[TileAlloc] = []
    prev_end = 0
    for layer, gap, bc, bm, start in zip(
            layers, cand.gaps, cand.block_c, cand.block_m, starts):
        n, grid = candidate_tiles(layer, bc, bm)
        chips = _span_chips(start, n, tpc)
        if gap == 0:
            # greedy_place's convention: start_chip is where the previous
            # span left the cursor (chip of position prev_end - 1)
            start_chip = 0 if prev_end == 0 else (prev_end - 1) // tpc
            crosses = len(chips) > 1 or chips[0] != start_chip
        else:
            crosses = len(chips) > 1
        allocs.append(TileAlloc(layer=layer, n_tiles=n, grid=grid,
                                chip_ids=chips, crosses_chip=crosses))
        prev_end = start + n
    return tuple(allocs), starts


def candidate_n_chips(layers: Sequence, arch: ArchSpec,
                      cand: MappingCandidate) -> int:
    allocs, _ = candidate_allocs(layers, arch, cand)
    return max(c for a in allocs for c in a.chip_ids) + 1


# ---------------------------------------------------------------------------
# legality — the rules greedy_place used to enforce only implicitly
# ---------------------------------------------------------------------------


def validate_alloc(alloc: TileAlloc, arch: ArchSpec) -> None:
    """One allocation's internal consistency; raises ``ValueError``.

    Checks: positive tile count, tile count == block-grid product, chip
    ids present/consecutive, and chip capacity (``n_tiles`` tiles cannot
    exceed ``len(chip_ids) * tiles_per_chip`` slots).
    """
    name = getattr(alloc.layer, "name", "?")
    problems: List[str] = []
    k2, cb, mb = alloc.grid
    if alloc.n_tiles < 1:
        problems.append(f"n_tiles={alloc.n_tiles} < 1")
    if k2 < 1 or cb < 1 or mb < 1:
        problems.append(f"grid {alloc.grid} has a non-positive factor")
    elif alloc.n_tiles != k2 * cb * mb:
        problems.append(
            f"n_tiles={alloc.n_tiles} != grid product {k2}*{cb}*{mb}")
    if not alloc.chip_ids:
        problems.append("chip_ids is empty")
    else:
        if any(c < 0 for c in alloc.chip_ids):
            problems.append(f"negative chip id in {alloc.chip_ids}")
        if list(alloc.chip_ids) != list(
                range(alloc.chip_ids[0], alloc.chip_ids[-1] + 1)):
            problems.append(
                f"chip_ids {alloc.chip_ids} are not consecutive")
        if alloc.n_tiles > len(alloc.chip_ids) * arch.tiles_per_chip:
            problems.append(
                f"capacity overflow: {alloc.n_tiles} tiles on "
                f"{len(alloc.chip_ids)} chip(s) of {arch.tiles_per_chip}")
    if problems:
        raise ValueError(
            f"invalid TileAlloc for layer {name!r}: " + "; ".join(problems))


def validate_allocs(allocs: Sequence[TileAlloc], arch: ArchSpec,
                    starts: Optional[Sequence[int]] = None,
                    faults=None) -> None:
    """A whole placement's legality; raises ``ValueError``.

    ``starts`` are the flat start positions of each span; when omitted the
    placement is taken as contiguous in order (the greedy invariant —
    ``greedy_place`` calls this form on its own output). Checks every
    allocation (:func:`validate_alloc`), that spans do not overlap, and
    that each span's chip ids match its flat extent — which together bound
    every chip's occupancy at ``tiles_per_chip``.

    ``faults`` (a :class:`repro_torch.faults.FaultSet`) switches to the
    degraded-fabric legality model: tiles may only land on healthy
    serpentine segments, every chip's load is bounded by its longest
    segment, and dead chips are excluded — the rules fault-compiled
    programs must satisfy (``starts`` does not apply: degraded placements
    are validated against the canonical occupancy walk).
    """
    if faults is not None and not faults.is_empty:
        from repro_torch.faults.place import validate_fault_allocs

        if starts is not None:
            raise ValueError(
                "validate_allocs(faults=...) validates the degraded "
                "occupancy walk; explicit starts only apply to the "
                "pristine flat-span model")
        validate_fault_allocs(allocs, arch, faults)
        return
    tpc = arch.tiles_per_chip
    if starts is None:
        starts = []
        pos = 0
        for a in allocs:
            starts.append(pos)
            pos += a.n_tiles
    if len(starts) != len(allocs):
        raise ValueError(
            f"{len(starts)} start positions for {len(allocs)} allocations")
    prev_end = 0
    for a, start in zip(allocs, starts):
        validate_alloc(a, arch)
        name = getattr(a.layer, "name", "?")
        if start < prev_end:
            raise ValueError(
                f"overlapping placement: layer {name!r} starts at tile "
                f"{start} but the previous span ends at {prev_end}")
        want = _span_chips(start, a.n_tiles, tpc)
        if tuple(a.chip_ids) != want:
            raise ValueError(
                f"chip_ids {a.chip_ids} of layer {name!r} do not match its "
                f"span [{start}, {start + a.n_tiles}) (expected {want})")
        prev_end = start + a.n_tiles


def validate_blocks(layer, block_c: int, block_m: int,
                    ranges_c: Sequence[Tuple[int, int]],
                    ranges_m: Sequence[Tuple[int, int]]) -> None:
    """Channel-range coverage of one layer's block grid; raises
    ``ValueError`` on a gap or overlap on either axis."""
    for axis, total, size, ranges in (
            ("c", layer.c_in, block_c, ranges_c),
            ("m", layer.c_out, block_m, ranges_m)):
        if size < 1:
            raise ValueError(
                f"layer {layer.name!r}: block_{axis}={size} < 1")
        expect = -(-total // size)
        if len(ranges) != expect:
            raise ValueError(
                f"layer {layer.name!r}: {len(ranges)} {axis}-ranges for "
                f"{total} channels at block size {size} (expected {expect})")
        pos = 0
        for lo, hi in ranges:
            if lo != pos:
                kind = "gap" if lo > pos else "overlap"
                raise ValueError(
                    f"layer {layer.name!r}: {axis}-range {kind} at channel "
                    f"{pos} (next range starts at {lo})")
            if hi <= lo:
                raise ValueError(
                    f"layer {layer.name!r}: empty {axis}-range [{lo}, {hi})")
            pos = hi
        if pos != total:
            raise ValueError(
                f"layer {layer.name!r}: {axis}-ranges cover [0, {pos}) of "
                f"{total} channels")


def validate_candidate(layers: Sequence, arch: ArchSpec,
                       cand: MappingCandidate,
                       max_chips: Optional[int] = None,
                       faults=None) -> None:
    """Full candidate legality; raises ``ValueError``.

    Field shapes/domains, per-layer blocking bounds, the realized
    placement (:func:`validate_allocs` on the gap-cumulative starts), and
    optionally a chip budget (the search engines pin ``max_chips`` to the
    greedy chip count so padding can never inflate the fleet).

    ``faults`` (a :class:`repro_torch.faults.FaultSet`) additionally requires
    every realized span to avoid dead tiles, dead chips, and dead
    serpentine links (and to fit a bounded fleet) — the hook that lets
    the search engines' legality model express unavailable resources.
    """
    n = len(layers)
    for fname in ("gaps", "block_c", "block_m", "order", "egress_rot"):
        vals = getattr(cand, fname)
        if len(vals) != n:
            raise ValueError(
                f"candidate.{fname} has {len(vals)} entries for {n} layers")
    for i, (layer, gap, bc, bm, order, rot) in enumerate(zip(
            layers, cand.gaps, cand.block_c, cand.block_m,
            cand.order, cand.egress_rot)):
        if gap < 0:
            raise ValueError(f"layers[{i}]: negative gap {gap}")
        if not (1 <= bc <= arch.n_c):
            raise ValueError(
                f"layers[{i}]: block_c={bc} outside [1, {arch.n_c}]")
        if not (1 <= bm <= arch.n_m):
            raise ValueError(
                f"layers[{i}]: block_m={bm} outside [1, {arch.n_m}]")
        if order not in ORDERS:
            raise ValueError(
                f"layers[{i}]: unknown order {order!r} (not in {ORDERS})")
        cb = -(-layer.c_in // bc)
        if not (0 <= rot < cb):
            raise ValueError(
                f"layers[{i}]: egress_rot={rot} outside [0, {cb})")
    allocs, starts = candidate_allocs(layers, arch, cand)
    validate_allocs(allocs, arch, starts)
    if max_chips is not None:
        chips = max(c for a in allocs for c in a.chip_ids) + 1
        if chips > max_chips:
            raise ValueError(
                f"candidate needs {chips} chips, budget is {max_chips}")
    if faults is not None and not faults.is_empty:
        from repro_torch.faults.model import span_conflicts

        problems: List[str] = []
        for a, start in zip(allocs, starts):
            for p in span_conflicts(start, a.n_tiles, faults, arch):
                problems.append(
                    f"layer {getattr(a.layer, 'name', '?')!r}: {p}")
        if problems:
            raise ValueError(
                "candidate conflicts with the fault set:\n"
                + "\n".join(problems))


# ---------------------------------------------------------------------------
# NoC geometry: serpentine tile grid per chip
# ---------------------------------------------------------------------------


def grid_cols(arch: ArchSpec) -> int:
    """Columns of the per-chip serpentine tile grid (~square)."""
    return max(1, math.isqrt(arch.tiles_per_chip - 1) + 1) \
        if arch.tiles_per_chip > 1 else 1


def tile_coords(pos: int, arch: ArchSpec) -> Tuple[int, int, int]:
    """Flat position → ``(chip, row, col)`` on the serpentine grid.

    Consecutive positions on one chip are always Manhattan-adjacent
    (boustrophedon rows), so the committed contiguous chain layout incurs
    distance-1 hops — exactly the closed forms' assumption.
    """
    tpc = arch.tiles_per_chip
    chip, local = divmod(pos, tpc)
    cols = grid_cols(arch)
    row, col = divmod(local, cols)
    if row % 2 == 1:
        col = cols - 1 - col
    return chip, row, col


def tile_distance(a: int, b: int, arch: ArchSpec) -> Optional[int]:
    """Manhattan NoC distance between two flat positions, or ``None`` when
    they sit on different chips (inter-chip traffic is accounted by the
    off-chip model, not per-hop)."""
    ca, ra, xa = tile_coords(a, arch)
    cb, rb, xb = tile_coords(b, arch)
    if ca != cb:
        return None
    return abs(ra - rb) + abs(xa - xb)


# ---------------------------------------------------------------------------
# mutation operators (seeded RNG owned by the engines)
# ---------------------------------------------------------------------------


def _with(cand: MappingCandidate, **field_updates) -> MappingCandidate:
    import dataclasses

    return dataclasses.replace(cand, **field_updates)


def mutate(cand: MappingCandidate, layers: Sequence, arch: ArchSpec,
           rng, max_chips: int, tries: int = 8) -> MappingCandidate:
    """One random legal mutation of ``cand`` (seeded ``rng`` =
    ``numpy.random.Generator``). Falls back to returning ``cand`` itself
    if ``tries`` proposals all violate legality or the chip budget."""
    n = cand.n_layers
    for _ in range(tries):
        i = int(rng.integers(n))
        op = int(rng.integers(6))
        layer = layers[i]
        if op == 0:      # flip the layer's NoC layout order
            order = list(cand.order)
            order[i] = "chain" if order[i] == "block" else "block"
            new = _with(cand, order=tuple(order))
        elif op == 1:    # nudge the gap before the layer
            gaps = list(cand.gaps)
            step = int(rng.integers(1, 9))
            gaps[i] = max(0, gaps[i] + (step if rng.random() < 0.5 else -step))
            new = _with(cand, gaps=tuple(gaps))
        elif op == 2:    # align the layer's span to the next chip boundary
            starts = candidate_starts(layers, arch, cand)
            pad = (-int(starts[i])) % arch.tiles_per_chip
            gaps = list(cand.gaps)
            gaps[i] = gaps[i] + pad if pad else 0
            new = _with(cand, gaps=tuple(gaps))
        elif op == 3:    # close the gap (return toward greedy packing)
            gaps = list(cand.gaps)
            gaps[i] = 0
            new = _with(cand, gaps=tuple(gaps))
        elif op == 4:    # reblock one axis of the layer
            choices_c = sorted({min(layer.c_in, arch.n_c),
                               max(1, arch.n_c // 2), arch.n_c})
            choices_m = sorted({min(layer.c_out, arch.n_m),
                               max(1, arch.n_m // 2), arch.n_m})
            if rng.random() < 0.5:
                bc = list(cand.block_c)
                bc[i] = int(choices_c[int(rng.integers(len(choices_c)))])
                new = _with(cand, block_c=tuple(bc))
            else:
                bm = list(cand.block_m)
                bm[i] = int(choices_m[int(rng.integers(len(choices_m)))])
                new = _with(cand, block_m=tuple(bm))
            # reblocking changes the C-chain depth: re-clamp the rotation
            rot = list(new.egress_rot)
            cb = -(-layer.c_in // new.block_c[i])
            rot[i] = min(rot[i], cb - 1)
            new = _with(new, egress_rot=tuple(rot))
        else:            # rotate which C-block closes the chain
            rot = list(cand.egress_rot)
            cb = -(-layer.c_in // cand.block_c[i])
            rot[i] = int(rng.integers(cb))
            new = _with(cand, egress_rot=tuple(rot))
        try:
            validate_candidate(layers, arch, new, max_chips=max_chips)
        except ValueError:
            continue
        if new != cand:
            return new
    return cand
