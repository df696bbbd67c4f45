"""Fault-aware greedy placement: the degraded-fabric twin of
``mapping.greedy_place`` (the port's own copy of ``repro.faults.place``).

The walk is the same in-order greedy pass, but each chip contributes only
its longest healthy serpentine segment (``repro_torch.faults.model.usable_tiles``
— dead tiles and dead links break the segment, dead chips contribute
nothing) and zero-capacity chips are skipped. Layers therefore *spill* to
later chips; every extra chip and chip crossing is priced by the existing
cost model (``offchip_values_img`` counts crossings, ``DominoModel`` adds
per-chip area), so graceful degradation has a visible energy/area cost
rather than a free pass. With a bounded fleet (``FaultSet.n_chips``) a
walk that runs off the end raises :class:`~repro_torch.faults.model
.FaultCapacityError` with the exact capacity arithmetic.

``validate_fault_allocs`` is the matching legality check shared through
``repro_torch.search.space.validate_allocs(..., faults=...)``: it re-derives the
canonical occupancy walk and requires the allocations to match it
field-for-field, so a placement that parks tiles on a dead chip, overfills
a degraded run, or mislabels a crossing fails with a pointed error.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec

from repro_torch.faults.model import FaultCapacityError, FaultSet, usable_tiles


def _walk(layers: Sequence, arch: ArchSpec, faults: FaultSet):
    """The canonical degraded-greedy walk: yields, per layer,
    ``(n_tiles, grid, chip_ids, crosses_chip)``."""
    from repro_torch.core.mapping import tiles_for  # late: mapping imports us

    tpc = arch.tiles_per_chip
    fleet = faults.n_chips
    chip, used = 0, 0
    placed = 0
    for layer in layers:
        n, grid = tiles_for(layer, arch)
        chips: List[int] = []
        left = n
        start_chip = chip
        while left > 0:
            if fleet is not None and chip >= fleet:
                from repro_torch.faults.model import fleet_capacity

                total = sum(
                    tiles_for(l, arch)[0] for l in layers)
                raise FaultCapacityError(
                    f"cannot place layer "
                    f"{getattr(layer, 'name', '?')!r}: the workload needs "
                    f"{total} tiles but the faulted fleet of {fleet} chips "
                    f"provides only {fleet_capacity(faults, fleet, arch)} "
                    f"usable tiles ({placed + (n - left)} placed before "
                    f"running off the fleet; pristine capacity would be "
                    f"{fleet * tpc})")
            cap = usable_tiles(faults, chip, arch)
            take = min(left, cap - used)
            if take <= 0:
                chip += 1
                used = 0
                continue
            chips.append(chip)
            used += take
            left -= take
        placed += n
        crosses = len(set(chips)) > 1 or chips[0] != start_chip
        yield n, grid, tuple(chips), crosses


def fault_place(layers: Sequence, arch: ArchSpec = DEFAULT_ARCH,
                faults: FaultSet = None) -> List:
    """Greedy in-order placement around a :class:`FaultSet`; returns the
    per-layer ``TileAlloc`` list (``mapping.greedy_place(faults=...)``
    delegates here). On an empty FaultSet this reproduces the pristine
    greedy placement exactly."""
    from repro_torch.core.mapping import TileAlloc

    if faults is None:
        faults = FaultSet.empty(arch)
    allocs: List[TileAlloc] = []
    for layer, (n, grid, chips, crosses) in zip(
            layers, _walk(layers, arch, faults)):
        allocs.append(TileAlloc(layer=layer, n_tiles=n, grid=grid,
                                chip_ids=chips, crosses_chip=crosses))
    validate_fault_allocs(allocs, arch, faults)
    return allocs


def validate_fault_allocs(allocs: Sequence, arch: ArchSpec,
                          faults: FaultSet) -> None:
    """A degraded placement's legality; raises ``ValueError``.

    Per allocation: positive tile count matching the block-grid product,
    chip ids strictly increasing with none dead. Whole placement: the
    allocations must realize the canonical degraded-greedy occupancy walk
    — every chip's load stays within its longest healthy segment and the
    crossing flags match the walk's convention (the same convention the
    pristine ``validate_allocs`` pins for greedy placements).
    """
    problems: List[str] = []
    for a in allocs:
        name = getattr(a.layer, "name", "?")
        k2, cb, mb = a.grid
        if a.n_tiles < 1:
            problems.append(f"layer {name!r}: n_tiles={a.n_tiles} < 1")
        elif a.n_tiles != k2 * cb * mb:
            problems.append(
                f"layer {name!r}: n_tiles={a.n_tiles} != grid product "
                f"{k2}*{cb}*{mb}")
        if not a.chip_ids:
            problems.append(f"layer {name!r}: chip_ids is empty")
            continue
        if list(a.chip_ids) != sorted(set(a.chip_ids)):
            problems.append(
                f"layer {name!r}: chip_ids {a.chip_ids} are not strictly "
                "increasing")
        for c in a.chip_ids:
            if c in faults.dead_chips:
                problems.append(f"layer {name!r}: placed on dead chip {c}")
            elif usable_tiles(faults, c, arch) == 0:
                problems.append(
                    f"layer {name!r}: chip {c} has no usable serpentine "
                    "segment")
    if problems:
        raise ValueError(
            "invalid degraded placement:\n" + "\n".join(problems))
    want = list(_walk([a.layer for a in allocs], arch, faults))
    for a, (n, _grid, chips, crosses) in zip(allocs, want):
        name = getattr(a.layer, "name", "?")
        if a.n_tiles != n:
            problems.append(
                f"layer {name!r}: n_tiles={a.n_tiles}, the block partition "
                f"needs {n}")
        if tuple(a.chip_ids) != chips:
            problems.append(
                f"layer {name!r}: chip_ids {a.chip_ids} do not match the "
                f"degraded occupancy walk (expected {chips}: chips "
                "contribute their longest healthy segment, in order)")
        if bool(a.crosses_chip) != crosses:
            problems.append(
                f"layer {name!r}: crosses_chip={a.crosses_chip}, the walk "
                f"convention says {crosses}")
    if problems:
        raise ValueError(
            "invalid degraded placement:\n" + "\n".join(problems))


def degraded_chips(allocs: Sequence) -> int:
    """Fleet size a degraded placement actually touches."""
    return max(c for a in allocs for c in a.chip_ids) + 1
