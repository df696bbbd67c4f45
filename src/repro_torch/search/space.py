"""Placement legality: the rules ``greedy_place`` asserts on its own output.

The PyTorch port's own copy of the pristine-fabric validators of
``repro.search.space``. Tile positions are flat indices into the chip
sequence; a layer's span ``[start, start + n_tiles)`` covers the chips
``start // tiles_per_chip .. (start + n_tiles - 1) // tiles_per_chip``.
The candidate encoding and the search engines are not ported yet.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

from repro_torch.core.arch import ArchSpec


def _span_chips(start: int, n: int, tiles_per_chip: int) -> Tuple[int, ...]:
    """Chip ids covered by the flat tile span ``[start, start + n)``."""
    return tuple(range(start // tiles_per_chip,
                       (start + n - 1) // tiles_per_chip + 1))


def validate_alloc(alloc, arch: ArchSpec) -> None:
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


def validate_allocs(allocs: Sequence, arch: ArchSpec) -> None:
    """A contiguous in-order placement's legality (the greedy invariant);
    raises ``ValueError``.

    Checks every allocation (:func:`validate_alloc`) and that each span's
    chip ids match its flat extent — which together bound every chip's
    occupancy at ``tiles_per_chip``. (The JAX package's form with explicit
    start positions serves the mapping search, which is not ported yet.)
    """
    start = 0
    for a in allocs:
        validate_alloc(a, arch)
        want = _span_chips(start, a.n_tiles, arch.tiles_per_chip)
        if tuple(a.chip_ids) != want:
            raise ValueError(
                f"chip_ids {a.chip_ids} of layer {getattr(a.layer, 'name', '?')!r} do not "
                f"match its span [{start}, {start + a.n_tiles}) (expected {want})")
        start += a.n_tiles
