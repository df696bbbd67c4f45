"""Transient serving-tier faults: seeded slot/page failures per decode step.

The port's copy of ``repro.faults.transient``: the draws are NumPy in both
packages, so a fault schedule here equals the JAX package's.

``Engine.serve(faults=TransientFaults(...))`` consults this model once per
decode step: each active slot fails independently with
``slot_rate``; in paged mode each page a slot holds additionally fails
with ``page_rate`` (a corrupted page corrupts its owning slot). A failed
slot's token for that step is discarded and the engine recovers by
re-prefilling the slot's context (prompt + tokens emitted so far) after
consulting :class:`repro_torch.runtime.fault_tolerance.RestartPolicy`.

Determinism: the per-step draw uses
``default_rng(SeedSequence([seed, step]))`` with one uniform per slot in
slot order, so a fault schedule is a pure function of (seed, step,
active-slot set) — identical across machines and replays.

``poison`` marks *deterministic* faults: a ``(arrival_index, produced)``
pair fails every attempt to produce that request's token ``produced``.
Since a retry re-attempts the same token, the RestartPolicy sees the same
fault identity three times and halts — the "don't burn the fleet"
branch, now reachable from the serving tier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class TransientFaults:
    """Seeded transient failure injection for ``Engine.serve``.

    ``slot_rate`` — per (active slot, decode step) failure probability;
    ``page_rate`` — per (held page, decode step) failure probability
    (paged engines only; a slot holding ``p`` pages fails with
    ``1 - (1 - page_rate)**p``);
    ``poison`` — ``(arrival_index, produced)`` pairs that fail
    deterministically on every attempt.
    """

    slot_rate: float = 0.0
    page_rate: float = 0.0
    seed: int = 0
    poison: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "poison",
            tuple((int(i), int(p)) for i, p in self.poison))
        for name in ("slot_rate", "page_rate"):
            v = getattr(self, name)
            if not (0.0 <= v < 1.0):
                raise ValueError(f"{name}={v} outside [0, 1)")

    @property
    def is_empty(self) -> bool:
        return (self.slot_rate == 0.0 and self.page_rate == 0.0
                and not self.poison)

    def failed_slots(self, step: int,
                     active: Sequence[Tuple[int, int, int]],
                     pages_held: Optional[Sequence[int]] = None) -> List[int]:
        """Slots that fail at decode step ``step``.

        ``active`` lists ``(slot, arrival_index, produced)`` for every
        occupied slot, in slot order; ``pages_held`` aligns with it in
        paged mode. Returns the failed slot ids (subset of the active
        slots, in slot order).
        """
        if not active:
            return []
        failed: List[int] = []
        u_slot = u_page = None
        if self.slot_rate > 0.0 or self.page_rate > 0.0:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, int(step)]))
            # fixed draw order (slots first, then pages) so paged and
            # contiguous runs of the same traffic share the slot draws
            u_slot = rng.random(len(active))
            u_page = rng.random(len(active))
        for i, (slot, index, produced) in enumerate(active):
            hit = (index, produced) in self.poison
            if not hit and u_slot is not None:
                if u_slot[i] < self.slot_rate:
                    hit = True
                elif self.page_rate > 0.0 and pages_held is not None:
                    p_fail = 1.0 - (1.0 - self.page_rate) ** int(pages_held[i])
                    hit = u_page[i] < p_fail
            if hit:
                failed.append(slot)
        return failed
