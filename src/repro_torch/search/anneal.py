"""Simulated-annealing mapping search (seeded, batch-evaluated).

The PyTorch port's own copy of ``repro.search.anneal``.

Classic Metropolis annealing over :class:`MappingCandidate` space with one
twist for throughput: each step proposes a *batch* of mutations of the
current state and scores the whole batch through the
:class:`~repro_torch.search.cost.PopulationEvaluator` in one call, then applies
the accept rule to the batch's best proposal. The RNG is a seeded
``numpy.random.Generator`` and every decision (mutation draws, Metropolis
coin flips) draws from it in a fixed order, so a fixed seed reproduces the
returned mapping bit-for-bit.

The best-so-far state is initialized with the greedy candidate, so the
result can never be worse than greedy — ``searched ≤ greedy`` holds by
construction and the engines only ever improve on it.
"""
from __future__ import annotations

import math
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.search.cost import PopulationEvaluator, SearchResult
from repro_torch.search.space import (
    candidate_n_chips,
    greedy_candidate,
    mutate,
)


def anneal_search(layers: Sequence, arch: ArchSpec = DEFAULT_ARCH, *,
                  budget: int = 256, seed: int = 0,
                  evaluator: Optional[PopulationEvaluator] = None,
                  batch: int = 16, t0: Optional[float] = None,
                  cooling: float = 0.85) -> SearchResult:
    """Anneal for at most ``budget`` candidate evaluations.

    ``t0`` defaults to 0.1% of the greedy hop energy — hot enough to accept
    small regressions early, cold within a few dozen batches. ``evaluator``
    is injectable so tests can intercept every emitted candidate.
    """
    wall0 = time.perf_counter()
    layers = tuple(layers)
    if evaluator is None:
        evaluator = PopulationEvaluator(layers, arch)
    rng = np.random.default_rng(seed)
    greedy = greedy_candidate(layers, arch)
    gcost = evaluator.costs([greedy])[0]
    max_chips = candidate_n_chips(layers, arch, greedy)
    current, ccost = greedy, gcost
    best, bcost = greedy, gcost
    evals = 1
    history = [gcost.hop_energy_pj]
    temp = t0 if t0 is not None else max(gcost.hop_energy_pj * 1e-3, 1e-9)
    while evals < budget:
        k = min(batch, budget - evals)
        proposals = [mutate(current, layers, arch, rng, max_chips)
                     for _ in range(k)]
        costs = evaluator.costs(proposals)
        evals += k
        j = min(range(k), key=lambda i: costs[i].objective)
        cand, cost = proposals[j], costs[j]
        delta = cost.hop_energy_pj - ccost.hop_energy_pj
        if delta <= 0 or rng.random() < math.exp(-delta / max(temp, 1e-30)):
            current, ccost = cand, cost
        if cost.objective < bcost.objective:
            best, bcost = cand, cost
        history.append(bcost.hop_energy_pj)
        temp *= cooling
    return SearchResult(
        candidate=best, cost=bcost, greedy_cost=gcost, engine="anneal",
        evaluations=evals, history=tuple(history),
        wall_s=time.perf_counter() - wall0,
    )
