"""(μ+λ) evolutionary mapping search (seeded, batch-evaluated).

The PyTorch port's own copy of ``repro.search.evolve``.

Small-population elitist evolution over :class:`MappingCandidate` space:
every generation mutates ``λ`` offspring off uniformly drawn parents,
scores the whole brood through the
:class:`~repro_torch.search.cost.PopulationEvaluator` in one batched call, and
keeps the best ``μ`` of parents + offspring (stable sort on the
lexicographic objective, so ties resolve deterministically in favor of
the incumbent). The greedy candidate seeds the population and elitism
never discards an unbeaten incumbent, so ``searched ≤ greedy`` holds by
construction; a fixed seed reproduces the returned mapping bit-for-bit.
"""
from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.search.cost import MappingCost, PopulationEvaluator, SearchResult
from repro_torch.search.space import (
    MappingCandidate,
    candidate_n_chips,
    greedy_candidate,
    mutate,
)


def evolve_search(layers: Sequence, arch: ArchSpec = DEFAULT_ARCH, *,
                  budget: int = 256, seed: int = 0,
                  evaluator: Optional[PopulationEvaluator] = None,
                  mu: int = 6, lam: int = 16) -> SearchResult:
    """Evolve for at most ``budget`` candidate evaluations.

    ``evaluator`` is injectable so tests can intercept every emitted
    candidate; the engines share its batch-scoring path with the sweep
    backends.
    """
    wall0 = time.perf_counter()
    layers = tuple(layers)
    if evaluator is None:
        evaluator = PopulationEvaluator(layers, arch)
    rng = np.random.default_rng(seed)
    greedy = greedy_candidate(layers, arch)
    gcost = evaluator.costs([greedy])[0]
    max_chips = candidate_n_chips(layers, arch, greedy)
    pop: List[Tuple[MappingCandidate, MappingCost]] = [(greedy, gcost)]
    evals = 1
    history = [gcost.hop_energy_pj]
    # seed brood: mutations of greedy fill the initial parent pool
    k = min(max(mu - 1, 0), max(budget - evals, 0))
    if k:
        seeds = [mutate(greedy, layers, arch, rng, max_chips)
                 for _ in range(k)]
        pop += list(zip(seeds, evaluator.costs(seeds)))
        evals += k
        pop.sort(key=lambda pc: pc[1].objective)
        history.append(pop[0][1].hop_energy_pj)
    while evals < budget:
        k = min(lam, budget - evals)
        parents = [pop[int(rng.integers(len(pop)))][0] for _ in range(k)]
        brood = [mutate(p, layers, arch, rng, max_chips) for p in parents]
        pop += list(zip(brood, evaluator.costs(brood)))
        evals += k
        pop.sort(key=lambda pc: pc[1].objective)   # stable: incumbents win ties
        del pop[mu:]
        history.append(pop[0][1].hop_energy_pj)
    best, bcost = pop[0]
    return SearchResult(
        candidate=best, cost=bcost, greedy_cost=gcost, engine="evolve",
        evaluations=evals, history=tuple(history),
        wall_s=time.perf_counter() - wall0,
    )
