"""``repro_torch.search`` — mapping/dataflow optimization over the compile
IR (the port's counterpart of ``repro.search``).

The search covers the mapping space that placement lives in — per-layer
NoC placement gaps, ``n_c×n_m`` blocking, tile layout order, and chain
egress rotation — for mappings that beat greedy on ps/ifm hop energy.

Pieces:

* :mod:`repro_torch.search.space`  — candidate encoding + the legality
  validator shared with ``mapping.greedy_place``.
* :mod:`repro_torch.search.cost`   — the cost model (closed-form base +
  serpentine-NoC transit extension, NumPy float64 on the host) and the
  :class:`PopulationEvaluator` that scores populations' Tab. IV columns
  through the sweep backends.
* :mod:`repro_torch.search.anneal` / :mod:`repro_torch.search.evolve` —
  the engines (seeded NumPy generators, scoring through ``costs``).
* :func:`search_mapping`     — the entry point
  ``compile_program(workload, arch, mapping="searched")`` consumes.

Results are memoized on ``(workload, arch, budget, engine, seed,
backend)`` — ``repro_torch.core.cache_stats()`` reports the cache as
``search_mapping``.
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.search.anneal import anneal_search
from repro_torch.search.cost import (
    MappingCost,
    PopulationEvaluator,
    SearchResult,
    mapping_cost,
)
from repro_torch.search.evolve import evolve_search
from repro_torch.search.space import (
    MappingCandidate,
    candidate_allocs,
    greedy_candidate,
    mutate,
    validate_allocs,
    validate_candidate,
)

ENGINES = {"anneal": anneal_search, "evolve": evolve_search}

__all__ = [
    "ENGINES",
    "MappingCandidate",
    "MappingCost",
    "PopulationEvaluator",
    "SearchResult",
    "anneal_search",
    "candidate_allocs",
    "evolve_search",
    "greedy_candidate",
    "mapping_cost",
    "mutate",
    "search_mapping",
    "validate_allocs",
    "validate_candidate",
]


@lru_cache(maxsize=64)
def _search_mapping(workload, arch: ArchSpec, budget: int, engine: str,
                    seed: int, backend) -> SearchResult:
    try:
        fn = ENGINES[engine]
    except KeyError:
        raise ValueError(
            f"unknown search engine {engine!r}; available: "
            f"{sorted(ENGINES)}") from None
    evaluator = PopulationEvaluator(workload.layers, arch, backend=backend)
    return fn(workload.layers, arch, budget=budget, seed=seed,
              evaluator=evaluator)


def search_mapping(workload, arch: ArchSpec = DEFAULT_ARCH, *,
                   budget: int = 256, engine: str = "evolve", seed: int = 0,
                   backend="torch") -> SearchResult:
    """Search the mapping space of ``workload`` under ``arch``.

    ``budget`` bounds total candidate evaluations (greedy included —
    budget 1 returns greedy itself); ``engine`` is ``"evolve"`` (default)
    or ``"anneal"``; ``seed`` makes the run bit-for-bit reproducible.
    ``backend`` names the sweep backend of the evaluator's ``columns``:
    ``"torch"`` (default; the float64 column math on the card), ``"numpy"``
    (the host oracle) or a backend callable. The JAX package's default is
    its ``"jax"`` backend, which the port does not have. The engines score
    candidates only through the evaluator's NumPy ``costs``, so the search
    touches no device and its result does not depend on ``backend``.

    Returns a :class:`~repro_torch.search.cost.SearchResult` whose
    ``candidate`` feeds ``compile_program(workload, arch,
    mapping=result.candidate)`` (or let ``mapping="searched"`` call this
    for you). The searched cost never exceeds the greedy cost — both
    engines start from greedy and keep it unless strictly beaten.
    """
    from repro_torch.core.program import Workload

    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    return _search_mapping(Workload.of(workload), arch, int(budget),
                           engine, int(seed), backend)
