"""Batched Domino design-space exploration (the port's counterpart of
``repro.sweep``).

``SweepGrid`` (validation-first scenario schema, including the `ArchSpec`
axes ``tiles_per_chip`` / ``n_c`` / ``n_m`` / ``node_nm``) x ``run_sweep``
(vectorized evaluation of every Tab. IV column over the whole grid in one
shot, on a pluggable backend: ``"torch"``, the default, is the float64
column math on the card; ``"numpy"`` is the golden oracle on the host). The
batched results are held to per-scenario ``DominoModel.evaluate`` by the
golden tests, and the torch backend to the NumPy one.
"""
from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.sweep.engine import (
    BACKENDS,
    COLUMNS,
    ScenarioBatch,
    SweepResult,
    build_batch,
    evaluate_scenario,
    network_summary,
    register_backend,
    run_sweep,
)
from repro_torch.sweep.backend_torch import make_torch_backend  # registers "torch"
from repro_torch.sweep.registry import available_networks, resolve_network
from repro_torch.sweep.scenario import (
    AXES,
    Precision,
    Scenario,
    SweepGrid,
    SweepValidationError,
)

__all__ = [
    "AXES",
    "ArchSpec",
    "BACKENDS",
    "COLUMNS",
    "DEFAULT_ARCH",
    "Precision",
    "Scenario",
    "ScenarioBatch",
    "SweepGrid",
    "SweepResult",
    "SweepValidationError",
    "available_networks",
    "build_batch",
    "evaluate_scenario",
    "make_torch_backend",
    "network_summary",
    "register_backend",
    "resolve_network",
    "run_sweep",
]
