"""Network name registry for the sweep engine.

The PyTorch port's own copy of ``repro.sweep.registry``.

Two namespaces:
  * the paper's Tab. IV CNNs (``vgg11-cifar`` ... ``resnet18-cifar``) from
    ``repro_torch.core.mapping.NETWORKS``;
  * ``llm:<arch-id>`` for every seed config in ``repro_torch.configs`` via the
    FC-chain bridge (``repro_torch.sweep.llm_bridge``).

``resolve_network`` returns the (hashable, cached) frozen ``Workload`` a
name maps to — the key ``compile_program`` (and with it every mapping/
schedule/event cache) is keyed on.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Tuple

from repro_torch.configs import ARCHS, get_config
from repro_torch.core.mapping import NETWORKS
from repro_torch.core.program import Workload
from repro_torch.sweep.llm_bridge import fc_network_from_config

LLM_PREFIX = "llm:"


@lru_cache(maxsize=None)
def available_networks() -> Tuple[str, ...]:
    """Every name a ``SweepGrid.networks`` axis may use: the paper's four
    Tab. IV CNNs plus one ``llm:<arch-id>`` bridge per seed config."""
    return tuple(NETWORKS) + tuple(f"{LLM_PREFIX}{a}" for a in ARCHS)


@lru_cache(maxsize=None)
def resolve_network(name: str) -> Workload:
    """Name -> frozen ``Workload`` (raises KeyError for unknowns — grids
    are validated before they get here). Cached, so repeated scenarios
    share one workload object and one compile cache line."""
    if name in NETWORKS:
        return NETWORKS[name]()
    if name.startswith(LLM_PREFIX):
        return Workload(
            name, fc_network_from_config(get_config(name[len(LLM_PREFIX):])))
    raise KeyError(
        f"unknown network {name!r}; known: {list(available_networks())}"
    )
