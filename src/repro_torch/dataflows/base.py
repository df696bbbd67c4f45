"""The ``DataflowModel`` protocol and registry.

The PyTorch port's own copy of ``repro.dataflows.base``.

Scored by its own closed forms alone, the COM dataflow reproduces the
paper's headline (localized computing-on-the-move slashes data-movement
energy) without ever *contesting* it. This module defines the pluggable contract under which rival dataflow event
models are scored on the **same silicon** (one shared
:class:`~repro_torch.core.arch.ArchSpec` / :class:`~repro_torch.core.arch.EnergyTable`)
and the **same workloads** (the frozen layer tuples of
``repro_torch.sweep.registry``), so a sweep can put a published rival next to COM
in every Tab. IV column.

A model owns three things:

* **traffic** — per-layer, per-image value/transfer counts
  (:meth:`DataflowModel.layer_traffic`), the analog of the COM event closed
  forms in ``repro_torch.core.simulator.batched_layer_events``;
* **pricing** — those counts priced through the shared ``EnergyTable`` at
  the architecture's technology corner
  (:meth:`DataflowModel.energy_breakdown_img_j`);
* **summary overrides** — the subset of the sweep engine's per-(network,
  arch) ``NetworkSummary`` fields the model replaces
  (:meth:`DataflowModel.summary_overrides`). The registered COM model
  returns ``{}`` here, which is what keeps the sweep's ``dataflow="com"``
  column bitwise-identical to the pre-registry engine.

Registered models are singletons; their per-``(layers, arch)`` caches are
bounded LRUs reported by :func:`dataflow_cache_stats`.
"""
from __future__ import annotations

import abc
from functools import lru_cache
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec

# Bumped whenever a registered model's closed forms or pricing change in a
# way that shifts committed artifacts. Benchmark payloads record it so a
# baseline mismatch names the registry generation, not just a float drift.
REGISTRY_VERSION = 1

# NetworkSummary fields a model may override (everything else — timing,
# ops, off-chip pJ/bit — is shared: same silicon, same workload).
OVERRIDABLE_SUMMARY_FIELDS: Tuple[str, ...] = (
    "n_tiles", "onchip_j", "offchip_values", "area_mm2",
)


class DataflowModel(abc.ABC):
    """One dataflow's closed-form event/energy model.

    Subclasses set ``name`` (the registry key and sweep-axis value),
    ``cite`` (the paper the closed forms come from), and
    ``TRAFFIC_FIELDS`` (the component names ``layer_traffic`` emits), and
    implement the abstract methods. ``layers`` is always a tuple of frozen
    ``ConvSpec``/``FCSpec`` layer specs (hashable — it is the cache key),
    ``arch`` a frozen ``ArchSpec``.
    """

    name: str = ""
    cite: str = ""
    TRAFFIC_FIELDS: Tuple[str, ...] = ()

    def __init__(self):
        # bounded per-model caches, keyed on the hashable (layers, arch);
        # introspected by dataflow_cache_stats()
        self._traffic_totals = lru_cache(maxsize=1024)(self._totals_uncached)
        self._summary_overrides = lru_cache(maxsize=1024)(
            self._overrides_uncached)

    # ---- traffic ----
    @abc.abstractmethod
    def layer_traffic(self, layers: Tuple, arch: ArchSpec
                      ) -> Dict[str, np.ndarray]:
        """Per-layer, per-image traffic counts: ``{field: (n_layers,)
        float64}`` with exactly the keys of ``TRAFFIC_FIELDS``."""

    def _totals_uncached(self, layers: Tuple, arch: ArchSpec
                         ) -> Tuple[float, ...]:
        per_layer = self.layer_traffic(layers, arch)
        if set(per_layer) != set(self.TRAFFIC_FIELDS):
            raise ValueError(
                f"{self.name}: layer_traffic keys {sorted(per_layer)} != "
                f"declared TRAFFIC_FIELDS {sorted(self.TRAFFIC_FIELDS)}")
        return tuple(
            float(np.asarray(per_layer[f], dtype=np.float64).sum())
            for f in self.TRAFFIC_FIELDS
        )

    def traffic_totals(self, layers: Sequence,
                       arch: ArchSpec = DEFAULT_ARCH) -> Dict[str, float]:
        """Whole-network per-image traffic totals (cached)."""
        vals = self._traffic_totals(tuple(layers), arch)
        return dict(zip(self.TRAFFIC_FIELDS, vals))

    # ---- pricing ----
    @abc.abstractmethod
    def energy_breakdown_img_j(self, layers: Tuple, arch: ArchSpec
                               ) -> Dict[str, float]:
        """On-chip energy per image (J) by named component, priced through
        ``arch.energy`` at the ``arch.energy_scale()`` corner."""

    def onchip_energy_img_j(self, layers: Sequence,
                            arch: ArchSpec = DEFAULT_ARCH) -> float:
        """Total on-chip J/image (default: the breakdown summed)."""
        return float(
            sum(self.energy_breakdown_img_j(tuple(layers), arch).values()))

    @abc.abstractmethod
    def offchip_values_img(self, layers: Tuple, arch: ArchSpec) -> float:
        """Feature-map values crossing a chip boundary per image
        (bit-width independent, same convention as
        ``repro_torch.core.simulator.offchip_values_img``)."""

    def offchip_energy_img_j(self, layers: Sequence, arch: ArchSpec,
                             bits: int = None) -> float:
        """Inter-chip J/image at ``bits`` (default ``arch.precision_bits``),
        priced on the shared transceiver energy."""
        if bits is None:
            bits = arch.precision_bits
        return self.offchip_values_img(tuple(layers), arch) * bits \
            * arch.energy.interchip_pj_per_bit * arch.energy_scale() * 1e-12

    def movement_energy_img_j(self, layers: Sequence,
                              arch: ArchSpec = DEFAULT_ARCH) -> float:
        """The head-to-head headline: data-movement J/image — every on-chip
        component that moves or stores values (compute components like
        adders/activations excluded by subclasses) plus off-chip transfer
        at ``arch.precision_bits``. Default: on-chip total + off-chip."""
        layers = tuple(layers)
        return self.onchip_energy_img_j(layers, arch) \
            + self.offchip_energy_img_j(layers, arch)

    # ---- structure ----
    @abc.abstractmethod
    def n_arrays(self, layers: Tuple, arch: ArchSpec) -> int:
        """CIM arrays (tiles) the model's mapping occupies."""

    # ---- sweep integration ----
    def _overrides_uncached(self, layers: Tuple, arch: ArchSpec
                            ) -> Tuple[Tuple[str, float], ...]:
        n = self.n_arrays(layers, arch)
        return (
            ("n_tiles", float(n)),
            ("onchip_j", self.onchip_energy_img_j(layers, arch)),
            ("offchip_values", self.offchip_values_img(layers, arch)),
            ("area_mm2", n * arch.tile_area_um2() / 1e6),
        )

    def summary_overrides(self, layers: Sequence,
                          arch: ArchSpec = DEFAULT_ARCH) -> Dict[str, float]:
        """``NetworkSummary`` fields this model replaces in the sweep
        engine (subset of ``OVERRIDABLE_SUMMARY_FIELDS``; cached). Timing
        fields stay the engine's COM pipeline model — the head-to-head is
        an energy/structure comparison on shared throughput assumptions."""
        out = dict(self._summary_overrides(tuple(layers), arch))
        extra = set(out) - set(OVERRIDABLE_SUMMARY_FIELDS)
        if extra:
            raise ValueError(
                f"{self.name}: summary_overrides may only set "
                f"{OVERRIDABLE_SUMMARY_FIELDS}, got extra {sorted(extra)}")
        return out

    def cache_infos(self) -> Dict[str, object]:
        """``functools.CacheInfo`` per bounded cache of this model."""
        return {
            "traffic_totals": self._traffic_totals.cache_info(),
            "summary_overrides": self._summary_overrides.cache_info(),
        }


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, DataflowModel] = {}


def register_dataflow(model: DataflowModel, *, overwrite: bool = False) -> None:
    """Register ``model`` under ``model.name`` (insertion-ordered; the COM
    reference model registers first). Re-registering an existing name
    raises unless ``overwrite=True``."""
    if not isinstance(model, DataflowModel):
        raise TypeError(f"expected a DataflowModel instance, got {model!r}")
    if not model.name or not isinstance(model.name, str):
        raise ValueError(f"dataflow model {model!r} needs a non-empty name")
    if model.name in _REGISTRY and not overwrite:
        raise ValueError(
            f"dataflow {model.name!r} is already registered; pass "
            f"overwrite=True to replace it")
    _REGISTRY[model.name] = model


def get_dataflow(name: str) -> DataflowModel:
    """Registered model by name (KeyError names the known models)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown dataflow {name!r}; registered: "
            f"{list(available_dataflows())}") from None


def available_dataflows() -> Tuple[str, ...]:
    """Registered dataflow names, registration order (``com`` first)."""
    return tuple(_REGISTRY)


def dataflow_cache_stats() -> Dict[str, object]:
    """Cache stats of every registered model, keyed
    ``dataflow:<name>:<cache>``."""
    return {
        f"dataflow:{name}:{cache}": info
        for name, model in _REGISTRY.items()
        for cache, info in model.cache_infos().items()
    }
