"""The port's compiler, executor and Tab. IV evaluation (counterpart of
``repro.core``)."""
from typing import Dict

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec, EnergyTable
from repro_torch.core.energy import COUNTERPARTS, PAPER_DOMINO, Counterpart
from repro_torch.core.program import (
    CompiledProgram,
    LayerBlock,
    LayerProgram,
    Workload,
    compile_program,
)
from repro_torch.core.simulator import (
    COMGridSim,
    DominoModel,
    Events,
    PowerBreakdown,
    conv_events,
    fc_events,
    offchip_values_img,
    onchip_pj_from_events,
    reference_conv,
    reference_fc,
)

__all__ = [
    "ArchSpec",
    "COMGridSim",
    "COUNTERPARTS",
    "CompiledProgram",
    "Counterpart",
    "DEFAULT_ARCH",
    "DominoModel",
    "EnergyTable",
    "Events",
    "LayerBlock",
    "LayerProgram",
    "PAPER_DOMINO",
    "PowerBreakdown",
    "Workload",
    "cache_stats",
    "compile_program",
    "conv_events",
    "fc_events",
    "offchip_values_img",
    "onchip_pj_from_events",
    "reference_conv",
    "reference_fc",
]


def cache_stats() -> Dict[str, object]:
    """``functools.CacheInfo`` for every bounded LRU cache of the port's
    evaluation stack, under the JAX package's key names
    (``repro.core.cache_stats``): the compile, schedule and event caches
    always, and the sweep, fault, search and dataflow caches once those
    packages are loaded."""
    import sys

    from repro_torch.core.program import (
        _compile_candidate,
        _compile_program,
        _compile_program_faulted,
    )
    from repro_torch.core.schedule import _layer_schedules
    from repro_torch.core.simulator import _network_event_totals, layer_table

    stats = {
        "compile_program": _compile_program.cache_info(),
        "compile_candidate": _compile_candidate.cache_info(),
        "compile_faulted": _compile_program_faulted.cache_info(),
        "layer_schedules": _layer_schedules.cache_info(),
        "layer_table": layer_table.cache_info(),
        "network_event_totals": _network_event_totals.cache_info(),
    }
    engine = sys.modules.get("repro_torch.sweep.engine")
    if engine is not None:
        stats["network_summary"] = engine._network_summary.cache_info()
        stats["dataflow_summary"] = engine._dataflow_summary.cache_info()
    faults = sys.modules.get("repro_torch.faults.model")
    if faults is not None:
        stats["chip_segments"] = faults.chip_segments.cache_info()
    search = sys.modules.get("repro_torch.search")
    if search is not None:
        stats["search_mapping"] = search._search_mapping.cache_info()
    dataflows = sys.modules.get("repro_torch.dataflows")
    if dataflows is not None:
        stats.update(dataflows.dataflow_cache_stats())
    return stats
