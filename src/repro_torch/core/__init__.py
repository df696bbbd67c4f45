"""The port's compiler, executor and Tab. IV evaluation (counterpart of
``repro.core``)."""
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
    "compile_program",
    "conv_events",
    "fc_events",
    "offchip_values_img",
    "onchip_pj_from_events",
    "reference_conv",
    "reference_fc",
]
