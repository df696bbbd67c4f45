"""The port's compiler and executor (counterpart of ``repro.core``)."""
from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec, EnergyTable
from repro_torch.core.program import (
    CompiledProgram,
    LayerBlock,
    LayerProgram,
    Workload,
    compile_program,
)

__all__ = [
    "ArchSpec",
    "CompiledProgram",
    "DEFAULT_ARCH",
    "EnergyTable",
    "LayerBlock",
    "LayerProgram",
    "Workload",
    "compile_program",
]
