"""Seeded, deterministic fault injection in the compiler, the executor and
the serving tier (the port's counterpart of ``repro.faults``).

One frozen :class:`FaultSet` threads through the compiler and the executor,
and :class:`TransientFaults` through the serving tier:

* **compile** — ``compile_program(workload, arch, faults=...)`` places
  layers around dead tiles/links/chips on the longest healthy serpentine
  runs, spilling to spare chips (priced by the existing off-chip cost
  model) or raising :class:`FaultCapacityError` on a bounded fleet;
* **execute** — weight-cell faults and logical-tile dropout are realized
  once on the host, on the float64 weights, so the float64 reference and
  the CUDA kernel path consume byte-identical faulted arrays;
* **serve** — :class:`TransientFaults` fails decode slots and KV pages per
  step in ``Engine.serve``, which recovers by retry-and-re-prefill.
"""
from repro_torch.faults.inject import apply_weight_faults
from repro_torch.faults.model import (
    CELL_KINDS,
    BlockFault,
    FaultCapacityError,
    FaultSet,
    WeightFault,
    chip_segments,
    fleet_capacity,
    span_conflicts,
    usable_tiles,
)
from repro_torch.faults.place import (
    degraded_chips,
    fault_place,
    validate_fault_allocs,
)
from repro_torch.faults.transient import TransientFaults

__all__ = [
    "BlockFault",
    "CELL_KINDS",
    "FaultCapacityError",
    "FaultSet",
    "TransientFaults",
    "WeightFault",
    "apply_weight_faults",
    "chip_segments",
    "degraded_chips",
    "fault_place",
    "fleet_capacity",
    "span_conflicts",
    "usable_tiles",
    "validate_fault_allocs",
]
