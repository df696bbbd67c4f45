"""``repro_torch.dataflows`` — pluggable dataflow event models (the port's
own copy of ``repro.dataflows``).

COM (the source paper's dataflow) and its published rivals scored on the
same silicon (shared ``ArchSpec``/``EnergyTable``) and workloads, so sweeps
benchmark COM head-to-head instead of only against itself. Importing this
package registers the built-in models:

* ``"com"`` — the COM closed forms, bitwise-anchored to the engine's
  native Tab. IV numbers (``repro_torch.dataflows.com``);
* ``"minimal_buffer"`` — the minimal-buffer-traffic CIM dataflow of
  arxiv 2508.14375 (``repro_torch.dataflows.minimal_buffer``).

Entry points: :func:`get_dataflow` / :func:`available_dataflows` /
:func:`register_dataflow`; the sweep engine threads a ``dataflow`` grid
axis through every backend.
"""
from repro_torch.dataflows.base import (
    OVERRIDABLE_SUMMARY_FIELDS,
    REGISTRY_VERSION,
    DataflowModel,
    available_dataflows,
    dataflow_cache_stats,
    get_dataflow,
    register_dataflow,
)
from repro_torch.dataflows.com import COMDataflow
from repro_torch.dataflows.minimal_buffer import MinimalBufferDataflow

__all__ = [
    "COMDataflow",
    "DataflowModel",
    "MinimalBufferDataflow",
    "OVERRIDABLE_SUMMARY_FIELDS",
    "REGISTRY_VERSION",
    "available_dataflows",
    "dataflow_cache_stats",
    "get_dataflow",
    "register_dataflow",
]
