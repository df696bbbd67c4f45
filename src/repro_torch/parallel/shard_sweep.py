"""Sharded sweep evaluation: the scenario axis over a ``("data",)`` mesh.

The port's copy of ``repro.parallel.shard_sweep``. The batched sweep engine
(``repro_torch.sweep.engine``) evaluates every Tab. IV column as
elementwise closed forms over stacked per-scenario arrays — exactly the
shape data parallelism wants. This module registers the
``"torch-sharded"`` backend: the float64 column math of the ``"torch"``
backend (``repro_torch.sweep.backend_torch``) on each device of an
in-process data mesh (``repro_torch.launch.mesh.make_data_mesh``), each
device evaluating one contiguous slice of the flat scenario axis, the
columns concatenated back on the host.

* **Chunking composes.** ``run_sweep(grid, backend="torch-sharded",
  chunk_size=...)`` hands the backend gathered ``(chunk,)`` batches; each
  chunk is split across the mesh in turn.
* **Bitwise parity.** The column math is elementwise — no reductions — so
  sharding changes only *where* each scenario is evaluated: the columns
  equal the unsharded ``"torch"`` backend's on the same flat evaluation
  bit for bit, on any number of shards.
* **One device.** On a 1-device mesh the backend runs the torch backend's
  flat path on the flattened batch, the same bits as any split.

The scenario axis is padded (edge-replicated) up to a multiple of the mesh
size and the pad rows are sliced off after, so grids need not divide the
device count.

``run_sweep`` resolves the name to :func:`sharded_torch_backend` on use::

    run_sweep(grid, backend="torch-sharded")    # every visible card
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.launch.mesh import make_data_mesh
from repro_torch.sweep.backend_torch import _column_exprs, _f64, flat_views, make_torch_backend
from repro_torch.sweep.engine import COLUMNS, ScenarioBatch, SweepBackend


def _pad_to_multiple(a: np.ndarray, multiple: int) -> np.ndarray:
    """Edge-pad the leading axis up to a multiple (pad rows are evaluated
    and discarded — edge values keep them numerically benign)."""
    pad = (-a.shape[0]) % multiple
    if pad == 0:
        return a
    return np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])


def sharded_torch_backend(batch: ScenarioBatch, mesh=None) -> Dict[str, np.ndarray]:
    """Evaluate a :class:`ScenarioBatch` with the scenario axis split
    across a data mesh (default: every visible card).

    Full-grid batches are flattened to per-scenario gathers first (the
    same ``flat_views`` the chunked path uses); chunked batches split each
    chunk as it is."""
    if mesh is None:
        mesh = make_data_mesh()
    devices = list(mesh)
    if batch.sel is None:
        batch = dataclasses.replace(batch, sel=np.arange(batch.n_scenarios, dtype=np.int64))
    if len(devices) == 1:
        return make_torch_backend(devices[0])(batch)
    n, k = int(batch.sel.shape[0]), len(devices)
    views = flat_views(batch)
    chips, bits, e_mac, tpc = (_pad_to_multiple(a, k) for a in views[:4])
    summary = {f: _pad_to_multiple(a, k) for f, a in views[4].items()}
    per = chips.shape[0] // k
    parts = []
    with torch.no_grad():
        for i, dev in enumerate(devices):
            sl = slice(i * per, (i + 1) * per)
            cols = _column_exprs(
                _f64(chips[sl], dev), _f64(bits[sl], dev), _f64(e_mac[sl], dev),
                _f64(tpc[sl], dev), {f: _f64(a[sl], dev) for f, a in summary.items()},
                batch.fdm_factor, batch.step_hz, batch.pipeline_eff)
            parts.append(torch.stack([torch.broadcast_to(cols[c], (per,)) for c in COLUMNS])
                         .cpu())
    host = torch.cat(parts, dim=1)[:, :n].numpy()
    return {c: host[i] for i, c in enumerate(COLUMNS)}


def make_sharded_backend(mesh) -> SweepBackend:
    """A ``run_sweep``-compatible backend bound to an explicit data mesh —
    register it, or pass it as ``backend=``, to split over a device list
    (``[cuda:0, cuda:0]`` on a machine with one card, ``[cpu, cpu]``)."""

    def backend(batch: ScenarioBatch) -> Dict[str, np.ndarray]:
        return sharded_torch_backend(batch, mesh=mesh)

    backend.__name__ = "torch-sharded"
    return backend

