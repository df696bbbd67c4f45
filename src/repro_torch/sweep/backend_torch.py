"""Torch sweep backend: the Tab. IV column math in float64 PyTorch.

The port's counterpart of ``repro.sweep.backend_jax``. The NumPy backend
(``repro_torch.sweep.engine.numpy_backend``) is the golden oracle; this
module evaluates the identical closed forms as float64 tensor expressions
on a device — the card unless the caller names another — over the stacked
scenario arrays of a :class:`~repro_torch.sweep.engine.ScenarioBatch`:

* full grid: the per-axis value arrays and the per-(network, arch)
  summaries go to the device once and broadcast over the 9-axis
  ``batch.shape`` there;
* chunked (``batch.sel``): the batch's views gather the selected rows on
  the host (:func:`flat_views`), and the device sees flat ``(chunk,)``
  arrays only.

Every column comes back to the host as one float64 NumPy array, so a
``run_sweep`` wall clock ends after the copy. FMA contraction and the
device's division may move the last bits against NumPy; the tests and
``chip_smoke.py`` hold every column within 1e-6 of the oracle.

Importing this module registers the backend (the package's ``__init__``
does so), bound to ``device=None``, the card::

    run_sweep(grid)                    # backend="torch" on the card
    run_sweep(grid, device="cpu")      # the same column math on the CPU
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.convert import resolve_device
from repro_torch.sweep.engine import COLUMNS, ScenarioBatch, SweepBackend, register_backend


def _column_exprs(chips, bits, e_mac, tpc, sm, fdm_factor, step_hz,
                  pipeline_eff) -> Dict[str, torch.Tensor]:
    """The Tab. IV column math on broadcast-compatible float64 tensors —
    ``numpy_backend`` expression for expression. ``sm`` maps summary field
    names to tensors; shared by the full-grid and the flat path."""
    n_tiles = sm["n_tiles"]
    onchip_j = sm["onchip_j"]
    ops = sm["ops"]
    area = sm["area_mm2"]

    per_copy = fdm_factor * step_hz / sm["bottleneck_px"]
    copies = torch.clamp_min((chips * tpc) / n_tiles, 1.0)
    img_s = per_copy * copies * pipeline_eff * sm["skip_stall"]

    e_off = sm["offchip_values"] * bits * sm["offchip_pj_per_bit"] * 1e-12
    e_cim = ops * e_mac * 1e-12
    e_total = onchip_j + e_off + e_cim

    return dict(
        exec_us=sm["exec_us"],
        img_s=img_s,
        power_w=e_total * img_s,
        onchip_w=onchip_j * img_s,
        offchip_w=e_off * img_s,
        cim_w=e_cim * img_s,
        ce_tops_w=ops / e_total / 1e12,
        ops=ops,
        area_mm2=area,
        thr_tops_mm2=ops * img_s / 1e12 / area,
        img_s_per_core=img_s / (chips * tpc),
        n_chips=chips,
        n_tiles=n_tiles,
    )


def _f64(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # the batch's views may be broadcast (zero-stride) or read-only; integer
    # axes (chips, bits, tiles per chip) become float64 here, as in NumPy
    return torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64), device=device)


def _columns_full(batch: ScenarioBatch, device: torch.device) -> Dict[str, torch.Tensor]:
    """All Tab. IV columns over the full grid, broadcast on the device."""
    shape = batch.shape

    def ax(values, axis):
        shp = [1] * len(shape)
        shp[axis] = len(values)
        return _f64(values, device).reshape(shp)

    sm = {
        f: _f64(a, device).reshape(
            shape[0], 1, 1, 1, shape[4], shape[5], shape[6], shape[7], shape[8])
        for f, a in batch.summary.items()
    }
    cols = _column_exprs(
        ax(batch.chips, 1), ax(batch.bits, 2), ax(batch.e_mac, 3), ax(batch.tpc, 4), sm,
        batch.fdm_factor, batch.step_hz, batch.pipeline_eff,
    )
    return {c: torch.broadcast_to(v, shape).reshape(-1) for c, v in cols.items()}


def flat_views(batch: ScenarioBatch) -> Tuple[np.ndarray, ...]:
    """The per-scenario flat ``(n,)`` float64 gathers of a chunked batch:
    ``(chips, bits, e_mac, tpc, {field: summary})``, made on the host.
    Requires ``batch.sel``."""
    if batch.sel is None:
        raise ValueError("flat_views needs a chunked batch (batch.sel)")
    return (
        np.asarray(batch.axis_view(batch.chips, 1), dtype=np.float64),
        np.asarray(batch.axis_view(batch.bits, 2), dtype=np.float64),
        np.asarray(batch.axis_view(batch.e_mac, 3), dtype=np.float64),
        np.asarray(batch.axis_view(batch.tpc, 4), dtype=np.float64),
        {f: np.asarray(batch.summary_view(f), dtype=np.float64)
         for f in batch.summary},
    )


def _columns_flat(batch: ScenarioBatch, device: torch.device) -> Dict[str, torch.Tensor]:
    """The same column math over pre-gathered per-scenario ``(n,)`` views —
    the chunked (``ScenarioBatch.sel``) evaluation path."""
    chips, bits, e_mac, tpc, summary = flat_views(batch)
    cols = _column_exprs(
        _f64(chips, device), _f64(bits, device), _f64(e_mac, device), _f64(tpc, device),
        {f: _f64(a, device) for f, a in summary.items()},
        batch.fdm_factor, batch.step_hz, batch.pipeline_eff,
    )
    n = chips.shape[0]
    return {c: torch.broadcast_to(v, (n,)) for c, v in cols.items()}


def make_torch_backend(device=None) -> SweepBackend:
    """A :data:`~repro_torch.sweep.engine.SweepBackend` that evaluates on
    ``device`` (``None``: the card; no card raises when it runs)."""

    def torch_backend(batch: ScenarioBatch) -> Dict[str, np.ndarray]:
        dev = resolve_device(device)
        with torch.no_grad():
            out = (_columns_full if batch.sel is None else _columns_flat)(batch, dev)
            # one copy to the host for all thirteen columns
            host = torch.stack([out[c] for c in COLUMNS]).cpu().numpy()
        return {c: host[i] for i, c in enumerate(COLUMNS)}

    torch_backend.__name__ = "torch"
    return torch_backend


register_backend("torch", make_torch_backend())
