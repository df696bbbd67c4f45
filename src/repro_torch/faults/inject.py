"""Execution-level fault realization: faulted weights, once, for every
backend.

The PyTorch port's own copy of ``repro.faults.inject``. The executor's two
backends (the float64 ``"reference"`` block chains and the CUDA
``com_matmul`` chain) both start from one float64 NumPy weight list.
Fault injection happens there, once, on the host, in deterministic NumPy
(the cell field's ``default_rng`` draw has no torch counterpart), before
the list moves to the device — both backends then read byte-identical
faulted arrays, which is what makes accuracy-vs-fault-rate curves agree across
backends bitwise at the fault-mask level (the contract the benchmark
records as ``mask_checksum``).

Three corruption mechanisms (see :mod:`repro_torch.faults.model`):

* explicit ``WeightFault`` cells — ``stuck0`` (cell reads 0),
  ``stuck1`` (cell saturates at the layer's max magnitude, signed), and
  ``flip`` (sign bit-flip);
* a seeded random cell-fault field (``cell_rate``/``cell_seed``) expanded
  per layer with ``default_rng(SeedSequence([cell_seed, layer_index]))``
  — fixed draw order, so the mask is a pure function of (seed, rate,
  layer shapes) and reproduces across machines;
* ``BlockFault`` logical-tile dropout — the weight slice a block's tile
  holds (kernel pixel × C-block × M-block under the committed greedy
  blocking) reads zero, the whole-array analogue of a dead CIM macro.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np

from repro_torch.core.arch import ArchSpec

from repro_torch.faults.model import CELL_KINDS, FaultSet


def _weight_shape(layer) -> Tuple[int, ...]:
    from repro_torch.core.mapping import ConvSpec

    if isinstance(layer, ConvSpec):
        return (layer.k, layer.k, layer.c_in, layer.c_out)
    return (layer.c_in, layer.c_out)


def _corrupt_cells(flat: np.ndarray, idx: np.ndarray,
                   kinds: np.ndarray) -> None:
    """Apply cell faults in place on the flattened layer weights. The
    ``stuck1`` magnitude is the layer's pre-fault max |w| (the cell's
    full-scale conductance), signed like the stored value (0 -> +max)."""
    if idx.size == 0:
        return
    full = float(np.abs(flat).max()) if flat.size else 0.0
    vals = flat[idx]
    for k, kind in enumerate(CELL_KINDS):
        sel = kinds == k
        if not np.any(sel):
            continue
        if kind == "stuck0":
            vals[sel] = 0.0
        elif kind == "stuck1":
            s = np.sign(vals[sel])
            vals[sel] = np.where(s == 0, 1.0, s) * full
        else:  # flip: sign bit-flip
            vals[sel] = -vals[sel]
    flat[idx] = vals


def _block_ranges(layer, arch: ArchSpec, c_index: int,
                  m_index: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Channel ranges of one ``(c_index, m_index)`` block under the
    committed greedy blocking (``arch.n_c``/``arch.n_m`` slices)."""
    cs = c_index * arch.n_c
    ms = m_index * arch.n_m
    return ((cs, min(cs + arch.n_c, layer.c_in)),
            (ms, min(ms + arch.n_m, layer.c_out)))


def apply_weight_faults(layers: Sequence, weights: List[np.ndarray],
                        faults: FaultSet,
                        arch: ArchSpec) -> Tuple[List[np.ndarray], Dict]:
    """Realize a FaultSet's workload faults on resolved float64 weights.

    Returns ``(faulted_weights, info)`` — fresh arrays (inputs untouched)
    and the deterministic fault-mask summary the benchmark fingerprints:
    ``n_cells`` / ``n_blocks`` faulted and ``mask_checksum`` =
    ``sum(|faulted - clean|)`` in float64. Raises ``ValueError`` on
    out-of-range fault coordinates (a fault description that silently
    misses its target would fake resilience).

    ``weights`` may be the executor's resolved per-layer list or a
    name-keyed mapping as :func:`repro_torch.core.executor.random_weights`
    returns.
    """
    from repro_torch.core.mapping import ConvSpec, tiles_for

    if isinstance(weights, Mapping):
        weights = [weights[l.name] for l in layers]
    out = [np.array(w, dtype=np.float64, copy=True) for w in weights]
    n_cells = 0
    n_blocks = 0

    # --- explicit cells, grouped per layer ---
    per_layer: Dict[int, List] = {}
    for wf in faults.weight_faults:
        if wf.layer >= len(layers):
            raise ValueError(
                f"weight fault targets layer {wf.layer} but the workload "
                f"has {len(layers)} layers")
        per_layer.setdefault(wf.layer, []).append(wf)
    for li, wfs in per_layer.items():
        flat = out[li].reshape(-1)
        idx = np.array([wf.index for wf in wfs], dtype=np.int64)
        if int(idx.max()) >= flat.size:
            bad = max(wfs, key=lambda wf: wf.index)
            raise ValueError(
                f"weight fault index {bad.index} out of range for layer "
                f"{getattr(layers[li], 'name', li)!r} "
                f"({flat.size} cells)")
        kinds = np.array([CELL_KINDS.index(wf.kind) for wf in wfs],
                         dtype=np.int64)
        _corrupt_cells(flat, idx, kinds)
        n_cells += len(wfs)

    # --- seeded random cell field (nested-monotone like the fabric) ---
    if faults.cell_rate > 0.0:
        for li, w in enumerate(out):
            flat = w.reshape(-1)
            rng = np.random.default_rng(
                np.random.SeedSequence([faults.cell_seed, li]))
            u = rng.random(flat.size)
            idx = np.flatnonzero(u < faults.cell_rate)
            # kind cycles with the faulted cell's rank: deterministic and
            # independent of the rate (no extra draws to keep nesting)
            kinds = np.arange(idx.size, dtype=np.int64) % len(CELL_KINDS)
            _corrupt_cells(flat, idx, kinds)
            n_cells += int(idx.size)

    # --- logical-tile dropout ---
    for bf in faults.dead_blocks:
        if bf.layer >= len(layers):
            raise ValueError(
                f"block fault targets layer {bf.layer} but the workload "
                f"has {len(layers)} layers")
        layer = layers[bf.layer]
        _, (k2, cb, mb) = tiles_for(layer, arch)
        if bf.k_index >= k2 or bf.c_index >= cb or bf.m_index >= mb:
            raise ValueError(
                f"block fault ({bf.k_index}, {bf.c_index}, {bf.m_index}) "
                f"outside layer {getattr(layer, 'name', bf.layer)!r}'s "
                f"block grid ({k2}, {cb}, {mb})")
        (cs, ce), (ms, me) = _block_ranges(layer, arch, bf.c_index,
                                           bf.m_index)
        if isinstance(layer, ConvSpec):
            kr, kc = divmod(bf.k_index, layer.k)
            out[bf.layer][kr, kc, cs:ce, ms:me] = 0.0
        else:
            out[bf.layer][cs:ce, ms:me] = 0.0
        n_blocks += 1

    checksum = float(sum(np.abs(f - c).sum()
                         for f, c in zip(out, (np.asarray(w, dtype=np.float64)
                                               for w in weights))))
    return out, dict(n_cells=n_cells, n_blocks=n_blocks,
                     mask_checksum=checksum)
