"""Mapping cost model: ps/ifm hop energy + cycles of a candidate mapping.

The PyTorch port's own copy of ``repro.search.cost``. The scalar costs stay
NumPy float64 on the host, in the reference's order of operations, so they
equal the JAX package's with ``==``; only :meth:`PopulationEvaluator.columns`
reaches a device, through the port's sweep backends.

Two components, deliberately separated:

* **base** — the committed closed-form energy, *reused* from the evaluation
  stack (``batched_layer_events`` for the ps/ifm link bits at the
  candidate's blocking, ``offchip_values_img`` for the inter-chip values of
  the candidate's placement). For the greedy candidate this is bitwise the
  committed baseline: the same integers ``compile_program`` caches and the
  same float expressions ``DominoModel`` evaluates — asserted ``==`` (not
  allclose) in the tests and gated as fidelity in CI.
* **transit** — the placement-aware extension the closed forms abstract
  away. The closed forms count every partial-sum handoff as ONE link hop,
  i.e. they assume chained tiles are NoC-adjacent. On the serpentine tile
  grid (``space.tile_coords``) that is true of contiguous spans, but the
  committed row-major ``(c_index, m_index)`` block layout interleaves
  M-blocks between the C-blocks of an accumulation chain, so a cross-block
  handoff actually travels ``d > 1`` Manhattan hops when ``m_blocks > 1``.
  ``transit`` charges the *extra* distance, ``(d - 1) ×`` the handoff's
  bits, per chain handoff and per layer-egress→next-ingress edge (inter-
  chip pairs are excluded — the off-chip term owns them). It is exactly
  zero when every counted pair is adjacent; laying each M-chain's C-blocks
  contiguously (``order="chain"``) achieves that, which is the headline
  improvement the search engines find over greedy's committed layout.

The search objective is lexicographic:
``(hop_energy_pj, steady_cycles, fill_cycles, n_tiles)``.

:class:`PopulationEvaluator` scores whole candidate populations: the
scalar costs vectorize the closed forms over a ``(P, L)`` feature matrix,
and the full Tab. IV columns for the same population are evaluated
through the *sweep engine's* backends — the population becomes a chunked
:class:`~repro_torch.sweep.engine.ScenarioBatch` (one summary row per
candidate, ``sel`` selecting the diagonal), so ``backend="torch"`` runs the
same float64 column math on the card that the 1e6-scenario sweeps use.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.core.mapping import ConvSpec
from repro_torch.core.schedule import conv_period
from repro_torch.core.simulator import (
    batched_layer_events,
    layer_table,
    offchip_values_img,
)
from repro_torch.search.space import (
    MappingCandidate,
    candidate_allocs,
    grid_cols,
)


@dataclass(frozen=True)
class MappingCost:
    """One candidate's score. ``hop_energy_pj = base + transit`` where
    ``base = link_pj + offchip_pj`` reuses the committed closed forms."""

    link_pj: float        # ps/ifm bits x link energy (closed forms)
    offchip_pj: float     # inter-chip values x transceiver energy
    transit_pj: float     # placement extra: (d-1)-weighted handoff bits
    steady_cycles: float  # pipeline bottleneck (cycles/img steady state)
    fill_cycles: float    # pipeline fill latency (cycles)
    n_tiles: int
    n_chips: int

    @property
    def base_pj(self) -> float:
        return self.link_pj + self.offchip_pj

    @property
    def hop_energy_pj(self) -> float:
        return self.link_pj + self.offchip_pj + self.transit_pj

    @property
    def objective(self) -> Tuple[float, float, float, int]:
        return (self.hop_energy_pj, self.steady_cycles,
                self.fill_cycles, self.n_tiles)


def _coords_vec(pos: np.ndarray, arch: ArchSpec):
    """Vectorized ``space.tile_coords``: flat positions → (chip, row, col)."""
    chip, local = np.divmod(pos, arch.tiles_per_chip)
    cols = grid_cols(arch)
    row, col = np.divmod(local, cols)
    col = np.where(row % 2 == 1, cols - 1 - col, col)
    return chip, row, col


def _extra_hop_bits(src: np.ndarray, dst: np.ndarray,
                    bits: np.ndarray, arch: ArchSpec) -> float:
    """Σ ``(distance - 1) × bits`` over same-chip position pairs (cross-
    chip pairs contribute 0 here — the off-chip term accounts them)."""
    c0, r0, x0 = _coords_vec(src, arch)
    c1, r1, x1 = _coords_vec(dst, arch)
    d = np.abs(r0 - r1) + np.abs(x0 - x1)
    extra = np.where(c0 == c1, np.maximum(d - 1, 0), 0)
    return float(np.sum(extra * np.asarray(bits, dtype=np.float64)))


def _block_slots(cb: int, mb: int, order: str, rot: int) -> np.ndarray:
    """Block-grid slot of every ``(chain position, m_index)`` pair: the
    ``(cb, mb)`` matrix of layout slots visited in chain order (row 0 is
    the chain's first C-block after rotation)."""
    seq = (rot + np.arange(cb)) % cb          # C-chain visit order
    mi = np.arange(mb)
    if order == "chain":                      # each M-chain contiguous
        return mi[None, :] * cb + seq[:, None]
    return seq[:, None] * mb + mi[None, :]    # committed row-major layout


def _layer_transit_bits(layer, arch: ArchSpec, start: int, grid, order: str,
                        rot: int, block_m: int, next_start: Optional[int]) -> float:
    """Extra (beyond-adjacent) bit-hops of one layer's chain handoffs plus
    its egress→next-ingress edge, per image."""
    k2, cb, mb = grid
    conv = isinstance(layer, ConvSpec)
    px = layer.h_out * layer.w_out if conv else 1
    extra = 0.0
    mi = np.arange(mb)
    m_width = np.minimum((mi + 1) * block_m, layer.c_out) - mi * block_m
    slots = _block_slots(cb, mb, order, rot)
    bpos = start + slots * k2                 # (cb, mb) block start positions
    if cb > 1:
        # cross-block partial-sum handoff: px packets (conv) / 1 (FC) of
        # the M-slice width per chain link — the closed forms' hop counts
        src = bpos[:-1] + (k2 - 1)
        dst = bpos[1:]
        link_bits = (px * m_width * 8)[None, :]
        extra += _extra_hop_bits(src.ravel(), dst.ravel(),
                                 np.broadcast_to(link_bits, src.shape).ravel(),
                                 arch)
    if next_start is not None:
        # whole-layer egress: the OFM leaves from the closing tile of the
        # last M-chain toward the next layer's first (ingress) tile
        egress = int(bpos[-1, -1]) + (k2 - 1)
        ofm_bits = float(px * layer.c_out * 8)
        extra += _extra_hop_bits(np.array([egress]), np.array([next_start]),
                                 np.array([ofm_bits]), arch)
    return extra


def mapping_cost(layers: Sequence, arch: ArchSpec,
                 cand: MappingCandidate) -> MappingCost:
    """Score one candidate. On :func:`~repro_torch.search.space.greedy_candidate`
    the ``link``/``offchip`` components are bitwise the committed baseline
    quantities and ``transit`` reduces to the committed layout's chain-
    handoff extra (zero for single-M-block layers)."""
    layers = tuple(layers)
    allocs, starts = candidate_allocs(layers, arch, cand)
    ev = batched_layer_events(
        layer_table(layers), arch,
        n_c_eff=np.asarray(cand.block_c, dtype=np.int64),
        n_m_eff=np.asarray(cand.block_m, dtype=np.int64),
    )
    scale = arch.energy_scale()
    link_pj = (int(ev["ps_bits"].sum()) + int(ev["ifm_bits"].sum())) \
        * arch.energy.link_pj_per_bit * scale
    offchip_pj = offchip_values_img(list(allocs)) * arch.precision_bits \
        * arch.energy.interchip_pj_per_bit * scale
    transit_bits = 0.0
    for i, (layer, alloc, start) in enumerate(zip(layers, allocs, starts)):
        next_start = int(starts[i + 1]) if i + 1 < len(layers) else None
        transit_bits += _layer_transit_bits(
            layer, arch, int(start), alloc.grid, cand.order[i],
            cand.egress_rot[i], cand.block_m[i], next_start)
    transit_pj = transit_bits * arch.energy.link_pj_per_bit * scale
    steady = float(max(
        (l.h_out * l.w_out for l in layers if isinstance(l, ConvSpec)),
        default=1024,
    ))
    fill = 0.0
    for layer, alloc in zip(layers, allocs):
        if isinstance(layer, ConvSpec):
            fill += conv_period(layer) / 2
        else:
            _, cb, mb = alloc.grid
            fill += cb + mb * 2
    return MappingCost(
        link_pj=float(link_pj),
        offchip_pj=float(offchip_pj),
        transit_pj=float(transit_pj),
        steady_cycles=steady,
        fill_cycles=float(fill),
        n_tiles=int(sum(a.n_tiles for a in allocs)),
        n_chips=int(max(c for a in allocs for c in a.chip_ids) + 1),
    )


@dataclass(frozen=True)
class SearchResult:
    """What :func:`repro_torch.search.search_mapping` returns: the winning
    candidate plus the audit trail the benchmark artifact records."""

    candidate: MappingCandidate
    cost: MappingCost
    greedy_cost: MappingCost
    engine: str
    evaluations: int
    history: Tuple[float, ...]    # best-so-far hop energy per step
    wall_s: float = 0.0

    @property
    def improved(self) -> bool:
        return self.cost.hop_energy_pj < self.greedy_cost.hop_energy_pj

    @property
    def energy_ratio(self) -> float:
        g = self.greedy_cost.hop_energy_pj
        return self.cost.hop_energy_pj / g if g else 1.0


class PopulationEvaluator:
    """Batch-scores candidate populations for the search engines.

    ``costs`` is the scalar objective path (closed forms + transit, NumPy
    float64, deterministic). ``columns`` evaluates the same population's
    full Tab. IV columns through the sweep engine: each candidate becomes
    one summary row of a chunked :class:`ScenarioBatch` (``sel`` walks the
    diagonal of a ``(P, P)`` network×chips grid so per-candidate chip
    counts ride the chips axis), dispatched to a sweep backend: ``"torch"``
    (default) is the float64 column math on the card, ``"numpy"`` the
    oracle on the host, and a callable such as
    ``repro_torch.sweep.make_torch_backend("cpu")`` passes through. The
    JAX package defaults to its ``"jax"`` backend, which the port does not
    have; ``"torch"`` is its counterpart. Resolving the backend touches no
    device: only ``columns`` does, so an evaluator that only scores
    ``costs`` (as the engines do) runs anywhere, and the engines' result
    does not depend on the backend. ``evaluations`` counts every candidate
    scored.

    ``dataflow`` (default ``"com"``) switches the ``columns`` objective to
    a registered rival model (``repro_torch.dataflows``): the rival's
    mapping-independent energy/structure summaries replace each
    candidate's, yielding the rival's reference columns on the same
    geometry — "does the searched COM mapping still beat the rival?" is
    then a direct column comparison. The scalar ``costs`` path (the search
    objective proper) always scores the COM closed forms.
    """

    def __init__(self, layers: Sequence, arch: ArchSpec = DEFAULT_ARCH, *,
                 backend="torch", e_mac_pj: float = 0.1,
                 dataflow: str = "com"):
        self.layers = tuple(layers)
        self.arch = arch
        self.backend_name = backend
        self.e_mac_pj = float(e_mac_pj)
        self.evaluations = 0
        self.dataflow = dataflow
        if dataflow != "com":
            from repro_torch.dataflows import available_dataflows

            if dataflow not in available_dataflows():
                raise ValueError(
                    f"unknown dataflow {dataflow!r}; registered: "
                    f"{list(available_dataflows())}")
        from repro_torch.sweep.engine import _resolve_backend

        self._backend = _resolve_backend(backend)

    def costs(self, cands: Sequence[MappingCandidate]) -> List[MappingCost]:
        self.evaluations += len(cands)
        return [mapping_cost(self.layers, self.arch, c) for c in cands]

    def columns(self, cands: Sequence[MappingCandidate],
                costs: Optional[Sequence[MappingCost]] = None
                ) -> Dict[str, np.ndarray]:
        """Tab. IV columns, one value per candidate, via the sweep backend."""
        from repro_torch.core.simulator import onchip_pj_from_events
        from repro_torch.sweep.engine import SUMMARY_FIELDS, ScenarioBatch

        arch = self.arch
        if costs is None:
            costs = [mapping_cost(self.layers, arch, c) for c in cands]
        P = len(cands)
        t = layer_table(self.layers)
        summary = {f: np.empty((P, 1, 1, 1, 1, 1)) for f in SUMMARY_FIELDS}
        rival_ov = {}
        if self.dataflow != "com":
            # rival models are mapping-independent: one summary override
            # set replaces every candidate's energy/structure fields, so
            # the returned columns are the rival's reference values the
            # searched COM mappings are compared against
            from repro_torch.dataflows import get_dataflow

            rival_ov = get_dataflow(self.dataflow).summary_overrides(
                self.layers, arch)
        chips = np.empty(P)
        skip = any(isinstance(l, ConvSpec) and l.residual_from
                   for l in self.layers)
        for i, (cand, cost) in enumerate(zip(cands, costs)):
            ev = batched_layer_events(
                t, arch,
                n_c_eff=np.asarray(cand.block_c, dtype=np.int64),
                n_m_eff=np.asarray(cand.block_m, dtype=np.int64),
            )
            totals = {f: int(v.sum()) for f, v in ev.items()}
            allocs, _ = candidate_allocs(self.layers, arch, cand)
            vals = dict(
                n_tiles=cost.n_tiles,
                exec_us=(cost.steady_cycles + cost.fill_cycles)
                / arch.step_hz * 1e6,
                onchip_j=float(onchip_pj_from_events(totals, arch)) * 1e-12,
                offchip_values=offchip_values_img(list(allocs)),
                ops=float(sum(l.ops for l in self.layers)),
                bottleneck_px=cost.steady_cycles,
                skip_stall=arch.skip_stall if skip else 1.0,
                area_mm2=cost.n_tiles * arch.tile_area_um2() / 1e6,
                offchip_pj_per_bit=arch.energy.interchip_pj_per_bit
                * arch.energy_scale(),
            )
            vals.update(rival_ov)
            for f in SUMMARY_FIELDS:
                summary[f][i, 0, 0, 0, 0, 0] = vals[f]
            chips[i] = cost.n_chips
        batch = ScenarioBatch(
            shape=(P, P, 1, 1, 1, 1, 1, 1, 1),
            chips=chips,
            bits=np.array([float(arch.precision_bits)]),
            e_mac=np.array([self.e_mac_pj]),
            tpc=np.array([float(arch.tiles_per_chip)]),
            summary=summary,
            fdm_factor=float(arch.fdm_factor),
            step_hz=float(arch.step_hz),
            pipeline_eff=float(arch.pipeline_eff),
            sel=np.arange(P, dtype=np.int64) * (P + 1),  # (i, i, 0, ...) diag
        )
        return self._backend(batch)

    def evaluate(self, cands: Sequence[MappingCandidate]
                 ) -> Tuple[List[MappingCost], Dict[str, np.ndarray]]:
        costs = self.costs(cands)
        return costs, self.columns(cands, costs)


def timed(fn, *args, **kwargs):
    """(result, wall seconds) of one call — shared by the engines."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    return out, time.perf_counter() - t0
