"""The COM (computing-on-the-move) dataflow as a registered ``DataflowModel``.

The PyTorch port's own copy of ``repro.dataflows.com``.

This is the source paper's dataflow (arxiv 2111.11744) — the model the rest
of the repo evaluates natively. Registering it is deliberately a *thin
adapter*: traffic counts come verbatim from
``repro_torch.core.simulator.batched_layer_events``, on-chip energy from
``onchip_pj_from_events`` over the compiled program's cached event totals,
and off-chip values from the compiled greedy placement — the exact floats
``DominoModel``/``NetworkSummary`` already produce, asserted ``==`` (not
allclose) by the bitwise anchor tests. Its :meth:`summary_overrides` is
empty, so the sweep engine's ``dataflow="com"`` column runs the pre-registry
code path untouched.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from repro_torch.core.arch import ArchSpec
from repro_torch.core.program import Workload, compile_program
from repro_torch.core.simulator import (
    EVENT_FIELDS,
    batched_layer_events,
    layer_table,
    offchip_values_img,
    onchip_pj_from_events,
)
from repro_torch.dataflows.base import DataflowModel, register_dataflow


class COMDataflow(DataflowModel):
    """The paper's localized dataflow: IFM rows stream tile-to-tile over
    1-hop NoC links, partial/group sums accumulate on the move through
    ROFM adders and bounded group-sum queues — no shared global buffer on
    the inner loop. Traffic components are the COM event fields
    (``ps_bits``, ``ifm_hops``, ``buf_push`` ...)."""

    name = "com"
    cite = "arxiv 2111.11744 (Domino: COM NoC dataflow)"
    TRAFFIC_FIELDS: Tuple[str, ...] = EVENT_FIELDS

    def _program(self, layers: Tuple, arch: ArchSpec):
        # the shared compile cache line (same key DominoModel reads)
        return compile_program(Workload.of(layers), arch)

    def layer_traffic(self, layers: Tuple, arch: ArchSpec
                      ) -> Dict[str, np.ndarray]:
        ev = batched_layer_events(layer_table(tuple(layers)), arch)
        return {f: np.asarray(ev[f], dtype=np.float64) for f in EVENT_FIELDS}

    def energy_breakdown_img_j(self, layers: Tuple, arch: ArchSpec
                               ) -> Dict[str, float]:
        """Tab. III pricing, decomposed by component (the grouped terms of
        ``onchip_pj_from_events``)."""
        t = self._program(tuple(layers), arch).event_totals
        en = arch.energy
        j = arch.energy_scale() * 1e-12
        return dict(
            ps_link=t["ps_bits"] * en.link_pj_per_bit * j,
            adders=t["adds"] * arch.n_m * en.adder_pj_8b * j,
            ctrl=(t["ps_hops"] + t["ifm_hops"])
            * (en.rofm_ctrl_pj + en.rifm_ctrl_pj + en.sched_table_pj) * j,
            ifm_link=t["ifm_bits"] * en.link_pj_per_bit * j,
            rifm_buffer=(t["ifm_hops"] / 3.0) * en.rifm_buffer_pj * j,
            groupsum_buffer=(t["buf_push"] + t["buf_pop"])
            * en.data_buffer_pj * j,
            act=t["act"] * arch.n_m * en.act_pj_8b * j,
            pool=t["pool_cmp"] * arch.n_m * en.pool_pj_8b * j,
        )

    def onchip_energy_img_j(self, layers, arch=None) -> float:
        # NOT the breakdown sum: the exact chained expression of
        # onchip_pj_from_events, so the value is bitwise DominoModel's
        from repro_torch.core.arch import DEFAULT_ARCH

        arch = DEFAULT_ARCH if arch is None else arch
        program = self._program(tuple(layers), arch)
        return float(onchip_pj_from_events(program.event_totals, arch)) * 1e-12

    def offchip_values_img(self, layers: Tuple, arch: ArchSpec) -> float:
        return offchip_values_img(list(self._program(tuple(layers), arch).allocs))

    def movement_energy_img_j(self, layers, arch=None) -> float:
        """Data movement only: ps/ifm link bits + off-chip transfer."""
        from repro_torch.core.arch import DEFAULT_ARCH

        arch = DEFAULT_ARCH if arch is None else arch
        layers = tuple(layers)
        ev = batched_layer_events(layer_table(layers), arch)
        scale = arch.energy_scale()
        link_pj = (int(ev["ps_bits"].sum()) + int(ev["ifm_bits"].sum())) \
            * arch.energy.link_pj_per_bit * scale
        return link_pj * 1e-12 \
            + self.offchip_energy_img_j(layers, arch)

    def n_arrays(self, layers: Tuple, arch: ArchSpec) -> int:
        return int(self._program(tuple(layers), arch).n_tiles)

    def _overrides_uncached(self, layers: Tuple, arch: ArchSpec):
        # empty ON PURPOSE: the sweep engine's native summary already IS
        # this model — overriding nothing keeps the com column bitwise
        return ()


register_dataflow(COMDataflow())
