"""The minimal-buffer-traffic CIM dataflow (Song & Jeong, arxiv 2508.14375).

The PyTorch port's own copy of ``repro.dataflows.minimal_buffer``.

The published rival: a conventional CIM accelerator organization — weights
resident in crossbar arrays, activations staged in one shared **global
buffer** per chip — scheduled so buffer traffic is *minimal*: every IFM
value is fetched from the buffer exactly once per layer (perfect on-array
window reuse), every OFM value written back exactly once, and partial sums
forward array-to-array without a buffer round trip. That is the strongest
reasonable version of the buffer-centric dataflow, which is what makes the
head-to-head against COM meaningful: COM must beat the rival's *floor*,
not a strawman.

Closed forms (per image, per layer; ``cb×mb`` is the rival's own im2col
block grid — a conv unrolls ``K²·C_in`` rows, unlike COM's kernel-pixel
tile unrolling):

==============  ============================================================
``buf_rd``      IFM values read from the global buffer once:
                ``h_in·w_in·c_in`` (conv) / ``c_in`` (FC)
``buf_wr``      OFM values written back once: ``px·c_out`` / ``c_out``
``bus_vals``    values on the buffer↔array interconnect:
                ``buf_rd·mb + buf_wr`` (IFM multicast per M-block column)
``xfer_psum``   array-to-array partial-sum forwards: ``ofm·(cb−1)``
``acts``        activation firings: one per OFM value
==============  ============================================================

Pricing reuses the shared Tab. III ``EnergyTable`` on the same silicon:

* the global buffer is built from the same SRAM macro class as Domino's
  16KiB/256B tile buffers (``data_buffer_pj`` per 64-value line) but is
  chip-sized — one tile-buffer-equivalent per tile consolidated — so the
  per-access energy is scaled by ``tiles_per_chip**0.5`` (the classic
  ~sqrt(capacity) SRAM access-energy growth; ``GLOBAL_BUFFER_CAPACITY_EXP``
  documents the exponent as a modeling knob);
* buffer↔array transfers traverse the chip interconnect: a mean distance of
  half the tile-grid side, ``0.5·sqrt(tiles_per_chip)`` hops, at the NoC
  ``link_pj_per_bit`` — versus COM's locality invariant of 1 hop;
* partial-sum forwards are adjacent (1 hop) plus one ROFM-class 8b add;
* on-chip value widths use the 8-bit convention of the COM event forms
  (the sweep's precision axis prices off-chip traffic only, both models
  alike).

Not modeled (both knowingly in the rival's favor): pooling/residual
re-reads, buffer capacity misses (traffic is the published *minimum*), and
global-buffer area. Off-chip traffic uses the same greedy sequential
packing and chip-crossing rule as COM (``offchip_values_img``) over the
rival's own (smaller) array count.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.arch import ArchSpec
from repro_torch.core.mapping import ConvSpec, TileAlloc
from repro_torch.core.simulator import offchip_values_img
from repro_torch.dataflows.base import DataflowModel, register_dataflow

# Global-buffer access energy grows ~capacity**this vs the tile-sized
# reference macro (CACTI-class trend; 0.5 = sqrt scaling).
GLOBAL_BUFFER_CAPACITY_EXP = 0.5

# One 64-value (64B at 8-bit) line per data_buffer_pj access, matching the
# Tab. III accounting convention of the reference macro.
_BUFFER_LINE_VALUES = 64


def global_buffer_pj_per_value(arch: ArchSpec) -> float:
    """Global-buffer energy per 8b value: the tile SRAM macro's per-line
    energy, amortized per value, scaled to chip-sized capacity."""
    return (arch.energy.data_buffer_pj / _BUFFER_LINE_VALUES) \
        * arch.tiles_per_chip ** GLOBAL_BUFFER_CAPACITY_EXP


def mean_bus_hops(arch: ArchSpec) -> float:
    """Mean buffer↔array NoC distance: half the tile-grid side."""
    return 0.5 * math.sqrt(arch.tiles_per_chip)


def _layer_grid(layer, arch: ArchSpec) -> Tuple[int, int]:
    """The rival's im2col block grid ``(cb, mb)``: a conv unrolls its
    ``K²·C_in`` operand rows down the crossbar, so ``cb =
    ceil(K²·C_in/n_c)`` (K² fewer arrays than COM's kernel-pixel tiles,
    each read K² times as often — the density-vs-locality trade)."""
    if isinstance(layer, ConvSpec):
        rows = layer.k * layer.k * layer.c_in
    else:
        rows = layer.c_in
    return -(-rows // arch.n_c), -(-layer.c_out // arch.n_m)


def _layer_counts(layer, arch: ArchSpec) -> Dict[str, float]:
    cb, mb = _layer_grid(layer, arch)
    if isinstance(layer, ConvSpec):
        ifm_vals = layer.h_in * layer.w_in * layer.c_in
        ofm_vals = layer.h_out * layer.w_out * layer.c_out
    else:
        ifm_vals = layer.c_in
        ofm_vals = layer.c_out
    return dict(
        buf_rd=float(ifm_vals),
        buf_wr=float(ofm_vals),
        bus_vals=float(ifm_vals * mb + ofm_vals),
        xfer_psum=float(ofm_vals * (cb - 1)),
        acts=float(ofm_vals),
    )


class MinimalBufferDataflow(DataflowModel):
    """Minimal-buffer-traffic CIM dataflow on Domino silicon."""

    name = "minimal_buffer"
    cite = "arxiv 2508.14375 (minimal buffer-traffic CIM dataflow)"
    TRAFFIC_FIELDS: Tuple[str, ...] = (
        "buf_rd", "buf_wr", "bus_vals", "xfer_psum", "acts",
    )

    def layer_traffic(self, layers: Tuple, arch: ArchSpec
                      ) -> Dict[str, np.ndarray]:
        rows = [_layer_counts(l, arch) for l in layers]
        return {
            f: np.array([r[f] for r in rows], dtype=np.float64)
            for f in self.TRAFFIC_FIELDS
        }

    def energy_breakdown_img_j(self, layers: Tuple, arch: ArchSpec
                               ) -> Dict[str, float]:
        t = self.traffic_totals(tuple(layers), arch)
        en = arch.energy
        j = arch.energy_scale() * 1e-12
        bus_bit_hops = t["bus_vals"] * mean_bus_hops(arch) * 8.0
        return dict(
            global_buffer=(t["buf_rd"] + t["buf_wr"])
            * global_buffer_pj_per_value(arch) * j,
            bus_link=bus_bit_hops * en.link_pj_per_bit * j,
            psum_link=t["xfer_psum"] * 8.0 * en.link_pj_per_bit * j,
            psum_add=t["xfer_psum"] * en.adder_pj_8b * j,
            act=t["acts"] * en.act_pj_8b * j,
        )

    def movement_energy_img_j(self, layers, arch=None) -> float:
        """Data movement only: buffer accesses + bus/psum link traversal +
        off-chip transfer (``psum_add``/``act`` are compute, excluded —
        same convention as the COM model's link+offchip headline)."""
        from repro_torch.core.arch import DEFAULT_ARCH

        arch = DEFAULT_ARCH if arch is None else arch
        layers = tuple(layers)
        b = self.energy_breakdown_img_j(layers, arch)
        return b["global_buffer"] + b["bus_link"] + b["psum_link"] \
            + self.offchip_energy_img_j(layers, arch)

    def _allocs(self, layers: Tuple, arch: ArchSpec) -> List[TileAlloc]:
        """Greedy sequential packing of the rival's arrays onto chips —
        the same walk as ``greedy_place`` so the shared chip-crossing rule
        (``offchip_values_img``) applies to both dataflows identically."""
        allocs: List[TileAlloc] = []
        chip, used = 0, 0
        for layer in layers:
            cb, mb = _layer_grid(layer, arch)
            n = cb * mb
            chips: List[int] = []
            left = n
            start_chip = chip
            while left > 0:
                take = min(left, arch.tiles_per_chip - used)
                if take == 0:
                    chip += 1
                    used = 0
                    continue
                chips.append(chip)
                used += take
                left -= take
            allocs.append(TileAlloc(
                layer=layer, n_tiles=n, grid=(1, cb, mb),
                chip_ids=tuple(chips),
                crosses_chip=len(set(chips)) > 1 or chips[0] != start_chip,
            ))
        return allocs

    def offchip_values_img(self, layers: Tuple, arch: ArchSpec) -> float:
        return offchip_values_img(self._allocs(tuple(layers), arch))

    def n_arrays(self, layers: Tuple, arch: ArchSpec) -> int:
        return int(sum(a.n_tiles for a in self._allocs(tuple(layers), arch)))


register_dataflow(MinimalBufferDataflow())
