"""Energy/area model (paper Tab. III) + bit/VDD/technology normalization
(paper §IV-A, Stillmaker & Baas [13]) + the Tab. IV counterpart datasheet.

The PyTorch port's own copy of ``repro.core.energy`` (same constants, same
functions, same published numbers).

The per-component numbers live on :class:`repro_torch.core.arch.ArchSpec`
(``DEFAULT_ARCH.energy`` is the Tab. III table at 45nm/1V/8-bit/10MHz); the
module-level constants below are thin **deprecated** aliases kept for the
pre-`ArchSpec` call sites — new code should read fields off an ``ArchSpec``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

from repro_torch.core.arch import (  # noqa: F401  (node_energy_factor re-exported)
    DEFAULT_ARCH,
    node_energy_factor,
)

# ---- Tab. III — deprecated aliases of DEFAULT_ARCH.energy fields ----
_E = DEFAULT_ARCH.energy
RIFM_BUFFER_PJ = _E.rifm_buffer_pj
RIFM_CTRL_PJ = _E.rifm_ctrl_pj
RIFM_AREA = _E.rifm_area_um2

ADDER_PJ_8B = _E.adder_pj_8b
POOL_PJ_8B = _E.pool_pj_8b
ACT_PJ_8B = _E.act_pj_8b
DATA_BUFFER_PJ = _E.data_buffer_pj
SCHED_TABLE_PJ = _E.sched_table_pj
IO_BUFFER_PJ_64B = _E.io_buffer_pj_64b
ROFM_CTRL_PJ = _E.rofm_ctrl_pj
ROFM_AREA = _E.rofm_area_um2

INTERCHIP_PJ_PER_BIT = _E.interchip_pj_per_bit
INTERCHIP_AREA = _E.interchip_area_um2

CIM_AREA_256 = _E.cim_area_um2

STEP_HZ = DEFAULT_ARCH.step_hz
TILE_BW_BPS = DEFAULT_ARCH.tile_bw_bps
PRECISION_BITS = DEFAULT_ARCH.precision_bits
VDD = DEFAULT_ARCH.vdd
NODE_NM = DEFAULT_ARCH.node_nm


def tile_area_um2() -> float:
    """Deprecated alias of ``DEFAULT_ARCH.tile_area_um2()``."""
    return DEFAULT_ARCH.tile_area_um2()


def normalize_energy(e: float, *, node_from: float, node_to: float = 45,
                     v_from: float = 1.0, v_to: float = 1.0) -> float:
    """Scale an energy number between technology corners: E ∝ f(node)·V²."""
    return e * (node_energy_factor(node_to) / node_energy_factor(node_from)) \
             * (v_to ** 2) / (v_from ** 2)


def bit_scale_mac(bw_t: int, ba_t: int, bw_d: int = 8, ba_d: int = 8) -> float:
    """Paper §IV-A: MAC energy scaling factor B_wd·B_ad / (B_wt·B_at)."""
    return (bw_d * ba_d) / (bw_t * ba_t)


def bit_scale_data(ba_t: int, ba_d: int = 8) -> float:
    """Paper §IV-A: scaling for non-MAC ops and data movement."""
    return ba_d / ba_t


def normalize_ce(ce_tops_w: float, *, node: float, vdd: float, bw: int, ba: int) -> float:
    """Normalize a counterpart's CE to 8-bit / 1V / 45nm (Tab. IV footnote 3).

    CE ∝ 1/E: energy per op scales by node/V and by bit-width; both applied.
    """
    e_scale = normalize_energy(1.0, node_from=node, node_to=45, v_from=vdd, v_to=1.0)
    return ce_tops_w / (e_scale * bit_scale_mac(bw, ba))


def normalize_throughput(tp: float, *, node: float, bw: int, ba: int) -> float:
    """Tab. IV footnote 4: throughput/mm² normalized to 8-bit, 45nm.

    Area scales ~node²; ops are bit-normalized.
    """
    area_scale = (45.0 / node) ** 2   # their mm² expressed at 45nm grows
    return tp / bit_scale_mac(bw, ba) * area_scale


# ---- Tab. IV counterpart datasheet (published numbers, verbatim) ----


@dataclass(frozen=True)
class Counterpart:
    key: str
    model: str           # which DNN
    cim: str
    node: float
    vdd: float
    freq_mhz: float
    bits: int            # activation & weight precision
    ce_tops_w: float     # published CE
    thr_tops_mm2: float  # published throughput/mm²
    exec_us: float       # published execution time (n.a. -> 0)
    paper_norm_ce: float     # Tab. IV "Normalized CE" row (for validation)
    paper_norm_thr: float    # Tab. IV "Normalized throughput" row


COUNTERPARTS: Dict[str, Counterpart] = {
    "jia_isscc21": Counterpart("jia_isscc21", "vgg11-cifar", "SRAM", 16, 0.8, 200, 4,
                               71.39, 0.70, 128.0, 9.53, 0.088),
    "yue_isscc20": Counterpart("yue_isscc20", "resnet18-cifar", "SRAM", 65, 1.0, 100, 4,
                               6.91, 0.006, 1890.0, 2.82, 0.013),
    "yoon_isscc21": Counterpart("yoon_isscc21", "vgg16-imagenet", "ReRAM", 40, 0.9, 100, 8,
                                4.15, 0.10, 670e3, 3.92, 0.081),
    "atomlayer": Counterpart("atomlayer", "vgg19-imagenet", "ReRAM", 32, 1.0, 1200, 16,
                             0.68, 0.36, 6920.0, 2.73, 0.18),
    "cascade": Counterpart("cascade", "vgg19-imagenet", "ReRAM", 65, 1.0, 1200, 16,
                           1.96, 0.10, 0.0, 6.18, 0.21),
}

# Paper Tab. IV — Domino ("Ours") columns, for benchmark validation.
PAPER_DOMINO = {
    "jia_isscc21": dict(ce=17.22, thr=0.55, exec_us=137.3, onchip_w=3.53, offchip_w=0.34,
                        chips=5, power_w=11.03),
    "yue_isscc20": dict(ce=6.30, thr=0.17, exec_us=206.3, onchip_w=2.95, offchip_w=0.10,
                        chips=6, power_w=18.10),
    "yoon_isscc21": dict(ce=9.29, thr=0.10, exec_us=3481.8, onchip_w=0.64, offchip_w=0.005,
                         chips=10, power_w=4.26),
    "atomlayer": dict(ce=5.73, thr=0.22, exec_us=3582.9, onchip_w=0.72, offchip_w=0.01,
                      chips=10, power_w=8.73),
    "cascade": dict(ce=10.95, thr=0.66, exec_us=3582.9, onchip_w=0.72, offchip_w=0.01,
                    chips=10, power_w=4.57),
}
