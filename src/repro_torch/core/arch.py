"""`ArchSpec` — the explicit, hashable hardware description of a Domino chip.

The PyTorch port's own copy of ``repro.core.arch`` (same fields, same
defaults, same numbers), kept so that ``repro_torch`` imports nothing of
the JAX package.

Every architecture knob the evaluation stack depends on lives here as a
field of one frozen dataclass: CIM array geometry (``n_c`` x ``n_m``),
tiles per chip, clocks, pipeline efficiency factors, technology node, and
the Tab. III per-component energy/area table. ``DEFAULT_ARCH`` reproduces
the paper's evaluation setup.

Because ``ArchSpec`` is frozen and hashable it is a cache key: the compile
and event-count caches are keyed on ``(layers, arch)``.

Energies in the table are per access/operation at 45nm / 1V / 8-bit /
10MHz instruction step (Tab. III); ``energy_scale()`` gives the
Stillmaker-Baas dynamic-energy factor that rescales them to the spec's
``node_nm``/``vdd`` corner (exactly 1.0 at the 45nm/1V baseline).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import List

# ---- Stillmaker-Baas energy scaling (normalized to 45nm) ----
# Relative dynamic energy per op vs node (fit to [13] Tab. 6 trends).
_NODE_ENERGY = {
    180: 10.8, 130: 5.8, 90: 3.22, 65: 1.93, 45: 1.0, 40: 0.88, 32: 0.60,
    28: 0.52, 22: 0.38, 20: 0.35, 16: 0.28, 14: 0.25, 10: 0.18, 7: 0.12,
}


def node_energy_factor(node_nm: float) -> float:
    """Relative dynamic energy per operation at ``node_nm`` (nm),
    normalized to 1.0 at 45nm (dimensionless; Stillmaker–Baas [13] scaling
    the paper's §IV-A bit/technology normalization uses). Linear
    interpolation between the tabulated nodes; clamped outside the table.
    Multiply a Tab. III 45nm energy by this (and VDD²) to move corners."""
    nodes = sorted(_NODE_ENERGY)
    if node_nm in _NODE_ENERGY:
        return _NODE_ENERGY[node_nm]
    lo = max([n for n in nodes if n <= node_nm], default=nodes[0])
    hi = min([n for n in nodes if n >= node_nm], default=nodes[-1])
    if lo == hi:
        return _NODE_ENERGY[lo]
    t = (node_nm - lo) / (hi - lo)
    return _NODE_ENERGY[lo] * (1 - t) + _NODE_ENERGY[hi] * t


@dataclass(frozen=True)
class EnergyTable:
    """Tab. III per-component energies (pJ, at 45nm/1V/8-bit) and areas
    (um²). One value object so an ``ArchSpec`` stays a flat, hashable key."""

    rifm_buffer_pj: float = 281.3      # 256B RIFM buffer access
    rifm_ctrl_pj: float = 10.4
    adder_pj_8b: float = 0.02          # 8b x 8 x 2 adders: per 8b add
    pool_pj_8b: float = 0.0077         # 7.7 fJ / 8b
    act_pj_8b: float = 0.0009          # 0.9 fJ / 8b
    data_buffer_pj: float = 281.3      # 16KiB ROFM data buffer access
    sched_table_pj: float = 2.2        # per 16b read
    io_buffer_pj_64b: float = 42.1     # input/output buffer per 64b access
    rofm_ctrl_pj: float = 28.5
    interchip_pj_per_bit: float = 0.55  # 80Gbps x 8 transceivers
    link_pj_per_bit: float = 0.30      # NoC wire+register+crossbar per bit-hop
    rifm_area_um2: float = 2227.1
    rofm_area_um2: float = 57972.7
    cim_area_um2: float = 0.026e6      # CIM array at the 256x256 reference
    interchip_area_um2: float = 8e5


# the geometry EnergyTable.cim_area_um2 is quoted at (Tab. III estimate)
_CIM_AREA_REF_CELLS = 256 * 256


@dataclass(frozen=True)
class ArchSpec:
    """Frozen, hashable Domino architecture description.

    ``n_c`` / ``n_m``      — CIM array rows / columns per tile.
    ``tiles_per_chip``     — tiles on one chip (240 in the paper).
    ``step_hz``            — instruction step frequency.
    ``fdm_factor``         — frequency-division packet lanes per step
                             (160MHz peripheral clock / 10MHz step = 16).
    ``pipeline_eff``       — layer rate-mismatch stall factor.
    ``skip_stall``         — residual-join synchronization stall factor.
    ``precision_bits``     — activation/weight bit-width.
    ``node_nm`` / ``vdd``  — technology corner; per-component energies are
                             rescaled from the 45nm/1V table by
                             :meth:`energy_scale`.
    ``tile_bw_bps``        — inter-tile link bandwidth.
    ``energy``             — the Tab. III component energy/area table.
    """

    n_c: int = 256
    n_m: int = 256
    tiles_per_chip: int = 240
    step_hz: float = 10e6
    fdm_factor: int = 16
    pipeline_eff: float = 0.60
    skip_stall: float = 0.25
    precision_bits: int = 8
    node_nm: float = 45.0
    vdd: float = 1.0
    tile_bw_bps: float = 40e9
    energy: EnergyTable = EnergyTable()

    def __post_init__(self):
        problems: List[str] = []
        for name in ("n_c", "n_m", "tiles_per_chip", "fdm_factor"):
            v = getattr(self, name)
            if isinstance(v, bool) or not isinstance(v, int):
                problems.append(f"{name} must be an int, got {v!r}")
            elif v < 1:
                problems.append(f"{name} must be >= 1, got {v}")
        for name in ("step_hz", "node_nm", "vdd", "tile_bw_bps"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not math.isfinite(v) or v <= 0:
                problems.append(f"{name} must be a finite number > 0, got {v!r}")
        for name in ("pipeline_eff", "skip_stall"):
            v = getattr(self, name)
            if not isinstance(v, (int, float)) or isinstance(v, bool) \
                    or not 0 < v <= 1:
                problems.append(f"{name} must be in (0, 1], got {v!r}")
        if isinstance(self.precision_bits, bool) \
                or not isinstance(self.precision_bits, int) \
                or self.precision_bits < 1:
            problems.append(
                f"precision_bits must be an int >= 1, got {self.precision_bits!r}"
            )
        if problems:
            raise ValueError("invalid ArchSpec:\n" + "\n".join(problems))

    # ---- derived quantities ----
    def block_partition(self, c_in: int, c_out: int) -> "tuple[int, int]":
        """A layer's CIM block grid: ``(ceil(c_in/n_c), ceil(c_out/n_m))``.

        The single source of the C/M block-partition arithmetic — the
        mapping (``tiles_for``), the Workload→CompiledProgram compiler
        (``repro_torch.core.program``), and the event closed forms all
        agree on this grid. A layer with ``c_in > n_c`` needs a chain of
        ``c_blocks`` accumulating block groups; ``c_out > n_m`` needs
        ``m_blocks`` parallel output slices.
        """
        return -(-int(c_in) // self.n_c), -(-int(c_out) // self.n_m)

    def tile_area_um2(self) -> float:
        """Per-tile silicon area. The CIM array scales with the cell count
        (``n_c x n_m`` over the 256x256 the table quotes — exactly x1.0 at
        the default geometry, keeping DEFAULT_ARCH bitwise); the RIFM/ROFM
        peripherals are per-tile fixtures."""
        e = self.energy
        cim = e.cim_area_um2 * (self.n_c * self.n_m) / _CIM_AREA_REF_CELLS
        return e.rifm_area_um2 + e.rofm_area_um2 + cim

    def energy_scale(self) -> float:
        """Dynamic-energy factor vs the 45nm/1V table: f(node)/f(45) · V²
        (Stillmaker-Baas). Exactly 1.0 at the default corner so
        ``DEFAULT_ARCH`` results are bitwise those of the constant era."""
        return (node_energy_factor(self.node_nm) / node_energy_factor(45.0)) \
            * self.vdd ** 2

    def replace(self, **changes) -> "ArchSpec":
        """Functional update (``dataclasses.replace``); validation reruns."""
        return dataclasses.replace(self, **changes)


DEFAULT_ARCH = ArchSpec()
