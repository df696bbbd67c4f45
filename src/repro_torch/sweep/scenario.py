"""Validation-first sweep scenario schema (the SNIPPETS "FastSim" idiom).

The PyTorch port's own copy of ``repro.sweep.scenario``: the same axes,
checks and messages.

A ``SweepGrid`` is the single, self-contained contract for a design-space
sweep: which networks, how many chips, at what precision, which substituted
CIM-array energy points — and, since the `ArchSpec` redesign, which
*architectures*: tiles per chip, CIM array geometry (``n_c`` x ``n_m``),
and technology node are first-class grid axes. Every grid is rigorously
validated at construction — a controlled vocabulary (``Precision`` enum,
the network registry) plus explicit bounds checks guarantee the engine only
ever runs on well-formed input, and malformed grids are rejected upfront
with actionable errors that name the offending value.
"""
from __future__ import annotations

import math
from dataclasses import asdict, dataclass, field
from enum import IntEnum
from itertools import product
from typing import Dict, List, Sequence, Tuple

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.sweep.registry import available_networks


class SweepValidationError(ValueError):
    """A sweep grid (or scenario) failed schema validation. The message
    lists every problem found, one per line, with the offending value."""


class Precision(IntEnum):
    """Activation/weight bit-widths the energy model understands
    (paper §IV-A bit normalization)."""

    INT4 = 4
    INT8 = 8
    INT16 = 16


# Grid axes, in cross-product (row-major) order: the original four, then the
# ArchSpec axes, then the dataflow axis — each generation appended last so
# older grids keep their scenario order (and, at the default single-value
# tail axes, their exact flat indices).
AXES: Tuple[str, ...] = (
    "networks", "chip_counts", "precisions", "e_mac_pj",
    "tiles_per_chip", "n_c", "n_m", "node_nm", "dataflow",
)


@dataclass(frozen=True)
class Scenario:
    """One evaluation point: network x chip count x precision x CIM energy
    x architecture (tiles/chip, array geometry, technology node) x
    dataflow model."""

    network: str
    n_chips: int
    precision_bits: int
    e_mac_pj: float
    tiles_per_chip: int = DEFAULT_ARCH.tiles_per_chip
    n_c: int = DEFAULT_ARCH.n_c
    n_m: int = DEFAULT_ARCH.n_m
    node_nm: float = DEFAULT_ARCH.node_nm
    dataflow: str = "com"

    def arch(self, base: ArchSpec = DEFAULT_ARCH) -> ArchSpec:
        """The ``ArchSpec`` this scenario evaluates: ``base`` with the
        scenario's architecture axes (and precision) substituted in."""
        return base.replace(
            tiles_per_chip=self.tiles_per_chip, n_c=self.n_c, n_m=self.n_m,
            node_nm=self.node_nm, precision_bits=self.precision_bits,
        )

    def as_dict(self) -> Dict:
        """All nine scenario parameters as a plain dict (the per-row
        params half of ``SweepResult.rows()``)."""
        return asdict(self)


def _check_network(name, problems: List[str]) -> None:
    known = available_networks()
    if not isinstance(name, str):
        problems.append(f"network {name!r} must be a string (one of {list(known)})")
    elif name not in known:
        problems.append(f"unknown network {name!r}; known networks: {list(known)}")


def _check_chips(c, problems: List[str]) -> None:
    if isinstance(c, bool) or not isinstance(c, int):
        problems.append(f"chip count {c!r} must be an int (got {type(c).__name__})")
    elif c < 1:
        problems.append(f"chip count {c} must be >= 1")


def _check_precision(p, problems: List[str]) -> None:
    valid = [int(v) for v in Precision]
    if isinstance(p, bool) or not isinstance(p, int):
        problems.append(f"precision {p!r} must be an int, one of {valid}")
    elif p not in valid:
        problems.append(f"precision {p} bits is not supported; choose one of {valid}")


def _check_e_mac(e, problems: List[str]) -> None:
    if not isinstance(e, (int, float)) or isinstance(e, bool):
        problems.append(f"e_mac_pj {e!r} must be a number (pJ per 8b OP)")
    elif not math.isfinite(e):
        problems.append(f"e_mac_pj {e!r} must be finite")
    elif e <= 0:
        problems.append(f"e_mac_pj {e} must be > 0 (energy per CIM OP, pJ)")


def _check_pos_int(v, label: str, problems: List[str]) -> None:
    if isinstance(v, bool) or not isinstance(v, int):
        problems.append(f"{label} {v!r} must be an int (got {type(v).__name__})")
    elif v < 1:
        problems.append(f"{label} {v} must be >= 1")


def _check_node(n, problems: List[str]) -> None:
    if not isinstance(n, (int, float)) or isinstance(n, bool):
        problems.append(f"node_nm {n!r} must be a number (nm)")
    elif not math.isfinite(n) or not 1 <= n <= 250:
        problems.append(
            f"node_nm {n!r} must be a finite technology node in [1, 250] nm"
        )


def _check_dataflow(v, problems: List[str]) -> None:
    # lazy import: the dataflow registry pulls in the model modules, and
    # plain COM-only grids shouldn't pay (or depend on) that
    from repro_torch.dataflows import available_dataflows

    known = available_dataflows()
    if not isinstance(v, str):
        problems.append(
            f"dataflow {v!r} must be a string (one of {list(known)})")
    elif v not in known:
        problems.append(
            f"unknown dataflow {v!r}; registered models: {list(known)}")


_AXIS_CHECKS = {
    "networks": _check_network,
    "chip_counts": _check_chips,
    "precisions": _check_precision,
    "e_mac_pj": _check_e_mac,
    "tiles_per_chip": lambda v, p: _check_pos_int(v, "tiles_per_chip", p),
    "n_c": lambda v, p: _check_pos_int(v, "n_c (CIM rows)", p),
    "n_m": lambda v, p: _check_pos_int(v, "n_m (CIM cols)", p),
    "node_nm": _check_node,
    "dataflow": _check_dataflow,
}


def _unique(seq: Sequence, label: str, problems: List[str]) -> None:
    seen = set()
    for v in seq:
        try:
            dup = v in seen
        except TypeError:
            return  # unhashable entries already reported by the type checks
        if dup:
            problems.append(f"duplicate {label} entry {v!r} — grid axes must be unique")
        seen.add(v)


def validate_scenario(s: Scenario) -> Scenario:
    """Validate a single scenario; returns it or raises SweepValidationError."""
    problems: List[str] = []
    _check_network(s.network, problems)
    _check_chips(s.n_chips, problems)
    _check_precision(s.precision_bits, problems)
    _check_e_mac(s.e_mac_pj, problems)
    _check_pos_int(s.tiles_per_chip, "tiles_per_chip", problems)
    _check_pos_int(s.n_c, "n_c (CIM rows)", problems)
    _check_pos_int(s.n_m, "n_m (CIM cols)", problems)
    _check_node(s.node_nm, problems)
    _check_dataflow(s.dataflow, problems)
    if problems:
        raise SweepValidationError("\n".join(problems))
    return s


@dataclass(frozen=True)
class SweepGrid:
    """The full cross-product grid. Axes are validated upfront; the engine
    never sees a malformed grid.

    ``networks``       — names from :func:`repro_torch.sweep.registry.available_networks`
                         (the four Tab. IV CNNs plus ``llm:<arch>`` bridges).
    ``chip_counts``    — Domino chip counts (>= 1) to replicate onto.
    ``precisions``     — activation/weight bit-widths (Precision enum values).
    ``e_mac_pj``       — substituted CIM array energies, pJ per 8b OP at
                         45nm/1V (the paper's plug-in parameter).
    ``tiles_per_chip`` — tiles per chip (ArchSpec axis; paper: 240).
    ``n_c`` / ``n_m``  — CIM array rows/columns per tile (ArchSpec axes;
                         paper: 256 x 256).
    ``node_nm``        — technology node in nm (ArchSpec axis; energies are
                         Stillmaker-Baas-rescaled from the 45nm table).
    ``dataflow``       — registered dataflow model names
                         (:func:`repro_torch.dataflows.available_dataflows`);
                         ``"com"`` is the paper's native dataflow, rivals
                         (e.g. ``"minimal_buffer"``) substitute their own
                         energy/structure summaries on the same silicon.
    """

    networks: Tuple[str, ...]
    chip_counts: Tuple[int, ...]
    precisions: Tuple[int, ...] = (int(Precision.INT8),)
    e_mac_pj: Tuple[float, ...] = field(default_factory=lambda: (0.1,))
    tiles_per_chip: Tuple[int, ...] = (DEFAULT_ARCH.tiles_per_chip,)
    n_c: Tuple[int, ...] = (DEFAULT_ARCH.n_c,)
    n_m: Tuple[int, ...] = (DEFAULT_ARCH.n_m,)
    node_nm: Tuple[float, ...] = (DEFAULT_ARCH.node_nm,)
    dataflow: Tuple[str, ...] = ("com",)

    def __post_init__(self):
        # normalize: accept any sequence, store tuples (frozen dataclass)
        for name in AXES:
            v = getattr(self, name)
            if isinstance(v, (str, bytes)) or not isinstance(v, Sequence):
                raise SweepValidationError(
                    f"{name} must be a sequence of values, got {v!r}"
                )
            object.__setattr__(self, name, tuple(v))
        problems: List[str] = []
        for name in AXES:
            values = getattr(self, name)
            if not values:
                problems.append(f"{name} is empty — the grid needs at least one value")
            check = _AXIS_CHECKS[name]
            for v in values:
                check(v, problems)
            _unique(values, name, problems)
        if problems:
            raise SweepValidationError("invalid sweep grid:\n" + "\n".join(problems))

    @property
    def shape(self) -> Tuple[int, ...]:
        """Per-axis lengths, in ``AXES`` (row-major product) order."""
        return tuple(len(getattr(self, name)) for name in AXES)

    @property
    def n_scenarios(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    def scenarios(self) -> List[Scenario]:
        """The cross-product, in deterministic row-major ``AXES`` order
        (network slowest; the architecture axes appended fastest)."""
        return [
            Scenario(network=n, n_chips=c, precision_bits=int(p),
                     e_mac_pj=float(e), tiles_per_chip=int(t), n_c=int(nc),
                     n_m=int(nm), node_nm=float(node), dataflow=df)
            for n, c, p, e, t, nc, nm, node, df in product(
                *(getattr(self, name) for name in AXES)
            )
        ]

    def as_dict(self) -> Dict:
        """JSON-ready axes dict (``from_dict``'s inverse; the ``grid`` key
        of the sweep benchmark artifact)."""
        return dict(
            networks=list(self.networks),
            chip_counts=list(self.chip_counts),
            precisions=[int(p) for p in self.precisions],
            e_mac_pj=[float(e) for e in self.e_mac_pj],
            tiles_per_chip=list(self.tiles_per_chip),
            n_c=list(self.n_c),
            n_m=list(self.n_m),
            node_nm=[float(n) for n in self.node_nm],
            dataflow=list(self.dataflow),
        )

    @classmethod
    def from_dict(cls, d: Dict) -> "SweepGrid":
        extra = set(d) - set(AXES)
        if extra:
            raise SweepValidationError(
                f"unknown grid fields {sorted(extra)}; expected "
                f"{', '.join(AXES)}"
            )
        missing = {"networks", "chip_counts"} - set(d)
        if missing:
            raise SweepValidationError(
                f"missing required grid fields {sorted(missing)}"
            )
        return cls(**d)
