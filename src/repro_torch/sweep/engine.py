"""Batched design-space sweep engine with pluggable evaluation backends.

The PyTorch port's counterpart of ``repro.sweep.engine``. It evaluates a
whole ``SweepGrid`` in one shot. The scenario-independent quantities
(event totals, on-chip energy, mapping, pipeline structure) come from ONE
``compile_program`` call per *(network, architecture)* combo; the
scenario-dependent Tab. IV columns are then pure array expressions over
the stacked scenario axes.

The grid's ``dataflow`` axis selects the event model per scenario: ``"com"``
reads the engine's native summaries, rival names from
:func:`repro_torch.dataflows.available_dataflows` substitute their own
energy/structure summaries (:func:`dataflow_summary`) through the same
column math on every backend.

Backends (``run_sweep(grid, backend=...)``):

* ``"torch"`` (the default) — :mod:`repro_torch.sweep.backend_torch`: the
  same column math in float64 PyTorch on the card (``device=None``) or on
  the device ``run_sweep(device=...)`` names, held against the NumPy
  oracle to 1e-6. Without a card it raises; it never falls back.
* ``"numpy"`` — the golden oracle on the host. Mirrors
  ``DominoModel.evaluate`` operation-for-operation, so batched and scalar
  results agree to the last ulp — the golden tests assert 1e-9.

Third-party backends register through :func:`register_backend`; a backend
is any callable taking a :class:`ScenarioBatch` and returning the
``COLUMNS`` dict of ``(n_scenarios,)`` float64 NumPy arrays in grid
row-major order.
"""
from __future__ import annotations

import dataclasses
import operator
import time
from dataclasses import dataclass
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.arch import DEFAULT_ARCH, ArchSpec
from repro_torch.core.program import compile_program
from repro_torch.core.simulator import DominoModel, offchip_values_img
from repro_torch.sweep.registry import resolve_network
from repro_torch.sweep.scenario import Scenario, SweepGrid, validate_scenario

# Tab. IV columns emitted per scenario — identical keys and semantics to
# ``DominoModel.evaluate``.
COLUMNS: Tuple[str, ...] = (
    "exec_us", "img_s", "power_w", "onchip_w", "offchip_w", "cim_w",
    "ce_tops_w", "ops", "area_mm2", "thr_tops_mm2", "img_s_per_core",
    "n_chips", "n_tiles",
)

# Scenario-independent per-(network, arch) scalars the backends consume,
# stacked over the (network, tiles_per_chip, n_c, n_m, node_nm) combo axes.
SUMMARY_FIELDS: Tuple[str, ...] = (
    "n_tiles", "exec_us", "onchip_j", "offchip_values", "ops",
    "bottleneck_px", "skip_stall", "area_mm2", "offchip_pj_per_bit",
)


@dataclass(frozen=True)
class NetworkSummary:
    """Scenario-independent per-(network, architecture) quantities."""

    name: str
    n_tiles: int
    n_chips_min: int
    exec_us: float
    onchip_j: float
    offchip_values: float
    ops: float
    bottleneck_px: float      # steady-state cycles/img of the largest conv
    skip_stall: float         # residual-join pipeline stall factor
    area_mm2: float           # minimal-mapping tile area
    offchip_pj_per_bit: float  # inter-chip pJ/bit at the arch's node corner


# Bounded: sweeps replace the arch per scenario combo, so an unbounded
# cache grows with every distinct (network, arch) pair ever swept. 4096
# summaries (tiny frozen rows) cover far more combos than any one grid;
# evictions cost one re-read of the (separately cached) compiled program.
@lru_cache(maxsize=4096)
def _network_summary(name: str, arch: ArchSpec) -> NetworkSummary:
    # one compile per (workload, arch): the summary reads the program's
    # placement/block/event artifacts instead of re-deriving mappings
    model = DominoModel(compile_program(resolve_network(name), arch))
    return NetworkSummary(
        name=name,
        n_tiles=model.n_tiles,
        n_chips_min=model.n_chips,
        exec_us=model.exec_time_us(),
        onchip_j=model.onchip_energy_img_j(),
        offchip_values=offchip_values_img(model.allocs),
        ops=model.total_ops(),
        bottleneck_px=model.bottleneck_px(),
        skip_stall=model.skip_stall(),
        area_mm2=model.n_tiles * arch.tile_area_um2() / 1e6,
        offchip_pj_per_bit=arch.energy.interchip_pj_per_bit * arch.energy_scale(),
    )


def network_summary(name: str, arch: ArchSpec = DEFAULT_ARCH) -> NetworkSummary:
    """Scenario-independent summary, cached per ``(name, arch)`` (the
    default-arg call shares the explicit-``DEFAULT_ARCH`` cache line)."""
    return _network_summary(name, arch)


# the engine's cache the repeat-sweep tests introspect
network_summary.cache_info = _network_summary.cache_info
network_summary.cache_clear = _network_summary.cache_clear


@lru_cache(maxsize=2048)
def _dataflow_summary(dataflow: str, name: str, arch: ArchSpec
                      ) -> NetworkSummary:
    base = _network_summary(name, arch)
    if dataflow == "com":
        # the engine's native summary IS the COM model (the registered
        # adapter is bitwise-anchored to it); never re-derive
        return base
    from repro_torch.dataflows import get_dataflow

    model = get_dataflow(dataflow)
    ov = model.summary_overrides(resolve_network(name).layers, arch)
    return dataclasses.replace(
        base,
        n_tiles=int(ov["n_tiles"]) if "n_tiles" in ov else base.n_tiles,
        onchip_j=float(ov.get("onchip_j", base.onchip_j)),
        offchip_values=float(ov.get("offchip_values", base.offchip_values)),
        area_mm2=float(ov.get("area_mm2", base.area_mm2)),
    )


def dataflow_summary(dataflow: str, name: str,
                     arch: ArchSpec = DEFAULT_ARCH) -> NetworkSummary:
    """:func:`network_summary` under a registered dataflow model: the COM
    summary with the model's ``summary_overrides`` (energy + structure)
    substituted — timing fields stay the shared pipeline model. For
    ``"com"`` this *is* the cached native summary, untouched."""
    return _dataflow_summary(dataflow, name, arch)


dataflow_summary.cache_info = _dataflow_summary.cache_info
dataflow_summary.cache_clear = _dataflow_summary.cache_clear


@dataclass
class ScenarioBatch:
    """Backend input: the grid lowered to stacked arrays.

    ``shape`` is the 9-axis grid shape in ``scenario.AXES`` order. The
    cheap axes arrive as small per-axis value arrays (``chips``, ``bits``,
    ``e_mac``, ``tpc``); the expensive, architecture-dependent quantities
    arrive as ``summary[field]`` arrays over the (network, tiles_per_chip,
    n_c, n_m, node_nm, dataflow) combo axes. Backends broadcast both to the full
    grid, evaluate the column closed forms elementwise, and return
    row-major ``(n_scenarios,)`` columns — scenario ordering is fixed by
    ``SweepGrid.scenarios()`` and shared by every backend.

    **Chunked evaluation**: when ``sel`` carries a vector of flat scenario
    indices, the views gather per-scenario values of just those rows
    instead of broadcasting the full grid — ``axis_view``/``summary_view``
    return ``(len(sel),)`` arrays and ``out_shape`` is ``(len(sel),)``.
    ``run_sweep(grid, chunk_size=...)`` evaluates 1e6+-scenario grids in
    such bounded-memory chunks without ever materializing the full stacked
    batch.
    """

    shape: Tuple[int, ...]
    chips: np.ndarray          # (len(chip_counts),) float64
    bits: np.ndarray           # (len(precisions),) float64
    e_mac: np.ndarray          # (len(e_mac_pj),) float64
    tpc: np.ndarray            # (len(tiles_per_chip),) float64
    summary: Dict[str, np.ndarray]  # each (l_net, l_tpc, l_nc, l_nm, l_node, l_df)
    fdm_factor: float
    step_hz: float
    pipeline_eff: float
    sel: Optional[np.ndarray] = None  # flat scenario indices (chunked mode)

    @property
    def n_scenarios(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def out_shape(self) -> Tuple[int, ...]:
        """Shape backends broadcast their columns to before flattening:
        the full grid, or ``(len(sel),)`` in chunked mode."""
        if self.sel is not None:
            return (int(self.sel.shape[0]),)
        return self.shape

    def _sel_indices(self) -> Tuple[np.ndarray, ...]:
        """Per-axis index vectors of the selected flat scenarios (cached)."""
        cached = getattr(self, "_sel_idx", None)
        if cached is None:
            cached = np.unravel_index(self.sel, self.shape)
            object.__setattr__(self, "_sel_idx", cached)
        return cached

    def axis_view(self, values: np.ndarray, axis: int) -> np.ndarray:
        """A per-axis value array reshaped for broadcast over ``shape``
        (or gathered per selected scenario in chunked mode)."""
        if self.sel is not None:
            return values[self._sel_indices()[axis]]
        shp = [1] * len(self.shape)
        shp[axis] = len(values)
        return values.reshape(shp)

    def summary_view(self, field: str) -> np.ndarray:
        """A summary array reshaped for broadcast over ``shape``
        (or gathered per selected scenario in chunked mode)."""
        if self.sel is not None:
            i = self._sel_indices()
            return self.summary[field][i[0], i[4], i[5], i[6], i[7], i[8]]
        l = self.shape
        return self.summary[field].reshape(
            l[0], 1, 1, 1, l[4], l[5], l[6], l[7], l[8]
        )


def build_batch(grid: SweepGrid, arch: ArchSpec = DEFAULT_ARCH) -> ScenarioBatch:
    """Lower a validated grid to backend input arrays.

    Per-(network, architecture) summaries read the compiled program for
    each combo (``compile_program``, cached on the hashable ``(workload,
    ArchSpec)`` key); everything else is a cheap axis array. No
    per-scenario Python objects are materialized — this is what lets
    1e5+-scenario grids run.
    """
    shape = grid.shape
    summary = {
        f: np.empty((shape[0], shape[4], shape[5], shape[6], shape[7],
                     shape[8]), dtype=np.float64)
        for f in SUMMARY_FIELDS
    }
    for i0, net in enumerate(grid.networks):
        for i4, tpc in enumerate(grid.tiles_per_chip):
            for i5, nc in enumerate(grid.n_c):
                for i6, nm in enumerate(grid.n_m):
                    for i7, node in enumerate(grid.node_nm):
                        arch_c = arch.replace(
                            tiles_per_chip=int(tpc), n_c=int(nc),
                            n_m=int(nm), node_nm=float(node),
                        )
                        for i8, df in enumerate(grid.dataflow):
                            # "com" stays on the native summary path;
                            # rivals substitute their summary_overrides
                            s = (network_summary(net, arch_c)
                                 if df == "com"
                                 else dataflow_summary(df, net, arch_c))
                            for f in SUMMARY_FIELDS:
                                summary[f][i0, i4, i5, i6, i7, i8] = \
                                    getattr(s, f)
    return ScenarioBatch(
        shape=shape,
        chips=np.asarray(grid.chip_counts, dtype=np.float64),
        bits=np.asarray(grid.precisions, dtype=np.float64),
        e_mac=np.asarray(grid.e_mac_pj, dtype=np.float64),
        tpc=np.asarray(grid.tiles_per_chip, dtype=np.float64),
        summary=summary,
        fdm_factor=float(arch.fdm_factor),
        step_hz=float(arch.step_hz),
        pipeline_eff=float(arch.pipeline_eff),
    )


def numpy_backend(batch: ScenarioBatch) -> Dict[str, np.ndarray]:
    """The golden oracle: NumPy broadcasting over the stacked scenario
    arrays, operation-for-operation the arithmetic of
    ``DominoModel.evaluate`` (asserted to 1e-9 by the golden tests). Runs on
    the host and needs no device."""
    chips = batch.axis_view(batch.chips, 1)
    bits = batch.axis_view(batch.bits, 2)
    e_mac = batch.axis_view(batch.e_mac, 3)
    tpc = batch.axis_view(batch.tpc, 4)
    n_tiles = batch.summary_view("n_tiles")
    exec_us = batch.summary_view("exec_us")
    onchip_j = batch.summary_view("onchip_j")
    offchip_values = batch.summary_view("offchip_values")
    ops = batch.summary_view("ops")
    bottleneck_px = batch.summary_view("bottleneck_px")
    skip_stall = batch.summary_view("skip_stall")
    area = batch.summary_view("area_mm2")
    offchip_pj_per_bit = batch.summary_view("offchip_pj_per_bit")

    # throughput: steady-state rate x replicas x pipeline/skip stalls
    # (same expression order as DominoModel.throughput_img_s)
    per_copy = batch.fdm_factor * batch.step_hz / bottleneck_px
    copies = np.maximum(1.0, (chips * tpc) / n_tiles)
    img_s = per_copy * copies * batch.pipeline_eff * skip_stall

    # energy per image: on-chip events + precision-scaled off-chip
    # traffic + substituted CIM arrays
    e_off = offchip_values * bits * offchip_pj_per_bit * 1e-12
    e_cim = ops * e_mac * 1e-12
    e_total = onchip_j + e_off + e_cim

    cols = dict(
        exec_us=exec_us,
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
    shape = batch.out_shape
    return {
        c: np.ascontiguousarray(np.broadcast_to(v, shape)).reshape(-1)
        for c, v in cols.items()
    }


# ---------------------------------------------------------------------------
# backend registry
# ---------------------------------------------------------------------------

SweepBackend = Callable[[ScenarioBatch], Dict[str, np.ndarray]]

BACKENDS: Dict[str, SweepBackend] = {"numpy": numpy_backend}


def register_backend(name: str, fn: SweepBackend) -> None:
    """Register an evaluation backend under ``name`` (overwrites)."""
    BACKENDS[name] = fn


def _resolve_backend(name) -> SweepBackend:
    if callable(name) and not isinstance(name, str):
        # an unregistered SweepBackend callable passes straight through —
        # e.g. repro_torch.sweep.backend_torch.make_torch_backend(device)
        return name
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(
            f"unknown sweep backend {name!r}; available: {sorted(BACKENDS)}"
        ) from None


class SweepResult:
    """Columnar sweep output: ``columns[c][i]`` is Tab. IV column ``c`` for
    scenario ``i`` in grid row-major order (``grid.scenarios()`` order).

    ``engine_wall_s`` is the whole call on the host clock; ``build_wall_s``
    is its ``build_batch`` part (the compiles and summaries), so the
    backend's share is the difference.

    ``scenarios`` is materialized lazily — backends work on stacked arrays
    and never build the per-scenario objects; 1e5+-row results stay cheap
    unless a caller actually asks for the row view.
    """

    def __init__(self, grid: SweepGrid, columns: Dict[str, np.ndarray],
                 engine_wall_s: float, backend: str = "numpy",
                 scenarios: Optional[List[Scenario]] = None,
                 chunk_size: Optional[int] = None,
                 peak_chunk_bytes: Optional[int] = None,
                 build_wall_s: Optional[float] = None):
        self.grid = grid
        self.columns = columns
        self.engine_wall_s = engine_wall_s
        self.build_wall_s = build_wall_s
        self.backend = backend
        self.chunk_size = chunk_size
        self.peak_chunk_bytes = peak_chunk_bytes
        self._scenarios = scenarios

    @property
    def scenarios(self) -> List[Scenario]:
        if self._scenarios is None:
            self._scenarios = self.grid.scenarios()
        return self._scenarios

    @property
    def n_scenarios(self) -> int:
        return self.grid.n_scenarios

    def rows(self) -> List[Dict]:
        """Row-oriented view: one dict per scenario (params + columns)."""
        return [
            {**s.as_dict(), **{c: float(self.columns[c][i]) for c in COLUMNS}}
            for i, s in enumerate(self.scenarios)
        ]

    def as_dict(self, include_rows: Optional[bool] = None) -> Dict:
        """JSON-ready payload. ``include_rows=None`` auto-omits the row view
        above 10_000 scenarios (the columns stay available in-process)."""
        if include_rows is None:
            include_rows = self.n_scenarios <= 10_000
        out = dict(
            grid=self.grid.as_dict(),
            n_scenarios=self.n_scenarios,
            engine_wall_s=self.engine_wall_s,
            build_wall_s=self.build_wall_s,
            backend=self.backend,
            columns=list(COLUMNS),
        )
        if self.chunk_size is not None:
            out["chunk_size"] = self.chunk_size
            out["peak_chunk_bytes"] = self.peak_chunk_bytes
        if include_rows:
            out["rows"] = self.rows()
        return out


def run_sweep(grid: SweepGrid, backend: Union[str, SweepBackend] = "torch",
              arch: ArchSpec = DEFAULT_ARCH,
              chunk_size: Optional[int] = None, device=None) -> SweepResult:
    """Evaluate every scenario of a validated grid on the chosen backend —
    a registered name (``"torch"``, ``"numpy"``) or any ``SweepBackend``
    callable.

    ``device`` places the ``"torch"`` backend: ``None`` means the card, as
    everywhere in the port, and no card raises. It applies to ``"torch"``
    only; ``"numpy"`` runs on the host and takes no device.

    ``arch`` is the base architecture template; the grid's architecture
    axes (``tiles_per_chip``, ``n_c``, ``n_m``, ``node_nm``) are
    substituted into it per scenario.

    ``chunk_size`` switches to bounded-memory chunked evaluation: the
    backend sees ``ceil(n/chunk_size)`` gathered ``(chunk,)`` batches
    instead of one full-grid broadcast, so 1e6+-scenario grids run without
    materializing the full stacked batch (column results are bitwise
    chunking-invariant for the NumPy oracle). The result records the
    chunking and ``peak_chunk_bytes`` — the accounted per-chunk array
    bytes (index vectors + gathered views + column chunks; backends'
    elementwise temporaries scale with the same chunk length but are not
    counted), which is what bounds with the chunk instead of the grid.
    """
    if device is None:
        fn = _resolve_backend(backend)
    elif isinstance(backend, str) and backend == "torch":
        from repro_torch.sweep.backend_torch import make_torch_backend

        fn = make_torch_backend(device)
    else:
        raise ValueError(
            f"device={device!r} places the 'torch' backend only, not {backend!r}")
    if chunk_size is not None:
        # validate up front, before the (expensive) batch build; accept
        # any integral type (incl. NumPy ints), reject bools and floats
        try:
            if isinstance(chunk_size, bool):
                raise TypeError
            chunk_size = int(operator.index(chunk_size))
        except TypeError:
            raise ValueError(f"chunk_size must be a positive int, got "
                             f"{chunk_size!r}") from None
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be a positive int, got "
                             f"{chunk_size!r}")
    t0 = time.perf_counter()
    batch = build_batch(grid, arch)
    t_build = time.perf_counter() - t0
    if chunk_size is None:
        cols = fn(batch)
        peak = None
    else:
        n = grid.n_scenarios
        cols = {c: np.empty(n, dtype=np.float64) for c in COLUMNS}
        peak = 0
        # accounted per-chunk array bytes: the 9 unraveled index vectors,
        # the 4+|S| gathered per-scenario views, and the |C| column chunks
        # — all (chunk,) float64/int64. Backend elementwise temporaries
        # (a small constant factor more) scale with the same chunk length;
        # nothing scales with the full grid.
        per_row = 8 * (9 + 4 + len(SUMMARY_FIELDS) + len(COLUMNS))
        for lo in range(0, n, chunk_size):
            sel = np.arange(lo, min(lo + chunk_size, n), dtype=np.int64)
            out = fn(dataclasses.replace(batch, sel=sel))
            hi = lo + sel.shape[0]
            for c in COLUMNS:
                cols[c][lo:hi] = out[c]
            peak = max(peak, sel.shape[0] * per_row)
    return SweepResult(
        grid=grid, columns=cols, engine_wall_s=time.perf_counter() - t0,
        backend=(backend if isinstance(backend, str)
                 else getattr(backend, "__name__", "custom")),
        chunk_size=chunk_size, peak_chunk_bytes=peak, build_wall_s=t_build,
    )


def _evaluate_rival(s: Scenario, arch: ArchSpec) -> Dict[str, float]:
    """Scalar columns under a rival dataflow model — a fully independent
    code path from the batched summary tables: energy/structure come
    straight from the registered model, the shared columns mirror
    ``DominoModel.evaluate`` expression-for-expression (the same role the
    scalar oracle plays for the com column)."""
    from repro_torch.dataflows import get_dataflow

    arch_s = s.arch(arch)
    wl = resolve_network(s.network)
    model = DominoModel(compile_program(wl, arch_s))
    df = get_dataflow(s.dataflow)
    layers = tuple(wl.layers)
    ov = df.summary_overrides(layers, arch_s)
    n_tiles = int(ov["n_tiles"]) if "n_tiles" in ov else model.n_tiles
    onchip_j = float(ov.get("onchip_j", model.onchip_energy_img_j()))
    offv = float(ov.get("offchip_values", offchip_values_img(model.allocs)))
    area = float(ov.get(
        "area_mm2", model.n_tiles * arch_s.tile_area_um2() / 1e6))
    chips = s.n_chips
    per_copy = arch_s.fdm_factor * arch_s.step_hz / model.bottleneck_px()
    copies = max(1.0, (chips * arch_s.tiles_per_chip) / n_tiles)
    img_s = per_copy * copies * arch_s.pipeline_eff * model.skip_stall()
    e_off = offv * s.precision_bits * (
        arch_s.energy.interchip_pj_per_bit * arch_s.energy_scale()) * 1e-12
    ops = model.total_ops()
    e_cim = ops * s.e_mac_pj * 1e-12
    e_total = onchip_j + e_off + e_cim
    return dict(
        exec_us=model.exec_time_us(),
        img_s=img_s,
        power_w=e_total * img_s,
        onchip_w=onchip_j * img_s,
        offchip_w=e_off * img_s,
        cim_w=e_cim * img_s,
        ce_tops_w=ops / e_total / 1e12,
        ops=ops,
        area_mm2=area,
        thr_tops_mm2=ops * img_s / 1e12 / area,
        img_s_per_core=img_s / (chips * arch_s.tiles_per_chip),
        n_chips=chips,
        n_tiles=n_tiles,
    )


def evaluate_scenario(s: Scenario, arch: ArchSpec = DEFAULT_ARCH) -> Dict[str, float]:
    """Scalar single-scenario evaluation through the reference path —
    ``DominoModel.evaluate`` for the native ``dataflow="com"``, the rival
    model's overrides through the identical column expressions otherwise
    — the oracle the batched engine is golden-tested against."""
    validate_scenario(s)
    if s.dataflow != "com":
        return _evaluate_rival(s, arch)
    model = DominoModel(compile_program(resolve_network(s.network), s.arch(arch)))
    return model.evaluate(s.e_mac_pj, n_chips=s.n_chips)
