"""The port's sweep engine and dataflows registry against the JAX package's.

The grid schema's messages, the network registry, the per-(network, arch)
summaries, the ``"numpy"`` backend and the scalar oracle are host-side
NumPy/Python in the same order as ``repro.sweep``, so they are held to it
with ``==``. The torch backend (here on the CPU) is held to ``repro.sweep``'s
``"numpy"`` backend, the designated golden, within tests/
test_sweep_backends.py:26's 1e-6 on every column. The JAX package's
``"jax"`` backends are not imported: they cannot run here.
"""
import math

import numpy as np
import pytest

import repro.dataflows as jdf
import repro.sweep as jsw
import repro.sweep.engine as jeng
import repro_torch.core.simulator as tsim
import repro_torch.dataflows as tdf
import repro_torch.sweep as tsw
import repro_torch.sweep.engine as teng
from repro.core.arch import DEFAULT_ARCH as J_ARCH
from repro.core.mapping import ConvSpec as JConv, FCSpec as JFC
from repro_torch.core.arch import DEFAULT_ARCH as T_ARCH
from repro_torch.core.mapping import ConvSpec as TConv, FCSpec as TFC
from repro_torch.core.program import compile_program
from repro_torch.dataflows.minimal_buffer import global_buffer_pj_per_value, mean_bus_hops
from repro_torch.launch import sweep as launch_sweep

TORCH_RTOL = 1e-6

# tests/test_sweep_backends.py:49-60's ArchSpec-axes grid, with an LLM
# bridge network and the rival dataflow added
ARCH_AXES = dict(
    networks=("vgg11-cifar", "resnet18-cifar", "llm:smollm-135m"),
    chip_counts=(1, 7, 24),
    precisions=(8, 16),
    e_mac_pj=(0.02, 0.1),
    tiles_per_chip=(120, 240, 360),
    n_c=(128, 256),
    n_m=(64, 256),
    node_nm=(45.0, 16.0),
    dataflow=("com", "minimal_buffer"),
)
SMALL = dict(networks=("vgg11-cifar", "llm:smollm-135m"), chip_counts=(5, 10),
             precisions=(8, 16), e_mac_pj=(0.02, 0.1), n_c=(128, 256),
             node_nm=(45.0, 22.0), dataflow=("com", "minimal_buffer"))


def _grids(**kw):
    return jsw.SweepGrid(**kw), tsw.SweepGrid(**kw)


def _rel_err(a, b) -> float:
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


# ---------------------------------------------------------------------------
# the schema: the same messages for the bad grids of tests/test_sweep.py:90-198
# ---------------------------------------------------------------------------

BASE = dict(networks=("vgg11-cifar",), chip_counts=(5,))
BAD_GRIDS = (
    [dict(BASE, networks=(v,)) for v in ("vgg99", "", "resnet18", 7, None)]
    + [dict(BASE, chip_counts=(v,)) for v in (0, -1, 2.5, "six", None, True)]
    + [dict(BASE, precisions=(v,)) for v in (0, 3, -8, 64, "8", None)]
    + [dict(BASE, e_mac_pj=(v,)) for v in (0.0, -0.5, float("nan"), float("inf"), "x", None)]
    + [dict(BASE, **{axis: (v,)}) for axis in ("tiles_per_chip", "n_c", "n_m")
       for v in (0, 2.5, "240", None, True)]
    + [dict(BASE, node_nm=(v,)) for v in (0, -45, 251, float("nan"), "45nm", None)]
    + [dict(BASE, dataflow=(v,)) for v in ("nope", 3)]
    + [dict(BASE, networks=()), dict(BASE, networks=("vgg11-cifar", "vgg11-cifar")),
       dict(BASE, networks="vgg11-cifar"),
       dict(networks=("nope",), chip_counts=(0,), precisions=(3,), e_mac_pj=(-1.0,))]
)


@pytest.mark.parametrize("kw", BAD_GRIDS, ids=lambda kw: repr(kw)[:60])
def test_bad_grid_messages_equal_the_reference(kw):
    with pytest.raises(jsw.SweepValidationError) as want:
        jsw.SweepGrid(**kw)
    with pytest.raises(tsw.SweepValidationError) as got:
        tsw.SweepGrid(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("d", [
    {"networks": ["vgg11-cifar"], "chip_counts": [5], "typo_axis": [1]},
    {"networks": ["vgg11-cifar"]},
])
def test_from_dict_messages_equal_the_reference(d):
    with pytest.raises(jsw.SweepValidationError) as want:
        jsw.SweepGrid.from_dict(d)
    with pytest.raises(tsw.SweepValidationError) as got:
        tsw.SweepGrid.from_dict(d)
    assert str(got.value) == str(want.value)


def test_grid_axes_and_scenarios_equal_the_reference():
    jg, tg = _grids(**ARCH_AXES)
    assert tsw.AXES == jsw.AXES and tsw.COLUMNS == jsw.COLUMNS
    assert teng.SUMMARY_FIELDS == jeng.SUMMARY_FIELDS
    assert tg.shape == jg.shape and tg.as_dict() == jg.as_dict()
    assert tsw.SweepGrid.from_dict(tg.as_dict()) == tg
    assert [s.as_dict() for s in tg.scenarios()] == [s.as_dict() for s in jg.scenarios()]


# ---------------------------------------------------------------------------
# the numpy backend and the scalar oracle: equal to the reference's
# ---------------------------------------------------------------------------


def test_network_registry_equals_the_reference():
    assert tsw.available_networks() == jsw.available_networks()
    for net in tsw.available_networks():
        assert tsw.resolve_network(net).layers == tuple(
            TConv(**l.__dict__) if isinstance(l, JConv) else TFC(**l.__dict__)
            for l in jsw.resolve_network(net).layers), net


@pytest.mark.parametrize("net", ["resnet18-cifar", "llm:smollm-135m"])
@pytest.mark.parametrize("dataflow", ["com", "minimal_buffer"])
def test_summaries_equal_the_reference(net, dataflow):
    ja, ta = J_ARCH.replace(n_c=128, node_nm=22.0), T_ARCH.replace(n_c=128, node_nm=22.0)
    assert teng.dataflow_summary(dataflow, net, ta).__dict__ \
        == jeng.dataflow_summary(dataflow, net, ja).__dict__


@pytest.mark.parametrize("chunk_size", [None, 7, 4096])
def test_numpy_backend_equals_the_reference_bitwise(chunk_size):
    jg, tg = _grids(**ARCH_AXES)
    want = jsw.run_sweep(jg, backend="numpy", chunk_size=chunk_size)
    got = tsw.run_sweep(tg, backend="numpy", chunk_size=chunk_size)
    assert got.n_scenarios == want.n_scenarios == jg.n_scenarios
    for c in tsw.COLUMNS:
        np.testing.assert_array_equal(got.columns[c], want.columns[c], err_msg=c)
    assert got.peak_chunk_bytes == want.peak_chunk_bytes
    assert got.build_wall_s <= got.engine_wall_s
    if chunk_size is None:
        assert got.rows()[::97] == want.rows()[::97]


def test_scalar_oracle_equals_the_reference():
    jg, tg = _grids(**SMALL)
    for js, ts in list(zip(jg.scenarios(), tg.scenarios()))[::5]:
        assert tsw.evaluate_scenario(ts) == jsw.evaluate_scenario(js)


# ---------------------------------------------------------------------------
# the torch backend (on the CPU here) against the reference's numpy golden
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk_size", [None, 1000])
def test_torch_backend_matches_the_reference_golden(chunk_size):
    jg, tg = _grids(**ARCH_AXES)
    want = jsw.run_sweep(jg, backend="numpy")
    got = tsw.run_sweep(tg, backend=tsw.make_torch_backend("cpu"), chunk_size=chunk_size)
    assert got.backend == "torch"
    for c in tsw.COLUMNS:
        assert got.columns[c].dtype == np.float64
        assert got.columns[c].shape == (jg.n_scenarios,)
        assert _rel_err(got.columns[c], want.columns[c]) < TORCH_RTOL, c


def test_run_sweep_places_the_torch_backend():
    _, tg = _grids(**SMALL)
    want = tsw.run_sweep(tg, backend="numpy")
    got = tsw.run_sweep(tg, device="cpu", chunk_size=5)
    assert got.backend == "torch" and got.chunk_size == 5
    for c in tsw.COLUMNS:
        assert _rel_err(got.columns[c], want.columns[c]) < TORCH_RTOL, c
    with pytest.raises(ValueError, match="places the 'torch' backend only"):
        tsw.run_sweep(tg, backend="numpy", device="cpu")


def test_unknown_backend_raises_with_the_known_list():
    _, tg = _grids(**BASE)
    with pytest.raises(ValueError) as ei:
        tsw.run_sweep(tg, backend="jax")
    assert str(ei.value) == "unknown sweep backend 'jax'; available: ['numpy', 'torch']"
    with pytest.raises(ValueError, match="chunk_size must be a positive int"):
        tsw.run_sweep(tg, backend="numpy", chunk_size=0)


def test_the_default_backend_runs_on_the_card():
    """``run_sweep(grid)`` is the torch backend on the card: with no card it
    raises, and never becomes ``numpy``."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there (tests/test_torch_gpu.py)")
    _, tg = _grids(**BASE)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsw.run_sweep(tg)


def test_launch_sweep_checks_both_backends(tmp_path):
    out = tmp_path / "sweep.json"
    assert launch_sweep.main(["--backend", "both", "--device", "cpu", "--repeats", "1",
                              "--chips", "5", "10", "--dataflow", "com", "minimal_buffer",
                              "--out", str(out)]) == 0
    import json

    payload = json.loads(out.read_text())
    assert payload["n_scenarios"] == 4 * 2 * 2 * 2 * 2
    assert payload["check_max_rel_err"] <= 1e-9
    assert payload["torch_max_rel_err_vs_numpy"] < TORCH_RTOL
    assert set(payload["backends"]) == {"numpy", "torch"}
    assert payload["torch_device"] == "cpu"
    assert launch_sweep.smoke_1e6_grid().n_scenarios == 1_002_240
    assert launch_sweep.perf_grid().n_scenarios >= 100_000


def test_check_against_scalar_on_a_sample():
    grid = launch_sweep.perf_grid()
    g = tsw.SweepGrid(**{**grid.as_dict(), "networks": ["vgg11-cifar"],
                         "e_mac_pj": [0.05], "chip_counts": [1, 40]})
    res = tsw.run_sweep(g, backend="numpy")
    idx = np.arange(0, g.n_scenarios, 13)
    assert launch_sweep.check_against_scalar(res, 1e-9, idx) <= 1e-9
    assert [launch_sweep._scenario_at(g, int(i)) for i in idx] == [g.scenarios()[i] for i in idx]


# ---------------------------------------------------------------------------
# the dataflows registry (tests/test_dataflows.py:92-172)
# ---------------------------------------------------------------------------

T_CONV, J_CONV = TConv("c1", 3, 4, 5, 8, 8), JConv("c1", 3, 4, 5, 8, 8)
T_FC, J_FC = TFC("f1", 300, 10), JFC("f1", 300, 10)


@pytest.mark.parametrize("net", ["vgg11-cifar", "resnet18-cifar"])
def test_com_adapter_is_domino_model_bitwise(net):
    com = tdf.get_dataflow("com")
    layers = tuple(tsw.resolve_network(net).layers)
    model = tsim.DominoModel(compile_program(tsw.resolve_network(net), T_ARCH))
    # == on purpose: the adapter must not re-derive anything
    assert com.onchip_energy_img_j(layers, T_ARCH) == model.onchip_energy_img_j()
    assert com.offchip_energy_img_j(layers, T_ARCH) == model.offchip_energy_img_j()
    assert com.offchip_values_img(layers, T_ARCH) == tsim.offchip_values_img(model.allocs)
    assert com.n_arrays(layers, T_ARCH) == model.n_tiles
    totals = com.traffic_totals(layers, T_ARCH)
    assert totals == {f: float(model.program.event_totals[f]) for f in tsim.EVENT_FIELDS}
    assert com.summary_overrides(layers, T_ARCH) == {}
    assert teng.dataflow_summary("com", net, T_ARCH) is teng.network_summary(net, T_ARCH)
    j_layers = tuple(jsw.resolve_network(net).layers)
    jcom = jdf.get_dataflow("com")
    assert com.energy_breakdown_img_j(layers, T_ARCH) \
        == jcom.energy_breakdown_img_j(j_layers, J_ARCH)
    assert com.movement_energy_img_j(layers, T_ARCH) \
        == jcom.movement_energy_img_j(j_layers, J_ARCH)


def test_minimal_buffer_golden_counts_and_energy():
    mb = tdf.get_dataflow("minimal_buffer")
    assert mb.traffic_totals((T_CONV,), T_ARCH) == dict(
        buf_rd=256.0, buf_wr=320.0, bus_vals=576.0, xfer_psum=0.0, acts=320.0)
    assert mb.traffic_totals((T_FC,), T_ARCH) == dict(
        buf_rd=300.0, buf_wr=10.0, bus_vals=310.0, xfer_psum=10.0, acts=10.0)
    b = mb.energy_breakdown_img_j((T_CONV,), T_ARCH)
    gb = 281.3 / 64 * math.sqrt(240)
    assert math.isclose(global_buffer_pj_per_value(T_ARCH), gb, rel_tol=1e-12)
    assert math.isclose(mean_bus_hops(T_ARCH), 0.5 * math.sqrt(240), rel_tol=1e-12)
    assert math.isclose(b["global_buffer"], (256 + 320) * gb * 1e-12, rel_tol=1e-12)
    assert math.isclose(b["bus_link"], 576 * 0.5 * math.sqrt(240) * 8 * 0.30 * 1e-12,
                        rel_tol=1e-12)
    assert b["psum_link"] == 0.0 and b["psum_add"] == 0.0
    assert math.isclose(b["act"], 320 * 0.0009 * 1e-12, rel_tol=1e-12)
    layers = (T_CONV, T_FC)
    b = mb.energy_breakdown_img_j(layers, T_ARCH)
    assert mb.movement_energy_img_j(layers, T_ARCH) == pytest.approx(
        b["global_buffer"] + b["bus_link"] + b["psum_link"]
        + mb.offchip_energy_img_j(layers, T_ARCH), rel=1e-12)
    rn = tuple(tsw.resolve_network("resnet18-cifar").layers)
    assert mb.n_arrays(rn, T_ARCH) < tdf.get_dataflow("com").n_arrays(rn, T_ARCH)


@pytest.mark.parametrize("net", ["vgg16-imagenet", "llm:smollm-135m"])
def test_minimal_buffer_equals_the_reference(net):
    ta, ja = T_ARCH.replace(tiles_per_chip=120), J_ARCH.replace(tiles_per_chip=120)
    t_layers = tuple(tsw.resolve_network(net).layers)
    j_layers = tuple(jsw.resolve_network(net).layers)
    mb, jmb = tdf.get_dataflow("minimal_buffer"), jdf.get_dataflow("minimal_buffer")
    assert mb.traffic_totals(t_layers, ta) == jmb.traffic_totals(j_layers, ja)
    assert mb.summary_overrides(t_layers, ta) == jmb.summary_overrides(j_layers, ja)
    assert mb.movement_energy_img_j(t_layers, ta) == jmb.movement_energy_img_j(j_layers, ja)


def test_registry_semantics():
    assert tdf.available_dataflows() == jdf.available_dataflows() == ("com", "minimal_buffer")
    assert tdf.REGISTRY_VERSION == jdf.REGISTRY_VERSION
    assert tdf.OVERRIDABLE_SUMMARY_FIELDS == jdf.OVERRIDABLE_SUMMARY_FIELDS
    with pytest.raises(KeyError) as want:
        jdf.get_dataflow("nope")
    with pytest.raises(KeyError) as got:
        tdf.get_dataflow("nope")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="already registered"):
        tdf.register_dataflow(tdf.MinimalBufferDataflow())
    with pytest.raises(TypeError):
        tdf.register_dataflow(object())

    class Bad(tdf.MinimalBufferDataflow):
        name = "bad-overrides"

        def _overrides_uncached(self, layers, arch):
            return (("exec_us", 1.0),)

    with pytest.raises(ValueError, match="may only set"):
        Bad().summary_overrides((T_CONV,), T_ARCH)
    stats = tdf.dataflow_cache_stats()
    assert "dataflow:com:traffic_totals" in stats
    assert "dataflow:minimal_buffer:summary_overrides" in stats
