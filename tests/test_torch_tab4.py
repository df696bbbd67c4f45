"""The port's Tab. IV evaluation against the JAX package's.

``repro_torch.core.energy``, the Tab. IV part of
``repro_torch.core.simulator`` and ``repro_torch.launch.table_iv`` are
host-side float64 arithmetic in the same order as the reference, so their
numbers are held to ``repro``'s with ``==``. ``COMGridSim`` runs its block
chain in float64 PyTorch (here on the CPU) and is held to the reference sim
and to the float64 oracles at tests/test_simulator.py:39's rtol = atol =
1e-10, with equal event counts.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

import benchmarks.table_iv as j_t4
import repro.core.energy as jE
import repro.core.mapping as jmap
import repro.core.program as jprog
import repro.core.simulator as jsim
import repro_torch.core.energy as tE
import repro_torch.core.mapping as tmap
import repro_torch.core.program as tprog
import repro_torch.core.simulator as tsim
import repro_torch.launch.table_iv as t_t4
from repro.core.arch import DEFAULT_ARCH as J_ARCH
from repro_torch.core.arch import DEFAULT_ARCH as T_ARCH

NETS = list(jmap.NETWORKS)
# README.md's quickstart design point
WIDE = dict(n_c=512, n_m=512, tiles_per_chip=120, node_nm=22.0)
TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("dataflow", ["com", "minimal_buffer"])
def test_table_iv_rows_equal_the_reference(dataflow):
    assert t_t4.run(dataflow) == j_t4.run(dataflow)


def test_table_iv_main_writes_the_rows(tmp_path, capsys):
    out = tmp_path / "t4.json"
    rows = t_t4.main(["--dataflow", "minimal_buffer", "--out", str(out)])
    assert rows == j_t4.run("minimal_buffer")
    assert "dataflow=minimal_buffer" in capsys.readouterr().out
    assert out.read_text().count('"counterpart"') == len(jE.COUNTERPARTS)


def test_energy_constants_and_datasheet_equal_the_reference():
    assert tE.PAPER_DOMINO == jE.PAPER_DOMINO
    assert [dataclasses.astuple(c) for c in tE.COUNTERPARTS.values()] \
        == [dataclasses.astuple(c) for c in jE.COUNTERPARTS.values()]
    for name in ("RIFM_BUFFER_PJ", "ADDER_PJ_8B", "INTERCHIP_PJ_PER_BIT", "STEP_HZ",
                 "TILE_BW_BPS", "PRECISION_BITS", "VDD", "NODE_NM", "CIM_AREA_256"):
        assert getattr(tE, name) == getattr(jE, name), name
    assert tE.tile_area_um2() == jE.tile_area_um2()
    for c in jE.COUNTERPARTS.values():
        kw = dict(node=c.node, bw=c.bits, ba=c.bits)
        assert tE.normalize_ce(c.ce_tops_w, vdd=c.vdd, **kw) \
            == jE.normalize_ce(c.ce_tops_w, vdd=c.vdd, **kw)
        assert tE.normalize_throughput(c.thr_tops_mm2, **kw) \
            == jE.normalize_throughput(c.thr_tops_mm2, **kw)
    assert t_t4.implied_e_mac_pj("yoon_isscc21") == j_t4.implied_e_mac_pj("yoon_isscc21")


@pytest.mark.parametrize("arch", [{}, WIDE], ids=["default", "wide"])
@pytest.mark.parametrize("net", NETS)
def test_domino_model_evaluate_equals_the_reference(net, arch):
    jm = jsim.DominoModel(list(jmap.NETWORKS[net]()), arch=J_ARCH.replace(**arch))
    tm = tsim.DominoModel(list(tmap.NETWORKS[net]()), arch=T_ARCH.replace(**arch))
    for e_mac, chips in ((0.05, 10), (0.1, None)):
        assert tm.evaluate(e_mac, n_chips=chips) == jm.evaluate(e_mac, n_chips=chips)
    assert tm.exec_time_us() == jm.exec_time_us()
    assert tm.offchip_bits_img() == jm.offchip_bits_img()
    assert dataclasses.asdict(tm.events()) == dataclasses.asdict(jm.events())
    with pytest.raises(ValueError, match="conflicting architectures"):
        tsim.DominoModel(tm.program, arch=T_ARCH.replace(n_c=64))


@pytest.mark.parametrize("net", NETS)
def test_energy_from_events_and_offchip_values_equal_the_reference(net):
    jp = jprog.compile_program(jmap.NETWORKS[net](), J_ARCH.replace(**WIDE))
    tp = tprog.compile_program(tmap.NETWORKS[net](), T_ARCH.replace(**WIDE))
    assert tsim.onchip_pj_from_events(tp.event_totals, tp.arch) \
        == jsim.onchip_pj_from_events(jp.event_totals, jp.arch)
    assert tsim.offchip_values_img(list(tp.allocs)) == jsim.offchip_values_img(list(jp.allocs))
    # the array form the sweep engine feeds it
    per_layer = {f: np.asarray(tp.layer_programs[0].events[f]) * np.arange(1, 4)
                 for f in tsim.EVENT_FIELDS}
    np.testing.assert_array_equal(tsim.onchip_pj_from_events(per_layer, tp.arch),
                                  jsim.onchip_pj_from_events(per_layer, jp.arch))


@pytest.mark.parametrize("arch", [{}, dict(n_c=8, n_m=8)], ids=["default", "small"])
def test_closed_form_events_equal_the_reference(arch):
    ja, ta = J_ARCH.replace(**arch), T_ARCH.replace(**arch)
    for jl, tl in zip(jmap.vgg16_imagenet(), tmap.vgg16_imagenet()):
        jf, tf = (jsim.conv_events, tsim.conv_events) if isinstance(tl, tmap.ConvSpec) \
            else (jsim.fc_events, tsim.fc_events)
        assert dataclasses.asdict(tf(tl, ta)) == dataclasses.asdict(jf(jl, ja))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert dataclasses.asdict(tsim.events_for_layers(list(tmap.vgg11_cifar()))) \
            == dataclasses.asdict(jsim.events_for_layers(list(jmap.vgg11_cifar())))
    with pytest.deprecated_call():
        tsim.events_for_layers([tmap.FCSpec("f", 4, 4)])


# tests/test_simulator.py:22-39's shape space, and multi-block layers
# (C > n_c and M > n_m) at the default and at an 8 x 8 geometry
CONVS = [
    # h, w, c, m, k, s, p, arch
    (4, 4, 1, 1, 1, 1, 0, {}),
    (12, 9, 12, 7, 3, 1, 1, {}),
    (7, 11, 5, 12, 5, 2, 2, {}),
    (10, 6, 3, 9, 3, 2, 0, {}),
    (6, 6, 20, 12, 3, 1, 1, dict(n_c=8, n_m=8)),
    (4, 4, 300, 270, 3, 1, 1, {}),
]


@pytest.mark.parametrize("h,w,c,m,k,s,p,arch", CONVS)
def test_com_grid_sim_conv_matches_reference(h, w, c, m, k, s, p, arch):
    rng = np.random.default_rng(h * 100 + c)
    wts = rng.normal(size=(k, k, c, m))
    x = rng.normal(size=(h, w, c))
    jl = jmap.ConvSpec("t", k, c, m, h, w, stride=s, padding=p)
    tl = tmap.ConvSpec("t", k, c, m, h, w, stride=s, padding=p)
    jsim_ = jsim.COMGridSim(jl, wts, J_ARCH.replace(**arch))
    tsim_ = tsim.COMGridSim(tl, wts, T_ARCH.replace(**arch), device="cpu")
    want = jsim_.run(x)
    got = tsim_.run(x)
    assert got.dtype == torch.float64 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(tsim.reference_conv(x, wts, tl).numpy(), want, **TOL)
    np.testing.assert_allclose(
        tsim.reference_conv(torch.as_tensor(x), torch.as_tensor(wts), tl).numpy(),
        jsim.reference_conv(x, wts, jl), **TOL)
    assert dataclasses.asdict(tsim_.ev) == dataclasses.asdict(jsim_.ev)
    assert dataclasses.asdict(tsim_.ev) == dataclasses.asdict(
        tsim.conv_events(tl, T_ARCH.replace(**arch)))
    assert tsim_.max_queue_depth == jsim_.max_queue_depth


@pytest.mark.parametrize("c,m,arch", [(37, 11, {}), (300, 270, {}), (20, 12, dict(n_c=8, n_m=8))])
def test_com_grid_sim_fc_matches_reference(c, m, arch):
    rng = np.random.default_rng(c + m)
    wts = rng.normal(size=(c, m))
    x = rng.normal(size=(c,))
    jl, tl = jmap.FCSpec("f", c, m), tmap.FCSpec("f", c, m)
    jsim_ = jsim.COMGridSim(jl, wts, J_ARCH.replace(**arch))
    tsim_ = tsim.COMGridSim(tl, torch.as_tensor(wts), T_ARCH.replace(**arch), device="cpu")
    want = jsim_.run(x)
    np.testing.assert_allclose(tsim_.run(x).numpy(), want, **TOL)
    np.testing.assert_allclose(tsim.reference_fc(x, wts).numpy(), jsim.reference_fc(x, wts), **TOL)
    assert dataclasses.asdict(tsim_.ev) == dataclasses.asdict(jsim_.ev) \
        == dataclasses.asdict(tsim.fc_events(tl, T_ARCH.replace(**arch)))
    with pytest.raises(ValueError, match="FC input shape"):
        tsim_.run(x[:-1])


def test_com_grid_sim_from_program_and_checks():
    arch = T_ARCH.replace(n_c=8, n_m=8)
    tp = tprog.compile_program(tprog.Workload("mb", (
        tmap.ConvSpec("c0", 3, 3, 12, 8, 8), tmap.ConvSpec("c1", 3, 12, 10, 8, 8))), arch)
    lp = tp.layer_programs[1]
    assert lp.c_blocks > 1 and lp.m_blocks > 1
    L = lp.layer
    rng = np.random.default_rng(7)
    wts = rng.normal(size=(L.k, L.k, L.c_in, L.c_out))
    x = rng.normal(size=(L.h_in, L.w_in, L.c_in))
    sim = tsim.COMGridSim.from_program(tp, L.name, wts, device="cpu")
    assert sim.program is tp
    np.testing.assert_allclose(sim.run(x).numpy(), tsim.reference_conv(x, wts, L).numpy(), **TOL)
    assert dataclasses.asdict(sim.ev) == dict(lp.events)
    with pytest.raises(ValueError, match="weights shape"):
        tsim.COMGridSim(L, wts[..., :-1], device="cpu")
    with pytest.raises(ValueError, match="conflicting architectures"):
        tsim.COMGridSim(L, wts, T_ARCH, program=tp, device="cpu")
    with pytest.raises(KeyError):
        tsim.COMGridSim(tmap.FCSpec("absent", 4, 4), np.zeros((4, 4)), program=tp,
                        device="cpu")


def test_the_card_is_the_default_device():
    """``COMGridSim`` and ``DominoModel.functional_forward`` run on the card
    unless told otherwise: without one they raise, never fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there (tests/test_torch_gpu.py)")
    layer = tmap.FCSpec("f", 4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsim.COMGridSim(layer, np.zeros((4, 4)))
    model = tsim.DominoModel([layer])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.functional_forward(np.zeros((1, 4)), [np.zeros((4, 4))])
    with pytest.raises(ValueError, match="backend='cuda'"):
        model.functional_forward(np.zeros((1, 4)), [np.zeros((4, 4))], device="cpu")


def test_functional_forward_reference_matches_the_reference_model():
    """The float64 ``"reference"`` backend through ``DominoModel`` against
    the JAX package's ``"numpy"`` backend through its ``DominoModel``, on a
    multi-block workload (tests/test_executor.py:79's rtol 1e-9)."""
    def layers(m):
        return [m.ConvSpec("c0", 3, 3, 12, 8, 8, pool_k=2), m.ConvSpec("c1", 3, 12, 10, 4, 4),
                m.FCSpec("f0", 160, 20), m.FCSpec("f1", 20, 5)]

    small = dict(n_c=8, n_m=8)
    jm = jsim.DominoModel(layers(jmap), arch=J_ARCH.replace(**small))
    tm = tsim.DominoModel(layers(tmap), arch=T_ARCH.replace(**small))
    rng = np.random.default_rng(3)
    weights = [rng.normal(size=s) for s in
               ((3, 3, 3, 12), (3, 3, 12, 10), (160, 20), (20, 5))]
    images = rng.normal(size=(2, 8, 8, 3))
    want = jm.functional_forward(images, weights)
    got = tm.functional_forward(images, weights, backend="reference", device="cpu")
    np.testing.assert_allclose(got.outputs.numpy(), want.outputs, rtol=1e-9, atol=1e-12)
    assert dict(got.events) == dict(want.events) == dict(tm.program.event_totals)
