"""The port's mapping search (``repro_torch.search``) and the searched and
candidate compile paths against the JAX package's ``repro.search``.

The candidate space, the validators, the cost model and both engines are
host-side Python and NumPy float64 in the reference's order, so they are
held to it exactly: candidates and costs with ``==`` (as
benchmarks/search_bench.py's fidelity checks require), messages as equal
strings, allocations, blocks and events as equal integers. The reference
always searches with ``backend="numpy"`` here: its default ``"jax"`` backend
cannot be imported under this jax (``enable_x64``). The candidate does not
depend on the backend (the engines score only through NumPy ``costs``).
``PopulationEvaluator.columns`` with the ``"numpy"`` backend is held to the
reference bitwise; the torch backend (on the CPU) within
tests/test_sweep_backends.py:26's 1e-6. The searched program's
``"reference"`` logits are held to the greedy program's with
tests/test_search.py:290-292's rtol 1e-9 / atol 1e-12.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.executor as jex
import repro.core.mapping as jmap
import repro.core.program as jprog
import repro.core.simulator as jsim
import repro.search as js
import repro.search.space as jspace
import repro_torch.core.mapping as tmap
import repro_torch.core.program as tprog
import repro_torch.core.simulator as tsim
import repro_torch.search as ts
import repro_torch.search.space as tspace
from repro.core.arch import DEFAULT_ARCH as J_ARCH
from repro_torch.convert import candidate_to_port
from repro_torch.core.arch import DEFAULT_ARCH as T_ARCH
from repro_torch.sweep import make_torch_backend

# tests/test_search.py:37's small arch: tiny layers split into many blocks
# and chips
J_SMALL = J_ARCH.replace(n_c=16, n_m=16, tiles_per_chip=12)
T_SMALL = T_ARCH.replace(n_c=16, n_m=16, tiles_per_chip=12)
NETWORKS = sorted(tmap.NETWORKS)
TORCH_RTOL = 1e-6


def tiny_workload(m, prog, seed):
    """tests/test_search.py:40's random 2–4 layer conv/FC stack."""
    rng = np.random.default_rng(seed)
    c = int(rng.integers(3, 9))
    layers = []
    h = 8
    for i in range(int(rng.integers(1, 4))):
        c_out = int(rng.integers(4, 33))
        layers.append(m.ConvSpec(f"c{i}", 3, c, c_out, h, h,
                                 pool_k=2 if rng.random() < 0.3 else 0))
        c, h = c_out, layers[-1].h_out // (2 if layers[-1].pool_k else 1)
    layers.append(m.FCSpec("fc", c * h * h, int(rng.integers(4, 40))))
    return prog.Workload(f"tiny{seed}", tuple(layers))


def _pair(what):
    """(reference workload, port workload, reference arch, port arch)."""
    if what.startswith("tiny"):
        seed = int(what[4:])
        return (tiny_workload(jmap, jprog, seed), tiny_workload(tmap, tprog, seed),
                J_SMALL, T_SMALL)
    return jmap.NETWORKS[what](), tmap.NETWORKS[what](), J_ARCH, T_ARCH


def _alloc_key(allocs):
    return [(a.layer.name, a.n_tiles, a.grid, tuple(a.chip_ids), bool(a.crosses_chip))
            for a in allocs]


def _same_program(tp, jp):
    assert _alloc_key(tp.allocs) == _alloc_key(jp.allocs)
    assert (tp.n_tiles, tp.n_chips, tp.mapping) == (jp.n_tiles, jp.n_chips, jp.mapping)
    assert dict(tp.event_totals) == dict(jp.event_totals)
    for tl, jl in zip(tp.layer_programs, jp.layer_programs):
        assert (tl.c_blocks, tl.m_blocks) == (jl.c_blocks, jl.m_blocks)
        assert [(b.c_index, b.m_index, b.c_range, b.m_range, b.roles, b.n_tiles, b.is_last_c,
                 b.spec.c_in, b.spec.c_out) for b in tl.blocks] == \
            [(b.c_index, b.m_index, b.c_range, b.m_range, b.roles, b.n_tiles, b.is_last_c,
              b.spec.c_in, b.spec.c_out) for b in jl.blocks]
        assert dict(tl.events) == dict(jl.events)


def _raises(fn_j, fn_t, exc=ValueError):
    """Both raise ``exc`` with the same message (a module the message names
    is the port's own: ``repro_torch.`` for ``repro.``)."""
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc) as et:
        fn_t()
    assert str(et.value).replace("repro_torch.", "repro.") == str(ej.value)
    return str(et.value)


def _mutants(layers, arch, space, seed, n):
    """``n`` chained mutations of greedy from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    g = space.greedy_candidate(layers, arch)
    chips = space.candidate_n_chips(layers, arch, g)
    out, c = [], g
    for _ in range(n):
        c = space.mutate(c, layers, arch, rng, chips)
        out.append(c)
    return out


# ---------------------------------------------------------------------------
# the candidate space
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("network", NETWORKS)
def test_greedy_candidate_realizes_greedy_place(network):
    _, wl, _, arch = _pair(network)
    cand = ts.greedy_candidate(wl.layers, arch)
    allocs, starts = ts.candidate_allocs(wl.layers, arch, cand)
    assert list(allocs) == list(tmap.greedy_place(list(wl.layers), arch))
    assert list(allocs) == list(tprog.compile_program(wl, arch).allocs)
    jw = jmap.NETWORKS[network]()
    jc = js.greedy_candidate(jw.layers, J_ARCH)
    assert cand == candidate_to_port(jc)
    assert starts == js.candidate_allocs(jw.layers, J_ARCH, jc)[1]
    assert tspace.candidate_n_chips(wl.layers, arch, cand) == \
        jspace.candidate_n_chips(jw.layers, J_ARCH, jc)


@pytest.mark.parametrize("what", ["vgg11-cifar", "resnet18-cifar", "tiny0", "tiny3"])
@pytest.mark.parametrize("seed", [0, 5])
def test_mutate_and_allocs_equal_reference(what, seed):
    jw, tw, ja, ta = _pair(what)
    tm = _mutants(tw.layers, ta, tspace, seed, 12)
    jm = _mutants(jw.layers, ja, jspace, seed, 12)
    assert tm == [candidate_to_port(c) for c in jm]
    for tc, jc in zip(tm, jm):
        tallocs, tstarts = tspace.candidate_allocs(tw.layers, ta, tc)
        jallocs, jstarts = jspace.candidate_allocs(jw.layers, ja, jc)
        assert _alloc_key(tallocs) == _alloc_key(jallocs) and tstarts == jstarts


@pytest.mark.parametrize("pos", [0, 1, 239, 240, 241, 500, 959])
def test_noc_geometry_equals_reference(pos):
    for arch_t, arch_j in ((T_ARCH, J_ARCH), (T_SMALL, J_SMALL)):
        assert tspace.grid_cols(arch_t) == jspace.grid_cols(arch_j)
        assert tspace.tile_coords(pos, arch_t) == jspace.tile_coords(pos, arch_j)
        for other in (0, pos + 1, pos + 17):
            assert tspace.tile_distance(pos, other, arch_t) == \
                jspace.tile_distance(pos, other, arch_j)


# ---------------------------------------------------------------------------
# the validators' messages
# ---------------------------------------------------------------------------

def _bad_alloc(m, space, which):
    arch = J_ARCH if space is jspace else T_ARCH
    allocs = list(m.greedy_place(list(m.vgg11_cifar().layers), arch))
    a = allocs[0]
    if which == "overflow":
        return lambda: space.validate_alloc(dataclasses.replace(
            a, n_tiles=10 * arch.tiles_per_chip, grid=(10, arch.tiles_per_chip, 1)), arch)
    if which == "grid":
        return lambda: space.validate_alloc(dataclasses.replace(a, grid=(0, 1, 1)), arch)
    if which == "chips":
        return lambda: space.validate_alloc(dataclasses.replace(a, chip_ids=(0, 2)), arch)
    if which == "overlap":
        return lambda: space.validate_allocs(allocs, arch, starts=[0] * len(allocs))
    if which == "mismatch":
        allocs[1] = dataclasses.replace(allocs[1], chip_ids=(3,))
        return lambda: space.validate_allocs(allocs, arch)
    return lambda: space.validate_allocs(allocs, arch, starts=[0])


@pytest.mark.parametrize("which", ["overflow", "grid", "chips", "overlap", "mismatch", "starts"])
def test_validate_allocs_messages_equal(which):
    _raises(_bad_alloc(jmap, jspace, which), _bad_alloc(tmap, tspace, which))


@pytest.mark.parametrize("ranges_c,ranges_m", [
    ([(0, 8), (9, 16)], [(0, 16)]),
    ([(0, 8), (7, 16)], [(0, 16)]),
    ([(0, 16)], [(0, 16)]),
    ([(0, 8), (8, 16)], [(0, 8), (8, 8)]),
    ([(0, 8), (8, 12)], [(0, 16)]),
], ids=["gap", "overlap", "count", "empty", "short"])
def test_validate_blocks_messages_equal(ranges_c, ranges_m):
    jl, tl = jmap.ConvSpec("c", 3, 16, 16, 4, 4), tmap.ConvSpec("c", 3, 16, 16, 4, 4)
    _raises(lambda: jspace.validate_blocks(jl, 8, 8 if len(ranges_m) > 1 else 16,
                                           ranges_c, ranges_m),
            lambda: tspace.validate_blocks(tl, 8, 8 if len(ranges_m) > 1 else 16,
                                           ranges_c, ranges_m))


BAD_CANDIDATES = {
    "gap": lambda g: dict(gaps=(-1,) + g.gaps[1:]),
    "block_c": lambda g: dict(block_c=(17,) + g.block_c[1:]),
    "block_m": lambda g: dict(block_m=(0,) + g.block_m[1:]),
    "order": lambda g: dict(order=("zigzag",) + g.order[1:]),
    "rot": lambda g: dict(egress_rot=(5,) + g.egress_rot[1:]),
    "length": lambda g: dict(gaps=g.gaps + (0,)),
    "budget": None,
}


@pytest.mark.parametrize("which", sorted(BAD_CANDIDATES))
def test_validate_candidate_messages_equal(which):
    jw, tw, ja, ta = _pair("tiny0")
    jg, tg = js.greedy_candidate(jw.layers, ja), ts.greedy_candidate(tw.layers, ta)
    ts.validate_candidate(tw.layers, ta, tg)
    if which == "budget":
        _raises(lambda: js.validate_candidate(jw.layers, ja, jg, max_chips=0),
                lambda: ts.validate_candidate(tw.layers, ta, tg, max_chips=0))
        return
    jc = dataclasses.replace(jg, **BAD_CANDIDATES[which](jg))
    tc = dataclasses.replace(tg, **BAD_CANDIDATES[which](tg))
    _raises(lambda: js.validate_candidate(jw.layers, ja, jc),
            lambda: ts.validate_candidate(tw.layers, ta, tc))


# ---------------------------------------------------------------------------
# the cost model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", NETWORKS + ["tiny1", "tiny4"])
def test_mapping_cost_equals_reference(what):
    jw, tw, ja, ta = _pair(what)
    tc = [ts.greedy_candidate(tw.layers, ta)] + _mutants(tw.layers, ta, tspace, 3, 6)
    jc = [js.greedy_candidate(jw.layers, ja)] + _mutants(jw.layers, ja, jspace, 3, 6)
    for t, j in zip(tc, jc):
        got, want = ts.mapping_cost(tw.layers, ta, t), js.mapping_cost(jw.layers, ja, j)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.objective == want.objective and got.hop_energy_pj == want.hop_energy_pj


def test_greedy_cost_is_the_committed_baseline():
    wl = tmap.vgg16_imagenet()
    cost = ts.mapping_cost(wl.layers, T_ARCH, ts.greedy_candidate(wl.layers, T_ARCH))
    program = tprog.compile_program(wl)
    model = tsim.DominoModel(program)
    tot = program.event_totals
    assert cost.link_pj == (tot["ps_bits"] + tot["ifm_bits"]) \
        * T_ARCH.energy.link_pj_per_bit * T_ARCH.energy_scale()
    assert cost.offchip_pj == model.offchip_energy_img_j() * 1e12
    assert cost.steady_cycles == model.bottleneck_px()
    assert (cost.n_tiles, cost.n_chips) == (program.n_tiles, program.n_chips)


def test_chain_order_zeroes_single_chip_transit():
    layers = (tmap.ConvSpec("solo", 3, 32, 32, 8, 8),)
    arch = T_ARCH.replace(n_c=8, n_m=8, tiles_per_chip=400)
    g = ts.greedy_candidate(layers, arch)
    chain = dataclasses.replace(g, order=("chain",))
    block_cost, chain_cost = ts.mapping_cost(layers, arch, g), ts.mapping_cost(layers, arch, chain)
    assert block_cost.transit_pj > 0 and chain_cost.transit_pj == 0.0
    assert chain_cost.base_pj == block_cost.base_pj


# ---------------------------------------------------------------------------
# the engines and search_mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["anneal", "evolve"])
@pytest.mark.parametrize("what,seed,budget", [("tiny0", 0, 16), ("tiny2", 11, 24),
                                              ("tiny5", 3, 40), ("vgg11-cifar", 1, 48)])
def test_engines_equal_reference(engine, what, seed, budget):
    jw, tw, ja, ta = _pair(what)
    want = js.ENGINES[engine](jw.layers, ja, budget=budget, seed=seed,
                              evaluator=js.PopulationEvaluator(jw.layers, ja, backend="numpy"))
    ev = ts.PopulationEvaluator(tw.layers, ta, backend="numpy")
    got = ts.ENGINES[engine](tw.layers, ta, budget=budget, seed=seed, evaluator=ev)
    assert got.candidate == candidate_to_port(want.candidate)
    assert dataclasses.asdict(got.cost) == dataclasses.asdict(want.cost)
    assert dataclasses.asdict(got.greedy_cost) == dataclasses.asdict(want.greedy_cost)
    assert (got.engine, got.evaluations, got.history) == \
        (want.engine, want.evaluations, want.history)
    assert ev.evaluations == got.evaluations <= budget
    assert got.cost.objective <= got.greedy_cost.objective
    ts.validate_candidate(tw.layers, ta, got.candidate,
                          tspace.candidate_n_chips(tw.layers, ta, ts.greedy_candidate(tw.layers, ta)))


@pytest.mark.parametrize("engine", ["anneal", "evolve"])
def test_vgg16_search_equals_reference(engine):
    """benchmarks/search_bench.py's CI recipe: VGG-16 on DEFAULT_ARCH,
    budget 96, seed 0."""
    want = js.search_mapping(jmap.vgg16_imagenet(), budget=96, engine=engine, seed=0,
                             backend="numpy")
    got = ts.search_mapping(tmap.vgg16_imagenet(), budget=96, engine=engine, seed=0)
    assert got.candidate == candidate_to_port(want.candidate)
    assert got.cost.objective == want.cost.objective
    assert got.history == want.history and got.energy_ratio == want.energy_ratio < 1.0
    # the searched VGG-16 candidates keep greedy's blocking
    g = ts.greedy_candidate(tmap.vgg16_imagenet().layers, T_ARCH)
    assert (got.candidate.block_c, got.candidate.block_m) == (g.block_c, g.block_m)


def test_search_result_does_not_depend_on_the_backend():
    wl = tiny_workload(tmap, tprog, 3)
    runs = [ts.search_mapping(wl, T_SMALL, budget=32, seed=2, backend=b)
            for b in ("torch", "numpy", make_torch_backend("cpu"))]
    assert runs[0].candidate == runs[1].candidate == runs[2].candidate
    assert runs[0].cost == runs[1].cost == runs[2].cost
    assert runs[0] is ts.search_mapping(wl, T_SMALL, budget=32, seed=2)  # memoized


def test_search_mapping_validates_args_like_reference():
    jw, tw = jmap.vgg11_cifar(), tmap.vgg11_cifar()
    _raises(lambda: js.search_mapping(jw, budget=0, backend="numpy"),
            lambda: ts.search_mapping(tw, budget=0))
    _raises(lambda: js.search_mapping(jw, budget=4, engine="bogus", backend="numpy"),
            lambda: ts.search_mapping(tw, budget=4, engine="bogus"))
    # the port's registry lists its own backends ("numpy", "torch")
    with pytest.raises(ValueError, match="unknown sweep backend 'bogus'; available: "
                                         r"\['numpy', 'torch'\]"):
        ts.PopulationEvaluator(tw.layers, backend="bogus")
    _raises(lambda: js.PopulationEvaluator(jw.layers, backend="numpy", dataflow="bogus"),
            lambda: ts.PopulationEvaluator(tw.layers, dataflow="bogus"))


# ---------------------------------------------------------------------------
# PopulationEvaluator.columns through the sweep backends
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dataflow", ["com", "minimal_buffer"])
@pytest.mark.parametrize("what", ["vgg16-imagenet", "tiny2"])
def test_population_columns_equal_reference(what, dataflow):
    jw, tw, ja, ta = _pair(what)
    tc = [ts.greedy_candidate(tw.layers, ta)] + _mutants(tw.layers, ta, tspace, 9, 5)
    jc = [js.greedy_candidate(jw.layers, ja)] + _mutants(jw.layers, ja, jspace, 9, 5)
    want = js.PopulationEvaluator(jw.layers, ja, backend="numpy", dataflow=dataflow).columns(jc)
    got = ts.PopulationEvaluator(tw.layers, ta, backend="numpy", dataflow=dataflow).columns(tc)
    assert set(got) == set(want)
    for c in want:
        assert np.array_equal(got[c], want[c]), c
    cpu = ts.PopulationEvaluator(tw.layers, ta, backend=make_torch_backend("cpu"),
                                 dataflow=dataflow)
    costs, cols = cpu.evaluate(tc)
    assert cpu.evaluations == len(tc)
    for c in want:
        err = np.max(np.abs(cols[c] - want[c]) / np.maximum(np.abs(want[c]), 1e-300))
        assert cols[c].shape == (len(tc),) and err <= TORCH_RTOL, (c, err)


# ---------------------------------------------------------------------------
# LayerTable and the candidate blocking of batched_layer_events
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", NETWORKS + ["tiny3"])
def test_layer_table_and_candidate_events_equal_reference(what):
    jw, tw, ja, ta = _pair(what)
    jt, tt = jsim.layer_table(tuple(jw.layers)), tsim.layer_table(tuple(tw.layers))
    assert tt.n_layers == jt.n_layers == len(tw.layers)
    assert np.array_equal(tt.ops, jt.ops) and tt.ops.dtype == jt.ops.dtype
    L = tt.n_layers
    rng = np.random.default_rng(L)
    nc = rng.integers(1, ta.n_c + 1, size=(4, L))
    nm = rng.integers(1, ta.n_m + 1, size=(4, L))
    for kw in (dict(), dict(n_c_eff=nc[0], n_m_eff=nm[0]), dict(n_c_eff=nc, n_m_eff=nm),
               dict(n_c_eff=nc[1])):
        got = tsim.batched_layer_events(tt, ta, **kw)
        want = jsim.batched_layer_events(jt, ja, **kw)
        assert set(got) == set(want)
        for f in want:
            assert np.array_equal(got[f], want[f]) and got[f].shape == want[f].shape, f


# ---------------------------------------------------------------------------
# compile_program(mapping=candidate | "searched")
# ---------------------------------------------------------------------------

def _custom_blocking(layers, space, arch):
    """tests/test_search.py:265-276: halve block_c of the widest layer."""
    g = space.greedy_candidate(layers, arch)
    bc = list(g.block_c)
    i = max(range(len(bc)), key=lambda j: layers[j].c_in)
    bc[i] = max(1, bc[i] // 2)
    return dataclasses.replace(g, block_c=tuple(bc))


@pytest.mark.parametrize("what", ["tiny0", "tiny6", "vgg11-cifar", "vgg16-imagenet"])
def test_candidate_program_equals_reference(what):
    jw, tw, ja, ta = _pair(what)
    jc = _custom_blocking(jw.layers, jspace, ja)
    tc = _custom_blocking(tw.layers, tspace, ta)
    assert tc == candidate_to_port(jc)
    tp = tprog.compile_program(tw, ta, mapping=tc)
    _same_program(tp, jprog.compile_program(jw, ja, mapping=jc))
    assert tp is tprog.compile_program(tw, ta, mapping=tc)
    assert tp.candidate == tc and tp.n_tiles > tprog.compile_program(tw, ta).n_tiles
    # a mutated candidate, too
    tm = _mutants(tw.layers, ta, tspace, 4, 8)[-1]
    jm = _mutants(jw.layers, ja, jspace, 4, 8)[-1]
    _same_program(tprog.compile_program(tw, ta, mapping=tm),
                  jprog.compile_program(jw, ja, mapping=jm))


@pytest.mark.parametrize("what", ["tiny2", "vgg11-cifar"])
def test_searched_program_equals_reference(what):
    jw, tw, ja, ta = _pair(what)
    tp = tprog.compile_program(tw, ta, mapping="searched")
    want = js.search_mapping(jw, ja, backend="numpy")
    jp = jprog.compile_program(jw, ja, mapping=want.candidate)
    assert tp.mapping == "searched" and tp.candidate == candidate_to_port(want.candidate)
    assert tp.candidate == ts.search_mapping(tw, ta).candidate
    _same_program(tp, jp)


def test_illegal_candidate_and_dispatch_errors_equal_reference():
    jw, tw, ja, ta = _pair("tiny0")
    jg, tg = js.greedy_candidate(jw.layers, ja), ts.greedy_candidate(tw.layers, ta)
    _raises(lambda: jprog.compile_program(jw, ja, mapping=dataclasses.replace(jg, gaps=(-1,) * len(jg.gaps))),
            lambda: tprog.compile_program(tw, ta, mapping=dataclasses.replace(tg, gaps=(-1,) * len(tg.gaps))))
    for bad in ("bogus", object(), 3):
        msg = _raises(lambda: jprog.compile_program(jw, ja, mapping=bad),
                      lambda: tprog.compile_program(tw, ta, mapping=bad))
        assert "unknown mapping" in msg
    # a reference candidate is not the port's: convert it by its fields
    with pytest.raises(ValueError, match="unknown mapping"):
        tprog.compile_program(tw, ta, mapping=jg)


def test_custom_blocked_program_executes_on_the_cpu():
    """tests/test_search.py:265-298 on the port's "reference" executor: a
    different blocking reorders float64 sums only; the events are the
    custom program's own closed forms."""
    jw, tw, ja, ta = _pair("tiny0")
    tc = _custom_blocking(tw.layers, tspace, ta)
    pg, ps = tprog.compile_program(tw, ta), tprog.compile_program(tw, ta, mapping=tc)
    weights = jex.random_weights(jprog.compile_program(jw, ja), seed=0)
    ref = pg.executor(weights, backend="reference", device="cpu")
    imgs = np.random.default_rng(1).normal(size=(2,) + ref.input_shape)
    got_g = ref.run(imgs)
    got_s = ps.execute(imgs, weights, backend="reference", device="cpu")
    np.testing.assert_allclose(got_s.outputs.numpy(), got_g.outputs.numpy(), rtol=1e-9,
                               atol=1e-12)
    assert got_s.events == dict(ps.event_totals) != dict(pg.event_totals)
    # and against the JAX package's NumPy oracle on the same candidate
    jp = jprog.compile_program(jw, ja, mapping=_custom_blocking(jw.layers, jspace, ja))
    np.testing.assert_allclose(got_s.outputs.numpy(),
                               jp.execute(imgs, weights, backend="numpy").outputs,
                               rtol=1e-9, atol=1e-12)


def test_cache_stats_reports_the_reference_keys():
    import repro.core as jcore
    import repro.dataflows  # noqa: F401
    import repro.faults  # noqa: F401
    import repro.sweep  # noqa: F401
    import repro_torch.core as tcore
    import repro_torch.dataflows  # noqa: F401
    import repro_torch.faults  # noqa: F401
    import repro_torch.sweep  # noqa: F401

    got, want = tcore.cache_stats(), jcore.cache_stats()
    assert set(got) == set(want)
    assert {"compile_program", "compile_candidate", "compile_faulted", "search_mapping",
            "chip_segments", "layer_table"} <= set(got)
    assert got["search_mapping"].maxsize == want["search_mapping"].maxsize == 64


@pytest.mark.parametrize("network", NETWORKS)
def test_mapping_shims_equal_reference(network):
    jw, tw, _, _ = _pair(network)
    with pytest.warns(DeprecationWarning, match="map_network"):
        allocs = tmap.map_network(list(tw.layers))
    assert allocs == list(tprog.compile_program(tw).allocs)
    assert tmap.map_network_cached(tuple(tw.layers)) is tprog.compile_program(tw).allocs
    with pytest.warns(DeprecationWarning):
        assert _alloc_key(allocs) == _alloc_key(jmap.map_network(list(jw.layers)))
    for bits in (8, 4, 16):
        assert tmap.weight_bytes(list(tw.layers), bits) == jmap.weight_bytes(list(jw.layers), bits)
