"""The port's fault model, fault-aware placement and weight-fault injection
(``repro_torch.faults``) against the JAX package's ``repro.faults``.

Everything here is host-side Python and NumPy in the reference's order, so
it is held to the reference exactly: fault sets field by field, placements
and events as equal integers, error messages as equal strings, faulted
weights byte for byte (``np.array_equal`` on float64) with equal ``info``.
The port's ``"reference"`` executor on faulted weights is held to the JAX
package's NumPy oracle with tests/test_executor.py:79's rtol 1e-9 /
atol 1e-12. Reference objects carry over to the port's classes by their
fields (``repro_torch.convert.faultset_to_port``); the two are never mixed.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.executor as jex
import repro.core.mapping as jmap
import repro.core.program as jprog
import repro.faults as jf
import repro.search.space as jspace
import repro_torch.core.executor as tex
import repro_torch.core.mapping as tmap
import repro_torch.core.program as tprog
import repro_torch.faults as tf
import repro_torch.search.space as tspace
from repro.core.arch import DEFAULT_ARCH as J_ARCH
from repro_torch.convert import faultset_to_port
from repro_torch.core.arch import DEFAULT_ARCH as T_ARCH

TPC = T_ARCH.tiles_per_chip
NETWORKS = sorted(tmap.NETWORKS)


def _tiny(m):
    """tests/test_faults.py:47's conv(pool)→FC workload."""
    return m.ConvSpec("t.c0", 3, 3, 8, 8, 8, pool_k=2), m.FCSpec("t.fc", 128, 10)


def _multiblock(m):
    """A conv→conv→FC→FC chain with C > n_c and M > n_m at n_c = n_m = 8."""
    return m.ConvSpec("c0", 3, 3, 12, 8, 8, pool_k=2), m.ConvSpec("c1", 3, 12, 10, 4, 4), \
        m.FCSpec("f0", 160, 20), m.FCSpec("f1", 20, 5)


def _raises(fn_j, fn_t, exc=ValueError):
    """Both calls raise ``exc`` with the same message (where a message names
    a module, the port names its own: ``repro_torch.`` for ``repro.``);
    returns it."""
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc) as et:
        fn_t()
    assert type(et.value).__name__ == type(ej.value).__name__
    assert str(et.value).replace("repro_torch.", "repro.") == str(ej.value)
    return str(et.value)


def _fields(fs):
    return {f.name: getattr(fs, f.name) for f in dataclasses.fields(fs) if f.name != "arch"}


def _same_faultset(t, j):
    tj = _fields(faultset_to_port(j))
    assert _fields(t) == tj
    assert t == faultset_to_port(j) and hash(t) == hash(faultset_to_port(j))


def _alloc_key(allocs):
    return [(a.layer.name, a.n_tiles, a.grid, tuple(a.chip_ids), bool(a.crosses_chip))
            for a in allocs]


# ---------------------------------------------------------------------------
# the FaultSet model
# ---------------------------------------------------------------------------

BAD_FAULTSETS = [
    dict(dead_tiles=(-1,)),
    dict(dead_links=(-2,)),
    dict(dead_links=(TPC - 1,)),
    dict(dead_links=(2 * TPC - 1, 5)),
    dict(dead_chips=(-1,)),
    dict(n_chips=0),
    dict(cell_rate=1.0),
    dict(cell_rate=-0.1),
    dict(weight_faults=("bogus",)),
    dict(weight_faults=(-1, 0)),
    dict(dead_blocks=(0, -1, 0, 0)),
    dict(dead_tiles=(-3,), n_chips=0, cell_rate=2.0),
]


def _kwargs(m, kw):
    kw = dict(kw)
    if "weight_faults" in kw:
        wf = kw["weight_faults"]
        kw["weight_faults"] = ((m.WeightFault(0, 0, kind=wf[0]),) if isinstance(wf[0], str)
                               else (m.WeightFault(*wf),))
    if "dead_blocks" in kw:
        kw["dead_blocks"] = (m.BlockFault(*kw["dead_blocks"]),)
    return kw


@pytest.mark.parametrize("kw", BAD_FAULTSETS, ids=lambda kw: ",".join(kw))
def test_faultset_validation_messages_equal(kw):
    msg = _raises(lambda: jf.FaultSet(**_kwargs(jf, kw)), lambda: tf.FaultSet(**_kwargs(tf, kw)))
    assert msg.startswith("invalid FaultSet:")


def test_faultset_canonicalizes_and_empty():
    kw = dict(dead_tiles=(5, 3, 5), dead_links=(7, 1, 7), dead_chips=(2, 0, 2),
              weight_faults=[(0, 3, "flip")], dead_blocks=[(1, 0, 0, 0)])
    mk = lambda m: m.FaultSet(  # noqa: E731
        **{**kw, "weight_faults": [m.WeightFault(*w) for w in kw["weight_faults"]],
           "dead_blocks": [m.BlockFault(*b) for b in kw["dead_blocks"]]})
    t, j = mk(tf), mk(jf)
    _same_faultset(t, j)
    assert t.dead_tiles == (3, 5) and isinstance(t.weight_faults, tuple)
    for m in (tf, jf):
        e = m.FaultSet.empty()
        assert e.is_empty and not e.has_workload_faults
        # arch is left out of equality (compare=False)
        assert e == m.FaultSet.empty(e.arch.replace(n_c=8))
    assert tf.FaultSet(cell_rate=0.1).has_workload_faults
    assert not tf.FaultSet(dead_tiles=(0,)).has_workload_faults
    assert not tf.FaultSet(n_chips=3).is_empty


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("rate", [0.0, 0.01, 0.05])
def test_sample_equals_reference_and_nests(seed, rate):
    t = tf.FaultSet.sample(rate, seed, n_chips=12, cell_rate=rate / 2)
    j = jf.FaultSet.sample(rate, seed, n_chips=12, cell_rate=rate / 2)
    _same_faultset(t, j)
    hi = tf.FaultSet.sample(rate + 0.03, seed, n_chips=12)
    assert set(t.dead_tiles) <= set(hi.dead_tiles)
    assert set(t.dead_links) <= set(hi.dead_links)
    assert set(t.dead_chips) <= set(hi.dead_chips)


@pytest.mark.parametrize("kw", [dict(tile_rate=0.1, link_rate=0.0, chip_rate=0.2, bounded=False),
                                dict(arch="small", n_chips=20)], ids=["sub-rates", "small-arch"])
def test_sample_options_equal_reference(kw):
    kw_t, kw_j = dict(kw), dict(kw)
    if kw.get("arch") == "small":
        kw_t["arch"] = T_ARCH.replace(n_c=16, n_m=16, tiles_per_chip=12)
        kw_j["arch"] = J_ARCH.replace(n_c=16, n_m=16, tiles_per_chip=12)
    t, j = tf.FaultSet.sample(0.08, 5, **kw_t), jf.FaultSet.sample(0.08, 5, **kw_j)
    assert _fields(t) == _fields(faultset_to_port(j, kw_t.get("arch")))


def test_sample_rejects_rate_like_reference():
    _raises(lambda: jf.FaultSet.sample(1.0, 0), lambda: tf.FaultSet.sample(1.0, 0))


SEGMENT_CASES = [
    dict(dead_tiles=(0, 5, TPC + 3), dead_links=(10, TPC + 20), dead_chips=(2,)),
    dict(dead_tiles=tuple(range(0, TPC, 7)), n_chips=3),
    dict(dead_links=(0, TPC - 2, 2 * TPC + 100)),
    dict(),
]


@pytest.mark.parametrize("case", range(len(SEGMENT_CASES)))
def test_geometry_equals_reference(case):
    kw = SEGMENT_CASES[case]
    t, j = tf.FaultSet(**kw), jf.FaultSet(**kw)
    for chip in range(4):
        assert tf.chip_segments(t, chip) == jf.chip_segments(j, chip)
        assert tf.usable_tiles(t, chip) == jf.usable_tiles(j, chip)
    assert tf.fleet_capacity(t, 4) == jf.fleet_capacity(j, 4)
    for start, n in [(0, 1), (0, TPC), (3, 12), (TPC - 5, 10), (2 * TPC, TPC + 1), (9, 200)]:
        assert tf.span_conflicts(start, n, t) == jf.span_conflicts(start, n, j)


# ---------------------------------------------------------------------------
# fault-aware placement
# ---------------------------------------------------------------------------

# VGG-16 at rate 0.05 outgrows 40 chips: the first case leaves the fleet
# unbounded (spares past the sampled chips are pristine)
PLACE_FAULTS = [dict(rate=0.05, seed=3, n_chips=40, bounded=False),
                dict(rate=0.01, seed=11, n_chips=60)]


@pytest.mark.parametrize("network", NETWORKS)
@pytest.mark.parametrize("fcase", [0, 1])
def test_fault_place_equals_reference(network, fcase):
    t = tf.FaultSet.sample(**PLACE_FAULTS[fcase])
    j = jf.FaultSet.sample(**PLACE_FAULTS[fcase])
    ta = tf.fault_place(list(tmap.NETWORKS[network]().layers), T_ARCH, t)
    ja = jf.fault_place(list(jmap.NETWORKS[network]().layers), J_ARCH, j)
    assert _alloc_key(ta) == _alloc_key(ja)
    assert tf.degraded_chips(ta) == jf.degraded_chips(ja)
    tf.validate_fault_allocs(ta, T_ARCH, t)
    tspace.validate_allocs(ta, T_ARCH, faults=t)
    assert all(c not in t.dead_chips for a in ta for c in a.chip_ids)


def test_empty_faultset_places_pristine():
    layers = list(tmap.vgg16_imagenet().layers)
    assert _alloc_key(tf.fault_place(layers, T_ARCH, None)) == \
        _alloc_key(tmap.greedy_place(layers, T_ARCH))
    assert tmap.greedy_place(layers, T_ARCH, faults=tf.FaultSet.empty()) == \
        tmap.greedy_place(layers, T_ARCH)


@pytest.mark.parametrize("case", ["vgg16-rate-0.01", "vgg11-one-chip", "tiny-dead-chip"])
def test_capacity_error_message_equals_reference(case):
    if case == "vgg16-rate-0.01":
        # 15 chips = VGG-16's pristine 9 plus faults_bench.py's 6 spares
        mk = lambda m, f: (m.vgg16_imagenet(), f.FaultSet.sample(0.01, 0, n_chips=15))  # noqa: E731
    elif case == "vgg11-one-chip":
        mk = lambda m, f: (m.vgg11_cifar(), f.FaultSet.sample(0.0, 0, n_chips=1))  # noqa: E731
    else:
        mk = lambda m, f: (m.vgg11_cifar(), f.FaultSet(dead_chips=(1,), n_chips=2))  # noqa: E731
    wl_j, fs_j = mk(jmap, jf)
    wl_t, fs_t = mk(tmap, tf)
    with pytest.raises(jf.FaultCapacityError) as ej:
        jprog.compile_program(wl_j, faults=fs_j)
    with pytest.raises(tf.FaultCapacityError) as et:
        tprog.compile_program(wl_t, faults=fs_t)
    msg = str(et.value)
    assert msg == str(ej.value) and isinstance(et.value, ValueError)
    if case == "vgg16-rate-0.01":
        assert "1811 usable tiles" in msg


def _tamper(m, f, which):
    layers = list(m.vgg11_cifar().layers)
    fs = f.FaultSet(dead_chips=(1,), dead_tiles=(3,))
    allocs = f.fault_place(layers, fs.arch, fs)
    a = allocs[1]
    if which == "dead-chip":
        allocs[1] = dataclasses.replace(a, chip_ids=(1,))
    elif which == "crossing":
        allocs[1] = dataclasses.replace(a, crosses_chip=not a.crosses_chip)
    elif which == "order":
        allocs[1] = dataclasses.replace(a, chip_ids=(2, 0))
    elif which == "tiles":
        allocs[1] = dataclasses.replace(a, n_tiles=a.n_tiles + 1)
    else:
        allocs[1] = dataclasses.replace(a, chip_ids=())
    return lambda: f.validate_fault_allocs(allocs, fs.arch, fs)


@pytest.mark.parametrize("which", ["dead-chip", "crossing", "order", "tiles", "empty"])
def test_validate_fault_allocs_messages_equal(which):
    msg = _raises(_tamper(jmap, jf, which), _tamper(tmap, tf, which))
    assert msg.startswith("invalid degraded placement:")


def test_validators_learn_the_fault_vocabulary_like_reference():
    def run(m, space, f):
        prog = (jprog if m is jmap else tprog).compile_program(m.vgg11_cifar())
        layers, arch = list(prog.workload.layers), prog.arch
        cand = space.greedy_candidate(layers, arch)
        space.validate_candidate(layers, arch, cand)
        out = []
        for fs in (f.FaultSet(dead_tiles=(0,)), f.FaultSet(dead_chips=(0,), dead_links=(7,)),
                   f.FaultSet(n_chips=1)):
            with pytest.raises(ValueError) as e:
                space.validate_candidate(layers, arch, cand, faults=fs)
            out.append(str(e.value))
        with pytest.raises(ValueError) as e:
            space.validate_allocs(prog.allocs, arch, starts=(0,) * len(prog.allocs),
                                  faults=f.FaultSet(dead_tiles=(0,)))
        return out + [str(e.value)]

    got, want = run(tmap, tspace, tf), run(jmap, jspace, jf)
    assert got == want and all("fault" in g or "starts" in g for g in got)


# ---------------------------------------------------------------------------
# compile_program(faults=...)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("network", NETWORKS)
def test_empty_and_none_are_the_same_cached_program(network):
    wl = tmap.NETWORKS[network]()
    p0 = tprog.compile_program(wl)
    assert tprog.compile_program(wl, faults=tf.FaultSet.empty()) is p0
    assert tprog.compile_program(wl, faults=None) is p0
    assert tprog.compile_program(wl, faults=tf.FaultSet.empty(T_ARCH.replace(n_c=8))) is p0
    assert p0.faults is None and p0.mapping == "greedy" and p0.candidate is None


@pytest.mark.parametrize("network", NETWORKS)
def test_faulted_program_equals_reference(network):
    t = tf.FaultSet.sample(**PLACE_FAULTS[0])
    j = jf.FaultSet.sample(**PLACE_FAULTS[0])
    tp = tprog.compile_program(tmap.NETWORKS[network](), faults=t)
    jp = jprog.compile_program(jmap.NETWORKS[network](), faults=j)
    assert tp is tprog.compile_program(tmap.NETWORKS[network](), faults=t)
    assert tp.faults == t and tp.mapping == "greedy"
    assert _alloc_key(tp.allocs) == _alloc_key(jp.allocs)
    assert tp.n_chips == jp.n_chips and tp.n_tiles == jp.n_tiles
    assert dict(tp.event_totals) == dict(jp.event_totals) == \
        dict(tprog.compile_program(tmap.NETWORKS[network]()).event_totals)
    for tl, jl in zip(tp.layer_programs, jp.layer_programs):
        assert (tl.c_blocks, tl.m_blocks) == (jl.c_blocks, jl.m_blocks)
        assert [(b.c_range, b.m_range, b.roles) for b in tl.blocks] == \
            [(b.c_range, b.m_range, b.roles) for b in jl.blocks]
        assert dict(tl.events) == dict(jl.events)


def test_faults_with_another_mapping_raise_like_reference():
    for mapping in ("searched", "search"):
        msg = _raises(
            lambda: jprog.compile_program(jmap.vgg11_cifar(), mapping=mapping,
                                          faults=jf.FaultSet(dead_tiles=(0,))),
            lambda: tprog.compile_program(tmap.vgg11_cifar(), mapping=mapping,
                                          faults=tf.FaultSet(dead_tiles=(0,))))
        assert "mapping" in msg


# ---------------------------------------------------------------------------
# weight faults: byte-identical to the reference's
# ---------------------------------------------------------------------------

INJECT_CASES = {
    "kinds": lambda f: f.FaultSet(weight_faults=(
        f.WeightFault(0, 0, "stuck0"), f.WeightFault(0, 1, "flip"), f.WeightFault(1, 2, "stuck1"),
        f.WeightFault(1, 9, "stuck1"), f.WeightFault(0, 215, "stuck0"))),
    "field": lambda f: f.FaultSet(cell_rate=0.02, cell_seed=7),
    "field-seed-3": lambda f: f.FaultSet(cell_rate=0.1, cell_seed=3),
    "blocks": lambda f: f.FaultSet(dead_blocks=(f.BlockFault(1, 0, 0, 0),
                                                f.BlockFault(0, 4, 0, 0))),
    "all": lambda f: f.FaultSet(cell_rate=0.05, cell_seed=1,
                                weight_faults=(f.WeightFault(1, 5, "flip"),),
                                dead_blocks=(f.BlockFault(0, 8, 0, 0),)),
}


def _inject_pair(case, workload, arch_kw=None):
    mk = {"tiny": _tiny, "multiblock": _multiblock}[workload]
    layers_j, layers_t = list(mk(jmap)), list(mk(tmap))
    arch_j, arch_t = J_ARCH.replace(**(arch_kw or {})), T_ARCH.replace(**(arch_kw or {}))
    w = jex.random_weights(layers_j, seed=0)
    fs_j = INJECT_CASES[case](jf)
    fs_t = faultset_to_port(fs_j, arch_t)
    assert fs_t == INJECT_CASES[case](tf)
    before = {k: v.copy() for k, v in w.items()}
    got, ginfo = tf.apply_weight_faults(layers_t, w, fs_t, arch_t)
    assert all(np.array_equal(w[k], before[k]) for k in w)  # inputs untouched
    want, winfo = jf.apply_weight_faults(layers_j, w, fs_j, arch_j)
    return got, ginfo, want, winfo


@pytest.mark.parametrize("case", sorted(INJECT_CASES))
@pytest.mark.parametrize("workload", ["tiny", "multiblock"])
def test_apply_weight_faults_byte_identical(case, workload):
    arch_kw = dict(n_c=8, n_m=8) if workload == "multiblock" else None
    got, ginfo, want, winfo = _inject_pair(case, workload, arch_kw)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype == np.float64 and g.shape == x.shape
        assert g.tobytes() == x.tobytes()
    assert ginfo == winfo
    assert ginfo["n_cells"] + ginfo["n_blocks"] > 0 and ginfo["mask_checksum"] > 0


def test_block_dropout_uses_the_committed_blocking():
    got, _, want, _ = _inject_pair("blocks", "multiblock", dict(n_c=8, n_m=8))
    # conv c1 (3x3x12x10) at n_c = n_m = 8: block (k 0, c 0, m 0) is kernel
    # pixel (0, 0), input channels 0:8, output channels 0:8
    assert np.all(got[1][0, 0, 0:8, 0:8] == 0.0) and np.any(got[1][0, 0, 8:, :] != 0.0)
    assert np.array_equal(got[1], want[1])


def test_vgg11_cell_field_byte_identical():
    layers_j, layers_t = list(jmap.vgg11_cifar().layers), list(tmap.vgg11_cifar().layers)
    w = jex.random_weights(layers_j, seed=2)
    got, ginfo = tf.apply_weight_faults(layers_t, w, tf.FaultSet(cell_rate=0.002, cell_seed=0),
                                        T_ARCH)
    want, winfo = jf.apply_weight_faults(layers_j, w, jf.FaultSet(cell_rate=0.002, cell_seed=0),
                                         J_ARCH)
    assert all(np.array_equal(g, x) for g, x in zip(got, want))
    assert ginfo == winfo and ginfo["n_cells"] > 10_000


@pytest.mark.parametrize("bad", ["cell-index", "cell-layer", "block-grid", "block-layer"])
def test_apply_weight_faults_errors_equal(bad):
    def fs(f):
        return {"cell-index": f.FaultSet(weight_faults=(f.WeightFault(1, 10_000),)),
                "cell-layer": f.FaultSet(weight_faults=(f.WeightFault(5, 0),)),
                "block-grid": f.FaultSet(dead_blocks=(f.BlockFault(1, 5, 0, 0),)),
                "block-layer": f.FaultSet(dead_blocks=(f.BlockFault(2, 0, 0, 0),))}[bad]
    w = jex.random_weights(list(_tiny(jmap)), seed=0)
    _raises(lambda: jf.apply_weight_faults(list(_tiny(jmap)), w, fs(jf), J_ARCH),
            lambda: tf.apply_weight_faults(list(_tiny(tmap)), w, fs(tf), T_ARCH))


# ---------------------------------------------------------------------------
# the executor on faulted weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["field", "all", "kinds"])
def test_faulted_reference_executor_matches_jax_numpy_oracle(case):
    jp = jprog.compile_program(jprog.Workload("tiny", _tiny(jmap)))
    tp = tprog.compile_program(tprog.Workload("tiny", _tiny(tmap)))
    w = jex.random_weights(jp, seed=0)
    fs_j = INJECT_CASES[case](jf)
    fs_t = faultset_to_port(fs_j)
    images = np.random.default_rng(0).normal(size=(2, 8, 8, 3))
    want = jex.ProgramExecutor(jp, w, backend="numpy", faults=fs_j)
    got = tex.ProgramExecutor(tp, w, backend="reference", device="cpu", faults=fs_t)
    assert got.fault_info == want.fault_info and got.faults == fs_t
    # the executor's weights are the realized faulted list, in the kernel layout
    faulted, _ = tf.apply_weight_faults(tp.workload.layers, w, fs_t, tp.arch)
    for t, x in zip(got.weights, faulted):
        assert np.array_equal(t.numpy().reshape(x.shape), x)
    out = got.run(images)
    np.testing.assert_allclose(out.outputs.numpy(), want.run(images).outputs,
                               rtol=1e-9, atol=1e-12)
    assert out.events == dict(tp.event_totals)
    # the clean run differs: the faults reached the logits
    clean = tex.ProgramExecutor(tp, w, backend="reference", device="cpu").run(images)
    assert not np.array_equal(clean.outputs.numpy(), out.outputs.numpy())


def test_executor_inherits_program_faults_and_empty_is_clean():
    tp = tprog.compile_program(tprog.Workload("tiny", _tiny(tmap)))
    w = jex.random_weights(list(_tiny(jmap)), seed=0)
    clean = tex.ProgramExecutor(tp, w, backend="reference", device="cpu")
    assert clean.faults is None and clean.fault_info is None
    empty = tex.ProgramExecutor(tp, w, backend="reference", device="cpu",
                                faults=tf.FaultSet.empty())
    assert empty.fault_info is None
    imgs = np.random.default_rng(1).normal(size=(1, 8, 8, 3))
    assert np.array_equal(empty.run(imgs).outputs.numpy(), clean.run(imgs).outputs.numpy())
    # a fault-compiled program's executor executes its FaultSet
    fs = tf.FaultSet(dead_tiles=(3,), n_chips=4, cell_rate=0.05, cell_seed=2)
    pf = tprog.compile_program(tp.workload, faults=fs)
    ex = pf.executor(w, backend="reference", device="cpu")
    jpf = jprog.compile_program(jprog.Workload("tiny", _tiny(jmap)),
                                faults=jf.FaultSet(dead_tiles=(3,), n_chips=4, cell_rate=0.05,
                                                   cell_seed=2))
    jx = jex.ProgramExecutor(jpf, w, backend="numpy")
    assert ex.faults == fs and ex.fault_info == jx.fault_info
    np.testing.assert_allclose(ex.run(imgs).outputs.numpy(), jx.run(imgs).outputs,
                               rtol=1e-9, atol=1e-12)
    # placement-only faults leave the weights alone
    po = tprog.compile_program(tp.workload, faults=tf.FaultSet(dead_tiles=(3,), n_chips=4))
    assert po.executor(w, backend="reference", device="cpu").fault_info is None


def test_faulted_multiblock_program_executes_like_reference():
    arch_j, arch_t = J_ARCH.replace(n_c=8, n_m=8), T_ARCH.replace(n_c=8, n_m=8)
    fs_j = jf.FaultSet(dead_tiles=(2, 30), dead_links=(11,), cell_rate=0.03, cell_seed=4,
                       dead_blocks=(jf.BlockFault(2, 0, 1, 2),), arch=arch_j)
    fs_t = faultset_to_port(fs_j, arch_t)
    jp = jprog.compile_program(jprog.Workload("mb", _multiblock(jmap)), arch_j, faults=fs_j)
    tp = tprog.compile_program(tprog.Workload("mb", _multiblock(tmap)), arch_t, faults=fs_t)
    assert _alloc_key(tp.allocs) == _alloc_key(jp.allocs)
    w = jex.random_weights(jp, seed=100)
    images = np.random.default_rng(42).normal(size=(3, 8, 8, 3))
    want = jp.execute(images, w, backend="numpy")
    got = tp.execute(images, w, backend="reference", device="cpu")
    np.testing.assert_allclose(got.outputs.numpy(), want.outputs, rtol=1e-9, atol=1e-12)
    assert got.events == dict(want.events) == dict(tp.event_totals)


def test_cache_stats_exposes_fault_caches():
    import repro_torch.core as core

    stats = core.cache_stats()
    assert {"compile_faulted", "chip_segments", "compile_program"} <= set(stats)
    assert stats["compile_faulted"].maxsize == 64
