"""The port's compiler (repro_torch.core.program) against the JAX package's.

For the Tab. IV networks and a small multi-block workload at a reduced
8 x 8 array, both packages compile the same workload. The allocations
(chip ids, grids), block ranges, per-layer and total event counts and every
schedule word must be equal integers: the port keeps its own copies of the
framework-free modules, and this is what holds the copies to the reference.
"""
import dataclasses

import pytest

import repro.core.arch as jarch
import repro.core.mapping as jmap
import repro.core.program as jprog
import repro.core.simulator as jsim
import repro_torch.core.arch as tarch
import repro_torch.core.mapping as tmap
import repro_torch.core.program as tprog
import repro_torch.core.simulator as tsim
from repro.core.schedule import layer_schedules as j_layer_schedules
from repro_torch.core.isa import decode
from repro_torch.core.schedule import layer_schedules as t_layer_schedules
from repro_torch.search.space import validate_allocs


def _small_multiblock(m):
    """conv(pool)→conv→flatten→FC→FC; at n_c = n_m = 8 it has C > n_c and
    M > n_m (tests/test_executor.py:49-61)."""
    return (
        m.ConvSpec("c0", 3, 3, 12, 8, 8, pool_k=2),
        m.ConvSpec("c1", 3, 12, 10, 4, 4),
        m.FCSpec("f0", 160, 20),
        m.FCSpec("f1", 20, 5),
    )


def _pair(name):
    """(JAX program, port program) for one named workload."""
    if name == "mb-exec":
        jp = jprog.compile_program(jprog.Workload(name, _small_multiblock(jmap)),
                                   jarch.DEFAULT_ARCH.replace(n_c=8, n_m=8))
        tp = tprog.compile_program(tprog.Workload(name, _small_multiblock(tmap)),
                                   tarch.DEFAULT_ARCH.replace(n_c=8, n_m=8))
        return jp, tp
    return (jprog.compile_program(jmap.NETWORKS[name]()),
            tprog.compile_program(tmap.NETWORKS[name]()))


WORKLOADS = ["vgg11-cifar", "vgg16-imagenet", "resnet18-cifar", "mb-exec"]


def _spec(layer):
    return type(layer).__name__, dataclasses.asdict(layer)


def test_default_arch_is_the_same():
    assert dataclasses.asdict(tarch.DEFAULT_ARCH) == dataclasses.asdict(jarch.DEFAULT_ARCH)
    for node in (7, 22, 28.5, 45, 200):
        assert tarch.node_energy_factor(node) == jarch.node_energy_factor(node)


@pytest.mark.parametrize("name", WORKLOADS)
def test_allocs_and_blocks_equal(name):
    jp, tp = _pair(name)
    assert [_spec(l) for l in tp.workload] == [_spec(l) for l in jp.workload]
    assert (tp.n_tiles, tp.n_chips) == (jp.n_tiles, jp.n_chips)
    for ja, ta in zip(jp.allocs, tp.allocs, strict=True):
        assert (ta.n_tiles, ta.grid, ta.chip_ids, ta.crosses_chip) == (
            ja.n_tiles, ja.grid, ja.chip_ids, ja.crosses_chip)
        assert _spec(ta.layer) == _spec(ja.layer)
    for jl, tl in zip(jp.layer_programs, tp.layer_programs, strict=True):
        assert (tl.c_blocks, tl.m_blocks, tl.n_blocks) == (jl.c_blocks, jl.m_blocks, jl.n_blocks)
        for jb, tb in zip(jl.blocks, tl.blocks, strict=True):
            assert (tb.layer_name, tb.c_index, tb.m_index, tb.c_range, tb.m_range,
                    tb.roles, tb.n_tiles, tb.is_last_c) == (
                jb.layer_name, jb.c_index, jb.m_index, jb.c_range, jb.m_range,
                jb.roles, jb.n_tiles, jb.is_last_c)
            assert _spec(tb.spec) == _spec(jb.spec)


@pytest.mark.parametrize("name", WORKLOADS)
def test_event_counts_equal(name):
    jp, tp = _pair(name)
    assert dict(tp.event_totals) == dict(jp.event_totals)
    for jl, tl in zip(jp.layer_programs, tp.layer_programs, strict=True):
        assert dict(tl.events) == dict(jl.events)
    assert tsim.network_event_totals(tuple(tp.workload), tp.arch) == dict(
        jsim.network_event_totals(tuple(jp.workload), jp.arch))


@pytest.mark.parametrize("name", WORKLOADS)
def test_schedule_words_equal(name):
    jp, tp = _pair(name)
    for jl, tl in zip(jp.layer_programs, tp.layer_programs, strict=True):
        js = j_layer_schedules(jl.layer, jp.arch)
        ts = t_layer_schedules(tl.layer, tp.arch)
        assert list(ts) == list(js)
        for role in js:
            assert (ts[role].role, ts[role].table.words, ts[role].table.period,
                    ts[role].active_frac) == (js[role].role, js[role].table.words,
                                              js[role].table.period, js[role].active_frac)
            # and the port's decoder round-trips its own words
            assert [decode(w).encode() for w in ts[role].table.words] == ts[role].table.words
        assert tl.schedules is ts


def test_n_blocks_counts_the_block_grid():
    """tests/test_program.py:113's case: a 3 x 3 block grid at n_c = n_m = 8."""
    arch = tarch.DEFAULT_ARCH.replace(n_c=8, n_m=8)
    layer = tmap.ConvSpec("c", 3, 20, 20, 6, 6)
    lp = tprog.compile_program(tprog.Workload("one", (layer,)), arch).layer_programs[0]
    jlp = jprog.compile_program(jprog.Workload("one", (jmap.ConvSpec("c", 3, 20, 20, 6, 6),)),
                                jarch.DEFAULT_ARCH.replace(n_c=8, n_m=8)).layer_programs[0]
    assert lp.n_blocks == jlp.n_blocks == 9 == len(lp.blocks)
    assert [b.c_index * lp.m_blocks + b.m_index for b in lp.blocks] == list(range(lp.n_blocks))


def test_unported_compile_modes_raise():
    wl = tmap.vgg11_cifar()
    with pytest.raises(NotImplementedError, match="repro.search"):
        tprog.compile_program(wl, mapping="searched")
    with pytest.raises(NotImplementedError, match="repro.search"):
        tprog.compile_program(wl, mapping=object())
    with pytest.raises(NotImplementedError, match="repro.faults"):
        tprog.compile_program(wl, faults=object())
    with pytest.raises(ValueError, match="unknown mapping"):
        tprog.compile_program(wl, mapping="best")


def test_workload_contract():
    wl = tmap.vgg11_cifar()
    assert isinstance(wl, tprog.Workload) and wl.name == "vgg11-cifar" and len(wl) == 11
    anon = tprog.Workload.of(list(wl))
    assert anon == wl and hash(anon) == hash(wl)
    assert tprog.compile_program(anon) is tprog.compile_program(wl)
    with pytest.raises(ValueError, match="at least one layer"):
        tprog.Workload("empty", ())
    with pytest.raises(ValueError, match="not a ConvSpec/FCSpec"):
        tprog.Workload("bad", (tmap.FCSpec("a", 8, 8), "nope"))
    with pytest.raises(KeyError, match="no layer"):
        tprog.compile_program(wl).layer_program("nope")


def test_greedy_place_validates_its_output():
    arch = tarch.DEFAULT_ARCH.replace(tiles_per_chip=4)
    allocs = tmap.greedy_place([tmap.FCSpec("a", 8, 8)] * 3, arch)
    validate_allocs(allocs, arch)
    bad = dataclasses.replace(allocs[1], chip_ids=(5,))
    with pytest.raises(ValueError, match="do not match its span"):
        validate_allocs([allocs[0], bad, allocs[2]], arch)
