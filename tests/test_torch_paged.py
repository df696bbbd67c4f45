"""The port's paged KV cache against the JAX package's.

* ``PagePool``: the allocator invariants under random alloc/free sequences
  (tests/test_kvcache_paged.py's property test), the same pages in the same
  order as the JAX package's pool, the double free and the exhaustion;
* paged reads equal contiguous reads **bitwise**: a ``PagedSlotCache`` and a
  ``SlotCache`` given the same prefill writes and frees give equal dense
  views, for page sizes that do and do not divide ``max_seq``, and a slot
  holds exactly ``ceil(rows / page_size)`` pages;
* decode logits through the paged view are bitwise the contiguous cache's,
  and within float32 rounding of the JAX package's paged decode;
* the constructors' errors and ``OutOfPages`` carry the reference's words;
* ``seq_axes`` finds the dense KV's sequence axis, and the ssm family
  (xlstm), whose state does not scale with ``max_seq``, is refused by the
  paged cache in both packages;
* mixed leaves (reduced zamba2: paged KV rows, Mamba2 states dense per
  slot): the pool's leaves take the reference's shapes, and paged reads
  equal contiguous reads bitwise through admits, retires and refills.

Property tests run under real hypothesis when installed and under
``tests/_hypothesis_stub.py`` otherwise; the model and caches live in a
module memo, not fixtures (the stub hides wrapped signatures from pytest).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:  # stripped container: deterministic fallback
    from _hypothesis_stub import given, settings, st

from repro.configs import get_config as jax_get_config
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.serve import kvcache as jkv
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.serve import (
    Engine,
    OutOfPages,
    PagedSlotCache,
    PagePool,
    Request,
    cache_bytes,
    init_paged_slots,
    init_slots,
    seq_axes,
    trim_report,
)

B, S = 3, 12  # slot pool geometry shared by every cache-level test
_MEMO = {}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs: the suite runs in several
    worker processes at once, and PyTorch's default of a thread per core in
    each of them oversubscribes the CPU several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def served():
    """Reduced smollm-135m in the port, bfloat16 (the default CallConfig)."""
    if "served" not in _MEMO:
        cfg = get_config("smollm-135m").reduced()
        _MEMO["served"] = (cfg, build_model(cfg, device="cpu", seed=0))
    return _MEMO["served"]


def hybrid():
    """Reduced zamba2-1.2b in the port (its cache mixes pageable KV leaves
    with per-slot Mamba2 states), bfloat16."""
    if "hybrid" not in _MEMO:
        cfg = get_config("zamba2-1.2b").reduced()
        _MEMO["hybrid"] = (cfg, build_model(cfg, device="cpu", seed=0))
    return _MEMO["hybrid"]


def cache_pair(page_size):
    """A fresh (SlotCache, PagedSlotCache) pair of the served model."""
    _, model = served()
    return init_slots(model, B, S), PagedSlotCache(model, B, S, page_size)


def prefilled(model, prompt):
    """A batch-1 cache of ``S`` rows prefilled with ``prompt``."""
    _, one = model.prefill(np.asarray(prompt)[None, :], model.init_cache(1, S))
    return one


def leaves_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


# -------------------- allocator invariants --------------------
@settings(max_examples=40, deadline=None)
@given(n_pages=st.integers(1, 24), seed=st.integers(0, 2**31 - 1))
def test_page_pool_invariants_and_order_match_the_reference(n_pages, seed):
    """Random alloc/free interleavings through both pools: no double
    allocation, conservation, exhaustion raises, and the same page handed
    out at every step."""
    rng = np.random.RandomState(seed)
    pool, ref = PagePool(n_pages), jkv.PagePool(n_pages)
    held = set()
    for _ in range(rng.randint(10, 60)):
        if held and rng.rand() < 0.4:
            page = int(rng.choice(sorted(held)))
            pool.free(page)
            ref.free(page)
            held.discard(page)
        elif pool.n_free == 0:
            with pytest.raises(OutOfPages):
                pool.alloc()
        else:
            page = pool.alloc()
            assert page == ref.alloc()
            assert page not in held and 0 <= page < n_pages
            held.add(page)
        assert pool.n_held == len(held) == ref.n_held
        assert pool.n_free + pool.n_held == n_pages


def test_page_pool_double_free_exhaustion_and_order():
    pool, ref = PagePool(5), jkv.PagePool(5)
    assert [pool.alloc() for _ in range(5)] == [0, 1, 2, 3, 4]
    [ref.alloc() for _ in range(5)]
    _same_error(pool.alloc, ref.alloc, OutOfPages, jkv.OutOfPages)
    pool.free(3)
    assert pool.alloc() == 3  # LIFO: a freed page is the next one reused
    pool.free(3)
    with pytest.raises(ValueError, match="double free"):
        pool.free(3)
    with pytest.raises(ValueError):
        pool.free(99)
    with pytest.raises(ValueError, match="page pool needs >= 1 page"):
        PagePool(0)


# -------------------- paged == contiguous, bitwise --------------------
@settings(max_examples=10, deadline=None)
@given(page_size=st.sampled_from([1, 3, 4, 5, 12]), seed=st.integers(0, 2**31 - 1))
def test_paged_reads_match_contiguous_bitwise(page_size, seed):
    """Random admit/retire/refill sequences through both caches: after every
    operation the paged dense view equals the contiguous cache leaf for
    leaf, and a slot holds exactly ceil(rows / page_size) pages."""
    cfg, model = served()
    rng = np.random.RandomState(seed)
    dense, paged = cache_pair(page_size)
    rows_in = [0] * B
    assert leaves_equal(dense.cache, paged.gather_dense())
    for _ in range(6):
        b = rng.randint(B)
        if rows_in[b]:  # retire (the engine frees before a refill too)
            dense.reset_slot(b)
            paged.free_slot(b)
            rows_in[b] = 0
            if rng.rand() < 0.35:
                continue
        plen = int(rng.choice([2, 5, 9]))
        one = prefilled(model, rng.randint(1, cfg.vocab_size, size=plen).astype(np.int32))
        paged.ensure_rows(b, plen)
        paged.write_prefill(b, one)
        dense.write_prefill(b, one)
        rows_in[b] = plen
        assert leaves_equal(dense.cache, paged.gather_dense()), page_size
        for s in range(B):
            assert paged.pages_held(s) == paged.pages_needed(rows_in[s])
        alloc = paged.allocator
        assert alloc.n_free + alloc.n_held == alloc.n_pages
    # a stepped view scattered back reads back the same
    view = paged.gather_dense()
    paged.scatter_dense(view)
    assert leaves_equal(view, paged.gather_dense())


@pytest.mark.parametrize("page_size", [4, 5])  # 12 rows: dividing, non-dividing
def test_paged_decode_logits_bitwise(page_size):
    """Two decode steps through the engine's paged step (ensure_rows,
    gather, decode_step, scatter) and through the contiguous cache, with
    occupied, parked and written slots: bitwise the same logits and the
    same rows written."""
    cfg, model = served()
    dense, paged = cache_pair(page_size)
    rng = np.random.RandomState(7)
    for b, plen in [(0, 5), (2, 9)]:  # slot 1 stays parked
        one = prefilled(model, rng.randint(1, cfg.vocab_size, size=plen).astype(np.int32))
        paged.ensure_rows(b, plen)
        paged.write_prefill(b, one)
        dense.write_prefill(b, one)
    pos = torch.tensor([5, S, 9])
    for _ in range(2):
        tok = torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(B, 1)))
        for b in (0, 2):
            paged.ensure_rows(b, int(pos[b]) + 1)
        view = paged.gather_dense()
        lp, _ = model.decode_step(tok, view, pos)
        paged.scatter_dense(view)
        ld, _ = model.decode_step(tok, dense.cache, pos)
        assert torch.equal(ld, lp)
        assert leaves_equal(dense.cache, paged.gather_dense())
        pos = torch.tensor([6, S, 10])


def test_paged_decode_logits_match_the_reference_at_float32():
    """The same weights (model_params_to_port) and writes: the port's paged
    decode logits against the JAX package's paged decode, float32."""
    jcfg = jax_get_config("smollm-135m").reduced()
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    jm = jax_build_model(jcfg, JaxCallConfig(remat="none", **f32))
    params = jm.init(jax.random.PRNGKey(0))
    tm = model_params_to_port(get_config("smollm-135m").reduced(),
                              jax.tree.map(np.asarray, params),
                              cc=CallConfig(compute_dtype=torch.float32,
                                            cache_dtype=torch.float32), device="cpu")
    jp, tp = jkv.PagedSlotCache(jm, B, S, 5), PagedSlotCache(tm, B, S, 5)
    rng = np.random.RandomState(3)
    for b, plen in [(0, 4), (1, 7)]:
        prompt = rng.randint(1, jcfg.vocab_size, size=plen).astype(np.int32)
        _, one = jm.prefill(params, jnp.asarray(prompt)[None, :], jp.template)
        jp.ensure_rows(b, plen + 1)
        jp.write_prefill(b, one)
        tp.ensure_rows(b, plen + 1)
        tp.write_prefill(b, prefilled(tm, prompt))
        assert tp.pages_held(b) == jp.pages_held(b)
        assert tp.table_host.tolist() == np.asarray(jp._table_host).tolist()
    tok = rng.randint(1, jcfg.vocab_size, size=B).astype(np.int32)
    pos = np.array([4, 7, S], np.int32)
    want, _ = jm.decode_step(params, jnp.asarray(tok)[:, None], jp.gather_dense(), jnp.asarray(pos))
    got, _ = tm.decode_step(torch.as_tensor(tok)[:, None], tp.gather_dense(), torch.as_tensor(pos))
    want = np.asarray(want)[..., :jcfg.vocab_size]
    got = got.numpy()[..., :jcfg.vocab_size]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * np.abs(want).max())


def test_write_prefill_takes_a_prompt_length_cache():
    """The engine prefills into a cache of the prompt's rows alone; written
    into the slot's pages, it reads back as the full-length prefill does
    (zeros past the prompt in the slot's pages)."""
    cfg, model = served()
    prompt = np.arange(1, 8, dtype=np.int32)
    full = PagedSlotCache(model, B, S, 4)
    short = PagedSlotCache(model, B, S, 4)
    for cache in (full, short):
        cache.ensure_rows(1, 8)  # two pages: row 7 of the second is past the prompt
    full.write_prefill(1, prefilled(model, prompt))
    _, one = model.prefill(prompt[None, :], model.init_cache(1, len(prompt)))
    short.write_prefill(1, one)
    assert leaves_equal(full.gather_dense(), short.gather_dense())
    assert leaves_equal(full.read_slot(1), short.read_slot(1))
    assert all(not t[:, :, len(prompt):].any() for t in short.read_slot(1))


# -------------------- construction + exhaustion --------------------
def _same_error(fn_port, fn_ref, exc=ValueError, ref_exc=None):
    with pytest.raises(exc) as got:
        fn_port()
    with pytest.raises(ref_exc or exc) as want:
        fn_ref()
    assert str(got.value) == str(want.value)


def test_paged_pool_exhaustion_raises_as_the_reference():
    cfg, model = served()
    jm = jax_build_model(jax_get_config("smollm-135m").reduced(), JaxCallConfig(remat="none"))
    paged, ref = PagedSlotCache(model, B, S, 4, pool_pages=3), \
        jkv.PagedSlotCache(jm, B, S, 4, pool_pages=3)
    for c in (paged, ref):
        c.ensure_rows(0, S)  # slot 0 takes every page
    _same_error(lambda: paged.ensure_rows(1, 1), lambda: ref.ensure_rows(1, 1), OutOfPages,
                jkv.OutOfPages)
    paged.free_slot(0)
    assert paged.ensure_rows(1, 1) == 1  # freed pages recirculate
    _same_error(lambda: paged.ensure_rows(1, S + 1), lambda: ref.ensure_rows(1, S + 1))


@pytest.mark.parametrize("args,kw", [((B, S, 0), {}), ((B, S, S + 1), {}),
                                     ((B, S, 4), dict(pool_pages=2)), ((0, S, 4), {})])
def test_paged_constructor_errors_are_the_reference(args, kw):
    _, model = served()
    jm = jax_build_model(jax_get_config("smollm-135m").reduced(), JaxCallConfig(remat="none"))
    _same_error(lambda: PagedSlotCache(model, *args, **kw),
                lambda: jkv.PagedSlotCache(jm, *args, **kw))


@pytest.mark.parametrize("kw", [dict(page_size=0), dict(page_size=S + 1), dict(pool_pages=4),
                                dict(page_size=4, pool_pages=2)])
def test_engine_paging_errors_are_the_reference(kw):
    from repro.serve.engine import Engine as JaxEngine

    _, model = served()
    _same_error(lambda: Engine(model, batch=B, max_seq=S, **kw),
                lambda: JaxEngine(None, None, batch=B, max_seq=S, **kw))


def test_seq_axes_and_ssm_refused_as_the_reference():
    """Dense KV pages on axis 2 of (L, B, S, KVH, hd); xlstm's state has no
    max_seq-scaling leaf, so both packages refuse to page it, and the
    port's xlstm engine pages nothing unless asked."""
    _, model = served()
    assert seq_axes(model) == (2, 2)
    xcfg = get_config("xlstm-350m").reduced()
    xm = build_model(xcfg, device="cpu", seed=0)
    assert seq_axes(xm) == (None,) * 7
    jxm = jax_build_model(jax_get_config("xlstm-350m").reduced(), JaxCallConfig(remat="none"))
    _same_error(lambda: PagedSlotCache(xm, B, S, 4), lambda: jkv.PagedSlotCache(jxm, B, S, 4))
    eng = Engine(xm, batch=B, max_seq=S, page_size=4)
    with pytest.raises(ValueError, match="no max_seq-scaling leaves to page"):
        eng.generate([Request(prompt=np.arange(1, 4, dtype=np.int32), max_new_tokens=2)])


def test_paged_memory_footprint_smaller():
    """A pool of fewer pages than batch * pages_per_slot holds fewer KV bytes
    than the contiguous cache (the zero page included)."""
    _, model = served()
    dense = init_slots(model, B, S)
    paged = init_paged_slots(model, B, S, 4, pool_pages=4)
    assert cache_bytes(paged.pool) < cache_bytes(dense.cache)
    assert cache_bytes(paged.pool) == cache_bytes(dense.cache) * 5 // 9
    assert trim_report(paged.pool) == {"n_leaves": 2,
                                       "total_gb": cache_bytes(paged.pool) / 1e9}


# -------------------- mixed leaves: paged KV, per-slot recurrent state --------------------
def test_mixed_leaves_pool_layout_is_the_reference():
    """zamba2's six leaves: the two KV leaves paged as (NG, pool_pages + 1,
    page_size, KVH, hd), the four Mamba2 states repeated along their slot
    axis (2 on the group states, 1 on the tail's), as the reference's pool
    holds them; the axes are the reference's too."""
    _, model = hybrid()
    jm = jax_build_model(jax_get_config("zamba2-1.2b").reduced(), JaxCallConfig(remat="none"))
    paged, ref = PagedSlotCache(model, B, S, 5, pool_pages=4), \
        jkv.PagedSlotCache(jm, B, S, 5, pool_pages=4)
    assert paged._paged == list(ref._paged) == [True, True, False, False, False, False]
    assert list(paged._b_ax) == list(ref._b_ax) == [1, 1, 2, 2, 1, 1]
    assert seq_axes(model) == tuple(ref._s_ax) == (2, 2, None, None, None, None)
    assert [tuple(t.shape) for t in paged.pool] == \
        [tuple(a.shape) for a in jax.tree.leaves(ref.pool)]
    contiguous = model.init_cache(B, S)
    for t, c, pg in zip(paged.pool, contiguous, paged._paged):
        if not pg:
            assert t.shape == c.shape and torch.equal(t, c)


@settings(max_examples=8, deadline=None)
@given(page_size=st.sampled_from([1, 4, 5, 12]), seed=st.integers(0, 2**31 - 1))
def test_mixed_paged_reads_match_contiguous_bitwise(page_size, seed):
    """Random admit/retire/refill sequences through a SlotCache and a
    PagedSlotCache of zamba2: after every operation the paged dense view
    equals the contiguous cache leaf for leaf (the KV rows through the
    table, the per-slot states written at their slot), and the dense view
    of a per-slot state is the pool's own tensor."""
    cfg, model = hybrid()
    rng = np.random.RandomState(seed)
    dense, paged = init_slots(model, B, S), PagedSlotCache(model, B, S, page_size)
    rows_in = [0] * B
    for _ in range(6):
        b = rng.randint(B)
        if rows_in[b]:
            dense.reset_slot(b)
            paged.free_slot(b)
            paged.write_prefill(b, model.init_cache(1, S))  # the per-slot states, reset
            rows_in[b] = 0
            if rng.rand() < 0.35:
                continue
        plen = int(rng.choice([2, 5, 9]))
        one = prefilled(model, rng.randint(1, cfg.vocab_size, size=plen).astype(np.int32))
        paged.ensure_rows(b, plen)
        paged.write_prefill(b, one)
        dense.write_prefill(b, one)
        rows_in[b] = plen
        view = paged.gather_dense()
        assert leaves_equal(dense.cache, view), page_size
        assert all(v is p for v, p, pg in zip(view, paged.pool, paged._paged) if not pg)
        assert leaves_equal(paged.read_slot(b), dense.read_slot(b))
    view = tuple(t.clone() for t in paged.gather_dense())
    paged.scatter_dense(view)  # a stepped copy of the states is written back
    assert leaves_equal(view, paged.gather_dense())
