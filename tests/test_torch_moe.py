"""The port's moe family against the JAX package's.

* ``_dispatch_group`` on the same router logits: slots equal as integers,
  the expert buffer, the gates and the full softmax;
* ``moe_forward`` over (tokens, experts, k, capacity factor, dispatch
  groups), a dropping capacity factor (0.05) and ``dp_size`` 2 among them,
  and ``init_moe`` / ``moe_forward`` at ``ep_split`` 2: float32 y within
  rtol 2e-5, aux within 1e-6; bfloat16 within 2e-2
  (tests/test_kernels.py:18-19);
* a bfloat16 router with **forced ties** picks the reference's experts
  (``jax.lax.top_k`` puts the lower index first);
* ``expert_capacity`` ``==`` over a grid;
* reduced dbrx-132b (``moe_every`` 1, ``capacity_factor = num_experts`` as
  tests/test_serve.py:185 serves it) and llama4-maverick with ``moe_every``
  2 and 4 layers: prefill and two decode steps, logits and every cache
  leaf within 1e-5 · max|ref| at float32 (the dense family's tolerance) and
  2e-2 · max|ref| at bfloat16;
* ``Engine.generate`` on reduced dbrx: greedy tokens ``==`` the JAX
  engine's at float32 and ``==`` ``generate_sequential``; the drop-free
  guard evaluates the same ``expert_capacity`` as the dispatch.
"""
import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import moe as jmoe
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.models import moe as tmoe
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.serve import Engine, Request

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


def _both(a, dtype="float32"):
    a = np.asarray(a, dtype=np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _moe_params(E, D, F, *, ep_split=1, seed=0):
    """The reference's init_moe, as numpy, JAX and torch."""
    p, _ = jmoe.init_moe(jax.random.PRNGKey(seed), D, F, E, ep_split=ep_split)
    pn = {k: np.asarray(v) for k, v in p.items()}
    return pn, {k: jnp.asarray(v) for k, v in pn.items()}, \
        {k: torch.from_numpy(v.copy()) for k, v in pn.items()}


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


# -------------------- the dispatch --------------------
@pytest.mark.parametrize("T,E,k,cap", [(12, 4, 2, 4), (40, 8, 2, 3), (9, 16, 4, 9), (30, 4, 1, 2),
                                       (7, 4, 2, 1)])
def test_dispatch_group_matches_jax(T, E, k, cap):
    """The same logits: the same slots (overflow to E·C), buffer rows,
    gates and softmax; ranks are taken over the token-major (T·k) choices."""
    rng = np.random.default_rng(T * E + k)
    D = 16
    xj, xt = _both(rng.normal(size=(T, D)))
    lj, lt = _both(rng.normal(size=(T, E)))
    bj, sj, gj, fj = jmoe._dispatch_group(xj, lj, k, cap, E)
    bt, st, gt, ft = tmoe._dispatch_group(xt, lt, k, cap, E)
    assert st.dtype == torch.int64 and gt.dtype == xt.dtype and ft.dtype == torch.float32
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert (st.numpy() == E * cap).any() == (np.asarray(sj) == E * cap).any()
    np.testing.assert_array_equal(_np(bt)[:-1], _np(bj)[:-1])  # kept rows are exact copies
    np.testing.assert_allclose(_np(gt), _np(gj), rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(_np(ft), _np(fj), rtol=2e-5, atol=1e-7)


def test_forced_router_ties_pick_the_reference_experts():
    """bfloat16 router logits that tie exactly (experts 1, 2 and 3 share a
    router column; every token's top-2 lands in the tie): the port takes
    the reference's experts, the lower index first, where ``torch.topk``
    promises no order."""
    rng = np.random.default_rng(7)
    T, D, E, k = 24, 32, 6, 2
    col = rng.normal(size=D)
    router = rng.normal(size=(D, E)) * 0.1
    router[:, 1] = router[:, 2] = router[:, 3] = col
    x = rng.normal(size=(T, D)) + col  # x @ col ~ 32: every token prefers the tied experts
    xj, xt = _both(x, "bfloat16")
    lj = jnp.einsum("td,de->te", xj, jnp.asarray(router, jnp.bfloat16))
    lt = xt @ torch.from_numpy(router).float().to(torch.bfloat16)
    lt_np = _np(lt)
    assert (lt_np[:, 1] == lt_np[:, 2]).all() and (lt_np[:, 2] == lt_np[:, 3]).all()
    np.testing.assert_array_equal(lt_np, _np(lj))
    cap = T  # no drop: the ranks alone decide the slots
    _, sj, gj, _ = jmoe._dispatch_group(xj, lj, k, cap, E)
    _, st, gt, _ = tmoe._dispatch_group(xt, lt, k, cap, E)
    experts = st.numpy() // cap
    assert (experts == [1, 2]).all()  # the tie's two lowest experts, in order
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(_np(gt), _np(gj))


# -------------------- the layer --------------------
MOE_CASES = [
    # (B, S, E, k, capacity_factor, dp_size)
    (2, 8, 4, 2, 1.25, 1),
    (1, 16, 8, 2, 0.05, 1),   # capacity 1: most choices dropped
    (2, 6, 4, 1, 2.0, 2),     # two dispatch groups
    (3, 5, 8, 4, 4.0, 1),
    (1, 6, 4, 2, 1.0, 4),     # dp_size 4 on 6 tokens: two groups of 3
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,E,k,cf,dp", MOE_CASES)
def test_moe_forward_matches_jax(B, S, E, k, cf, dp, dtype):
    rng = np.random.default_rng(B * S + E)
    D, F = 32, 48
    _, pj, pt = _moe_params(E, D, F, seed=E + k)
    xj, xt = _both(rng.normal(size=(B, S, D)), dtype)
    kw = dict(top_k=k, num_experts=E, capacity_factor=cf, dp_size=dp)
    yj, aj = jmoe.moe_forward(pj, xj, **kw)
    yt, at = tmoe.moe_forward(pt, xt, **kw)
    assert yt.dtype == xt.dtype and yt.shape == xt.shape and at.dtype == torch.float32
    if dtype == "float32":
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=2e-5, atol=2e-5 * np.abs(_np(yj)).max())
        assert abs(at.item() - float(aj)) <= 1e-6
    else:
        _close(yt, yj, 2e-2)
        assert abs(at.item() - float(aj)) <= 2e-2 * abs(float(aj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_at_ep_split_2_matches_jax(dtype):
    """The expert-parallel layout (E·2, D, F/2): init_moe's shapes, and the
    split down-projections summed back."""
    rng = np.random.default_rng(3)
    E, D, F = 4, 32, 48
    pn, pj, pt = _moe_params(E, D, F, ep_split=2, seed=1)
    gen = torch.Generator().manual_seed(0)
    own = tmoe.init_moe(gen, D, F, E, ep_split=2)
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in pn.items()}
    with pytest.raises(ValueError, match="ep_split"):
        tmoe.init_moe(gen, D, 47, E, ep_split=2)
    xj, xt = _both(rng.normal(size=(2, 7, D)), dtype)
    kw = dict(top_k=2, num_experts=E, capacity_factor=1.25, dp_size=1, ep_split=2)
    yj, aj = jmoe.moe_forward(pj, xj, **kw)
    yt, at = tmoe.moe_forward(pt, xt, **kw)
    if dtype == "float32":
        np.testing.assert_allclose(_np(yt), _np(yj), rtol=2e-5, atol=2e-5 * np.abs(_np(yj)).max())
        assert abs(at.item() - float(aj)) <= 1e-6
    else:
        _close(yt, yj, 2e-2)


def test_init_moe_layout_is_the_reference():
    gen = torch.Generator().manual_seed(0)
    pn, _, _ = _moe_params(16, 64, 96)
    own = tmoe.init_moe(gen, 64, 96, 16)
    assert {k: tuple(v.shape) for k, v in own.items()} == {k: v.shape for k, v in pn.items()}
    assert all(v.dtype == torch.float32 for v in own.values())
    assert abs(own["wo"].std().item() * 96 ** 0.5 - 1.0) < 0.05


def test_expert_capacity_equals_the_reference_over_a_grid():
    for n, k, E, cf, dp in itertools.product(range(1, 41), (1, 2, 4), (4, 16, 128),
                                             (0.05, 1.0, 1.25, 4.5, 16.0), (1, 2, 3, 4, 8)):
        kw = dict(top_k=k, num_experts=E, capacity_factor=cf, dp_size=dp)
        assert tmoe.expert_capacity(n, **kw) == jmoe.expert_capacity(n, **kw), (n, kw)


# -------------------- the models --------------------
def _drop_free(cfg):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.num_experts)))


def _every_other(cfg):
    return dataclasses.replace(cfg, num_layers=4,
                               moe=dataclasses.replace(cfg.moe, moe_every=2))


VARIANTS = {"dbrx-132b": _drop_free, "llama4-maverick-400b-a17b": _every_other}
_PAIRS = {}


def _pair(arch):
    """A reduced config in both packages and the reference's parameters (and
    their numpy copy), memoised per module."""
    if arch not in _PAIRS:
        jcfg = VARIANTS[arch](jax_get_config(arch).reduced())
        params = jax_build_model(jcfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
        _PAIRS[arch] = (jcfg, VARIANTS[arch](get_config(arch).reduced()), params,
                        jax.tree.map(np.asarray, params))
    return _PAIRS[arch]


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("arch", list(VARIANTS))
def test_moe_model_prefill_and_decode_match_jax(arch, dtype, tol):
    """Prefill, forward and two decode steps (a scalar position, then per-row
    positions with a row parked): the logits and every cache leaf, in
    jax.tree.leaves order."""
    jcfg, cfg, params, np_params = _pair(arch)
    jd, td = DTYPES[dtype]
    jm = jax_build_model(jcfg, JaxCallConfig(remat="none", compute_dtype=jd, cache_dtype=jd))
    tm = model_params_to_port(cfg, np_params, cc=CallConfig(compute_dtype=td, cache_dtype=td),
                              device="cpu")
    rng = np.random.default_rng(6)
    B, S, MAX = 2, 13, 24
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = jm.prefill(params, jnp.asarray(toks), jm.init_cache(B, MAX))
    tl, tc = tm.prefill(toks, tm.init_cache(B, MAX))
    assert tuple(tl.shape) == (B, 1, jcfg.vocab_size) and tl.dtype == td
    _close(tl, jl, tol)
    jleaves = jax.tree.leaves(jc)
    assert [tuple(t.shape) for t in tc] == [tuple(a.shape) for a in jleaves]
    for got, want in zip(tc, jleaves):
        _close(got, want, tol)
    full_j, _, _ = jm.forward(params, jnp.asarray(toks))
    full_t, _ = tm.forward(toks)
    _close(full_t, full_j, tol)
    step = rng.integers(1, jcfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, jc = jm.decode_step(params, jnp.asarray(step), jc, jnp.int32(S))
    tl, tc = tm.decode_step(step, tc, S)
    _close(tl, jl, tol)
    pos = np.array([S + 1, MAX], np.int32)  # row 1 parked
    jl, jc = jm.decode_step(params, jnp.asarray(step), jc, jnp.asarray(pos))
    tl, tc = tm.decode_step(step, tc, torch.from_numpy(pos))
    _close(tl, jl, tol)
    for got, want in zip(tc, jax.tree.leaves(jc)):
        _close(got, want, tol)


@pytest.mark.parametrize("arch", list(VARIANTS))
def test_moe_model_builds_the_reference_parameter_tree(arch):
    """Parameter names and shapes equal the reference's stacked tree cut at
    each layer (dbrx: blocks.<l>.moe.*) or group (llama4:
    blocks.<g>.{dense,moe_l}.*); build_model draws them itself from a seed."""
    _, cfg, _, np_params = _pair(arch)
    model = build_model(cfg, device="cpu", seed=0)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        name = ".".join(p.key for p in path)
        if name.startswith("blocks."):
            for g in range(leaf.shape[0]):
                want[f"blocks.{g}.{name[7:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    assert own == want
    moe_leaf = "blocks.0.moe.wi_gate" if arch == "dbrx-132b" else "blocks.1.moe_l.moe.wo"
    assert moe_leaf in own
    if arch != "dbrx-132b":
        assert "blocks.0.dense.mlp.wi_gate" in own
        assert len(model.init_cache(3, 8)) == 4  # dense.k, dense.v, moe_l.k, moe_l.v


def test_model_params_to_port_checks_the_moe_tree():
    _, cfg, _, np_params = _pair("dbrx-132b")
    blocks = dict(np_params["blocks"], moe={k: v for k, v in np_params["blocks"]["moe"].items()
                                            if k != "router"})
    with pytest.raises(KeyError, match="moe.router"):
        model_params_to_port(cfg, dict(np_params, blocks=blocks), device="cpu")
    with pytest.raises(ValueError, match="stacks"):
        model_params_to_port(dataclasses.replace(cfg, num_layers=3), np_params, device="cpu")
    with pytest.raises(ValueError, match="moe_every"):
        build_model(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, moe_every=3)),
                    device="cpu")


# -------------------- serving --------------------
def _requests(vocab, cls=Request, n=4, max_new=5):
    rng = np.random.RandomState(0)
    return [cls(prompt=rng.randint(1, vocab, size=4 + (i % 4)).astype(np.int32),
                max_new_tokens=max_new) for i in range(n)]


def test_dbrx_greedy_generate_matches_jax_engine_and_sequential_at_float32():
    jcfg, cfg, params, np_params = _pair("dbrx-132b")
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    jm = jax_build_model(jcfg, JaxCallConfig(remat="none", **f32))
    tm = model_params_to_port(cfg, np_params, cc=CallConfig(compute_dtype=torch.float32,
                                                            cache_dtype=torch.float32),
                              device="cpu")
    want = JaxEngine(jm, params, batch=2, max_seq=32).generate(
        _requests(jcfg.vocab_size, JaxRequest), seed=0)
    eng = Engine(tm, batch=2, max_seq=32)
    got = eng.generate(_requests(cfg.vocab_size), seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    oracle = eng.generate_sequential(_requests(cfg.vocab_size), seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in oracle]
    assert all(r.done and len(r.out_tokens) == 5 for r in got)


def test_dbrx_bfloat16_generate_matches_sequential():
    _, cfg, _, _ = _pair("dbrx-132b")
    eng = Engine(build_model(cfg, device="cpu", seed=0), batch=3, max_seq=32)
    got = eng.generate(_requests(cfg.vocab_size, n=5), seed=0)
    oracle = eng.generate_sequential(_requests(cfg.vocab_size, n=5), seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in oracle]


def test_engine_guard_uses_the_dispatch_capacity():
    """The engine imports the dispatch's own formula (no copy), and refuses
    the published capacity factor at a pool of 8 with the drop-free value
    (8 + 1) · E / (8 · k) = 4.5 for dbrx's 16 experts, top 4."""
    from repro_torch.serve import engine as engine_mod

    assert engine_mod.expert_capacity is tmoe.expert_capacity
    assert not hasattr(engine_mod, "_expert_capacity")
    full = get_config("dbrx-132b")
    stub = type("Stub", (), {"cfg": full, "cc": CallConfig()})()
    with pytest.raises(ValueError, match=r"drop-free capacity_factor \(>= 4.5 for this pool\)"):
        Engine(stub, batch=8, max_seq=16)._family_guards()
    ok = dataclasses.replace(full, moe=dataclasses.replace(full.moe, capacity_factor=4.5))
    stub.cfg = ok
    Engine(stub, batch=8, max_seq=16)._family_guards()
    _, tl, cap = tmoe.expert_capacity(8, top_k=4, num_experts=16, capacity_factor=4.5)
    assert (tl, cap) == (8, 9)
