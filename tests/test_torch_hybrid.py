"""The port's hybrid family (zamba2: Mamba2 / SSD blocks and one shared
attention block) against the JAX package's.

* ``ssd_chunked`` with S a multiple of the chunk and ragged (padded with
  dt = 0), from the zero state and from an ``init_state``;
  ``mamba2_forward(return_state=True)`` (S = 2 < W - 1 left-pads the conv
  state) and ``mamba2_decode_step``, whose conv runs in float32 as JAX
  promotes it: float32 within 1e-4 · max|ref| (tests/test_layers.py:95, the
  ssm family's: the scans carry f32 rounding), bfloat16 within 2e-2;
* reduced zamba2-1.2b (one group of two Mamba2 blocks, the shared block,
  one tail block): prefill and two decode steps, logits and every cache
  leaf in jax.tree.leaves order, float32 within 1e-4 · max|ref|, bfloat16
  within 2e-2 · max|ref|; the full-sequence forward's logits at float32
  within 1e-4 · max|ref| and, at bfloat16, no farther from the reference's
  float32 logits than the reference's own bfloat16 forward (1.25 times at
  most); the parameter tree and its conversion;
* ``Engine.generate``: greedy tokens ``==`` the JAX engine's at float32
  and ``==`` ``generate_sequential``;
* a paged pool (KV rows paged, Mamba2 states dense per slot): decode
  logits bitwise the contiguous pool's, and ``simulate``'s payload ``==``
  the reference's on the same profile and pool.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import ssm as jssm
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.serve import TrafficProfile as JaxTrafficProfile
from repro.serve import simulate as jax_simulate
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.serve import (Engine, PagedSlotCache, Request, TrafficProfile, init_slots,
                               simulate)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARCH = "zamba2-1.2b"
HOST_FIELDS = ("wall_s", "tokens_s")  # wall-clock, not virtual
_MEMO = {}


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


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _tol(dtype):
    return 1e-4 if dtype == "float32" else 2e-2


# -------------------- the block --------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,chunk,init", [(64, 16, False), (37, 16, False), (37, 16, True),
                                          (5, 32, True)])
def test_ssd_chunked_matches_jax(S, chunk, init, dtype):
    """Whole chunks and a ragged S (the pad has dt = 0, so the final state
    is the unpadded one), from zero and from a given state."""
    rng = np.random.default_rng(S + chunk)
    B, H, P, N = 2, 3, 8, 4
    xj, xt = _both(rng.normal(size=(B, S, H, P)), dtype)
    dtj, dtt = _both(np.log1p(np.exp(rng.normal(size=(B, S, H)))))
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H)))
    Aj, At = _both(A)
    Bj, Bt = _both(rng.normal(size=(B, S, N)), dtype)
    Cj, Ct = _both(rng.normal(size=(B, S, N)), dtype)
    Dj, Dt = _both(rng.normal(size=H))
    kw_j, kw_t = {}, {}
    if init:
        hj, ht = _both(rng.normal(size=(B, H, N, P)))
        kw_j, kw_t = dict(init_state=hj), dict(init_state=ht)
    yj, sj = jssm.ssd_chunked(xj, dtj, Aj, Bj, Cj, Dj, chunk=chunk, **kw_j)
    yt, st = tssm.ssd_chunked(xt, dtt, At, Bt, Ct, Dt, chunk=chunk, **kw_t)
    assert yt.dtype == xt.dtype and st.dtype == torch.float32
    _close(yt, yj, _tol(dtype))
    _close(st, sj, _tol(dtype))


def _mamba_params(cfg, d, seed=1):
    s = cfg.ssm
    p, _ = jssm.init_mamba2(jax.random.PRNGKey(seed), d, expand=s.expand, head_dim=s.head_dim,
                            state_dim=s.state_dim, conv_width=s.conv_width)
    pn = {k: np.asarray(v) for k, v in p.items()}
    # nonzero biases and a scaled norm: every parameter reaches the output
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "dt_bias", "norm_scale", "D"):
        pn[k] = (pn[k] + 0.1 * rng.normal(size=pn[k].shape)).astype(np.float32)
    return {k: jnp.asarray(v) for k, v in pn.items()}, \
        {k: torch.from_numpy(v.copy()) for k, v in pn.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [45, 2])
def test_mamba2_forward_and_decode_step_match_jax(S, dtype):
    """The whole sequence with its decode state (S = 2 < W - 1 = 3: the raw
    conv columns left-padded with zeros), then two decode steps from it."""
    cfg = jax_get_config(ARCH).reduced()
    d = cfg.d_model
    pj, pt = _mamba_params(cfg, d)
    rng = np.random.default_rng(S)
    xj, xt = _both(rng.normal(size=(2, S, d)), dtype)
    tol = _tol(dtype)
    yj, sj = jssm.mamba2_forward(pj, xj, cfg, return_state=True)
    yt, st = tssm.mamba2_forward(pt, xt, cfg, return_state=True)
    assert yt.dtype == xt.dtype and all(st[k].dtype == torch.float32 for k in st)
    _close(yt, yj, tol)
    for k in ("conv", "ssd"):
        _close(st[k], sj[k], tol)
    np.testing.assert_array_equal(_np(tssm.mamba2_forward(pt, xt, cfg)), _np(yt))
    for _ in range(2):
        stepj, stept = _both(rng.normal(size=(2, 1, d)), dtype)
        yj, sj = jssm.mamba2_decode_step(pj, stepj, sj, cfg)
        yt, st = tssm.mamba2_decode_step(pt, stept, st, cfg)
        assert yt.dtype == xt.dtype and all(st[k].dtype == torch.float32 for k in st)
        _close(yt, yj, tol)
        for k in ("conv", "ssd"):
            _close(st[k], sj[k], tol)


def test_decode_conv_runs_in_float32_as_jax_promotes_it():
    """With a float32 state and bfloat16 activations the decode conv's
    output is float32 (jnp.concatenate promotes): the port's new conv state
    is bitwise the reference's, its raw columns kept unrounded."""
    cfg = jax_get_config(ARCH).reduced()
    d = cfg.d_model
    pj, pt = _mamba_params(cfg, d, seed=2)
    rng = np.random.default_rng(9)
    conv = rng.normal(size=(2, cfg.ssm.conv_width - 1, 288)).astype(np.float32)
    ssd = rng.normal(size=(2, 8, 16, 32)).astype(np.float32)
    sj = {"conv": jnp.asarray(conv), "ssd": jnp.asarray(ssd)}
    st = {"conv": torch.from_numpy(conv.copy()), "ssd": torch.from_numpy(ssd.copy())}
    xj, xt = _both(rng.normal(size=(2, 1, d)), "bfloat16")
    _, nj = jssm.mamba2_decode_step(pj, xj, sj, cfg)
    _, nt = tssm.mamba2_decode_step(pt, xt, st, cfg)
    np.testing.assert_array_equal(nt["conv"].numpy(), np.asarray(nj["conv"]))
    np.testing.assert_array_equal(nt["conv"][:, :-1].numpy(), conv[:, 1:])
    _close(nt["ssd"], nj["ssd"], 2e-2)


def test_init_mamba2_layout_is_the_reference():
    cfg = get_config(ARCH)
    s = cfg.ssm
    kw = dict(expand=s.expand, head_dim=s.head_dim, state_dim=s.state_dim,
              conv_width=s.conv_width)
    want, _ = jssm.init_mamba2(jax.random.PRNGKey(0), 64, **kw)
    got = tssm.init_mamba2(torch.Generator().manual_seed(0), 64, **kw)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k in ("conv_b", "A_log", "D", "dt_bias", "norm_scale"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6)
    st = tssm.init_mamba2_state(3, 64, cfg)
    jst = jssm.init_mamba2_state(3, 64, cfg)
    assert {k: tuple(v.shape) for k, v in st.items()} == {k: v.shape for k, v in jst.items()}


# -------------------- the model --------------------
def _pair():
    """Reduced zamba2 in both packages, the reference's parameters and their
    numpy copy (memoised per module)."""
    if "pair" not in _MEMO:
        jcfg = jax_get_config(ARCH).reduced()
        params = jax_build_model(jcfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
        _MEMO["pair"] = (jcfg, get_config(ARCH).reduced(), params,
                         jax.tree.map(np.asarray, params))
    return _MEMO["pair"]


def _port(dtype="float32"):
    _, cfg, _, np_params = _pair()
    td = DTYPES[dtype][1]
    return model_params_to_port(cfg, np_params, cc=CallConfig(compute_dtype=td, cache_dtype=td),
                                device="cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hybrid_model_prefill_and_decode_match_jax(dtype):
    """Prefill, forward and two decode steps (a scalar position, then per-row
    positions with a row parked): the logits and all six cache leaves."""
    jcfg, cfg, params, _ = _pair()
    jd, td = DTYPES[dtype]
    tol = _tol(dtype)
    jm = jax_build_model(jcfg, JaxCallConfig(remat="none", compute_dtype=jd, cache_dtype=jd))
    tm = _port(dtype)
    rng = np.random.default_rng(6)
    B, S, MAX = 2, 13, 24
    toks = rng.integers(1, jcfg.vocab_size, size=(B, S)).astype(np.int32)
    jl, jc = jm.prefill(params, jnp.asarray(toks), jm.init_cache(B, MAX))
    tl, tc = tm.prefill(toks, tm.init_cache(B, MAX))
    _close(tl, jl, tol)
    jleaves = jax.tree.leaves(jc)
    assert [tuple(t.shape) for t in tc] == [tuple(a.shape) for a in jleaves]
    assert [t.dtype for t in tc] == [td, td] + [torch.float32] * 4
    for got, want in zip(tc, jleaves):
        _close(got, want, tol)
    if dtype == "float32":  # bfloat16: test_hybrid_bfloat16_forward_is_as_close_as_the_reference
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


def test_hybrid_bfloat16_forward_is_as_close_as_the_reference():
    """Every position's bfloat16 logits of a full forward, measured against
    the reference's float32 logits: the port is no farther from them than
    the reference's own bfloat16 forward is (at most 1.25 times, and within
    5e-2 · max). The two bfloat16 forwards round their products in other
    orders (XLA's and PyTorch's CPU matmuls; the Mamba2 blocks alone are
    bitwise), and through the tail block their logits end about 2.3e-2 ·
    max apart at this seed, where the reference's own bfloat16 logits are
    4.4e-2 · max from its float32 ones."""
    jcfg, _, params, _ = _pair()
    toks = np.random.default_rng(6).integers(1, jcfg.vocab_size, size=(2, 13)).astype(np.int32)
    out = {}
    for dtype in ("float32", "bfloat16"):
        jd = DTYPES[dtype][0]
        jm = jax_build_model(jcfg, JaxCallConfig(remat="none", compute_dtype=jd, cache_dtype=jd))
        out["jax", dtype] = _np(jm.forward(params, jnp.asarray(toks))[0])
    out["port", "bfloat16"] = _np(_port("bfloat16").forward(toks)[0])
    want = out["jax", "float32"]

    def err(key):
        return np.abs(out[key] - want).max() / np.abs(want).max()

    assert np.isfinite(out["port", "bfloat16"]).all()
    assert err(("port", "bfloat16")) <= min(1.25 * err(("jax", "bfloat16")), 5e-2)


def test_hybrid_model_builds_the_reference_tree_and_cache():
    """blocks.<g>.<i>.{ln,mamba}.*, tail.<r>.*, shared_attn.* (registered
    once) with the reference's shapes; the cache leaves in jax.tree.leaves
    order, slot axis 2 on the group Mamba2 states and 1 elsewhere."""
    from repro_torch.serve.kvcache import batch_axes, seq_axes

    jcfg, cfg, _, np_params = _pair()
    model = build_model(cfg, device="cpu", seed=0)
    ke = cfg.hybrid_attn_every
    ng, rem = divmod(cfg.num_layers, ke)
    assert (len(model.blocks), len(model.blocks[0]), len(model.tail)) == (ng, ke, rem)
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(np_params)[0]:
        name = ".".join(p.key for p in path)
        top, _, rest = name.partition(".")
        if top == "blocks":
            for g in range(leaf.shape[0]):
                for i in range(leaf.shape[1]):
                    want[f"blocks.{g}.{i}.{rest}"] = tuple(leaf.shape[2:])
        elif top == "tail":
            for r in range(leaf.shape[0]):
                want[f"tail.{r}.{rest}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    assert own == want
    assert sum(n.startswith("shared_attn.attn.wq") for n in own) == 1
    jm = jax_build_model(jcfg, JaxCallConfig(remat="none"))
    jpaths = jax.tree_util.tree_flatten_with_path(jm.init_cache(3, 8))[0]
    names = [".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
             for path, _ in jpaths]
    assert names == ["groups.attn.0", "groups.attn.1", "groups.mamba.conv", "groups.mamba.ssd",
                     "tail.conv", "tail.ssd"]
    for t, (_, leaf) in zip(model.init_cache(3, 8), jpaths):
        assert t.shape == leaf.shape and str(t.dtype).split(".")[1] == str(leaf.dtype)
    assert batch_axes(model, 8) == (1, 1, 2, 2, 1, 1)
    assert seq_axes(model) == (2, 2, None, None, None, None)


def test_model_params_to_port_checks_the_hybrid_tree():
    _, cfg, _, np_params = _pair()
    model = model_params_to_port(cfg, np_params, device="cpu")
    np.testing.assert_array_equal(model.blocks[0][1].mamba["in_proj"].numpy(),
                                  np_params["blocks"]["mamba"]["in_proj"][0, 1])
    np.testing.assert_array_equal(model.tail[0].mamba["conv_w"].numpy(),
                                  np_params["tail"]["mamba"]["conv_w"][0])
    with pytest.raises(ValueError, match="stacks"):  # 3 per group: (1, 3) against (1, 2)
        model_params_to_port(dataclasses.replace(cfg, hybrid_attn_every=3, num_layers=4),
                             np_params, device="cpu")
    no_tail = {k: v for k, v in np_params.items() if k != "tail"}
    with pytest.raises(KeyError, match="tail.0.ln.scale"):
        model_params_to_port(cfg, no_tail, device="cpu")


# -------------------- serving --------------------
def _requests(vocab, cls=Request, n=4, max_new=5):
    rng = np.random.RandomState(0)
    return [cls(prompt=rng.randint(1, vocab, size=2 + 3 * i).astype(np.int32),
                max_new_tokens=max_new + i % 2) for i in range(n)]


def test_zamba2_greedy_generate_matches_jax_engine_and_sequential_at_float32():
    """Prompts of 2 to 11 tokens (the shortest below the conv's W - 1)."""
    jcfg, cfg, params, _ = _pair()
    f32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)
    jm = jax_build_model(jcfg, JaxCallConfig(remat="none", **f32))
    want = JaxEngine(jm, params, batch=2, max_seq=32).generate(
        _requests(jcfg.vocab_size, JaxRequest), seed=0)
    eng = Engine(_port("float32"), batch=2, max_seq=32)
    got = eng.generate(_requests(cfg.vocab_size), seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    oracle = eng.generate_sequential(_requests(cfg.vocab_size), seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in oracle]


def test_zamba2_bfloat16_generate_matches_sequential():
    _, cfg, _, _ = _pair()
    eng = Engine(build_model(cfg, device="cpu", seed=0), batch=3, max_seq=32)
    got = eng.generate(_requests(cfg.vocab_size, n=5), seed=0)
    oracle = eng.generate_sequential(_requests(cfg.vocab_size, n=5), seed=0)
    assert [r.out_tokens for r in got] == [r.out_tokens for r in oracle]


@pytest.mark.parametrize("page_size", [4, 5])  # 12 rows: dividing, non-dividing
def test_paged_zamba2_decode_logits_bitwise_the_contiguous_pool(page_size):
    """Two decode steps through the engine's paged step (ensure_rows,
    gather, decode_step, scatter) and through the contiguous cache, with
    occupied, parked and written slots: the same logits bit for bit, the
    same KV rows and the same Mamba2 states."""
    _, cfg, _, _ = _pair()
    model = build_model(cfg, device="cpu", seed=0)
    B, S = 3, 12
    dense, paged = init_slots(model, B, S), PagedSlotCache(model, B, S, page_size)
    rng = np.random.RandomState(7)
    for b, plen in [(0, 5), (2, 9)]:  # slot 1 stays parked
        prompt = rng.randint(1, cfg.vocab_size, size=plen).astype(np.int32)
        _, one = model.prefill(prompt[None, :], model.init_cache(1, S))
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
        assert all(torch.equal(a, b) for a, b in zip(dense.cache, paged.gather_dense()))
        pos = torch.tensor([6, S, 10])


def test_paged_simulate_payload_equals_the_reference():
    """The same profile through both simulators on paged pools smaller than
    the contiguous ones (eos_id=None: the clock does not depend on the
    model's numbers): every virtual-clock field equal, and the served
    tokens equal the port's own oracle."""
    jcfg, cfg, params, _ = _pair()
    prof = dict(name="hybrid-burst", num_requests=10, arrival="burst", burst_size=4,
                num_users=6, requests_per_user_tick=0.1, prompt_lens=[3, 6, 9],
                output_lens=[2, 4, 6], temperature=0.0, seed=0)
    p, jp = TrafficProfile.from_dict(prof), JaxTrafficProfile.from_dict(prof)
    pool = dict(batch=3, page_size=4, pool_pages=6)
    want = jax_simulate(JaxEngine(jax_build_model(jcfg, JaxCallConfig(remat="none")), params,
                                  max_seq=jp.max_rows, **pool), jp, check=False)
    eng = Engine(build_model(cfg, device="cpu", seed=0), max_seq=p.max_rows, **pool)
    got = simulate(eng, p, check=True)
    assert got.pop("matches_sequential")
    assert eng.slots.pool_pages < pool["batch"] * eng.slots.pages_per_slot
    assert {k: v for k, v in got.items() if k not in HOST_FIELDS} == \
        {k: v for k, v in want.items() if k not in HOST_FIELDS}
    assert eng.slots.allocator.n_held == 0
