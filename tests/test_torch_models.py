"""The port's configs, layers, attention, xLSTM blocks and models (dense and
ssm; every family builds and steps) against the JAX package's.

The same numpy inputs, made from a seed, go through the JAX function and
its port. Model weights come from the JAX package's ``Model.init`` and reach
the port through ``repro_torch.convert.model_params_to_port``. Tolerances:
float32 rtol 2e-5 and bfloat16 rtol 2e-2 for the layers
(tests/test_kernels.py:18-19); dense model logits within 1e-5 · max|ref| at
float32 and 2e-2 · max|ref| at bfloat16. The xLSTM blocks and the ssm model
(logits and every cache leaf) within 1e-4 · max|ref| at float32
(tests/test_layers.py:95; the recurrences carry f32 rounding from step to
step) and 2e-2 · max|ref| at bfloat16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs import ARCHS, get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import xlstm as jxlstm
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import ARCHS as PORT_ARCHS, get_config
from repro_torch.convert import model_params_to_port
from repro_torch.models import attention as tattn
from repro_torch.models.frontend import synth_image_embeds, synth_tokens
from repro_torch.models import layers as tlayers
from repro_torch.models import xlstm as txlstm
from repro_torch.models.transformer import CallConfig, build_model

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(a, dtype="float32"):
    a = np.asarray(a, dtype=np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(a, jd), torch.from_numpy(a).to(td)


def _np(y):
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(jnp.asarray(y).astype(jnp.float32))


def _tols(dtype):
    return dict(rtol=2e-2, atol=0.05) if dtype == "bfloat16" else dict(rtol=2e-5, atol=1e-5)


def _params_both(tree, dtype="float32"):
    """A dict of float32 numpy arrays as JAX arrays and torch tensors."""
    pairs = {k: _both(v) for k, v in tree.items()}
    return {k: j for k, (j, _) in pairs.items()}, {k: t for k, (_, t) in pairs.items()}


def test_configs_are_the_jax_packages():
    assert PORT_ARCHS == ARCHS
    for arch in ARCHS:
        want, got = jax_get_config(arch), get_config(arch)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), arch
        assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced()), arch
        assert (got.head_dim, got.param_count(), got.active_param_count()) == (
            want.head_dim, want.param_count(), want.active_param_count())
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_jax(dtype):
    rng = np.random.default_rng(0)
    xj, xt = _both(rng.normal(size=(3, 5, 48)) * 3.0, dtype)
    pj, pt = _params_both({"scale": rng.normal(size=48), "bias": rng.normal(size=48)})
    for jf, tf in ((jlayers.rmsnorm, tlayers.rmsnorm), (jlayers.layernorm, tlayers.layernorm)):
        got = tf(pt, xt)
        assert got.dtype == xt.dtype
        np.testing.assert_allclose(_np(got), _np(jf(pj, xj)), **_tols(dtype))
    assert tlayers.make_norm("rmsnorm") is tlayers.rmsnorm
    with pytest.raises(ValueError):
        tlayers.make_norm("batchnorm")


@pytest.mark.parametrize("fraction,dtype", [(1.0, "float32"), (0.75, "float32"),
                                            (1.0, "bfloat16"), (0.5, "bfloat16")])
def test_rope_matches_jax(fraction, dtype):
    rng = np.random.default_rng(1)
    xj, xt = _both(rng.normal(size=(2, 7, 3, 64)), dtype)
    pos = rng.integers(0, 500, size=(2, 7))
    got = tlayers.apply_rope(xt, torch.from_numpy(pos), 10_000.0, fraction)
    want = jlayers.apply_rope(xj, jnp.asarray(pos), 10_000.0, fraction)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(want), **_tols(dtype))
    np.testing.assert_allclose(tlayers.rope_freqs(64, 5e5, fraction).numpy(),
                               np.asarray(jlayers.rope_freqs(64, 5e5, fraction)), rtol=1e-6)


@pytest.mark.parametrize("activation,dtype", [("silu", "float32"), ("gelu", "float32"),
                                              ("silu", "bfloat16"), ("gelu", "bfloat16")])
def test_mlp_matches_jax(activation, dtype):
    rng = np.random.default_rng(2)
    xj, xt = _both(rng.normal(size=(2, 5, 32)), dtype)
    names = ("wi_gate", "wi_up", "wo") if activation == "silu" else ("wi", "wo")
    shapes = {"wi_gate": (32, 48), "wi_up": (32, 48), "wi": (32, 48), "wo": (48, 32)}
    pj, pt = _params_both({n: rng.normal(size=shapes[n]) / 6 for n in names})
    got = tlayers.mlp(pt, xt, activation)
    assert got.dtype == xt.dtype
    np.testing.assert_allclose(_np(got), _np(jlayers.mlp(pj, xj, activation)), **_tols(dtype))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_activations_round_as_the_reference(dtype):
    """layers.silu and layers.gelu take jax.nn.silu's and jax.nn.gelu's
    operations in their order, each rounded in the input's dtype: bitwise
    in bfloat16 (gelu's integer_pow[y=3] is x * x * x, rounded twice; its
    constants round to 0.044677734375 and 0.796875 first), and so is mlp's
    gelu branch at this shape (the products' sums are short enough to round
    alike). mlp's silu branch keeps F.silu (ROADMAP Queue 3, item 18) and is
    held by test_mlp_matches_jax. In float32 XLA's own exp and tanh on the
    CPU differ from torch's by a few ulps, so there the limit is 1e-6 of the
    largest magnitude."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=100_000) * 3.0
    x[:6] = [0.0, -0.0, 30.0, -30.0, 100.0, -100.0]
    xj, xt = _both(x, dtype)
    for jf, tf in ((jax.nn.silu, tlayers.silu), (jax.nn.gelu, tlayers.gelu)):
        got, want = _np(tf(xt)), _np(jf(xj))
        assert tf(xt).dtype == xt.dtype
        if dtype == "bfloat16":
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # one rounding (F.silu, F.gelu) differs from the reference in many elements
    if dtype == "bfloat16":
        assert (_np(F.gelu(xt, approximate="tanh")) != _np(jax.nn.gelu(xj))).mean() > 0.2
        assert (_np(F.silu(xt)) != _np(jax.nn.silu(xj))).mean() > 0.2
    xj, xt = _both(rng.normal(size=(2, 5, 32)), dtype)
    pj, pt = _params_both({"wi": rng.normal(size=(32, 48)) / 6,
                           "wo": rng.normal(size=(48, 32)) / 6})
    got, want = _np(tlayers.mlp(pt, xt, "gelu")), _np(jlayers.mlp(pj, xj, "gelu"))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def test_embed_and_unembed_match_jax():
    rng = np.random.default_rng(3)
    pj, pt = _params_both({"table": rng.normal(size=(40, 16))})
    toks = rng.integers(0, 40, size=(2, 6))
    for dtype in ("float32", "bfloat16"):
        jd, td = DTYPES[dtype]
        e = tlayers.embed(pt, torch.from_numpy(toks), td)
        np.testing.assert_array_equal(_np(e), _np(jlayers.embed(pj, jnp.asarray(toks), jd)))
        np.testing.assert_allclose(_np(tlayers.unembed(pt, e)),
                                   _np(jlayers.unembed(pj, jlayers.embed(pj, jnp.asarray(toks), jd))),
                                   **_tols(dtype))


def test_dense_init_scales_by_fan_in():
    gen = torch.Generator().manual_seed(0)
    w = tlayers.dense_init(gen, 400, 300)
    assert w.shape == (400, 300) and w.dtype == torch.float32
    assert abs(w.std().item() * 20.0 - 1.0) < 0.02


def _attn_params(rng, d, h, kvh):
    hd = d // h
    return _params_both({"wq": rng.normal(size=(d, h * hd)) / np.sqrt(d),
                         "wk": rng.normal(size=(d, kvh * hd)) / np.sqrt(d),
                         "wv": rng.normal(size=(d, kvh * hd)) / np.sqrt(d),
                         "wo": rng.normal(size=(h * hd, d)) / np.sqrt(d)})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_block_prefill_and_decode_match_jax(dtype):
    """Prefill fills the cache rows [0, S); a decode step with a (B,)
    position vector writes each row at its own position, and a row parked at
    pos >= max_seq writes nothing."""
    rng = np.random.default_rng(4)
    B, S, D, H, KVH, MAX = 3, 6, 64, 4, 2, 12
    jd, td = DTYPES[dtype]
    pj, pt = _attn_params(rng, D, H, KVH)
    xj, xt = _both(rng.normal(size=(B, S, D)), dtype)
    pos = np.broadcast_to(np.arange(S), (B, S))
    kw = dict(rope_theta=10_000.0)
    cache_shape = (B, MAX, KVH, D // H)
    jcache = (jnp.zeros(cache_shape, jd), jnp.zeros(cache_shape, jd))
    tcache = (torch.zeros(cache_shape, dtype=td), torch.zeros(cache_shape, dtype=td))
    yj, jcache = jattn.attention_block(pj, xj, jnp.asarray(pos), H, KVH, kv_cache=jcache, **kw)
    yt = tattn.attention_block(pt, xt, torch.from_numpy(pos.copy()), H, KVH, kv_cache=tcache,
                               **kw)
    np.testing.assert_allclose(_np(yt), _np(yj), **_tols(dtype))
    for got, want in zip(tcache, jcache):
        np.testing.assert_allclose(_np(got), _np(want), **_tols(dtype))

    # decode: row 2 is parked at max_seq
    step = np.array([S, S + 3, MAX])
    sj, st = _both(rng.normal(size=(B, 1, D)), dtype)
    jcache = tuple(c.astype(jd) for c in (jnp.asarray(_np(t)) for t in tcache))
    parked_before = [t[2].clone() for t in tcache]
    yj, jcache = jattn.attention_block(pj, sj, jnp.asarray(step)[:, None], H, KVH,
                                       kv_cache=jcache, cache_pos=jnp.asarray(step), **kw)
    yt = tattn.attention_block(pt, st, torch.from_numpy(step)[:, None], H, KVH,
                               kv_cache=tcache, cache_pos=torch.from_numpy(step), **kw)
    np.testing.assert_allclose(_np(yt), _np(yj), **_tols(dtype))
    for got, want, before in zip(tcache, jcache, parked_before):
        np.testing.assert_allclose(_np(got), _np(want), **_tols(dtype))
        assert torch.equal(got[2], before)


def test_naive_and_decode_attention_match_jax():
    rng = np.random.default_rng(5)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng.normal(size=s)) for s in
                                    ((2, 5, 6, 32), (2, 9, 2, 32), (2, 9, 2, 32)))
    for causal in (True, False):
        np.testing.assert_allclose(
            _np(tattn.naive_attention(qt, kt, vt, causal=causal)),
            _np(jattn.naive_attention(qj, kj, vj, causal=causal)), rtol=2e-5, atol=1e-5)
    for pos in (4, np.array([3, 8])):
        np.testing.assert_allclose(
            _np(tattn.decode_attention(qt[:, :1], kt, vt, torch.as_tensor(pos))),
            _np(jattn.decode_attention(qj[:, :1], kj, vj, jnp.asarray(pos))),
            rtol=2e-5, atol=1e-5)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _xlstm_tols(dtype):
    return 1e-4 if dtype == "float32" else 2e-2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_forward_and_decode_step_match_jax(dtype):
    """A ragged S (37, padded to whole chunks of 16 with ig = 0, fg = 30):
    the output and the final (C, n, m), then one decode step from it."""
    rng = np.random.default_rng(11)
    B, S, D, H = 2, 37, 64, 4
    params, _ = jxlstm.init_mlstm(jax.random.PRNGKey(1), D, H)
    pj, pt = _params_both({k: np.array(v) for k, v in params.items()})
    xj, xt = _both(rng.normal(size=(B, S, D)), dtype)
    tol = _xlstm_tols(dtype)
    yj, sj = jxlstm.mlstm_forward(pj, xj, H, chunk=16, return_state=True)
    yt, st = txlstm.mlstm_forward(pt, xt, H, chunk=16, return_state=True)
    assert yt.dtype == xt.dtype and all(st[k].dtype == torch.float32 for k in st)
    _close(yt, yj, tol)
    for k in ("C", "n", "m"):
        _close(st[k], sj[k], tol)
    stj, stt = _both(rng.normal(size=(B, 1, D)), dtype)
    yj, sj = jxlstm.mlstm_decode_step(pj, stj, sj, H)
    yt, st = txlstm.mlstm_decode_step(pt, stt, st, H)
    _close(yt, yj, tol)
    for k in ("C", "n", "m"):
        _close(st[k], sj[k], tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_and_decode_step_match_jax(dtype):
    """The whole sequence through ops.slstm (the plain version on the CPU)
    against the reference's lax.scan, then one decode step (_slstm_cell)."""
    rng = np.random.default_rng(12)
    B, S, D, H = 2, 21, 64, 2
    params, _ = jxlstm.init_slstm(jax.random.PRNGKey(2), D, H)
    pj, pt = _params_both({k: np.array(v) for k, v in params.items()})
    xj, xt = _both(rng.normal(size=(B, S, D)), dtype)
    tol = _xlstm_tols(dtype)
    yj, sj = jxlstm.slstm_forward(pj, xj, H, return_state=True)
    yt, st = txlstm.slstm_forward(pt, xt, H, return_state=True)
    assert yt.dtype == xt.dtype and all(st[k].dtype == torch.float32 for k in st)
    _close(yt, yj, tol)
    for k in "cnhm":
        _close(st[k], sj[k], tol)
    stj, stt = _both(rng.normal(size=(B, 1, D)), dtype)
    yj, sj = jxlstm.slstm_decode_step(pj, stj, sj, H)
    yt, st = txlstm.slstm_decode_step(pt, stt, st, H)
    _close(yt, yj, tol)
    for k in "cnhm":
        _close(st[k], sj[k], tol)


def _jax_pair(arch):
    """A reduced config: JAX params and their numpy copy."""
    cfg = jax_get_config(arch).reduced()
    params = jax_build_model(cfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def smollm_pair():
    """Reduced smollm-135m: JAX params and their numpy copy."""
    return _jax_pair("smollm-135m")


@pytest.fixture(scope="module")
def xlstm_pair():
    """Reduced xlstm-350m (one [mLSTM, sLSTM] pair, hd 32): JAX params and
    their numpy copy."""
    return _jax_pair("xlstm-350m")


@pytest.mark.parametrize("arch,dtype,tol", [
    pytest.param("smollm-135m", "float32", 1e-5, id="float32-1e-05"),
    pytest.param("smollm-135m", "bfloat16", 2e-2, id="bfloat16-0.02"),
    pytest.param("xlstm-350m", "float32", 1e-4, id="xlstm-350m-float32-0.0001"),
    pytest.param("xlstm-350m", "bfloat16", 2e-2, id="xlstm-350m-bfloat16-0.02"),
])
def test_model_prefill_and_decode_logits_match_jax(request, arch, dtype, tol):
    """Prefill, forward and two decode steps (a scalar position, then per-row
    positions with a row parked), the logits and every cache leaf."""
    cfg, params, np_params = request.getfixturevalue(
        "smollm_pair" if arch == "smollm-135m" else "xlstm_pair")
    jd, td = DTYPES[dtype]
    jm = jax_build_model(cfg, JaxCallConfig(remat="none", compute_dtype=jd, cache_dtype=jd))
    tm = model_params_to_port(get_config(arch).reduced(), np_params,
                              cc=CallConfig(compute_dtype=td, cache_dtype=td), device="cpu")
    rng = np.random.default_rng(6)
    B, S, MAX = 2, 13, 24
    toks = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)

    def close(got, want):
        _close(got, want, tol)

    jl, jc = jm.prefill(params, jnp.asarray(toks), jm.init_cache(B, MAX))
    tl, tc = tm.prefill(toks, tm.init_cache(B, MAX))
    assert tuple(tl.shape) == (B, 1, cfg.vocab_size) and tl.dtype == td
    close(tl, jl)
    assert len(tc) == len(jax.tree.leaves(jc))
    for got, want in zip(tc, jax.tree.leaves(jc)):
        close(got, want)
    full_j, _, _ = jm.forward(params, jnp.asarray(toks))
    full_t, _ = tm.forward(toks)
    close(full_t, full_j)
    # a scalar position, then per-row positions
    step = rng.integers(1, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl, jc = jm.decode_step(params, jnp.asarray(step), jc, jnp.int32(S))
    tl, tc = tm.decode_step(step, tc, S)
    close(tl, jl)
    pos = np.array([S + 1, MAX], np.int32)  # row 1 parked
    jl, jc = jm.decode_step(params, jnp.asarray(step), jc, jnp.asarray(pos))
    tl, tc = tm.decode_step(step, tc, torch.from_numpy(pos))
    close(tl, jl)
    for got, want in zip(tc, jax.tree.leaves(jc)):
        close(got, want)


def test_model_init_is_seeded_and_dense_only():
    cfg = get_config("smollm-135m").reduced()
    a = build_model(cfg, device="cpu", seed=3)
    b = build_model(cfg, device="cpu", seed=4).init(3)  # init redraws every parameter
    c = build_model(cfg, device="cpu", seed=4)
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["blocks.0.attn.wq"], sc["blocks.0.attn.wq"])
    assert torch.equal(sa["ln_f.scale"], torch.ones(cfg.d_model))
    k, v = a.init_cache(2, 8)
    assert k.shape == (cfg.num_layers, 2, 8, cfg.num_kv_heads, cfg.head_dim)
    assert k.dtype == torch.bfloat16 and not k.any()
    for arch in ("llama-3.2-vision-90b", "musicgen-large"):  # vlm, audio build too
        m = build_model(get_config(arch).reduced(), device="cpu", seed=0)
        jm = jax_build_model(jax_get_config(arch).reduced(), JaxCallConfig(remat="none"))
        want = jax.tree.leaves(jm.init_cache(2, 8))
        got = m.init_cache(2, 8)
        assert [tuple(t.shape) for t in got] == [tuple(w.shape) for w in want]
        assert all(t.dtype == torch.bfloat16 and not t.any() for t in got)
    with pytest.raises(ValueError, match="unknown family"):  # as the reference's init raises
        build_model(dataclasses.replace(cfg, family="rnn"), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_every_config_builds_and_steps_on_the_cpu(arch):
    """All six families build on the CPU from every config (reduced), and a
    prefill and a decode step give finite logits of the reference's shape
    ((B, 1, V), or (B, 1, K, V) for audio)."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", seed=0)
    gen = torch.Generator().manual_seed(1)
    toks = synth_tokens(gen, cfg, 2, 6)
    kw = {"image_embeds": synth_image_embeds(gen, cfg, 2)} if cfg.family == "vlm" else {}
    logits, cache = model.prefill(toks, model.init_cache(2, 8), **kw)
    want = (2, 1) + ((cfg.num_codebooks,) if cfg.num_codebooks else ()) + (cfg.vocab_size,)
    assert tuple(logits.shape) == want and torch.isfinite(logits).all()
    logits, _ = model.decode_step(toks[:, -1:], cache, 6)
    assert tuple(logits.shape) == want and torch.isfinite(logits).all()


def test_model_params_to_port_checks_names_and_shapes(smollm_pair):
    cfg, _, np_params = smollm_pair
    port_cfg = get_config("smollm-135m").reduced()
    missing = {k: v for k, v in np_params.items() if k != "ln_f"}
    with pytest.raises(KeyError, match="ln_f.scale"):
        model_params_to_port(port_cfg, missing, device="cpu")
    bad = dict(np_params, ln_f={"scale": np.ones(cfg.d_model + 1, np.float32)})
    with pytest.raises(ValueError, match="ln_f.scale"):
        model_params_to_port(port_cfg, bad, device="cpu")
    with pytest.raises(ValueError, match="stacks"):
        model_params_to_port(dataclasses.replace(port_cfg, num_layers=3), np_params,
                             device="cpu")


def test_xlstm_model_builds_pairs_and_its_cache(xlstm_pair):
    """Parameter names and shapes equal the reference's pair-stacked tree cut
    at each pair; the cache is the reference's state pytree as seven float32
    leaves in jax.tree.leaves order, slot axis 1, whatever the cache dtype."""
    cfg, _, np_params = xlstm_pair
    port_cfg = get_config("xlstm-350m").reduced()
    model = build_model(port_cfg, device="cpu", seed=0)
    assert len(model.blocks) == cfg.num_layers // 2
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    flat = jax.tree_util.tree_flatten_with_path(np_params)[0]
    want = {}
    for path, leaf in flat:
        name = ".".join(p.key for p in path)
        if name.startswith("blocks."):
            for g in range(leaf.shape[0]):
                want[f"blocks.{g}.{name[7:]}"] = tuple(leaf.shape[1:])
        else:
            want[name] = tuple(leaf.shape)
    assert own == want
    jm = jax_build_model(cfg, JaxCallConfig(remat="none"))
    jcache = jax.tree_util.tree_flatten_with_path(jm.init_cache(3, 8))[0]
    cache = model.init_cache(3, 8)
    assert [".".join(p.key for p in path) for path, _ in jcache] == list(txlstm.STATE_LEAVES)
    for t, (_, leaf) in zip(cache, jcache):
        assert t.dtype == torch.float32 and t.shape == leaf.shape and t.shape[1] == 3
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_model_params_to_port_takes_the_pair_stacked_tree(xlstm_pair):
    cfg, _, np_params = xlstm_pair
    port_cfg = get_config("xlstm-350m").reduced()
    model = model_params_to_port(port_cfg, np_params, device="cpu")
    rg = np_params["blocks"]["slstm"]["rg"]
    assert rg.shape[0] == cfg.num_layers // 2
    np.testing.assert_array_equal(model.blocks[0].slstm["rg"].numpy(), rg[0])
    with pytest.raises(ValueError, match="stacks"):  # the layer count is not the pair count
        model_params_to_port(dataclasses.replace(port_cfg, num_layers=4), np_params,
                             device="cpu")
    missing = dict(np_params, blocks={k: v for k, v in np_params["blocks"].items()
                                      if k != "ln_s"})
    with pytest.raises(KeyError, match="ln_s.scale"):
        model_params_to_port(port_cfg, missing, device="cpu")
