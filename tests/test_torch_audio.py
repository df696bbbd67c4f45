"""The port's audio family (musicgen: a dense layernorm / gelu stack over K
EnCodec codebooks, summed at the input and unembedded one table each)
against the JAX package's.

* ``frontend.audio_token_shape`` equals the reference's; ``synth_tokens``
  draws ``(B, S, K)`` grids;
* the codebook-summed embedding is bitwise the reference's in bfloat16 and
  float32 (the reference's Python ``sum`` order, each add rounded in the
  compute dtype);
* reduced musicgen-large as ``reduced()`` gives it (2 layers, 4 codebooks):
  prefill, forward and two decode steps with ``(B, 1, K)`` tokens (a scalar
  position, then per-row positions with a row parked), the ``(B, S, K, V)``
  logits and both cache leaves, float32 within 1e-5 · max|ref| and bfloat16
  within 2e-2 · max|ref| (the dense family's tolerances); prefill + decode
  against forward (tests/test_models.py:86-98);
* the parameter tree (``(K, V, D)`` tables, not stacked) and its conversion;
* both launchers refuse audio before building a model.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import main as jax_serve_main
from repro.models import frontend as jfrontend
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.launch.serve import main as serve_main
from repro_torch.models import frontend as tfrontend
from repro_torch.models.transformer import CallConfig, build_model

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
ARCH = "musicgen-large"


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


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.fixture(scope="module")
def audio_pair():
    """Reduced musicgen-large: JAX params and their numpy copy."""
    cfg = jax_get_config(ARCH).reduced()
    params = jax_build_model(cfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(np.asarray, params)


def _models(pair, dtype):
    cfg, params, np_params = pair
    jd, td = DTYPES[dtype]
    jm = jax_build_model(cfg, JaxCallConfig(remat="none", compute_dtype=jd, cache_dtype=jd))
    tm = model_params_to_port(get_config(ARCH).reduced(), np_params, device="cpu",
                              cc=CallConfig(compute_dtype=td, cache_dtype=td))
    return jm, tm


def test_frontend_token_grid():
    jcfg, cfg = jax_get_config(ARCH), get_config(ARCH)
    assert tfrontend.audio_token_shape(cfg, 2, 5) == jfrontend.audio_token_shape(jcfg, 2, 5) \
        == (2, 5, 4)
    toks = tfrontend.synth_tokens(torch.Generator().manual_seed(0), cfg, 3, 11)
    assert toks.shape == (3, 11, 4) and toks.dtype == torch.long
    assert 0 <= toks.min() and toks.max() < cfg.vocab_size
    assert len(toks.unique()) > 100


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_codebook_embedding_is_bitwise_the_references(audio_pair, dtype):
    jm, tm = _models(audio_pair, dtype)
    cfg, params, _ = audio_pair
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(3, 7, cfg.num_codebooks))
    got = tm._embed_tokens(torch.from_numpy(toks))
    assert got.shape == (3, 7, cfg.d_model) and got.dtype == DTYPES[dtype][1]
    np.testing.assert_array_equal(_np(got), _np(jm._embed_tokens(params, jnp.asarray(toks))))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_audio_prefill_and_decode_match_jax(audio_pair, dtype, tol):
    """Prefill, forward and two (B, 1, K)-token decode steps (a scalar
    position, then per-row positions with row 1 parked at max_seq): the
    (B, S, K, V) logits and both cache leaves after each."""
    cfg, params, _ = audio_pair
    jm, tm = _models(audio_pair, dtype)
    td = DTYPES[dtype][1]
    rng = np.random.default_rng(6)
    B, S, MAX, K = 2, 13, 24, cfg.num_codebooks
    toks = rng.integers(0, cfg.vocab_size, size=(B, S, K)).astype(np.int32)

    def close_all(tc, jc):
        leaves = jax.tree.leaves(jc)
        assert len(tc) == len(leaves) == 2
        for got, want in zip(tc, leaves):
            assert got.dtype == td
            _close(got, want, tol)

    jl, jc = jm.prefill(params, jnp.asarray(toks), jm.init_cache(B, MAX))
    tl, tc = tm.prefill(toks, tm.init_cache(B, MAX))
    assert tuple(tl.shape) == (B, 1, K, cfg.vocab_size) and tl.dtype == td
    _close(tl, jl, tol)
    close_all(tc, jc)
    full_j, _, _ = jm.forward(params, jnp.asarray(toks))
    full_t, _ = tm.forward(toks)
    assert tuple(full_t.shape) == (B, S, K, cfg.vocab_size)
    _close(full_t, full_j, tol)
    step = rng.integers(0, cfg.vocab_size, size=(B, 1, K)).astype(np.int32)
    jl, jc = jm.decode_step(params, jnp.asarray(step), jc, jnp.int32(S))
    tl, tc = tm.decode_step(step, tc, S)
    assert tuple(tl.shape) == (B, 1, K, cfg.vocab_size)
    _close(tl, jl, tol)
    close_all(tc, jc)
    pos = np.array([S + 1, MAX], np.int32)  # row 1 parked
    jl, jc = jm.decode_step(params, jnp.asarray(step), jc, jnp.asarray(pos))
    tl, tc = tm.decode_step(step, tc, torch.from_numpy(pos))
    _close(tl, jl, tol)
    close_all(tc, jc)


def test_audio_decode_matches_forward(audio_pair):
    """prefill(t[:k]) + decode_step(t[k]) logits == forward(t)[k] in float32,
    rtol = atol = 2e-2 (tests/test_models.py:86-98), and in fact within
    1e-4 · max here."""
    _, tm = _models(audio_pair, "float32")
    cfg = tm.cfg
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, size=(2, 12, cfg.num_codebooks))
    full, _ = tm.forward(toks)
    k = 8
    lg, cache = tm.prefill(toks[:, :k], tm.init_cache(2, 12))
    torch.testing.assert_close(lg[:, 0], full[:, k - 1], rtol=2e-2, atol=2e-2)
    _close(lg[:, 0], full[:, k - 1], 1e-4)
    for t in range(k, k + 2):
        lg, cache = tm.decode_step(toks[:, t:t + 1], cache, t)
        torch.testing.assert_close(lg[:, 0], full[:, t], rtol=2e-2, atol=2e-2)
        _close(lg[:, 0], full[:, t], 1e-4)


def test_audio_parameter_tree_and_conversion(audio_pair):
    """embed.table and unembed.table are (K, V, D) and not stacked; the
    blocks are the dense family's layer stack with layernorm and the
    two-matrix gelu MLP; a wrong stack depth raises."""
    cfg, _, np_params = audio_pair
    port_cfg = get_config(ARCH).reduced()
    model = model_params_to_port(port_cfg, np_params, device="cpu")
    K, V, D = cfg.num_codebooks, cfg.vocab_size, cfg.d_model
    own = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert own["embed.table"] == own["unembed.table"] == (K, V, D)
    assert own["blocks.1.mlp.wi"] == (D, cfg.d_ff) and "blocks.0.ln1.bias" in own
    np.testing.assert_array_equal(model.unembed["table"].numpy(), np_params["unembed"]["table"])
    np.testing.assert_array_equal(model.blocks[1].mlp["wi"].numpy(),
                                  np_params["blocks"]["mlp"]["wi"][1])
    fresh = build_model(port_cfg, device="cpu", seed=0).state_dict()
    assert {k: tuple(v.shape) for k, v in fresh.items()} == own
    with pytest.raises(ValueError, match="stacks"):
        model_params_to_port(dataclasses.replace(port_cfg, num_layers=3), np_params,
                             device="cpu")


def test_launchers_refuse_audio():
    """The reference's launcher exits for a multi-codebook config before it
    builds a model; the port's does too, with a message that names what to
    call instead."""
    with pytest.raises(SystemExit):
        jax_serve_main(["--arch", ARCH, "--reduced"])
    with pytest.raises(SystemExit, match="decode_step") as e:
        serve_main(["--arch", ARCH, "--reduced", "--device", "cpu"])
    assert "examples/" not in str(e.value)
