"""Training the audio family (musicgen-large) in the port against the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and the
port (``repro_torch``), in float32 unless a test says otherwise, on reduced
musicgen-large as ``reduced()`` gives it (2 layers, d_model 128, layernorm,
gelu, 4 codebooks of 512, untied (K, V, D) embed and unembed tables), over
batches of 2 x 64 frames x 4 codebooks from both packages'
``SyntheticTokens(num_codebooks=4)``:

* ``layers.gelu`` and ``layers.layernorm``: their gradients against
  ``jax.vjp`` of ``jax.nn.gelu`` and of the reference's layernorm (float32,
  1e-6 of the largest), and the same bits under ``torch.utils.checkpoint``;
* ``Model.loss`` (float32 rtol 2e-5, bfloat16 2e-2; the mean over B, S and
  K) and every float32 gradient leaf, the (K, V, D) tables among them,
  against ``jax.value_and_grad`` through ``convert.stack_tree`` (rtol 1e-3,
  atol 1e-4 of the leaf's largest gradient, tests/test_layers.py:121);
* every bfloat16 gradient leaf within 2e-2 of the leaf's largest gradient:
  ``embed.table`` reads 1.48e-2 of it, the other leaves at most 9.9e-3
  (``blocks.attn.wq``; ROADMAP Queue 3, item 31). Both packages round the backward of the
  codebook lookups, a bfloat16 scatter-add of Zipf-frequent tokens, each
  in its own order;
* remat "block" against "none" bitwise; the serving ``forward``'s logits
  equal to ``forward_train``'s;
* three ``make_train_step`` steps at accumulation 1 and 2 against the
  reference's, at Adam eps 1e-6 (ROADMAP Queue 3, item 23);
* a train state's checkpoint crossing between the packages both ways;
* the launcher on the CPU, and its resume.

The card's side (train steps through the attention kernels) is in
tests/test_torch_gpu.py.
"""
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.checkpoint import checkpoint as jck
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models import layers as jlayers
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_port, model_params_to_port, stack_tree
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import train as train_launcher
from repro_torch.models import layers as tlayers
from repro_torch.models.transformer import CallConfig
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (load_state_tree, make_train_state, make_train_step,
                                          state_tree)

ARCH = "musicgen-large"
BATCH, SEQ = 2, 64
GRAD_TOL = dict(rtol=1e-3)  # and atol 1e-4 of the largest gradient (tests/test_layers.py:121)
BF16_GRAD_TOL = 2e-2  # of a leaf's largest bfloat16 gradient (the bf16 tolerance)
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread while this module runs (the suite runs in several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _batch(step: int, seed: int = 0) -> dict:
    """Step ``step`` of the port's SyntheticTokens over reduced musicgen's 4
    codebooks: (B, S, K) tokens and targets."""
    cfg = get_config(ARCH).reduced()
    return SyntheticTokens(DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                                      seed=seed, num_codebooks=cfg.num_codebooks)).batch_at(step)


def _jbatch(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---- the layers ----------------------------------------------------------------------


def _grads_both(jfn, tfn, inputs: dict, cot: np.ndarray):
    """The gradients of ``<fn(**inputs), cot>`` for every input: the port's
    by autograd, directly and under torch.utils.checkpoint, and the
    reference's by jax.vjp."""
    names = list(inputs)
    _, vjp = jax.vjp(lambda *a: jfn(**dict(zip(names, a))),
                     *(jnp.asarray(inputs[n], jnp.float32) for n in names))
    want = vjp(jnp.asarray(cot, jnp.float32))
    got = []
    for remat in (False, True):
        ts = [torch.tensor(inputs[n], dtype=torch.float32, requires_grad=True) for n in names]
        fn = lambda *a: tfn(**dict(zip(names, a)))  # noqa: E731
        y = checkpoint(fn, *ts, use_reentrant=False) if remat else fn(*ts)
        got.append(torch.autograd.grad(y, ts, torch.from_numpy(cot.astype(np.float32))))
    return names, got, want


@pytest.mark.parametrize("scale", [1.0, 3.0])
def test_gelu_gradient_matches_jax_and_checkpoint(scale):
    """At unit scale (gelu's input in the model, ln2(x) @ wi with wi drawn
    at 1/sqrt(d_model)) within 1e-6 of the reference's; at all scales
    within 1e-6 of the float64 gradient. At scale 3 the reference itself
    stands 1.5e-6 from the float64 gradient (XLA's float32 tanh on the CPU,
    its error grown by 1 - tanh^2 near saturation), and the port 3.2e-7."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 33, 64)) * scale
    cot = rng.normal(size=x.shape)
    names, (plain, remat), want = _grads_both(
        lambda x: jax.nn.gelu(x), lambda x: tlayers.gelu(x), {"x": x}, cot)
    x64 = torch.tensor(x, requires_grad=True)
    exact = torch.autograd.grad(tlayers.gelu(x64), x64, torch.from_numpy(cot))[0].numpy()
    assert torch.equal(plain[0], remat[0])
    got = _np(plain[0])
    assert np.abs(got - exact).max() <= 1e-6 * np.abs(exact).max()
    if scale == 1.0:
        w = _np(want[0])
        assert np.abs(got - w).max() <= 1e-6 * np.abs(w).max()


def test_layernorm_gradients_match_jax_and_checkpoint():
    """d x, d scale and d bias of layers.layernorm against the reference's."""
    rng = np.random.default_rng(6)
    inputs = {"x": rng.normal(size=(4, 33, 128)) * 2.0 + 0.5,
              "scale": 1.0 + 0.1 * rng.normal(size=128), "bias": 0.1 * rng.normal(size=128)}
    names, (plain, remat), want = _grads_both(
        lambda x, scale, bias: jlayers.layernorm({"scale": scale, "bias": bias}, x),
        lambda x, scale, bias: tlayers.layernorm({"scale": scale, "bias": bias}, x),
        inputs, rng.normal(size=inputs["x"].shape))
    for n, a, b, w in zip(names, plain, remat, want):
        assert torch.equal(a, b), n
        w = _np(w)
        assert np.abs(_np(a) - w).max() <= 1e-6 * np.abs(w).max(), n


# ---- the model's loss and gradients ----------------------------------------------------


@pytest.fixture(scope="module")
def musicgen():
    """Reduced musicgen-large: the JAX params and their numpy copy, and
    step 0's batch."""
    jcfg = jax_get_config(ARCH).reduced()
    params = jax_build_model(jcfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params), _batch(0)


def _models(np_params, dtype="float32", remat="block"):
    jd, td = DTYPES[dtype]
    jm = jax_build_model(jax_get_config(ARCH).reduced(), JaxCallConfig(remat=remat,
                                                                        compute_dtype=jd))
    tm = model_params_to_port(get_config(ARCH).reduced(), np_params,
                              cc=CallConfig(compute_dtype=td, remat=remat), device="cpu")
    return jm, tm


def test_the_batches_are_the_references_codebook_grids(musicgen):
    cfg = get_config(ARCH).reduced()
    batch = musicgen[2]
    want = JaxSyntheticTokens(JaxDataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ,
                                            global_batch=BATCH, seed=0,
                                            num_codebooks=cfg.num_codebooks)).batch_at(0)
    for k in ("tokens", "targets"):
        assert batch[k].shape == (BATCH, SEQ, cfg.num_codebooks)
        np.testing.assert_array_equal(batch[k], np.asarray(want[k]))


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_loss_matches_the_reference(musicgen, dtype, rtol):
    params, np_params, batch = musicgen
    jm, tm = _models(np_params, dtype)
    jloss, jmets = jm.loss(params, _jbatch(batch))
    with torch.no_grad():
        tloss, tmets = tm.loss(batch)
    assert tloss.dtype == torch.float32 and set(tmets) == {"nll", "aux"}
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(tmets["nll"]), float(jmets["nll"]), rtol=rtol)
    assert float(tmets["aux"]) == float(jmets["aux"]) == 0.0


def _port_grads(tm, batch):
    tm.requires_grad_(True)
    params = dict(tm.named_parameters())
    loss, _ = tm.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), {n: g.float().numpy() for n, g in zip(params, grads)}


def _grad_pairs(musicgen, dtype):
    """(name, port gradient, reference gradient) of every leaf, in the
    reference's stacked tree order."""
    params, np_params, batch = musicgen
    jm, tm = _models(np_params, dtype)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(params, _jbatch(batch))
    tloss, tgrads = _port_grads(tm, batch)
    got = jax.tree_util.tree_flatten_with_path(stack_tree(tm.cfg, tm, tgrads))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    keys = [jax.tree_util.keystr(p) for p, _ in got]
    assert keys == [jax.tree_util.keystr(p) for p, _ in want]
    return float(tloss), float(jloss), [(k, g, _np(w)) for k, (_, g), (_, w)
                                        in zip(keys, got, want)]


def test_every_gradient_leaf_matches_value_and_grad(musicgen):
    tloss, jloss, pairs = _grad_pairs(musicgen, "float32")
    np.testing.assert_allclose(tloss, jloss, rtol=2e-5)
    shapes = {k: g.shape for k, g, _ in pairs}
    K, V, D = 4, 512, 128
    assert shapes["['embed']['table']"] == shapes["['unembed']['table']"] == (K, V, D)
    for k, g, w in pairs:
        assert g.shape == w.shape and np.isfinite(g).all(), k
        np.testing.assert_allclose(g, w, atol=1e-4 * np.abs(w).max(), err_msg=k, **GRAD_TOL)


def test_bf16_gradient_leaves_stay_within_the_bf16_tolerance(musicgen):
    """Every bfloat16 gradient leaf within 2e-2 of its largest element.
    embed.table is the furthest (1.48e-2; blocks.attn.wq next, 9.9e-3):
    the backward of the K codebook
    lookups scatter-adds bfloat16 rows of Zipf-frequent tokens, and the two
    packages add them in other orders."""
    _, _, pairs = _grad_pairs(musicgen, "bfloat16")
    worst = {k: np.abs(g - w).max() / np.abs(w).max() for k, g, w in pairs}
    assert all(np.isfinite(g).all() for _, g, _ in pairs)
    assert max(worst.values()) <= BF16_GRAD_TOL, worst


def test_remat_block_and_none_give_the_same_loss_and_gradients(musicgen):
    _, np_params, batch = musicgen
    _, tm_block = _models(np_params, remat="block")
    _, tm_none = _models(np_params, remat="none")
    lb, gb = _port_grads(tm_block, batch)
    ln, gn = _port_grads(tm_none, batch)
    assert torch.equal(lb, ln)
    for n in gb:
        np.testing.assert_array_equal(gb[n], gn[n], err_msg=n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serving_logits_are_the_train_forwards(musicgen, dtype):
    _, np_params, batch = musicgen
    _, tm = _models(np_params, dtype)
    tm.requires_grad_(True)
    served, _ = tm.forward(batch["tokens"])
    trained, aux = tm.forward_train(batch["tokens"])
    assert served.grad_fn is None and trained.requires_grad
    assert tuple(trained.shape) == (BATCH, SEQ, 4, 512) and float(aux) == 0.0
    assert torch.equal(served, trained.detach())


# the parameter leaves' limit in train_step, over how far each moved (the
# dense family's, tests/test_torch_train.py)
MOVED = 1e-3


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(musicgen, accum):
    """Three steps from the same converted parameters at Adam eps 1e-6
    (ROADMAP Queue 3, item 23): the losses within rtol 2e-5 and the grad
    norm within 1e-4 at every step, each parameter leaf within 1e-5 + MOVED
    max|p_jax - p_init| (a leaf that is wrong or not updated moves by the
    whole of it)."""
    params, np_params, _ = musicgen
    jm, tm = _models(np_params)
    ocfg = dict(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=3, eps=1e-6)
    jstep = jax.jit(jax_make_train_step(jm, jopt.OptConfig(**ocfg), accum_steps=accum))
    tstep = make_train_step(tm, topt.OptConfig(**ocfg), accum_steps=accum)
    jstate = {"params": params, "opt": jopt.init_opt_state(params, jopt.OptConfig(**ocfg)),
              "rng": jax.random.PRNGKey(0)}
    tstate = make_train_state(tm, None, topt.OptConfig(**ocfg))
    for step in range(3):
        batch = _batch(step, seed=7)
        jstate, jmets = jstep(jstate, _jbatch(batch))
        tstate, tmets = tstep(tstate, batch)
        np.testing.assert_allclose(float(tmets["loss"]), float(jmets["loss"]), rtol=2e-5)
        assert float(tmets["grad_norm"]) == pytest.approx(float(jmets["grad_norm"]), rel=1e-4)
    assert int(tstate["opt"]["step"]) == 3
    got = model_params_from_port(tm)
    for (path, g), w, p0 in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree.leaves(jstate["params"]), jax.tree.leaves(np_params)):
        w = np.asarray(w)
        moved = np.abs(w - p0).max()
        assert np.abs(g - w).max() <= 1e-5 + MOVED * moved, jax.tree_util.keystr(path)


def test_an_audio_train_state_checkpoint_crosses_between_the_packages(musicgen, tmp_path):
    """A port state after one step, saved by the port, restores in the
    reference with the reference's keys, the (K, V, D) tables and the
    stacked layers bitwise; a reference state one AdamW step from its init,
    saved by the reference, restores into a fresh port state bitwise."""
    params, np_params, batch = musicgen
    ocfg = topt.OptConfig(schedule="const", warmup_steps=1)
    _, tm = _models(np_params)
    state = make_train_state(tm, None, ocfg)
    state, _ = make_train_step(tm, ocfg)(state, batch)
    jcfg = jopt.OptConfig()
    jstate = {"params": params, "opt": jopt.init_opt_state(params, jcfg),
              "rng": jax.random.PRNGKey(0)}
    ck.save(str(tmp_path / "port"), 1, state_tree(state))
    got, man = jck.restore(str(tmp_path / "port"), jstate)
    assert man["keys"] == [jax.tree_util.keystr(p)
                           for p, _ in jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert np.asarray(got["params"]["embed"]["table"]).shape == (4, 512, 128)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(state_tree(state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))

    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    jp, jo, _ = jopt.adamw_update(params, grads, jstate["opt"], jcfg)
    jstate = {"params": jp, "opt": jo, "rng": jax.random.PRNGKey(5)}
    jck.save(str(tmp_path / "jax"), 1, jax.tree.map(np.asarray, jstate))
    _, fresh_model = _models(np_params)
    fresh = make_train_state(fresh_model, None, ocfg)
    tree, _ = ck.restore(str(tmp_path / "jax"), state_tree(fresh, template=True))
    load_state_tree(fresh, tree)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(state_tree(fresh))[0],
                            jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    assert int(fresh["opt"]["step"]) == 1


# ---- the launcher -----------------------------------------------------------------


ARGS = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4", "--seq", str(SEQ),
        "--log-every", "1"]


def test_launcher_trains_musicgen_and_its_loss_falls(capsys):
    losses = train_launcher.main(ARGS + ["--steps", "12"])
    assert len(losses) == 12 and all(math.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]
    assert "ms/step" in capsys.readouterr().out


def test_launcher_resume_continues_the_uninterrupted_musicgen_run(tmp_path, capsys):
    full = train_launcher.main(ARGS + ["--steps", "6"])
    d = str(tmp_path / "ckpt")
    first = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "3"])
    assert first == full
    shutil.rmtree(tmp_path / "ckpt" / "step_00000006")
    rest = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert rest == full[3:]
