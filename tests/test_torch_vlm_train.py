"""Training the vlm family (llama-3.2-vision-90b) in the port against the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and the
port (``repro_torch``), in float32 unless a test says otherwise, at the
reference's gradient tolerance rtol 1e-3, atol 1e-4 of the largest gradient
(tests/test_layers.py:121):

* the attention backward at Sq != Skv, non-causal (the cross layer's
  queries against the image tokens): ``ops.flash_attention`` through its
  autograd Function against ``jax.vjp`` of the model attention's
  ``custom_vjp``; ``cross_attention`` (``cross_kv`` and
  ``cross_attention_kv``) against ``jax.vjp`` of the reference's, the
  parameters, the text stream and the image context;
* reduced llama-3.2-vision-90b (one group: ``cross_attn_every`` 2, a self
  layer and a cross layer over 16 image tokens, d_model 128):
  ``Model.loss`` (float32 rtol 2e-5, bfloat16 2e-2), every gradient leaf
  against ``jax.value_and_grad``, remat "block" against "none" bitwise,
  the serving forward's logits the train forward's;
* bf16 master weights: ``cast_params`` leaf by leaf, the per-call weight
  casts then no-ops, three train steps on bf16 masters and bf16 moments
  against the reference's step on parameters cast as its dry run casts
  them (``repro/launch/dryrun.py:150-157``), and a checkpoint round trip
  of such a state;
* the launcher's image embeddings and the launcher on the CPU, and its
  resume.

The card's side (train steps through the attention kernels, the backward
at the cross layer's shape) is in tests/test_torch_gpu.py.
"""
import dataclasses
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_port, model_params_to_port, stack_tree
from repro_torch.kernels import ops
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention as tattn
from repro_torch.models.transformer import CallConfig
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (load_state_tree, make_train_state, make_train_step,
                                          state_tree)

ARCH = "llama-3.2-vision-90b"
SEQ = 24
GRAD_TOL = dict(rtol=1e-3)  # and atol 1e-4 of the largest gradient (tests/test_layers.py:121)
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


def _close_grad(got, want, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all(), msg
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), err_msg=msg,
                               **GRAD_TOL)


# ---- the attention backward at Sq != Skv ------------------------------------------------


@pytest.mark.parametrize("sq,skv,h,kvh,hd", [
    (37, 16, 4, 2, 32),     # reduced vlm's cross layer: 16 image tokens
    (300, 77, 4, 2, 32),    # a ragged key count below the query count
    (1, 130, 8, 1, 64),     # a decode step's one query, GQA 8:1
    (64, 200, 6, 3, 128),   # more keys than queries, hd 128
    (70, 65, 8, 8, 128),    # one key past a 64-key block
])
def test_cross_shape_backward_matches_the_custom_vjp(sq, skv, h, kvh, hd):
    """dq, dk, dv of ops.flash_attention, non-causal, against jax.vjp of the
    model attention's custom_vjp, Sq queries against Skv keys."""
    rng = np.random.default_rng(sq * 7 + skv + hd)
    qn = rng.normal(size=(2, sq, h, hd)).astype(np.float32)
    kn, vn = (rng.normal(size=(2, skv, kvh, hd)).astype(np.float32) for _ in range(2))
    dn = rng.normal(size=(2, sq, h, hd)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, causal=False),
                         jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want = vjp(jnp.asarray(dn))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    out = ops.flash_attention(q, k, v, causal=False)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    np.testing.assert_allclose(_np(out), _np(out_j), rtol=2e-5, atol=1e-5)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(dn))
    for name, a, b in zip("qkv", got, want):
        assert tuple(a.shape) == b.shape
        _close_grad(a, b, f"d{name}")


def test_the_attention_function_keeps_causal_false_for_its_backward():
    """A non-causal forward's backward is the non-causal one: at Sq == Skv
    the causal backward differs, so the gradients tell which ran."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 20, 2, 32)).astype(np.float32))
               .requires_grad_() for _ in range(3))
    grads = {}
    for causal in (False, True):
        out = ops.flash_attention(q, k, v, causal=causal)
        grads[causal] = torch.autograd.grad(out.square().sum(), (q, k, v))
        want = torch.autograd.grad(
            tattn.naive_attention(q, k, v, causal=causal).square().sum(), (q, k, v))
        for a, b in zip(grads[causal], want):
            _close_grad(a, b)
    assert not torch.allclose(grads[False][1], grads[True][1])


def test_cross_attention_gradients_match_jax_vjp():
    """cross_attention = cross_kv + cross_attention_kv under autograd (no
    in-place write into a saved tensor, no no_grad): the gradients of wq,
    wk, wv, wo, the text stream x and the image context against jax.vjp of
    the reference's cross_attention, Sq = 33 against T = 21."""
    rng = np.random.default_rng(9)
    d, H, KVH, S, T = 128, 4, 2, 33, 21
    p_np = {n: (rng.normal(size=s) / math.sqrt(s[0])).astype(np.float32) for n, s in
            (("wq", (d, d)), ("wk", (d, d // 2)), ("wv", (d, d // 2)), ("wo", (d, d)))}
    x_np = rng.normal(size=(2, S, d)).astype(np.float32)
    c_np = rng.normal(size=(2, T, d)).astype(np.float32)
    g_np = rng.normal(size=(2, S, d)).astype(np.float32)
    fn = lambda p, x, c: jattn.cross_attention(p, x, c, H, KVH)  # noqa: E731
    _, vjp = jax.vjp(fn, {k: jnp.asarray(a) for k, a in p_np.items()}, jnp.asarray(x_np),
                     jnp.asarray(c_np))
    jp, jx, jc = vjp(jnp.asarray(g_np))
    p = {k: torch.from_numpy(a).requires_grad_() for k, a in p_np.items()}
    x, c = torch.from_numpy(x_np).requires_grad_(), torch.from_numpy(c_np).requires_grad_()
    y = tattn.cross_attention(p, x, c, H, KVH)
    got = torch.autograd.grad(y, [*p.values(), x, c], torch.from_numpy(g_np))
    for name, a in zip(list(p) + ["x", "ctx"], got):
        _close_grad(a, jp[name] if name in p else (jx if name == "x" else jc), name)


# ---- the model's loss and gradients ----------------------------------------------------


def _cfgs():
    """Reduced llama-3.2-vision-90b in both packages: one group of a self
    layer and a cross layer."""
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def vlm():
    """The JAX params and a batch of 2 x SEQ tokens with 2 images of 16
    image tokens (normal, unit scale)."""
    jcfg, _ = _cfgs()
    params = jax_build_model(jcfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(51)
    toks = rng.integers(1, jcfg.vocab_size, size=(2, SEQ + 1)).astype(np.int32)
    img = rng.normal(size=(2, jcfg.num_image_tokens, jcfg.d_model)).astype(np.float32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "image_embeds": img}
    return params, jax.tree.map(np.asarray, params), batch


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _models(np_params, dtype="float32", remat="block"):
    jd, td = DTYPES[dtype]
    jcfg, tcfg = _cfgs()
    jm = jax_build_model(jcfg, JaxCallConfig(remat=remat, compute_dtype=jd))
    tm = model_params_to_port(tcfg, np_params, cc=CallConfig(compute_dtype=td, remat=remat),
                              device="cpu")
    return jm, tm


def test_the_config_is_one_group_of_a_self_and_a_cross_layer(vlm):
    _, tm = _models(vlm[1])
    assert len(tm.blocks) == 1 and len(tm.blocks[0].selfs) == 1
    assert tm.cfg.num_image_tokens == 16 and tm.cfg.d_model == 128
    assert not any("bq" in n for n, _ in tm.blocks[0].cross.named_parameters())


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_loss_matches_the_reference(vlm, dtype, rtol):
    params, np_params, batch = vlm
    jm, tm = _models(np_params, dtype)
    jloss, jmets = jm.loss(params, _jbatch(batch))
    with torch.no_grad():
        tloss, tmets = tm.loss(batch)
    assert tloss.dtype == torch.float32 and set(tmets) == {"nll", "aux"}
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=rtol)
    np.testing.assert_allclose(float(tmets["nll"]), float(jmets["nll"]), rtol=rtol)
    assert float(tmets["aux"]) == float(jmets["aux"]) == 0.0


def test_the_train_forward_needs_the_image_embeddings(vlm):
    _, tm = _models(vlm[1])
    batch = {k: v for k, v in vlm[2].items() if k != "image_embeds"}
    with pytest.raises(ValueError, match="image_embeds"):
        tm.loss(batch)


def _port_grads(tm, batch):
    tm.requires_grad_(True)
    params = dict(tm.named_parameters())
    loss, _ = tm.loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), {n: g.numpy() for n, g in zip(params, grads)}


def test_every_gradient_leaf_matches_value_and_grad(vlm):
    """Every leaf, the cross layer's wq, wk, wv and wo among them (wk and wv
    through the image projection alone)."""
    params, np_params, batch = vlm
    jm, tm = _models(np_params)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(params, _jbatch(batch))
    tloss, tgrads = _port_grads(tm, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    got = jax.tree_util.tree_flatten_with_path(stack_tree(tm.cfg, tm, tgrads))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    keys = [jax.tree_util.keystr(p) for p, _ in got]
    assert keys == [jax.tree_util.keystr(p) for p, _ in want]
    for w in ("wq", "wk", "wv", "wo"):
        assert f"['blocks']['cross']['attn']['{w}']" in keys
    for (path, g), (_, w) in zip(got, want):
        assert np.abs(np.asarray(w)).max() > 0, jax.tree_util.keystr(path)
        _close_grad(g, w, jax.tree_util.keystr(path))


def test_remat_block_and_none_give_the_same_loss_and_gradients(vlm):
    """A checkpoint a layer (the port) or none: the same bits. The image
    context enters the cross layer's checkpoint as an input."""
    _, np_params, batch = vlm
    _, tm_block = _models(np_params, remat="block")
    _, tm_none = _models(np_params, remat="none")
    lb, gb = _port_grads(tm_block, batch)
    ln, gn = _port_grads(tm_none, batch)
    assert torch.equal(lb, ln)
    for n in gb:
        np.testing.assert_array_equal(gb[n], gn[n], err_msg=n)


def test_serving_logits_are_the_train_forwards(vlm):
    """The serving forward (no grad, no cache) and the train forward give
    the same logits, bit for bit; serving builds no graph."""
    _, np_params, batch = vlm
    _, tm = _models(np_params)
    tm.requires_grad_(True)
    served, _ = tm.forward(batch["tokens"], image_embeds=batch["image_embeds"])
    trained, aux = tm.forward_train(batch["tokens"], image_embeds=batch["image_embeds"])
    assert served.grad_fn is None and trained.grad_fn is not None
    assert torch.equal(served, trained.detach()) and float(aux) == 0.0


# ---- bf16 master weights -------------------------------------------------------------


def test_cast_params_casts_float32_leaves_in_place():
    ps = {"a": torch.nn.Parameter(torch.randn(3, 4)), "b": torch.arange(3),
          "c": torch.randn(5, dtype=torch.float64)}
    before = {k: v for k, v in ps.items()}
    want = ps["a"].detach().to(torch.bfloat16)
    topt.cast_params(ps, topt.OptConfig())  # fp32 masters: nothing changes
    assert ps["a"].dtype == torch.float32
    topt.cast_params(ps, topt.OptConfig(param_dtype="bf16"))
    assert all(ps[k] is before[k] for k in ps)  # the same objects
    assert ps["a"].dtype == torch.bfloat16 and isinstance(ps["a"], torch.nn.Parameter)
    assert torch.equal(ps["a"].detach(), want)
    assert ps["b"].dtype == torch.int64 and ps["c"].dtype == torch.float64
    with pytest.raises(ValueError, match="param_dtype"):
        topt.cast_params(ps, topt.OptConfig(param_dtype="fp16"))


def test_bf16_masters_make_the_weight_casts_no_ops(vlm):
    """On bf16 masters a bf16 product's weight cast returns the weight
    itself, and the train forward gives the bits of f32 masters holding the
    same bf16 values."""
    _, np_params, batch = vlm
    _, tm = _models(np_params, "bfloat16")
    _, rounded = _models(np_params, "bfloat16")
    ocfg = topt.OptConfig(param_dtype="bf16", moment_dtype="bf16")
    make_train_state(tm, None, ocfg)
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.to(torch.bfloat16).float())
    wq = tm.blocks[0].cross.attn["wq"]
    assert wq.dtype == torch.bfloat16 and wq.to(torch.bfloat16) is wq
    assert all(p.dtype == torch.bfloat16 for p in tm.parameters())
    got, _ = tm.forward_train(batch["tokens"], image_embeds=batch["image_embeds"])
    want, _ = rounded.forward_train(batch["tokens"], image_embeds=batch["image_embeds"])
    assert torch.equal(got, want)


def _bf16_tree(tree):
    """The reference dry run's cast of a state's parameters
    (repro/launch/dryrun.py:150-157): float32 leaves to bfloat16."""
    return jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a, tree)


# the limits of three bf16-master steps, 1.5 times the largest reading over
# accum 1 and 2 or above it: the lr 3e-3 update is about one bfloat16 step of
# a weight near 0.3, so where the two packages' float32 updates differ by
# rounding a parameter element rounds to the neighbouring bf16 value. At most
# FLIPPED of a leaf's elements differ (reading 0.40 %, unembed.table) and
# none by more than MOVED of how far the leaf moved (reading 0.20, one
# bfloat16 step of cross.attn.wq); a leaf updated wrongly or not at all
# differs in most elements by the whole of it. The moments (bf16 roundings of
# float32 sums of gradients that differ by rounding) within the bfloat16
# tolerance, 2e-2 of the leaf's largest element (reading 4.4e-3)
FLIPPED, MOVED, MOMENT_TOL = 0.01, 0.3, 2e-2


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_on_bf16_masters_matches_the_reference(vlm, accum):
    """Three steps on bf16 masters and bf16 moments from the same converted
    parameters (float32 compute, Adam eps 1e-6: ROADMAP Queue 3, item 23):
    the losses within rtol 2e-5 and the grad norms within 1e-4 at every
    step; every parameter and moment leaf bfloat16 in both packages, the
    parameters within FLIPPED and MOVED, the moments within MOMENT_TOL."""
    params, np_params, batch = vlm
    jm, tm = _models(np_params)
    ocfg = dict(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=3, eps=1e-6,
                moment_dtype="bf16", param_dtype="bf16")
    jc, tc = jopt.OptConfig(**ocfg), topt.OptConfig(**ocfg)
    jparams = _bf16_tree(params)
    jstep = jax.jit(jax_make_train_step(jm, jc, accum_steps=accum))
    jstate = {"params": jparams, "opt": jopt.init_opt_state(jparams, jc),
              "rng": jax.random.PRNGKey(0)}
    tstate = make_train_state(tm, None, tc)
    tstep = make_train_step(tm, tc, accum_steps=accum)
    rng = np.random.default_rng(61)
    for _ in range(3):
        toks = rng.integers(1, 512, size=(2, SEQ + 1)).astype(np.int32)
        b = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "image_embeds": batch["image_embeds"]}
        jstate, jmets = jstep(jstate, _jbatch(b))
        tstate, tmets = tstep(tstate, b)
        np.testing.assert_allclose(float(tmets["loss"]), float(jmets["loss"]), rtol=2e-5)
        assert float(tmets["grad_norm"]) == pytest.approx(float(jmets["grad_norm"]), rel=1e-4)
    assert int(tstate["opt"]["step"]) == 3
    tree = state_tree(tstate)
    init = jax.tree.leaves(jparams)
    for part in ("params", "m", "v"):
        got_t = tree[part] if part == "params" else tree["opt"][part]
        want_t = jstate[part] if part == "params" else jstate["opt"][part]
        for i, ((path, g), w) in enumerate(zip(jax.tree_util.tree_flatten_with_path(got_t)[0],
                                               jax.tree.leaves(want_t))):
            name = f"{part} {jax.tree_util.keystr(path)}"
            assert g.dtype.name == "bfloat16" and w.dtype == jnp.bfloat16, name
            g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
            off = np.abs(g - w)
            if part == "params":
                moved = np.abs(w - np.asarray(init[i], np.float32)).max()
                assert moved > 0 and (off > 0).mean() <= FLIPPED, (name, (off > 0).mean())
                assert off.max() <= MOVED * moved, (name, off.max() / moved)
            else:
                assert off.max() <= MOMENT_TOL * np.abs(w).max(), name


def test_a_bf16_master_state_round_trips_through_a_checkpoint(vlm, tmp_path):
    """A state on bf16 masters and bf16 moments after one step: saved in the
    reference's layout (bfloat16 leaves), restored into a fresh state,
    every parameter and moment bitwise; a second step from both is the
    same."""
    _, np_params, batch = vlm
    ocfg = topt.OptConfig(lr=3e-3, warmup_steps=1, total_steps=4, moment_dtype="bf16",
                          param_dtype="bf16")
    _, tm = _models(np_params, "bfloat16")
    state, step = make_train_state(tm, None, ocfg), make_train_step(tm, ocfg)
    state, _ = step(state, batch)
    tree = state_tree(state)
    assert {np.asarray(a).dtype.name for a in jax.tree.leaves(tree["params"])} == {"bfloat16"}
    ckpt_lib.save(str(tmp_path), 1, tree)
    _, fresh_model = _models(np_params, "bfloat16")
    fresh = make_train_state(fresh_model, None, ocfg)
    restored, manifest = ckpt_lib.restore(str(tmp_path), state_tree(fresh, template=True))
    load_state_tree(fresh, restored)
    assert manifest["step"] == 1 and int(fresh["opt"]["step"]) == 1
    for (n, a), b in zip(tm.named_parameters(), fresh_model.parameters()):
        assert b.dtype == torch.bfloat16 and torch.equal(a, b), n
    for which in ("m", "v"):
        for n, m in state["opt"][which].items():
            assert torch.equal(m, fresh["opt"][which][n]), (which, n)
    _, m1 = step(state, batch)
    _, m2 = make_train_step(fresh_model, ocfg)(fresh, batch)
    assert float(m1["loss"]) == float(m2["loss"])


def test_model_params_from_port_reads_bf16_masters_as_float32(vlm):
    _, np_params, _ = vlm
    _, tm = _models(np_params)
    topt.cast_params(dict(tm.named_parameters()), topt.OptConfig(param_dtype="bf16"))
    back = model_params_from_port(tm)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(_bf16_tree(np_params))):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b, np.float32))


# ---- the launcher -----------------------------------------------------------------


def test_image_embeds_are_drawn_per_step():
    cfg = get_config(ARCH).reduced()
    a = train_launcher.image_embeds_at(cfg, 3, 0, 5, "cpu")
    assert tuple(a.shape) == (3, cfg.num_image_tokens, cfg.d_model)
    assert a.dtype == torch.bfloat16
    assert torch.equal(a, train_launcher.image_embeds_at(cfg, 3, 0, 5, "cpu"))
    assert not torch.equal(a, train_launcher.image_embeds_at(cfg, 3, 0, 6, "cpu"))
    assert not torch.equal(a, train_launcher.image_embeds_at(cfg, 3, 1, 5, "cpu"))
    assert 0.015 < float(a.float().std()) < 0.025  # normal x 0.02


ARGS = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4", "--seq", str(SEQ),
        "--log-every", "1"]


def test_launcher_trains_vlm_and_its_loss_falls(capsys):
    losses = train_launcher.main(ARGS + ["--steps", "10"])
    assert len(losses) == 10 and all(math.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]
    assert "ms/step" in capsys.readouterr().out


def test_launcher_resume_continues_the_uninterrupted_vlm_run(tmp_path, capsys):
    """The resumed run draws each step's image embeddings as the
    uninterrupted one did: the same losses."""
    full = train_launcher.main(ARGS + ["--steps", "6"])
    d = str(tmp_path / "ckpt")
    first = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "3"])
    assert first == full
    shutil.rmtree(tmp_path / "ckpt" / "step_00000006")
    rest = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert rest == full[3:]


def test_accumulation_splits_the_image_embeddings(vlm):
    """accum 2 cuts image_embeds along the batch with the tokens: the loss is
    the mean of the two halves' losses."""
    _, np_params, batch = vlm
    _, tm = _models(np_params)
    ocfg = topt.OptConfig(schedule="const", warmup_steps=1)
    halves = []
    for i in range(2):
        with torch.no_grad():
            halves.append(float(tm.loss({k: v[i:i + 1] for k, v in batch.items()})[0]))
    state = make_train_state(tm, None, ocfg)
    _, mets = make_train_step(tm, ocfg, accum_steps=2)(state, batch)
    assert float(mets["loss"]) == pytest.approx(sum(halves) / 2, rel=1e-6)


def test_dataclasses_replace_keeps_the_vlm_layout():
    """The chip's cut, num_layers 5 of llama-3.2-vision-90b, is one group of
    4 self layers and the cross layer."""
    cfg = dataclasses.replace(get_config(ARCH), num_layers=5)
    assert cfg.num_layers // cfg.cross_attn_every == 1 and cfg.cross_attn_every - 1 == 4
