"""Training in the port against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and the
port (``repro_torch``), both in float32 unless a test says otherwise:

* the attention backward: ``ops.flash_attention`` through its autograd
  Function (the plain backward ``flash_attention_bwd_ref`` on the CPU)
  against ``jax.vjp`` of the model attention's ``custom_vjp``
  (``repro.models.attention.flash_attention``), at rtol 1e-3, atol 1e-4,
  the reference's own gradient tolerance (tests/test_layers.py:121);
* ``Model.loss`` of reduced smollm-135m (2 layers, d 128, hd 32, vocab 512)
  against the reference's (float32 rtol 2e-5, bfloat16 2e-2) and every
  gradient leaf against ``jax.value_and_grad`` (rtol 1e-3, atol 1e-4 of the
  leaf's largest gradient);
* ``schedule_lr``, ``adamw_update`` (fp32, bf16 and int8 moments) and
  ``make_train_step`` (accumulation 1 and 2) against the reference's;
* the launcher on the CPU.

The card's side (the CUDA backward kernel, train steps through it) is in
tests/test_torch_gpu.py.
"""
import math

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
from repro_torch.configs import ARCHS, get_config
from repro_torch.convert import (model_params_from_port, model_params_to_port, stack_tree,
                                 unstack_tree)
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_bwd_ref, flash_attention_ref
from repro_torch.launch import train as train_launcher
from repro_torch.models.transformer import FAMILIES, CallConfig, build_model
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_state, make_train_step

GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_layers.py:121


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


# ---- the attention backward -------------------------------------------------------


def _qkv(rng, B, S, H, KVH, hd):
    return (rng.normal(size=(B, S, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, KVH, hd)).astype(np.float32),
            rng.normal(size=(B, S, KVH, hd)).astype(np.float32))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("g", [1, 3], ids=lambda g: f"G{g}")
@pytest.mark.parametrize("hd", [32, 64, 128], ids=lambda h: f"hd{h}")
@pytest.mark.parametrize("S", [1, 37, 64, 130], ids=lambda s: f"S{s}")
def test_attention_backward_matches_the_custom_vjp(S, hd, g, causal):
    """dq, dk, dv of ops.flash_attention (its Function, the plain backward on
    the CPU) against jax.vjp of the model attention's custom_vjp."""
    KVH = 2
    H = KVH * g
    rng = np.random.default_rng(S * 1000 + hd * 10 + g + causal)
    qn, kn, vn = _qkv(rng, 2, S, H, KVH, hd)
    dn = rng.normal(size=(2, S, H, hd)).astype(np.float32)
    out_j, vjp = jax.vjp(lambda q, k, v: jattn.flash_attention(q, k, v, causal=causal),
                         jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn))
    want = vjp(jnp.asarray(dn))
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    out = ops.flash_attention(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(out), _np(out_j), rtol=2e-5, atol=1e-5)
    got = torch.autograd.grad(out, (q, k, v), torch.from_numpy(dn))
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("B,S,H,KVH,hd,causal", [(2, 37, 6, 3, 32, True), (1, 64, 4, 4, 64, False),
                                                 (2, 130, 3, 1, 128, True)])
def test_plain_backward_is_the_gradient_of_the_plain_forward(B, S, H, KVH, hd, causal):
    """flash_attention_bwd_ref against autograd through flash_attention_ref,
    and its lse against the reference's (B, Sq, KVH, G) lse."""
    rng = np.random.default_rng(B + S + hd)
    qn, kn, vn = _qkv(rng, B, S, H, KVH, hd)
    dn = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in (qn, kn, vn))
    out, lse = flash_attention_ref(q, k, v, causal=causal, return_lse=True)
    assert tuple(lse.shape) == (B, H, S) and lse.dtype == torch.float32
    want = torch.autograd.grad(out, (q, k, v), torch.from_numpy(dn))
    got = flash_attention_bwd_ref(q.detach(), k.detach(), v.detach(), out.detach(), lse.detach(),
                                  torch.from_numpy(dn), causal=causal)
    for name, a, b in zip("qkv", got, want):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=f"d{name}", **GRAD_TOL)
    _, jlse = jattn._flash_fwd_impl(jnp.asarray(qn), jnp.asarray(kn), jnp.asarray(vn), causal, 512)
    np.testing.assert_allclose(_np(lse), _np(jlse).reshape(B, S, H).transpose(0, 2, 1),
                               rtol=2e-5, atol=1e-5)


def test_plain_forward_output_does_not_depend_on_lse():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 45, 4, 2, 32))
    for dtype in (torch.float32, torch.bfloat16):
        a = flash_attention_ref(q.to(dtype), k.to(dtype), v.to(dtype))
        b, _ = flash_attention_ref(q.to(dtype), k.to(dtype), v.to(dtype), return_lse=True)
        assert torch.equal(a, b)


def test_attention_without_grad_takes_the_forward_alone():
    """No grad (serving): the plain forward, no Function in the graph; with
    grad but no input requiring it, the same."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 1, 20, 2, 2, 32))
    want = flash_attention_ref(q, k, v)
    assert torch.equal(ops.flash_attention(q, k, v), want)
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None and torch.equal(out, want)
    out = ops.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"


# ---- the model's loss and gradients ---------------------------------------------------


@pytest.fixture(scope="module")
def smollm():
    """Reduced smollm-135m: the JAX params and a batch of 2 x 24 tokens."""
    cfg = jax_get_config("smollm-135m").reduced()
    params = jax_build_model(cfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(11)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return cfg, params, jax.tree.map(np.asarray, params), batch


def _models(np_params, dtype="float32", remat="block"):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    cfg = jax_get_config("smollm-135m").reduced()
    jm = jax_build_model(cfg, JaxCallConfig(remat=remat, compute_dtype=jd))
    tm = model_params_to_port(get_config("smollm-135m").reduced(), np_params,
                              cc=CallConfig(compute_dtype=td, remat=remat), device="cpu")
    return jm, tm


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_loss_matches_the_reference(smollm, dtype, rtol):
    _, params, np_params, batch = smollm
    jm, tm = _models(np_params, dtype)
    jloss, jmets = jm.loss(params, {k: jnp.asarray(v) for k, v in batch.items()})
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
    return loss.detach(), {n: g.numpy() for n, g in zip(params, grads)}


def test_every_gradient_leaf_matches_value_and_grad(smollm):
    cfg, params, np_params, batch = smollm
    jm, tm = _models(np_params)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = _port_grads(tm, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    got = stack_tree(tm.cfg, tm, tgrads)
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got_flat] == \
        [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got_flat, want):
        w = np.asarray(w)
        assert g.shape == w.shape, jax.tree_util.keystr(path)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-4 * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_block_and_none_give_the_same_loss_and_gradients(smollm):
    _, _, np_params, batch = smollm
    _, tm_block = _models(np_params, remat="block")
    _, tm_none = _models(np_params, remat="none")
    lb, gb = _port_grads(tm_block, batch)
    ln, gn = _port_grads(tm_none, batch)
    assert torch.equal(lb, ln)
    for n in gb:
        np.testing.assert_array_equal(gb[n], gn[n], err_msg=n)


def test_remat_is_checked_and_serving_stays_without_grad(smollm):
    _, _, np_params, batch = smollm
    with pytest.raises(ValueError, match="remat"):
        build_model(get_config("smollm-135m").reduced(), CallConfig(remat="full"), device="cpu")
    _, tm = _models(np_params)
    tm.requires_grad_(True)
    logits, _ = tm.forward(batch["tokens"])
    assert logits.grad_fn is None and not logits.requires_grad
    cache = tm.init_cache(2, 32)
    last, _ = tm.prefill(batch["tokens"], cache)
    step, _ = tm.decode_step(batch["targets"][:, -1:], cache, 24)
    assert last.grad_fn is None and step.grad_fn is None


def test_tied_embedding_is_one_parameter():
    tm = build_model(get_config("smollm-135m").reduced(), device="cpu")
    names = [n for n, _ in tm.named_parameters()]
    assert "embed.table" in names and not any(n.startswith("unembed") for n in names)


@pytest.mark.parametrize("family", FAMILIES)
def test_other_families_refuse_to_train(family):
    """No family refuses to train any more: on each family's first reduced
    config one loss and its backward are finite, every parameter getting a
    finite gradient (vlm with image embeddings, audio with (B, S, K)
    tokens)."""
    name = next(n for n in sorted(ARCHS) if get_config(n).family == family)
    cfg = get_config(name).reduced()
    tm = build_model(cfg, CallConfig(compute_dtype=torch.float32), device="cpu")
    shape = (1, 8, cfg.num_codebooks) if cfg.num_codebooks else (1, 8)
    toks = np.random.default_rng(len(name)).integers(1, cfg.vocab_size, size=shape)
    batch = {"tokens": toks, "targets": toks}
    if family == "vlm":
        batch["image_embeds"] = np.zeros((1, cfg.num_image_tokens, cfg.d_model), np.float32)
    tm.requires_grad_(True)
    params = [p for _, p in tm.named_parameters()]
    loss, _ = tm.loss(batch)
    grads = torch.autograd.grad(loss, params)
    assert math.isfinite(float(loss.detach()))
    assert all(torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_params_from_port_inverts_params_to_port(arch):
    """model_params_from_port(model_params_to_port(tree)) is the tree, with
    the structure and shapes of the reference's Model.init, for every
    family's layout."""
    cfg = get_config(arch).reduced()
    shapes = jax.eval_shape(jax_build_model(jax_get_config(arch).reduced()).init,
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(len(arch))
    tree = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32), shapes)
    back = model_params_from_port(model_params_to_port(cfg, tree, device="cpu"))
    flat_t, def_t = jax.tree.flatten(tree)
    flat_b, def_b = jax.tree.flatten(back)
    assert def_t == def_b
    for a, b in zip(flat_t, flat_b):
        np.testing.assert_array_equal(a, b)
    model = build_model(cfg, device="cpu")
    assert set(unstack_tree(cfg, model, tree)) == set(model.state_dict())


# ---- the optimizer ------------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["const", "cosine", "wsd"])
def test_schedule_lr_matches_the_reference(schedule):
    cfg = dict(lr=3e-3, schedule=schedule, warmup_steps=7, total_steps=60, decay_frac=0.2,
               min_lr_ratio=0.1)
    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    for s in range(0, 66):
        want = float(jopt.schedule_lr(jc, jnp.int32(s)))
        got = topt.schedule_lr(tc, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), s


def _tree_params(rng):
    return {"a": rng.normal(size=(5, 12)).astype(np.float32),
            "b": rng.normal(size=(7,)).astype(np.float32),
            "c": rng.normal(size=(3, 4, 9)).astype(np.float32)}


@pytest.mark.parametrize("moments", ["fp32", "bf16", "int8"])
def test_adamw_update_matches_the_reference(moments):
    """Three steps from the same parameters and gradients: the parameters
    and moments after each; int8 codes equal (a differing code counted and
    printed), scales within float32 rounding."""
    cfg = dict(lr=1e-2, schedule="cosine", warmup_steps=2, total_steps=10, moment_dtype=moments,
               clip_norm=2.0)
    jc, tc = jopt.OptConfig(**cfg), topt.OptConfig(**cfg)
    rng = np.random.default_rng(5)
    init = _tree_params(rng)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    js, ts = jopt.init_opt_state(jp, jc), topt.init_opt_state(tp, tc)
    differing = 0
    for step in range(3):
        g = {k: (rng.normal(size=v.shape) * (step + 1)).astype(np.float32)
             for k, v in init.items()}
        jp, js, jm = jopt.adamw_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, jc)
        tp2, ts2, tm = topt.adamw_update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts, tc)
        assert tp2 is tp and ts2 is ts  # in place
        assert int(ts["step"]) == int(js["step"]) == step + 1
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        for k in init:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
            for which in ("m", "v"):
                jl, tl = js[which][k], ts[which][k]
                if moments == "int8":
                    codes_j, codes_t = np.asarray(jl["q"]), tl["q"].numpy()
                    assert codes_t.dtype == codes_j.dtype
                    differing += int((codes_j != codes_t).sum())
                    np.testing.assert_allclose(tl["scale"].numpy(), np.asarray(jl["scale"]),
                                               rtol=1e-6)
                else:
                    assert (tl.dtype == torch.bfloat16) == (moments == "bf16")
                    np.testing.assert_allclose(_np(tl), _np(jl), rtol=1e-5, atol=1e-9)
    print(f"{moments}: {differing} int8 codes differ from the reference's")
    assert differing == 0


def test_adamw_converges_on_quadratic():
    cfg = topt.OptConfig(lr=0.1, weight_decay=0.0, schedule="const", warmup_steps=1,
                         total_steps=100)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = topt.init_opt_state(params, cfg)
    target = torch.tensor([1.0, 2.0])
    for _ in range(200):
        g = {"w": 2 * (params["w"] - target)}
        topt.adamw_update(params, g, state, cfg)
    np.testing.assert_allclose(params["w"].numpy(), target.numpy(), atol=1e-2)


def test_wsd_schedule_shape():
    cfg = topt.OptConfig(lr=1.0, schedule="wsd", warmup_steps=10, total_steps=100,
                         decay_frac=0.2, min_lr_ratio=0.1)
    lrs = [float(topt.schedule_lr(cfg, s)) for s in range(101)]
    assert lrs[0] == 0.0 and lrs[10] == pytest.approx(1.0)
    assert lrs[50] == pytest.approx(1.0)                      # stable phase flat
    assert lrs[100] == pytest.approx(0.1, rel=1e-3)           # decayed tail
    assert all(a >= b - 1e-9 for a, b in zip(lrs[10:], lrs[11:]))  # monotone after warmup


@pytest.mark.parametrize("shape", [(8,), (4, 16), (2, 3, 8), ()])
@pytest.mark.parametrize("signed", [True, False])
def test_int8_moment_roundtrip_error(shape, signed):
    x = torch.from_numpy(np.random.default_rng(sum(shape) + 1).normal(size=shape)
                         .astype(np.float32))
    if not signed:
        x = x.abs()
    q = topt._quant(x, signed)
    assert q["q"].dtype == (torch.int8 if signed else torch.uint8)
    err = (topt._dequant(q) - x).abs().max()
    assert float(err) <= float(x.abs().max()) / (127 if signed else 255) + 1e-7
    jq = jopt._quant(jnp.asarray(x.numpy()), signed)
    np.testing.assert_array_equal(q["q"].numpy(), np.asarray(jq["q"]))


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(topt.global_norm(t)) == pytest.approx(5.0)
    assert float(topt.global_norm([t["a"], {"c": t["b"]}])) == pytest.approx(5.0)


# ---- the train step ------------------------------------------------------------------


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(smollm, accum):
    """Three steps from the same converted parameters: the losses within rtol
    2e-5; each parameter leaf within 1e-5 + 1e-3 max|p_jax - p_init|.

    Adam's eps is 1e-6 here. At the default 1e-8 an update divides gradient
    elements near 1e-8 (a few in every leaf) by about their own size, so
    float32 rounding noise of ~1e-6 max|g| in them moves a parameter by a
    share of lr: the reference run eagerly without remat lands 9.0 times
    this limit from its own jitted run, the port 1.46 times (ROADMAP Queue
    3, item 23). At 1e-6 the two are 0.35 and 0.60 times the limit."""
    _, params, np_params, _ = smollm
    jm, tm = _models(np_params)
    ocfg = dict(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=3, eps=1e-6)
    jstep = jax.jit(jax_make_train_step(jm, jopt.OptConfig(**ocfg), accum_steps=accum))
    tstep = make_train_step(tm, topt.OptConfig(**ocfg), accum_steps=accum)
    jstate = {"params": params, "opt": jopt.init_opt_state(params, jopt.OptConfig(**ocfg)),
              "rng": jax.random.PRNGKey(0)}
    tstate = make_train_state(tm, None, topt.OptConfig(**ocfg))
    rng = np.random.default_rng(21)
    for step in range(3):
        toks = rng.integers(1, 512, size=(4, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        jstate, jmets = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmets = tstep(tstate, batch)
        np.testing.assert_allclose(float(tmets["loss"]), float(jmets["loss"]), rtol=2e-5)
        np.testing.assert_allclose(float(tmets["nll"]), float(jmets["nll"]), rtol=2e-5)
        assert float(tmets["grad_norm"]) == pytest.approx(float(jmets["grad_norm"]), rel=1e-4)
    assert int(tstate["opt"]["step"]) == 3
    got = model_params_from_port(tm)
    for (path, g), w, p0 in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree.leaves(jstate["params"]), jax.tree.leaves(np_params)):
        w = np.asarray(w)
        moved = np.abs(w - p0).max()
        assert np.abs(g - w).max() <= 1e-5 + 1e-3 * moved, jax.tree_util.keystr(path)


def test_grad_transform_sees_the_gradients_and_keeps_its_carry(smollm):
    _, _, np_params, batch = smollm
    _, tm = _models(np_params)
    seen = []

    def halve(grads, carry):
        seen.append(sorted(grads))
        return {n: g / 2 for n, g in grads.items()}, (carry or 0) + 1

    ocfg = topt.OptConfig(schedule="const", warmup_steps=1)
    step = make_train_step(tm, ocfg, grad_transform=halve)
    state = make_train_state(tm, None, ocfg)
    for _ in range(2):
        state, mets = step(state, batch)
    assert state["grad_carry"] == 2
    assert seen[0] == sorted(n for n, _ in tm.named_parameters())


# ---- the launcher -----------------------------------------------------------------


ARGS = ["--reduced", "--device", "cpu", "--batch", "4", "--seq", "32", "--log-every", "1"]


def test_launcher_trains_and_its_loss_falls(capsys):
    losses = train_launcher.main(ARGS + ["--steps", "12"])
    assert len(losses) == 12 and all(math.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]
    assert "ms/step" in capsys.readouterr().out


def test_launcher_resume_continues_the_uninterrupted_run(tmp_path, capsys):
    full = train_launcher.main(ARGS + ["--steps", "6"])
    d = str(tmp_path / "ckpt")
    first = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "3"])
    assert first == full
    # a run of 6 steps from the step-3 checkpoint (the step-6 one removed)
    import shutil
    shutil.rmtree(tmp_path / "ckpt" / "step_00000006")
    rest = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert rest == full[3:]


def test_launcher_refuses_other_families(capsys):
    """The launcher refuses no family: reduced musicgen-large, the last to
    train, takes one step."""
    losses = train_launcher.main(["--arch", "musicgen-large", "--reduced", "--device", "cpu",
                                  "--steps", "1", "--batch", "2", "--seq", "16"])
    assert len(losses) == 1 and math.isfinite(losses[0])
    assert "step     1" in capsys.readouterr().out
