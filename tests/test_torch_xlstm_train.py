"""Training the ssm family (xlstm-350m) in the port against the JAX package,
on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and the
port (``repro_torch``), in float32 unless a test says otherwise, at the
reference's gradient tolerance rtol 1e-3, atol 1e-4 of the largest gradient
(tests/test_layers.py:121):

* the sLSTM's plain backward ``slstm_bwd_ref`` against autograd of the plain
  forward ``slstm_ref`` and against ``jax.vjp`` of the reference's scan over
  ``repro.models.xlstm._slstm_cell`` (the step of ``slstm_forward``);
* ``ops.slstm`` through its autograd Function ``SLSTMFused`` under grad, the
  forward alone without; the sLSTM and mLSTM blocks' gradients against
  ``jax.grad`` of the reference's blocks;
* ``Model.loss`` of reduced xlstm-350m (1 [mLSTM, sLSTM] pair, d_model 128,
  4 heads of 32, vocab 512) against the reference's (float32 rtol 2e-5,
  bfloat16 2e-2), every gradient leaf against ``jax.value_and_grad``, remat
  "block" against "none", ``make_train_step`` against the reference's;
* the launcher on the CPU.

The card's side (the CUDA backward kernel, train steps through it) is in
tests/test_torch_gpu.py.
"""
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import xlstm as jxlstm
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_port, model_params_to_port, stack_tree
from repro_torch.kernels import ops
from repro_torch.kernels.ref import slstm_bwd_ref, slstm_ref
from repro_torch.launch import train as train_launcher
from repro_torch.models import xlstm as txlstm
from repro_torch.models.transformer import CallConfig
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_state, make_train_step

ARCH = "xlstm-350m"
GRAD_TOL = dict(rtol=1e-3)  # and atol 1e-4 of the largest gradient (tests/test_layers.py:121)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _close_grad(got, want, msg=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and np.isfinite(got).all(), msg
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max(), err_msg=msg,
                               **GRAD_TOL)


# ---- the sLSTM recurrence's backward ----------------------------------------------------


def _recurrence_inputs(B, S, H, hd, seed):
    rng = np.random.default_rng(seed)
    D = H * hd
    gx = rng.normal(size=(B, S, 4, D)).astype(np.float32)
    rg = (rng.normal(size=(4, H, hd, hd)) / np.sqrt(hd)).astype(np.float32)
    dh = rng.normal(size=(B, S, D)).astype(np.float32)
    return gx, rg, dh


def _jax_slstm_h(gx, rg, H):
    """h (B, S, D) of the reference's scan over _slstm_cell from gate
    pre-activations gx (B, S, 4, D): slstm_forward's step, without its
    input and output projections."""
    B, S, _, D = gx.shape

    def step(state, g):
        new = jxlstm._slstm_cell({"rg": rg}, g.reshape(B, 4 * D), state, H, D // H)
        return new, new["h"]

    _, hs = jax.lax.scan(step, jxlstm.init_slstm_state(B, D, H), gx.swapaxes(0, 1))
    return hs.swapaxes(0, 1).reshape(B, S, D)


RECURRENCE_CASES = [(b, s, hd) for b in (1, 2) for s in (1, 37) for hd in (16, 32)]


@pytest.mark.parametrize("B,S,hd", RECURRENCE_CASES)
def test_plain_backward_is_the_gradient_of_the_plain_forward(B, S, hd):
    """slstm_bwd_ref on slstm_ref's saved state against autograd through
    slstm_ref; saving leaves h bitwise as it was."""
    H = 2
    gxn, rgn, dhn = _recurrence_inputs(B, S, H, hd, seed=B * 100 + S + hd)
    gx, rg = torch.from_numpy(gxn).requires_grad_(), torch.from_numpy(rgn).requires_grad_()
    h, _ = slstm_ref(gx, rg, H)
    want = torch.autograd.grad(h, (gx, rg), torch.from_numpy(dhn))
    h2, _, saved = slstm_ref(gx.detach(), rg.detach(), H, save=True)
    assert torch.equal(h2, h.detach())
    assert tuple(saved.shape) == (B, S, 7, H * hd) and saved.dtype == torch.float32
    assert (saved[:, :, 5] >= 1).all()  # n_t >= 1: the clamp never acts
    got = slstm_bwd_ref(rg.detach(), saved, torch.from_numpy(dhn), H)
    for name, a, b in zip(("dgx", "dR"), got, want):
        _close_grad(a, b, name)


@pytest.mark.parametrize("B,S,hd", RECURRENCE_CASES)
def test_plain_backward_matches_jax_vjp_of_the_reference_scan(B, S, hd):
    """slstm_bwd_ref against jax.vjp of the reference's scan, which
    differentiates through the running max m (slstm_bwd_ref holds it
    constant, which is exact)."""
    H = 2
    gxn, rgn, dhn = _recurrence_inputs(B, S, H, hd, seed=B * 1000 + S + hd)
    _, vjp = jax.vjp(lambda gx, rg: _jax_slstm_h(gx, rg, H), jnp.asarray(gxn), jnp.asarray(rgn))
    want = vjp(jnp.asarray(dhn))
    _, _, saved = slstm_ref(torch.from_numpy(gxn), torch.from_numpy(rgn), H, save=True)
    got = slstm_bwd_ref(torch.from_numpy(rgn), saved, torch.from_numpy(dhn), H)
    for name, a, b in zip(("dgx", "dR"), got, want):
        _close_grad(a, b, name)


def test_plain_backward_keeps_the_input_dtype():
    gxn, rgn, dhn = _recurrence_inputs(2, 9, 2, 16, seed=3)
    gx = torch.from_numpy(gxn).bfloat16()
    _, _, saved = slstm_ref(gx, torch.from_numpy(rgn), 2, save=True)
    dgx, dr = slstm_bwd_ref(torch.from_numpy(rgn), saved, torch.from_numpy(dhn).bfloat16(), 2)
    assert dgx.dtype == torch.bfloat16 and dr.dtype == torch.float32
    assert tuple(dgx.shape) == gx.shape and tuple(dr.shape) == (4, 2, 16, 16)


def test_slstm_takes_its_function_only_under_grad():
    """Under grad with an input requiring it, ops.slstm goes through
    SLSTMFused (its final state not differentiable); without grad it is the
    forward alone, with the same bits."""
    gxn, rgn, _ = _recurrence_inputs(2, 11, 2, 16, seed=4)
    gx, rg = torch.from_numpy(gxn), torch.from_numpy(rgn)
    want, want_state = slstm_ref(gx, rg, 2)
    h, state = ops.slstm(gx, rg, 2)
    assert h.grad_fn is None and torch.equal(h, want)
    with torch.no_grad():
        h, _ = ops.slstm(gx.clone().requires_grad_(), rg, 2)
    assert h.grad_fn is None and torch.equal(h, want)
    h, state = ops.slstm(gx.clone().requires_grad_(), rg, 2)
    assert type(h.grad_fn).__name__ == "SLSTMFusedBackward" and torch.equal(h.detach(), want)
    assert all(not s.requires_grad for s in state)
    for a, b in zip(state, want_state):
        assert torch.equal(a, b)


# ---- the xLSTM blocks -----------------------------------------------------------------------


def _block_grads(jfwd, tfwd, params, x, H, out_seed):
    """Gradients of sum(out * w) for a fixed random w, of x and every
    parameter, in both packages."""
    pj = {k: jnp.asarray(np.asarray(v)) for k, v in params.items()}
    w = np.random.default_rng(out_seed).normal(size=x.shape).astype(np.float32)
    want = jax.grad(lambda p, xx: jnp.sum(jfwd(p, xx, H) * w), argnums=(0, 1))(pj, jnp.asarray(x))
    pt = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = tfwd(pt, xt, H)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(), list(pt.values()) + [xt])
    return dict(zip(list(pt) + ["x"], got)), {**want[0], "x": want[1]}, out


def test_slstm_block_gradients_match_jax():
    """xlstm.slstm_forward (the projections and ops.slstm through SLSTMFused)
    against jax.grad of the reference's slstm_forward, a ragged S."""
    rng = np.random.default_rng(12)
    B, S, D, H = 2, 21, 64, 2
    params, _ = jxlstm.init_slstm(jax.random.PRNGKey(2), D, H)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    got, want, out = _block_grads(jxlstm.slstm_forward, txlstm.slstm_forward, params, x, H, 13)
    assert type(out.grad_fn).__name__ != "SLSTMFusedBackward"  # the wo projection follows
    assert set(got) == {"wg", "rg", "bg", "wo", "x"}
    for k in got:
        _close_grad(got[k], want[k], k)


def test_mlstm_block_gradients_are_finite_and_match_jax():
    """xlstm.mlstm_forward's chunked scan under autograd (the -inf mask, the
    amax stabilizer, the -1e30 initial m, a ragged S padded to whole chunks)
    against jax.grad of the reference's mlstm_forward."""
    rng = np.random.default_rng(14)
    B, S, D, H = 2, 37, 64, 4
    params, _ = jxlstm.init_mlstm(jax.random.PRNGKey(1), D, H)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    got, want, _ = _block_grads(lambda p, xx, h: jxlstm.mlstm_forward(p, xx, h, chunk=16),
                                lambda p, xx, h: txlstm.mlstm_forward(p, xx, h, chunk=16),
                                params, x, H, 15)
    assert set(got) == {"wq", "wk", "wv", "wi", "wf", "wo_gate", "wo", "x"}
    for k in got:
        _close_grad(got[k], want[k], k)


# ---- the model's loss and gradients ----------------------------------------------------


@pytest.fixture(scope="module")
def xlstm():
    """Reduced xlstm-350m: the JAX params and a batch of 2 x 24 tokens."""
    cfg = jax_get_config(ARCH).reduced()
    params = jax_build_model(cfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(31)
    toks = rng.integers(1, cfg.vocab_size, size=(2, 25)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return cfg, params, jax.tree.map(np.asarray, params), batch


def _models(np_params, dtype="float32", remat="block"):
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jm = jax_build_model(jax_get_config(ARCH).reduced(),
                         JaxCallConfig(remat=remat, compute_dtype=jd))
    tm = model_params_to_port(get_config(ARCH).reduced(), np_params,
                              cc=CallConfig(compute_dtype=td, remat=remat), device="cpu")
    return jm, tm


def test_reduced_config_is_one_pair_of_32_wide_heads(xlstm):
    cfg = xlstm[0]
    assert (cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads) == ("ssm", 2, 128, 4)
    assert cfg.d_model // cfg.num_heads == 32
    _, tm = _models(xlstm[2])
    assert len(tm.blocks) == 1


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_loss_matches_the_reference(xlstm, dtype, rtol):
    _, params, np_params, batch = xlstm
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


def test_every_gradient_leaf_matches_value_and_grad(xlstm):
    _, params, np_params, batch = xlstm
    jm, tm = _models(np_params)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = _port_grads(tm, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    got = jax.tree_util.tree_flatten_with_path(stack_tree(tm.cfg, tm, tgrads))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    assert any("slstm" in jax.tree_util.keystr(p) and "rg" in jax.tree_util.keystr(p)
               for p, _ in got)
    for (path, g), (_, w) in zip(got, want):
        _close_grad(g, w, jax.tree_util.keystr(path))


def test_remat_block_and_none_give_the_same_loss_and_gradients(xlstm):
    _, _, np_params, batch = xlstm
    _, tm_block = _models(np_params, remat="block")
    _, tm_none = _models(np_params, remat="none")
    lb, gb = _port_grads(tm_block, batch)
    ln, gn = _port_grads(tm_none, batch)
    assert torch.equal(lb, ln)
    for n in gb:
        np.testing.assert_array_equal(gb[n], gn[n], err_msg=n)


def test_serving_stays_without_grad_and_saves_no_state(xlstm):
    _, _, np_params, batch = xlstm
    _, tm = _models(np_params)
    tm.requires_grad_(True)
    logits, _ = tm.forward(batch["tokens"])
    assert logits.grad_fn is None and not logits.requires_grad
    cache = tm.init_cache(2, 32)
    last, _ = tm.prefill(batch["tokens"], cache)
    step, _ = tm.decode_step(batch["targets"][:, -1:], cache, 24)
    assert last.grad_fn is None and step.grad_fn is None


# embed.table's parameter limit in train_step, over how far it moved: 1.5 times
# the largest reading (9.9e-3; the dense limit is 1e-3)
EMBED_MOVED = 1.5e-2


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(xlstm, accum):
    """Three steps from the same converted parameters: the losses within rtol
    2e-5, the grad norm within 1e-4, each parameter leaf within 1e-5 + 1e-3
    max|p_jax - p_init|, the dense family's limit (tests/test_torch_train.py),
    but embed.table. Adam's eps is 1e-6, as for the dense family (ROADMAP
    Queue 3, item 23).

    embed.table has a limit of its own, 1e-5 + EMBED_MOVED max|p_jax -
    p_init|: the mLSTM's float32 gradients stand about 2e-6 of their largest
    element from the reference's (exp and log are other implementations; the
    reference's jitted and eager gradients are bitwise equal), and Adam at
    eps 1e-6 turns that into 9.9e-3 (accum 1) and 9.1e-3 (accum 2) of how far
    embed.table moved, whose smallest gradients (~6e-6) sit near eps. Every
    other leaf reads at most 0.41 of the dense limit (mlstm.wq); a leaf that
    is wrong or not updated moves by the whole of max|p_jax - p_init|."""
    _, params, np_params, _ = xlstm
    jm, tm = _models(np_params)
    ocfg = dict(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=3, eps=1e-6)
    jstep = jax.jit(jax_make_train_step(jm, jopt.OptConfig(**ocfg), accum_steps=accum))
    tstep = make_train_step(tm, topt.OptConfig(**ocfg), accum_steps=accum)
    jstate = {"params": params, "opt": jopt.init_opt_state(params, jopt.OptConfig(**ocfg)),
              "rng": jax.random.PRNGKey(0)}
    tstate = make_train_state(tm, None, topt.OptConfig(**ocfg))
    rng = np.random.default_rng(41)
    for _ in range(3):
        toks = rng.integers(1, 512, size=(4, 17)).astype(np.int32)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        jstate, jmets = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        tstate, tmets = tstep(tstate, batch)
        np.testing.assert_allclose(float(tmets["loss"]), float(jmets["loss"]), rtol=2e-5)
        assert float(tmets["grad_norm"]) == pytest.approx(float(jmets["grad_norm"]), rel=1e-4)
    assert int(tstate["opt"]["step"]) == 3
    got = model_params_from_port(tm)
    for (path, g), w, p0 in zip(jax.tree_util.tree_flatten_with_path(got)[0],
                                jax.tree.leaves(jstate["params"]), jax.tree.leaves(np_params)):
        w = np.asarray(w)
        name = jax.tree_util.keystr(path)
        moved = np.abs(w - p0).max() * (EMBED_MOVED if name == "['embed']['table']" else 1e-3)
        assert np.abs(g - w).max() <= 1e-5 + moved, name


# ---- the launcher -----------------------------------------------------------------


ARGS = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4", "--seq", "32",
        "--log-every", "1"]


def test_launcher_trains_xlstm_and_its_loss_falls(capsys):
    losses = train_launcher.main(ARGS + ["--steps", "10"])
    assert len(losses) == 10 and all(math.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]
    assert "ms/step" in capsys.readouterr().out


def test_launcher_resume_continues_the_uninterrupted_xlstm_run(tmp_path, capsys):
    full = train_launcher.main(ARGS + ["--steps", "6"])
    d = str(tmp_path / "ckpt")
    first = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "3"])
    assert first == full
    shutil.rmtree(tmp_path / "ckpt" / "step_00000006")
    rest = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert rest == full[3:]
