"""Training the hybrid family (zamba2-1.2b) in the port against the JAX
package, on the CPU.

The same numpy inputs, made from a seed, go through the JAX package and the
port (``repro_torch``), in float32 unless a test says otherwise, at the
reference's gradient tolerance rtol 1e-3, atol 1e-4 of the largest gradient
(tests/test_layers.py:121):

* ``ssd_chunked`` under autograd against ``jax.vjp`` of the reference's
  (whole chunks and a ragged S padded with dt = 0, with and without an
  ``init_state``, float32 and bfloat16 inputs); the log-space mask's
  gradient: exact zeros above the diagonal and nothing non-finite where
  ``exp`` before the mask would overflow;
* ``mamba2_forward``'s gradients against ``jax.grad`` of the reference's;
* reduced zamba2-1.2b at ``num_layers=5``: two groups of two Mamba2 blocks,
  each followed by the one shared attention + MLP block, and one tail
  block (``reduced()`` alone has one group, where the shared block is used
  once, so no test would see its gradient summed over uses), over 70
  tokens (two chunks of 32 and a ragged third): ``Model.loss`` (float32
  rtol 2e-5, bfloat16 2e-2), every gradient leaf against
  ``jax.value_and_grad``, remat "block" against "none" bitwise,
  ``make_train_step`` against the reference's;
* the launcher on the CPU, and its resume.

The card's side (train steps through the attention kernels) is in
tests/test_torch_gpu.py.
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
from repro.models import ssm as jssm
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_port, model_params_to_port, stack_tree
from repro_torch.launch import train as train_launcher
from repro_torch.models import ssm as tssm
from repro_torch.models.transformer import CallConfig
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import make_train_state, make_train_step

ARCH = "zamba2-1.2b"
LAYERS = 5  # two groups of hybrid_attn_every = 2 Mamba2 blocks and the shared block, one tail
SEQ = 70  # two chunks of the reduced chunk 32 and a ragged third
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


def _cfgs():
    """Reduced zamba2 at LAYERS layers in both packages."""
    return (dataclasses.replace(jax_get_config(ARCH).reduced(), num_layers=LAYERS),
            dataclasses.replace(get_config(ARCH).reduced(), num_layers=LAYERS))


# ---- the SSD chunk loop ---------------------------------------------------------------


def _ssd_inputs(S, init, seed, dt_scale=1.0):
    """x (B, S, H, P), dt, A, Bm, Cm, D and an init_state (or None) as numpy."""
    rng = np.random.default_rng(seed)
    B, H, P, N = 2, 3, 8, 4
    return dict(
        x=rng.normal(size=(B, S, H, P)), dt=dt_scale * np.log1p(np.exp(rng.normal(size=(B, S, H)))),
        A=-np.linspace(1.0, 16.0, H), Bm=rng.normal(size=(B, S, N)),
        Cm=rng.normal(size=(B, S, N)), D=rng.normal(size=H),
        init_state=rng.normal(size=(B, H, N, P)) if init else None)


LOW = ("x", "Bm", "Cm")  # the inputs in the compute dtype; dt, A, D and the state are float32


def _ssd_torch(inp, dtype):
    return {k: None if v is None else
            torch.from_numpy(np.asarray(v, np.float32)).to(
                DTYPES[dtype][1] if k in LOW else torch.float32).requires_grad_()
            for k, v in inp.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True], ids=["zero", "init_state"])
@pytest.mark.parametrize("S,chunk", [(64, 16), (SEQ, 32)], ids=["whole", "ragged"])
def test_ssd_chunked_gradients_match_jax_vjp(S, chunk, init, dtype):
    """The gradients of every input of ssd_chunked, for cotangents of y and
    of the final state, against jax.vjp of the reference's ssd_chunked (its
    jax.checkpoint per chunk recomputes; autograd keeps the chunk's
    tensors), each in its input's dtype (x, Bm and Cm bfloat16 in the
    bfloat16 case)."""
    inp = _ssd_inputs(S, init, seed=S + chunk + init)
    names = [k for k, v in inp.items() if v is not None]
    jd = DTYPES[dtype][0]
    jin = [jnp.asarray(np.asarray(inp[k], np.float32), jd if k in LOW else jnp.float32)
           for k in names]

    def jfn(*args):
        kw = dict(zip(names, args))
        return jssm.ssd_chunked(kw.pop("x"), kw.pop("dt"), kw.pop("A"), kw.pop("Bm"),
                                kw.pop("Cm"), kw.pop("D"), chunk=chunk, **kw)

    (yj, hj), vjp = jax.vjp(jfn, *jin)
    rng = np.random.default_rng(7)
    dy = rng.normal(size=yj.shape).astype(np.float32)
    dh = rng.normal(size=hj.shape).astype(np.float32)
    want = vjp((jnp.asarray(dy, yj.dtype), jnp.asarray(dh)))

    tin = _ssd_torch(inp, dtype)
    args = [tin[k] for k in names]
    yt, ht = tssm.ssd_chunked(tin["x"], tin["dt"], tin["A"], tin["Bm"], tin["Cm"], tin["D"],
                              chunk=chunk, init_state=tin["init_state"])
    got = torch.autograd.grad((yt, ht), args, (torch.from_numpy(dy).to(yt.dtype),
                                               torch.from_numpy(dh)))
    for k, g, w, a in zip(names, got, want, args):
        assert g.dtype == a.dtype, k
        _close_grad(g, w, k)


def test_ssd_forward_is_unchanged_under_grad():
    """Serving and training run the same function: y and the final state
    are the same bits with and without grad."""
    tin = _ssd_torch(_ssd_inputs(SEQ, True, seed=3), "bfloat16")
    args = (tin["x"], tin["dt"], tin["A"], tin["Bm"], tin["Cm"], tin["D"])
    y, h = tssm.ssd_chunked(*args, chunk=32, init_state=tin["init_state"])
    with torch.no_grad():
        y0, h0 = tssm.ssd_chunked(*args, chunk=32, init_state=tin["init_state"])
    assert y.grad_fn is not None and torch.equal(y.detach(), y0) and torch.equal(h.detach(), h0)


def test_log_space_mask_gives_exact_zero_gradients_above_the_diagonal():
    """Large steps (dt ~ 30, A down to -16): the segment sums above a
    chunk's diagonal reach ~1e4, where exp before the mask would be inf and
    its gradient NaN. The gradient of y at one position t0 is finite
    everywhere, exactly zero at every later position (x, dt, Bm: the
    masked entries and later chunks contribute exact zeros), and Cm's only
    at t0; the reference's vjp gives the same zeros."""
    S, chunk, t0 = SEQ, 32, 40  # t0 inside the second chunk
    inp = _ssd_inputs(S, True, seed=11, dt_scale=30.0)
    tin = _ssd_torch(inp, "float32")
    names = ("x", "dt", "A", "Bm", "Cm", "D", "init_state")
    y, _ = tssm.ssd_chunked(tin["x"], tin["dt"], tin["A"], tin["Bm"], tin["Cm"], tin["D"],
                            chunk=chunk, init_state=tin["init_state"])
    got = dict(zip(names, torch.autograd.grad(y[:, t0].sum(), [tin[k] for k in names])))
    for k, g in got.items():
        assert torch.isfinite(g).all(), k
    for k in ("x", "dt", "Bm"):
        assert torch.count_nonzero(got[k][:, t0 + 1:]) == 0, k
        assert torch.count_nonzero(got[k][:, :t0 + 1]) > 0, k
    assert torch.count_nonzero(got["Cm"][:, :t0]) == 0 == torch.count_nonzero(got["Cm"][:, t0 + 1:])

    def jfn(x, dt, Bm):
        yj, _ = jssm.ssd_chunked(x, dt, jnp.asarray(inp["A"], jnp.float32), Bm,
                                 jnp.asarray(inp["Cm"], jnp.float32),
                                 jnp.asarray(inp["D"], jnp.float32), chunk=chunk,
                                 init_state=jnp.asarray(inp["init_state"], jnp.float32))
        return yj[:, t0].sum()

    want = jax.grad(jfn, argnums=(0, 1, 2))(*(jnp.asarray(inp[k], jnp.float32)
                                              for k in ("x", "dt", "Bm")))
    for k, w in zip(("x", "dt", "Bm"), want):
        assert np.count_nonzero(np.asarray(w)[:, t0 + 1:]) == 0, k
        _close_grad(got[k], w, k)


# ---- the Mamba2 block -----------------------------------------------------------------


def _mamba_params(cfg, seed=1):
    s = cfg.ssm
    p, _ = jssm.init_mamba2(jax.random.PRNGKey(seed), cfg.d_model, expand=s.expand,
                            head_dim=s.head_dim, state_dim=s.state_dim, conv_width=s.conv_width)
    pn = {k: np.asarray(v) for k, v in p.items()}
    # nonzero biases and a scaled norm: every parameter reaches the output
    rng = np.random.default_rng(seed)
    for k in ("conv_b", "dt_bias", "norm_scale", "D"):
        pn[k] = (pn[k] + 0.1 * rng.normal(size=pn[k].shape)).astype(np.float32)
    return pn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_gradients_match_jax(dtype):
    """Gradients of sum(out * w) for a fixed random w, of x and every
    parameter (float32 masters), through the projections, the causal conv,
    softplus, the SSD over a ragged S and the gated norm, against jax.grad
    of the reference's mamba2_forward. bfloat16 holds the float32 master
    gradients at 2e-2 of their largest element (the forward rounds to
    bfloat16 at each product, in both packages)."""
    jcfg, tcfg = _cfgs()
    pn = _mamba_params(jcfg)
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2, SEQ, jcfg.d_model)).astype(np.float32)
    w = rng.normal(size=x.shape).astype(np.float32)
    jd, td = DTYPES[dtype]

    def jloss(p, xx):
        return jnp.sum(jssm.mamba2_forward(p, xx.astype(jd), jcfg).astype(jnp.float32) * w)

    want = jax.grad(jloss, argnums=(0, 1))({k: jnp.asarray(v) for k, v in pn.items()},
                                           jnp.asarray(x))
    want = {**want[0], "x": want[1]}
    pt = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in pn.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = tssm.mamba2_forward(pt, xt.to(td), tcfg)
    assert out.dtype == td
    got = torch.autograd.grad((out.float() * torch.from_numpy(w)).sum(), list(pt.values()) + [xt])
    got = dict(zip(list(pt) + ["x"], got))
    assert set(got) == set(want) == {"in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                                     "norm_scale", "out_proj", "x"}
    for k in got:
        if dtype == "float32":
            _close_grad(got[k], want[k], k)
        else:
            g, wk = _np(got[k]), _np(want[k])
            assert np.isfinite(g).all() and np.abs(g - wk).max() <= 2e-2 * np.abs(wk).max(), k


# ---- the model's loss and gradients ----------------------------------------------------


@pytest.fixture(scope="module")
def zamba2():
    """Reduced zamba2 at LAYERS layers: the JAX params and a batch of 2 x SEQ
    tokens."""
    jcfg, _ = _cfgs()
    params = jax_build_model(jcfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(31)
    toks = rng.integers(1, jcfg.vocab_size, size=(2, SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    return params, jax.tree.map(np.asarray, params), batch


def _models(np_params, dtype="float32", remat="block"):
    jd, td = DTYPES[dtype]
    jcfg, tcfg = _cfgs()
    jm = jax_build_model(jcfg, JaxCallConfig(remat=remat, compute_dtype=jd))
    tm = model_params_to_port(tcfg, np_params, cc=CallConfig(compute_dtype=td, remat=remat),
                              device="cpu")
    return jm, tm


def test_the_config_uses_the_shared_block_twice_and_has_a_tail(zamba2):
    _, tm = _models(zamba2[1])
    assert len(tm.blocks) == 2 and all(len(g) == 2 for g in tm.blocks) and len(tm.tail) == 1
    assert SEQ > tm.cfg.ssm.chunk and SEQ % tm.cfg.ssm.chunk
    assert get_config(ARCH).reduced().num_layers == 3  # one group: one use


@pytest.mark.parametrize("dtype,rtol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_loss_matches_the_reference(zamba2, dtype, rtol):
    params, np_params, batch = zamba2
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


def test_every_gradient_leaf_matches_value_and_grad(zamba2):
    """Every leaf, the shared block's among them: autograd's sum over its
    two uses against the reference's gradient of shared_attn."""
    params, np_params, batch = zamba2
    jm, tm = _models(np_params)
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = _port_grads(tm, batch)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=2e-5)
    got = jax.tree_util.tree_flatten_with_path(stack_tree(tm.cfg, tm, tgrads))[0]
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    keys = [jax.tree_util.keystr(p) for p, _ in got]
    assert keys == [jax.tree_util.keystr(p) for p, _ in want]
    assert sum("shared_attn" in k for k in keys) >= 8 and any("tail" in k for k in keys)
    for (path, g), (_, w) in zip(got, want):
        _close_grad(g, w, jax.tree_util.keystr(path))


def test_remat_block_and_none_give_the_same_loss_and_gradients(zamba2):
    _, np_params, batch = zamba2
    _, tm_block = _models(np_params, remat="block")
    _, tm_none = _models(np_params, remat="none")
    lb, gb = _port_grads(tm_block, batch)
    ln, gn = _port_grads(tm_none, batch)
    assert torch.equal(lb, ln)
    for n in gb:
        np.testing.assert_array_equal(gb[n], gn[n], err_msg=n)


def test_serving_stays_without_grad(zamba2):
    _, np_params, batch = zamba2
    _, tm = _models(np_params)
    tm.requires_grad_(True)
    logits, _ = tm.forward(batch["tokens"])
    assert logits.grad_fn is None and not logits.requires_grad
    cache = tm.init_cache(2, 80)
    last, _ = tm.prefill(batch["tokens"], cache)
    step, _ = tm.decode_step(batch["targets"][:, -1:], cache, SEQ)
    assert last.grad_fn is None and step.grad_fn is None


# the parameter leaves' limits in train_step, over how far each moved: 1.5
# times the largest reading (embed.table 0.250 at accum 1, 0.155 at accum 2;
# every other leaf at most 0.012, blocks.mamba.in_proj; the dense limit is 1e-3)
EMBED_MOVED, MOVED = 0.375, 0.018


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_the_reference(zamba2, accum):
    """Three steps from the same converted parameters at Adam eps 1e-6
    (ROADMAP Queue 3, item 23): the losses within rtol 2e-5 and the grad
    norm within 1e-4 at every step, each parameter leaf within 1e-5 + MOVED
    max|p_jax - p_init|, embed.table within 1e-5 + EMBED_MOVED of it.

    The dense family's limit, 1e-3 of how far a leaf moved
    (tests/test_torch_train.py), does not hold here, and the reference does
    not hold it against itself: its eager and jitted steps part by 0.118 of
    how far embed.table moved (accum 1). Every gradient leaf agrees within
    rtol 1e-3, atol 1e-4 max (test_every_gradient_leaf_matches_value_and_grad):
    embed.table's first gradient stands 1.1e-5 of its largest element from
    the reference's, but an element of 2.1e-6, near eps, stands 16 % off,
    and Adam's first update of it (g / (|g| + eps)) 4 % of lr; the next
    steps' gradients carry that on. A leaf that is wrong or not updated
    moves by the whole of max|p_jax - p_init|."""
    params, np_params, _ = zamba2
    jm, tm = _models(np_params)
    ocfg = dict(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=3, eps=1e-6)
    jstep = jax.jit(jax_make_train_step(jm, jopt.OptConfig(**ocfg), accum_steps=accum))
    tstep = make_train_step(tm, topt.OptConfig(**ocfg), accum_steps=accum)
    jstate = {"params": params, "opt": jopt.init_opt_state(params, jopt.OptConfig(**ocfg)),
              "rng": jax.random.PRNGKey(0)}
    tstate = make_train_state(tm, None, topt.OptConfig(**ocfg))
    rng = np.random.default_rng(41)
    for _ in range(3):
        toks = rng.integers(1, 512, size=(2, SEQ + 1)).astype(np.int32)
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
        moved = np.abs(w - p0).max() * (EMBED_MOVED if name == "['embed']['table']" else MOVED)
        assert np.abs(g - w).max() <= 1e-5 + moved, name


# ---- the launcher -----------------------------------------------------------------


ARGS = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "4", "--seq", str(SEQ),
        "--log-every", "1"]


def test_launcher_trains_zamba2_and_its_loss_falls(capsys):
    losses = train_launcher.main(ARGS + ["--steps", "10"])
    assert len(losses) == 10 and all(math.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]
    assert "ms/step" in capsys.readouterr().out


def test_launcher_resume_continues_the_uninterrupted_zamba2_run(tmp_path, capsys):
    full = train_launcher.main(ARGS + ["--steps", "6"])
    d = str(tmp_path / "ckpt")
    first = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--ckpt-every", "3"])
    assert first == full
    shutil.rmtree(tmp_path / "ckpt" / "step_00000006")
    rest = train_launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", d, "--resume"])
    assert "resumed from step 3" in capsys.readouterr().out
    assert rest == full[3:]
