"""Model-parallel training of the audio, vlm and moe families (tensor
parallelism and FSDP on ``DTensor``) against the JAX package, on the CPU.

Five reduced cases (tests/_torch_ranks.py:FAMILY_CASES): musicgen-large
(codebook tables split over the vocabulary), llama-3.2-vision-90b with
image embeddings (the cross layers' K/V split by heads where they divide
"model"), dbrx-132b at ``ep_split`` 1 (experts over "model", gathered over
"data") and 2 (the expert slices over the whole mesh, the tokens moved to
them), and llama4-maverick with ``moe_every=2`` set back (``MoEGroup``).
Each on (data=2, model=4) and (pod=2, data=2, model=2), with ``dp_size``
the batch's axes' size, the port on 8 ``gloo`` CPU ranks spawned once for
all cases, the reference's sharded step (as tests/_mesh_checks.py:102-133
runs it) in one subprocess on 8 forced host devices:

* the float32 loss within 2e-5 and the grad norm within 1e-4 of the
  reference's sharded step, and the loss of ``jax.value_and_grad``;
* every gradient leaf against ``jax.value_and_grad``'s at rtol 1e-3, atol
  1e-4 · max; the updated parameters, at Adam eps 1e-6, within limits
  from readings (``MOVED``) of the reference's one-device and sharded
  steps (ROADMAP Queue 3, items 23 and 39);
* the moe load-balance loss within 2e-5 of the reference's, and the
  dropped choices equal to the one-process port's (whose slots equal the
  reference's, tests/test_torch_moe.py);
* the bfloat16 loss within the reference's own 2e-2 (tests/_mesh_checks.py:125);
* the moe dispatch's placements (``xg``, ``ebuf``, ``ebuf_ep``, ``out``)
  at the reference's specs; the non-causal flash calls' local shapes; no
  collective of the audio step taking a (B, S, K, V)-sized tensor; each
  family's sharded train state restored bitwise; zamba2, xlstm and a
  ``dp_size`` the batch's axes do not split refused.

Run as a script, this file computes the reference's side in the
subprocess: ``XLA_FLAGS=--xla_force_host_platform_device_count=8 python
tests/test_torch_model_parallel_families.py --reference WORKDIR``.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import _torch_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro_torch.convert import stack_tree

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 8
TOL = 2e-5  # f32 (tests/test_kernels.py:18)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_layers.py:121, per leaf of max|g|
BF16_TOL = 2e-2  # tests/_mesh_checks.py:125
MESH_SHAPES = {"2x4": ((2, 4), ("data", "model")),
               "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
CASES = list(ranks.FAMILY_CASES)
# each updated parameter's limit over how far it moved, max|p_one - p_init|,
# (every other leaf, the embedding and unembedding tables): 1.5 times the
# largest reading over the cases and meshes. The port's sharded step stands
# at most 2.65e-3 (llama4's dense wk) and 9.29e-3 (dbrx ep_split 2's
# embed.table on (2, 2, 2)) from the reference's one-device step; the
# reference's own sharded step stands 6.12e-3 from it in embed.table: at
# Adam eps 1e-6 a rounding is amplified by the update (ROADMAP Queue 3,
# item 23). The dense family's 1e-3 (tests/test_torch_train.py) holds
# neither. A leaf that is wrong or not updated moves by the whole of it.
MOVED = {False: 0.004, True: 0.015}


def jax_config(case: str):
    """The reduced config of a case, the reference's."""
    arch, changes = ranks.FAMILY_CASES[case]
    cfg = jax_get_config(arch).reduced()
    moe = {k: v for k, v in changes.items() if k in ("ep_split", "moe_every")}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    if "num_layers" in changes:
        cfg = dataclasses.replace(cfg, num_layers=changes["num_layers"])
    return cfg


def make_batch(cfg, seed: int = 11) -> dict:
    """FAMILY_ROWS rows of FAMILY_SEQ + 1 tokens (audio: x num_codebooks) as
    tokens and next-token targets; the vlm's image embeddings drawn too."""
    rng = np.random.default_rng(seed)
    shape = (ranks.FAMILY_ROWS, ranks.FAMILY_SEQ + 1) + (
        (cfg.num_codebooks,) if cfg.num_codebooks else ())
    toks = rng.integers(1, cfg.vocab_size, size=shape).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["image_embeds"] = rng.normal(
            size=(ranks.FAMILY_ROWS, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _spec(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _reference(workdir: Path) -> None:
    """The reference's sharded float32 step of every case on both meshes, on
    8 forced host devices: loss, grad norm, aux, the updated parameters and
    the specs of the moe dispatch's shard_fn calls."""
    from repro.core import jax_compat
    from repro.parallel import sharding as jsh
    from repro.train.optimizer import OptConfig, init_opt_state
    from repro.train.train_step import make_train_step

    t0 = time.time()
    arrays, info = {}, {}
    for case in CASES:
        cfg = jax_config(case)
        with open(workdir / f"params_{case}.pkl", "rb") as f:
            params0 = pickle.load(f)
        batch = {k: jnp.asarray(v) for k, v in make_batch(cfg).items()}
        for name, (shape, names) in MESH_SHAPES.items():
            mesh = jax_compat.make_mesh(shape, names)
            rules = jsh.act_rules(mesh, job="train")
            base, seen = jsh.make_shard_fn(mesh, rules), []

            def shard(x, axes, base=base, rules=rules, seen=seen):
                if tuple(axes) in ranks.MOE_AXES:
                    seen.append([list(axes), _spec(rules.spec_for(tuple(axes), x.shape))])
                return base(x, axes)

            cc = JaxCallConfig(dp_size=ranks.FAMILY_DP[name], remat="block",
                               compute_dtype=jnp.float32, shard_fn=shard)
            model = jax_build_model(cfg, cc)
            pshard = jsh.param_rules(mesh).tree_shardings(model.axes_tree(), params0)
            params = jax.tree.map(lambda x, s: jax.device_put(jnp.asarray(x), s), params0, pshard)
            ocfg = OptConfig(**ranks.TRAIN_OPT)
            state = {"params": params, "opt": init_opt_state(params, ocfg),
                     "rng": jax.random.PRNGKey(0)}
            with mesh:
                state, mets = jax.jit(make_train_step(model, ocfg))(state, batch)
            info[f"{case}.{name}"] = {"loss": float(mets["loss"]),
                                      "grad_norm": float(mets["grad_norm"]),
                                      "aux": float(mets["aux"]), "moe_specs": seen}
            for path, leaf in jax.tree_util.tree_flatten_with_path(state["params"])[0]:
                arrays[f"{case}.{name}.param{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
            # the one-device step (its dispatch groups matter to the moe only)
            if cfg.family == "moe" or name == "2x4":
                model = jax_build_model(cfg, JaxCallConfig(
                    dp_size=ranks.FAMILY_DP[name], remat="block", compute_dtype=jnp.float32))
                params = jax.tree.map(jnp.asarray, params0)
                one = {"params": params, "opt": init_opt_state(params, ocfg),
                       "rng": jax.random.PRNGKey(0)}
                one, _ = jax.jit(make_train_step(model, ocfg))(one, batch)
            for path, leaf in jax.tree_util.tree_flatten_with_path(one["params"])[0]:
                arrays[f"{case}.{name}.one{jax.tree_util.keystr(path)}"] = np.asarray(leaf)
    info["seconds"] = time.time() - t0
    np.savez(workdir / "reference.npz", **arrays)
    (workdir / "reference.json").write_text(json.dumps(info))


# ---- the reference and the ranks, once for the module ------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """Every case's JAX parameters (PRNGKey(0)) and batches, for both sides."""
    d = tmp_path_factory.mktemp("mp_families")
    batches = {}
    for case in CASES:
        cfg = jax_config(case)
        params = jax_build_model(cfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
        with open(d / f"params_{case}.pkl", "wb") as f:
            pickle.dump(jax.tree.map(np.asarray, params), f)
        batches.update({f"{case}.{k}": v for k, v in make_batch(cfg).items()})
    np.savez(d / "batches.npz", **batches)
    return d


@pytest.fixture(scope="module")
def runs(workdir):
    """The reference's subprocess and the port's 8 ranks, side by side."""
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT / "tests"),
                                           os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, __file__, "--reference", str(workdir)], env=env,
                            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks.spawn(ranks.families_rank, N_RANKS, workdir, timeout=400)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-4000:]
    ref = (dict(np.load(workdir / "reference.npz")),
           json.loads((workdir / "reference.json").read_text()))
    port = (dict(np.load(workdir / "families_0.npz")),
            [json.loads((workdir / f"families_{r}.json").read_text()) for r in range(N_RANKS)])
    return ref, port


@pytest.fixture(scope="module")
def value_and_grad(workdir):
    """jax.value_and_grad of each case's loss, float32, unsharded (remat
    "block", the cases' dp_size): loss, aux and the gradients by mesh; and
    the bfloat16 loss of one device."""
    out = {}
    for case in CASES:
        cfg = jax_config(case)
        with open(workdir / f"params_{case}.pkl", "rb") as f:
            params = jax.tree.map(jnp.asarray, pickle.load(f))
        batch = {k: jnp.asarray(v) for k, v in make_batch(cfg).items()}
        for name, dp in ranks.FAMILY_DP.items():
            jm = jax_build_model(cfg, JaxCallConfig(dp_size=dp, remat="block",
                                                    compute_dtype=jnp.float32))
            (loss, mets), grads = jax.value_and_grad(jm.loss, has_aux=True)(params, batch)
            bm = jax_build_model(cfg, JaxCallConfig(dp_size=dp, remat="block",
                                                    compute_dtype=jnp.bfloat16))
            out[f"{case}.{name}"] = {"loss": float(loss), "aux": float(mets["aux"]),
                                     "grads": grads,
                                     "bf16_loss": float(jax.jit(bm.loss)(params, batch)[0])}
    return out


def _flat(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port_tree(case, outs, prefix):
    """The port's flat leaves under ``prefix`` stacked into the reference's tree."""
    from repro_torch.models.transformer import build_model

    cfg = ranks.family_config(case)
    return stack_tree(cfg, build_model(cfg, device="cpu"),
                      {k[len(prefix):]: v for k, v in outs.items() if k.startswith(prefix)})


# ---- the sharded step ----------------------------------------------------------------------


@pytest.mark.timeout(900)
@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("case", CASES)
def test_sharded_step_matches_the_reference(runs, value_and_grad, workdir, case, mesh):
    """Every rank's loss, grad norm and aux against the reference's sharded
    step and jax.value_and_grad; every gradient leaf against
    jax.value_and_grad's; every updated parameter within
    1e-5 + MOVED of how far it moved of the reference's one-device step
    and of its sharded step."""
    (ref_arrays, ref_info), (outs, infos) = runs
    want, vg = ref_info[f"{case}.{mesh}"], value_and_grad[f"{case}.{mesh}"]
    for info in infos:
        got = info[f"{case}.{mesh}"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
        np.testing.assert_allclose(got["loss"], vg["loss"], rtol=TOL)
        assert got["grad_norm"] == pytest.approx(want["grad_norm"], rel=1e-4)
        np.testing.assert_allclose(got["aux"], want["aux"], rtol=TOL, atol=1e-7)
        np.testing.assert_allclose(got["aux"], vg["aux"], rtol=TOL, atol=1e-7)
    got = _flat(_port_tree(case, outs, f"{case}.{mesh}.grad."))
    wanted = _flat(vg["grads"])
    assert [k for k, _ in got] == [k for k, _ in wanted]
    for (key, g), (_, w) in zip(got, wanted):
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL["rtol"],
                                   atol=GRAD_TOL["atol"] * np.abs(w).max(), err_msg=key)
    with open(workdir / f"params_{case}.pkl", "rb") as f:
        p0 = dict(_flat(pickle.load(f)))
    for key, g in _flat(_port_tree(case, outs, f"{case}.{mesh}.param.")):
        one, sharded = (ref_arrays[f"{case}.{mesh}.{w}{key}"] for w in ("one", "param"))
        limit = 1e-5 + MOVED[key.endswith("['table']")] * np.abs(one - p0[key]).max()
        assert np.abs(g - one).max() <= limit, key
        assert np.abs(g - sharded).max() <= limit, key


@pytest.mark.timeout(900)
@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("case", CASES)
def test_sharded_bf16_step_holds_the_reference_loss(runs, value_and_grad, case, mesh):
    _, (_, infos) = runs
    for info in infos:
        np.testing.assert_allclose(info[f"{case}.{mesh}.bf16"]["loss"],
                                   value_and_grad[f"{case}.{mesh}"]["bf16_loss"], rtol=BF16_TOL)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("case", CASES)
def test_one_process_and_sharded_agree(runs, case, mesh):
    """The sharded forward's loss and aux equal the one-process port's at
    2e-5, and (moe) it drops as many choices (the one-process dispatch's
    slots equal the reference's, tests/test_torch_moe.py)."""
    _, (_, infos) = runs
    for info in infos:
        line = info[f"{case}.{mesh}"]
        np.testing.assert_allclose(line["loss"], line["one_process"]["loss"], rtol=TOL)
        np.testing.assert_allclose(line["aux"], line["one_process"]["aux"], rtol=TOL, atol=1e-7)
        assert line["drops"] == line["one_process"]["drops"]
    if "dbrx" in case:
        assert infos[0][f"{case}.{mesh}"]["drops"] > 0  # capacity factor 1.25 drops here


@pytest.mark.timeout(900)
@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("case", ["dbrx_ep1", "dbrx_ep2", "llama4_every2"])
def test_moe_dispatch_placements_equal_the_reference_specs(runs, case, mesh):
    """xg, ebuf (ep_split 1) or ebuf_ep and out (ep_split 2): the port's
    shard_fn calls give the reference's specs, and the placements those
    specs make (a dim over several axes in the mesh's order)."""
    (_, ref_info), (_, infos) = runs
    want = {tuple(map(lambda e: tuple(e) if isinstance(e, list) else e, a)): s
            for a, s in ref_info[f"{case}.{mesh}"]["moe_specs"]}
    ep = ranks.family_config(case).moe.ep_split > 1
    names = {("exp_dp", None, None)} | ({(None, "experts_ep", None, None),
                                         ("exp_dp", None, None, None)} if ep else
                                        {("exp_dp", "experts", None, None)})
    assert set(want) == names
    for info in infos:
        seen = info[f"{case}.{mesh}"]["moe_placements"]
        assert {tuple(s["axes"]) for s in seen} == names
        for s in seen:
            assert s["spec"] == want[tuple(s["axes"])], s
            assert s["placements"] == s["want"], s
    if ep:
        split = [s for s in infos[0][f"{case}.{mesh}"]["moe_placements"]
                 if s["axes"][1] == "experts_ep"][0]
        assert split["spec"][1][0] == "model" and "Replicate()" not in split["placements"]


@pytest.mark.timeout(900)
def test_non_causal_flash_runs_on_each_ranks_heads(runs):
    """The vlm's cross layer: 32 text queries against 16 image keys,
    non-causal. 4 heads and 2 KV heads do not divide model=4: replicated,
    a rank's 2 rows; on model=2 split, 2 and 1 heads a rank and a row.
    The self layer causal at 32 keys. Each run twice (remat)."""
    _, (_, infos) = runs
    for info in infos:
        for mesh, (rows, h, kvh) in {"2x4": (2, 4, 2), "2x2x2": (1, 2, 1)}.items():
            calls = info[f"vlm.{mesh}"]["flash"]
            assert calls.count([[rows, 32, h, 32], [rows, 16, kvh, 32], False]) == 2
            assert calls.count([[rows, 32, h, 32], [rows, 32, kvh, 32], True]) == 2
            assert len(calls) == 4


@pytest.mark.timeout(900)
def test_the_codebook_loss_moves_no_logits(runs):
    """musicgen's step on (2, 4): the (B, S, K, V) logits stay split over the
    vocabulary (2, 32, 4, 128) a rank, and no collective, forward or
    backward, takes a tensor that ends in (32, 4, 128) or (32, 4, 512)."""
    _, (_, infos) = runs
    for info in infos:
        shapes = [tuple(s) for v in info["audio_comms"]["shapes"].values() for s in v]
        assert shapes
        assert not [s for s in shapes if s[-3:] in ((32, 4, 128), (32, 4, 512))], shapes


@pytest.mark.timeout(900)
@pytest.mark.parametrize("case", CASES)
def test_a_sharded_train_state_restores_bitwise(runs, case):
    _, (_, infos) = runs
    assert all(i[f"{case}.restored_bitwise"] for i in infos)


@pytest.mark.timeout(900)
@pytest.mark.parametrize("what", list(ranks.REFUSING) + ["moe dp_size 1"])
def test_hybrid_ssm_and_an_uneven_dispatch_refuse_a_mesh(runs, what):
    _, (_, infos) = runs
    assert all(i["refusals"][what] for i in infos)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference(Path(sys.argv[2]))
