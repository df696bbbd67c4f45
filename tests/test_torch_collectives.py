"""The port's collectives, sharding rules and data/pod-parallel training
against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through both packages:

* the COM ring (``com_reduce_scatter``, ``com_all_gather``) bitwise, and
  ``make_com_matmul`` (no epilogue, silu, gelu, bias + residual),
  ``com_matmul_local_bidir`` and the three ``matmul_strategy``s within
  2e-5 · max|ref| (tests/test_kernels.py:18): the port on 8 ``gloo`` CPU
  ranks (tests/_torch_ranks.py), the reference in one subprocess with 8
  forced host devices, as tests/_mesh_checks.py runs it; the port's
  transport counters equal to ``wire_bytes``;
* ``compressed_pod_psum``: the int8 codes and scales equal, the reduced
  grads and error state within float32 rounding of the reference's on
  replicated grads (the only case the reference can express) and of the
  mean of the dequantized rows on grads that differ by pod;
* ``wire_bytes``, ``PipelinePlan``, ``plan``, ``gpipe_forward``,
  ``_ring_perm``, ``build_mesh``'s shapes and ``ShardingRules.spec_for``
  (with its ``dropped`` list, on fake meshes as tests/test_infra.py:108
  builds them) equal;
* reduced smollm-135m's data-parallel train step on (pod=2, data=2), a row
  a rank, against the reference's one-device step and
  ``jax.value_and_grad`` on the whole batch (tests/test_torch_train.py's
  tolerances), and with the compressed pod mean within each row's int8
  bound; a tree saved on (2, 4) restored onto
  ``build_mesh(plan_remesh(MeshPlan(2, 4), 4))`` (tests/_mesh_checks.py:136).

Run as a script, this file computes the reference's side in the
subprocess: ``XLA_FLAGS=--xla_force_host_platform_device_count=8 python
tests/test_torch_collectives.py --reference IN OUT``.
"""
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as ranks
from repro.configs import get_config as jax_get_config
from repro.core import com as jcom
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.parallel import collectives as jcoll
from repro.parallel import pipeline as jpipe
from repro.parallel import sharding as jsh
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train.train_step import make_train_step as jax_make_train_step
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port, stack_tree
from repro_torch.core import com
from repro_torch.launch.mesh import (DataMesh, make_data_mesh, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.parallel import collectives, pipeline, sharding
from repro_torch.parallel.shard_sweep import make_sharded_backend
from repro_torch.runtime.elastic import MeshPlan, build_mesh
from repro_torch.sweep import COLUMNS, SweepGrid, run_sweep
from repro_torch.train import grad_compress

ROOT = Path(__file__).resolve().parents[1]
N_RANKS = 8
TOL = 2e-5  # f32 (tests/test_kernels.py:18)
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)  # tests/test_layers.py:121, per leaf of max|g|
F32_ROUNDING = dict(rtol=2 ** -22, atol=0)  # a couple of float32 roundings
EPILOGUES = tuple(ranks.EPILOGUES)


def _inputs() -> dict:
    rng = np.random.default_rng(31)
    f = np.float32
    return {"xg": rng.normal(size=(64, 16, 5)).astype(f), "xa": rng.normal(size=(16, 3)).astype(f),
            "x": rng.normal(size=(4, 64)).astype(f), "w": rng.normal(size=(64, 32)).astype(f),
            "bias": rng.normal(size=(32,)).astype(f), "residual": rng.normal(size=(4, 32)).astype(f),
            "ga": rng.normal(size=(16, 8)).astype(f), "gb": rng.normal(size=(4,)).astype(f),
            "da": rng.normal(size=(16, 8)).astype(f), "db": (3 * rng.normal(size=(4,))).astype(f)}


def _reference(inputs: Path, out: Path) -> None:
    """The reference's side, on 8 forced host devices."""
    from jax.sharding import PartitionSpec as P

    from repro.core import jax_compat
    from repro.runtime.elastic import MeshPlan as JaxMeshPlan
    from repro.runtime.elastic import build_mesh as jax_build_mesh

    inp = {k: jnp.asarray(v) for k, v in np.load(inputs).items()}
    mesh = jax_compat.make_mesh((8,), ("model",))
    smap = jax_compat.shard_map
    res = {"rs": smap(lambda xp: jcom.com_reduce_scatter(xp, "model"), mesh=mesh,
                      in_specs=P("model"), out_specs=P("model"))(inp["xg"]),
           "ag": smap(lambda xl: jcom.com_all_gather(xl, "model").reshape(-1, xl.shape[-1]),
                      mesh=mesh, in_specs=P("model", None), out_specs=P(None, None))(inp["xa"]),
           "bidir": smap(lambda xl, wl: jcom.com_matmul_local_bidir(xl, wl, "model"), mesh=mesh,
                         in_specs=(P(None, "model"), P("model", None)),
                         out_specs=P(None, "model"))(inp["x"], inp["w"])}
    com_mm = jcom.make_com_matmul(mesh, "model")
    for name, kw in ranks.EPILOGUES.items():
        kw = {k: inp[v] if k in ("bias", "residual") else v for k, v in kw.items()}
        res[f"com_{name}"] = com_mm(inp["x"], inp["w"], **kw)
    for strategy in ("psum", "com", "com_bidir"):
        res[strategy] = jcoll.matmul_strategy(mesh, strategy)(inp["x"], inp["w"])
    mesh3 = jax_compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
    red, err = jgc.compressed_pod_psum({"a": inp["ga"], "b": inp["gb"]}, None, mesh3, axis="pod")
    res.update({f"rep_red_{k}": v for k, v in red.items()})
    res.update({f"rep_err_{k}": v for k, v in err.items()})
    np.savez(out, **{k: np.asarray(v) for k, v in res.items()})
    meshes = {str(MeshPlan(**kw)): list(jax_build_mesh(JaxMeshPlan(**kw)).shape.items())
              for kw in (dict(data=2, model=4), dict(data=2, model=2, pod=2))}
    Path(str(out) + ".json").write_text(json.dumps({"build_mesh": meshes}))


# ---- the ranks and the reference, once for the module ------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("collectives")
    np.savez(d / "inputs.npz", **_inputs())
    return d


@pytest.fixture(scope="module")
def reference(workdir):
    out = workdir / "reference.npz"
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, __file__, "--reference", str(workdir / "inputs.npz"),
                           str(out)], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out)), json.loads(Path(str(out) + ".json").read_text())


def _gather(workdir, name, world):
    return ([dict(np.load(workdir / f"{name}_{r}.npz")) for r in range(world)],
            [json.loads((workdir / f"{name}_{r}.json").read_text()) for r in range(world)])


@pytest.fixture(scope="module")
def ring(workdir):
    ranks.spawn(ranks.ring_rank, N_RANKS, workdir, timeout=300)
    return _gather(workdir, "ring", N_RANKS)


@pytest.fixture(scope="module")
def smollm():
    """Reduced smollm-135m: the JAX params and 4 rows of 25 tokens."""
    cfg = jax_get_config("smollm-135m").reduced()
    params = jax_build_model(cfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(11).integers(1, cfg.vocab_size, size=(4, 25)).astype(np.int32)
    return params, jax.tree.map(np.asarray, params), toks


@pytest.fixture(scope="module")
def train(workdir, ring, smollm):
    _, np_params, toks = smollm
    with open(workdir / "params.pkl", "wb") as f:
        pickle.dump(np_params, f)
    np.savez(workdir / "batch.npz", tokens=toks)
    ranks.spawn(ranks.train_rank, 4, workdir, timeout=300)
    return _gather(workdir, "train", 4)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max())


# ---- the ring ----------------------------------------------------------------------------


@pytest.mark.timeout(900)
def test_reduce_scatter_is_bitwise_the_reference(ring, reference):
    outs, _ = ring
    got = np.concatenate([o["rs"] for o in outs])
    np.testing.assert_array_equal(got, reference[0]["rs"])
    _close(got, np.asarray(_inputs()["xg"]).reshape(8, 8, 16, 5).sum(0).reshape(128, 5))


@pytest.mark.timeout(900)
def test_all_gather_is_bitwise_the_reference(ring, reference):
    outs, _ = ring
    for o in outs:
        np.testing.assert_array_equal(o["ag"].reshape(16, 3), reference[0]["ag"])
        np.testing.assert_array_equal(o["ag"].reshape(16, 3), _inputs()["xa"])


@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", EPILOGUES)
def test_com_matmul_matches_the_reference(ring, reference, name):
    """The DTensor's full_tensor() on every rank, and each rank's shard its
    columns of it."""
    outs, _ = ring
    want = reference[0][f"com_{name}"]
    for r, o in enumerate(outs):
        _close(o[f"com_{name}"], want)
        np.testing.assert_array_equal(o[f"com_{name}_local"], o[f"com_{name}"][:, 4 * r:4 * r + 4])
    inp = _inputs()
    dense = torch.from_numpy(inp["x"]) @ torch.from_numpy(inp["w"])
    if name == "bias_res":
        dense = dense + torch.from_numpy(inp["bias"])
    dense = {"silu": torch.nn.functional.silu,
             "gelu": lambda y: torch.nn.functional.gelu(y, approximate="tanh")}.get(name, lambda y: y)(dense)
    if name == "bias_res":
        dense = dense + torch.from_numpy(inp["residual"])
    _close(outs[0][f"com_{name}"], dense.numpy())


@pytest.mark.timeout(900)
def test_bidirectional_ring_matches_the_reference(ring, reference):
    outs, _ = ring
    _close(np.concatenate([o["bidir"] for o in outs], axis=-1), reference[0]["bidir"])


@pytest.mark.timeout(900)
@pytest.mark.parametrize("strategy", ["psum", "com", "com_bidir"])
def test_strategies_match_the_reference(ring, reference, strategy):
    outs, infos = ring
    for o in outs:
        _close(o[strategy], reference[0][strategy])
    want = ["Replicate()"] if strategy == "psum" else ["Shard(dim=1)"]
    assert infos[0][f"{strategy}_placements"] == want


def _counted_case(name):
    """(counter name, the output's bytes, strategy) of a ring test case."""
    f32 = 4
    if name == "rs":
        return 128 * 5 * f32, "com"
    if name == "ag":   # a gather sends (n-1) of n shards: (n-1)/n of the gathered bytes
        return 16 * 3 * f32, "com"
    return 4 * 32 * f32, {"psum": "psum", "com_bidir": "com_bidir", "bidir": "com_bidir"}.get(name, "com")


@pytest.mark.timeout(900)
@pytest.mark.parametrize("name", ["rs", "ag", "bidir", "psum", "com", "com_bidir"]
                         + [f"com_{e}" for e in EPILOGUES])
def test_counted_bytes_equal_wire_bytes(ring, name):
    _, infos = ring
    out_bytes, strategy = _counted_case(name)
    for info in infos:
        c = info[name]
        if strategy == "psum":
            assert (c["sends"], c["bytes_sent"]) == (0, 0)
            assert (c["all_reduces"], c["all_reduce_bytes"]) == (1, out_bytes)
        else:
            assert c["bytes_sent"] == collectives.wire_bytes(strategy, out_bytes, N_RANKS)
            assert c["sends"] == (2 if strategy == "com_bidir" else 1) * (N_RANKS - 1)
            assert c["all_reduces"] == 0
    assert collectives.wire_bytes("com", out_bytes, N_RANKS) == \
        0.5 * collectives.wire_bytes("psum", out_bytes, N_RANKS)


@pytest.mark.timeout(900)
def test_com_matmul_refuses_a_tensor_off_the_mesh_device_and_a_wrong_world(ring):
    _, infos = ring
    assert all(i.get("refuses_other_device") and i.get("refuses_wrong_world") for i in infos)


@pytest.mark.parametrize("n,shift", [(1, 1), (2, 1), (2, -1), (8, 1), (8, -1), (5, 3)])
def test_ring_perm_equals_the_reference(n, shift):
    assert com._ring_perm(n, shift) == jcom._ring_perm(n, shift)


@pytest.mark.parametrize("strategy", ["psum", "com", "com_bidir"])
@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_wire_bytes_equal_the_reference(strategy, n):
    for out_bytes in (0, 1024, 5120 * 2048 * 4, 7):
        assert collectives.wire_bytes(strategy, out_bytes, n) == \
            jcoll.wire_bytes(strategy, out_bytes, n)


def test_wire_bytes_refuses_an_unknown_strategy():
    with pytest.raises(ValueError):
        collectives.wire_bytes("ring", 8, 2)
    with pytest.raises(ValueError):
        collectives.matmul_strategy(None, "ring")


# ---- the compressed pod mean ---------------------------------------------------------------


def _quant_cases():
    rng = np.random.default_rng(5)
    ties = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5]], np.float32)
    return {"matrix": rng.normal(size=(16, 8)).astype(np.float32),
            "vector": rng.normal(size=(33,)).astype(np.float32),
            "scalar": np.array(2.75, np.float32),
            "rank3": rng.normal(size=(3, 4, 5)).astype(np.float32) * 1e-3,
            "ties": ties, "zeros": np.zeros((2, 3), np.float32),
            "tiny": np.full((2, 2), 1e-30, np.float32)}


@pytest.mark.parametrize("case", list(_quant_cases()))
def test_int8_codes_and_scales_equal_the_reference(case):
    x = _quant_cases()[case]
    q, s = grad_compress._quant_rows(torch.from_numpy(x))
    jq, js = jgc._quant_rows(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(grad_compress._dequant_rows(q, s, x.shape).numpy(),
                                  np.asarray(jgc._dequant_rows(jq, js, x.shape)))


@pytest.mark.timeout(900)
@pytest.mark.parametrize("leaf", ["a", "b"])
def test_compressed_pod_mean_of_replicated_grads_matches_the_reference(ring, reference, leaf):
    outs, _ = ring
    for o in outs:
        np.testing.assert_allclose(o[f"rep_red_{leaf}"], reference[0][f"rep_red_{leaf}"],
                                   **F32_ROUNDING)
        np.testing.assert_allclose(o[f"rep_err_{leaf}"], reference[0][f"rep_err_{leaf}"],
                                   **F32_ROUNDING)
    g = _inputs()[f"g{leaf}"]
    assert np.abs(outs[0][f"rep_err_{leaf}"]).max() < 0.02 * np.abs(g).max()


def _deq(x):
    q, s = jgc._quant_rows(jnp.asarray(x))
    return np.asarray(jgc._dequant_rows(q, s, x.shape))


@pytest.mark.timeout(900)
@pytest.mark.parametrize("leaf", ["a", "b"])
def test_compressed_pod_mean_of_grads_by_pod_is_the_mean_of_dequantized_rows(ring, leaf):
    """Pod p holds g + p * d: the mean over pods of each pod's dequantized
    rows, each rank's residual its own pod's; then the same with that
    residual fed back."""
    outs, infos = ring
    inp = _inputs()
    by_pod = [inp[f"g{leaf}"] + p * inp[f"d{leaf}"] for p in (0, 1)]
    want = (_deq(by_pod[0]) + _deq(by_pod[1])) / 2
    fed = [g + (g - _deq(g)) for g in by_pod]
    want2 = (_deq(fed[0]) + _deq(fed[1])) / 2
    for o, info in zip(outs, infos):
        g = by_pod[info["pod"]]
        np.testing.assert_allclose(o[f"pod_red_{leaf}"], want, **F32_ROUNDING)
        np.testing.assert_allclose(o[f"pod_err_{leaf}"], g - _deq(g), **F32_ROUNDING)
        np.testing.assert_allclose(o[f"pod_red2_{leaf}"], want2, rtol=2 ** -22,
                                   atol=2 ** -22 * np.abs(want2).max())
        np.testing.assert_allclose(o[f"pod_err2_{leaf}"], fed[info["pod"]] - _deq(fed[info["pod"]]),
                                   rtol=2 ** -22, atol=2 ** -22 * np.abs(fed[0]).max())


@pytest.mark.timeout(900)
def test_compressed_pod_mean_sends_codes_and_scales(ring):
    """Each leaf's int8 codes and float32 row scales go round the pod ring
    (one hop at two pods): 128 + 64 bytes for a (16, 8) leaf, 4 + 4 for a
    (4,) one, where a float32 all-reduce would reduce 512 + 16."""
    _, infos = ring
    for info in infos:
        assert info["compress"] == {"sends": 4, "bytes_sent": 128 + 64 + 4 + 4,
                                    "all_reduces": 0, "all_reduce_bytes": 0}
        assert info["no_pod_axis_returns_early"]


# ---- meshes and sharding rules -----------------------------------------------------------


@pytest.mark.timeout(900)
def test_build_mesh_shapes_equal_the_reference(ring, reference):
    _, infos = ring
    want = {k: [list(x) for x in v] for k, v in reference[1]["build_mesh"].items()}
    for info in infos:
        assert {k: [list(x) for x in v] for k, v in info["build_mesh"].items()} == want


def test_no_mesh_on_the_cpu_by_default():
    """device_type=None is the card: without one, every process mesh
    raises (a card without a process group raises that it is missing)."""
    want = "not initialized" if torch.cuda.is_available() else "no CUDA device"
    for make in (make_debug_mesh, make_production_mesh, lambda: make_debug_mesh(pod=2),
                 lambda: build_mesh(MeshPlan(data=2, model=2))):
        with pytest.raises(RuntimeError, match=want):
            make()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_data_mesh()


def test_a_process_mesh_needs_an_initialized_world():
    with pytest.raises(RuntimeError, match="not initialized"):
        make_debug_mesh(device_type="cpu")


def test_data_mesh_is_a_device_list():
    mesh = make_data_mesh(["cpu", torch.device("cpu")])
    assert isinstance(mesh, DataMesh) and mesh.shape == {"data": 2} and len(mesh) == 2
    assert list(mesh) == [torch.device("cpu")] * 2 and mesh.axis_names == ("data",)
    with pytest.raises(ValueError):
        make_data_mesh([])


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {"16x16": {"data": 16, "model": 16}, "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x4": {"data": 2, "model": 4}, "2x2x2": {"pod": 2, "data": 2, "model": 2}}
LOGICAL = [(("batch", None, "vocab"), (256, 10, 122753)), (("batch", None, "vocab"), (256, 10, 49152)),
           (("embed", "mlp"), (576, 1536)), (("vocab", "embed"), (122753, 2304)),
           (("vocab", "embed"), (49152, 576)), (("embed", "heads", None), (2048, 32, 64)),
           (("embed", "kv", None), (5120, 8, 128)), (("experts", "embed", "mlp"), (16, 6144, 10752)),
           (("experts_ep", "embed", "mlp"), (16, 6144, 10752)), (("layers", "embed", "mlp"), (30, 576, 1536)),
           (("batch", "kv_seq", "kv_heads", None), (8, 2048, 3, 64)), (("batch", "seq", "embed"), (6, 97, 576)),
           (("exp_dp", "experts", None), (4, 16, 128)), (("ssm_heads", "ssm_conv"), (32, 4)),
           ((None, "embed"), (3, 7)), (("heads", "heads"), (32, 32))]


def _rule_sets(mod, mesh):
    return {"params": mod.param_rules(mesh), "train": mod.act_rules(mesh),
            "decode": mod.act_rules(mesh, job="decode"),
            "prefill_seq": mod.act_rules(mesh, job="prefill", seq_shard=True)}


@pytest.mark.parametrize("kind", ["params", "train", "decode", "prefill_seq"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_spec_for_equals_the_reference_axis_for_axis(mesh, kind):
    mine = _rule_sets(sharding, FakeMesh(MESHES[mesh]))[kind]
    ref = _rule_sets(jsh, FakeMesh(MESHES[mesh]))[kind]
    assert mine.rules == ref.rules
    for axes, shape in LOGICAL:
        assert mine.spec_for(axes, shape) == tuple(ref.spec_for(axes, shape)), (axes, shape)
    assert mine.dropped == ref.dropped


def test_the_minicpm_vocab_is_dropped_and_recorded():
    r = sharding.ShardingRules(rules={"vocab": "model", "batch": ("data",)},
                               mesh=FakeMesh(MESHES["16x16"]))
    assert r.spec_for(("batch", None, "vocab"), (256, 10, 122753)) == ("data", None, None)
    assert r.dropped == ["vocab:122753"]
    assert r.spec_for(("batch", None, "vocab"), (256, 10, 49152)) == ("data", None, "model")


def test_tree_batch_and_leading_axis_shardings_equal_the_reference():
    from repro.core import jax_compat

    jmesh = jax_compat.make_mesh((1, 1), ("data", "model"))
    fake = FakeMesh({"data": 1, "model": 1})
    axes = {"embed": {"table": ("vocab", "embed")}, "blocks": [("embed", "mlp"), ("mlp", "embed")]}
    shapes = {"embed": {"table": np.zeros((50, 8))},
              "blocks": [np.zeros((3, 8, 16)), np.zeros((3, 16, 8))]}
    mine = sharding.param_rules(fake).tree_shardings(axes, shapes)
    ref = jsh.param_rules(jmesh).tree_shardings(axes, shapes)
    assert mine["embed"]["table"].spec == tuple(ref["embed"]["table"].spec)
    for m, r in zip(mine["blocks"], ref["blocks"]):
        assert m.spec == tuple(r.spec)
    batch = {"tokens": np.zeros((4, 9), np.int32), "image_embeds": np.zeros((4, 5, 8))}
    mine = sharding.batch_shardings(sharding.act_rules(fake), batch)
    ref = jsh.batch_shardings(jsh.act_rules(jmesh), batch)
    assert {k: v.spec for k, v in mine.items()} == {k: tuple(v.spec) for k, v in ref.items()}
    jdata = jax_compat.make_mesh((1,), ("data",))
    assert sharding.leading_axis_sharding(make_data_mesh(["cpu"]), 3).spec == \
        tuple(jsh.leading_axis_sharding(jdata, 3).spec)


def test_sharding_placements_follow_the_mesh_axes():
    from torch.distributed.tensor import Replicate, Shard

    class Names:
        mesh_dim_names = ("pod", "data", "model")

    place = lambda spec: sharding.Sharding(Names(), spec).placements  # noqa: E731
    assert place((("pod", "data"), None, "model")) == [Shard(0), Shard(0), Shard(2)]
    assert place(("data", None)) == [Replicate(), Shard(0), Replicate()]
    assert place((None, None)) == [Replicate()] * 3
    # a dim over axes out of the mesh's order (the expert-parallel slices'
    # ("model", "pod", "data")) is split in the mesh's order, DTensor's only one
    assert place((("model", "pod"),)) == [Shard(0), Replicate(), Shard(0)]


# ---- pipeline ----------------------------------------------------------------------------


@pytest.mark.parametrize("stages,batch,micro", [(4, 64, 4), (1, 8, 8), (2, 7, 2), (3, 1, 4), (8, 256, 16)])
def test_pipeline_plans_equal_the_reference(stages, batch, micro):
    mine, ref = pipeline.plan(stages, batch, micro), jpipe.plan(stages, batch, micro)
    assert (mine.n_stages, mine.n_microbatches) == (ref.n_stages, ref.n_microbatches)
    assert mine.bubble_fraction == ref.bubble_fraction
    for kw in (dict(grad_bytes=1e9, act_bytes_per_mb=1e6, link_bw=1e10, step_compute_s=0.5),
               dict(grad_bytes=1e6, act_bytes_per_mb=1e8, link_bw=1e9, step_compute_s=0.01)):
        assert mine.better_than_dp(**kw) == ref.better_than_dp(**kw)
    assert pipeline.PipelinePlan(1, 8).bubble_fraction == jpipe.PipelinePlan(1, 8).bubble_fraction


def test_gpipe_forward_equals_the_reference():
    fns = [lambda x: x + 1, lambda x: x * 2, lambda x: x - 3]
    xs = np.arange(10.0, dtype=np.float32).reshape(5, 2)
    got = pipeline.gpipe_forward(fns, torch.from_numpy(xs))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jpipe.gpipe_forward(fns, jnp.asarray(xs))))


# ---- the sharded sweep -------------------------------------------------------------------


def _grid():
    return SweepGrid(networks=("vgg11-cifar", "resnet18-cifar", "llm:smollm-135m"), chip_counts=(5, 10, 20),
                     precisions=(8, 16), e_mac_pj=(0.02, 0.05, 0.1), tiles_per_chip=(180, 240),
                     dataflow=("com", "minimal_buffer"))


@pytest.mark.parametrize("chunk", [None, 7], ids=["whole", "chunk7"])
@pytest.mark.parametrize("shards", [1, 2, 3])
def test_sharded_sweep_is_bitwise_the_torch_backend_and_meets_numpy(shards, chunk):
    grid = _grid()
    got = run_sweep(grid, backend=make_sharded_backend(make_data_mesh(["cpu"] * shards)),
                    chunk_size=chunk)
    flat = run_sweep(grid, backend="torch", device="cpu", chunk_size=chunk or grid.n_scenarios)
    oracle = run_sweep(grid, backend="numpy")
    assert got.backend == "torch-sharded"
    for c in COLUMNS:
        np.testing.assert_array_equal(got.columns[c], flat.columns[c], err_msg=c)
        np.testing.assert_allclose(got.columns[c], oracle.columns[c], rtol=1e-6, err_msg=c)


def test_sharded_sweep_by_name_takes_every_card():
    """run_sweep(backend="torch-sharded") resolves the name on use and
    splits over every visible card: none here, so it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_sweep(_grid(), backend="torch-sharded")


def test_sharded_sweep_pads_to_the_mesh():
    from repro.parallel.shard_sweep import _pad_to_multiple as jpad

    from repro_torch.parallel.shard_sweep import _pad_to_multiple

    for n, k in ((7, 3), (6, 3), (1, 4)):
        a = np.arange(n * 2, dtype=np.float64).reshape(n, 2)
        np.testing.assert_array_equal(_pad_to_multiple(a, k), jpad(a, k))


# ---- data/pod-parallel training and the elastic restore ------------------------------------


@pytest.mark.timeout(900)
def test_data_parallel_step_matches_the_one_device_step(train, smollm):
    """Four ranks a row each on (pod=2, data=2) against the reference's
    jitted step and jax.value_and_grad on the four rows."""
    params, np_params, toks = smollm
    outs, infos = train
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    cfg = jax_get_config("smollm-135m").reduced()
    jm = jax_build_model(cfg, JaxCallConfig(remat="block", compute_dtype=jnp.float32))
    (jloss, _), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    ocfg = jopt.OptConfig(**ranks.TRAIN_OPT)
    _, jmets = jax.jit(jax_make_train_step(jm, ocfg))(
        {"params": params, "opt": jopt.init_opt_state(params, ocfg), "rng": jax.random.PRNGKey(0)},
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss = np.mean([i["dp"]["loss"] for i in infos])
    np.testing.assert_allclose(loss, float(jloss), rtol=2e-5)
    np.testing.assert_allclose(loss, float(jmets["loss"]), rtol=2e-2)  # tests/_mesh_checks.py:125
    for i in infos:
        assert i["dp"]["grad_norm"] == pytest.approx(float(jmets["grad_norm"]), rel=1e-4)
    tm = model_params_to_port(get_config("smollm-135m").reduced(), np_params, device="cpu")
    got = stack_tree(tm.cfg, tm, {k[len("dp."):]: v for k, v in outs[0].items() if k.startswith("dp.")})
    want = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    got_flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in got_flat] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got_flat, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=GRAD_TOL["rtol"], atol=GRAD_TOL["atol"] * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))
    for o in outs[1:]:
        for k in outs[0]:
            if k.startswith("dp."):
                np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


def _rows_amax(g):
    flat = g.reshape(-1) if g.ndim <= 1 else g.reshape(g.shape[0], -1)
    return np.abs(flat).max(axis=-1, keepdims=True)


@pytest.mark.timeout(900)
def test_compressed_step_stays_within_each_rows_int8_bound(train):
    """Every gradient leaf of the compressed step within max over pods of
    its row's max|g| / 254 (plus float32 rounding) of the uncompressed
    mean; the error feedback under 2 % of max|g| (tests/_mesh_checks.py:98)."""
    outs, infos = train
    pods = {i["pod"]: o for o, i in zip(outs, infos)}
    names = [k[len("dp."):] for k in outs[0] if k.startswith("dp.")]
    for name in names:
        amax = np.maximum(*(_rows_amax(pods[p][f"data_mean.{name}"]) for p in (0, 1)))
        bound = amax * (1 / 254 + 2 ** -20)
        for o in outs:
            diff = np.abs(o[f"compressed.{name}"] - o[f"dp.{name}"])
            diff = diff.reshape(-1) if diff.ndim <= 1 else diff.reshape(diff.shape[0], -1)
            assert (diff <= bound).all(), name
            g = o[f"data_mean.{name}"]
            assert np.abs(o[f"error.{name}"]).max() <= 0.02 * np.abs(g).max(), name
    assert all(i["compressed"]["carry"] and not i["dp"]["carry"] for i in infos)


@pytest.mark.timeout(900)
def test_elastic_restore_onto_the_remeshed_plan(train, ring):
    """Saved on (2, 4), restored onto build_mesh(plan_remesh(MeshPlan(2, 4),
    4)) = (1, 4): values equal, step 7, accumulation doubled."""
    outs, infos = train
    for o, i in zip(outs, infos):
        np.testing.assert_array_equal(o["restored"], np.arange(64, dtype=np.float32).reshape(8, 8))
        assert i["step"] == 7 and i["devices"] == 4
        assert i["plan"] == [1, 4, 0, 2]
        assert i["mesh_b"] == [["data", 1], ["model", 4]]
        assert i["restored_local_shape"] == [8, 2]
    assert all(i["saved_local_shape"] == [4, 2] for i in ring[1])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reference"]:
        _reference(Path(sys.argv[2]), Path(sys.argv[3]))
