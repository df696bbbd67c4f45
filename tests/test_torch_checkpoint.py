"""The port's data pipeline, checkpoints and re-mesh plan against the JAX
package's, on the CPU.

* ``SyntheticTokens.batch_at`` gives the reference's batches bit for bit
  over seeds, steps, hosts and codebooks; host shards are disjoint; the
  ``Prefetcher`` keeps step order (the mirrors of tests/test_infra.py).
* Checkpoints keep the reference's layout: a round trip, GC, an
  uncommitted directory ignored, and a checkpoint written by either package
  restored by the other with equal keys and leaves, for plain trees and
  for reduced smollm-135m's whole train state (fp32 and int8 moments;
  bf16 moments restore in the port from either package's checkpoint); the
  restore's one-pass reader against ``np.load``.
* ``plan_remesh`` equals the reference's over a grid.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jck
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import SyntheticTokens as JaxSyntheticTokens
from repro.models.transformer import CallConfig as JaxCallConfig
from repro.models.transformer import build_model as jax_build_model
from repro.runtime.elastic import MeshPlan as JaxMeshPlan
from repro.runtime.elastic import plan_remesh as jax_plan_remesh
from repro.train import optimizer as jopt
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.data.pipeline import DataConfig, Prefetcher, SyntheticTokens
from repro_torch.models.transformer import CallConfig
from repro_torch.runtime.elastic import MeshPlan, plan_remesh
from repro_torch.train import optimizer as topt
from repro_torch.train.train_step import (load_state_tree, make_train_state, make_train_step,
                                          state_tree)


# ---- data ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,codebooks", [(0, 0), (7, 0), (3, 4)])
@pytest.mark.parametrize("num_hosts", [1, 2])
def test_batches_equal_the_references(seed, codebooks, num_hosts):
    kw = dict(vocab_size=300, seq_len=130, global_batch=4, seed=seed, num_codebooks=codebooks)
    for host in range(num_hosts):
        mine = SyntheticTokens(DataConfig(**kw), host_id=host, num_hosts=num_hosts)
        ref = JaxSyntheticTokens(JaxDataConfig(**kw), host_id=host, num_hosts=num_hosts)
        for step in (0, 1, 42):
            a, b = mine.batch_at(step), ref.batch_at(step)
            assert set(a) == set(b) == {"tokens", "targets"}
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k], b[k])


def test_data_deterministic_and_seekable():
    cfg = DataConfig(vocab_size=128, seq_len=32, global_batch=4, seed=7)
    s1, s2 = SyntheticTokens(cfg), SyntheticTokens(cfg)
    b1, b2 = s1.batch_at(42), s2.batch_at(42)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (4, 32)
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["targets"][:, :-1])
    assert not np.array_equal(s1.batch_at(43)["tokens"], b1["tokens"])


def test_data_host_sharding_disjoint():
    cfg = DataConfig(vocab_size=128, seq_len=16, global_batch=8, seed=0)
    h0 = SyntheticTokens(cfg, host_id=0, num_hosts=2).batch_at(5)
    h1 = SyntheticTokens(cfg, host_id=1, num_hosts=2).batch_at(5)
    assert h0["tokens"].shape == (4, 16)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


def test_prefetcher_orders_steps():
    src = SyntheticTokens(DataConfig(vocab_size=64, seq_len=8, global_batch=2))
    pf = Prefetcher(src, depth=2, start_step=10)
    try:
        got = [pf.next() for _ in range(4)]
    finally:
        pf.close()
    assert [s for s, _ in got] == [10, 11, 12, 13]
    for s, b in got:
        np.testing.assert_array_equal(b["tokens"], src.batch_at(s)["tokens"])


# ---- checkpoints: plain trees ---------------------------------------------------------


def test_checkpoint_roundtrip_and_gc(tmp_path):
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "b": {"c": np.float32(2.5)},
            "t": torch.arange(4, dtype=torch.int32)}
    d = str(tmp_path)
    for s in (5, 10, 15, 20):
        ck.save(d, s, tree, keep=2)
    assert ck.latest_step(d) == 20
    assert len([n for n in os.listdir(d) if n.startswith("step_")]) == 2  # GC kept 2
    restored, man = ck.restore(d, tree)
    np.testing.assert_array_equal(restored["a"], tree["a"])
    assert restored["b"]["c"] == np.float32(2.5)
    np.testing.assert_array_equal(restored["t"], np.arange(4, dtype=np.int32))
    assert man["step"] == 20 and man["keys"] == ["['a']", "['b']['c']", "['t']"]
    restored, man = ck.restore(d, tree, step=15)
    assert man["step"] == 15


def test_uncommitted_checkpoint_ignored(tmp_path):
    tree = {"a": np.zeros(3, np.float32)}
    d = str(tmp_path)
    ck.save(d, 1, tree)
    os.makedirs(os.path.join(d, "step_00000002"))  # a partial write: no _COMMITTED
    assert ck.latest_step(d) == 1
    assert ck.latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        ck.restore(str(tmp_path / "none"), tree)


def test_save_async_copies_before_returning(tmp_path):
    t = torch.ones(5)
    th = ck.save_async(str(tmp_path), 3, {"w": t})
    t.zero_()  # training goes on changing the tensor
    th.join()
    restored, _ = ck.restore(str(tmp_path), {"w": None})
    np.testing.assert_array_equal(restored["w"], np.ones(5, np.float32))


TREE = {"z": np.arange(3, dtype=np.int32), "a": {"y": np.float32(1.5),
                                               "b": np.ones((2, 2), np.float32)},
        "l": [np.zeros(2, np.uint8), (np.full(3, 7, np.int64),)]}


def _same_checkpoint(got, want, man_got, man_want):
    assert man_got["keys"] == man_want["keys"]
    assert man_got["shapes"] == man_want["shapes"] and man_got["dtypes"] == man_want["dtypes"]
    fg, fw = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(fg) == len(fw)
    for a, b in zip(fg, fw):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("writer", ["savez", "savez_compressed"])
def test_restore_reads_every_npz_member_as_np_load(tmp_path, writer):
    """The restore's one-pass reader gives np.load's arrays (dtype, shape,
    order and bytes) for float32, int8, 0-d, empty, Fortran-order and
    bfloat16 (2-byte void) leaves; compressed members go through np.load;
    a flipped byte fails the member's CRC."""
    import ml_dtypes
    import zipfile

    arrays = {"leaf_0": np.arange(12, dtype=np.float32).reshape(3, 4),
              "leaf_1": np.asarray(np.int32(5)), "leaf_2": np.zeros((0, 3), np.float32),
              "leaf_3": np.asfortranarray(np.arange(6.0).reshape(2, 3)),
              "leaf_4": np.arange(6, dtype=np.float32).astype(ml_dtypes.bfloat16),
              "leaf_5": np.arange(-5, 5, dtype=np.int8)}
    path = str(tmp_path / "shard.npz")
    getattr(np, writer)(path, **arrays)
    got = ck._loadz(path, list(arrays))
    with np.load(path) as want:
        for name, g in zip(arrays, got):
            w = want[name]
            assert (g.dtype, g.shape, g.flags.f_contiguous) == (w.dtype, w.shape, w.flags.f_contiguous)
            assert g.tobytes(order="A") == w.tobytes(order="A"), name
    if writer == "savez":
        raw = bytearray(open(path, "rb").read())
        at = raw.find(arrays["leaf_0"].tobytes())
        raw[at + 5] ^= 1
        open(path, "wb").write(bytes(raw))
        with pytest.raises(zipfile.BadZipFile, match="leaf_0"):
            ck._loadz(path, list(arrays))


def test_restore_reads_in_chunks_with_the_crc_of_each(tmp_path, monkeypatch):
    """The reader at a chunk of 7 bytes (a member in many pieces, the last
    one short, each CRC taken while the next piece is read): np.load's
    bytes, and a byte flipped in a middle piece still fails the CRC."""
    import zipfile

    monkeypatch.setattr(ck, "READ_CHUNK", 7)
    arrays = {"leaf_0": np.arange(1000, dtype=np.float32).reshape(10, 100),
              "leaf_1": np.arange(3, dtype=np.int8)}
    path = str(tmp_path / "shard.npz")
    np.savez(path, **arrays)
    for name, g in zip(arrays, ck._loadz(path, list(arrays))):
        assert g.tobytes() == arrays[name].tobytes(), name
    raw = bytearray(open(path, "rb").read())
    raw[raw.find(arrays["leaf_0"].tobytes()) + 2001] ^= 1
    open(path, "wb").write(bytes(raw))
    with pytest.raises(zipfile.BadZipFile, match="leaf_0"):
        ck._loadz(path, list(arrays))


def test_checkpoints_cross_between_the_packages(tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save(jd, 4, TREE)
    ck.save(td, 4, TREE)
    jman = jck.restore(jd, TREE)[1]
    tman = ck.restore(td, TREE)[1]
    assert tman["treedef"] == jman["treedef"]
    # the reference's checkpoint read by the port, the port's by the reference
    got, man = ck.restore(jd, TREE)
    want, wman = jck.restore(jd, TREE)
    _same_checkpoint(got, want, man, wman)
    got, man = jck.restore(td, TREE)
    _same_checkpoint(got, TREE, man, jman)


# ---- checkpoints: the train state -----------------------------------------------------


@pytest.fixture(scope="module")
def reduced_smollm():
    cfg = jax_get_config("smollm-135m").reduced()
    params = jax_build_model(cfg, JaxCallConfig(remat="none")).init(jax.random.PRNGKey(0))
    return params, jax.tree.map(np.asarray, params)


def _port_state(np_params, moments, seed=0):
    tm = model_params_to_port(get_config("smollm-135m").reduced(), np_params,
                              cc=CallConfig(compute_dtype=torch.float32), device="cpu")
    ocfg = topt.OptConfig(moment_dtype=moments, schedule="const", warmup_steps=1)
    state = make_train_state(tm, None, ocfg)
    return state, make_train_step(tm, ocfg)


@pytest.mark.parametrize("moments", ["fp32", "int8"])
def test_train_state_checkpoints_cross_between_the_packages(tmp_path, reduced_smollm, moments):
    """A port train state after one step, saved by the port, restores in the
    reference with the reference's keys; a reference train state saved by
    the reference restores in the port, parameters and moments bitwise."""
    params, np_params = reduced_smollm
    state, step = _port_state(np_params, moments)
    rng = np.random.default_rng(2)
    toks = rng.integers(1, 512, size=(2, 9)).astype(np.int32)
    state, _ = step(state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    jcfg = jopt.OptConfig(moment_dtype=moments)
    jstate = {"params": params, "opt": jopt.init_opt_state(params, jcfg),
              "rng": jax.random.PRNGKey(0)}

    ck.save(str(tmp_path / "port"), 1, state_tree(state))
    got, man = jck.restore(str(tmp_path / "port"), jstate)
    want_keys = [jax.tree_util.keystr(p) for p, _ in
                 jax.tree_util.tree_flatten_with_path(jstate)[0]]
    assert man["keys"] == want_keys
    mine = state_tree(state)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(mine)):
        assert np.asarray(a).dtype == np.asarray(b).dtype, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert int(got["opt"]["step"]) == 1

    # the reference's state, one AdamW step away from its init, into a fresh port state
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    jp, jo, _ = jopt.adamw_update(params, grads, jstate["opt"], jcfg)
    jstate = {"params": jp, "opt": jo, "rng": jax.random.PRNGKey(5)}
    jck.save(str(tmp_path / "jax"), 1, jax.tree.map(np.asarray, jstate))
    fresh, _ = _port_state(np_params, moments)
    tree, man = ck.restore(str(tmp_path / "jax"), state_tree(fresh))
    load_state_tree(fresh, tree)
    back = state_tree(fresh)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0], jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=jax.tree_util.keystr(path))
    assert int(fresh["opt"]["step"]) == 1 and list(fresh["rng"]) == [0, 5]


def test_bf16_moments_restore_as_bfloat16(tmp_path, reduced_smollm):
    """bfloat16 leaves go to disk as JAX writes them (ml_dtypes' bfloat16,
    which np.load reads back as 2-byte void): the port restores its own and
    the reference's as bfloat16, bitwise (ROADMAP Queue 3, item 24: the
    reference's restore hands the void arrays on as they are)."""
    params, np_params = reduced_smollm
    state, step = _port_state(np_params, "bf16")
    toks = np.random.default_rng(4).integers(1, 512, size=(2, 9)).astype(np.int32)
    state, _ = step(state, {"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    ck.save(str(tmp_path / "port"), 1, state_tree(state))
    fresh, _ = _port_state(np_params, "bf16")
    tree, _ = ck.restore(str(tmp_path / "port"), state_tree(fresh))
    load_state_tree(fresh, tree)
    for name, m in state["opt"]["m"].items():
        assert fresh["opt"]["m"][name].dtype == torch.bfloat16
        assert torch.equal(fresh["opt"]["m"][name], m) and torch.equal(fresh["opt"]["v"][name],
                                                                       state["opt"]["v"][name])
    jcfg = jopt.OptConfig(moment_dtype="bf16")
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, jnp.float32), params)
    jp, jo, _ = jopt.adamw_update(params, grads, jopt.init_opt_state(params, jcfg), jcfg)
    jck.save(str(tmp_path / "jax"), 1, jax.tree.map(np.asarray, {"params": jp, "opt": jo,
                                                                  "rng": jax.random.PRNGKey(0)}))
    tree, _ = ck.restore(str(tmp_path / "jax"), state_tree(fresh))
    load_state_tree(fresh, tree)
    back = state_tree(fresh)["opt"]["m"]
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(back)[0], jax.tree.leaves(jo["m"])):
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def test_resumed_train_state_steps_as_the_uninterrupted_one(tmp_path, reduced_smollm):
    """Save after 2 of 4 steps, restore into a fresh state, take the last 2:
    losses and parameters bitwise the uninterrupted run's."""
    _, np_params = reduced_smollm
    rng = np.random.default_rng(9)
    batches = []
    for _ in range(4):
        toks = rng.integers(1, 512, size=(2, 9)).astype(np.int32)
        batches.append({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
    state, step = _port_state(np_params, "fp32")
    losses = []
    for i, b in enumerate(batches):
        state, mets = step(state, b)
        losses.append(float(mets["loss"]))
        if i == 1:
            ck.save(str(tmp_path), 2, state_tree(state))
    fresh, fstep = _port_state(np_params, "fp32")
    tree, man = ck.restore(str(tmp_path), state_tree(fresh))
    load_state_tree(fresh, tree)
    assert man["step"] == 2
    for b, want in zip(batches[2:], losses[2:]):
        fresh, mets = fstep(fresh, b)
        assert float(mets["loss"]) == want
    for (n, a), (_, b) in zip(fresh["params"].named_parameters(),
                              state["params"].named_parameters()):
        assert torch.equal(a, b), n


# ---- the re-mesh plan -------------------------------------------------------------


@pytest.mark.parametrize("pod", [0, 2, 4])
def test_plan_remesh_equals_the_references(pod):
    for data in (1, 2, 3, 4, 8, 16):
        for model in (1, 2, 4, 8):
            for acc in (1, 2):
                cur, jcur = (MeshPlan(data, model, pod, acc), JaxMeshPlan(data, model, pod, acc))
                assert cur.devices == jcur.devices
                for avail in range(0, cur.devices + 3):
                    got, want = plan_remesh(cur, avail), jax_plan_remesh(jcur, avail)
                    if want is None:
                        assert got is None
                    else:
                        assert (got.data, got.model, got.pod, got.accum_multiplier,
                                got.devices) == (want.data, want.model, want.pod,
                                                 want.accum_multiplier, want.devices)
