"""Rank processes for tests/test_torch_collectives.py,
tests/test_torch_model_parallel.py and
tests/test_torch_model_parallel_families.py.

One process a rank, started with the ``spawn`` start method, in a ``gloo``
group of CPU processes whose store is a file under the test's temporary
directory (so that concurrent test workers share no port). A spawned child
re-imports the module of its target: this one, which imports the port,
torch and NumPy, and no JAX.

Each rank function reads its inputs from the work directory, runs the
port's collectives on its slice, and writes what the test compares into
``<name>_<rank>.npz`` (arrays) and ``<name>_<rank>.json`` (counters,
shapes, flags).
"""
import dataclasses
import json
import pickle
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import get_config
from repro_torch.convert import model_params_to_port
from repro_torch.core.com import (com_all_gather, com_matmul_local_bidir, com_reduce_scatter,
                                  counters, make_com_matmul)
from repro_torch.launch.mesh import make_debug_mesh, make_mesh
from repro_torch.models.transformer import CallConfig
from repro_torch.parallel.collectives import axis_mean, grad_transform, matmul_strategy
from repro_torch.parallel.sharding import Sharding
from repro_torch.runtime.elastic import MeshPlan, build_mesh, plan_remesh
from repro_torch.train.grad_compress import compressed_pod_psum
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import make_train_state, make_train_step

# the reduced smollm train step (tests/test_torch_train.py, Adam eps there)
TRAIN_OPT = dict(lr=3e-3, schedule="wsd", warmup_steps=1, total_steps=3, eps=1e-6)
EPILOGUES = {"none": {}, "silu": {"epilogue": "silu"}, "gelu": {"epilogue": "gelu"},
             "bias_res": {"bias": "bias", "residual": "residual"}}


def spawn(fn, world: int, workdir, timeout: float) -> None:
    """Run ``fn(rank, world, workdir)`` in ``world`` spawned processes of
    one gloo group; raises if a rank raises or exits non-zero, and kills
    every rank still running after ``timeout`` seconds."""
    store = Path(workdir) / f"store_{fn.__name__}"
    ctx = mp.start_processes(_main, args=(fn, world, str(workdir), str(store)), nprocs=world,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__} on {world} ranks ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()


def _main(rank: int, fn, world: int, workdir: str, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=world, rank=rank)
    try:
        fn(rank, world, Path(workdir))
    finally:
        dist.destroy_process_group()


def _write(workdir: Path, name: str, rank: int, arrays: dict, info: dict) -> None:
    np.savez(workdir / f"{name}_{rank}.npz", **arrays)
    (workdir / f"{name}_{rank}.json").write_text(json.dumps(info))


def _np(t) -> np.ndarray:
    return t.detach().float().numpy()


def ring_rank(rank: int, world: int, workdir: Path) -> None:
    """8 ranks: the ring, the COM matmul, the strategies, the compressed pod
    mean, a checkpoint of a sharded tree, build_mesh and the refusals."""
    from torch.distributed.device_mesh import init_device_mesh

    inp = {k: torch.from_numpy(v) for k, v in np.load(workdir / "inputs.npz").items()}
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("model",))
    group = mesh.get_group("model")
    me = dist.get_rank(group)
    out, info = {}, {}

    def counted(name, fn):
        counters.reset()
        value = fn()
        info[name] = counters.as_dict()
        return value

    rows = inp["xg"].shape[0] // world
    out["rs"] = counted("rs", lambda: com_reduce_scatter(inp["xg"][me * rows:(me + 1) * rows],
                                                         group))
    rows = inp["xa"].shape[0] // world
    out["ag"] = counted("ag", lambda: com_all_gather(inp["xa"][me * rows:(me + 1) * rows], group))

    com_mm = make_com_matmul(mesh, "model")
    x, w = inp["x"], inp["w"]
    for name, kw in EPILOGUES.items():
        kw = {k: inp[v] if k in ("bias", "residual") else v for k, v in kw.items()}
        y = counted(f"com_{name}", lambda: com_mm(x, w, **kw))
        out[f"com_{name}"] = y.full_tensor()
        out[f"com_{name}_local"] = y.to_local()
    k = x.shape[1] // world
    out["bidir"] = counted("bidir", lambda: com_matmul_local_bidir(
        x[:, me * k:(me + 1) * k], w[me * k:(me + 1) * k], group))
    for strategy in ("psum", "com", "com_bidir"):
        y = counted(strategy, lambda: matmul_strategy(mesh, strategy)(x, w))
        out[strategy] = y.full_tensor()
        info[f"{strategy}_placements"] = [repr(p) for p in y.placements]
    try:
        com_mm(x.to("meta"), w)
    except ValueError:
        info["refuses_other_device"] = True

    # compressed cross-pod mean on (pod=2, data=2, model=2): replicated
    # grads, then grads that differ by pod, then again with the error carried
    mesh3 = make_debug_mesh(2, 2, pod=2, device_type="cpu")
    pod = mesh3.get_local_rank("pod")
    grads = {"a": inp["ga"], "b": inp["gb"]}
    red, err = counted("compress", lambda: compressed_pod_psum(grads, None, mesh3))
    out.update({f"rep_red_{k}": v for k, v in red.items()})
    out.update({f"rep_err_{k}": v for k, v in err.items()})
    by_pod = {k: g + pod * inp[f"d{k}"] for k, g in grads.items()}
    red, err = compressed_pod_psum(by_pod, None, mesh3)
    red2, err2 = compressed_pod_psum(by_pod, err, mesh3)
    for tag, tree in (("pod_red", red), ("pod_err", err), ("pod_red2", red2),
                      ("pod_err2", err2)):
        out.update({f"{tag}_{k}": v for k, v in tree.items()})
    info["pod"] = pod
    same, carry = compressed_pod_psum(grads, "untouched", make_debug_mesh(4, 2, device_type="cpu"))
    info["no_pod_axis_returns_early"] = same is grads and carry == "untouched"

    # a (2, 4) tree saved whole by every rank (host 0's file is restored)
    mesh_a = make_debug_mesh(2, 4, device_type="cpu")
    tree = {"w": Sharding(mesh_a, ("data", "model")).place(torch.arange(64.0).reshape(8, 8))}
    info["saved_local_shape"] = list(tree["w"].to_local().shape)
    ck.save(str(workdir / "ckpt"), 7, tree, host_id=rank)

    info["build_mesh"] = {str(p): list(zip(m.mesh_dim_names, m.shape)) for p, m in (
        (plan, build_mesh(plan, device_type="cpu"))
        for plan in (MeshPlan(data=2, model=4), MeshPlan(data=2, model=2, pod=2)))}
    try:
        make_mesh((2, 2), ("data", "model"), "cpu")
    except ValueError:
        info["refuses_wrong_world"] = True
    _write(workdir, "ring", rank, {k: _np(v) for k, v in out.items()}, info)


def train_rank(rank: int, world: int, workdir: Path) -> None:
    """4 ranks on (pod=2, data=2): reduced smollm's data-parallel train step
    (a row a rank), uncompressed and with the compressed pod mean; then
    the elastic restore of ring_rank's checkpoint onto build_mesh of
    plan_remesh(MeshPlan(2, 4), 4)."""
    with open(workdir / "params.pkl", "rb") as f:
        params = pickle.load(f)
    tokens = np.load(workdir / "batch.npz")["tokens"]
    row = tokens[rank:rank + 1]
    batch = {"tokens": row[:, :-1], "targets": row[:, 1:]}
    mesh = make_debug_mesh(data=2, model=1, pod=2, device_type="cpu")
    cfg = get_config("smollm-135m").reduced()
    out, info = {}, {"pod": mesh.get_local_rank("pod"), "data": mesh.get_local_rank("data")}

    for compress in (False, True):
        tag = "compressed" if compress else "dp"
        model = model_params_to_port(cfg, params, cc=CallConfig(compute_dtype=torch.float32,
                                                                remat="block"), device="cpu")
        ocfg = OptConfig(**TRAIN_OPT)
        transform = grad_transform(mesh, compress_pod=compress)
        seen = {}

        def capture(grads, carry):
            seen["raw"] = grads
            seen["out"] = transform(grads, carry)
            return seen["out"]

        state = make_train_state(model, None, ocfg)
        state, mets = make_train_step(model, ocfg, grad_transform=capture)(state, batch)
        grads = seen["out"][0]
        info[tag] = {"loss": float(mets["loss"]), "grad_norm": float(mets["grad_norm"]),
                 "aux": float(mets["aux"]),
                     "carry": "grad_carry" in state}
        out.update({f"{tag}.{n}": _np(g) for n, g in grads.items()})
        if compress:
            data_mean = axis_mean(seen["raw"], mesh, "data")
            out.update({f"data_mean.{n}": _np(g) for n, g in data_mean.items()})
            out.update({f"error.{n}": _np(e) for n, e in state["grad_carry"].items()})

    plan = plan_remesh(MeshPlan(data=2, model=4), available_devices=world)
    mesh_b = build_mesh(plan, device_type="cpu")
    restored, manifest = ck.restore(str(workdir / "ckpt"), {"w": None},
                                    shardings={"w": Sharding(mesh_b, ("data", "model"))})
    out["restored"] = _np(restored["w"].full_tensor())
    info.update(plan=[plan.data, plan.model, plan.pod, plan.accum_multiplier],
                devices=plan.devices, step=manifest["step"],
                restored_local_shape=list(restored["w"].to_local().shape),
                mesh_b=list(zip(mesh_b.mesh_dim_names, mesh_b.shape)))
    _write(workdir, "train", rank, out, info)


def gpu_com_rank(rank: int, world: int, workdir: Path) -> None:
    """Ranks on cuda:0 in a gloo group (the hops through pinned host
    memory): make_com_matmul in float32 and bfloat16 against the dense
    product on the card, and the counted bytes."""
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_debug_mesh(data=1, model=world, device_type="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    M, K, N = 96, 256, 128
    info = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(K, N, generator=gen, device="cuda") / K ** 0.5).to(dtype)
        counters.reset()
        y = make_com_matmul(mesh, "model")(x, w, epilogue="silu")
        sent = counters.as_dict()
        dense = torch.nn.functional.silu(x.float() @ w.float())
        c = N // world
        want = dense[:, rank * c:(rank + 1) * c]
        local = y.to_local()
        info[str(dtype)] = {"err": ((local.double() - want.double()).abs().max()
                                    / want.double().abs().max()).item(),
                            "device": str(local.device), "dtype": str(local.dtype),
                            "shape": list(local.shape), "sent": sent,
                            "out_bytes": M * N * x.element_size()}
    (workdir / f"gpu_{rank}.json").write_text(json.dumps(info))


# ---- model-parallel training (tests/test_torch_model_parallel.py) ------------------------

MP_MESHES = {"2x4": dict(data=2, model=4), "2x2x2": dict(pod=2, data=2, model=2)}
# the shard_fn cases: logical axes and a shape, under act_rules(job="train")
SHARD_CASES = [(("batch", "seq", "embed"), (4, 8, 16)), (("batch", "seq", "vocab"), (4, 8, 512)),
               (("batch", None, "kv_heads", None), (4, 8, 4, 8)), ((None, "embed"), (6, 16)),
               (("exp_dp", "experts", None), (4, 8, 12))]
# the attention cases: (num_heads, num_kv_heads) at head_dim 32, heads split over
# model=4 and replicated
ATTN_CASES = {"split": (8, 4), "replicated": (4, 2)}
REFUSING = ("zamba2-1.2b", "xlstm-350m")
# the comm-count case: a vocabulary padded to 4,096 (its last 96 logits
# masked), local logits (2, 32, 1024) on (2, 4)
WIDE_VOCAB, WIDE_PADDED = 4000, 4096


def _mesh(name: str):
    return make_debug_mesh(device_type="cpu", **MP_MESHES[name])


def _placed_model(cfg, mesh, params=None, dtype=torch.float32, seed=0, dp_size=1, shard_fn=None):
    """The port's model of ``cfg`` (the reference's ``params`` converted, or
    drawn from ``seed``) placed on ``mesh`` by param_rules, with
    ``shard_fn`` (default make_shard_fn(mesh, act_rules(mesh))) and
    ``dp_size`` moe dispatch groups."""
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel import sharding as sh

    cc = CallConfig(compute_dtype=dtype, remat="block", dp_size=dp_size,
                    shard_fn=shard_fn or sh.make_shard_fn(mesh, sh.act_rules(mesh)))
    model = (model_params_to_port(cfg, params, cc=cc, device="cpu") if params is not None
             else build_model(cfg, cc, device="cpu", seed=seed))
    return sh.place_params(model, mesh)


def _sharded_step(cfg, mesh, params, batch, dtype, out, info, tag, dp_size=1, shard_fn=None):
    """Step 1 of TRAIN_OPT on ``mesh``: the loss, the grad norm, every
    gradient (as the step redistributed it) and updated parameter, gathered."""
    model = _placed_model(cfg, mesh, params, dtype, dp_size=dp_size, shard_fn=shard_fn)
    seen = {}

    def capture(grads, carry):
        seen["grads"] = grads
        return grads, carry

    state = make_train_state(model, None, OptConfig(**TRAIN_OPT))
    state, mets = make_train_step(model, OptConfig(**TRAIN_OPT), grad_transform=capture)(state,
                                                                                         batch)
    info[tag] = {"loss": float(mets["loss"]), "grad_norm": float(mets["grad_norm"]),
                 "aux": float(mets["aux"]),
                 "grad_placements": {n: [repr(p) for p in g.placements]
                                     for n, g in seen["grads"].items()},
                 "param_placements": {n: [repr(p) for p in q.placements]
                                      for n, q in model.named_parameters()}}
    if dtype == torch.float32:
        out.update({f"{tag}.grad.{n}": _np(g.full_tensor()) for n, g in seen["grads"].items()})
        out.update({f"{tag}.param.{n}": _np(q.full_tensor()) for n, q in model.named_parameters()})
    return model, state


def model_parallel_rank(rank: int, world: int, workdir: Path) -> None:
    """8 ranks: reduced smollm's sharded train step on (data=2, model=4) and
    (pod=2, data=2, model=2) in float32 (with the flash calls' local shapes)
    and bfloat16, the collectives of a wide-vocabulary loss, shard_fn's
    placements, attention with heads split and replicated, a sharded train
    state saved and restored, and the refusals."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.kernels import ref
    from repro_torch.models import attention
    from repro_torch.models.transformer import build_model
    from repro_torch.parallel import sharding as sh
    from repro_torch.train.train_step import load_state_tree, state_tree

    with open(workdir / "params.pkl", "rb") as f:
        params = pickle.load(f)
    tokens = np.load(workdir / "batch.npz")["tokens"]
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    cfg = get_config("smollm-135m").reduced()
    out, info = {}, {}

    # the flash calls' local shapes: the plain version is what the CPU runs
    shapes, plain = [], ref.flash_attention_ref

    def recording(q, k, v, **kw):
        shapes.append([list(q.shape), list(k.shape)])
        return plain(q, k, v, **kw)

    for name in MP_MESHES:
        mesh = _mesh(name)
        ref.flash_attention_ref = recording
        try:
            model, state = _sharded_step(cfg, mesh, params, batch, torch.float32, out, info, name)
        finally:
            ref.flash_attention_ref = plain
        info[name]["flash_shapes"] = shapes[:]
        shapes.clear()
        # the same step with DTensor's functional all-gather routed through
        # torch.distributed's own call, as a gloo group of ranks on one card
        # takes it (GlooDeviceCollectives, here on CPU tensors)
        with sh.GlooDeviceCollectives(devices=("cpu",)) as mode:
            routed, _ = _sharded_step(cfg, mesh, params, batch, torch.float32, {}, info,
                                      f"{name}.routed")
        info[name]["routed_calls"] = mode.routed
        info[name]["routed_param_diff"] = max(
            (a.full_tensor() - b.full_tensor()).abs().max().item()
            for a, b in zip(routed.parameters(), model.parameters()))
        _sharded_step(cfg, mesh, params, batch, torch.bfloat16, out, info, f"{name}.bf16")

        # a sharded train state through a checkpoint and back, bitwise
        tree = state_tree(state)
        ck.save(str(workdir / f"ckpt_{name}"), 1, tree, host_id=rank)
        dist.barrier()
        fresh = _placed_model(cfg, mesh, seed=1)
        fresh_state = make_train_state(fresh, None, OptConfig(**TRAIN_OPT))
        restored, _ = ck.restore(str(workdir / f"ckpt_{name}"), state_tree(fresh_state,
                                                                           template=True))
        load_state_tree(fresh_state, restored)
        same = all(torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
                   for a, b in zip(fresh.parameters(), model.parameters()))
        for which in ("m", "v"):
            same = same and all(torch.equal(fresh_state["opt"][which][n].to_local(),
                                            state["opt"][which][n].to_local())
                                for n in state["opt"][which])
        info[name]["restored_bitwise"] = bool(same and int(fresh_state["opt"]["step"]) == 1)
        info[name]["int8_refused"] = _raises(lambda: make_train_state(
            model, None, OptConfig(moment_dtype="int8")), ValueError)

        # shard_fn: the placements of the reference's spec, the values untouched
        shard = sh.make_shard_fn(mesh, sh.act_rules(mesh))
        gen = torch.Generator().manual_seed(3)
        cases = []
        for axes, shape in SHARD_CASES:
            x = torch.randn(shape, generator=gen)
            whole = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
            got = shard(whole, axes)
            again = shard(got.redistribute(mesh, [Shard(len(shape) - 1)] + [Replicate()] * (
                mesh.ndim - 1)), axes)
            cases.append({"placements": [repr(p) for p in got.placements],
                          "bitwise": bool(torch.equal(got.full_tensor(), x)
                                          and torch.equal(again.full_tensor(), x)
                                          and again.placements == got.placements)})
        info[name]["shard_cases"] = cases
        info[name]["plain_refused"] = _raises(lambda: shard(torch.zeros(4, 8, 16),
                                                            ("batch", "seq", "embed")), TypeError)
        del model, state, fresh, fresh_state

    mesh = _mesh("2x4")
    # attention with heads split over model=4 and replicated, against one process
    for case, (H, KVH) in ATTN_CASES.items():
        d, B, S = 32 * H, 4, 16
        gen = torch.Generator().manual_seed(5)
        p = attention.attention_params(gen, d, H, KVH, qkv_bias=True)
        p = {k: v + 0.01 * torch.randn(v.shape, generator=gen) for k, v in p.items()}
        x = torch.randn(B, S, d, generator=gen)
        pos = torch.arange(S)[None, :].expand(B, S)
        want = attention.attention_block(p, x, pos, H, KVH, rope_theta=10000.0)
        rules = sh.param_rules(mesh)
        pp = {k: rules.named(attention.attention_axes(True)[k], tuple(v.shape)).place(v)
              for k, v in p.items()}
        arules = sh.act_rules(mesh)
        xd = sh.batch_shardings(arules, x).place(x)
        posd = sh.batch_shardings(arules, pos).place(pos.contiguous())
        q, k, _ = attention.qkv_project(pp, xd, H, KVH)
        got = attention.attention_block(pp, xd, posd, H, KVH, rope_theta=10000.0)
        out[f"attn.{case}.got"] = _np(got.full_tensor())
        out[f"attn.{case}.want"] = _np(want)
        info[f"attn.{case}"] = {"q_local": list(q.to_local().shape),
                                "k_local": list(k.to_local().shape),
                                "q_placements": [repr(p) for p in q.placements]}

    # the collectives of a wide-vocabulary step: none moves (B, S, V) logits
    wide = dataclasses.replace(cfg, vocab_size=WIDE_VOCAB)
    model = _placed_model(wide, mesh, seed=0)
    model.requires_grad_(True)
    toks = np.random.default_rng(9).integers(1, WIDE_VOCAB, size=(4, 33))
    counter = sh.CommCounter()
    with counter:
        loss, _ = model.loss({"tokens": toks[:, :-1], "targets": toks[:, 1:]})
        torch.autograd.grad(loss, list(model.parameters()))
    one = build_model(wide, CallConfig(compute_dtype=torch.float32), device="cpu", seed=0)
    info["wide"] = {"counts": counter.counts, "loss": float(loss),
                    "one_process_loss": float(one.loss({"tokens": toks[:, :-1],
                                                        "targets": toks[:, 1:]})[0]),
                    "shapes": {k: sorted(map(list, v)) for k, v in counter.shapes.items()}}

    # the families whose model-parallel forward is not ported, and a dense
    # model whose parameters were not placed
    refusals = {}
    for arch in REFUSING:
        rcfg = get_config(arch).reduced()
        m = _placed_model(rcfg, mesh, seed=0)
        refusals[arch] = _raises(lambda: m.loss(_family_batch(rcfg)), ValueError, "Queue 1")
    unplaced = build_model(cfg, CallConfig(shard_fn=sh.make_shard_fn(mesh, sh.act_rules(mesh))),
                           device="cpu")
    refusals["dense unplaced"] = _raises(lambda: unplaced.loss(batch), ValueError, "place_params")
    refusals["serving"] = _raises(lambda: _placed_model(cfg, mesh).forward(batch["tokens"]),
                                  ValueError)
    info["refusals"] = refusals
    if rank == 0:
        _write(workdir, "mp", rank, out, info)
    else:
        _write(workdir, "mp", rank, {k: v for k, v in out.items() if k.startswith("attn")}, info)


# ---- model-parallel training of the audio, vlm and moe families
# (tests/test_torch_model_parallel_families.py) ------------------------------------------

# the reduced cases: (arch, changes); moe_every=2 is set back on llama4 (reduced() drops it)
FAMILY_CASES = {"musicgen": ("musicgen-large", {}), "vlm": ("llama-3.2-vision-90b", {}),
                "dbrx_ep1": ("dbrx-132b", {}), "dbrx_ep2": ("dbrx-132b", {"ep_split": 2}),
                "llama4_every2": ("llama4-maverick-400b-a17b", {"moe_every": 2, "num_layers": 4})}
# the moe dispatch groups of each mesh: the batch's axes' size (2 and 4)
FAMILY_DP = {"2x4": 2, "2x2x2": 4}
FAMILY_ROWS, FAMILY_SEQ = 4, 32
# the logical axes of the moe dispatch's placements (moe_forward's shard_fn calls)
MOE_AXES = (("exp_dp", None, None), ("exp_dp", "experts", None, None),
            (None, "experts_ep", None, None), ("exp_dp", None, None, None))


def family_config(case: str):
    """The reduced config of a FAMILY_CASES case (the port's)."""
    arch, changes = FAMILY_CASES[case]
    cfg = get_config(arch).reduced()
    moe = {k: v for k, v in changes.items() if k in ("ep_split", "moe_every")}
    if moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    if "num_layers" in changes:
        cfg = dataclasses.replace(cfg, num_layers=changes["num_layers"])
    return cfg


def _recording_shard_fn(mesh, seen: list):
    """make_shard_fn(mesh, act_rules(mesh)) that appends each moe dispatch
    placement (its logical axes, the spec and the placements it gave) to ``seen``."""
    from repro_torch.parallel import sharding as sh

    rules = sh.act_rules(mesh)
    base = sh.make_shard_fn(mesh, rules)

    def shard(x, axes):
        y = base(x, axes)
        if tuple(axes) in MOE_AXES:
            seen.append({"axes": list(axes), "spec": [list(e) if isinstance(e, tuple) else e
                                                      for e in rules.spec_for(tuple(axes),
                                                                              tuple(x.shape))],
                         "placements": [repr(p) for p in y.placements],
                         "want": [repr(p) for p in sh.Sharding(mesh, rules.spec_for(
                             tuple(axes), tuple(x.shape))).placements]})
        return y

    shard.mesh, shard.rules = base.mesh, base.rules
    return shard


def _drops(routing: list) -> int:
    return int(sum(int(d) for d in routing))


def families_rank(rank: int, world: int, workdir: Path) -> None:
    """8 ranks: each FAMILY_CASES case's sharded train step on (data=2,
    model=4) and (pod=2, data=2, model=2) in float32 (every flash call's
    local shapes and causality, the moe dispatch's placements and dropped
    choices, one process's beside them) and bfloat16; on (2, 4) the audio
    step's collectives counted, a sharded train state saved and restored,
    and the refusals (zamba2, xlstm, a dp_size the batch's axes do not
    split)."""
    from repro_torch.kernels import ref
    from repro_torch.models import moe as tmoe
    from repro_torch.parallel import sharding as sh

    batches = {k: v for k, v in np.load(workdir / "batches.npz").items()}
    out, info = {}, {}
    shapes, plain = [], ref.flash_attention_ref
    drops = []
    orig_dispatch = tmoe._dispatch_group

    def recording(q, k, v, causal=True, **kw):
        shapes.append([list(q.shape), list(k.shape), bool(causal)])
        return plain(q, k, v, causal=causal, **kw)

    def counting(x, logits, top_k, capacity, num_experts):
        got = orig_dispatch(x, logits, top_k, capacity, num_experts)
        if not _in_backward():  # a checkpointed layer's recompute is not counted
            drops.append((got[1] == num_experts * capacity).sum())
        return got

    for case in FAMILY_CASES:
        cfg = family_config(case)
        with open(workdir / f"params_{case}.pkl", "rb") as f:
            params = pickle.load(f)
        batch = {k.split(".", 1)[1]: v for k, v in batches.items() if k.startswith(case + ".")}
        for name in MP_MESHES:
            mesh = _mesh(name)
            dp = FAMILY_DP[name]
            seen = []
            ref.flash_attention_ref, tmoe._dispatch_group = recording, counting
            try:
                model, state = _sharded_step(cfg, mesh, params, batch, torch.float32, out, info,
                                             f"{case}.{name}", dp_size=dp,
                                             shard_fn=_recording_shard_fn(mesh, seen))
                # each rank dispatches its own groups: the batch's drops summed
                # over the ranks, each group counted once a model rank
                total = torch.tensor(_drops(drops), dtype=torch.float64)
                dist.all_reduce(total)
                sharded_drops = int(total.item()) // mesh.size(mesh.mesh_dim_names.index("model"))
                sharded_flash = shapes[:]
                drops.clear()
                one = model_params_to_port(cfg, params, cc=CallConfig(
                    compute_dtype=torch.float32, dp_size=dp), device="cpu")
                with torch.no_grad():
                    one_loss, one_mets = one.loss(batch)
                one_drops = _drops(drops)
            finally:
                ref.flash_attention_ref, tmoe._dispatch_group = plain, orig_dispatch
            drops.clear()
            line = info[f"{case}.{name}"]
            line.update(flash=sharded_flash, moe_placements=seen, drops=sharded_drops,
                        one_process={"loss": float(one_loss), "aux": float(one_mets["aux"]),
                                     "drops": one_drops})
            shapes.clear()
            _sharded_step(cfg, mesh, params, batch, torch.bfloat16, out, info,
                          f"{case}.{name}.bf16", dp_size=dp)
            if name == "2x4":
                _restore_check(workdir, rank, case, cfg, mesh, model, state, dp, info)
            if case == "musicgen" and name == "2x4":
                counter = sh.CommCounter()
                m = _placed_model(cfg, mesh, params)
                m.requires_grad_(True)
                with counter:
                    loss, _ = m.loss(batch)
                    torch.autograd.grad(loss, list(m.parameters()))
                info["audio_comms"] = {"shapes": {k: sorted(map(list, v))
                                                  for k, v in counter.shapes.items()},
                                       "logits_local": [FAMILY_ROWS // 2, FAMILY_SEQ,
                                                        cfg.num_codebooks, 512 // 4]}
            del model, state
    mesh = _mesh("2x4")
    refusals = {}
    for arch in REFUSING:
        rcfg = get_config(arch).reduced()
        m = _placed_model(rcfg, mesh, seed=0)
        refusals[arch] = _raises(lambda: m.loss(_family_batch(rcfg)), ValueError, "Queue 1")
    dcfg = family_config("dbrx_ep1")
    m = _placed_model(dcfg, mesh, seed=0, dp_size=1)
    refusals["moe dp_size 1"] = _raises(lambda: m.loss(_family_batch(dcfg)), ValueError,
                                        "dp_size")
    info["refusals"] = refusals
    _write(workdir, "families", rank, out if rank == 0 else {}, info)


def _restore_check(workdir, rank, case, cfg, mesh, model, state, dp, info) -> None:
    """A sharded train state saved, restored into a fresh placed model (drawn
    from another seed) and compared bitwise, shard by shard."""
    from repro_torch.train.train_step import load_state_tree, state_tree

    ck.save(str(workdir / f"ckpt_{case}"), 1, state_tree(state), host_id=rank)
    dist.barrier()
    fresh = _placed_model(cfg, mesh, seed=1, dp_size=dp)
    fresh_state = make_train_state(fresh, None, OptConfig(**TRAIN_OPT))
    restored, _ = ck.restore(str(workdir / f"ckpt_{case}"), state_tree(fresh_state, template=True))
    load_state_tree(fresh_state, restored)
    same = all(torch.equal(a.to_local(), b.to_local()) and a.placements == b.placements
               for a, b in zip(fresh.parameters(), model.parameters()))
    for which in ("m", "v"):
        same = same and all(torch.equal(fresh_state["opt"][which][n].to_local(),
                                        state["opt"][which][n].to_local())
                            for n in state["opt"][which])
    info[f"{case}.restored_bitwise"] = bool(same and int(fresh_state["opt"]["step"]) == 1)


def _in_backward() -> bool:
    """Whether autograd's engine is running a backward on this thread (a
    checkpointed layer's recompute)."""
    return torch._C._current_graph_task_id() != -1


def _family_batch(cfg) -> dict:
    """A small train batch of ``cfg``'s family (audio: codebook grids; vlm:
    image embeddings)."""
    shape = (4, 8, cfg.num_codebooks) if cfg.num_codebooks else (4, 8)
    toks = np.random.default_rng(2).integers(1, cfg.vocab_size, size=shape)
    b = {"tokens": toks, "targets": toks}
    if cfg.family == "vlm":
        b["image_embeds"] = np.zeros((4, cfg.num_image_tokens, cfg.d_model), np.float32)
    return b


def _raises(fn, kind, words: str = "") -> bool:
    """Whether ``fn()`` raises ``kind`` with ``words`` in its message."""
    try:
        fn()
    except kind as e:
        return words in str(e)
    return False
