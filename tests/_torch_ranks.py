"""Rank processes for tests/test_torch_collectives.py.

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
