#!/usr/bin/env python3
"""Whether a ``gloo`` group takes CUDA tensors directly, on one NVIDIA card.

    python3 scripts/gloo_cuda_probe.py        # from the repository root; one card

The port's transport (``repro_torch/core/com.py``) copies a CUDA tensor
through pinned host memory before a ``gloo`` group sends it on a ring hop,
because PyTorch's table of backends marks gloo's send, receive and
all-gather CPU only (its all-reduce takes CUDA tensors). This probe hands
gloo the CUDA tensors themselves: for each
operation (a ring hop through ``batch_isend_irecv``, ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, and the ``DTensor`` redistributions, which issue
functional collectives: ``Partial`` to ``Shard`` (a reduce-scatter),
``Shard(0)`` to ``Shard(1)`` (an all-to-all), ``Shard`` to ``Replicate`` (an
all-gather) and ``Partial`` to ``Replicate`` (an all-reduce), the last two
also under ``repro_torch.parallel.sharding.GlooDeviceCollectives``, which
routes the all-gather through ``torch.distributed``'s own call) two fresh
ranks on cuda:0 run it once on a tensor drawn from a seed, and the line
says whether it returned, what it raised, or how the rank exited, and
whether the result equals the same operation done through collectives of
CPU tensors (the staged transport's, for the first three). Reports; gates
nothing. Ends with the card's name and power limit. The lines are also
written to chiprun_out/gloo_cuda_probe.jsonl.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

OUT = ROOT / "chiprun_out" / "gloo_cuda_probe.jsonl"
DTENSOR = {"dtensor_partial_to_shard": ("Partial", "Shard0"),
           "dtensor_shard_to_shard": ("Shard0", "Shard1"),
           "dtensor_shard_to_replicate": ("Shard0", "Replicate"),
           "dtensor_partial_to_replicate": ("Partial", "Replicate"),
           "routed_shard_to_replicate": ("Shard0", "Replicate"),
           "routed_partial_to_replicate": ("Partial", "Replicate")}
OPS = ("hop", "all_reduce", "all_gather", "reduce_scatter", "all_to_all") + tuple(DTENSOR)
WORLD = 2


def run_op(rank: int, op: str, workdir: str) -> None:
    """One rank: ``op`` on CUDA tensors handed to gloo directly, then the
    same through the port's staged transport; writes what happened."""
    from repro_torch.core import com

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store_{op}",
                            world_size=WORLD, rank=rank)
    group = dist.group.WORLD
    x = torch.randn(1024, 257, generator=torch.Generator(device="cuda").manual_seed(rank),
                    device="cuda")
    if op not in ("hop", "all_reduce", "all_gather"):
        x = x[:, :256].contiguous()  # even splits of both axes
    line = {"op": op, "rank": rank}
    try:
        if op == "hop":
            out = torch.empty_like(x)
            works = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, (rank + 1) % WORLD),
                                            dist.P2POp(dist.irecv, out, (rank - 1) % WORLD)])
            for w in works:
                w.wait()
            staged = com.hop([(x, 1)], group)[0]
        elif op == "all_reduce":
            out = x.clone()
            dist.all_reduce(out)
            staged = com.all_reduce(x, group)
        elif op == "all_gather":
            out = torch.empty((WORLD * x.shape[0],) + tuple(x.shape[1:]), device="cuda")
            dist.all_gather_into_tensor(out, x)
            out = out.view((WORLD,) + tuple(x.shape))
            staged = com.com_all_gather(x, group)
        elif op == "reduce_scatter":
            out = torch.empty((x.shape[0] // WORLD,) + tuple(x.shape[1:]), device="cuda")
            dist.reduce_scatter_tensor(out, x)
            staged = _on_cpu(lambda c: _reduce_scatter_cpu(c), x)
        elif op == "all_to_all":
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x)
            staged = _on_cpu(lambda c: _all_to_all_cpu(c), x)
        else:
            import contextlib

            from torch.distributed.device_mesh import init_device_mesh
            from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

            from repro_torch.parallel.sharding import GlooDeviceCollectives

            mesh = init_device_mesh("cuda", (WORLD,), mesh_dim_names=("model",))
            cpu_mesh = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("model",))
            kinds = {"Partial": Partial(), "Shard0": Shard(0), "Shard1": Shard(1),
                     "Replicate": Replicate()}
            src, dst = ([kinds[k]] for k in DTENSOR[op])
            routed = GlooDeviceCollectives() if op.startswith("routed") else \
                contextlib.nullcontext()
            with routed:
                out = DTensor.from_local(x, mesh, src, run_check=False).redistribute(
                    mesh, dst).to_local()
            staged = DTensor.from_local(x.cpu(), cpu_mesh, src, run_check=False).redistribute(
                cpu_mesh, dst).to_local().to("cuda")
        torch.cuda.synchronize()
        line.update(returned=True, equal_to_staged=bool(torch.equal(out, staged)),
                    out_device=str(out.device))
    except Exception as e:  # the probe's question is what gloo raises
        line.update(returned=False, raised=f"{type(e).__name__}: {str(e)[:300]}")
    Path(workdir, f"{op}_{rank}.json").write_text(json.dumps(line))
    dist.destroy_process_group()


def _on_cpu(fn, x):
    """``fn`` of ``x`` copied to the host, in the same gloo group, back on the card."""
    return fn(x.cpu()).to("cuda")


def _reduce_scatter_cpu(x):
    out = torch.empty((x.shape[0] // WORLD,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x)
    return out


def _all_to_all_cpu(x):
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("gloo_cuda_probe: no CUDA device is available", file=sys.stderr)
        return 1
    OUT.parent.mkdir(exist_ok=True)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for op in OPS:
            ctx = mp.start_processes(run_op, args=(op, tmp), nprocs=WORLD, join=False,
                                     start_method="spawn")
            deadline = time.monotonic() + 120
            try:
                while not ctx.join(timeout=1.0):
                    if time.monotonic() > deadline:
                        break
                exits = None
            except mp.ProcessExitedException as e:  # a rank died: the probe reports how
                exits = str(e)
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
            ranks = [json.loads(Path(tmp, f"{op}_{r}.json").read_text())
                     if Path(tmp, f"{op}_{r}.json").exists() else None for r in range(WORLD)]
            lines.append({"op": op, "ranks": ranks, "exit": exits,
                          "exitcodes": [p.exitcode for p in ctx.processes],
                          "torch": torch.__version__})
            print(json.dumps(lines[-1]), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    OUT.write_text("".join(json.dumps(ln) + "\n" for ln in lines + [{"card": smi}]))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
