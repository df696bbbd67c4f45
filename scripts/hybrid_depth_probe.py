#!/usr/bin/env python3
"""zamba2-1.2b's training at several depths (chip_smoke.py's train-hybrid
cell: bf16 compute on f32 masters, remat "block", the launcher's recipe at
the cell's lr or --lr) on one NVIDIA card: how far the kernel path's held
steps stand from the plain path's and from a float64 attention's, and
whether the recipe trains at that depth on either path.

    python3 scripts/hybrid_depth_probe.py      # from the repository root; nvcc, one card
    python3 scripts/hybrid_depth_probe.py --depths 6 10 --modes forced --runs kernel
    python3 scripts/hybrid_depth_probe.py --lr 3e-3     # the launcher's own lr

For each depth (layers of 38; a group is 6 Mamba2 blocks followed by the
shared block, the rest tail blocks) and each mode prints one JSON line with
chip_smoke.py's held checks of the cell (train_held_checks, without the
resume): CHECK_STEPS steps of CHECK_BATCH x 2048 tokens, float32 and
bfloat16, through the kernels, the plain versions and a float64
attention, "compounded" (each path steps its own parameters) or "forced"
(each step of the kernel and float64 paths from the plain path's
parameters before it); then for each of --runs one line with the
TRAIN_STEPS bfloat16 steps of TRAIN_BATCH x 2048 tokens of the train
phase through that path: each loss and grad norm. Reports; gates
nothing. Ends with the card's name and power limit. The lines are also
written to chiprun_out/hybrid_depth_probe.jsonl.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

OUT = ROOT / "chiprun_out" / "hybrid_depth_probe.jsonl"


def emit(obj) -> None:
    cs.emit(obj)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps(obj) + "\n")


LR = None  # --lr, where given


def cell_at(depth: int, forced: bool):
    """The train-hybrid cell at ``depth`` layers (at LR where given)."""
    cell = next(c for c in cs.train_cells() if c.arch == cs.HYBRID_ARCH)
    cfg = cs.cut(cs.HYBRID_ARCH, dict(num_layers=depth))
    groups = cfg.num_layers // cfg.hybrid_attn_every
    opt = cell.opt if LR is None else dict(cell.opt, lr=LR)
    return dataclasses.replace(cell, config=dict(num_layers=depth), per_step=(2 * groups, groups),
                               forced=forced, opt=opt)


def held(depth: int, mode: str) -> dict:
    """The cell's held checks at ``depth`` in ``mode``, its failures listed."""
    t0 = time.perf_counter()
    with torch.enable_grad():
        out = cs.train_held_checks(cell_at(depth, mode == "forced"))
    out.pop("resume")
    return {"layers": depth, "mode": mode, "lr": cs.train_opt(cell_at(depth, False)).lr,
            "failures": out.pop("_failures"),
            "seconds": time.perf_counter() - t0, **out}


def run(depth: int, path: str) -> dict:
    """The train phase's TRAIN_STEPS steps at ``depth`` through ``path``."""
    cell = cell_at(depth, False)
    batches = cs.train_batches(cs.TRAIN_BATCH, cs.TRAIN_STEPS, arch=cell.arch)
    walls, mets = [], []
    with torch.enable_grad():
        model, state, step = cs.train_setup(cell, torch.bfloat16,
                                            "ref" if path == "plain" else None)
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            mets.append(cs.step_metrics(m))
            walls.append(time.perf_counter() - t0)
        del model, state, step
    torch.cuda.empty_cache()
    return {"layers": depth, "path": path, "lr": cs.train_opt(cell).lr,
            "losses": [m[0] for m in mets],
            "grad_norms": [m[1] for m in mets], "median_ms_per_step": statistics.median(walls) * 1e3}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depths", type=int, nargs="+", default=[6, 8, 10, 12, 14])
    ap.add_argument("--modes", nargs="+", default=["forced", "compounded"],
                    choices=["forced", "compounded"])
    ap.add_argument("--runs", nargs="*", default=["kernel", "plain"], choices=["kernel", "plain"])
    ap.add_argument("--lr", type=float, default=None, help="in place of the cell's lr")
    args = ap.parse_args()
    global LR
    LR = args.lr
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    _build.build(_build.all_kernels())
    for depth in args.depths:
        for mode in args.modes:
            emit(held(depth, mode))
        for path in args.runs:
            emit(run(depth, path))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
