#!/usr/bin/env python3
"""dbrx-132b's training at full width (chip_smoke.py's train-moe cell: 1 of
40 layers, capacity_factor 1.25, bf16 compute on f32 masters, remat
"block", 8 x 2048 tokens a step) under other optimizer settings, on one
NVIDIA card.

    python3 scripts/train_moe_probe.py        # from the repository root; nvcc, one card
    python3 scripts/train_moe_probe.py --variants 3e-3:bf16 3e-3:int8 3e-4:bf16

For each variant (learning rate : moment dtype, the rest of the cell's
OptConfig as chip_smoke.py builds it) runs the cell's TRAIN_STEPS steps from
the same weights and batches and prints one JSON line: each step's loss,
grad norm, load-balance aux and dropped choices, the median ms a step and
the peak memory. Reports; gates nothing. Ends with the card's name and power
limit. The lines are also written to chiprun_out/train_moe_probe.jsonl.
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

OUT = ROOT / "chiprun_out" / "train_moe_probe.jsonl"


def emit(obj) -> None:
    cs.emit(obj)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps(obj) + "\n")


def run(cell, lr: float, moments: str) -> dict:
    """The cell's TRAIN_STEPS steps with OptConfig(lr=lr, moment_dtype=moments)."""
    cell = dataclasses.replace(cell, opt=dict(cell.opt, lr=lr, moment_dtype=moments))
    batches = cs.train_batches(cs.TRAIN_BATCH, cs.TRAIN_STEPS, arch=cell.arch)
    torch.cuda.reset_peak_memory_stats()
    walls, mets = [], []
    with torch.enable_grad(), cs.Routing() as route:
        model, state, step = cs.train_setup(cell)
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, b)
            mets.append(cs.step_metrics(m))
            walls.append(time.perf_counter() - t0)
        del model, state, step
    torch.cuda.empty_cache()
    return {"probe": "train-moe", "lr": lr, "moments": moments,
            "losses": [m[0] for m in mets], "grad_norms": [m[1] for m in mets],
            "aux": [m[2] for m in mets], "dropped_choices": [int(d) for d in route.drops],
            "median_ms_per_step": statistics.median(walls[2:]) * 1e3,
            "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variants", nargs="+", default=["3e-3:bf16", "3e-3:int8", "3e-4:bf16"],
                    help="lr:moment_dtype pairs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_grad_enabled(False)
    _build.build(["flash_attention"], force=True)
    cell = cs.train_cells()[3]
    for v in args.variants:
        lr, moments = v.split(":")
        emit(run(cell, float(lr), moments))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
