#!/usr/bin/env python3
"""The bfloat16 attention backward (csrc/flash_attention.cu, the wgmma
kernels) at more shapes and input draws than chip_smoke.py checks, on one
NVIDIA card.

    python3 scripts/flash_bwd_probe.py        # from the repository root; nvcc, one card

Builds the kernels from the sources and prints ptxas's registers and spills
of the wgmma kernels and its wgmma warnings. Then, at each shape, the line
of chip_smoke.py's check_flash_bwd (the error of dq, dk and dv over the
bf16 gate of 2e-2 max|plain|, same bits over two calls, graph_ms beside
SDPA's backward in a graph, the bound), followed by each backward kernel's
device time a call (torch.profiler). Ends with the card's name and power
limit. The checks run under chip_smoke.py's time limit; a check that fails
ends the run with exit code 1.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402

# (B, S, H, KVH, hd, causal): the train shape, chip_smoke.py's other four,
# and tests/test_torch_gpu.py's G = 1 and ragged cases; then the train shape
# on two more draws of the inputs. No S = 1: there dq and dk are 0, and the
# gate is relative to max|plain|
TRAIN = (8, 2048, 9, 3, 64, True)
SHAPES = [TRAIN, (2, 517, 9, 3, 64, True), (1, 300, 4, 2, 32, True),
          (1, 1024, 9, 3, 128, True), (1, 517, 9, 3, 64, False), (1, 200, 4, 1, 128, True),
          (1, 2048, 9, 3, 64, True), (2, 130, 6, 3, 64, False), (2, 333, 9, 3, 64, True),
          TRAIN, TRAIN]
TIME_LIMIT_S = 600


def device_ms_by_kernel(fn, reps: int = 5) -> dict:
    """Device time of each backward kernel a call (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if "flash_bwd" in e.key:
            name = re.search(r"flash_bwd_\w+", e.key).group(0)
            t = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
            out[name] = out.get(name, 0.0) + t / 1e3 / reps
    return out


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    cs._build.build(["flash_attention"], force=True)
    log = cs._build.ptxas_log["flash_attention"]
    warnings = {ln.strip() for ln in log.splitlines()
                if "wgmma" in ln.lower() and re.search("warn|serializ", ln.lower())}
    cs.emit({"ptxas": {k: v for k, v in cs.ptxas_summary(log).items() if "wgmma" in k},
             "ptxas_wgmma_warnings": sorted(warnings)})
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    with cs.time_limit(TIME_LIMIT_S, "the flash_attention_bwd probe"):
        for B, S, H, KVH, hd, causal in SHAPES:
            line = cs.check_flash_bwd(gen, S, torch.bfloat16, causal, H=H, KVH=KVH, hd=hd, B=B)
            q, dout = (cs.randn((B, S, H, hd), gen, torch.bfloat16) for _ in range(2))
            k, v = (cs.randn((B, S, KVH, hd), gen, torch.bfloat16) for _ in range(2))
            out, lse = cs.flash_attention(q, k, v, causal=causal, return_lse=True)
            cs.emit({"shape": line["shape"], "causal": causal, "device_ms_by_kernel":
                     device_ms_by_kernel(lambda: cs.flash_attention_bwd(
                         q, k, v, out, lse, dout, causal=causal))})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
