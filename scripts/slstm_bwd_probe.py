#!/usr/bin/env python3
"""The sLSTM backward's design points (csrc/slstm.cu, "the backward") timed on
one NVIDIA card, beside the kernel itself.

    python3 scripts/slstm_bwd_probe.py        # from the repository root; nvcc, one card

Builds the kernels from the sources and this script's scripts/slstm_bwd_probe.cu
(the turned-down designs, which include the kernel's source), and prints, one
JSON line each:

* ptxas's registers, shared memory and spills of every backward kernel and
  probe kernel;
* the step floor, S steps of the exchange and the barrier.cluster alone, at
  xlstm-350m's train shape (B 8, H 4, hd 256): 16-CTA clusters of 8 rows (the
  kernel's), 8-CTA clusters of 8 rows, and groups of 4 rows (8 clusters) of
  8 and 16 CTAs, each through L2 and one multicast copy a CTA's slice to
  mbarriers (multicast, the kernel's), by reading the owners' buffers after
  a barrier.cluster (pull), with an mbarrier flag an owner in place of the
  barrier (flags), by writing every CTA's buffer (push) or sending each
  CTA's slice by the copy engine to mbarriers (bulk); the barrier.cluster
  alone; the
  exchange of a reduce-scatter design (8 KB a CTA);
* the step's product alone (3xTF32 MMAs over 4 hd terms, 8 rows) for the
  register budgets: 16 units a CTA with R's halves in registers (the
  kernel's), and 32 units (8-CTA clusters) with both halves in registers, R
  split again every step, or the small halves in shared memory;
* chip_smoke.py's check_slstm_bwd at the train shape in float32 and
  bfloat16 and at (2, 517, 4, 256): errors over the gates, same bits, graph
  ms, the step floor, resident clusters and waves.

Ends with the card's name and power limit. The lines are also written to
chiprun_out/slstm_bwd_probe.jsonl. A check that fails ends the run with exit
code 1.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.slstm import bwd_step_floor, plan_bwd  # noqa: E402

S, B, H, HD = 2048, 8, 4, 256  # xlstm-350m's train shape
OUT = ROOT / "chiprun_out" / "slstm_bwd_probe.jsonl"
TIME_LIMIT_S = 600
PRODUCTS = {0: "16 units, halves in registers (kernel)", 1: "32 units, halves in registers",
            2: "32 units, split every step", 3: "32 units, small halves in shared memory"}


def emit(obj) -> None:
    cs.emit(obj)
    with OUT.open("a") as f:
        f.write(json.dumps(obj) + "\n")


def build_probe() -> ctypes.CDLL:
    """nvcc of scripts/slstm_bwd_probe.cu with the port's flags; ptxas's log."""
    target = _build.BUILD_DIR / "libslstm_bwd_probe.so"
    target.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(target),
                          str(ROOT / "scripts" / "slstm_bwd_probe.cu")],
                         capture_output=True, text=True)
    if out.returncode != 0:
        cs.fail(f"nvcc failed for slstm_bwd_probe.cu:\n{out.stdout}{out.stderr}")
    emit({"ptxas_probe": cs.ptxas_summary(out.stdout + out.stderr)})
    lib = ctypes.CDLL(str(target))
    lib.probe_floor_push.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.probe_product.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
    lib.probe_floor_rs.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.probe_floor_bulk.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.probe_floor_bulk.restype = ctypes.c_int
    lib.probe_floor_flags.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.probe_floor_pull.argtypes = [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.probe_floor_flags.restype = lib.probe_floor_pull.restype = ctypes.c_int
    lib.probe_floor_push.restype = lib.probe_product.restype = ctypes.c_int
    lib.probe_floor_rs.restype = ctypes.c_int
    return lib


def checked(err: int, what: str) -> None:
    if err != 0:
        cs.fail(f"{what}: CUDA error {err}")


def main() -> None:
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    OUT.parent.mkdir(exist_ok=True)
    OUT.write_text("")
    _build.build(["slstm"], force=True)
    emit({"ptxas": {k: v for k, v in cs.ptxas_summary(_build.ptxas_log["slstm"]).items()
                    if "bwd" in k}})
    lib = build_probe()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    sink = torch.zeros(256, device=dev)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    p = plan_bwd(B, S, H, HD, torch.float32)
    with cs.time_limit(TIME_LIMIT_S, "the slstm_fused_bwd probe"):
        # the step floor: (cluster, m-tiles, rows a group); B 16 at 4 rows is
        # the same 8 rows a head in two groups
        for C, mt, rows in ((16, 1, 8), (8, 2, 8), (8, 2, 4), (16, 1, 4)):
            b = B if rows == 8 else 2 * B
            fp = dataclasses.replace(p, cluster=C, units=16 * mt, m_tiles=mt,
                                     grid=(C, H, -(-b // 8)))
            xbuf = torch.empty(fp.xbuf_floats, device=dev)
            multicast = cs.graph_ms(lambda: bwd_step_floor(fp, S, xbuf, rows=rows), reps=3)
            pull = cs.graph_ms(lambda: checked(lib.probe_floor_pull(
                b, S, H, HD, C, mt, p.k_tiles, rows, stream()), "probe_floor_pull"), reps=3)
            push = cs.graph_ms(lambda: checked(lib.probe_floor_push(
                b, S, H, HD, C, mt, p.k_tiles, rows, stream()), "probe_floor_push"), reps=3)
            bulk = cs.graph_ms(lambda: checked(lib.probe_floor_bulk(
                b, S, H, HD, C, mt, p.k_tiles, rows, stream()), "probe_floor_bulk"), reps=3)
            flags = cs.graph_ms(lambda: checked(lib.probe_floor_flags(
                b, S, H, HD, C, mt, p.k_tiles, rows, stream()), "probe_floor_flags"), reps=3)
            emit({"step_floor": {"cluster": C, "units": 16 * mt, "rows": rows,
                                 "clusters": H * -(-b // 8), "push_us": push * 1e3 / S,
                                 "pull_us": pull * 1e3 / S, "bulk_us": bulk * 1e3 / S,
                                 "flags_us": flags * 1e3 / S,
                                 "multicast_us": multicast * 1e3 / S}})
        for C, mt in ((16, 1), (8, 2)):
            fp = dataclasses.replace(p, cluster=C, units=16 * mt, m_tiles=mt, grid=(C, H, 1))
            alone = cs.graph_ms(lambda: checked(lib.probe_floor_push(
                B, S, H, HD, C, mt, p.k_tiles, 0, stream()), "probe_floor_push"), reps=3)
            rs = cs.graph_ms(lambda: checked(lib.probe_floor_rs(C, H, S, stream()),
                                             "probe_floor_rs"), reps=3)
            emit({"step_floor": {"cluster": C, "barrier_alone_us": alone * 1e3 / S,
                                 "reduce_scatter_push_us": rs * 1e3 / S}})
        for variant, what in PRODUCTS.items():
            ctas = H * (16 if variant == 0 else 8)
            ms = cs.graph_ms(lambda: checked(lib.probe_product(
                variant, ctas, S, sink.data_ptr(), stream()), "probe_product"), reps=3)
            emit({"product": what, "ctas": ctas, "step_us": ms * 1e3 / S})
        gen = torch.Generator(device="cuda").manual_seed(0)
        for dtype in (torch.float32, torch.bfloat16):
            line = cs.check_slstm_bwd(gen, S, dtype, B=B, H=H, hd=HD, one_wave=True)
            emit({k: line[k] for k in ("shape", "dtype", "err_over_limit", "graph_ms",
                                       "kernel_ms", "dr_ms", "step_us", "step_floor_us",
                                       "active_clusters", "waves", "bound_ms")})
        line = cs.check_slstm_bwd(gen, 517, torch.bfloat16, B=2, H=H, hd=HD)
        emit({k: line[k] for k in ("shape", "dtype", "err_over_limit", "graph_ms", "step_us",
                                   "step_floor_us")})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    emit({"card": smi})
    print(smi, flush=True)


if __name__ == "__main__":
    main()
