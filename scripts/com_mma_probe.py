#!/usr/bin/env python3
"""Two measurements behind the design of csrc/com_mma.cuh, on one NVIDIA card.

    python3 scripts/com_mma_probe.py     # from the repository root; nvcc, one card

1. ceiling — the rate of mma.sync alone (TF32 m16n8k8 and bf16 m16n8k16,
   operands in registers, 8 independent accumulators a warp, 2 blocks an
   SM): what the tensor-core route of com_matmul and conv2d_com can reach
   without wgmma. A 3xTF32 product runs at a third of the TF32 figure.
2. promotion — com_matmul built as shipped and built with -DCOM_PROMOTE=0
   (the MMA accumulator never promoted into the f32 register sum): the
   error of a K = 4608 float32 product of post-ReLU activations against
   float64, and of the VGG-16 B = 8 executor's logits against its float64
   reference backend (limit 2e-5 of max|ref|, tests/test_executor.py:87).

Prints one JSON line a measurement, then the card's name and power limit.
Builds go to build/ (listed in .gitignore).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CEILING_CU = r"""
#include <cstdio>
#include <stdint.h>
template <int TF32>
__global__ void peak(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2, threadIdx.x + 3};
  uint32_t b[2] = {threadIdx.x * 3u, threadIdx.x * 5u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
                     : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
                     : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) for (int c = 0; c < 4; ++c) s += acc[j][c];
  if (s == 12345.f) out[threadIdx.x] = s;  // keeps the loop alive
}
int main() {
  float* out;
  cudaMalloc(&out, 4096);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4000, blocks = 2 * 132, warps = 8;
  for (int tf = 1; tf >= 0; --tf)
    for (int rep = 0; rep < 2; ++rep) {  // the first launch warms up
      cudaEventRecord(e0);
      if (tf) peak<1><<<blocks, warps * 32>>>(out, iters);
      else peak<0><<<blocks, warps * 32>>>(out, iters);
      cudaEventRecord(e1);
      cudaEventSynchronize(e1);
      float ms;
      cudaEventElapsedTime(&ms, e0, e1);
      const double flop = 2.0 * blocks * warps * iters * 8 * 16 * 8 * (tf ? 8 : 16);
      if (rep) printf("{\"ceiling\": \"%s\", \"tflops\": %.1f}\n",
                      tf ? "mma.sync tf32 m16n8k8" : "mma.sync bf16 m16n8k16", flop / ms / 1e9);
    }
  return 0;
}
"""


def promotion(promote: bool) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.executor import random_weights
    from repro_torch.core.mapping import vgg16_imagenet
    from repro_torch.core.program import compile_program
    from repro_torch.kernels import _build
    from repro_torch.kernels.com_matmul import com_matmul

    if not promote:
        _build.NVCC_FLAGS = _build.NVCC_FLAGS + ("-DCOM_PROMOTE=0",)
    _build.build(["com_matmul"], force=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1568, 4608), generator=gen, device="cuda").relu()
    w = torch.randn((4608, 512), generator=gen, device="cuda") * (2 / 4608) ** 0.5
    want = x.double() @ w.double()
    k_err = ((com_matmul(x, w).double() - want).abs().max() / want.abs().max()).item()
    program = compile_program(vgg16_imagenet())
    weights = random_weights(program, seed=0)
    images = np.random.default_rng(1).normal(size=(8, 224, 224, 3))
    ref = program.executor(weights, backend="reference").run(images).outputs
    out = program.executor(weights).run(images).outputs.double()
    return {"promote": promote, "k4608_rel_err": k_err,
            "vgg16_logits_rel_err": ((out - ref).abs().max() / ref.abs().max()).item()}


def main() -> None:
    if len(sys.argv) == 2:  # one promotion build, in its own process
        print(json.dumps(promotion(sys.argv[1] == "1")), flush=True)
        return
    build = ROOT / "build"
    build.mkdir(exist_ok=True)
    (build / "mma_ceiling.cu").write_text(CEILING_CU)
    from repro_torch.kernels import _build

    subprocess.run([_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-o",
                    str(build / "mma_ceiling"), str(build / "mma_ceiling.cu")], check=True)
    print(subprocess.run([str(build / "mma_ceiling")], check=True, capture_output=True,
                         text=True).stdout, end="", flush=True)
    for promote in ("1", "0"):
        print(subprocess.run([sys.executable, __file__, promote], check=True, capture_output=True,
                             text=True).stdout, end="", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
