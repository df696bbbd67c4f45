#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Five paths: the compiled VGG-16 executor (phases 3-5), serving smollm-135m
(phases 3, 6 and 7) and serving xlstm-350m (phases 3, 8 and 9), both at their
full published widths, the paper's Tab. IV evaluation and design-space
sweep (phases 10-12), and VGG-16 compiled around faults and from a searched
mapping (phases 13-14). Phases, each printing JSON lines:

1. card      — the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build     — the four CUDA kernels built from src/repro_torch/csrc/*.cu for
               sm_90a, one nvcc each, started together: seconds taken and the
               ptxas -v report;
3. kernels   — each kernel against its plain PyTorch version at every shape the
               main paths give it (the 16 VGG-16 products of a B=8 forward for
               com_matmul, the 13 VGG-16 per-image convolutions for conv2d_com,
               smollm's batch-1 prefill attention at S = 128, 517, 1024, 2048 and
               at every prompt length the serve phase prefills, for
               flash_attention; xlstm-350m's batch-1 prefill recurrence
               (1, S, 4, 1024) with 4 heads of 256 at S = 128, 517, 1024 and at
               every prompt length the xlstm serve phase prefills, for
               slstm_fused) plus the epilogue, stride-2, 5x5, bf16,
               non-causal, head_dim-128, head_dim-32 (the reduced configs'),
               B = 2 and S = 1 cases, slstm_fused at hd 32 (a cluster of
               one) and at hd 512 (the stream path), and an inf and a
               near-overflow operand through com_matmul on its streaming and
               tensor-core paths (com_matmul_ref's infinities, NaNs and finite
               values): errors, kernel, plain and library times (CUDA events),
               and the bound; each line also gives the launch plan it ran
               (the kernels' plan functions); com_matmul, conv2d_com and
               flash_attention lines give bound_3xtf32_ms (three TF32 passes at
               495 TFLOP/s against the bytes at 3.35 TB/s, float32); flash and
               slstm lines give graph_ms, the device time alone (calls replayed
               from a CUDA graph: no host time between launches; for flash also
               SDPA's), and slstm lines the time a step; where a plan splits K
               or the KV range, a second call must return the same bits;
4. e2e       — compile_program(vgg16_imagenet()), random_weights(seed=0), 8 images
               from numpy.random.default_rng(1): the executor's "cuda" backend
               held against its float64 "reference" backend on the card, events
               against event_totals, com_matmul launches per forward, images/s
               and peak memory; then the direct-convolution path (ops.conv2d per
               image and layer, ops.com_matmul for the FC layers) held against
               the same reference;
5. profile   — a torch.profiler window over one forward: device busy time, idle
               share and the kernels by time; fails if a cuBLAS, cuDNN or
               CUTLASS kernel ran in it (every product is the port's own);
6. serve     — smollm-135m (30 layers, d_model 576, 9 heads, 3 KV heads, vocab
               49152, tied), bf16, weights drawn from seed 0: 16 greedy
               requests with prompt lengths from numpy.random.default_rng(2)
               uniform in 128-1024, 64 new tokens each, 8 slots, max_seq 2048,
               through Engine.generate: wall time, tokens/s, median TTFT and
               decode step, peak memory, flash_attention launches (30 per
               prefill); the tokens against Engine.generate_sequential; the
               last-token logits of every request's prefill against the same
               model with the plain attention, in float32 and in bfloat16;
7. profile-serve — a torch.profiler window over one prefill and one decode step;
               fails if a library attention kernel (flash_fwd, fmha,
               efficient_attention, cuDNN) runs in the prefill;
8. serve-xlstm — xlstm-350m (24 layers as 12 [mLSTM, sLSTM] pairs, d_model
               1024, 4 heads of 256, vocab 50304, untied), bf16, weights drawn
               from seed 0, the same 16-request wave as phase 6: the same
               numbers, slstm_fused launches (12 per prefill, each a cluster of
               8 CTAs per head), the tokens
               against generate_sequential; then, on four of the prompts (the
               shortest, the longest, two between: the plain recurrence is a
               loop of ~20 launches a step), the last-token prefill logits
               against the same model with the plain recurrence
               (CallConfig.kernel_backend="ref") in float32, every sLSTM layer
               of those prefills against the plain recurrence on its own
               inputs in float32 and bfloat16, and the bfloat16 logits beside
               the plain version's own rounding noise (reported, not gated:
               see logits_xlstm);
9. profile-serve — the same two windows for xlstm-350m;
10. tab4     — repro_torch.launch.table_iv.run() for the com and minimal_buffer
               dataflows: the com rows within the reference's bands of the
               paper's Tab. IV (CE within 25 %, off-chip under 10 % of the
               power, CE improvement in 1.3-2.6x; tests/test_simulator.py:93-108),
               the rival's under 10 % off-chip and below COM's CE; then
               DominoModel(vgg16-imagenet).functional_forward on the card with
               phase 4's weights and images: its logits bit for bit phase 4's,
               its events the program's, 16 com_matmul launches;
11. comgrid  — COMGridSim in float64 on the card at full VGG-16 width, on the
               first 14x14x512 -> 512 conv (2 x 2 blocks) and on FC0 (25088 ->
               4096, 98 x 16 blocks, 0.82 GB of float64 weights), phase 4's
               weights: within rtol = atol = 1e-10 of reference_conv /
               reference_fc (tests/test_simulator.py:39), events equal to
               conv_events / fc_events; sim and oracle ms;
12. sweep    — smoke_1e6_grid() (1,002,240 scenarios): the cold batch build
               (216 compiles), then the NumPy oracle (full and in chunks of
               65536) and the torch backend on the card (full and chunked, each
               twice), every column within 1e-6 of the oracle
               (tests/test_sweep_backends.py:26), batch-build and backend
               seconds and scenarios/s apart; the oracle against the scalar
               path (DominoModel.evaluate) at 1e-9 on 1,000 sampled scenarios;
13. faults   — compile_program(vgg16_imagenet(), faults=FaultSet.empty()) is
               the pristine program, and its executor gives phase 4's logits
               bit for bit; then FaultSet.sample(0.002, seed=0, n_chips=9 + 6
               spares, cell_rate=0.002) with a dropped block on conv0 and on
               fc0: the degraded placement (validate_fault_allocs), its chips
               and off-chip J per image against the pristine program's, the
               host seconds of the compile and of the weight-fault realization,
               then both executor backends on the one faulted weight list
               (phase 4's weights and images): logits within 2e-5 · max|ref|,
               equal fault_info, events equal to event_totals, 16 com_matmul
               launches, images/s, argmax agreement with the clean logits;
14. search   — search_mapping(vgg16, budget=96, seed=0) with evolve and anneal
               (host seconds, hop-energy ratio to greedy, never above 1), then
               compile_program(mapping="searched") (budget 256); the greedy and
               searched candidates' Tab. IV columns through
               PopulationEvaluator.columns on the card within 1e-6 of NumPy;
               the searched program and a custom-blocked one (the widest
               layer's block_c halved: more tiles) through both backends: the
               same checks as phase 13, "cuda" logits bit for bit phase 4's
               (the im2col path does not read the block partition), reference
               logits within rtol 1e-9, atol 1e-12 of phase 4's
               (tests/test_search.py:290-292);
15. the seconds of each phase, the kernels line, the card line, the result line.

Any failed check exits non-zero before the result line is printed. Finding no
card is a failure. Tolerances: float32 results within 2e-5 of the reference's
largest magnitude, bfloat16 within 2e-2 (tests/test_kernels.py:18-19 and
tests/test_executor.py:87 of the JAX package); flash_attention's bfloat16
output also element by element within one bfloat16 rounding (2^-7 of the
element) plus the float32 tolerance, since it and its plain version each round
one f32 result once. slstm_fused and the xlstm prefill logits in float32: 2e-4
of the largest magnitude, the reference's own tolerance for the recurrence
(tests/test_kernels.py:142), in place of 2e-5; slstm_fused's bfloat16 h also
element by element within one rounding plus 2e-4 of the largest magnitude,
and its final state (float32) within 2e-4, both at the kernel checks' inputs
and at every sLSTM layer of the compared xlstm prefills.
"""
from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.energy import COUNTERPARTS, PAPER_DOMINO  # noqa: E402
from repro_torch.core.executor import _maxpool, random_weights  # noqa: E402
from repro_torch.core.mapping import ConvSpec, vgg16_imagenet  # noqa: E402
from repro_torch.core.program import compile_program  # noqa: E402
from repro_torch.core.simulator import (  # noqa: E402
    COMGridSim, DominoModel, Events, conv_events, fc_events, reference_conv, reference_fc)
from repro_torch.faults import (  # noqa: E402
    BlockFault, FaultSet, apply_weight_faults, degraded_chips, usable_tiles, validate_fault_allocs)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.com_matmul import com_matmul  # noqa: E402
from repro_torch.kernels.com_matmul import plan as com_matmul_plan  # noqa: E402
from repro_torch.kernels.conv2d_com import conv2d_com  # noqa: E402
from repro_torch.kernels.conv2d_com import plan as conv2d_plan  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import plan as flash_plan  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    com_matmul_ref, conv2d_com_ref, flash_attention_ref, slstm_ref)
from repro_torch.kernels.slstm import plan as slstm_plan  # noqa: E402
from repro_torch.kernels.slstm import slstm_fused  # noqa: E402
from repro_torch.models.transformer import CallConfig, build_model  # noqa: E402
from repro_torch.launch import table_iv  # noqa: E402
from repro_torch.launch.sweep import check_against_scalar, smoke_1e6_grid  # noqa: E402
from repro_torch.search import PopulationEvaluator, greedy_candidate, search_mapping  # noqa: E402
from repro_torch.search.cost import timed  # noqa: E402
from repro_torch.serve.engine import Engine, Request  # noqa: E402
from repro_torch.sweep import COLUMNS, build_batch, resolve_network, run_sweep  # noqa: E402

# published H100 SXM peaks (dense): f32 outside the tensor cores, bf16 tensor
# cores, TF32 tensor cores (the 3xTF32 float32 products take three passes), HBM3
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# kernel names of NVIDIA's libraries (cuBLAS, cuDNN, CUTLASS device-level
# GEMMs): none may run in the VGG-16 forward, whose products are the port's own
LIBRARY_KERNEL = re.compile(
    r"cublas|cudnn|cutlass|gemm|gemv|xmma|winograd|implicit_convolve|sm\d\d_|ampere_|hopper_",
    re.IGNORECASE)
# kernel names of PyTorch's fused attention (flash, memory-efficient, cuDNN):
# none may run in the smollm prefill, whose attention is the port's own
LIBRARY_ATTENTION = re.compile(r"flash_fwd|fmha|efficient_attention|mem_eff|cudnn|pytorch_flash",
                               re.IGNORECASE)
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
BF16_ULP = 2.0 ** -7  # a bfloat16 value's spacing, relative to the value, at most
BATCH = 8
# the serve phases: smollm-135m and xlstm-350m, 16 requests, 8 slots
SERVE_ARCH, N_REQUESTS, MAX_NEW, SLOTS, MAX_SEQ = "smollm-135m", 16, 64, 8, 2048
XLSTM_ARCH = "xlstm-350m"
SLSTM_TOL = 2e-4  # float32 tolerance of the recurrence (tests/test_kernels.py:142)
SWEEP_RTOL = 1e-6  # the float64 sweep backend against NumPy (tests/test_sweep_backends.py:26)
FAULT_SPARES = 6  # spare chips past the pristine placement (benchmarks/faults_bench.py's default)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean time of one call, by CUDA events around ``reps`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph and
    replayed, timed by CUDA events, so that no host time sits between the
    launches (``cuda_ms`` of a call shorter than its host path times the
    host)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms


def bound(n_bytes: float, n_ops: float, dtype) -> tuple:
    """Least time on the card (ms) and what sets it: each input read once and
    each output written once at the memory rate, or the operations at the
    peak rate for the type."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return (t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def bound_3xtf32(n_bytes: float, n_ops: float, dtype):
    """The float32 bound of the kernels' own route: three TF32 passes of the
    operations at the TF32 tensor-core peak, against the bytes at the memory
    rate (ms); None for bfloat16, whose bound_ms is already the tensor cores'."""
    if dtype != torch.float32:
        return None
    return max(n_bytes / PEAK_BYTES, 3 * n_ops / PEAK_TF32) * 1e3


def same_bits(fn, got, name, shape) -> bool:
    """A second call of ``fn`` returns ``got`` bit for bit (split-K and
    split-KV combine their slices in a fixed order, with no atomics)."""
    again = fn()
    torch.cuda.synchronize()
    if not torch.equal(again, got):
        fail(f"{name} {shape}: two calls differ (a split launch must be deterministic)")
    return True


def compare(name, shape, dtype, got, want, kernel_ms, plain_ms, library_ms, t_parts, by,
            one_rounding=False, f32_tol=TOL[torch.float32], extra=None):
    """Check ``got`` against ``want`` within ``f32_tol`` (float32) or
    TOL[bfloat16] of max|want|. With ``one_rounding`` (a kernel whose plain
    version computes in f32 and rounds once to bfloat16, as the kernel does)
    each bfloat16 element is also held within one rounding of its own value:
    |got - want| <= 2^-7 |want| plus ``f32_tol`` of max|want|, a limit a
    dropped or doubled term of a sum cannot hide in. ``extra`` is added to
    the line."""
    tol = f32_tol if dtype == torch.float32 else TOL[dtype]
    diff = (got.double() - want.double()).abs()
    err = diff.max().item()
    scale = want.double().abs().max().item()
    line = {
        "kernel": name, "shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
        "max_abs_err": err, "max_rel_err": err / max(scale, 1e-30), "tol": tol,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_parts), "bound_by": by, **(extra or {}),
    }
    per_element = one_rounding and dtype == torch.bfloat16
    if per_element:
        limit = BF16_ULP * want.double().abs() + f32_tol * scale
        line["max_err_over_one_rounding"] = (diff / limit).max().item()
    emit(line)
    if not torch.isfinite(got).all().item():
        fail(f"{name} {shape}: non-finite output")
    if scale == 0.0 or err > tol * scale:
        fail(f"{name} {shape} {dtype}: max_abs_err {err} > {tol} * {scale}")
    if per_element and line["max_err_over_one_rounding"] > 1.0:
        fail(f"{name} {shape} {dtype}: an element is {line['max_err_over_one_rounding']} times "
             f"one bfloat16 rounding of the plain version's away from it")
    return line


def randn(shape, gen, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype).contiguous()


def check_com_matmul(gen, M, K, N, dtype=torch.float32, activation="relu",
                     with_bias=False, with_residual=False):
    x, w = randn((M, K), gen, dtype), randn((K, N), gen, dtype, (2.0 / K) ** 0.5)
    bias = randn((N,), gen, dtype) if with_bias else None
    res = randn((M, N), gen, dtype) if with_residual else None
    kw = dict(bias=bias, activation=activation, residual=res)
    got = com_matmul(x, w, **kw)
    torch.cuda.synchronize()
    want = com_matmul_ref(x, w, **kw)
    es = x.element_size()
    n_bytes = es * (M * K + K * N + M * N + (N if with_bias else 0)
                    + (M * N if with_residual else 0))
    n_ops = 2.0 * M * N * K
    t_parts, by = bound(n_bytes, n_ops, dtype)
    name = "com_matmul" + "".join(
        f"+{p}" for p, on in (("bias", with_bias), (activation, activation),
                              ("residual", with_residual)) if on)
    p = com_matmul_plan(M, N, K, dtype)
    extra = {"plan": dataclasses.asdict(p),
             "bound_3xtf32_ms": bound_3xtf32(n_bytes, n_ops, dtype)}
    if p.splits > 1:
        extra["split_k_same_bits"] = same_bits(lambda: com_matmul(x, w, **kw), got, name,
                                               (M, K, N))
    return compare(
        name, (M, K, N), dtype, got, want,
        cuda_ms(lambda: com_matmul(x, w, **kw)), cuda_ms(lambda: com_matmul_ref(x, w, **kw)),
        cuda_ms(lambda: torch.matmul(x, w)), t_parts, by, extra=extra)


def check_com_matmul_inf(gen, M, dtype):
    """An inf in x and a -inf in w, each meeting an exact 1.0 (whose 3xTF32
    small half is 0), and a near-overflow 3.4028e38: com_matmul must give
    com_matmul_ref's infinities, NaNs and finite values (f32 tolerance of the
    finite part), on the streaming (M <= 32) or tensor-core path."""
    K, N = 96, 40
    x = randn((M, K), gen)
    w = randn((K, N), gen, scale=1e-3)
    w[7, 3] = 1.0
    x[5, 7], x[6, 9], w[11, 20] = float("inf"), 3.4028e38, float("-inf")
    x, w = x.to(dtype), w.to(dtype)
    got = com_matmul(x, w)
    torch.cuda.synchronize()
    want = com_matmul_ref(x, w)
    fin = want.isfinite()
    same = (torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
            and torch.equal(got[got.isinf()], want[want.isinf()]))
    err = (got[fin].double() - want[fin].double()).abs().max().item()
    scale = want[fin].double().abs().max().item()
    line = {"kernel": "com_matmul(inf operand)", "shape": [M, K, N],
            "dtype": str(dtype).replace("torch.", ""), "path": com_matmul_plan(M, N, K, dtype).path,
            "non_finite": int((~fin).sum().item()), "same_non_finite_as_plain": same,
            "finite_max_rel_err": err / scale, "tol": TOL[dtype]}
    emit(line)
    if not same or err > TOL[dtype] * scale:
        fail(f"com_matmul with an inf operand, M = {M} {dtype}: {line}")


def check_conv2d(gen, H, W, C, M, K=3, stride=1, padding=1, dtype=torch.float32):
    x = randn((H, W, C), gen, dtype)
    w = randn((K, K, C, M), gen, dtype, (2.0 / (K * K * C)) ** 0.5)
    kw = dict(stride=stride, padding=padding, activation="relu")
    got = conv2d_com(x, w, **kw)
    torch.cuda.synchronize()
    want = conv2d_com_ref(x, w, **kw)
    Ho, Wo = want.shape[0], want.shape[1]
    xn, wn = x.permute(2, 0, 1)[None].contiguous(), w.permute(3, 2, 0, 1).contiguous()
    n_bytes = x.element_size() * (H * W * C + K * K * C * M + Ho * Wo * M)
    n_ops = 2.0 * Ho * Wo * M * K * K * C
    t_parts, by = bound(n_bytes, n_ops, dtype)
    shape = (H, W, C, M, K, stride, padding)
    p = conv2d_plan(H, W, C, K, M, stride, padding, dtype)
    extra = {"plan": dataclasses.asdict(p),
             "bound_3xtf32_ms": bound_3xtf32(n_bytes, n_ops, dtype)}
    if p.splits > 1:
        extra["split_k_same_bits"] = same_bits(lambda: conv2d_com(x, w, **kw), got,
                                               "conv2d_com", shape)
    return compare(
        "conv2d_com", shape, dtype, got, want,
        cuda_ms(lambda: conv2d_com(x, w, **kw)), cuda_ms(lambda: conv2d_com_ref(x, w, **kw)),
        cuda_ms(lambda: F.conv2d(xn, wn, stride=stride, padding=padding)), t_parts, by,
        extra=extra)


def sdpa(q, k, v, causal):
    """The library yardstick: PyTorch's fused attention on the same inputs
    (never called by the port)."""
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    try:
        out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)
    except TypeError:  # a torch without enable_gqa: repeat the KV heads
        g = q.shape[2] // k.shape[2]
        out = F.scaled_dot_product_attention(qt, kt.repeat_interleave(g, 1),
                                             vt.repeat_interleave(g, 1), is_causal=causal)
    return out.transpose(1, 2)


def check_flash(gen, S, dtype=torch.bfloat16, causal=True, H=9, KVH=3, hd=64, B=1):
    q = randn((B, S, H, hd), gen, dtype)
    k, v = randn((B, S, KVH, hd), gen, dtype), randn((B, S, KVH, hd), gen, dtype)
    got = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = flash_attention_ref(q, k, v, causal=causal)
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    pairs = S * (S + 1) // 2 if causal else S * S  # (q, k) pairs the mask keeps
    n_ops = 4.0 * hd * H * B * pairs
    t_parts, by = bound(n_bytes, n_ops, dtype)
    p = flash_plan(B, S, S, H, KVH, hd, dtype, causal)
    extra = {"plan": dataclasses.asdict(p), "bound_3xtf32_ms": bound_3xtf32(n_bytes, n_ops, dtype),
             "graph_ms": graph_ms(lambda: flash_attention(q, k, v, causal=causal)),
             "library_graph_ms": graph_ms(lambda: sdpa(q, k, v, causal))}
    if p.splits > 1:
        extra["split_kv_same_bits"] = same_bits(lambda: flash_attention(q, k, v, causal=causal),
                                                got, "flash_attention", (B, S, H, KVH, hd))
    return compare(
        "flash_attention" + ("" if causal else "(non-causal)"), (B, S, H, KVH, hd), dtype,
        got, want, cuda_ms(lambda: flash_attention(q, k, v, causal=causal)),
        cuda_ms(lambda: flash_attention_ref(q, k, v, causal=causal)),
        cuda_ms(lambda: sdpa(q, k, v, causal)), t_parts, by, one_rounding=True, extra=extra)


def check_slstm(gen, S, dtype=torch.bfloat16, B=1, H=4, hd=256):
    """slstm_fused against slstm_ref on gate pre-activations of unit scale
    and the reference's R ~ N(0, 1/hd): h and the final (c, n, h, m). The
    plain version is a loop of about 20 launches a step: timed once, on the
    call that gives the comparison."""
    D = H * hd
    gx = randn((B, S, 4, D), gen, dtype)
    rg = randn((4, H, hd, hd), gen, torch.float32, hd ** -0.5)
    p = slstm_plan(B, S, H, hd, dtype)
    def run():
        return slstm_fused(gx, rg, H)

    got, state = run()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    want, want_state = slstm_ref(gx, rg, H)
    end.record()
    torch.cuda.synchronize()
    state_err = {}
    for k, g, w in zip("cnhm", state, want_state):
        scale = w.double().abs().max().item()
        state_err[k] = (g.double() - w.double()).abs().max().item() / max(scale, 1e-30)
    es = gx.element_size()
    # gx read once, h and the final state written once, R read once
    n_bytes = es * (B * S * 4 * D + B * S * D) + 4 * (rg.numel() + 4 * B * H * hd)
    t_parts, by = bound(n_bytes, 2.0 * 4 * hd * hd * H * S * B, torch.float32)
    kernel_ms = cuda_ms(lambda: run()[0])
    line = compare(
        "slstm_fused", (B, S, 4, D), dtype, got, want, kernel_ms, start.elapsed_time(end), None, t_parts, by,
        one_rounding=True, f32_tol=SLSTM_TOL,
        extra={"heads": H, "state_max_rel_err": state_err, "plan": dataclasses.asdict(p),
               "steps": S, "step_us": kernel_ms * 1e3 / S,
               "graph_ms": graph_ms(lambda: run()[0], reps=3)})
    if not all(torch.isfinite(t).all().item() for t in state) or max(state_err.values()) > SLSTM_TOL:
        fail(f"slstm_fused {(B, S, 4, D)} {dtype}: final state off by {state_err} of max|plain| "
             f"(limit {SLSTM_TOL})")
    return line


def summary(lines, repeat: int = 1) -> dict:
    """A kernel's numbers over one run of its path: times summed over the
    path's shapes (``repeat`` runs of each), errors the worst; with the
    3xTF32 bound where every line has one, and the time a step of a
    recurrence."""
    parts = [0.0, 0.0]
    for ln in lines:
        # bound_ms of a line is max(bytes, ops): recover which one it was
        parts[ln["bound_by"] == "operations"] += ln["bound_ms"]
    extra = {}
    if all(ln.get("bound_3xtf32_ms") is not None for ln in lines):
        extra["bound_3xtf32_ms"] = repeat * sum(ln["bound_3xtf32_ms"] for ln in lines)
    for key in ("graph_ms", "library_graph_ms"):  # device time alone (CUDA graph replay)
        if all(key in ln for ln in lines):
            extra[key] = repeat * sum(ln[key] for ln in lines)
    if all("steps" in ln for ln in lines):  # a recurrence: its mean time a step
        extra["step_us"] = 1e3 * sum(ln["kernel_ms"] for ln in lines) / sum(
            ln["steps"] for ln in lines)
    return {
        "max_abs_err": max(ln["max_abs_err"] for ln in lines),
        "ms": repeat * sum(ln["kernel_ms"] for ln in lines),
        "plain_ms": repeat * sum(ln["plain_ms"] for ln in lines),
        "bound_ms": repeat * sum(ln["bound_ms"] for ln in lines),
        "bound_by": "bytes" if parts[0] >= parts[1] else "operations",
        "library_ms": None if any(ln["library_ms"] is None for ln in lines)
        else repeat * sum(ln["library_ms"] for ln in lines),
        **extra,
    }


def ptxas_summary(log: str) -> dict:
    """``ptxas -v`` per kernel instantiation: registers, shared memory and
    spills, keyed by a short name such as ``com_matmul_kernel<float,128,...>``."""
    out, name = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            mangled = entry.group(1)
            # Itanium mangling: the kernel's name is preceded by its length
            end = mangled.find("_kernelI") + len("_kernel")
            base = next((mangled[end - n:end] for n in range(1, end)
                         if mangled[:end - n].endswith(str(n))), mangled)
            dtype = "bfloat16" if "bfloat16" in mangled else "float"
            args = re.findall(r"Li(\d+)E", mangled)
            name = f"{base}<{','.join([dtype] + args)}>"
            out[name] = []
        elif name and ("Used" in line or "spill" in line):
            out[name].append(line.replace("ptxas info    :", "").strip())
    return {k: "; ".join(v) for k, v in out.items()}


def direct_forward(program, weights, images):
    """The direct-convolution path through the port's public kernel entry
    points: ops.conv2d per image and conv layer (ReLU fused), max-pool,
    flatten, ops.com_matmul for the FC layers."""
    feats = []
    for img in images:
        x = img
        for lp, w in zip(program.layer_programs, weights):
            l = lp.layer
            if not isinstance(l, ConvSpec):
                break
            x = ops.conv2d(x, w.view(l.k, l.k, l.c_in, l.c_out), stride=l.stride,
                           padding=l.padding, activation="relu")
            if l.pool_k > 0:
                x = _maxpool(x[None], l.pool_k, l.pool_stride)[0]
        feats.append(x.reshape(-1))
    x = torch.stack(feats)
    for lp, w in zip(program.layer_programs, weights):
        if not isinstance(lp.layer, ConvSpec):
            x = ops.com_matmul(x, w, activation="relu")
    return x


def profile_window(fn, what: str, forbid=None) -> dict:
    """Device busy time, span, idle share and the kernels by time over one
    call of ``fn`` under torch.profiler (``fn`` is run once before, to warm up).
    With ``forbid`` (a pattern), fails if a device kernel's name matches it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        fail(f"the profiler saw no device activity in {what}")
    busy, cur_s, cur_e = 0.0, None, None
    by_name = {}
    for s, e, name in spans:
        by_name[name[:60]] = by_name.get(name[:60], 0.0) + (e - s) / 1e3
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    top = dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:10])
    line = {"device_busy_ms": busy / 1e3, "device_span_ms": span / 1e3,
            "idle_share": 1.0 - busy / span, "host_wall_ms": wall * 1e3,
            "device_kernels": len(spans), "ms_by_kernel": top}
    if forbid is not None:
        found = sorted({name for _, _, name in spans if forbid.search(name)})
        line["library_kernels"] = found
        if found:
            fail(f"{what} ran library kernels: {found}")
    return line


def serve_wave(vocab: int):
    """The serve phase's 16 greedy requests: prompt lengths uniform in
    128-1024 and prompt tokens, both from numpy.random.default_rng(2)."""
    rng = np.random.default_rng(2)
    lengths = rng.integers(128, 1025, size=N_REQUESTS)
    return [Request(prompt=rng.integers(1, vocab, size=int(n)).astype(np.int32),
                    max_new_tokens=MAX_NEW) for n in lengths]


def prefill_logits(model, prompt, dtype, **changes):
    """The last-token logits of one batch-1 prefill of ``prompt`` with the
    model's CallConfig in ``dtype`` and ``changes``."""
    cc = model.cc
    model.cc = dataclasses.replace(cc, compute_dtype=dtype, cache_dtype=dtype, **changes)
    out, _ = model.prefill(prompt[None, :], model.init_cache(1, len(prompt)))
    model.cc = cc
    return out


def rel_err(got, want) -> float:
    """max|got - want| / max|want|, after a finiteness check of ``got``."""
    scale = want.double().abs().max().item()
    if not torch.isfinite(got).all().item() or scale == 0.0:
        fail("non-finite prefill logits, or plain ones all zero")
    return (got.double() - want.double()).abs().max().item() / max(scale, 1e-30)


def logits_kernel_vs_plain(f32_tol: float):
    """The serve phase's logits check: the last-token logits of every
    request's prefill with the kernel (CallConfig.kernel_backend None: the
    card's tensors launch it) against the plain version ("ref"), in float32,
    where the two differ by f32 rounding alone (limit ``f32_tol``), and in
    the served bfloat16 (limit TOL[bf16])."""
    def check(model, reqs) -> dict:
        errs = {}
        for dtype in (torch.float32, torch.bfloat16):
            tol = f32_tol if dtype == torch.float32 else TOL[dtype]
            name = str(dtype).replace("torch.", "")
            errs[name] = [rel_err(prefill_logits(model, r.prompt, dtype),
                                  prefill_logits(model, r.prompt, dtype, kernel_backend="ref"))
                          for r in reqs]
            for r, e in zip(reqs, errs[name]):
                if e > tol:
                    fail(f"{name} prefill logits with the kernel, prompt of {len(r.prompt)}: "
                         f"{e} of max|plain| > {tol}")
        return {"prefill_logits_max_rel_err": errs,
                "prefill_logits_tol": {"float32": f32_tol, "bfloat16": TOL[torch.bfloat16]},
                "prefill_logits_headroom": {k: (f32_tol if k == "float32" else
                                                TOL[torch.bfloat16]) / max(max(v), 1e-30)
                                            for k, v in errs.items()}}
    return check


def slstm_held(kernel_path, worst: dict):
    """``ops.slstm`` that also holds each kernel-path call against slstm_ref
    on the same inputs (real model activations): h element by element within
    one bfloat16 rounding plus SLSTM_TOL of max|plain| (float32: SLSTM_TOL of
    max|plain|), the final state within SLSTM_TOL; the worst ratio of error
    to limit goes to ``worst[dtype]``."""
    def run(gx, rg, num_heads, *, backend=None):
        h, state = kernel_path(gx, rg, num_heads, backend=backend)
        if backend is None:
            want, want_state = slstm_ref(gx, rg, num_heads)
            diff, scale = (h.double() - want.double()).abs(), want.double().abs().max()
            limit = SLSTM_TOL * scale + (BF16_ULP * want.double().abs()
                                         if gx.dtype == torch.bfloat16 else 0.0)
            ratios = [(diff / limit).max().item()] + [
                ((g.double() - w.double()).abs().max() / (SLSTM_TOL * w.double().abs().max()))
                .item() for g, w in zip(state, want_state)]
            name = str(gx.dtype).replace("torch.", "")
            worst[name] = max([worst.get(name, 0.0)] + ratios)
        return h, state
    return run


def slstm_reordered(gx, rg, num_heads, *, backend=None):
    """slstm_ref on the hidden units of each head in reverse order, the
    result put back: the same arithmetic with every recurrent sum taken in
    another order (the plain version's own rounding noise)."""
    hd = gx.shape[-1] // num_heads
    flip = lambda t: t.reshape(*t.shape[:-1], num_heads, hd).flip(-1).reshape(t.shape)  # noqa: E731
    h, state = slstm_ref(flip(gx).contiguous(), rg.flip(-1).flip(-2).contiguous(), num_heads)
    return flip(h), tuple(t.flip(-1) for t in state)


def logits_xlstm(model, reqs) -> dict:
    """xlstm-350m's logits check, on four prompts (the shortest, the longest
    and two between: the plain recurrence is a loop of ~20 launches a step).
    Float32: kernel path against the plain recurrence within SLSTM_TOL,
    decisive. Every sLSTM layer of those kernel-path prefills, in both
    dtypes, is held against the plain recurrence on its own inputs
    (slstm_held). Bfloat16 logits are reported beside the plain version's
    own noise, the plain path against slstm_reordered: 24 layers of bf16
    rounding make any two orders of the f32 sums disagree by several percent
    of max|logit|, so no bf16 logits limit separates a fault from that."""
    order = sorted(range(len(reqs)), key=lambda i: len(reqs[i].prompt))
    picks = [reqs[order[i]] for i in (0, len(order) // 3, 2 * len(order) // 3, len(order) - 1)]
    kernel_path, worst = ops.slstm, {}
    errs, noise = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        errs[name], noise[name] = [], []
        for r in picks:
            ops.slstm = slstm_held(kernel_path, worst)
            got = prefill_logits(model, r.prompt, dtype)
            ops.slstm = kernel_path
            plain = prefill_logits(model, r.prompt, dtype, kernel_backend="ref")
            ops.slstm = slstm_reordered
            reordered = prefill_logits(model, r.prompt, dtype, kernel_backend="ref")
            ops.slstm = kernel_path
            errs[name].append(rel_err(got, plain))
            noise[name].append(rel_err(reordered, plain))
    if max(errs["float32"]) > SLSTM_TOL:
        fail(f"float32 prefill logits with the kernel: {errs['float32']} of max|plain| "
             f"> {SLSTM_TOL}")
    line = {"prefill_logits_prompts": [len(r.prompt) for r in picks],
            "prefill_logits_max_rel_err": errs, "plain_reordered_logits_max_rel_err": noise,
            "prefill_logits_tol": {"float32": SLSTM_TOL, "bfloat16": "reported, not gated"},
            "prefill_logits_headroom": {"float32": SLSTM_TOL / max(max(errs["float32"]), 1e-30)},
            "slstm_layers_worst_err_over_limit": worst}
    if max(worst.values()) > 1.0:
        fail(f"an sLSTM layer of a served prefill is off its plain version: {worst} x the limit")
    return line


def serve(model, cfg, kernel, per_prefill: int, logits_check, phase: str) -> tuple:
    """Serve the wave through Engine.generate and check it: ``per_prefill``
    launches of ``kernel`` a prefill, greedy tokens equal to
    generate_sequential's, and ``logits_check(model, reqs)``, whose fields
    join the phase's line. Returns the line, the kernel's launches in the
    run and the engine."""
    eng = Engine(model, batch=SLOTS, max_seq=MAX_SEQ)
    eng.generate([Request(prompt=np.arange(1, 200, dtype=np.int32), max_new_tokens=4)
                  for _ in range(2)])  # warm-up: the pool, the libraries' first calls
    marks = {"prefill": [], "decode_step": []}

    def timed(name, fn):
        def run(*args, **kwargs):
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()  # the engine reads each result on the host anyway
            marks[name].append((t, time.perf_counter()))
            return out
        return run

    reqs = serve_wave(cfg.vocab_size)
    model.prefill = timed("prefill", model.prefill)
    model.decode_step = timed("decode_step", model.decode_step)
    torch.cuda.reset_peak_memory_stats()
    kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.generate(reqs, seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernel.launches
    peak = torch.cuda.max_memory_allocated()
    del model.prefill, model.decode_step  # back to the class's methods
    stats = eng.last_stats
    n_prompt = sum(len(r.prompt) for r in reqs)
    prefill_s = sum(e - s for s, e in marks["prefill"])
    ttft = [e - t0 for _, e in marks["prefill"]]  # every request arrives at t0
    steps = [(e - s) * 1e3 for s, e in marks["decode_step"]]

    oracle = [Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens) for r in reqs]
    eng.generate_sequential(oracle, seed=0)
    identical = [r.out_tokens for r in reqs] == [r.out_tokens for r in oracle]

    logits = logits_check(model, reqs)

    gen_tokens = stats["generated_tokens"]
    line = {"phase": phase, "arch": cfg.name, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "vocab": cfg.vocab_size, "dtype": str(model.cc.compute_dtype).replace("torch.", ""),
            "requests": len(reqs), "slots": SLOTS, "max_seq": MAX_SEQ,
            "prompt_tokens": n_prompt, "generated_tokens": gen_tokens, "wall_s": wall,
            "generated_tokens_s": gen_tokens / wall, "prefill_tokens_s": n_prompt / prefill_s,
            "prefill_s": prefill_s, "median_ttft_ms": statistics.median(ttft) * 1e3,
            "median_decode_step_ms": statistics.median(steps), "decode_steps": len(steps),
            "occupancy": stats["occupancy"], "prefills": stats["prefills"],
            "peak_mem_gib": peak / 2**30, f"{kernel.__name__}_launches": launches,
            "greedy_identical_to_sequential": identical, **logits}
    emit(line)
    if launches != per_prefill * stats["prefills"]:
        fail(f"serving launched {kernel.__name__} {launches} times for {stats['prefills']} "
             f"prefills, expected {per_prefill} each")
    if stats["prefills"] != len(reqs) or gen_tokens != len(reqs) * MAX_NEW or not all(
            r.done and len(r.out_tokens) == MAX_NEW
            and all(0 <= t < cfg.vocab_size for t in r.out_tokens) for r in reqs):
        fail(f"the wave did not come back whole: {stats}")
    if not identical:
        fail("Engine.generate's greedy tokens differ from generate_sequential's")
    return line, launches, eng


def profile_serve(model, eng, cfg, forbid=None) -> None:
    """Where a prefill's (the wave's first prompt) and an 8-slot decode
    step's device time goes; with ``forbid``, fails if a kernel of that name
    pattern runs in the prefill."""
    prompt = serve_wave(cfg.vocab_size)[0].prompt[None, :]
    one = model.init_cache(1, MAX_SEQ)
    emit({"phase": "profile-serve", "arch": cfg.name, "what": "prefill",
          "prompt_len": prompt.shape[1],
          **profile_window(lambda: model.prefill(prompt, one), "a prefill", forbid=forbid)})
    tok = torch.ones((SLOTS, 1), dtype=torch.long, device="cuda")
    pos = torch.full((SLOTS,), 1000, dtype=torch.long, device="cuda")
    emit({"phase": "profile-serve", "arch": cfg.name, "what": "decode_step", "slots": SLOTS,
          "pos": 1000, **profile_window(lambda: model.decode_step(tok, eng.slots.cache, pos),
                                        "a decode step")})


def close_within(got, want, rtol: float, atol: float) -> tuple:
    """Largest |got - want| and largest |got - want| / (atol + rtol |want|):
    the second is at most 1 where every element is within the tolerance
    (torch.testing.assert_close's rule)."""
    diff = (got - want).abs()
    return diff.max().item(), (diff / (atol + rtol * want.abs())).max().item()


def tab4_phase(weights, images, e2e_logits) -> None:
    """The Tab. IV evaluation through the port's own entry points, and the
    VGG-16 forward through DominoModel.functional_forward on the card."""
    rows = {df: table_iv.run(df) for df in ("com", "minimal_buffer")}
    for df, rs in rows.items():
        imps = [r["ce_improvement"] for r in rs]
        emit({"phase": "tab4", "dataflow": df,
              "ce_improvement": [min(imps), max(imps)],
              "rows": [{k: r[k] for k in ("counterpart", "model", "ours_ce", "paper_ce",
                                          "ours_thr", "paper_thr", "ours_onchip_w",
                                          "ours_offchip_w", "ours_power_w",
                                          "ce_improvement")} for r in rs]})
        for r in rs:
            vals = [v for v in r.values() if isinstance(v, float)]
            if not all(np.isfinite(vals)):
                fail(f"tab4 {df} {r['counterpart']}: a non-finite column")
            # off-chip power stays a small fraction (paper: 0.1%-3%)
            if not r["ours_offchip_w"] < 0.1 * r["ours_power_w"]:
                fail(f"tab4 {df} {r['counterpart']}: off-chip {r['ours_offchip_w']} W is "
                     f"not under 10 % of {r['ours_power_w']} W")
    # the paper's dataflow against its Tab. IV Domino column: CE within 25 %
    # of each published value, the headline CE improvement in 1.3-2.6x
    # (the reference's bands, tests/test_simulator.py:93-108)
    for r in rows["com"]:
        p = PAPER_DOMINO[r["counterpart"]]
        if COUNTERPARTS[r["counterpart"]].model != r["model"] or r["paper_ce"] != p["ce"]:
            fail(f"tab4 row {r['counterpart']} is not the paper's column")
        if abs(r["ours_ce"] - p["ce"]) > 0.25 * p["ce"]:
            fail(f"tab4 com {r['counterpart']}: CE {r['ours_ce']} not within 25 % of {p['ce']}")
    imps = [r["ce_improvement"] for r in rows["com"]]
    if not (min(imps) > 1.3 and max(imps) < 2.6):
        fail(f"tab4 com: CE improvement {min(imps)}-{max(imps)}x outside 1.3-2.6x")
    # the buffer-centric rival on the same silicon scores below COM
    for r, c in zip(rows["minimal_buffer"], rows["com"]):
        if not r["ours_ce"] < c["ours_ce"]:
            fail(f"tab4 minimal_buffer {r['counterpart']}: CE {r['ours_ce']} is not below "
                 f"COM's {c['ours_ce']}")

    model = DominoModel(resolve_network("vgg16-imagenet"))
    com_matmul.launches = conv2d_com.launches = 0
    t0 = time.perf_counter()
    res = model.functional_forward(images, weights)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    bitwise = bool(torch.equal(res.outputs, e2e_logits))
    events_match = dict(res.events) == dict(model.program.event_totals)
    emit({"phase": "tab4-forward", "workload": model.workload.name, "batch": BATCH,
          "device": str(res.outputs.device), "wall_ms": wall * 1e3, "launches": launches,
          "logits_bitwise_equal_e2e": bitwise, "events_match": events_match})
    if res.outputs.device.type != "cuda" or not bitwise:
        fail("DominoModel.functional_forward's logits are not the e2e executor's bit for bit")
    if not events_match:
        fail(f"functional_forward events {res.events} != {dict(model.program.event_totals)}")
    if launches != {"com_matmul": len(model.layers), "conv2d_com": 0}:
        fail(f"functional_forward launched {launches}, expected {len(model.layers)} com_matmul")


def comgrid_phase(program, weights) -> None:
    """COMGridSim in float64 on the card at full VGG-16 width, against the
    float64 oracles at rtol = atol = 1e-10 (tests/test_simulator.py:39)."""
    rng = np.random.default_rng(4)
    conv = next(lp.layer for lp in program.layer_programs
                if isinstance(lp.layer, ConvSpec) and lp.layer.c_in == 512 and lp.layer.h_in == 14)
    fc = next(lp.layer for lp in program.layer_programs if not isinstance(lp.layer, ConvSpec))
    cases = [(conv, rng.normal(size=(conv.h_in, conv.w_in, conv.c_in)), reference_conv,
              conv_events),
             (fc, np.maximum(rng.normal(size=(fc.c_in,)), 0.0), reference_fc, fc_events)]
    for layer, x, oracle, closed_form in cases:
        lp = program.layer_program(layer.name)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim = COMGridSim.from_program(program, layer.name, weights[layer.name])
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        xd = torch.as_tensor(x, device="cuda")
        sim.run(xd)  # warm-up
        sim.ev = Events()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = sim.run(xd)
        torch.cuda.synchronize()
        sim_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = (oracle(xd, sim.w, layer) if isinstance(layer, ConvSpec) else oracle(xd, sim.w))
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        err, over = close_within(got, want, 1e-10, 1e-10)
        events_match = sim.ev == closed_form(layer)
        emit({"phase": "comgrid", "layer": layer.name, "shape": list(sim.w.shape),
              "c_blocks": lp.c_blocks, "m_blocks": lp.m_blocks, "device": str(got.device),
              "dtype": str(got.dtype).replace("torch.", ""),
              "weights_gb": sim.w.numel() * 8 / 1e9, "upload_s": upload_s,
              "sim_ms": sim_s * 1e3, "oracle_ms": oracle_s * 1e3, "max_abs_err": err,
              "max_err_over_tol": over, "rtol": 1e-10, "atol": 1e-10,
              "events_match": events_match})
        if got.device.type != "cuda" or got.dtype != torch.float64:
            fail(f"COMGridSim ran on {got.device} in {got.dtype}, not float64 on the card")
        if not torch.isfinite(got).all().item() or over > 1.0:
            fail(f"COMGridSim {layer.name}: {err} off the oracle ({over} x the tolerance)")
        if not events_match:
            fail(f"COMGridSim {layer.name}: events {sim.ev} != {closed_form(layer)}")
        del sim, got, want
    torch.cuda.empty_cache()


def sweep_phase() -> None:
    """smoke_1e6_grid through the torch backend on the card, full grid and in
    chunks of 65536, against the NumPy oracle on every column at the
    reference's 1e-6, and the NumPy oracle against the scalar path at 1e-9
    on 1,000 sampled scenarios."""
    grid = smoke_1e6_grid()
    n = grid.n_scenarios
    t0 = time.perf_counter()
    build_batch(grid)  # the cold build: 4 networks x 54 architectures compiled
    build_cold_s = time.perf_counter() - t0
    oracle = run_sweep(grid, backend="numpy")
    runs = [("numpy", None, oracle), ("numpy", 65536, run_sweep(grid, backend="numpy",
                                                               chunk_size=65536))]
    for chunk in (None, 65536):
        for _ in range(2):  # the second run is warm
            runs.append(("torch", chunk, run_sweep(grid, chunk_size=chunk)))
    worst = 0.0
    for backend, chunk, r in runs:
        errs = {c: float(np.max(np.abs(r.columns[c] - oracle.columns[c])
                                / np.maximum(np.abs(oracle.columns[c]), 1e-300)))
                for c in COLUMNS}
        backend_s = r.engine_wall_s - r.build_wall_s
        emit({"phase": "sweep", "backend": backend, "chunk_size": chunk, "n_scenarios": n,
              "rows": int(r.columns["ce_tops_w"].shape[0]),
              "engine_wall_s": r.engine_wall_s, "build_wall_s": r.build_wall_s,
              "backend_s": backend_s, "scenarios_per_s": n / max(backend_s, 1e-12),
              "scenarios_per_s_with_build": n / max(r.engine_wall_s, 1e-12),
              "peak_chunk_bytes": r.peak_chunk_bytes,
              "max_rel_err_vs_numpy": max(errs.values()), "rtol": SWEEP_RTOL})
        if any(r.columns[c].shape != (n,) for c in COLUMNS):
            fail(f"sweep {backend} chunk={chunk}: a column does not hold {n} scenarios")
        if max(errs.values()) > SWEEP_RTOL:
            fail(f"sweep {backend} chunk={chunk}: {errs} over {SWEEP_RTOL}")
        if backend == "numpy" and max(errs.values()) != 0.0:
            fail(f"sweep numpy chunk={chunk}: not chunking-invariant ({errs})")
        worst = max(worst, max(errs.values()))
    sample = np.random.default_rng(0).choice(n, size=1000, replace=False)
    t0 = time.perf_counter()
    scalar_err = check_against_scalar(oracle, 1e-9, sample)
    emit({"phase": "sweep-scalar", "sampled": len(sample), "max_rel_err": scalar_err,
          "rtol": 1e-9, "seconds": time.perf_counter() - t0})
    emit({"phase": "sweep-summary", "n_scenarios": n, "build_cold_s": build_cold_s,
          "torch_max_rel_err_vs_numpy": worst, "rtol": SWEEP_RTOL,
          "device": torch.cuda.get_device_name(0)})


def forward_checks(what: str, program, weights, images, **kw) -> tuple:
    """One program's VGG-16 B=8 forward on the card through both executor
    backends: the "cuda" run (counts set to 0 just before it, read just
    after) against the float64 "reference" run within 2e-5 · max|ref|, both
    runs' events against the program's event_totals, 16 com_matmul launches
    and no conv2d_com, equal fault_info. Returns the two executors, the
    "cuda" and "reference" results, the seconds each executor took to build
    (the host's fault realization and the weights' upload) and the line."""
    t0 = time.perf_counter()
    ex = program.executor(weights, **kw)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_ex = program.executor(weights, backend="reference", **kw)
    ref_build_s = time.perf_counter() - t0
    ex.run(images)  # warm-up
    com_matmul.launches = conv2d_com.launches = 0
    res = ex.run(images)
    launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    walls = [ex.run(images).wall_s for _ in range(5)]
    want = ref_ex.run(images)
    out = res.outputs.double()
    err = (out - want.outputs).abs().max().item()
    scale = want.outputs.abs().max().item()
    events_match = res.events == dict(program.event_totals) == want.events
    n_layers = len(program.layer_programs)
    line = {"what": what, "batch": BATCH, "mapping": program.mapping, "n_tiles": program.n_tiles,
            "n_chips": program.n_chips, "images_s": BATCH / statistics.median(walls),
            "wall_ms": [w * 1e3 for w in walls], "executor_build_s": build_s,
            "reference_build_s": ref_build_s, "fault_info": ex.fault_info,
            "logits_max_abs_err": err, "logits_max_rel_err": err / max(scale, 1e-30),
            "tol": TOL[torch.float32], "events_match": events_match, "launches": launches}
    if tuple(out.shape) != (BATCH, program.workload.layers[-1].c_out) or \
            not torch.isfinite(out).all().item():
        fail(f"{what}: logits of shape {tuple(out.shape)} are not finite")
    if scale == 0.0 or err > TOL[torch.float32] * scale:
        fail(f"{what}: logits max_abs_err {err} > {TOL[torch.float32]} * {scale}")
    if not events_match:
        fail(f"{what}: events {res.events} / {want.events} != {dict(program.event_totals)}")
    if launches != {"com_matmul": n_layers, "conv2d_com": 0}:
        fail(f"{what}: the forward launched {launches}, expected {n_layers} com_matmul")
    if ex.fault_info != ref_ex.fault_info:
        fail(f"{what}: fault_info {ex.fault_info} != {ref_ex.fault_info}")
    return ex, ref_ex, res, want, line


def faults_phase(program, weights, images, e2e_logits) -> tuple:
    """VGG-16 compiled and run around a fault set: the empty set is the
    pristine program and gives phase 4's logits bit for bit; a sampled set
    (rate 0.002 on the pristine chips plus faults_bench.py's 6 spares, cell
    rate 0.002, seed 0) with a dropped block on conv0 and on fc0 compiles
    onto a degraded placement and runs through both backends on one faulted
    weight list. Returns the faulted run's com_matmul launches and its
    line."""
    wl = program.workload
    # the sweep's 216 compiles may have evicted phase 4's cache line: compare
    # with the pristine program as the cache holds it now
    pristine = compile_program(wl)
    if compile_program(wl, faults=FaultSet.empty()) is not pristine:
        fail("faults: compile_program(faults=FaultSet.empty()) is not the pristine program")
    empty = pristine.executor(weights, faults=FaultSet.empty())
    empty_bits = bool(torch.equal(empty.run(images).outputs, e2e_logits))
    emit({"phase": "faults", "what": "empty", "same_program": True,
          "fault_info": empty.fault_info, "logits_bitwise_e2e": empty_bits})
    if not empty_bits or empty.fault_info is not None:
        fail("faults: the empty fault set did not give phase 4's logits bit for bit")
    del empty

    fc0 = next(i for i, l in enumerate(wl.layers) if not isinstance(l, ConvSpec))
    fs = FaultSet.sample(0.002, seed=0, n_chips=program.n_chips + FAULT_SPARES,
                         cell_rate=0.002)
    lp = program.layer_programs[fc0]
    fs = dataclasses.replace(fs, dead_blocks=(
        BlockFault(0, 4, 0, 0), BlockFault(fc0, 0, lp.c_blocks // 2, lp.m_blocks // 2)))
    t0 = time.perf_counter()
    pf = compile_program(wl, faults=fs)
    compile_s = time.perf_counter() - t0
    validate_fault_allocs(pf.allocs, pf.arch, fs)
    t0 = time.perf_counter()
    _, info = apply_weight_faults(wl.layers, weights, fs, pf.arch)
    realize_s = time.perf_counter() - t0
    ex, _, res, _, line = forward_checks("faulted", pf, weights, images)
    if info != ex.fault_info or info["n_blocks"] != 2 or info["n_cells"] == 0:
        fail(f"faults: fault_info {ex.fault_info} != the realization's {info}")
    agree = (res.outputs.argmax(-1) == e2e_logits.argmax(-1)).float().mean().item()
    emit({"phase": "faults", **line, "dead_tiles": len(fs.dead_tiles),
          "dead_links": len(fs.dead_links), "dead_chips": len(fs.dead_chips),
          "fleet": fs.n_chips, "pristine_chips": program.n_chips,
          "degraded_chips": degraded_chips(pf.allocs),
          "usable_tiles": [usable_tiles(fs, c) for c in range(fs.n_chips)],
          "crossing_layers": [a.layer.name for a in pf.allocs if a.crosses_chip],
          "pristine_crossing_layers": [a.layer.name for a in program.allocs if a.crosses_chip],
          "offchip_j_img": DominoModel(pf).offchip_energy_img_j(),
          "pristine_offchip_j_img": DominoModel(program).offchip_energy_img_j(),
          "compile_s": compile_s, "realize_s": realize_s,
          "argmax_agreement_with_clean": agree})
    return line["launches"]["com_matmul"], line


def search_phase(program, weights, images, e2e_logits, ref_logits) -> tuple:
    """VGG-16's mapping search on the host (search_bench.py's CI recipe:
    budget 96, seed 0, both engines; then compile_program(mapping=
    "searched"), budget 256), the two candidates' Tab. IV columns through
    the torch sweep backend on the card against NumPy, and the searched
    and a custom-blocked program (fc0's block_c halved) through both
    executor backends. Returns the searched run's com_matmul launches and
    the lines."""
    wl = program.workload
    lines = []
    for engine in ("evolve", "anneal"):
        t0 = time.perf_counter()
        r = search_mapping(wl, budget=96, engine=engine, seed=0)
        lines.append({"phase": "search", "engine": engine, "budget": 96, "seed": 0,
                      "host_s": time.perf_counter() - t0, "evaluations": r.evaluations,
                      "energy_ratio": r.energy_ratio, "improved": r.improved})
        emit(lines[-1])
        if r.cost.hop_energy_pj > r.greedy_cost.hop_energy_pj:
            fail(f"search {engine}: searched hop energy {r.cost.hop_energy_pj} > greedy's")
    t0 = time.perf_counter()
    ps = compile_program(wl, mapping="searched")
    searched_s = time.perf_counter() - t0
    r = search_mapping(wl)
    if ps.candidate != r.candidate or r.cost.hop_energy_pj > r.greedy_cost.hop_energy_pj:
        fail("search: the searched program is not search_mapping's candidate, or costs more")
    greedy = greedy_candidate(wl.layers, program.arch)
    cols = PopulationEvaluator(wl.layers).columns([greedy, ps.candidate])
    oracle = PopulationEvaluator(wl.layers, backend="numpy").columns([greedy, ps.candidate])
    col_ms = 1e3 * min(timed(PopulationEvaluator(wl.layers).columns,
                             [greedy, ps.candidate])[1] for _ in range(3))
    col_err = max(float(np.max(np.abs(cols[c] - oracle[c]) / np.maximum(np.abs(oracle[c]),
                                                                          1e-300)))
                  for c in oracle)
    ex, _, res, want, line = forward_checks("searched", ps, weights, images)
    bits = bool(torch.equal(res.outputs, e2e_logits))
    ref_ok = bool(torch.allclose(want.outputs, ref_logits, rtol=1e-9, atol=1e-12))
    lines.append({"phase": "search", **line, "budget": 256, "compile_searched_s": searched_s,
                  "energy_ratio": r.energy_ratio, "keeps_greedy_blocking":
                  (ps.candidate.block_c, ps.candidate.block_m) == (greedy.block_c,
                                                                   greedy.block_m),
                  "columns_ms_card": col_ms, "columns_max_rel_err_vs_numpy": col_err,
                  "rtol": SWEEP_RTOL, "logits_bitwise_e2e": bits,
                  "reference_logits_within_1e-9_of_e2e_reference": ref_ok})
    emit(lines[-1])
    if col_err > SWEEP_RTOL:
        fail(f"search: PopulationEvaluator.columns on the card {col_err} off NumPy")
    if not bits:
        fail("search: the searched program's cuda logits are not phase 4's bit for bit")
    if not ref_ok:
        fail("search: the searched program's reference logits are not within rtol 1e-9 of "
             "phase 4's")
    launches = line["launches"]["com_matmul"]
    del ex

    i = max(range(len(wl.layers)), key=lambda j: wl.layers[j].c_in)
    bc = list(greedy.block_c)
    bc[i] = max(1, bc[i] // 2)
    custom = dataclasses.replace(greedy, block_c=tuple(bc))
    pc = compile_program(wl, mapping=custom)
    ex, _, res, want, line = forward_checks("custom-blocking", pc, weights, images)
    bits = bool(torch.equal(res.outputs, e2e_logits))
    ref_ok = bool(torch.allclose(want.outputs, ref_logits, rtol=1e-9, atol=1e-12))
    lines.append({"phase": "search", **line, "layer": wl.layers[i].name,
                  "block_c": bc[i], "greedy_n_tiles": program.n_tiles,
                  "logits_bitwise_e2e": bits,
                  "reference_logits_within_1e-9_of_e2e_reference": ref_ok})
    emit(lines[-1])
    if pc.n_tiles <= program.n_tiles:
        fail(f"search: the custom blocking has {pc.n_tiles} tiles, greedy {program.n_tiles}")
    if not bits or not ref_ok:
        fail(f"search: custom-blocked logits: cuda bitwise {bits}, reference within 1e-9 {ref_ok}")
    return launches, lines


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_grad_enabled(False)
    torch.cuda.set_device(0)

    seconds, t_phase = {}, time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        seconds[name] = now - t_phase
        t_phase = now

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # 2. the build: one nvcc per source, all started together
    t0 = time.perf_counter()
    names = _build.all_kernels()
    _build.build(names, force=True)  # from the sources, even if a build is cached
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": list(names),
          "flags": list(_build.NVCC_FLAGS),
          "ptxas": {k: v for n in names for k, v in ptxas_summary(_build.ptxas_log[n]).items()}})
    phase_done("card+build")

    # 3. each kernel against its plain version at the main path's shapes
    program = compile_program(vgg16_imagenet())
    layers = program.workload.layers
    gen = torch.Generator(device="cuda").manual_seed(0)
    gemm_lines = []
    for l in layers:
        if isinstance(l, ConvSpec):
            m, k, n = BATCH * l.h_out * l.w_out, l.k * l.k * l.c_in, l.c_out
        else:
            m, k, n = BATCH, l.c_in, l.c_out
        gemm_lines.append(check_com_matmul(gen, m, k, n))
    for dtype in (torch.float32, torch.bfloat16):
        check_com_matmul(gen, 3001, 1000, 1000, dtype, "gelu", True, True)
    check_com_matmul(gen, 3001, 1000, 1000, torch.float32, "silu", True, True)
    for M in (8, 200):  # the streaming and the tensor-core path
        for dtype in (torch.float32, torch.bfloat16):
            check_com_matmul_inf(gen, M, dtype)
    conv_lines = [check_conv2d(gen, l.h_in, l.w_in, l.c_in, l.c_out, l.k, l.stride, l.padding)
                  for l in layers if isinstance(l, ConvSpec)]
    check_conv2d(gen, 112, 112, 64, 128, 3, 2, 1)
    check_conv2d(gen, 112, 112, 64, 128, 5, 2, 2)
    check_conv2d(gen, 56, 56, 256, 256, 3, 1, 1, torch.bfloat16)
    for S in (128, 517, 1024, 2048):  # smollm's batch-1 prefill attention
        for dtype in (torch.bfloat16, torch.float32):
            check_flash(gen, S, dtype)
    check_flash(gen, 517, causal=False)
    check_flash(gen, 1024, H=9, KVH=3, hd=128)
    for dtype in (torch.bfloat16, torch.float32):  # the reduced configs' hd 32, split
        check_flash(gen, 1100, dtype, H=2, KVH=2, hd=32)
    check_flash(gen, 517, H=4, KVH=2, hd=32, B=2)
    serve_cfg = get_config(SERVE_ARCH)
    flash_lines = [check_flash(gen, len(r.prompt), hd=serve_cfg.head_dim, H=serve_cfg.num_heads,
                               KVH=serve_cfg.num_kv_heads)
                   for r in serve_wave(serve_cfg.vocab_size)]
    xcfg = get_config(XLSTM_ARCH)
    xlstm_shape = dict(H=xcfg.num_heads, hd=xcfg.head_dim)
    for S in (128, 517, 1024):  # xlstm-350m's batch-1 prefill recurrence
        for dtype in (torch.bfloat16, torch.float32):
            check_slstm(gen, S, dtype, **xlstm_shape)
    check_slstm(gen, 77, torch.float32, B=2, **xlstm_shape)
    check_slstm(gen, 1, torch.bfloat16, **xlstm_shape)
    check_slstm(gen, 130, torch.float32, B=2, H=4, hd=32)  # the reduced configs' cluster of 1
    check_slstm(gen, 200, H=1, hd=512)  # the stream path
    slstm_lines = [check_slstm(gen, len(r.prompt), **xlstm_shape)
                   for r in serve_wave(xcfg.vocab_size)]
    phase_done("kernels")

    # 4. end to end: the executor's kernel path against its float64 reference
    weights = random_weights(program, seed=0)
    images = np.random.default_rng(1).normal(size=(BATCH, 224, 224, 3))
    ex = program.executor(weights)
    ref = program.executor(weights, backend="reference").run(images)
    ex.run(images)  # warm-up
    com_matmul.launches = conv2d_com.launches = 0
    res = ex.run(images)
    launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    torch.cuda.reset_peak_memory_stats()
    walls = [ex.run(images).wall_s for _ in range(7)]
    peak = torch.cuda.max_memory_allocated()
    out, want = res.outputs.double(), ref.outputs
    err = (out - want).abs().max().item()
    scale = want.abs().max().item()
    events_match = res.events == dict(program.event_totals) == ref.events
    wall = statistics.median(walls)
    emit({"phase": "e2e", "workload": program.workload.name, "batch": BATCH,
          "images_s": BATCH / wall, "median_wall_ms": wall * 1e3,
          "wall_ms": [w * 1e3 for w in walls], "peak_mem_gib": peak / 2**30,
          "logits_shape": list(out.shape), "logits_max_abs_err": err,
          "logits_max_rel_err": err / max(scale, 1e-30), "tol": TOL[torch.float32],
          "events_match": events_match, "launches": launches})
    if tuple(out.shape) != (BATCH, layers[-1].c_out) or not torch.isfinite(out).all().item():
        fail(f"logits of shape {tuple(out.shape)} are not finite ({BATCH}, {layers[-1].c_out})")
    if scale == 0.0 or err > TOL[torch.float32] * scale:
        fail(f"logits max_abs_err {err} > {TOL[torch.float32]} * {scale}")
    if not events_match:
        fail(f"events {res.events} != event_totals {dict(program.event_totals)}")
    if launches != {"com_matmul": len(layers), "conv2d_com": 0}:
        fail(f"the forward launched {launches}, expected {len(layers)} com_matmul")

    imgs = torch.as_tensor(images, dtype=torch.float32, device="cuda")
    direct_forward(program, ex.weights, imgs[:1])  # warm-up
    com_matmul.launches = conv2d_com.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    direct = direct_forward(program, ex.weights, imgs)
    torch.cuda.synchronize()
    direct_wall = time.perf_counter() - t0
    direct_launches = {"com_matmul": com_matmul.launches, "conv2d_com": conv2d_com.launches}
    n_conv = sum(isinstance(l, ConvSpec) for l in layers)
    derr = (direct.double() - want).abs().max().item()
    emit({"phase": "e2e-direct-conv", "batch": BATCH, "images_s": BATCH / direct_wall,
          "wall_ms": direct_wall * 1e3, "logits_max_abs_err": derr,
          "logits_max_rel_err": derr / max(scale, 1e-30), "launches": direct_launches})
    if derr > TOL[torch.float32] * scale:
        fail(f"direct-conv logits max_abs_err {derr} > {TOL[torch.float32]} * {scale}")
    if direct_launches != {"com_matmul": len(layers) - n_conv, "conv2d_com": BATCH * n_conv}:
        fail(f"the direct-conv path launched {direct_launches}")
    phase_done("e2e")

    # 5. where the forward's device time goes
    emit({"phase": "profile", "workload": program.workload.name, "batch": BATCH,
          **profile_window(lambda: ex.run(images), "the forward", forbid=LIBRARY_KERNEL)})
    del ex, imgs
    phase_done("profile")

    # 6. serving smollm-135m at full width through the flash kernel
    model = build_model(serve_cfg, CallConfig(), device="cuda", seed=0)
    _, flash_launches, eng = serve(model, serve_cfg, flash_attention, serve_cfg.num_layers,
                                   logits_kernel_vs_plain(TOL[torch.float32]),
                                   "serve")
    phase_done("serve")

    # 7. where a prefill's and a decode step's device time goes
    profile_serve(model, eng, serve_cfg, forbid=LIBRARY_ATTENTION)
    del model, eng
    torch.cuda.empty_cache()
    phase_done("profile-serve")

    # 8. serving xlstm-350m at full width through the sLSTM kernel
    xmodel = build_model(xcfg, CallConfig(), device="cuda", seed=0)
    _, slstm_launches, xeng = serve(xmodel, xcfg, slstm_fused, xcfg.num_layers // 2,
                                    logits_xlstm, "serve-xlstm")
    phase_done("serve-xlstm")

    # 9. the same for xlstm-350m
    profile_serve(xmodel, xeng, xcfg)
    phase_done("profile-serve-xlstm")

    del xmodel, xeng
    torch.cuda.empty_cache()

    # 10. the Tab. IV evaluation, and the VGG-16 forward through DominoModel
    tab4_phase(weights, images, res.outputs)
    phase_done("tab4")

    # 11. COMGridSim in float64 on the card at full width
    comgrid_phase(program, weights)
    phase_done("comgrid")

    # 12. the design-space sweep's float64 columns on the card
    sweep_phase()
    phase_done("sweep")

    # 13. VGG-16 compiled and run around a fault set
    faults_phase(program, weights, images, res.outputs)
    phase_done("faults")

    # 14. the mapping search, and the searched and custom-blocked programs
    search_phase(program, weights, images, res.outputs, ref.outputs)
    phase_done("search")

    # 15. the phases' seconds, the kernels line, the card, the result
    emit({"phase": "seconds", **seconds, "total": sum(seconds.values())})
    emit({"kernels": [
        {"name": "com_matmul", "route": "cuda", "source": "src/repro_torch/csrc/com_matmul.cu",
         "replaces": "src/repro/kernels/com_matmul.py:69",
         "launches": launches["com_matmul"], **summary(gemm_lines)},
        {"name": "conv2d_com", "route": "cuda", "source": "src/repro_torch/csrc/conv2d_com.cu",
         "replaces": "src/repro/kernels/conv2d_com.py:61",
         "launches": direct_launches["conv2d_com"], **summary(conv_lines, BATCH)},
        {"name": "flash_attention", "route": "cuda",
         "source": "src/repro_torch/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:64",
         "launches": flash_launches, **summary(flash_lines, serve_cfg.num_layers)},
        {"name": "slstm_fused", "route": "cuda", "source": "src/repro_torch/csrc/slstm.cu",
         "replaces": "src/repro/kernels/slstm.py:70",
         "launches": slstm_launches, **summary(slstm_lines, xcfg.num_layers // 2)},
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
