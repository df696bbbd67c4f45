#!/usr/bin/env python3
"""What paces a musicgen-large train step (chip_smoke.py's train-audio cell,
but all 48 layers unless --layers cuts them: full width, bf16 compute on f32
masters, remat "block", 8 x 2048 frames x 4 codebooks a step), with ``layers.gelu``'s two constants made on
the host (the port's) and on the card (``torch.tensor(..., device=x.device)``
at every call, a host-to-device copy that waits for the stream), on one
NVIDIA card.

    python3 scripts/train_audio_probe.py             # from the repository root; nvcc, one card
    python3 scripts/train_audio_probe.py --layers 12 --steps 3
    python3 scripts/train_audio_probe.py --part held

Builds the cell's model and train state once and takes TRAIN_WARMUP steps,
then runs the variants in the order card, host, host, card: for each, one
step to settle, ``--steps`` timed steps (median ms, tokens/s), one profiled
step (chip_smoke.profile_window: idle share, device busy ms, the host's
synchronizing calls) and one under step_breakdown (the device ms
of the GELU chain, the layernorms, the weight casts and AdamW, forward and
backward). First checks that both variants give the same bits on a
(8, 2048, 8192) bf16 tensor, and in float32. Reports; gates only that.

``--part held``: the cell's float32 held steps through the kernels
(CHECK_STEPS steps of CHECK_BATCH x AUDIO_CHECK_SEQ frames). Each call of the
attention backward kernel is held, as chip_smoke.flash_bwd_f64_held holds it,
against the float64 attention backward on the same inputs
(chip_smoke.attention_bwd_f64), with the plain float32 backward's distance as
the measure of float32's own rounding (chip_smoke.flash_bwd_f64_ratio: passes
at 1 or less). For each call and each of dq, dk, dv: its error over the held
limit (rtol 1e-3, atol 1e-4 of the largest element) against the plain
backward and against the float64 one, the plain's against the float64 one,
the scores' range, lse's and dout's. Then the same ratio for controls that a
sound gate must refuse, each computed on the call's own inputs while the
steps go on with the kernel's own gradients (so every control sees the same
calls): the kernel's backward in bfloat16 (CONTROLS) and the kernel with a
fault planted (lse rounded to bfloat16, a fault that grows with lse; dq 1 %
and 0.3 % high). Reports the worst call of each and whether the gate refuses
it; fails if a control passes.

Starts with the card's name and power limit. The lines are also written to
chiprun_out/train_audio_probe.jsonl.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
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
from repro_torch.kernels.flash_attention import flash_attention_bwd  # noqa: E402
from repro_torch.models import layers as layers_lib  # noqa: E402
from repro_torch.models import transformer as transformer_lib  # noqa: E402
from repro_torch.train import train_step as train_step_lib  # noqa: E402

OUT = ROOT / "chiprun_out" / "train_audio_probe.jsonl"


def emit(obj) -> None:
    cs.emit(obj)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps(obj) + "\n")


def gelu_card_constants(x: torch.Tensor) -> torch.Tensor:
    """layers.gelu with its constants made on ``x``'s device at every call."""
    c = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    s = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    return x * (0.5 * (1 + torch.tanh(s * (x + c * (x * x * x)))))


VARIANTS = {"card": gelu_card_constants, "host": layers_lib.gelu}


# the parts of a train step that step_breakdown times: each function of the
# port its record_function range is wrapped around (module, attribute)
BREAKDOWN_PARTS = {"gelu": (layers_lib, "gelu"), "layernorm": (layers_lib, "layernorm"),
                   "adamw": (train_step_lib, "adamw_update")}
BACKWARD_NODE = "autograd::engine::evaluate_function: "
# a range around each checkpointed call of forward_train, so that a layer's
# recompute, which runs inside the backward node that first needs one of its
# tensors, counts as forward work
LAYER_RANGE = "checkpointed_layer"


@contextlib.contextmanager
def profiled_parts():
    """Each BREAKDOWN_PARTS function, and each function the train forward
    checkpoints (LAYER_RANGE), wrapped in a torch.profiler record_function
    range of its name while the block runs."""
    from torch.profiler import record_function

    def wrap(name, fn):
        def tagged(*args, **kw):
            with record_function(name):
                return fn(*args, **kw)
        return tagged

    ckpt = transformer_lib.checkpoint
    originals = {name: getattr(mod, attr) for name, (mod, attr) in BREAKDOWN_PARTS.items()}
    for name, (mod, attr) in BREAKDOWN_PARTS.items():
        setattr(mod, attr, wrap(name, originals[name]))
    transformer_lib.checkpoint = lambda fn, *a, **kw: ckpt(wrap(LAYER_RANGE, fn), *a, **kw)
    try:
        yield
    finally:
        for name, (mod, attr) in BREAKDOWN_PARTS.items():
            setattr(mod, attr, originals[name])
        transformer_lib.checkpoint = ckpt


def part_of(e, weight_shapes: set, forward: dict):
    """The (part, "forward" | "backward") an op event of a step_breakdown
    trace belongs to, or None. The part is the innermost BREAKDOWN_PARTS
    range or weight cast (``aten::_to_copy`` of a tensor of a parameter's
    shape) around the op; else, for an op of an autograd node, the part of
    the forward op that made the node (``forward``: (thread, sequence
    number) -> part). The direction is "backward" inside an autograd node
    and outside a layer's recompute, else "forward" (AdamW's too)."""
    part = None
    while e is not None:
        if part is None:
            if e.name in BREAKDOWN_PARTS:
                part = e.name
            elif e.name == "aten::_to_copy" and e.input_shapes and \
                    tuple(e.input_shapes[0]) in weight_shapes:
                part = "weight_casts"
        if e.name == LAYER_RANGE:
            break
        if e.name.startswith(BACKWARD_NODE):
            if part is None:
                node = e.name[len(BACKWARD_NODE):]  # the node's own range: its sequence number
                part = next((forward.get((c.fwd_thread, c.sequence_nr))
                             for c in e.cpu_children if c.name == node), None)
            return None if part is None else (part, "backward")
        e = e.cpu_parent
    return None if part is None else (part, "forward")


def step_breakdown(fn, model) -> dict:
    """One call of ``fn`` (a train step) under torch.profiler with input
    shapes recorded and profiled_parts: the device ms of the GELU chain,
    the layernorms, the weight casts (float32 masters cast to the compute
    dtype, and their backward) and AdamW, forward (the recompute under
    remat included) and backward apart, beside the step's device ms in
    all. Recording shapes costs host time, so the idle share and the
    host's synchronizing calls are profile_window's, not this window's."""
    from torch.profiler import ProfilerActivity, profile

    weight_shapes = {tuple(p.shape) for p in model.parameters() if p.dim() > 1}
    torch.cuda.synchronize()
    with profiled_parts(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                   record_shapes=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]
    forward = {}
    for e in events:
        part = part_of(e, weight_shapes, {})
        if part is not None and part[1] == "forward" and e.sequence_nr >= 0:
            forward.setdefault((e.thread, e.sequence_nr), part[0])
    ms = {name: {"forward": 0.0, "backward": 0.0}
          for name in (*BREAKDOWN_PARTS, "weight_casts")}
    total = 0.0
    for e in events:
        kernel_ms = sum(k.duration for k in e.kernels) / 1e3
        if not kernel_ms:
            continue
        total += kernel_ms
        part = part_of(e, weight_shapes, forward)
        if part is not None:
            ms[part[0]][part[1]] += kernel_ms
    return {"device_ms": total, "ms_by_part": ms,
            "parts_share": sum(a + b for a, b in (d.values() for d in ms.values())) / total
            if total else None}


def same_bits() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((8, 2048, 8192), generator=gen, device="cuda").to(dtype) * 3
        out[str(dtype).replace("torch.", "")] = torch.equal(
            gelu_card_constants(x), VARIANTS["host"](x))
    return out


def bf16_backward(q, k, v, out, lse, dout, **kw):
    """The kernel's backward on the inputs rounded to bfloat16 (lse float32),
    its gradients taken back to float32."""
    got = flash_attention_bwd(*(t.bfloat16() for t in (q, k, v, out)), lse, dout.bfloat16(),
                              **kw)
    return tuple(g.float() for g in got)


# controls of the float64 hold: each maps (the call's inputs, the kernel's
# gradients) to gradients a sound gate must refuse
CONTROLS = {
    "bf16 backward": lambda args, kw, got: bf16_backward(*args, **kw),
    "lse rounded to bf16": lambda args, kw, got: flash_attention_bwd(
        *args[:4], args[4].bfloat16().float(), args[5], **kw),
    "dq 1 % high": lambda args, kw, got: (got[0] * 1.01, *got[1:]),
    "dq 0.3 % high": lambda args, kw, got: (got[0] * 1.003, *got[1:]),
}


def held_part(cell) -> None:
    """The float32 held steps through the kernels, every backward call held
    against the float64 backward as chip_smoke holds it, and the controls
    (see the module docstring)."""
    calls = []
    worst = {name: {"ratio": -1.0} for name in ("kernel", *CONTROLS)}
    original = cs.ops._flash_attention_bwd
    step_no = [0]

    def readings(got, want, w64):
        """Per tensor: error over the held limit against the plain backward
        and against the float64 one, the plain's against the float64 one."""
        return {name: dict(zip(("over_limit_vs_plain", "over_limit_vs_f64",
                                "plain_over_limit_vs_f64"), r))
                for name, *r in zip(("dq", "dk", "dv"), cs.grad_over_limit(got, want),
                                    cs.grad_over_limit(got, w64), cs.grad_over_limit(want, w64))}

    def run(q, k, v, out, lse, dout, *, causal=True, block_kv=None):
        args, kw = (q, k, v, out, lse, dout), dict(causal=causal, block_kv=block_kv)
        got = original(*args, **kw)
        want = cs.flash_attention_bwd_ref(q, k, v, out, lse, dout, causal=causal)
        w64 = cs.attention_bwd_f64(q, k, v, dout, causal=causal)
        s = torch.einsum("bqhd,bshd->bhqs", q.double(), k.double().repeat_interleave(
            q.shape[2] // k.shape[2], dim=2)) / math.sqrt(q.shape[-1])
        s = s.masked_fill(torch.ones_like(s[0, 0], dtype=torch.bool).triu(1), float("nan"))
        line = {"step": step_no[0], "call": len([c for c in calls if c["step"] == step_no[0]]),
                "scores_min": s.nan_to_num(float("inf")).min().item(),
                "scores_max": s.nan_to_num(float("-inf")).max().item(),
                "lse_min": lse.min().item(), "lse_max": lse.max().item(),
                "dout_max": dout.abs().max().item(), "out_max": out.abs().max().item(),
                **readings(got, want, w64),
                "gate": {"kernel": cs.flash_bwd_f64_ratio(got, want, w64),
                         **{name: cs.flash_bwd_f64_ratio(control(args, kw, got), want, w64)
                            for name, control in CONTROLS.items()}}}
        calls.append(line)
        for name, ratio in line["gate"].items():
            if ratio > worst[name]["ratio"]:
                worst[name].update(ratio=ratio, step=line["step"], call=line["call"],
                                   lse_max=line["lse_max"])
        return got

    checks = cs.train_batches(cs.CHECK_BATCH, cs.CHECK_STEPS, arch=cell.arch, seq=cell.check_seq)
    cs.ops._flash_attention_bwd = run
    try:
        with torch.enable_grad():
            model, state, step = cs.train_setup(cell, torch.float32)
            for b in checks:
                step_no[0] += 1
                state, m = step(state, b)
                emit({"probe": "held_step", "step": step_no[0], "loss": float(m["loss"]),
                      "grad_norm": float(m["grad_norm"])})
            del model, state, step
    finally:
        cs.ops._flash_attention_bwd = original
    for line in calls:
        emit({"probe": "held_bwd_call", **line})
    # per control, the share of calls the gate refuses, step by step
    refused = {name: {s: sum(c["gate"][name] > 1.0 for c in calls if c["step"] == s)
                      / max(1, sum(c["step"] == s for c in calls))
                      for s in range(1, cs.CHECK_STEPS + 1)} for name in worst}
    emit({"probe": "held_bwd_gate", "calls": len(calls), "factor": cs.F32_BWD_VS_PLAIN,
          "worst": worst, "refused_share_by_step": refused,
          "kernel_over_limit_vs_plain": max(max(c[g]["over_limit_vs_plain"]
                                                for g in ("dq", "dk", "dv")) for c in calls)})
    if worst["kernel"]["ratio"] > 1.0:
        cs.fail(f"the kernel fails its float64 hold: {worst['kernel']}")
    passed = [name for name in CONTROLS if worst[name]["ratio"] <= 1.0]
    if passed:
        cs.fail(f"controls the float64 hold lets through: {passed}")


def gelu_part(cell, steps: int) -> None:
    """The two gelu variants' steps, in the order card, host, host, card (see
    the module docstring)."""
    bits = same_bits()
    emit({"probe": "gelu_same_bits", **bits})
    if not all(bits.values()):
        cs.fail(f"gelu's two constant placements differ: {bits}")
    per_variant = 1 + steps + 2 + 1  # settle, timed, profile_window (2), breakdown
    order = ("card", "host", "host", "card")
    batches = cs.train_batches(cs.TRAIN_BATCH, cs.TRAIN_WARMUP + per_variant * len(order),
                               arch=cell.arch)
    it = iter(batches)
    tokens = cs.TRAIN_BATCH * cs.TRAIN_SEQ
    original = layers_lib.gelu
    with torch.enable_grad():
        model, state, step = cs.train_setup(cell)

        def one_step():
            nonlocal state
            state, m = step(state, next(it))
            return m

        for _ in range(cs.TRAIN_WARMUP):
            one_step()
        try:
            for name in order:
                layers_lib.gelu = VARIANTS[name]
                one_step()
                walls = []
                for _ in range(steps):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    m = one_step()
                    torch.cuda.synchronize()
                    walls.append(time.perf_counter() - t0)
                prof = cs.profile_window(one_step, "a train step", forbid=cell.forbid)
                parts = step_breakdown(one_step, model)
                ms = statistics.median(walls) * 1e3
                emit({"probe": "train_audio_step", "gelu_constants": name,
                      "layers": model.cfg.num_layers, "tokens_per_step": tokens,
                      "median_ms_per_step": ms, "tokens_s": tokens / ms * 1e3,
                      "ms_per_step": [w * 1e3 for w in walls], "loss": float(m["loss"]),
                      "profile": prof, "step_breakdown": parts})
        finally:
            layers_lib.gelu = original


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=None, help="cut the depth (default: whole)")
    ap.add_argument("--steps", type=int, default=4, help="timed steps a variant")
    ap.add_argument("--part", choices=("gelu", "held"), default="gelu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        cs.fail("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.unlink(missing_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    emit({"probe": "card", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0)})
    _build.build(_build.all_kernels())
    cell = next(c for c in cs.train_cells() if c.phase == "train-audio")
    # the whole model unless --layers cuts it (chip_smoke.py's cell trains 6 layers)
    cell = dataclasses.replace(cell, config={} if args.layers is None
                               else dict(num_layers=args.layers))
    if args.part == "held":
        held_part(cell)
    else:
        gelu_part(cell, args.steps)


if __name__ == "__main__":
    main()
