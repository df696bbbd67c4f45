#!/usr/bin/env python3
"""Where the bfloat16 gradient of xlstm-350m through the sLSTM kernels
parts from the plain path's, and whether the kernels or the model's own
conditioning part them, on one NVIDIA card.

    python3 scripts/slstm_grad_probe.py                          # repository root; nvcc, one card
    python3 scripts/slstm_grad_probe.py --reduced --device cpu   # a tiny model, plain versions

Part 1, the step-1 gradient. xlstm-350m whole (weights from seed 0, remat
"block") takes one gradient of ``Model.loss`` on batches of 2 x 256 tokens
(chip_smoke.py's held-check batches, SyntheticTokens(seed=0)), with only the
sLSTM changed between variants (every variant goes through
``ops.SLSTMFused``; the rest of the model is the same code on the same
weights):

* ``plain``: ``slstm_ref`` forward, ``slstm_bwd_ref`` backward;
* ``kernel``: the CUDA forward and backward;
* ``kernel_fwd+plain_bwd`` and ``plain_fwd+kernel_bwd``: one of each;
* ``plain~p<i>`` and ``kernel~p<i>``: the hidden units of every head in a
  seeded random order (the sums of each step in another order, the same
  arithmetic): the plain path's and the kernel's own rounding noise;
* two lower-precision controls, designs a kernel could take: ``ctrl:R_bf16``
  (R rounded to bfloat16, forward and backward) and ``ctrl:saved_bf16``
  (the per-step state stored in bfloat16); and a gross fault,
  ``ctrl:zero_bwd`` (the sLSTM passes no gradient back).

Each variant's gradient is held against the float32 plain gradient (the
truth here; the f32 kernel's distance from it is printed too) and against
the bf16 plain one: the grad norm, the distance of the whole gradient
``|g - g_f32| / |g_f32|``, and the shares of ``|g - g_f32|^2`` by leaf kind.

Part 2, the trajectories (grad norm and loss each step, lr 3e-3 WSD as
chip_smoke.py's train phases): at 2 x 256 tokens, bf16 through the kernels
and through the plain versions, and f32 through the kernels, for 20 steps;
at 8 x 2048 (the train-xlstm phase's size), f32 through the kernels for 20
steps and bf16 through the plain versions for ``--plain-steps``.

Part 3, the held steps: chip_smoke.py's held check (3 steps of 2 x 256
tokens, the train phases' optimizer) for every variant of part 1 but the
mixed ones, in float32 and bfloat16: each step's loss and grad norm, and
their distance from the plain path's.

``--parts`` picks the parts (default all). Writes every line to
``chiprun_out/slstm_grad_probe.jsonl`` and ends with the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ref as ref_lib  # noqa: E402
from repro_torch.models.transformer import CallConfig, build_model  # noqa: E402
from repro_torch.train.optimizer import OptConfig  # noqa: E402
from repro_torch.train.train_step import make_train_state, make_train_step  # noqa: E402

OUT = ROOT / "chiprun_out" / "slstm_grad_probe.jsonl"
DRAWS = 3  # unit orders a path
BATCHES = 2  # step-1 batches


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)
    with OUT.open("a") as f:
        f.write(json.dumps(obj) + "\n")


def plain_fwd(gx, rg, num_heads, *, save=False):
    return ref_lib.slstm_ref(gx, rg, num_heads, save=save)


def saved_bf16_fwd(gx, rg, num_heads, *, save=False):
    h, state, saved = ref_lib.slstm_ref(gx, rg, num_heads, save=True)
    return h, state, saved.bfloat16().float()


def zero_bwd(rg, saved, dh, num_heads):
    B, S, _, D = saved.shape
    return dh.new_zeros((B, S, 4, D)), torch.zeros_like(rg)


def routed(fwd, bwd, perm=None, r_bf16=False):
    """An ``ops.slstm`` for grad: ops.SLSTMFused with ``fwd`` and ``bwd``
    (None: the kernels), on the units of each head in the order ``perm``."""
    def run(gx, rg, num_heads, *, backend=None):
        hd = gx.shape[-1] // num_heads
        if r_bf16:
            rg = rg.bfloat16().float()
        if perm is not None:
            p = perm.to(gx.device)
            idx = (torch.arange(num_heads, device=gx.device)[:, None] * hd + p).reshape(-1)
            gx, rg = gx[..., idx], rg[:, :, p][:, :, :, p]
        h, *state = ops.SLSTMFused.apply(gx.contiguous(), rg.contiguous(), num_heads, "cuda")
        if perm is not None:
            h = h[..., torch.argsort(idx)]
        return h, tuple(state)
    return run


@contextlib.contextmanager
def sLSTM(fwd, bwd, perm=None, r_bf16=False):
    saved = ops.slstm, ops._slstm_fused, ops._slstm_fused_bwd
    ops.slstm = routed(fwd, bwd, perm, r_bf16)
    if fwd is not None:
        ops._slstm_fused = fwd
    if bwd is not None:
        ops._slstm_fused_bwd = bwd
    try:
        yield
    finally:
        ops.slstm, ops._slstm_fused, ops._slstm_fused_bwd = saved


def kind(name: str) -> str:
    """blocks.3.mlstm.wq -> mlstm.wq"""
    return re.sub(r"^blocks\.\d+\.", "", name)


def gradient(model, batch):
    loss, _ = model.loss(batch)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), {n: g.detach().float() for n, g in zip(params, grads)}


def norm(g: dict) -> float:
    return sum(float((t.double() ** 2).sum()) for t in g.values()) ** 0.5


def against(g: dict, want: dict) -> tuple:
    """|g - want| / |want| and the shares of |g - want|^2 by leaf kind."""
    parts = {}
    for n in want:
        k = kind(n)
        parts[k] = parts.get(k, 0.0) + float(((g[n].double() - want[n].double()) ** 2).sum())
    total = sum(parts.values())
    top = sorted(parts.items(), key=lambda kv: -kv[1])[:4]
    return (total ** 0.5 / norm(want),
            {k: v / total if total else 0.0 for k, v in top})


def variants(hd: int, card: bool, mixed: bool = True) -> dict:
    """name -> (forward, backward, unit order, R in bf16); None: the kernel."""
    gen = torch.Generator().manual_seed(0)
    perms = [torch.randperm(hd, generator=gen) for _ in range(DRAWS)]
    kfwd = kbwd = None  # the kernels
    pbwd = ref_lib.slstm_bwd_ref
    out = {"plain": (plain_fwd, pbwd, None, False)}
    out.update({f"plain~p{i}": (plain_fwd, pbwd, p, False) for i, p in enumerate(perms)})
    if card:
        out["kernel"] = (kfwd, kbwd, None, False)
        if mixed:
            out.update({"kernel_fwd+plain_bwd": (kfwd, pbwd, None, False),
                        "plain_fwd+kernel_bwd": (plain_fwd, kbwd, None, False)})
        out.update({f"kernel~p{i}": (kfwd, kbwd, p, False) for i, p in enumerate(perms)})
    out.update({"ctrl:R_bf16": (plain_fwd, pbwd, None, True),
                "ctrl:saved_bf16": (saved_bf16_fwd, pbwd, None, False),
                "ctrl:zero_bwd": (plain_fwd, zero_bwd, None, False)})
    return out


def step1(cfg, dev, batches, card: bool) -> None:
    variants_ = variants(cfg.xlstm.head_dim, card)
    for bi, batch in enumerate(batches):
        truth = None
        for dtype in (torch.float32, torch.bfloat16):
            model = build_model(cfg, CallConfig(compute_dtype=dtype, remat="block"),
                                device=dev, seed=0)
            model.requires_grad_(True)
            names = ["plain", "kernel"] if dtype == torch.float32 else list(variants_)
            base = None
            for name in names:
                if name not in variants_:
                    continue
                fwd, bwd, perm, r_bf16 = variants_[name]
                t0 = time.perf_counter()
                with sLSTM(fwd, bwd, perm, r_bf16):
                    loss, g = gradient(model, batch)
                secs = time.perf_counter() - t0
                if truth is None:
                    truth = g
                if base is None:
                    base = (loss, norm(g), g)
                d_truth, shares = against(g, truth)
                d_plain, _ = against(g, base[2])
                gn = norm(g)
                emit({"part": "step1", "batch": bi, "dtype": str(dtype)[6:], "variant": name,
                      "loss": loss, "grad_norm": gn,
                      "grad_norm_rel_to_plain": abs(gn - base[1]) / base[1],
                      "grad_norm_rel_to_f32": abs(gn - norm(truth)) / norm(truth),
                      "dist_to_f32": d_truth, "dist_to_plain": d_plain,
                      "f32_dist_shares": shares, "s": secs})
                del g
            del model
            if card:
                torch.cuda.empty_cache()


def train(cfg, dev, dtype, backend, batches) -> tuple:
    """(losses, grad norms) of ``batches`` through the train phases' step."""
    model = build_model(cfg, CallConfig(compute_dtype=dtype, remat="block",
                                        kernel_backend=backend), device=dev, seed=0)
    ocfg = OptConfig(lr=3e-3, schedule="wsd", warmup_steps=max(cs.TRAIN_STEPS // 10, 1),
                     total_steps=cs.TRAIN_STEPS)
    state, step = make_train_state(model, None, ocfg), make_train_step(model, ocfg)
    losses, gns = [], []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        gns.append(float(m["grad_norm"]))
    del model, state, step
    if dev == "cuda":
        torch.cuda.empty_cache()
    return losses, gns


def trajectory(cfg, dev, dtype, backend, batches, what: str) -> None:
    t0 = time.perf_counter()
    losses, gns = train(cfg, dev, dtype, backend, batches)
    emit({"part": "trajectory", "what": what, "dtype": str(dtype)[6:],
          "path": "plain" if backend == "ref" else "kernel", "steps": len(batches),
          "tokens": [len(batches[0]["tokens"]), len(batches[0]["tokens"][0])],
          "grad_norms": gns, "losses": losses, "s": time.perf_counter() - t0})


def held(cfg, dev, batches, card: bool) -> None:
    for dtype in (torch.float32, torch.bfloat16):
        base = None
        for name, (fwd, bwd, perm, r_bf16) in variants(cfg.xlstm.head_dim, card,
                                                       mixed=False).items():
            with sLSTM(fwd, bwd, perm, r_bf16):
                losses, gns = train(cfg, dev, dtype, None, batches)
            base = base or (losses, gns)
            emit({"part": "held", "dtype": str(dtype)[6:], "variant": name, "losses": losses,
                  "grad_norms": gns,
                  "loss_rel": [abs(a - b) / abs(b) for a, b in zip(losses, base[0])],
                  "grad_norm_rel": [abs(a - b) / abs(b) for a, b in zip(gns, base[1])]})


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduced", action="store_true", help="the smoke-size config")
    ap.add_argument("--plain-steps", type=int, default=4,
                    help="bf16 plain steps at the train-xlstm phase's size")
    ap.add_argument("--parts", default="1,2,3", help="which parts to run")
    args = ap.parse_args()
    parts = {int(p) for p in args.parts.split(",")}
    card = args.device == "cuda"
    if card and not torch.cuda.is_available():
        sys.exit("no CUDA device is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    OUT.parent.mkdir(exist_ok=True)
    OUT.unlink(missing_ok=True)
    cfg = get_config(cs.XLSTM_ARCH)
    if args.reduced:
        cfg = cfg.reduced()
    seq = cs.XLSTM_CHECK_SEQ if card else 32
    small = cs.train_batches(cs.CHECK_BATCH, cs.TRAIN_STEPS, arch=cs.XLSTM_ARCH, seq=seq)
    if args.reduced:
        for b in small:
            for k in b:
                b[k] = b[k] % cfg.vocab_size
    with torch.enable_grad():
        if 1 in parts:
            step1(cfg, args.device, small[:BATCHES], card)
        runs = [(torch.bfloat16, None), (torch.bfloat16, "ref"), (torch.float32, None)]
        for dtype, backend in (runs if card else runs[1:]) if 2 in parts else ():
            trajectory(cfg, args.device, dtype, backend, small, "check size")
        if 3 in parts:
            held(cfg, args.device, small[:cs.CHECK_STEPS], card)
        if 2 in parts and card and not args.reduced:
            full = cs.train_batches(cs.TRAIN_BATCH, cs.TRAIN_STEPS, arch=cs.XLSTM_ARCH)
            trajectory(cfg, args.device, torch.float32, None, full, "train size")
            trajectory(cfg, args.device, torch.bfloat16, "ref", full[:args.plain_steps],
                       "train size")
    if card:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True)
        print(smi.stdout.strip())


if __name__ == "__main__":
    main()
