"""Training launcher, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.train --reduced --device cpu \
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--resume]
    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-1.2b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch dbrx-132b --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama-3.2-vision-90b --reduced \
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-large --reduced --device cpu

The port's copy of ``repro.launch.train``: the same flags, plus
``--device``, in one process. The model is built with
``CallConfig(remat="block")``, its weights drawn from ``--seed``; batches come
from ``SyntheticTokens`` (seed ``--seed``), the optimizer is AdamW with
``--schedule`` (warm-up over a tenth of the steps), checkpoints go to
``--ckpt-dir`` every ``--ckpt-every`` steps in the reference's layout, and
``--resume`` continues from the latest one; the loop runs under the port's
``Supervisor``, which saves and, when a step raises, restores and retries.
Trains every family (the moe loss adds 0.01 times the layers' load-balance
loss; a vlm batch carries image embeddings drawn each step,
:func:`image_embeds_at`; an audio batch carries ``(B, S, num_codebooks)``
tokens and targets). Prints
``step … loss … lr … gnorm … ms/step`` every ``--log-every`` steps and
returns the logged losses.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import checkpoint as ckpt_lib
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.models.frontend import synth_image_embeds
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.runtime.fault_tolerance import Supervisor
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.train_step import (load_state_tree, make_train_state, make_train_step,
                                          prng_key, state_tree)


def image_embeds_at(cfg, batch: int, seed: int, step: int, device) -> torch.Tensor:
    """A vlm batch's image embeddings at ``step``: ``synth_image_embeds`` (B,
    num_image_tokens, d_model) in bfloat16 from a ``torch.Generator`` on
    ``device`` seeded from ``seed + 1`` and ``step`` (mixed into 32 bits by
    ``numpy.random.SeedSequence``: the CPU generator keeps only the low 32
    bits of a seed), where the reference's launcher draws from
    ``fold_in(PRNGKey(seed + 1), step)``. The two give other numbers
    (ROADMAP Queue 3, item 29); each step's draw is its own, so a resumed
    run sees the embeddings the uninterrupted one did."""
    mixed = int(np.random.SeedSequence([seed + 1, step]).generate_state(1)[0])
    gen = torch.Generator(device=device).manual_seed(mixed)
    return synth_image_embeds(gen, cfg, batch)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true", help="smoke-size config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", default="wsd")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, CallConfig(remat="block", dp_size=1), device=args.device,
                        seed=args.seed)
    ocfg = OptConfig(lr=args.lr, schedule=args.schedule, warmup_steps=max(args.steps // 10, 1),
                     total_steps=args.steps)
    data = SyntheticTokens(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch,
        seed=args.seed, num_codebooks=cfg.num_codebooks,
    ))
    step_fn = make_train_step(model, ocfg, accum_steps=args.accum)

    def batch_at(step):
        batch = data.batch_at(step)
        if cfg.family == "vlm":
            batch["image_embeds"] = image_embeds_at(cfg, args.batch, args.seed, step,
                                                    model.device)
        return batch

    start_step = 0
    state = make_train_state(model, None, ocfg)  # the weights build_model drew
    state["rng"] = prng_key(args.seed)
    if args.resume and args.ckpt_dir:
        latest = ckpt_lib.latest_step(args.ckpt_dir)
        if latest is not None:
            tree, manifest = ckpt_lib.restore(args.ckpt_dir, state_tree(state, template=True))
            load_state_tree(state, tree)
            start_step = manifest["step"]
            print(f"resumed from step {start_step}")

    losses = []
    t0 = time.time()

    def train_fn(st, batch):
        st, metrics = step_fn(st, batch)
        step = int(st["opt"]["step"])
        if step % args.log_every == 0 or step == args.steps:
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = (time.time() - t0) / max(step - start_step, 1)
            print(f"step {step:5d} loss {loss:8.4f} lr {float(metrics['lr']):.2e} "
                  f"gnorm {float(metrics['grad_norm']):7.3f} {dt*1e3:7.1f} ms/step", flush=True)
        return st, metrics

    def save_fn(step, st):
        if args.ckpt_dir:
            ckpt_lib.save(args.ckpt_dir, step, state_tree(st))

    def restore_fn():
        tree, man = ckpt_lib.restore(args.ckpt_dir, state_tree(state, template=True))
        return load_state_tree(state, tree), man["step"]

    # checkpoints every --ckpt-every steps; a step that raises is retried from
    # the latest checkpoint under the supervisor's restart policy
    sup = Supervisor(save_fn=save_fn, restore_fn=restore_fn, ckpt_every=args.ckpt_every)
    sup.run(train_fn, state, batch_at, start_step=start_step, num_steps=args.steps)
    return losses


if __name__ == "__main__":
    main()
