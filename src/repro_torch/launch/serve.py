"""Serving launcher: batched generation against a (reduced) model, on the
card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-350m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-1.2b --reduced --device cpu

The port's copy of ``repro.launch.serve``: the same flags, plus
``--device``. Serves the dense, moe, hybrid (zamba2-1.2b) and ssm
(xlstm-350m) families. Weights are random, drawn from ``--seed``. As in the
reference:

* an moe config whose ``capacity_factor`` is not drop-free at the
  slot-pool size (``dbrx-132b`` as published, 1.25, at more than one slot)
  is refused by the engine with a ``ValueError`` that names a drop-free
  value;
* a vlm config (``llama-3.2-vision-90b``) builds, and the engine refuses
  it with a ``ValueError``: a ``Request`` carries no ``image_embeds``;
* an audio config (``musicgen-large``) exits before a model is built: the
  slot pool feeds back one token a row, not ``(B, 1, K)`` codebook tokens.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models.transformer import CallConfig, build_model
from repro_torch.serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--batch", type=int, default=None,
                    help="slot-pool size (default min(requests, 8)); the "
                         "KV pool is preallocated at batch x max-seq")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.num_codebooks:
        raise SystemExit(
            f"{cfg.name}: the serving launcher does not serve multi-codebook audio (the slot "
            "pool feeds back one token a row); call Model.prefill and Model.decode_step with "
            "(B, 1, num_codebooks) tokens instead")
    model = build_model(cfg, CallConfig(), device=args.device, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(prompt=rng.integers(1, cfg.vocab_size, size=args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new, temperature=args.temperature)
        for _ in range(args.requests)
    ]
    batch = args.batch if args.batch is not None else min(max(args.requests, 1), 8)
    eng = Engine(model, batch=batch, max_seq=args.max_seq)
    t0 = time.time()
    out = eng.generate(reqs, seed=args.seed)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.time() - t0
    total_new = sum(len(r.out_tokens) for r in out)
    print(f"{len(out)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s) on {model.device}")
    for i, r in enumerate(out):
        print(f"req{i}: {r.out_tokens[:12]}{'...' if len(r.out_tokens) > 12 else ''}")


if __name__ == "__main__":
    main()
