"""Deterministic sharded synthetic-token data pipeline (the port's copy of
``repro.data.pipeline``, NumPy only: the same batches, bit for bit).

Production shape without external deps: an infinite, seekable stream of
(tokens, targets) batches, deterministic in (seed, step) — so a restarted
job resumes mid-epoch bit-identically (checkpoint stores only ``step``) —
with per-host sharding (each host materializes only its batch slice) and a
simple background prefetch queue.

The token source is a mixture of Zipf-distributed unigrams and a repeated
n-gram process, which gives non-trivial loss curves for the examples while
staying dependency-free.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    num_codebooks: int = 0     # audio archs
    zipf_a: float = 1.2


class SyntheticTokens:
    """Deterministic, seekable (seed, step) -> batch."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0, num_hosts: int = 1):
        assert cfg.global_batch % num_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.local_batch = cfg.global_batch // num_hosts
        # fixed "document" pool for n-gram structure
        rng = np.random.default_rng(cfg.seed)
        self._phrases = rng.integers(
            1, cfg.vocab_size, size=(256, 16), dtype=np.int32
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 4096 + self.host_id
        )
        shape = (self.local_batch, cfg.seq_len + 1)
        if cfg.num_codebooks:
            shape = shape + (cfg.num_codebooks,)
        # Zipf unigrams (clipped to vocab)
        toks = rng.zipf(cfg.zipf_a, size=shape).astype(np.int64)
        toks = np.clip(toks, 1, cfg.vocab_size - 1).astype(np.int32)
        # splice in repeated phrases for learnable structure
        n_splice = cfg.seq_len // 64
        for b in range(self.local_batch):
            for _ in range(n_splice):
                ph = self._phrases[rng.integers(0, 256)]
                pos = rng.integers(0, cfg.seq_len - 16)
                if cfg.num_codebooks:
                    toks[b, pos : pos + 16, :] = ph[:, None]
                else:
                    toks[b, pos : pos + 16] = ph
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue; seekable via start_step."""

    def __init__(self, source: SyntheticTokens, *, depth: int = 2, start_step: int = 0):
        self.source = source
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def next(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
