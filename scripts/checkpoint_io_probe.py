#!/usr/bin/env python3
"""How fast a checkpoint shard reads back on this machine: ``np.load`` of
each member against the port's one-pass reader
(``repro_torch.checkpoint.checkpoint._loadz``, what ``restore`` uses), both
as it runs (each READ_CHUNK piece's CRC-32 taken while the next piece is
read) and with the whole member read before its CRC (one piece).

    python3 scripts/checkpoint_io_probe.py [--gib 8] [--pairs 3]

Writes a shard of float32 leaves of 2 GiB each with ``np.savez`` (what
``checkpoint.save`` writes) under build/, then reads it back ``--pairs``
times with each reader, each pass in the reverse order of the last, and
prints one JSON line: the write's GB/s and each read's. Both readers check every member's
CRC-32 and return the same arrays (checked). Needs no card; run on the
machine whose disk the numbers are for. The line is also written to
chiprun_out/checkpoint_io_probe.jsonl.
"""
from __future__ import annotations

import argparse
import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402

from repro_torch.checkpoint import checkpoint as ckpt_lib  # noqa: E402

OUT = ROOT / "chiprun_out" / "checkpoint_io_probe.jsonl"
LEAF = 2**29  # float32 elements: 2 GiB a leaf


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gib", type=int, default=8, help="the shard's size, a multiple of 2")
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    work = ROOT / "build" / "checkpoint_io_probe"
    work.mkdir(parents=True, exist_ok=True)
    path = str(work / "shard_00000.npz")
    names = [f"leaf_{i}" for i in range(args.gib // 2)]
    arrays = {n: np.random.default_rng(i).random(LEAF, dtype=np.float32)
              for i, n in enumerate(names)}
    nbytes = sum(a.nbytes for a in arrays.values())
    t0 = time.perf_counter()
    np.savez(path, **arrays)
    line = {"probe": "checkpoint-io", "bytes": nbytes,
            "savez_gb_s": nbytes / (time.perf_counter() - t0) / 1e9,
            "np_load_gb_s": [], "port_read_gb_s": [], "port_read_one_piece_gb_s": []}

    def np_load():
        with np.load(path) as data:
            return [data[n] for n in names]

    def one_piece():
        chunk, ckpt_lib.READ_CHUNK = ckpt_lib.READ_CHUNK, 1 << 62
        try:
            return ckpt_lib._loadz(path, names)
        finally:
            ckpt_lib.READ_CHUNK = chunk

    readers = {"np_load_gb_s": np_load, "port_read_gb_s": lambda: ckpt_lib._loadz(path, names),
               "port_read_one_piece_gb_s": one_piece}
    for pair in range(args.pairs):
        order = list(readers) if pair % 2 == 0 else list(reversed(readers))
        for key in order:
            t0 = time.perf_counter()
            got = readers[key]()
            line[key].append(nbytes / (time.perf_counter() - t0) / 1e9)
            if not all(np.array_equal(g, arrays[n]) for g, n in zip(got, names)):
                sys.exit(f"{key}: the read arrays differ from the written ones")
            del got
    shutil.rmtree(work)
    print(json.dumps(line), flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    with OUT.open("a") as f:
        f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
