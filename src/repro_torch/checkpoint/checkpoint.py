"""Checkpoints with a manifest and an atomic commit marker.

The port's copy of ``repro.checkpoint.checkpoint``, in the same layout, so
that a checkpoint written by either package restores in the other::

    ckpt_dir/step_00000100/
        manifest.json          # keys, shapes, dtypes, treedef, step, extra
        shard_00000.npz        # leaf_0, leaf_1, ... in the tree's leaf order
        _COMMITTED             # written last: a partial checkpoint is never restored

A tree is nested dicts (keys in sorted order, as ``jax.tree_util``
flattens them), lists and tuples, with array leaves (numpy arrays, numbers
or tensors, copied to the host). The manifest's ``keys`` are the strings
``jax.tree_util.keystr`` gives for the same paths (``['opt']['m']...``);
its ``treedef`` is the port's own rendering of the structure, which
``restore`` never reads (nor does the reference's).

A ``DTensor`` leaf is saved whole: ``full_tensor()`` gathers it, which is
a collective, so every rank of its mesh calls ``save`` (each with its own
``host_id``, as the reference's hosts do; ``restore`` reads host 0's
file). ``restore(..., shardings=)`` is the elastic restart onto another
mesh: each leaf is placed with ``distribute_tensor`` on its
:class:`~repro_torch.parallel.sharding.Sharding`'s mesh and placements.
"""
from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

PyTree = Any


def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple))


def _children(x):
    if isinstance(x, dict):
        return [(f"[{k!r}]", x[k]) for k in sorted(x)]
    return [(f"[{i}]", v) for i, v in enumerate(x)]


def _flat_with_paths(tree: PyTree, prefix: str = "") -> List[Tuple[str, Any]]:
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for key, child in _children(tree):
        out += _flat_with_paths(child, prefix + key)
    return out


def _treedef(tree: PyTree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}" for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"({inner},)" if len(tree) == 1 else f"({inner})"
    return "*"


def _unflatten(template: PyTree, leaves: List[Any]) -> PyTree:
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("the checkpoint holds more leaves than the template")
    return out


def _host(leaf) -> np.ndarray:
    """A leaf as a numpy array (a tensor is copied to the host, a
    ``DTensor`` gathered whole first; bfloat16 becomes ml_dtypes' bfloat16,
    as a JAX array's does)."""
    if hasattr(leaf, "detach"):
        import torch

        if hasattr(leaf, "full_tensor"):
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return np.asarray(leaf)


_LOCAL_HEADER = struct.Struct("<4s2B4HL2L2H")  # a zip member's local header; [10], [11]: name, extra
READ_CHUNK = 64 << 20  # bytes a read of the restore; a chunk's CRC-32 runs while the next is read


def _read_crc(f, buf: memoryview, crc: int, pool: ThreadPoolExecutor) -> Tuple[int, int]:
    """Read ``f`` into ``buf`` until it is full or the file ends, in
    READ_CHUNK pieces, the CRC-32 of each piece taken on ``pool``'s thread
    while the next one is read (both release the GIL), so that the read
    runs at the slower of the two rates and not at their serial sum.
    Returns (bytes read, the CRC-32 continued from ``crc``)."""
    got, pending = 0, None
    while got < len(buf):
        n = f.readinto(buf[got:got + READ_CHUNK])
        if not n:
            break
        if pending is not None:
            crc = pending.result()
        pending = pool.submit(zlib.crc32, buf[got:got + n], crc)
        got += n
    return got, crc if pending is None else pending.result()


def _loadz(path: str, names: List[str]) -> List[np.ndarray]:
    """``np.load(path)[name]`` for each of ``names``. A member stored
    uncompressed with a version 1.0 or 2.0 header (what ``np.savez``
    writes) is read into its array in one pass (:func:`_read_crc`) and its
    CRC-32 checked against the zip's, where ``np.load`` reads 256 KiB at a
    time; any other member goes through ``np.load``."""
    fmt = np.lib.format
    out = []
    with zipfile.ZipFile(path) as zf, open(path, "rb", buffering=0) as f, \
            ThreadPoolExecutor(max_workers=1) as pool:
        for name in names:
            info = zf.getinfo(name + ".npy")
            f.seek(info.header_offset)
            fields = _LOCAL_HEADER.unpack(f.read(_LOCAL_HEADER.size))
            start = info.header_offset + _LOCAL_HEADER.size + fields[10] + fields[11]
            f.seek(start)
            version = fmt.read_magic(f) if info.compress_type == zipfile.ZIP_STORED else None
            if version not in ((1, 0), (2, 0)):
                with np.load(path) as data:
                    out.append(data[name])
                continue
            read_header = fmt.read_array_header_1_0 if version == (1, 0) else \
                fmt.read_array_header_2_0
            shape, fortran, dtype = read_header(f)
            head = f.tell() - start
            f.seek(start)
            crc = zlib.crc32(f.read(head))
            a = np.empty(shape, dtype, order="F" if fortran else "C")
            buf = memoryview(a.reshape(-1, order="A").view(np.uint8))
            got, crc = _read_crc(f, buf, crc, pool)
            if got != len(buf) or head + got != info.file_size or crc != info.CRC:
                raise zipfile.BadZipFile(f"{path}: member {name}.npy is short or fails its CRC")
            out.append(a)
    return out


def save(ckpt_dir: str, step: int, tree: PyTree, *, extra: Optional[Dict] = None,
         host_id: int = 0, keep: int = 3) -> str:
    """Write one checkpoint; returns its path. Host 0 writes the manifest
    and the commit marker, then the oldest committed checkpoints past
    ``keep`` are removed."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    flat = [(k, _host(v)) for k, v in _flat_with_paths(tree)]
    arrays = {f"leaf_{i}": a for i, (_, a) in enumerate(flat)}
    np.savez(os.path.join(path, f"shard_{host_id:05d}.npz"), **arrays)
    if host_id == 0:
        manifest = {
            "step": step,
            "keys": [k for k, _ in flat],
            "shapes": [list(np.shape(a)) for _, a in flat],
            "dtypes": [str(a.dtype) for _, a in flat],
            "treedef": f"PyTreeDef({_treedef(tree)})",
            "time": time.time(),
            "extra": extra or {},
        }
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(path, "_COMMITTED"), "w") as f:
            f.write("ok")
    _gc(ckpt_dir, keep)
    return path


def _committed(ckpt_dir: str) -> List[str]:
    return [d for d in os.listdir(ckpt_dir)
            if d.startswith("step_") and os.path.exists(os.path.join(ckpt_dir, d, "_COMMITTED"))]


def _gc(ckpt_dir: str, keep: int):
    for d in sorted(_committed(ckpt_dir))[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in _committed(ckpt_dir)]
    return max(steps) if steps else None


def _tensor(a):
    """A restored leaf as a tensor, sharing its memory where it can. A
    bfloat16 leaf comes back from np.load as 2-byte void (its bits), or as
    ml_dtypes' bfloat16 if never saved."""
    import torch

    a = np.asarray(a)
    if not (a.flags.writeable and a.flags.c_contiguous):
        a = np.array(a)  # 0-d stays 0-d
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def restore(ckpt_dir: str, template: PyTree, *, step: Optional[int] = None,
            shardings: Optional[PyTree] = None) -> Tuple[PyTree, Dict]:
    """The checkpoint at ``step`` (default: the latest committed one) in
    ``template``'s structure (its leaves are not read), numpy leaves, and
    its manifest. With ``shardings`` (a tree of
    :class:`~repro_torch.parallel.sharding.Sharding` in the template's
    structure), each leaf is instead a ``DTensor`` placed on its sharding's
    mesh: every rank of that mesh calls ``restore``."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = _loadz(os.path.join(path, "shard_00000.npz"),
                    [f"leaf_{i}" for i in range(len(manifest["keys"]))])
    tree = _unflatten(template, leaves)
    if shardings is not None:
        flat, where = _flat_with_paths(tree), _flat_with_paths(shardings)
        if [k for k, _ in flat] != [k for k, _ in where]:
            raise ValueError("shardings do not have the template's structure")
        tree = _unflatten(template, [s.place(_tensor(x)) for (_, x), (_, s) in zip(flat, where)])
    return tree, manifest


def save_async(ckpt_dir: str, step: int, tree: PyTree, **kw) -> threading.Thread:
    """Save on a thread; the device -> host copy happens first, so that
    training can go on changing the tensors at once."""
    host_tree = _map(tree, lambda x: np.array(_host(x)))  # a copy, even of a CPU tensor
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree), kwargs=kw, daemon=True)
    t.start()
    return t


def _map(tree: PyTree, fn) -> PyTree:
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)
