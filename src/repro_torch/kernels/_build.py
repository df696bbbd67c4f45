"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C interface and
compiles on its own into a shared library for Hopper (``sm_90a``); sources
may include shared headers (``csrc/*.cuh``). A library is named by a hash
of its source, every header it includes (recursively) and the flags, so a
stale build is never loaded, and is built at first use: ``python3 chip_smoke.py`` in a
fresh checkout builds everything it runs. Builds go to
``build/repro_torch/`` at the repository root; ``.gitignore`` already lists
``build/``.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_functions: Dict[str, object] = {}
# ptxas -v report of every library built by this process, by kernel name
ptxas_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the port's "
            "CUDA kernels are built on the machine with the card")
    return str(path)


_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def _sources(path: Path, seen=None) -> list:
    """``path`` and every file it includes with ``#include "..."`` (looked up
    beside the including file, as nvcc does), each once, in include order."""
    seen = [] if seen is None else seen
    if path in seen or not path.exists():
        return seen
    seen.append(path)
    for inc in _INCLUDE.findall(path.read_bytes()):
        _sources(path.parent / inc.decode(), seen)
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in _sources(CSRC / f"{name}.cu"):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, force: bool = False):
    """Start one nvcc for ``name`` unless its library is built already (or
    ``force``); returns ``(process, tmp, target)`` or ``None``."""
    target = _target(name)
    if target.exists() and not force:
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, started) -> None:
    proc, tmp, target = started
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)  # atomic: another process never loads half a file
    ptxas_log[name] = out


def build(names: Iterable[str], force: bool = False) -> None:
    """Build the named kernels' libraries, one ``nvcc`` per source, all
    started together; ``force`` rebuilds a library that exists already."""
    with _lock:
        started = {n: _start(n, force) for n in names}
        failed = []
        for n, s in started.items():  # wait for every nvcc before raising
            if s is not None:
                try:
                    _finish(n, s)
                except RuntimeError as e:
                    failed.append(str(e))
        if failed:
            raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(name, started)
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib


def function(name: str, symbol: str, argtypes):
    """The C entry ``symbol`` of kernel ``name``, typed with ``argtypes``
    (pointers and the stream as ``c_void_p``, so none is cut to 32 bits)
    and returning the ``int`` CUDA error code."""
    fn = _functions.get(symbol)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[symbol] = fn
    return fn


def call(fn, device, *args) -> int:
    """``fn(*args, stream)`` on ``device``'s current stream, with ``device``
    made current only where it is not already (the guard costs host time on
    every launch)."""
    import torch

    if device.index is not None and device.index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def all_kernels() -> tuple:
    """Names of every CUDA source of the port."""
    return tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
