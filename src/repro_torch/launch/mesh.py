"""Device meshes: process meshes over ``torch.distributed`` and the
in-process data mesh.

The port's copy of ``repro.launch.mesh``. Each mesh is made by a FUNCTION,
so importing this module touches no device and no process group.

Mesh axes:
  single-pod: (data=16, model=16)          -> 256 ranks
  multi-pod : (pod=2, data=16, model=16)   -> 512 ranks

`pod` is an outer data-parallel axis (gradient reduction crosses the
inter-pod links once per step; optionally compressed via
``repro_torch.train.grad_compress``).

``make_production_mesh`` and ``make_debug_mesh`` return a
``torch.distributed.device_mesh.DeviceMesh`` over the initialized world:
one process per rank, each having called
``torch.distributed.init_process_group`` with its address, world size and
rank (a ``gloo`` group of CPU processes in the tests; NCCL with one rank a
card on a machine with several). ``device_type=None`` means ``"cuda"`` and
raises where there is no card; a mesh of CPU ranks is asked for by name.

``make_data_mesh`` is the counterpart of the reference's in-process
``("data",)`` mesh: a list of ``torch.device`` of this one process, which
``ProgramExecutor(shard=)`` and the ``"torch-sharded"`` sweep backend
(``repro_torch.parallel.shard_sweep``) split a batch over.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def make_mesh(shape: Sequence[int], names: Sequence[str], device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``shape`` with axis ``names`` over every rank of
    the initialized world, which must hold exactly ``prod(shape)`` ranks."""
    if device_type is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device_type='cpu' for a mesh "
                               "of CPU ranks")
        device_type = "cuda"
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call init_process_group with "
                           "the world's address, size and this process's rank first")
    world, want = dist.get_world_size(), math.prod(shape)
    if world != want:
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs {want} ranks; the world "
                         f"has {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, for a ``DeviceMesh`` (``mesh_dim_names`` and its
    shape) or a mesh whose ``shape`` is that mapping already (a
    :class:`DataMesh`, a test's fake)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_debug_mesh(data: int = 2, model: int = 2, *, pod: int = 0,
                    device_type: Optional[str] = None):
    """Small mesh for tests (the world must hold pod * data * model ranks,
    ``pod`` 0 meaning no pod axis)."""
    if pod:
        return make_mesh((pod, data, model), ("pod", "data", "model"), device_type)
    return make_mesh((data, model), ("data", "model"), device_type)


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ``("data",)`` mesh of devices of one process. Iterating it
    gives the devices, so ``ProgramExecutor(shard=mesh)`` takes it as a
    device list; ``shape`` maps the axis name to its size, as a mesh's
    does."""

    devices: Tuple[torch.device, ...]
    axis_names = ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}

    def __iter__(self):
        return iter(self.devices)

    def __len__(self) -> int:
        return len(self.devices)


def make_data_mesh(devices=None) -> DataMesh:
    """1-D ``("data",)`` mesh over every visible card (or the given
    devices, which may repeat one: ``[cuda:0, cuda:0]`` splits a batch in
    two on a machine with one card, ``[cpu, cpu]`` on the CPU).

    The scale-out substrate for the sharded sweep backend
    (``repro_torch.parallel.shard_sweep``) and the sharded
    ``ProgramExecutor`` mode: both partition one leading batch-like axis,
    so a flat data-parallel mesh is the whole topology."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass the devices, e.g. "
                               "make_data_mesh(['cpu', 'cpu'])")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(torch.device(d) for d in devices)
    if not devices:
        raise ValueError("a data mesh needs at least one device")
    return DataMesh(devices)
