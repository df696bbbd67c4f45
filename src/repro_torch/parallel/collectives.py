"""Collective strategy selection, accounting helpers, and the gradient
reduction of data- and pod-parallel training.

The port's copy of ``repro.parallel.collectives``. ``matmul_strategy``
lets a layer swap its row-parallel reduction between:
  * "psum"      — local matmul + all-reduce (the paper's "conventional
                   NoC" strawman: global-buffer reduction),
  * "com"       — Domino's COM ring reduce-scatter (``core/com.py``),
  * "com_bidir" — both link directions (dual-router analogue).

``wire_bytes`` gives each strategy's bytes a rank puts on the links.

``grad_transform`` is the train step's gradient hook
(``repro_torch.train.train_step.make_train_step(grad_transform=)``) for
data- and pod-parallel training: the counterpart of the reduction that
GSPMD derives for the reference's sharded train step. Every rank holds the
whole model and a slice of the batch; with equal tokens a rank, the mean
of the ranks' gradients is the gradient of the whole batch, and the step
is the one-process step on it.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.core.com import (_placements, _split, all_reduce, com_matmul_local,
                                  com_matmul_local_bidir)
from repro_torch.launch.mesh import mesh_shape
from repro_torch.train.grad_compress import compressed_pod_psum


def wire_bytes(strategy: str, out_bytes: int, n: int) -> float:
    """Per-rank link traffic to produce a (replicated|sharded) output of
    ``out_bytes`` from n partial sums."""
    if n <= 1:
        return 0.0
    if strategy == "psum":          # all-reduce, ring: 2(n-1)/n * bytes
        return 2 * (n - 1) / n * out_bytes
    if strategy in ("com", "com_bidir"):  # reduce-scatter: (n-1)/n * bytes
        return (n - 1) / n * out_bytes
    raise ValueError(strategy)


def matmul_strategy(mesh, strategy: str, axis: str = "model"):
    """Returns ``mm(x, w)`` for a ``DeviceMesh``: every rank passes the
    global x (..., K) and w (K, N) and computes with its K slice of both
    (x K-sharded, w row-sharded over ``axis``), as a ``DTensor``. psum: the
    output replicated over ``axis``; com, com_bidir: the output N-sharded
    over ``axis`` (output-stationary — the consumer must accept the sharded
    layout, which is what sequence-parallel consumers want)."""
    if strategy not in ("psum", "com", "com_bidir"):
        raise ValueError(strategy)
    group = mesh.get_group(axis)

    def mm(x, w):
        from torch.distributed.tensor import DTensor, Replicate

        n, me = dist.get_world_size(group), dist.get_rank(group)
        x_l, w_l = _split(x, -1, n, me), _split(w, 0, n, me)
        if strategy == "psum":
            return DTensor.from_local(all_reduce(x_l @ w_l, group), mesh,
                                      [Replicate()] * mesh.ndim, run_check=False)
        local = com_matmul_local if strategy == "com" else com_matmul_local_bidir
        return DTensor.from_local(local(x_l, w_l, group), mesh,
                                  _placements(mesh, axis, x.ndim - 1), run_check=False)

    return mm


def axis_mean(grads: Dict[str, torch.Tensor], mesh, axis: str) -> Dict[str, torch.Tensor]:
    """The full-precision mean of ``grads`` (name -> tensor) over ``axis``:
    one float32 all-reduce of every leaf at once, each leaf back in its own
    dtype. An axis the mesh lacks is size 1: the grads come back as they
    are."""
    shape = mesh_shape(mesh)
    if axis not in shape:
        return grads
    flat = torch.cat([g.reshape(-1).to(torch.float32) for g in grads.values()])
    total = all_reduce(flat, mesh.get_group(axis)) / shape[axis]
    out, at = {}, 0
    for k, g in grads.items():
        out[k] = total[at:at + g.numel()].view(g.shape).to(g.dtype)
        at += g.numel()
    return out


def grad_transform(mesh, *, compress_pod: bool = False) -> Callable:
    """``transform(grads, carry) -> (grads, carry)`` for
    ``make_train_step(grad_transform=)``: the full-precision mean over
    "data", then the cross-pod mean — through
    :func:`~repro_torch.train.grad_compress.compressed_pod_psum` (int8 rows
    with error feedback, its residual the carry) where ``compress_pod`` is
    set, else full precision."""

    def transform(grads, carry: Optional[dict]):
        grads = axis_mean(grads, mesh, "data")
        if compress_pod:
            return compressed_pod_psum(grads, carry, mesh, axis="pod")
        return axis_mean(grads, mesh, "pod"), carry

    return transform
