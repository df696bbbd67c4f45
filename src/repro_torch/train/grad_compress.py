"""Compressed cross-pod gradient reduction with error feedback.

The port's copy of ``repro.train.grad_compress``. Domino's data-movement
thesis applied to the slowest link of a multi-pod job, the inter-pod
gradient reduction: gradients are int8-quantized with one scale a row
before they cross the 'pod' axis, and the quantization residual is fed
back into the next step (error feedback keeps SGD/Adam convergence —
Karimireddy et al. 2019). Intra-pod reduction stays full precision
(``repro_torch.parallel.collectives.grad_transform``).

The wire. The reference's docstring says the int8 payload crosses the pod
links, but its ``psum`` runs on the dequantized float32 rows. The result
matched here is the code's, the mean over pods of the dequantized rows;
what the port sends is what the docstring says: each rank's int8 codes and
float32 row scales go round the pod ring (``com_all_gather``, counted in
``repro_torch.core.com.counters``), and every rank sums the pods'
dequantized rows in pod order.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.com import com_all_gather
from repro_torch.launch.mesh import mesh_shape

Grads = Dict[str, torch.Tensor]


def _quant_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.reshape(-1) if x.ndim <= 1 else x.reshape(x.shape[0], -1)
    amax = flat.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-20) / 127.0
    q = torch.clamp(torch.round(flat / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant_rows(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    return (q.to(torch.float32) * scale).reshape(shape)


def compressed_pod_psum(grads: Grads, error: Optional[Grads], mesh, *,
                        axis: str = "pod") -> Tuple[Grads, Optional[Grads]]:
    """The mean of ``grads`` (name -> tensor) across ``axis`` of a
    ``DeviceMesh`` with int8 compression and error feedback. Returns
    (reduced grads, new error state: float32, this rank's residual).

    Intended call: grads are already reduced within the pod; this adds the
    cross-pod mean. Without the axis, or at size 1, grads and error come
    back as they are."""
    npod = mesh_shape(mesh).get(axis, 1)
    if npod == 1:
        return grads, error
    group = mesh.get_group(axis)
    if error is None:
        error = {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                 for k, g in grads.items()}
    new_g, new_e = {}, {}
    for k, g in grads.items():
        g_fb = g.to(torch.float32) + error[k]
        q, scale = _quant_rows(g_fb)
        new_e[k] = g_fb - _dequant_rows(q, scale, g.shape)  # the residual stays local
        qs, ss = com_all_gather(q, group), com_all_gather(scale, group)
        total = qs[0].to(torch.float32) * ss[0]
        for p in range(1, npod):
            total = total + qs[p].to(torch.float32) * ss[p]
        new_g[k] = (total / npod).reshape(g.shape).to(g.dtype)
    return new_g, new_e
