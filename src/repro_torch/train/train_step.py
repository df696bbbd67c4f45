"""The training step: loss, gradients and AdamW, with microbatch gradient
accumulation and an optional gradient transform.

The port's copy of ``repro.train.train_step``. A train state is a dict
``{"params": model, "opt": {"step", "m", "v"}, "rng"}``: the model itself
(its parameters are the master weights, float32, or bfloat16 under
``OptConfig(param_dtype="bf16")``), the optimizer state of
:func:`repro_torch.train.optimizer.init_opt_state` keyed by parameter name,
and the reference's PRNG key as a uint32 array ``[0, seed]`` (the port draws
nothing from it). ``train_step(state, batch)`` updates the state in place
and returns it with the step's metrics. :func:`state_tree` and
:func:`load_state_tree` carry a state to and from the reference's own
train-state tree (stacked leaves), which is what checkpoints hold.

Under a mesh (model-parallel training: the parameters ``DTensor`` s placed
by :func:`repro_torch.parallel.sharding.place_params`) each gradient comes
back from autograd laid out as the product left it (a weight split over
"data" gets a partial sum over "data") and is redistributed to its
parameter's placements before the update: the reduce-scatter of the data
mean. The metrics come back as plain tensors. :func:`state_tree` gathers
each leaf whole (``full_tensor()``, one at a time), and
:func:`load_state_tree` writes each rank's chunk of a whole leaf into its
shard.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpoint.checkpoint import _host, _tensor
from repro_torch.convert import stack_tree, unstack_tree
from repro_torch.parallel.sharding import device_collectives
from repro_torch.train.optimizer import (OptConfig, _is_qleaf, adamw_update, cast_params,
                                         init_opt_state)


def prng_key(seed: int) -> np.ndarray:
    """The reference's ``jax.random.PRNGKey(seed)`` as it is stored: uint32
    ``[0, seed]`` (a seed below 2**32)."""
    return np.array([0, seed], dtype=np.uint32)


def make_train_state(model, seed: Optional[int], opt_cfg: OptConfig) -> Dict[str, Any]:
    """A fresh train state: the parameters redrawn from ``seed`` (None keeps
    the model's own, e.g. converted from the reference's), cast to
    ``opt_cfg.param_dtype`` (:func:`~repro_torch.train.optimizer.cast_params`),
    made trainable, and zero moments."""
    if seed is not None:
        model.init(seed)
    cast_params(dict(model.named_parameters()), opt_cfg)
    model.requires_grad_(True)
    return {"params": model, "opt": init_opt_state(dict(model.named_parameters()), opt_cfg),
            "rng": prng_key(0 if seed is None else seed)}


def make_train_step(model, opt_cfg: OptConfig, *, accum_steps: int = 1,
                    grad_transform: Optional[Callable] = None):
    """``train_step(state, batch) -> (state, metrics)``. ``batch`` is
    ``{"tokens", "targets"}`` (B, S) arrays; with ``accum_steps`` > 1 it is
    cut along the batch into that many microbatches whose gradients are
    summed in float32 (for float32 masters; bfloat16 otherwise) and divided
    by ``accum_steps``: the loss is the mean of the microbatch losses, the
    other metrics the last microbatch's. ``grad_transform(grads, carry) ->
    (grads, carry)`` runs before the update (the reference's hook for
    compressed cross-pod reduction), its carry kept in
    ``state["grad_carry"]``."""
    model.requires_grad_(True)

    def value_and_grad(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(p, DTensor) else g
                 for g, p in zip(grads, params.values())]
        return _plain(loss.detach()), {k: _plain(v.detach()) for k, v in metrics.items()}, \
            dict(zip(params, grads))

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = dict(state["params"].named_parameters())
        with device_collectives(_mesh(params.values())):
            return _step(state, params, batch)

    def _step(state, params, batch):
        if accum_steps == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            def split(x, i):
                b = x.shape[0]
                if b % accum_steps:
                    raise ValueError(f"batch {b} does not split into {accum_steps} microbatches")
                n = b // accum_steps
                return x[i * n:(i + 1) * n]

            grads = {n: torch.zeros_like(p, dtype=torch.float32 if p.dtype == torch.float32
                                         else torch.bfloat16,
                                         memory_format=torch.contiguous_format)
                     for n, p in params.items()}
            loss = torch.zeros((), device=next(iter(params.values())).device)
            for i in range(accum_steps):
                l, metrics, g = value_and_grad(params, {k: split(v, i) for k, v in batch.items()})
                grads = {n: grads[n] + g[n].to(grads[n].dtype) for n in grads}
                loss = loss + l
            grads = {n: g / accum_steps for n, g in grads.items()}
            loss = loss / accum_steps

        carry = state.get("grad_carry")
        if grad_transform is not None:
            grads, carry = grad_transform(grads, carry)
        _, _, opt_metrics = adamw_update(params, grads, state["opt"], opt_cfg)
        if carry is not None:
            state["grad_carry"] = carry
        return state, dict(metrics, loss=loss, **opt_metrics)

    return train_step


# ---------------------------------------------------------------------------
# The reference's train-state tree (checkpoints)
# ---------------------------------------------------------------------------


def _mesh(tensors):
    """The mesh of the first ``DTensor`` of ``tensors``, or None."""
    return next((t.device_mesh for t in tensors if isinstance(t, DTensor)), None)


def _plain(t):
    """A replicated ``DTensor`` metric as the plain tensor every rank holds."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _load(dst: torch.Tensor, whole) -> None:
    """Overwrite ``dst`` with a whole restored leaf, in place: a ``DTensor``
    with its own chunk of it (the same on every rank, so nothing crosses the
    mesh)."""
    t = _tensor(whole).reshape(dst.shape)
    if isinstance(dst, DTensor):
        t = distribute_tensor(t.to(dst.to_local().device), dst.device_mesh, dst.placements,
                              src_data_rank=None).to_local()
        dst = dst.to_local()
    dst.copy_(t)


def _flat_moments(moments: Dict[str, Any], host) -> Dict[str, Any]:
    flat = {}
    for name, m in moments.items():
        if _is_qleaf(m):
            flat.update({f"{name}.{k}": host(t) for k, t in m.items()})
        else:
            flat[name] = host(m)
    return flat


def _placeholder(t) -> np.ndarray:
    return np.zeros(())



def state_tree(state: Dict[str, Any], *, template: bool = False) -> Dict[str, Any]:
    """The state as the reference's train-state tree: ``{"opt": {"m",
    "step", "v"}, "params", "rng"}`` with the parameters and moments
    stacked as ``repro.models.transformer.Model.init`` stacks them, numpy
    leaves in their own dtype (bfloat16 masters and moments as ml_dtypes'
    bfloat16, as JAX holds them).
    With ``template`` every leaf is a 0-d placeholder: the structure alone,
    which is all ``checkpoint.restore`` reads of its template, with nothing
    copied off the card."""
    with device_collectives(None if template else _mesh(state["params"].parameters())):
        return _state_tree(state, template)


def _state_tree(state, template: bool):
    model = state["params"]
    host = _placeholder if template else _host
    # the tensors stacked where they live, then each stacked leaf to the host once
    leaf, convert = (_placeholder, None) if template else (lambda t: t, _host)
    stack = lambda d: stack_tree(model.cfg, model, _flat_moments(d, leaf),  # noqa: E731
                                 convert=convert)
    opt = state["opt"]
    return {"opt": {"m": stack(opt["m"]), "step": host(opt["step"]), "v": stack(opt["v"])},
            "params": stack(dict(model.state_dict())), "rng": np.asarray(state["rng"])}


@torch.no_grad()
def load_state_tree(state: Dict[str, Any], tree: Dict[str, Any]) -> Dict[str, Any]:
    """Overwrite ``state`` in place with a reference-layout train-state tree
    (:func:`state_tree`'s, or one the reference's checkpoint holds); returns
    ``state``."""
    model = state["params"]
    params = dict(model.named_parameters())
    flat = unstack_tree(model.cfg, model, tree["params"])
    if set(flat) != set(params):
        raise KeyError(f"parameters missing: {sorted(set(params) - set(flat))}, "
                       f"unknown: {sorted(set(flat) - set(params))}")
    for name, p in params.items():
        _load(p, flat[name])
    for which in ("m", "v"):
        flat = unstack_tree(model.cfg, model, tree["opt"][which])
        for name, m in state["opt"][which].items():
            if _is_qleaf(m):
                for k, t in m.items():
                    _load(t, flat[f"{name}.{k}"])
            else:
                _load(m, flat[name])
    state["opt"]["step"].copy_(_tensor(tree["opt"]["step"]))
    state["rng"] = np.asarray(tree["rng"], dtype=np.uint32)
    return state
