"""Optimizer: AdamW with cosine / WSD schedules, global-norm clipping,
optional bf16 or 8-bit (per-row quantized) moments and optional bf16
master weights (:func:`cast_params`).

The port's copy of ``repro.train.optimizer``, on a flat mapping of
parameter name -> tensor (``dict(model.named_parameters())``) where the
reference maps a pytree. The arithmetic is the reference's, in float32 on
the parameters' device. Where the reference returns new arrays, the port
updates in place: each parameter, each moment (int8 codes and scales
included) and the step counter are overwritten with their new values
(``copy_`` under ``no_grad``), and :func:`adamw_update` returns the same
objects.

The reference updates stacked leaves of more than 2e9 elements slice by
slice (``lax.map``), so that XLA's float32 temporaries stay one layer's
size. The port's parameters are per layer already (``blocks.<l>.*``, no
stacked leaf), but one layer's leaf can be large (dbrx-132b's experts:
1.06e9 elements, 4.2 GB of float32 for each of the update's ~7
temporaries), so the port updates any leaf of more than ``SLICE_ELEMENTS``
elements in slices of its first axis. Every operation of the update is
elementwise or over the last axis (the int8 scales), so the slices give
the bits of one pass.

Under a mesh (model-parallel training) a parameter is a ``DTensor``; its
moments are ``DTensor`` s of the same placements, its gradient arrives in
them (``train_step`` redistributes it), and the update runs on each
rank's local shard (sliced the same way) with the clip, learning rate
and bias corrections as plain scalars, the same on every rank.
:func:`global_norm` sums each shard's squares once (a replicated shard
counted once over its copies) and reduces over the mesh before the square
root. int8 moments keep one scale per global row, so they refuse a
placement that splits a row (its last axis).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial

Moment = Union[torch.Tensor, Dict[str, torch.Tensor]]
# a leaf larger than this is updated in slices of its first axis, each of
# at most this many elements (1 GiB of float32) where a row allows it
SLICE_ELEMENTS = 1 << 28


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"      # "cosine" | "wsd" | "const"
    warmup_steps: int = 100
    total_steps: int = 10_000
    decay_frac: float = 0.1       # WSD: final fraction of steps in decay
    min_lr_ratio: float = 0.1
    moment_dtype: str = "fp32"    # "fp32" | "bf16" | "int8"
    param_dtype: str = "fp32"     # "fp32" | "bf16" master weights (cast_params)


PARAM_DTYPES = ("fp32", "bf16")


@torch.no_grad()
def cast_params(params: Mapping[str, torch.Tensor], cfg: OptConfig) -> None:
    """The master weights in ``cfg.param_dtype``, in place: with ``"bf16"``
    every float32 parameter becomes bfloat16 (any other dtype stays), as the
    reference's dry run casts a train state's parameters before
    ``init_opt_state`` (``repro/launch/dryrun.py:150-157``); ``"fp32"``
    leaves them as they are. Leaf by leaf: each tensor's float32 storage is
    released as its bfloat16 copy replaces it (``.data``, so a
    ``nn.Parameter`` stays the same object), and the two copies of the
    model never stand side by side. :func:`adamw_update` then writes each
    update back in the parameter's dtype."""
    if cfg.param_dtype not in PARAM_DTYPES:
        raise ValueError(f"param_dtype={cfg.param_dtype!r}; expected one of {PARAM_DTYPES}")
    if cfg.param_dtype == "fp32":
        return
    for p in params.values():
        if p.dtype == torch.float32:
            p.data = p.data.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------


def schedule_lr(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), a
    float32 0-d tensor on the step's device: linear warm-up, then constant,
    cosine to ``min_lr_ratio`` or WSD (flat, then a linear decay over the
    last ``decay_frac`` of the steps)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        mult = torch.ones((), device=step.device)
    elif cfg.schedule == "cosine":
        t = torch.clamp((step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                        0.0, 1.0)
        mult = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "wsd":
        # Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395)
        decay_start = cfg.total_steps * (1 - cfg.decay_frac)
        t = torch.clamp((step - decay_start) / max(cfg.total_steps - decay_start, 1), 0.0, 1.0)
        mult = 1.0 - (1 - cfg.min_lr_ratio) * t
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * mult


# ---------------------------------------------------------------------------
# Quantized moment storage
# ---------------------------------------------------------------------------


def _quant(x: torch.Tensor, signed: bool) -> Dict[str, torch.Tensor]:
    """Per-row (last-dim) linear quantization to int8 (signed) or uint8
    codes and float32 scales; ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    squeeze = x.dim() == 0
    if squeeze:
        x = x[None]
    amax = x.abs().amax(dim=-1, keepdim=True) if signed else x.amax(dim=-1, keepdim=True)
    qmax = 127.0 if signed else 255.0
    scale = torch.clamp(amax, min=1e-20) / qmax
    q = torch.clamp(torch.round(x / scale), -qmax if signed else 0.0, qmax)
    out = {"q": q.to(torch.int8 if signed else torch.uint8), "scale": scale.float()}
    if squeeze:
        out["_scalar"] = torch.ones((), dtype=torch.int8, device=x.device)
    return out


def _dequant(d: Mapping[str, torch.Tensor]) -> torch.Tensor:
    x = d["q"].float() * d["scale"]
    if "_scalar" in d:
        x = x[0]
    return x


def _is_qleaf(t) -> bool:
    return isinstance(t, Mapping) and "q" in t and "scale" in t


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def init_opt_state(params: Mapping[str, torch.Tensor], cfg: OptConfig) -> Dict[str, Any]:
    """``{"step", "m", "v"}``: the step a 0-d int32 tensor, each moment a
    mapping of parameter name -> zeros of its shape (float32, bfloat16, or
    int8 / uint8 codes with scales)."""
    def zeros_like_moment(p, signed):
        if isinstance(p, DTensor):
            if cfg.moment_dtype == "int8":
                _whole_rows(p)
            return _placed_as(zeros_like_moment(p.to_local(), signed), p)
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.moment_dtype == "bf16":
            return z.to(torch.bfloat16)
        if cfg.moment_dtype == "int8":
            return _quant(z, signed)
        return z

    device = next(iter(params.values())).device if params else None
    with torch.no_grad():
        return {
            "step": torch.zeros((), dtype=torch.int32, device=device),
            "m": {n: zeros_like_moment(p, True) for n, p in params.items()},
            "v": {n: zeros_like_moment(p, False) for n, p in params.items()},
        }


def _whole_rows(p: DTensor) -> None:
    """int8 moments keep one scale per row of the last axis: refuse a
    placement that splits it."""
    mesh = p.device_mesh
    for i, pl in enumerate(p.placements):
        if pl.is_shard(p.ndim - 1) and mesh.size(i) > 1:
            raise ValueError(f"int8 moments keep one scale per global row; a parameter of shape "
                             f"{tuple(p.shape)} placed {p.placements} splits its rows over "
                             f"{mesh.mesh_dim_names[i]!r} (use moment_dtype 'fp32' or 'bf16')")


def _placed_as(local, p: DTensor):
    """A local moment (a tensor, or int8 codes and scales) as ``DTensor`` s
    of ``p``'s placements."""
    wrap = lambda t: DTensor.from_local(t, p.device_mesh, p.placements, run_check=False)  # noqa: E731
    if isinstance(local, Mapping):
        return {k: (t if k == "_scalar" else wrap(t)) for k, t in local.items()}
    return wrap(local)


def _local(t):
    """A ``DTensor`` (or a dict of them) as this rank's local tensor(s), which
    share its memory; anything else as it is."""
    if isinstance(t, Mapping):
        return {k: _local(v) for k, v in t.items()}
    return t.to_local() if isinstance(t, DTensor) else t


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, Mapping):
        for v in tree.values():
            yield from _tensors(v)
    else:
        for v in tree:
            yield from _tensors(v)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a mapping or
    sequence of tensors, nested). ``DTensor`` leaves (all on one mesh, split
    or replicated, as ``train_step`` hands them over): each rank sums its
    shards' squares, a shard replicated over ``c`` ranks
    weighted ``1 / c``, and the sum is reduced over the mesh before the
    square root; a plain tensor, the same on every rank, comes back."""
    leaves = list(_tensors(tree))
    if not any(isinstance(x, DTensor) for x in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(x.float())) for x in leaves))
    mesh = leaves[0].device_mesh
    total = None
    for x in leaves:
        copies = math.prod(mesh.size(i) for i, p in enumerate(x.placements) if p.is_replicate())
        part = torch.sum(torch.square(x.to_local().float())) / copies
        total = part if total is None else total + part
    total = DTensor.from_local(total, mesh, [Partial()] * mesh.ndim, run_check=False)
    return torch.sqrt(total.full_tensor())


def _store(dst: Moment, new: Moment) -> None:
    """Overwrite a moment with its new value, in place."""
    if _is_qleaf(dst):
        for k in dst:
            dst[k].copy_(new[k])
    else:
        dst.copy_(new)


def _slices(shape, limit: int) -> list:
    """Slices of the first axis that cut a leaf of ``shape`` into pieces of
    at most ``limit`` elements (one row at least); the whole leaf (``...``)
    where it fits, or where it has fewer than two axes (its last axis is a
    row of the int8 scales)."""
    n = math.prod(shape)
    if len(shape) < 2 or n <= limit:
        return [...]
    rows = max(1, limit // (n // shape[0]))
    return [slice(i, i + rows) for i in range(0, shape[0], rows)]


def _part(m: Moment, s) -> Moment:
    return {k: t[s] for k, t in m.items()} if _is_qleaf(m) else m[s]


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor], grads: Mapping[str, torch.Tensor],
                 opt_state: Dict[str, Any], cfg: OptConfig):
    """One AdamW step, leaf by leaf, in place: returns ``(params, opt_state,
    {"lr", "grad_norm"})`` with ``params`` and ``opt_state`` the objects
    given, overwritten (see the module docstring); a leaf of more than
    ``SLICE_ELEMENTS`` elements in slices of its first axis."""
    step = opt_state["step"] + 1
    lr = schedule_lr(cfg, step)
    gnorm = global_norm([grads[n] for n in params])
    clip = torch.clamp(torch.full_like(gnorm, cfg.clip_norm) / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    b1, b2 = cfg.betas
    stepf = step.to(torch.float32)
    bc1 = 1 - b1 ** stepf
    bc2 = 1 - b2 ** stepf
    for name, leaf in params.items():
        grad, m_all, v_all = grads[name], opt_state["m"][name], opt_state["v"][name]
        if isinstance(leaf, DTensor):
            if grad.placements != leaf.placements:
                raise ValueError(f"{name}: the gradient is placed {grad.placements}, the "
                                 f"parameter {leaf.placements}")
            leaf, grad, m_all, v_all = (_local(t) for t in (leaf, grad, m_all, v_all))
        for s in _slices(leaf.shape, SLICE_ELEMENTS):
            p = leaf[s]
            g = grad[s].float() * clip
            m, v = _part(m_all, s), _part(v_all, s)
            m_f = _dequant(m) if _is_qleaf(m) else m.float()
            v_f = _dequant(v) if _is_qleaf(v) else v.float()
            m_f = b1 * m_f + (1 - b1) * g
            v_f = b2 * v_f + (1 - b2) * torch.square(g)
            update = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
            pf = p.float()
            p.copy_((pf - lr * (update + cfg.weight_decay * pf)).to(p.dtype))
            if _is_qleaf(m):
                m_f, v_f = _quant(m_f, True), _quant(v_f, False)
            elif m.dtype == torch.bfloat16:
                m_f, v_f = m_f.to(torch.bfloat16), v_f.to(torch.bfloat16)
            _store(m, m_f)
            _store(v, v_f)
    opt_state["step"].copy_(step)
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
