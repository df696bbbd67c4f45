"""Mixture-of-Experts FFN with top-k routing and capacity-bounded scatter
dispatch (scatter-index based, so no (T, E, C) one-hot tensor is built).

The port's copy of ``repro.models.moe``, function for function, with the
same parameter names, layouts and cast points. Dataflow per dispatch group
(``dp`` groups of ``T / dp`` tokens):

  route -> rank-in-expert via one-hot cumsum -> scatter to (E, C, D)
  -> batched expert SwiGLU products -> gather back -> weighted combine.

Overflowed tokens (rank >= capacity) are dropped. The reference runs each
group under ``jax.vmap``; here the groups are dispatched one after another
and their expert buffers stacked on a leading ``dp`` axis. The expert
products stay plain ``torch.matmul`` (through ``einsum``), as they are
plain XLA in the reference: no Pallas kernel lies on this path.

Where the port must be written with care to give the reference's numbers:

* **top-k ties** — ``jax.lax.top_k`` puts the lower expert first on a tie
  and ``torch.topk`` promises no order; the experts are the first ``k`` of
  a *stable* descending sort, which keeps the lower index first;
* **ranks** — a cumsum over the flattened ``(T·k)`` choices in token-major
  order, as the reference's, so the same tokens overflow;
* **scatter** — ``index_add_`` into ``E·C + 1`` rows, the last one the
  overflow row that is thrown away (valid slots are unique, so the kept
  rows are exact copies of their tokens);
* **gates** — cast to the activations' dtype before the combine;
* **dropped slots** gather the zero row appended to the expert outputs.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models.layers import Params, dense_init, gathered, reduced, silu


def init_moe(gen: torch.Generator, d: int, f: int, num_experts: int, *,
             ep_split: int = 1) -> dict:
    """The router ``(d, E)`` and the experts' SwiGLU weights, drawn from
    ``gen`` on its device. ``ep_split > 1`` is the reference's
    expert-parallel layout: ``(E·split, d, f / split)`` (and ``(E·split,
    f / split, d)`` for ``wo``), each expert's hidden units cut into
    ``split`` slices whose down-projections are summed."""
    dev = gen.device

    def normal(shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) * (fan_in ** -0.5)

    if ep_split > 1:
        if f % ep_split:
            raise ValueError(f"d_ff {f} is not a multiple of ep_split {ep_split}")
        es, fs = num_experts * ep_split, f // ep_split
        return {"router": dense_init(gen, d, num_experts),
                "wi_gate": normal((es, d, fs), d), "wi_up": normal((es, d, fs), d),
                "wo": normal((es, fs, d), fs)}
    return {"router": dense_init(gen, d, num_experts),
            "wi_gate": normal((num_experts, d, f), d), "wi_up": normal((num_experts, d, f), d),
            "wo": normal((num_experts, f, d), f)}


def _dispatch_group(x: torch.Tensor, logits: torch.Tensor, top_k: int, capacity: int,
                    num_experts: int):
    """x: (T, D); logits: (T, E). Returns (buf (E·C+1, D), slot (T, k),
    gates (T, k) in ``x.dtype``, gates_full (T, E) float32)."""
    T, D = x.shape
    gates_full = torch.softmax(logits.float(), dim=-1)
    # jax.lax.top_k order: descending, the lower index first on a tie
    gates, eidx = torch.sort(gates_full, dim=-1, descending=True, stable=True)
    gates, eidx = gates[:, :top_k], eidx[:, :top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    flat_e = eidx.reshape(-1)  # (T·k,) token-major
    oh = F.one_hot(flat_e, num_experts)
    ranks = (oh.cumsum(dim=0) - 1).gather(1, flat_e[:, None])[:, 0]
    slot = torch.where(ranks < capacity, flat_e * capacity + ranks,
                       torch.full_like(flat_e, num_experts * capacity))
    tok = torch.arange(T, device=x.device).repeat_interleave(top_k)
    buf = x.new_zeros((num_experts * capacity + 1, D)).index_add_(0, slot, x[tok])
    return buf, slot.reshape(T, top_k), gates.to(x.dtype), gates_full


def expert_capacity(n_tokens: int, *, top_k: int, num_experts: int,
                    capacity_factor: float, dp_size: int = 1) -> Tuple[int, int, int]:
    """The (dp groups, tokens per group, per-expert buffer depth) that
    :func:`moe_forward` uses for a batch of ``n_tokens``. Tokens whose
    per-expert rank reaches the capacity are dropped, so ``capacity >=
    tokens_per_group`` means no drop is possible: the exact drop-free check
    the serve engine's moe guard evaluates. This is the single source of
    the capacity formula: the guard is only sound while it computes
    byte-for-byte what the dispatch does."""
    dp = max(1, min(dp_size, n_tokens))
    while n_tokens % dp:
        dp //= 2
    tl = n_tokens // dp
    return dp, tl, max(1, int((tl * top_k / num_experts) * capacity_factor))


def moe_axes(ep_split: int = 1) -> dict:
    """The logical axes of :func:`init_moe`'s parameters; the
    expert-parallel layout's leading axis is "experts_ep" (the whole mesh)."""
    experts = "experts_ep" if ep_split > 1 else "experts"
    return {"router": ("embed", None), "wi_gate": (experts, "embed", "mlp"),
            "wi_up": (experts, "embed", "mlp"), "wo": (experts, "mlp", "embed")}


def _experts(ebuf: torch.Tensor, params: Params) -> torch.Tensor:
    """The SwiGLU of every expert on its buffer: ebuf (dp, E', C, D) with
    E' the weights' leading axis -> (dp, E', C, D). Each weight is cast to
    the buffer's dtype, as the reference casts it."""
    dt = ebuf.dtype
    g = torch.einsum("gecd,edf->gecf", ebuf, params["wi_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", ebuf, params["wi_up"].to(dt))
    return torch.einsum("gecf,efd->gecd", silu(g) * u, params["wo"].to(dt))


def _route(xg: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int,
           num_experts: int):
    """The router product and the dispatch of each of ``xg``'s groups:
    xg (g, Tl, D), router (D, E) in ``xg.dtype`` -> (ebuf (g, E, C, D), slot
    (g, Tl, k), gates (g, Tl, k), gates_full (g, Tl, E) float32). The
    groups go one after another (a Python loop), their buffers stacked."""
    g, _, D = xg.shape
    logits = torch.einsum("gtd,de->gte", xg, router)
    groups = [_dispatch_group(xx, ll, top_k, capacity, num_experts)
              for xx, ll in zip(xg, logits)]
    buf, slot, gates, gates_full = (torch.stack(t) for t in zip(*groups))
    return buf[:, :-1].reshape(g, num_experts, capacity, D), slot, gates, gates_full


def _split_sum(out_ep: torch.Tensor, num_experts: int, ep_split: int) -> torch.Tensor:
    """(g, E·split, C, D) partial down-projections -> (g, E, C, D), each
    expert's ``split`` slices summed."""
    g, _, C, D = out_ep.shape
    return out_ep.reshape(g, num_experts, ep_split, C, D).sum(dim=2)


def _combine(out: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor) -> torch.Tensor:
    """out (g, E, C, D), slot and gates (g, Tl, k) -> (g, Tl, D): each
    token's choices gathered (slot E·C, a dropped choice, picks an appended
    zero row) and weighted by their gates."""
    g, E, C, D = out.shape
    out_flat = torch.cat([out.reshape(g, E * C, D), out.new_zeros((g, 1, D))], dim=1)
    picked = torch.stack([of[sl] for of, sl in zip(out_flat, slot)])  # (g, Tl, k, D)
    return torch.einsum("gtkd,gtk->gtd", picked, gates)


def _balance_sums(gates_full: torch.Tensor, num_experts: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sums over (groups, tokens) of the gates (E,) and of the top-1
    one-hot (E,), float32: the load-balance loss's p and f before the mean."""
    top1 = gates_full.argmax(dim=-1)
    return gates_full.sum(dim=(0, 1)), F.one_hot(top1, num_experts).float().sum(dim=(0, 1))


def moe_forward(params: Params, x: torch.Tensor, *, top_k: int, num_experts: int,
                capacity_factor: float, dp_size: int, shard_fn=None,
                ep_split: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux_loss () float32).

    ``shard_fn`` is ``CallConfig.shard_fn``: it places what the reference
    places, at the same points: ``xg`` as ``("exp_dp", None, None)``;
    ``ebuf`` as ``("exp_dp", "experts", None, None)`` (experts split over
    "model", their weights gathered over the batch's axes for the products:
    FSDP); with ``ep_split > 1`` ``ebuf_ep`` as ``(None, "experts_ep",
    None, None)`` (the tokens move to the weight slices, which stay where
    they are) and ``out`` as ``("exp_dp", None, None, None)``. With
    ``ep_split > 1`` each expert's buffer is repeated for its ``ep_split``
    weight slices and their down-projections are summed, as the reference
    computes it.

    Under a mesh (``x`` a ``DTensor``, its batch split over the mesh's batch
    axes, see :func:`_moe_placed`) the dispatch, the split sums and the
    combine run on each rank's own groups (``local_map``), and the
    load-balance loss is taken over the whole batch."""
    B, S, D = x.shape
    dp, tl, capacity = expert_capacity(B * S, top_k=top_k, num_experts=num_experts,
                                       capacity_factor=capacity_factor, dp_size=dp_size)
    if isinstance(x, DTensor):
        return _moe_placed(params, x, dp, tl, capacity, top_k=top_k, num_experts=num_experts,
                           shard_fn=shard_fn, ep_split=ep_split)
    place = shard_fn if shard_fn is not None else (lambda t, axes: t)
    xg = place(x.reshape(dp, tl, D), ("exp_dp", None, None))
    ebuf, slot, gates, gates_full = _route(xg, params["router"].to(x.dtype), top_k, capacity,
                                           num_experts)
    if ep_split > 1:
        es = num_experts * ep_split
        ebuf_ep = ebuf[:, :, None].expand(dp, num_experts, ep_split, capacity, D)
        ebuf_ep = place(ebuf_ep.reshape(dp, es, capacity, D), (None, "experts_ep", None, None))
        out = place(_split_sum(_experts(ebuf_ep, params), num_experts, ep_split),
                    ("exp_dp", None, None, None))
    else:
        out = _experts(place(ebuf, ("exp_dp", "experts", None, None)), params)
    y = _combine(out, slot, gates)

    # load-balance aux loss (Switch): E · sum_e f_e · p_e, f and p the means
    # over the dp · Tl tokens
    pe_sum, fe_sum = _balance_sums(gates_full, num_experts)
    aux = num_experts * ((fe_sum / (dp * tl)) * (pe_sum / (dp * tl))).sum()
    return y.reshape(B, S, D), aux


def _moe_placed(params: Params, x, dp: int, tl: int, capacity: int, *, top_k: int,
                num_experts: int, shard_fn, ep_split: int):
    """:func:`moe_forward` of a ``DTensor`` ``x`` (B, S, D) laid out over the
    batch (``Shard(0)``) on some mesh axes and replicated on the rest. The
    ``dp`` groups split over the batch's axes as the batch does (each rank's
    rows are its own groups, so nothing moves for the dispatch); a ``dp``
    those axes do not divide is refused, never regrouped. Each rank routes
    and dispatches its groups (:func:`_route`), the expert products run on
    each rank's own buffers and weights, gathered over the batch's axes
    where the weights are split there (FSDP), and the combine on each rank's
    own groups after the outputs come back over "model"; the load-balance
    loss sums each rank's gates and top-1 counts, reduced over the batch's
    axes, then takes the means over all ``dp · Tl`` tokens."""
    from torch.distributed.tensor.experimental import local_map

    if shard_fn is None:
        raise ValueError("a DTensor moe input needs CallConfig.shard_fn (make_shard_fn)")
    mesh = x.device_mesh
    if any(not (p.is_replicate() or p.is_shard(0)) for p in x.placements):
        raise ValueError(f"the moe input must be split over its batch only, not {x.placements}")
    batch = [i for i, p in enumerate(x.placements) if p.is_shard(0)]
    nb = math.prod(mesh.size(i) for i in batch)
    if dp % nb:
        names = [mesh.mesh_dim_names[i] for i in batch]
        raise ValueError(f"dp_size gives {dp} dispatch groups, which the batch's mesh axes "
                         f"{names} ({nb} ranks) do not split evenly; set CallConfig.dp_size to "
                         f"a multiple of {nb}")
    B, S, D = x.shape
    dt = x.dtype
    xp = list(x.placements)
    grad_partial = [Partial() if i in batch else Replicate() for i in range(mesh.ndim)]

    def lm(fn, out, ins, grads=None):
        return local_map(fn, out_placements=out, in_placements=ins, in_grad_placements=grads,
                         device_mesh=mesh)

    xg = lm(lambda t: t.reshape(-1, tl, D), xp, (xp,))(x)
    xg = shard_fn(xg, ("exp_dp", None, None))
    gp = list(xg.placements)
    router = gathered(params["router"].to(dt), xg)
    ebuf, slot, gates, gates_full = lm(
        lambda t, r: _route(t, r, top_k, capacity, num_experts), (gp,) * 4,
        (gp, list(router.placements)), (gp, grad_partial))(xg, router)
    if ep_split > 1:
        es = num_experts * ep_split
        ebuf_ep = lm(lambda t: t[:, :, None].expand(-1, num_experts, ep_split, capacity, D)
                     .reshape(-1, es, capacity, D), gp, (gp,))(ebuf)
        ebuf_ep = shard_fn(ebuf_ep, (None, "experts_ep", None, None))
        out_ep = _experts_placed(ebuf_ep, params)
        out_ep = out_ep.redistribute(mesh, gp)
        out = lm(lambda t: _split_sum(t, num_experts, ep_split), gp, (gp,))(out_ep)
        out = shard_fn(out, ("exp_dp", None, None, None))
    else:
        ebuf = shard_fn(ebuf, ("exp_dp", "experts", None, None))
        out = _experts_placed(ebuf, params).redistribute(mesh, gp)
    y = lm(lambda o, s, g: _combine(o, s, g).reshape(-1, S, D), xp, (gp, gp, gp))(out, slot,
                                                                                gates)
    pe_sum, fe_sum = (reduced(t) for t in lm(
        lambda g: _balance_sums(g, num_experts), (grad_partial,) * 2, (gp,))(gates_full))
    n = dp * tl
    aux = num_experts * ((fe_sum / n) * (pe_sum / n)).sum()
    return y, aux


def _experts_placed(ebuf, params: Params):
    """:func:`_experts` of a ``DTensor`` buffer (g, E', C, D) split over
    experts and groups as the expert weights' leading axis and the batch's
    axes split them: each weight cast to the buffer's dtype, then gathered
    over the mesh axes that split the buffer's groups (the cast first, so
    the gather moves the compute dtype), and each rank's products on its
    own buffer and weights. A weight's gradient is a partial sum over those
    axes (each rank's groups)."""
    from torch.distributed.tensor.experimental import local_map

    mesh = ebuf.device_mesh
    dt = ebuf.dtype
    ws = [gathered(params[k].to(dt), ebuf) for k in ("wi_gate", "wi_up", "wo")]
    wp = [list(w.placements) for w in ws]
    wgrad = [[Partial() if bp.is_shard(0) else p for p, bp in zip(w, ebuf.placements)]
             for w in wp]
    bp = list(ebuf.placements)
    return local_map(lambda b, g, u, o: _experts(b, {"wi_gate": g, "wi_up": u, "wo": o}),
                     out_placements=bp, in_placements=(bp, *wp),
                     in_grad_placements=(bp, *wgrad), device_mesh=mesh)(ebuf, *ws)
