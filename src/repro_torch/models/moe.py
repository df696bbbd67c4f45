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

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, dense_init, silu


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


def moe_forward(params: Params, x: torch.Tensor, *, top_k: int, num_experts: int,
                capacity_factor: float, dp_size: int,
                ep_split: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y (B, S, D), aux_loss () float32).

    The reference's ``shard_fn`` (a placement of the dispatch buffers that
    makes the expert-parallel all-to-all) waits for the moe family's
    model-parallel training (ROADMAP.md, Queue 1): in one process it places
    nothing, and under a mesh the train forward refuses the moe family
    (:meth:`repro_torch.models.transformer.Model.forward_train`). With
    ``ep_split > 1`` each expert's buffer is
    repeated for its ``ep_split`` weight slices and their down-projections
    are summed, as the reference computes it."""
    B, S, D = x.shape
    dp, tl, capacity = expert_capacity(B * S, top_k=top_k, num_experts=num_experts,
                                       capacity_factor=capacity_factor, dp_size=dp_size)
    xg = x.reshape(dp, tl, D)
    logits = torch.einsum("gtd,de->gte", xg, params["router"].to(x.dtype))
    groups = [_dispatch_group(xx, ll, top_k, capacity, num_experts)
              for xx, ll in zip(xg, logits)]
    buf, slot, gates, gates_full = (torch.stack(t) for t in zip(*groups))
    ebuf = buf[:, :-1].reshape(dp, num_experts, capacity, D)
    if ep_split > 1:
        es = num_experts * ep_split
        ebuf = ebuf[:, :, None].expand(dp, num_experts, ep_split, capacity, D)
        out = _experts(ebuf.reshape(dp, es, capacity, D), params)
        out = out.reshape(dp, num_experts, ep_split, capacity, D).sum(dim=2)
    else:
        out = _experts(ebuf, params)
    out_flat = torch.cat([out.reshape(dp, num_experts * capacity, D),
                          out.new_zeros((dp, 1, D))], dim=1)
    # slot E·C picks the zero row (a dropped choice)
    picked = torch.stack([of[sl] for of, sl in zip(out_flat, slot)])  # (dp, Tl, k, D)
    y = torch.einsum("gtkd,gtk->gtd", picked, gates)

    # load-balance aux loss (Switch): E · sum_e f_e · p_e
    pe = gates_full.mean(dim=(0, 1))
    top1 = gates_full.argmax(dim=-1)
    fe = F.one_hot(top1, num_experts).float().mean(dim=(0, 1))
    aux = num_experts * (fe * pe).sum()
    return y.reshape(B, S, D), aux
