"""Foundational layers: norms, RoPE, linear/embedding init, SwiGLU MLP.

The port's copy of ``repro.models.layers``. Parameters are mappings of
tensors (an ``nn.ParameterDict`` in :mod:`repro_torch.models.transformer`)
in the JAX package's layout — a dense weight is ``(in, out)`` — so weights
convert between the two packages without transposes. Every product casts
its float32 weight to the activation's dtype, as the reference does.

Each ``*_axes`` function gives the logical axis names of its parameters,
the tree that the reference's ``init_*`` returns beside the weights and
that :mod:`repro_torch.parallel.sharding` maps onto a mesh:

  "embed"   - d_model dim            -> fsdp ("data")
  "mlp"     - ffn hidden dim         -> tensor ("model")
  "heads"   - attention heads dim    -> tensor ("model")
  "kv"      - kv head dim            -> None (small) / tensor
  "vocab"   - vocabulary dim         -> tensor ("model")
  "experts" - MoE expert dim         -> tensor ("model")
  "layers"  - stacked layer dim      -> None
  None      - replicated
"""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

Params = Mapping[str, torch.Tensor]


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, *,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(in_dim, out_dim)`` normal weights scaled by ``1/sqrt(in_dim)``,
    drawn from ``gen`` on its device."""
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device, dtype=dtype)
    return w * (1.0 / math.sqrt(in_dim))


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def gathered(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A parameter ``w`` as its product with the activation ``x`` takes it:
    itself in one process; under a mesh gathered over the axes that split
    ``x``'s batch (FSDP's all-gather), so that the product keeps ``x``'s
    rows where they are and moves the weight, never the activations."""
    if isinstance(w, DTensor) and isinstance(x, DTensor):
        keep = [Replicate() if xp.is_shard(0) else wp for wp, xp in zip(w.placements, x.placements)]
        return w.redistribute(w.device_mesh, keep)
    return w


def weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A dense weight cast to ``x``'s dtype, as the reference casts it, then
    :func:`gathered`."""
    return gathered(w.to(x.dtype), x)


def reduced(t):
    """A ``DTensor`` with its partial placements (a partial sum or max, a
    masked partial gather) reduced, at its own shape; anything else as it
    is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(placements=[Replicate() if p.is_partial() else p for p in t.placements])


def grad_as_placed(y: torch.Tensor) -> torch.Tensor:
    """``y`` itself, whose gradient is brought back to ``y``'s own placements
    right here: a ``DTensor`` norm output feeds products split over
    "model", whose gradients arrive as partial sums over it, and they are
    reduced before the norm's backward (Megatron's all-reduce of the input's
    gradient). Left to ``DTensor``, torch 2.13 may reduce-scatter them over
    the sequence instead, and the products' backwards then search its
    strided layouts for minutes on a mesh of three axes. A plain tensor is
    returned as it is."""
    if not isinstance(y, DTensor):
        return y
    return DTensor.from_local(y.to_local(), y.device_mesh, y.placements, run_check=False,
                              shape=y.shape, stride=y.stride())


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """In float32, cast back to ``x.dtype``."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps) * gathered(params["scale"], x)
    return grad_as_placed(y.to(dt))


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * gathered(params["scale"], x) + gathered(
        params["bias"], x)
    return grad_as_placed(y.to(dt))


def norm_params(kind: str, d: int, device) -> dict:
    """The initial parameters of a ``kind`` norm over ``d`` features."""
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), device=device), "bias": torch.zeros((d,), device=device)}
    raise ValueError(kind)


def norm_axes(kind: str) -> dict:
    """The logical axes of a ``kind`` norm's parameters."""
    if kind == "rmsnorm":
        return {"scale": ("embed",)}
    if kind == "layernorm":
        return {"scale": ("embed",), "bias": ("embed",)}
    raise ValueError(kind)


def make_norm(kind: str):
    """The norm function named by an ``ArchConfig.norm``."""
    if kind == "rmsnorm":
        return rmsnorm
    if kind == "layernorm":
        return layernorm
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# RoPE (partial-fraction support for phi4)
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, fraction: float, device=None) -> torch.Tensor:
    rot_dim = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device) / rot_dim))
    return inv  # (rot_dim/2,)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).

    Rotates interleaved pairs ``(x[..., 0::2], x[..., 1::2])`` and stacks
    them back in place, as the reference does (not the ``rotate_half``
    convention). The products run in float32 and cast back to ``x.dtype``.
    """
    head_dim = x.shape[-1]
    inv = rope_freqs(head_dim, theta, fraction, device=x.device)
    rot_dim = inv.shape[0] * 2
    ang = positions[..., :, None].float() * inv  # (..., seq, rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    y = torch.stack([y1, y2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    return torch.cat([y, x_pass], dim=-1) if rot_dim < head_dim else y


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the reference's JAX computes it: ``x * (1 / (1 +
    exp(-x)))``, each operation rounded in ``x``'s dtype. In bfloat16 that
    differs from ``F.silu`` (one rounding of the float32 result) in about a
    third of the elements."""
    return x * torch.reciprocal(1 + torch.exp(-x))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) as the reference's JAX
    computes it: ``x * (0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 *
    x**3))))``, each operation rounded in ``x``'s dtype, the constants cast
    to it first (0.044677734375 and 0.796875 in bfloat16) and the cube two
    rounded products (``integer_pow`` is ``x * x * x``). In bfloat16 that
    differs from ``F.gelu(approximate="tanh")`` (one rounding) in about
    two fifths of the elements. The constants are 0-dim CPU tensors: a CUDA
    kernel takes them as values, where a tensor made on the card would be a
    host-to-device copy that waits for the stream at every call."""
    c = torch.tensor(0.044715, dtype=x.dtype)
    s = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype)
    return x * (0.5 * (1 + torch.tanh(s * (x + c * (x * x * x)))))


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, d: int, f: int, activation: str) -> dict:
    if activation == "silu":  # SwiGLU: gate+up+down
        return {"wi_gate": dense_init(gen, d, f), "wi_up": dense_init(gen, d, f),
                "wo": dense_init(gen, f, d)}
    return {"wi": dense_init(gen, d, f), "wo": dense_init(gen, f, d)}  # gelu 2-matrix


def mlp_axes(activation: str) -> dict:
    if activation == "silu":
        return {"wi_gate": ("embed", "mlp"), "wi_up": ("embed", "mlp"), "wo": ("mlp", "embed")}
    return {"wi": ("embed", "mlp"), "wo": ("mlp", "embed")}


def mlp(params: Params, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        g = x @ weight(params["wi_gate"], x)
        u = x @ weight(params["wi_up"], x)
        # F.silu rounds once where jax.nn.silu (layers.silu) rounds each
        # operation in bfloat16; with layers.silu here, reduced zamba2's bf16
        # tail state lands 2.08e-2 · max from the reference's, past the 2e-2
        # of tests/test_torch_hybrid.py (ROADMAP Queue 3, item 18)
        h = F.silu(g) * u
    else:
        h = gelu(x @ weight(params["wi"], x))
    return h @ weight(params["wo"], x)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------


def embedding_axes() -> dict:
    return {"table": ("vocab", "embed")}


def embed(params: Params, tokens: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The table is cast to ``dtype`` before the gather; a ``DTensor`` table
    takes :func:`_embed_split`."""
    table = params["table"].to(dtype)
    if isinstance(table, DTensor):
        return _embed_split(table, tokens)
    return table[tokens]


def _embed_split(table, tokens, book=None):
    """The lookup of ``DTensor`` tokens (laid out over the batch) in a
    ``DTensor`` table: the table gathered over every mesh axis but the one
    that splits its vocabulary (FSDP's gather of its "embed" dim), then on
    each rank the rows of its own vocabulary shard, the others zero: a
    partial sum over that axis, which the caller's ``shard`` reduces (one
    rank adds each row, the rest add zeros: the lookup's values). With
    ``book`` the table is audio's ``(K, Vp, D)``, split over its vocabulary
    (dim 1), the tokens ``(B, S, K)``, and the lookup is codebook ``book``'s
    tokens in its slice of the table."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = table.device_mesh
    vdim = 0 if book is None else 1
    split = [i for i, p in enumerate(table.placements) if p.is_shard(vdim)]
    table = table.redistribute(mesh, [p if p.is_shard(vdim) else Replicate()
                                      for p in table.placements])
    if not split:
        return (F.embedding(tokens, table) if book is None
                else F.embedding(tokens[..., book], table[book]))
    (axis,) = split
    rows = table.shape[vdim] // mesh.size(axis)
    first = mesh.get_local_rank(axis) * rows

    def lookup(t, tok):
        if book is not None:
            t, tok = t[book], tok[..., book]
        idx = tok - first
        inside = ((idx >= 0) & (idx < rows))[..., None]
        return torch.where(inside, t[idx.clamp(0, rows - 1)], torch.zeros((), dtype=t.dtype,
                                                                          device=t.device))

    # the table's gradient: a partial sum over the axes that split the batch
    grad = [p if i == axis else (Partial() if tp.is_shard() else Replicate())
            for i, (p, tp) in enumerate(zip(table.placements, tokens.placements))]
    out = [Partial() if i == axis else p for i, p in enumerate(tokens.placements)]
    return local_map(lookup, out_placements=out,
                     in_placements=(list(table.placements), list(tokens.placements)),
                     in_grad_placements=(grad, list(tokens.placements)),
                     device_mesh=mesh)(table, tokens)


def embed_codebooks(table, tokens) -> torch.Tensor:
    """Audio's embedding: ``table`` (K, Vp, D) already in the compute dtype
    and tokens (B, S, K) -> the sum of the K codebook lookups (B, S, D) in
    the reference's order, its Python ``sum``: ``((0 + e0) + e1) + ...``,
    rounded in the table's dtype at each step. A ``DTensor`` table split
    over its vocabulary looks each codebook up as a masked partial gather
    (:func:`_embed_split`, the table gathered over its other axes once)
    reduced before the sum, so the sum adds the rows themselves in that
    order."""
    K = table.shape[0]
    if not isinstance(table, DTensor):
        return sum(table[i][tokens[..., i]] for i in range(K))
    vocab = [p if p.is_shard(1) else Replicate() for p in table.placements]
    table = table.redistribute(table.device_mesh, vocab)
    out = 0
    for i in range(K):
        out = out + reduced(_embed_split(table, tokens, book=i))
    return out


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ weight(params["table"], x).t()
