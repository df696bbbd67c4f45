"""Attention: GQA projections, flash causal attention for prefill, decode
attention against a KV cache, and the vlm family's cross attention.

The port's copy of ``repro.models.attention``. Prefill attention and every
cross attention (prefill and decode, non-causal, against the image tokens'
K/V) go through :func:`repro_torch.kernels.ops.flash_attention`: the
hand-written CUDA kernel for a tensor on the card, its plain PyTorch
version for one on the CPU. Self-attention's decode step is the
reference's explicit max-subtracted softmax chain in plain PyTorch.

Where JAX returns an updated cache, the port writes the KV rows into the
cache tensors it is given, in place.

Under a mesh (``DTensor`` activations and parameters, model-parallel
training) :func:`qkv_project` lays q, k and v out by heads over the mesh's
"model" axis where ``num_heads`` and ``num_kv_heads`` both divide it, and
replicates them over "model" otherwise (the reference's GSPMD does the
same, silently, where a reshape cannot keep the split); RoPE and the
flash kernels then run on each rank's own rows and heads
(``local_map``), and ``wo`` is the row-parallel product whose partial sum
the residual's ``shard`` reduces. The vlm cross attention does the same
with k and v projected from the image embeddings (:func:`cross_kv`) and no
RoPE.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import BLOCK_KV
from repro_torch.models.layers import apply_rope, dense_init, weight

Params = Mapping[str, torch.Tensor]
KVCache = Tuple[torch.Tensor, torch.Tensor]


def attention_params(gen: torch.Generator, d: int, num_heads: int, num_kv_heads: int, *,
                     qkv_bias: bool = False) -> dict:
    hd = d // num_heads
    p = {
        "wq": dense_init(gen, d, num_heads * hd),
        "wk": dense_init(gen, d, num_kv_heads * hd),
        "wv": dense_init(gen, d, num_kv_heads * hd),
        "wo": dense_init(gen, num_heads * hd, d),
    }
    if qkv_bias:
        dev = gen.device
        p.update(bq=torch.zeros((num_heads * hd,), device=dev),
                 bk=torch.zeros((num_kv_heads * hd,), device=dev),
                 bv=torch.zeros((num_kv_heads * hd,), device=dev))
    return p


def attention_axes(qkv_bias: bool = False) -> dict:
    """The logical axes of :func:`attention_params`' parameters."""
    ax = {"wq": ("embed", "heads"), "wk": ("embed", "kv"), "wv": ("embed", "kv"),
          "wo": ("heads", "embed")}
    if qkv_bias:
        ax.update(bq=("heads",), bk=("kv",), bv=("kv",))
    return ax


def heads_split(mesh, num_heads: int, num_kv_heads: int) -> bool:
    """Whether the heads of q, k and v are split over ``mesh``'s "model"
    axis: only where the axis has more than one rank and divides both head
    counts (smollm-135m's 9 and 3 heads divide no "model" axis of 2 or 4)."""
    names = mesh.mesh_dim_names or ()
    if "model" not in names:
        return False
    m = mesh.shape[names.index("model")]
    return m > 1 and num_heads % m == 0 and num_kv_heads % m == 0


def _by_heads(x, t, split: bool):
    """``t`` (B, S, heads · hd), a product of ``x``, laid out as ``x`` is
    over every mesh axis but "model", where its last dim is split
    (``split``) or replicated."""
    names = x.device_mesh.mesh_dim_names or ()
    placements = [(Shard(t.ndim - 1) if split else Replicate()) if n == "model" else p
                  for n, p in zip(names, x.placements)]
    return t.redistribute(x.device_mesh, placements)


def qkv_project(params: Params, x: torch.Tensor, num_heads: int, num_kv_heads: int):
    d = x.shape[-1]
    hd = d // num_heads
    q = x @ weight(params["wq"], x)
    k = x @ weight(params["wk"], x)
    v = x @ weight(params["wv"], x)
    if "bq" in params:
        q = q + weight(params["bq"], x)
        k = k + weight(params["bk"], x)
        v = v + weight(params["bv"], x)
    B, S = x.shape[:2]
    if isinstance(x, DTensor):
        split = heads_split(x.device_mesh, num_heads, num_kv_heads)
        q, k, v = (_by_heads(x, t, split) for t in (q, k, v))
    return (q.reshape(B, S, num_heads, hd), k.reshape(B, S, num_kv_heads, hd),
            v.reshape(B, S, num_kv_heads, hd))


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float, fraction: float = 1.0):
    """:func:`~repro_torch.models.layers.apply_rope`; on a ``DTensor`` it
    runs on each rank's own rows and heads (``local_map``), ``positions``
    a ``DTensor`` laid out over the batch as ``x`` is."""
    if not isinstance(x, DTensor):
        return apply_rope(x, positions, theta, fraction)
    if not isinstance(positions, DTensor):
        raise TypeError("positions must be a DTensor placed as the batch where the "
                        "activations are DTensors")
    from torch.distributed.tensor.experimental import local_map

    return local_map(lambda t, pos: apply_rope(t, pos, theta, fraction),
                     out_placements=list(x.placements),
                     in_placements=(list(x.placements), list(positions.placements)),
                     device_mesh=x.device_mesh)(x, positions)


def naive_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Full softmax attention, the small-shape oracle. q: (B,Sq,H,hd),
    k/v: (B,Skv,KVH,hd) -> (B,Sq,H,hd). Its causal mask is aligned
    bottom-right (``tril(k=Skv-Sq)``), as the reference's is; for
    ``Sq == Skv`` that equals the top-left mask of :func:`flash_attention`."""
    B, Sq, H, hd = q.shape
    Skv, KVH = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, KVH, H // KVH, hd).float()
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device).tril(Skv - Sq)
        scores = scores.masked_fill(~mask, float("-inf"))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, block_kv: int = BLOCK_KV,
                    backend: Optional[str] = None) -> torch.Tensor:
    """Online-softmax attention, O(S·block) memory: the ported kernel.

    q: (B,Sq,H,hd), k/v: (B,Skv,KVH,hd). The causal mask is top-left
    aligned, which is the usual causal mask for ``Sq == Skv`` (prefill).
    ``backend`` is :func:`repro_torch.kernels.ops.flash_attention`'s:
    ``None`` lets the tensor's device decide. The reference scales q in its
    own dtype before the float32 cast; the kernel casts first, as the Pallas
    kernel does, which differs by one rounding of q at bfloat16.
    """
    return ops.flash_attention(q, k, v, causal=causal, backend=backend, block_kv=block_kv)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """q: (B,1,H,hd); caches: (B,S,KVH,hd); pos: a () shared current length
    or (B,) per-row lengths. Each row attends to cache rows ``<= pos``."""
    B, _, H, hd = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    qg = (q.reshape(B, KVH, G, hd) / math.sqrt(hd)).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.float())
    # (1,S) or (B,S) mask of positions filled so far
    pos = torch.as_tensor(pos, device=q.device)
    valid = torch.arange(S, device=q.device)[None, :] <= pos.reshape(-1, 1)
    s = s.masked_fill(~valid[:, None, None, :], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh", p / l, v_cache.float())
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _write_decode_rows(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write this step's (B,1,KVH,hd) rows into the (B,S,KVH,hd) cache at
    ``pos``, in place. A () position writes every row there, clamped to the
    last row as ``dynamic_update_slice`` clamps; with a (B,) vector, a row at
    ``pos >= S`` writes nothing (a parked slot stays as it is)."""
    new = new[:, 0].to(cache.dtype)
    S = cache.shape[1]
    if not isinstance(pos, torch.Tensor) or pos.dim() == 0:
        p = min(max(int(pos), 0), S - 1)
        cache[:, p] = new
        return
    rows = torch.arange(cache.shape[0], device=cache.device)
    at = pos.clamp(max=S - 1)
    keep = (pos < S)[:, None, None]
    cache[rows, at] = torch.where(keep, new, cache[rows, at])


# ---------------------------------------------------------------------------
# Cross attention (vlm): queries from the text stream, K/V from image embeddings
# ---------------------------------------------------------------------------


def init_cross_attention(gen: torch.Generator, d: int, num_heads: int,
                         num_kv_heads: int) -> dict:
    """Attention parameters with no bias."""
    return attention_params(gen, d, num_heads, num_kv_heads)


def cross_kv(params: Params, ctx: torch.Tensor, num_heads: int, num_kv_heads: int, d: int):
    """Project image embeddings to the cross K/V. ctx: (B, T, D) -> k, v,
    each (B, T, KVH, hd), in ``ctx.dtype``. Under a mesh (``ctx`` a
    ``DTensor`` laid out over the batch) k and v are split by KV heads over
    "model" where :func:`heads_split` allows, replicated over it otherwise,
    as :func:`qkv_project` lays out the self-attention's."""
    hd = d // num_heads
    B, T = ctx.shape[:2]
    k = ctx @ weight(params["wk"], ctx)
    v = ctx @ weight(params["wv"], ctx)
    if isinstance(ctx, DTensor):
        split = heads_split(ctx.device_mesh, num_heads, num_kv_heads)
        k, v = (_by_heads(ctx, t, split) for t in (k, v))
    return k.reshape(B, T, num_kv_heads, hd), v.reshape(B, T, num_kv_heads, hd)


def cross_attention_kv(params: Params, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       num_heads: int, *, block_kv: int = BLOCK_KV,
                       backend: Optional[str] = None) -> torch.Tensor:
    """Cross attention against precomputed (cached) K/V: q from ``wq`` with
    no RoPE, non-causal flash attention over every image token (at Sq = 1
    in a decode step), then ``wo``. k, v are cast to ``x.dtype``. Under a
    mesh q is laid out by heads as :func:`cross_kv` lays out k and v, the
    flash kernels run on each rank's own rows and heads (Sq text queries
    against Skv image keys), and ``wo`` is the row-parallel product."""
    B, S, d = x.shape
    hd = d // num_heads
    q = x @ weight(params["wq"], x)
    if isinstance(x, DTensor):
        q = _by_heads(x, q, heads_split(x.device_mesh, num_heads, k.shape[2]))
    q = q.reshape(B, S, num_heads, hd)
    out = flash_attention(q, k.to(x.dtype), v.to(x.dtype), causal=False, block_kv=block_kv,
                          backend=backend)
    out = out.reshape(B, S, num_heads * hd)
    if isinstance(out, DTensor):
        out = _by_heads(out, out, True)
    return out @ weight(params["wo"], x)


def cross_attention(params: Params, x: torch.Tensor, ctx: torch.Tensor, num_heads: int,
                    num_kv_heads: int, *, block_kv: int = BLOCK_KV,
                    backend: Optional[str] = None) -> torch.Tensor:
    """x: (B, S, D) text stream; ctx: (B, T, D) precomputed image embeddings."""
    k, v = cross_kv(params, ctx, num_heads, num_kv_heads, x.shape[-1])
    return cross_attention_kv(params, x, k, v, num_heads, block_kv=block_kv, backend=backend)


def attention_block(
    params: Params,
    x: torch.Tensor,
    positions: torch.Tensor,
    num_heads: int,
    num_kv_heads: int,
    *,
    rope_theta: float,
    rope_fraction: float = 1.0,
    causal: bool = True,
    block_kv: int = BLOCK_KV,
    backend: Optional[str] = None,
    kv_cache: Optional[KVCache] = None,
    cache_pos=None,
) -> torch.Tensor:
    """Self-attention with its QKV and output projections.

    Under a mesh (``x`` a ``DTensor``) only the forward without a cache
    (training) runs; ``positions`` is then a ``DTensor`` placed as the batch.

    Modes:
      - prefill / forward (``cache_pos`` None): flash attention over the
        sequence; with ``kv_cache`` given, the RoPE'd k/v are written into
        its rows ``[0, S)`` in the cache dtype.
      - decode (``kv_cache`` and ``cache_pos`` given): one-token step.
        ``cache_pos`` is a () scalar shared by every row, or a (B,) vector
        of per-row positions; this step's k/v are written at each row's
        position (nothing for a row at ``pos >= S``), then the row attends
        to cache rows ``<= pos``.
    """
    B, S, d = x.shape
    if isinstance(x, DTensor) and kv_cache is not None:
        raise ValueError("a KV cache under a mesh is not ported: model-parallel training "
                         "runs without one")
    q, k, v = qkv_project(params, x, num_heads, num_kv_heads)
    q = rope(q, positions, rope_theta, rope_fraction)
    k = rope(k, positions, rope_theta, rope_fraction)

    if kv_cache is not None and cache_pos is not None:
        k_cache, v_cache = kv_cache
        _write_decode_rows(k_cache, k, cache_pos)
        _write_decode_rows(v_cache, v, cache_pos)
        out = decode_attention(q, k_cache, v_cache, cache_pos)
    else:
        out = flash_attention(q, k, v, causal=causal, block_kv=block_kv, backend=backend)
        if kv_cache is not None:
            k_cache, v_cache = kv_cache
            k_cache[:, :S] = k.to(k_cache.dtype)
            v_cache[:, :S] = v.to(v_cache.dtype)

    hd = d // num_heads
    out = out.reshape(B, S, num_heads * hd)
    if isinstance(out, DTensor):
        # wo's input split by heads over "model" (a local chunk where the
        # heads were replicated): the row-parallel product's gradient then
        # comes back through this redistribution in the heads' own layout,
        # never split where the heads cannot be
        out = _by_heads(out, out, True)
    return out @ weight(params["wo"], x)
