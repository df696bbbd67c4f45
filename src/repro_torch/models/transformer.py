"""The model stack: ``Model`` / ``build_model``, for all six families.

The port's copy of ``repro.models.transformer``. The layer layouts:

* ``dense`` and ``audio`` (musicgen-large): uniform ``[attn + mlp] x L``,
  a KV cache; audio embeds ``K = num_codebooks`` token streams (the sum
  of K table lookups) and returns ``(B, S, K, V)`` logits;
* ``moe`` with ``moe_every == 1`` (dbrx-132b): uniform ``[attn + moe] x L``;
  with ``moe_every == 2`` (llama4-maverick): ``L / 2`` groups
  ``{dense, moe_l}``, a dense layer followed by an moe layer;
* ``vlm`` (llama-3.2-vision-90b): ``NG = L // ce`` groups of ``ce - 1 =
  cross_attn_every - 1`` self-attention layers (``selfs``) and one
  cross-attention layer (``cross``) whose K/V are projected from the image
  embeddings (``image_embeds=``, cast to the compute dtype);
* ``hybrid`` (zamba2-1.2b): ``NG = L // ke`` groups of ``ke =
  hybrid_attn_every`` Mamba2 blocks, each group followed by the one
  **shared** attention + MLP block (one set of weights, its own KV cache
  in every group), then ``L % ke`` tail Mamba2 blocks;
* ``ssm`` (xlstm-350m): ``L / 2`` pairs ``[mLSTM, sLSTM]``, a recurrent state.

``Model`` is an ``nn.Module`` whose parameters keep the JAX package's names
and layouts: ``embed.table`` ``(V, D)`` (audio: ``(K, V, D)``, and so
``unembed.table``), ``ln_f.scale``, and per block
``blocks.<l>.{ln1,attn,ln2,mlp|moe}.<leaf>`` (dense, audio, moe every
layer), ``blocks.<g>.{dense,moe_l}.<...>`` (moe every other layer),
``blocks.<g>.selfs.<i>.<...>`` and ``blocks.<g>.cross.{ln1,attn,ln2,mlp}.<leaf>``
(vlm; the cross ``attn`` has no qkv bias),
``blocks.<g>.<i>.{ln,mamba}.<leaf>``, ``tail.<r>.{ln,mamba}.<leaf>`` and
``shared_attn.<...>`` (hybrid) or ``blocks.<g>.{ln_m,mlstm,ln_s,slstm}.<leaf>``
(ssm): a JAX leaf of the stacked ``blocks`` (``tail``) pytree cut at its
stacked axes (:func:`repro_torch.convert.model_params_to_port`). Parameters
are float32 (bfloat16 once a train state on bf16 masters casts them,
:func:`repro_torch.train.optimizer.cast_params`) and every product casts
them to the compute dtype, as the reference does.

The cache is a flat tuple of tensors, the reference's cache pytree in
``jax.tree.leaves`` order:

* dense, audio, moe every layer: ``(k, v)``, each ``(L, B, max_seq, KVH, hd)``;
* moe every other layer: ``dense.k, dense.v, moe_l.k, moe_l.v``, each
  ``(L/2, B, max_seq, KVH, hd)``;
* vlm (dict keys sort, so the cross leaves come first): ``cross.k,
  cross.v``, each ``(NG, B, T, KVH, hd)`` with ``T = num_image_tokens``,
  then ``selfs.k, selfs.v``, each ``(NG, ce-1, B, max_seq, KVH, hd)``; a
  prefill writes the cross K/V in the cache dtype, a decode step reads
  them cast to the compute dtype;
* hybrid: ``groups.attn`` k and v, each ``(NG, B, max_seq, KVH, hd)``;
  ``groups.mamba.conv (NG, ke, B, W-1, C)`` and ``groups.mamba.ssd (NG,
  ke, B, H, N, P)``; then, with a tail, ``tail.conv (rem, B, W-1, C)`` and
  ``tail.ssd (rem, B, H, N, P)``; the Mamba2 states are float32 whatever
  the cache dtype;
* ssm: the seven float32 leaves of the reference's state pytree
  (:data:`repro_torch.models.xlstm.STATE_LEAVES`: mLSTM ``C (NG, B, H, hd,
  hd)``, ``m (NG, B, H)``, ``n (NG, B, H, hd)``; sLSTM ``c, h, m, n``, each
  ``(NG, B, H, hd)``), stacked over the ``NG = L / 2`` pairs.

The slot (batch) axis is 1, except on the hybrid group Mamba2 leaves and
the vlm ``selfs`` leaves, where it is 2
(:func:`repro_torch.serve.kvcache.batch_axes` finds it).
Prefill and decode write into the cache they are given, in place, where
JAX returns a new one. The moe load-balance loss is computed by
:func:`repro_torch.models.moe.moe_forward`; serving drops it, training sums
it over the moe layers (:meth:`Block.forward_train`).

Training (:meth:`Model.loss`, :meth:`Model.forward_train`) is ported for all
six families: the full-sequence forward with
grad, each layer (ssm: each ``[mLSTM, sLSTM]`` pair; hybrid: each Mamba2
block and each use of the shared block; moe every other layer: the dense
and the moe layer of a group each; vlm: each self layer and each cross
layer) recomputed in the backward under ``CallConfig.remat == "block"`` (the
reference's ``jax.checkpoint`` per scanned layer, pair or group), the
attention (the vlm cross layers' too, non-causal against the image tokens)
differentiated through :class:`repro_torch.kernels.ops.FlashAttention`, the
sLSTM recurrence through :class:`repro_torch.kernels.ops.SLSTMFused`, the
Mamba2 / SSD chunk loop, the moe dispatch, experts and load-balance loss
and the audio codebook lookups and unembeddings by autograd.
``model.requires_grad_()``
makes the parameters trainable; the tied ``embed.table`` is one parameter.
``forward``, ``prefill`` and ``decode_step`` run under ``no_grad`` whatever
that flag says.

Model-parallel training (tensor parallelism and FSDP; the dense, audio, vlm
and moe families) runs on ``DTensor``:
:func:`repro_torch.parallel.sharding.place_params` places the parameters by
the logical axes of :meth:`Model.axes_tree` (the reference's tree,
stacked), ``CallConfig.shard_fn``
(:func:`repro_torch.parallel.sharding.make_shard_fn`) redistributes the
activations at the reference's call sites (``CallConfig.shard``: the
embedding, the residual after each block, the logits, and the moe
dispatch's buffers in :func:`repro_torch.models.moe.moe_forward`), and
:meth:`Model.loss` places the batch (the vlm image embeddings too) by
``batch_shardings`` and keeps the logits split over the vocabulary (audio:
the ``(B, S, K, V)`` logits over ``V``). The hybrid and ssm families' train
forward, and serving, refuse a mesh (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import resolve_device
from repro_torch.kernels.flash_attention import BLOCK_KV
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import (embed, embed_codebooks, embedding_axes, make_norm, mlp,
                                      mlp_axes, mlp_params, norm_axes, norm_params, reduced,
                                      unembed, weight)
from repro_torch.parallel.sharding import device_collectives

Cache = Tuple[torch.Tensor, ...]  # the reference's cache leaves (see the module docstring)
FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "audio")  # the reference's layer layouts
REMAT = ("none", "block")
MESH_REFUSED = ("hybrid", "ssm")  # families whose model-parallel training is not ported


@dataclass(frozen=True)
class CallConfig:
    """Per-call (not per-arch) knobs."""

    dp_size: int = 1                        # dispatch groups of the moe layers
    block_kv: int = BLOCK_KV                # the flash kernel's KV tile (built for one only)
    compute_dtype: torch.dtype = torch.bfloat16
    cache_dtype: torch.dtype = torch.bfloat16
    # the prefill's kernels (attention, the sLSTM recurrence): None lets the
    # tensors' device decide (the CUDA kernel on the card), "ref" runs the
    # plain version (repro_torch.kernels.ops)
    kernel_backend: Optional[str] = None
    # training: "block" recomputes each layer in the backward (the
    # reference's default), "none" keeps every activation
    remat: str = "block"
    # (x, logical axes) -> x laid out on the mesh of model-parallel
    # training (repro_torch.parallel.sharding.make_shard_fn); None in one process
    shard_fn: Optional[Callable] = None

    def shard(self, x, axes: Tuple):
        return self.shard_fn(x, axes) if self.shard_fn is not None else x


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in d.items()})


def _moe_every(cfg: ArchConfig) -> int:
    """1 for every family but moe; the moe layout's period, 1 or 2."""
    every = cfg.moe.moe_every if cfg.family == "moe" else 1
    if every not in (1, 2):
        raise ValueError(f"moe_every={every}; moe_every in {{1,2}} supported")
    return every


class Block(nn.Module):
    """One decoder layer: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``, or
    ``x + moe(ln2(x))`` for an moe layer. A vlm cross layer (``cross``) has
    no qkv bias and attends to image K/V (:meth:`forward_cross`)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator, *, is_moe_layer: bool = False,
                 cross: bool = False):
        super().__init__()
        dev = gen.device
        self.ln1 = _params(norm_params(cfg.norm, cfg.d_model, dev))
        if cross:
            self.attn = _params(attn_lib.init_cross_attention(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads))
        else:
            self.attn = _params(attn_lib.attention_params(
                gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, qkv_bias=cfg.qkv_bias))
        self.is_moe_layer = is_moe_layer and cfg.d_ff > 0
        if cfg.d_ff > 0:
            self.ln2 = _params(norm_params(cfg.norm, cfg.d_model, dev))
            if self.is_moe_layer:
                self.moe = _params(moe_lib.init_moe(gen, cfg.d_model, cfg.d_ff,
                                                    cfg.moe.num_experts, ep_split=cfg.moe.ep_split))
            else:
                self.mlp = _params(mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.activation))

    def forward(self, x, positions, cfg: ArchConfig, cc: CallConfig,
                cache: Optional[Cache] = None, cache_pos=None):
        return self._ffn(self._self_attn(x, positions, cfg, cc, cache, cache_pos), cfg, cc)[0]

    def forward_train(self, x, positions, cfg: ArchConfig, cc: CallConfig):
        """The whole sequence without a cache (training): ``(x, aux)``,
        ``aux`` the moe layer's float32 load-balance loss, None for a layer
        without one (the reference's zero, which adds nothing)."""
        return self._ffn(self._self_attn(x, positions, cfg, cc), cfg, cc)

    def _self_attn(self, x, positions, cfg: ArchConfig, cc: CallConfig, cache=None,
                   cache_pos=None):
        """``x + attn(ln1(x))``, writing the layer's KV rows into ``cache`` if given."""
        return cc.shard(x + attn_lib.attention_block(
            self.attn, make_norm(cfg.norm)(self.ln1, x), positions, cfg.num_heads,
            cfg.num_kv_heads, rope_theta=cfg.rope_theta, rope_fraction=cfg.rope_fraction,
            block_kv=cc.block_kv, backend=cc.kernel_backend, kv_cache=cache, cache_pos=cache_pos),
            ("batch", "seq", "embed"))

    def forward_cross(self, x, k, v, cfg: ArchConfig, cc: CallConfig):
        """The cross layer: ``x + cross_attn(ln1(x); k, v)`` against image
        K/V ``(B, T, KVH, hd)`` (cast to ``x.dtype``), then the MLP."""
        y = attn_lib.cross_attention_kv(self.attn, make_norm(cfg.norm)(self.ln1, x), k, v,
                                        cfg.num_heads, block_kv=cc.block_kv,
                                        backend=cc.kernel_backend)
        return self._ffn(cc.shard(x + y, ("batch", "seq", "embed")), cfg, cc)[0]

    def forward_cross_train(self, x, ctx, cfg: ArchConfig, cc: CallConfig):
        """The cross layer over the whole sequence without a cache
        (training): its K/V projected from the image context ``ctx`` (B, T,
        D) by :func:`~repro_torch.models.attention.cross_kv`, then
        :meth:`forward_cross`, so that ``wk`` and ``wv`` get their gradient
        through the projection."""
        k, v = attn_lib.cross_kv(self.attn, ctx, cfg.num_heads, cfg.num_kv_heads, cfg.d_model)
        return self.forward_cross(x, k, v, cfg, cc)

    def _ffn(self, x, cfg: ArchConfig, cc: CallConfig):
        """``(x + mlp(ln2(x)), None)``, or ``(x + moe(ln2(x)), aux)``, where
        the layer has a feed-forward part; ``(x, None)`` where it has none."""
        aux = None
        if cfg.d_ff > 0:
            h = make_norm(cfg.norm)(self.ln2, x)
            if self.is_moe_layer:
                moe = cfg.moe
                y, aux = moe_lib.moe_forward(
                    self.moe, h, top_k=moe.top_k, num_experts=moe.num_experts,
                    capacity_factor=moe.capacity_factor, dp_size=cc.dp_size,
                    shard_fn=cc.shard_fn, ep_split=moe.ep_split)
            else:
                y = mlp(self.mlp, h, cfg.activation)
            x = cc.shard(x + y, ("batch", "seq", "embed"))
        return x, aux


class MoEGroup(nn.Module):
    """One group of the ``moe_every == 2`` layout: a dense layer, then an
    moe layer."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.dense = Block(cfg, gen)
        self.moe_l = Block(cfg, gen, is_moe_layer=True)


class VLMGroup(nn.Module):
    """One vlm group: ``cross_attn_every - 1`` self-attention layers
    (``selfs``), then a cross-attention layer (``cross``)."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        self.selfs = nn.ModuleList(Block(cfg, gen) for _ in range(cfg.cross_attn_every - 1))
        self.cross = Block(cfg, gen, cross=True)


class MambaBlock(nn.Module):
    """One hybrid Mamba2 block: ``x + mamba(ln(x))``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        s = cfg.ssm
        self.ln = _params(norm_params(cfg.norm, cfg.d_model, gen.device))
        self.mamba = _params(ssm_lib.init_mamba2(
            gen, cfg.d_model, expand=s.expand, head_dim=s.head_dim, state_dim=s.state_dim,
            conv_width=s.conv_width))

    def forward(self, x, cfg: ArchConfig, cc: CallConfig, *, return_state: bool):
        """The whole sequence from the zero state; returns ``x`` and, with
        ``return_state``, the block's decode state (else None)."""
        h = make_norm(cfg.norm)(self.ln, x)
        if return_state:
            y, st = ssm_lib.mamba2_forward(self.mamba, h, cfg, return_state=True)
        else:
            y, st = ssm_lib.mamba2_forward(self.mamba, h, cfg), None
        return cc.shard(x + y, ("batch", "seq", "embed")), st

    def forward_train(self, x, cfg: ArchConfig, cc: CallConfig):
        """The whole sequence from the zero state, the state dropped (training)."""
        return self(x, cfg, cc, return_state=False)[0]

    def step(self, x, cfg: ArchConfig, state):
        """One token from the block's state; returns ``x`` and the new state."""
        y, st = ssm_lib.mamba2_decode_step(self.mamba, make_norm(cfg.norm)(self.ln, x), state,
                                           cfg)
        return x + y, st


class XLSTMPair(nn.Module):
    """One ssm group: ``x + mlstm(ln_m(x))``, then ``x + slstm(ln_s(x))``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        dev = gen.device
        self.ln_m = _params(norm_params(cfg.norm, cfg.d_model, dev))
        self.mlstm = _params(xlstm_lib.init_mlstm(gen, cfg.d_model, cfg.num_heads))
        self.ln_s = _params(norm_params(cfg.norm, cfg.d_model, dev))
        self.slstm = _params(xlstm_lib.init_slstm(gen, cfg.d_model, cfg.num_heads))

    def forward(self, x, cfg: ArchConfig, cc: CallConfig):
        """The whole sequence from the zero state; returns ``x`` and the
        pair's final states (mLSTM, sLSTM)."""
        norm = make_norm(cfg.norm)
        ym, st_m = xlstm_lib.mlstm_forward(self.mlstm, norm(self.ln_m, x), cfg.num_heads,
                                           return_state=True)
        x = cc.shard(x + ym, ("batch", "seq", "embed"))
        ys, st_s = xlstm_lib.slstm_forward(self.slstm, norm(self.ln_s, x), cfg.num_heads,
                                           return_state=True, backend=cc.kernel_backend)
        return cc.shard(x + ys, ("batch", "seq", "embed")), st_m, st_s

    def forward_train(self, x, cfg: ArchConfig, cc: CallConfig):
        """The whole sequence from the zero state, states dropped (training)."""
        norm = make_norm(cfg.norm)
        x = cc.shard(x + xlstm_lib.mlstm_forward(self.mlstm, norm(self.ln_m, x), cfg.num_heads),
                     ("batch", "seq", "embed"))
        return cc.shard(x + xlstm_lib.slstm_forward(self.slstm, norm(self.ln_s, x),
                                                    cfg.num_heads, backend=cc.kernel_backend),
                        ("batch", "seq", "embed"))

    def step(self, x, cfg: ArchConfig, st_m, st_s):
        """One token from the pair's states; returns ``x`` and the new states."""
        norm = make_norm(cfg.norm)
        ym, st_m = xlstm_lib.mlstm_decode_step(self.mlstm, norm(self.ln_m, x), st_m,
                                               cfg.num_heads)
        x = x + ym
        ys, st_s = xlstm_lib.slstm_decode_step(self.slstm, norm(self.ln_s, x), st_s,
                                               cfg.num_heads)
        return x + ys, st_m, st_s


def block_axes(cfg: ArchConfig, *, is_moe_layer: bool = False, cross: bool = False) -> dict:
    """The logical axes of one :class:`Block`'s parameters."""
    norm = norm_axes(cfg.norm)
    ax = {"ln1": norm, "attn": attn_lib.attention_axes(cfg.qkv_bias and not cross)}
    if cfg.d_ff > 0:
        ax["ln2"] = norm
        if is_moe_layer:
            ax["moe"] = moe_lib.moe_axes(cfg.moe.ep_split)
        else:
            ax["mlp"] = mlp_axes(cfg.activation)
    return ax


def _stacked(tree) -> dict:
    """Every leaf's axes led by one more stacked "layers" axis."""
    if isinstance(tree, dict):
        return {k: _stacked(v) for k, v in tree.items()}
    return ("layers",) + tuple(tree)


def axes_tree(cfg: ArchConfig) -> dict:
    """The logical axes of every parameter of an ``cfg`` model, in the
    reference's stacked tree (``repro.models.transformer.Model.axes_tree``):
    a leaf of the stacked ``blocks`` (``tail``) pytree led by one
    ``"layers"`` per stacked axis, audio's tables ``(None, "vocab",
    "embed")``. Built from the config: nothing is allocated."""
    fam = cfg.family
    if cfg.num_codebooks:
        table = {"table": (None, "vocab", "embed")}
    else:
        table = embedding_axes()
    ax = {"embed": table, "ln_f": norm_axes(cfg.norm)}
    if not cfg.tie_embeddings:
        ax["unembed"] = dict(table)
    if fam == "ssm":
        norm = norm_axes(cfg.norm)
        ax["blocks"] = _stacked({"ln_m": norm, "mlstm": xlstm_lib.mlstm_axes(), "ln_s": norm,
                                 "slstm": xlstm_lib.slstm_axes()})
    elif fam == "hybrid":
        mamba = {"ln": norm_axes(cfg.norm), "mamba": ssm_lib.mamba2_axes()}
        ax["blocks"] = _stacked(_stacked(mamba))
        if cfg.num_layers % cfg.hybrid_attn_every:
            ax["tail"] = _stacked(mamba)
        ax["shared_attn"] = block_axes(cfg)
    elif fam == "vlm":
        ax["blocks"] = _stacked({"selfs": _stacked(block_axes(cfg)),
                                 "cross": block_axes(cfg, cross=True)})
    elif _moe_every(cfg) == 2:
        ax["blocks"] = _stacked({"dense": block_axes(cfg),
                                 "moe_l": block_axes(cfg, is_moe_layer=True)})
    else:
        ax["blocks"] = _stacked(block_axes(cfg, is_moe_layer=fam == "moe"))
    return ax


def cache_paths(cfg: ArchConfig) -> Tuple[str, ...]:
    """The reference's key path (``jax.tree_util.keystr``) of each leaf of
    an ``cfg`` model's cache, in the order of the port's flat cache tuple
    (the module docstring)."""
    kv = ("[0]", "[1]")
    if cfg.family == "ssm":
        return tuple("".join(f"['{k}']" for k in leaf.split("."))
                     for leaf in xlstm_lib.STATE_LEAVES)
    if cfg.family == "vlm":
        return tuple(f"['{g}']{i}" for g in ("cross", "selfs") for i in kv)
    if cfg.family == "hybrid":
        paths = tuple(f"['groups']['attn']{i}" for i in kv) + tuple(
            f"['groups']['mamba']['{k}']" for k in ("conv", "ssd"))
        if cfg.num_layers % cfg.hybrid_attn_every:
            paths += tuple(f"['tail']['{k}']" for k in ("conv", "ssd"))
        return paths
    if _moe_every(cfg) == 2:
        return tuple(f"['{g}']{i}" for g in ("dense", "moe_l") for i in kv)
    return kv


def _replicated(t: torch.Tensor, mesh) -> DTensor:
    """A plain tensor, the same on every rank, as a ``DTensor`` replicated on ``mesh``."""
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _codebook_logits(x, tabs):
    """Audio's unembedding ``einsum("bsd,kvd->bskv")`` of x (B, S, D) and the
    tables (K, Vp, D) in ``x``'s dtype. ``DTensor`` s (x laid out over the
    batch, the tables split over the vocabulary and gathered over the
    batch's axes) multiply on each rank's own rows and vocabulary columns
    (``local_map``): the logits come back split over ``V`` and nothing is
    gathered; x's gradient is a partial sum over the vocabulary's axis, the
    tables' over the batch's."""
    if not isinstance(x, DTensor):
        return torch.einsum("bsd,kvd->bskv", x, tabs)
    from torch.distributed.tensor import Partial, Shard
    from torch.distributed.tensor.experimental import local_map

    xp, tp = list(x.placements), list(tabs.placements)
    if any(not (p.is_replicate() or p.is_shard(0)) for p in xp) or any(
            not (p.is_replicate() or p.is_shard(1)) for p in tp):
        raise ValueError(f"audio's logits take x split over the batch and the tables over the "
                         f"vocabulary, not {xp} and {tp}")
    out = [Shard(3) if t.is_shard(1) else a for a, t in zip(xp, tp)]
    xgrad = [Partial() if t.is_shard(1) else a for a, t in zip(xp, tp)]
    tgrad = [Partial() if a.is_shard(0) else t for a, t in zip(xp, tp)]
    return local_map(lambda a, t: torch.einsum("bsd,kvd->bskv", a, t), out_placements=out,
                     in_placements=(xp, tp), in_grad_placements=(xgrad, tgrad),
                     device_mesh=x.device_mesh)(x, tabs)


def _target_logit(lf, targets):
    """Each position's logit of its target: ``lf`` (B, S, V) and ``targets``
    (B, S). Logits split over the vocabulary take a masked partial gather:
    each rank gathers the targets in its own columns, the rest zero, and the
    (B, S) partial sums are reduced; no logits move, forward or backward."""
    if not isinstance(lf, DTensor) or not any(p.is_shard(lf.ndim - 1) for p in lf.placements):
        return reduced(lf.gather(-1, targets[..., None]))[..., 0]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mesh = lf.device_mesh
    (axis,) = [i for i, p in enumerate(lf.placements) if p.is_shard(lf.ndim - 1)]
    cols = lf.shape[-1] // mesh.size(axis)
    first = mesh.get_local_rank(axis) * cols

    def pick(logits, tgt):
        idx = tgt - first
        got = logits.gather(-1, idx.clamp(0, cols - 1)[..., None])[..., 0]
        return torch.where((idx >= 0) & (idx < cols), got,
                           torch.zeros((), dtype=got.dtype, device=got.device))

    out = [Partial() if i == axis else p for i, p in enumerate(targets.placements)]
    return reduced(local_map(pick, out_placements=out,
                              in_placements=(list(lf.placements), list(targets.placements)),
                              in_grad_placements=(list(lf.placements), list(targets.placements)),
                              device_mesh=mesh)(lf, targets))


def _write_ssm_states(cache: Cache, g: int, st_m, st_s) -> None:
    """Write pair ``g``'s new states into every cache leaf, in place."""
    for dst, src in zip(cache, xlstm_lib.state_leaves(st_m, st_s)):
        dst[g].copy_(src)


def _write_mamba_state(conv: torch.Tensor, ssd: torch.Tensor, st) -> None:
    """Write one Mamba2 block's state into its cache slices, in place."""
    conv.copy_(st["conv"])
    ssd.copy_(st["ssd"])


class Model(nn.Module):
    """Model facade: init / init_cache / forward / prefill / decode_step.

    ``device=None`` is the card; the parameters live there, drawn once from
    ``seed`` (:meth:`init` redraws them).
    """

    def __init__(self, cfg: ArchConfig, cc: Optional[CallConfig] = None, *, device=None,
                 seed: int = 0):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}; known: {FAMILIES}")
        _moe_every(cfg)
        if (cc or CallConfig()).remat not in REMAT:
            raise ValueError(f"remat={(cc or CallConfig()).remat!r}; expected one of {REMAT}")
        self.cfg = cfg
        self.cc = cc or CallConfig()
        self.device = resolve_device(device)
        # vocab padded to a multiple of 128, as the reference pads it; the
        # padded logit columns are masked to -1e30 in _logits
        self.padded_vocab = ((cfg.vocab_size + 127) // 128) * 128 \
            if cfg.vocab_size % 128 else cfg.vocab_size
        self.init(seed)

    def init(self, seed: int) -> "Model":
        """(Re)draw every parameter from a ``torch.Generator`` seeded with
        ``seed`` on the model's device: dense weights normal / sqrt(fan_in),
        embeddings normal * 0.02, norm scales 1. Returns the model."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        shape = (self.padded_vocab, cfg.d_model)
        if cfg.num_codebooks:  # one table per codebook
            shape = (cfg.num_codebooks,) + shape
        table = lambda: torch.randn(shape, generator=gen, device=self.device) * 0.02  # noqa: E731
        self.embed = _params({"table": table()})
        self.ln_f = _params(norm_params(cfg.norm, cfg.d_model, self.device))
        if not cfg.tie_embeddings:
            self.unembed = _params({"table": table()})
        fam = cfg.family
        if fam == "ssm":
            self.blocks = nn.ModuleList(XLSTMPair(cfg, gen) for _ in range(cfg.num_layers // 2))
        elif fam == "hybrid":
            ke = cfg.hybrid_attn_every
            ng, rem = divmod(cfg.num_layers, ke)
            self.blocks = nn.ModuleList(
                nn.ModuleList(MambaBlock(cfg, gen) for _ in range(ke)) for _ in range(ng))
            if rem:
                self.tail = nn.ModuleList(MambaBlock(cfg, gen) for _ in range(rem))
            self.shared_attn = Block(cfg, gen)
        elif fam == "vlm":
            self.blocks = nn.ModuleList(
                VLMGroup(cfg, gen) for _ in range(cfg.num_layers // cfg.cross_attn_every))
        elif _moe_every(cfg) == 2:
            self.blocks = nn.ModuleList(MoEGroup(cfg, gen) for _ in range(cfg.num_layers // 2))
        else:
            self.blocks = nn.ModuleList(Block(cfg, gen, is_moe_layer=fam == "moe")
                                        for _ in range(cfg.num_layers))
        return self

    def axes_tree(self) -> dict:
        """The logical axes of the parameters, the reference's stacked tree
        (:func:`axes_tree`)."""
        return axes_tree(self.cfg)

    # -------------------- model-parallel training --------------------
    def _placed(self) -> bool:
        return isinstance(self.embed["table"], DTensor)

    def _train_mesh(self):
        """The mesh of model-parallel training (``CallConfig.shard_fn``'s, or
        the placed parameters'), or None in one process. The hybrid and ssm
        families refuse a mesh; a mesh of more than one rank needs the
        parameters placed (``place_params``)."""
        from repro_torch.parallel.sharding import mesh_size

        placed = self._placed()
        mesh = getattr(self.cc.shard_fn, "mesh", None)
        if mesh is None and placed:
            mesh = self.embed["table"].device_mesh
        if mesh is None or not (placed or mesh_size(mesh) > 1):
            return None
        if self.cfg.family in MESH_REFUSED:
            raise ValueError(f"model-parallel training of the {self.cfg.family} family is not "
                             f"ported (ROADMAP.md, Queue 1, item 6: the dense, audio, vlm and moe "
                             f"families only); train it in one process, or data-parallel through "
                             f"grad_transform")
        if not placed:
            raise ValueError(f"a mesh of {mesh_size(mesh)} ranks needs the parameters placed "
                             f"on it: call repro_torch.parallel.sharding.place_params first")
        return mesh

    def _place_batch(self, t: torch.Tensor, mesh):
        """A batch tensor (the same on every rank) placed by ``batch_shardings``
        under ``CallConfig.shard_fn``'s rules (``act_rules(mesh)`` without)."""
        from repro_torch.parallel.sharding import act_rules, batch_shardings

        if isinstance(t, DTensor):
            return t
        rules = getattr(self.cc.shard_fn, "rules", None) or act_rules(mesh)
        return batch_shardings(rules, t).place(t.contiguous())

    def _refuse_placed(self, what: str) -> None:
        if self._placed():
            raise ValueError(f"{what} of a model placed on a mesh is not ported: model-parallel "
                             f"training runs forward_train and loss only")

    # -------------------- embedding / logits --------------------
    def _embed_tokens(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens, or (B, S, K) for audio, -> (B, S, D) in the compute
        dtype. Audio sums the K codebook lookups in the reference's order
        (:func:`~repro_torch.models.layers.embed_codebooks`)."""
        cfg, dt = self.cfg, self.cc.compute_dtype
        if cfg.num_codebooks:
            x = embed_codebooks(self.embed["table"].to(dt), tokens)  # (K, Vp, D) table
        else:
            x = embed(self.embed, tokens, dt)
        return self.cc.shard(x, ("batch", "seq", "embed"))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, V) logits, or (B, S, K, V) for audio (one unembedding per
        codebook), in ``x``'s dtype; padded vocab columns masked to -1e30.
        Under a mesh they stay split over the vocabulary."""
        cfg = self.cfg
        x = make_norm(cfg.norm)(self.ln_f, x)
        table = self.embed if cfg.tie_embeddings else self.unembed
        if cfg.num_codebooks:
            logits = _codebook_logits(x, weight(table["table"], x))
        else:
            logits = self.cc.shard(unembed(table, x), ("batch", "seq", "vocab"))
        if self.padded_vocab != cfg.vocab_size:
            valid = torch.arange(self.padded_vocab, device=x.device) < cfg.vocab_size
            if isinstance(logits, DTensor):
                valid = _replicated(valid, logits.device_mesh)
            logits = logits.masked_fill(~valid, -1e30)
        return logits

    # -------------------- cache construction --------------------
    def init_cache(self, batch: int, max_seq: int, *, device=None) -> Cache:
        """The initial cache on the model's device (or ``device``, e.g.
        ``"meta"`` for shapes alone), in the layout of the module docstring:
        zero KV leaves in the cache dtype; the recurrent states as the
        reference initialises them, float32 whatever the cache dtype (ssm:
        zeros, ``m = -1e30``; hybrid: zeros). ``max_seq`` sizes the self-attention
        KV leaves only; the vlm cross leaves hold ``num_image_tokens`` rows,
        zeros until a prefill projects them (the reference's ``init_cache``
        ignores ``image_embeds`` too)."""
        cfg = self.cfg
        dev = self.device if device is None else device
        if cfg.family == "ssm":
            args = (batch, cfg.d_model, cfg.num_heads, torch.float32, dev)
            pair = xlstm_lib.state_leaves(xlstm_lib.init_mlstm_state(*args),
                                          xlstm_lib.init_slstm_state(*args))
            ng = cfg.num_layers // 2
            return tuple(t.expand(ng, *t.shape).contiguous() for t in pair)

        def kv(*lead, rows=max_seq):
            shape = (*lead, batch, rows, cfg.num_kv_heads, cfg.head_dim)
            return (torch.zeros(shape, dtype=self.cc.cache_dtype, device=dev),
                    torch.zeros(shape, dtype=self.cc.cache_dtype, device=dev))

        if cfg.family == "vlm":
            ng = cfg.num_layers // cfg.cross_attn_every
            return kv(ng, rows=cfg.num_image_tokens) + kv(ng, cfg.cross_attn_every - 1)

        if cfg.family == "hybrid":
            ke = cfg.hybrid_attn_every
            ng, rem = divmod(cfg.num_layers, ke)
            st = ssm_lib.init_mamba2_state(batch, cfg.d_model, cfg, torch.float32, dev)
            leaves = kv(ng) + tuple(st[k].expand(ng, ke, *st[k].shape).contiguous()
                                    for k in ("conv", "ssd"))
            if rem:
                leaves += tuple(st[k].expand(rem, *st[k].shape).contiguous()
                                for k in ("conv", "ssd"))
            return leaves
        if _moe_every(cfg) == 2:
            return kv(cfg.num_layers // 2) + kv(cfg.num_layers // 2)
        return kv(cfg.num_layers)

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    def _image_ctx(self, image_embeds) -> torch.Tensor:
        """The vlm image embeddings (B, T, D) on the model's device, cast to
        the compute dtype as the reference casts them; an input, carrying no
        gradient."""
        if image_embeds is None:
            raise ValueError("the vlm family's prefill and train forward need image_embeds "
                             "(B, num_image_tokens, d_model) for its cross-attention layers")
        return torch.as_tensor(image_embeds, device=self.device).to(self.cc.compute_dtype)

    def _vlm(self, x, positions, cache: Optional[Cache], *, ctx=None, pos=None):
        """The vlm stack over ``x``, group by group: the self layers, then
        the cross layer. The whole sequence (``pos`` None): each cross
        layer projects its K/V from ``ctx``, attends with them uncast and,
        with ``cache`` given, writes them into its cross leaves in the cache
        dtype. One decode step at ``pos``: the cross layers attend to the
        cached K/V cast to the compute dtype."""
        cfg, cc = self.cfg, self.cc
        for g, group in enumerate(self.blocks):
            for i, blk in enumerate(group.selfs):
                lc = None if cache is None else (cache[2][g, i], cache[3][g, i])
                x = blk(x, positions, cfg, cc, lc, pos)
            if pos is None:
                k, v = attn_lib.cross_kv(group.cross.attn, ctx, cfg.num_heads,
                                         cfg.num_kv_heads, cfg.d_model)
                if cache is not None:
                    cache[0][g].copy_(k)
                    cache[1][g].copy_(v)
            else:
                k, v = cache[0][g], cache[1][g]
            x = group.cross.forward_cross(x, k, v, cfg, cc)
        return x

    def _attn_caches(self, cache: Optional[Cache]):
        """Each attention layer's ``(k, v)`` slices of ``cache`` (or None),
        in the order :meth:`_attn_layers` runs them."""
        n = len(self._attn_layers())
        if cache is None:
            return [None] * n
        if self.cfg.family == "hybrid" or _moe_every(self.cfg) == 1:
            return [(cache[0][l], cache[1][l]) for l in range(n)]
        # moe every other layer: dense.k, dense.v, moe_l.k, moe_l.v
        return [(cache[2 * (l % 2)][l // 2], cache[2 * (l % 2) + 1][l // 2]) for l in range(n)]

    def _attn_layers(self):
        """The attention layers in their order (dense, moe)."""
        if _moe_every(self.cfg) == 2:
            return [blk for grp in self.blocks for blk in (grp.dense, grp.moe_l)]
        return list(self.blocks)

    def _hybrid(self, x, positions, cache: Optional[Cache], pos=None):
        """The hybrid stack over ``x``: the whole sequence (``pos`` None),
        from the zero states, writing the KV rows and the final states into
        ``cache`` if given; or one decode step at ``pos`` from the states
        in ``cache``, written back in place."""
        cfg, cc = self.cfg, self.cc
        for g, group in enumerate(self.blocks):
            for i, blk in enumerate(group):
                x = self._mamba(blk, x, cache, pos, (2, 3), (g, i))
            lc = None if cache is None else (cache[0][g], cache[1][g])
            x = self.shared_attn(x, positions, cfg, cc, lc, pos)
        for r, blk in enumerate(getattr(self, "tail", ())):
            x = self._mamba(blk, x, cache, pos, (4, 5), (r,))
        return x

    def _mamba(self, blk, x, cache, pos, leaves, at):
        """One Mamba2 block of the hybrid stack; its state lives at index
        ``at`` of the cache leaves ``leaves`` (conv, ssd)."""
        cfg = self.cfg
        if cache is None:
            return blk(x, cfg, self.cc, return_state=False)[0]
        conv, ssd = cache[leaves[0]][at], cache[leaves[1]][at]
        if pos is None:
            x, st = blk(x, cfg, self.cc, return_state=True)
        else:
            x, st = blk.step(x, cfg, {"conv": conv, "ssd": ssd})
        _write_mamba_state(conv, ssd, st)
        return x

    # -------------------- full-sequence forward (prefill) --------------------
    @torch.no_grad()
    def forward(self, tokens, *, image_embeds=None, cache: Optional[Cache] = None,
                logits_last_only: bool = False):
        """tokens: (B, S), or (B, S, K) for audio -> ``(logits, cache)``.
        ``image_embeds`` (B, T, D) is the vlm family's (required there,
        ignored elsewhere). With ``cache`` given, every attention layer's
        RoPE'd k/v are written into its rows ``[0, S)``, every vlm cross
        layer's K/V into its cross leaves, and every recurrent state leaf is
        overwritten with the final state of the prompt (the scans start from
        the zero state and never read the cache, as the reference's do)."""
        cfg, cc = self.cfg, self.cc
        self._refuse_placed("serving")
        tokens = self._tokens(tokens)
        x = self._embed_tokens(tokens)
        B, S = tokens.shape[:2]
        if cfg.family == "ssm":
            for g, pair in enumerate(self.blocks):
                x, st_m, st_s = pair(x, cfg, cc)
                if cache is not None:
                    _write_ssm_states(cache, g, st_m, st_s)
        else:
            positions = torch.arange(S, device=self.device)[None, :].expand(B, S)
            if cfg.family == "hybrid":
                x = self._hybrid(x, positions, cache)
            elif cfg.family == "vlm":
                x = self._vlm(x, positions, cache, ctx=self._image_ctx(image_embeds))
            else:
                for blk, lc in zip(self._attn_layers(), self._attn_caches(cache)):
                    x = blk(x, positions, cfg, cc, lc)
        if logits_last_only:
            x = x[:, -1:]  # prefill: unembed only the last position
        return self._logits(x), cache

    # -------------------- training --------------------
    def forward_train(self, tokens, *, image_embeds=None):
        """The full-sequence forward with grad, every family: tokens (B, S),
        or (B, S, K) for audio -> ``(logits (B, S, V), or (B, S, K, V), in the
        compute dtype, aux)``, ``aux`` the float32 sum of the moe layers' load-balance
        losses in layer order, as the reference's scan carries it (0 for the
        other families: no block of theirs has one). ``image_embeds`` (B, T,
        D) is the vlm family's (required there, ignored elsewhere). Under
        ``remat == "block"`` and grad, each layer (ssm: each pair; hybrid:
        each Mamba2 block and each use of the shared block; moe every other
        layer: the dense and the moe layer of a group each; vlm: each self
        layer and each cross layer, the image context an input of the cross
        layer's checkpoint) runs in ``torch.utils.checkpoint``
        (non-reentrant): only its inputs are kept, and the backward runs it
        again, the moe dispatch included. The reference remats a whole vlm
        group (``_maybe_remat`` over the group's scan body); a checkpoint a
        layer recomputes the same values, so the gradients are the same and
        fewer activations are held at once. The hybrid stack walks its
        groups as :meth:`_hybrid` does; the shared block's gradient is
        autograd's sum over its uses. The vlm stack walks its groups as
        :meth:`_vlm` does, each cross layer projecting its K/V from the
        image context (:meth:`_image_ctx`).

        Under a mesh (:meth:`_train_mesh`) the tokens, positions and vlm
        image embeddings are placed by ``batch_shardings`` and every
        activation is a ``DTensor``; the logits come back split over the
        vocabulary."""
        mesh = self._train_mesh()
        with device_collectives(mesh):
            return self._forward_train(tokens, image_embeds, mesh)

    def _forward_train(self, tokens, image_embeds, mesh):
        cfg, cc = self.cfg, self.cc
        tokens = self._tokens(tokens)
        if mesh is not None:
            tokens = self._place_batch(tokens, mesh)
        x = self._embed_tokens(tokens)
        B, S = tokens.shape[:2]
        remat = cc.remat == "block" and torch.is_grad_enabled()
        if cfg.family == "ssm":
            calls = [(pair.forward_train, (cfg, cc)) for pair in self.blocks]
        else:
            positions = torch.arange(S, device=self.device)[None, :].expand(B, S)
            if mesh is not None:
                positions = self._place_batch(positions, mesh)
            if cfg.family == "hybrid":
                calls = []
                for group in self.blocks:
                    calls += [(blk.forward_train, (cfg, cc)) for blk in group]
                    calls.append((self.shared_attn, (positions, cfg, cc)))
                calls += [(blk.forward_train, (cfg, cc)) for blk in getattr(self, "tail", ())]
            elif cfg.family == "vlm":
                ctx = self._image_ctx(image_embeds)
                if mesh is not None:
                    ctx = self._place_batch(ctx, mesh)
                calls = []
                for group in self.blocks:
                    calls += [(blk.forward_train, (positions, cfg, cc)) for blk in group.selfs]
                    calls.append((group.cross.forward_cross_train, (ctx, cfg, cc)))
            else:
                calls = [(blk.forward_train, (positions, cfg, cc)) for blk in self._attn_layers()]
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        if mesh is not None:
            aux = _replicated(aux, mesh)
        for fn, args in calls:
            out = checkpoint(fn, x, *args, use_reentrant=False) if remat else fn(x, *args)
            x, a = out if isinstance(out, tuple) else (out, None)
            if a is not None:
                aux = aux + a
        return self._logits(x), aux

    def loss(self, batch):
        """``(loss, {"nll", "aux"})`` of a batch ``{"tokens", "targets"}``
        (B, S each, or (B, S, K) for audio), as
        ``repro.models.transformer.Model.loss``: the cross-entropy in float32
        over the last axis, its mean over every other (audio: over B, S and
        K), ``logsumexp`` with its max held out of the gradient, ``loss = nll
        + 0.01 * aux``. The target logit is taken by
        ``gather``, where the reference contracts with a one-hot: the same
        value (every other term of its sum is an exact zero).

        Under a mesh the logits stay split over the vocabulary: the max is a
        partial max and the target's logit a masked partial gather, both
        reduced over "model" at (B, S), so no (B, S, V) logits are
        gathered; the loss and its metrics come back replicated
        ``DTensor`` scalars."""
        with device_collectives(self._train_mesh()):
            return self._loss(batch)

    def _loss(self, batch):
        logits, aux = self.forward_train(batch["tokens"],
                                         image_embeds=batch.get("image_embeds"))
        targets = torch.as_tensor(batch["targets"], device=self.device).long()
        if isinstance(logits, DTensor):
            targets = self._place_batch(targets, logits.device_mesh)
        lf = logits.float()
        m = reduced(lf.amax(dim=-1, keepdim=True)).detach()
        logz = torch.log(reduced(torch.exp(lf - m).sum(dim=-1))) + m[..., 0]
        tgt = _target_logit(lf, targets)
        nll = (logz - tgt).mean()
        loss = nll + 0.01 * aux
        if isinstance(loss, DTensor):
            whole = [Replicate()] * loss.device_mesh.ndim
            loss, nll = loss.redistribute(placements=whole), nll.redistribute(placements=whole)
        return loss, {"nll": nll, "aux": aux}

    def prefill(self, tokens, cache: Cache, *, image_embeds=None):
        """Fill ``cache`` from a prompt, in place; returns (last-token
        logits (B, 1, V) or (B, 1, K, V), cache)."""
        return self.forward(tokens, image_embeds=image_embeds, cache=cache,
                            logits_last_only=True)

    # -------------------- decode --------------------
    @torch.no_grad()
    def decode_step(self, token, cache: Cache, pos):
        """One-token step. token: (B, 1), or (B, 1, K) for audio.

        ``pos`` is a () scalar (every row decodes at the same position) or a
        (B,) vector of per-row positions (the continuous-batching serve
        engine: each cache slot at its own offset; a row parked at
        ``pos >= max_seq`` attends but writes no KV row). Writes this step's
        k/v and the new recurrent states into ``cache`` in place; returns
        (logits (B, 1, V) or (B, 1, K, V), cache). The vlm cross layers
        attend to the cross K/V the prefill cached, whatever ``pos``.

        Recurrent states (ssm, the hybrid's Mamba2 blocks) ignore ``pos``, as
        the reference's do: every row's state advances in place, parked rows
        too (admission's prefill overwrites a slot's every state leaf before
        it is read again).
        """
        cfg, cc = self.cfg, self.cc
        self._refuse_placed("decoding")
        token = self._tokens(token)
        x = self._embed_tokens(token)
        B = x.shape[0]
        if cfg.family == "ssm":
            for g, pair in enumerate(self.blocks):
                x, st_m, st_s = pair.step(x, cfg, *xlstm_lib.leaf_states(t[g] for t in cache))
                _write_ssm_states(cache, g, st_m, st_s)
            return self._logits(x), cache
        if isinstance(pos, torch.Tensor):
            pos = pos.to(self.device)
        positions = torch.as_tensor(pos, device=self.device).reshape(-1, 1).expand(B, 1)
        if cfg.family == "hybrid":
            x = self._hybrid(x, positions, cache, pos)
        elif cfg.family == "vlm":
            x = self._vlm(x, positions, cache, pos=pos)
        else:
            for blk, lc in zip(self._attn_layers(), self._attn_caches(cache)):
                x = blk(x, positions, cfg, cc, lc, pos)
        return self._logits(x), cache


def build_model(cfg: ArchConfig, cc: Optional[CallConfig] = None, *, device=None,
                seed: int = 0) -> Model:
    return Model(cfg, cc, device=device, seed=seed)
