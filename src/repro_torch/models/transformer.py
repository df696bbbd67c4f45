"""The model stack for the dense family: ``Model`` / ``build_model``.

The port's copy of ``repro.models.transformer`` for ``family == "dense"``
(uniform ``[attn + mlp] x L``). Other families raise
``NotImplementedError`` until their slices are ported.

``Model`` is an ``nn.Module`` whose parameters keep the JAX package's names
and layouts: ``embed.table`` ``(V, D)``, ``ln_f.scale``, and per layer
``blocks.<l>.{ln1,attn,ln2,mlp}.<leaf>``, a JAX leaf of the stacked
``blocks`` pytree cut at layer ``l`` (:func:`repro_torch.convert.model_params_to_port`).
Parameters are float32 and every product casts them to the compute dtype,
as the reference does. The KV cache is a pair ``(k, v)`` of
``(L, B, max_seq, KVH, hd)`` tensors; prefill and decode write into the
cache they are given, in place, where JAX returns a new one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import embed, make_norm, mlp, mlp_params, norm_params, unembed

KVCache = Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class CallConfig:
    """Per-call (not per-arch) knobs."""

    block_kv: int = 64                      # the flash kernel's KV tile (built for 64 only)
    compute_dtype: torch.dtype = torch.bfloat16
    cache_dtype: torch.dtype = torch.bfloat16
    # prefill attention: None lets the tensors' device decide (the CUDA
    # kernel on the card), "ref" runs the plain version (repro_torch.kernels.ops)
    attn_backend: Optional[str] = None


def _params(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(v, requires_grad=False) for k, v in d.items()})


class Block(nn.Module):
    """One decoder layer: ``x + attn(ln1(x))``, then ``x + mlp(ln2(x))``."""

    def __init__(self, cfg: ArchConfig, gen: torch.Generator):
        super().__init__()
        dev = gen.device
        self.ln1 = _params(norm_params(cfg.norm, cfg.d_model, dev))
        self.attn = _params(attn_lib.attention_params(
            gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads, qkv_bias=cfg.qkv_bias))
        if cfg.d_ff > 0:
            self.ln2 = _params(norm_params(cfg.norm, cfg.d_model, dev))
            self.mlp = _params(mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.activation))

    def forward(self, x, positions, cfg: ArchConfig, cc: CallConfig,
                cache: Optional[KVCache] = None, cache_pos=None):
        norm = make_norm(cfg.norm)
        y = attn_lib.attention_block(
            self.attn, norm(self.ln1, x), positions, cfg.num_heads, cfg.num_kv_heads,
            rope_theta=cfg.rope_theta, rope_fraction=cfg.rope_fraction,
            block_kv=cc.block_kv, backend=cc.attn_backend, kv_cache=cache, cache_pos=cache_pos)
        x = x + y
        if cfg.d_ff > 0:
            x = x + mlp(self.mlp, norm(self.ln2, x), cfg.activation)
        return x


class Model(nn.Module):
    """Model facade: init / init_cache / forward / prefill / decode_step.

    ``device=None`` is the card; the parameters live there, drawn once from
    ``seed`` (:meth:`init` redraws them).
    """

    def __init__(self, cfg: ArchConfig, cc: Optional[CallConfig] = None, *, device=None,
                 seed: int = 0):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(f"the {cfg.family!r} family is not ported yet")
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
        table = lambda: torch.randn((self.padded_vocab, cfg.d_model), generator=gen,  # noqa: E731
                                    device=self.device) * 0.02
        self.embed = _params({"table": table()})
        self.ln_f = _params(norm_params(cfg.norm, cfg.d_model, self.device))
        if not cfg.tie_embeddings:
            self.unembed = _params({"table": table()})
        self.blocks = nn.ModuleList(Block(cfg, gen) for _ in range(cfg.num_layers))
        return self

    # -------------------- embedding / logits --------------------
    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = make_norm(cfg.norm)(self.ln_f, x)
        logits = unembed(self.embed if cfg.tie_embeddings else self.unembed, x)
        if self.padded_vocab != cfg.vocab_size:
            valid = torch.arange(self.padded_vocab, device=x.device) < cfg.vocab_size
            logits = logits.masked_fill(~valid, -1e30)
        return logits

    # -------------------- cache construction --------------------
    def init_cache(self, batch: int, max_seq: int, *, device=None) -> KVCache:
        """Zero ``(k, v)``, each ``(L, batch, max_seq, KVH, hd)`` in the cache
        dtype, on the model's device (or ``device``, e.g. ``"meta"`` for
        shapes alone)."""
        cfg = self.cfg
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        dev = self.device if device is None else device
        return (torch.zeros(shape, dtype=self.cc.cache_dtype, device=dev),
                torch.zeros(shape, dtype=self.cc.cache_dtype, device=dev))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # -------------------- full-sequence forward (prefill) --------------------
    @torch.no_grad()
    def forward(self, tokens, *, cache: Optional[KVCache] = None,
                logits_last_only: bool = False):
        """tokens: (B, S) -> ``(logits, cache)``. With ``cache`` given, every
        layer's RoPE'd k/v are written into its rows ``[0, S)``."""
        cfg, cc = self.cfg, self.cc
        tokens = self._tokens(tokens)
        x = embed(self.embed, tokens, cc.compute_dtype)
        B, S = tokens.shape
        positions = torch.arange(S, device=self.device)[None, :].expand(B, S)
        for l, blk in enumerate(self.blocks):
            lc = None if cache is None else (cache[0][l], cache[1][l])
            x = blk(x, positions, cfg, cc, lc)
        if logits_last_only:
            x = x[:, -1:]  # prefill: unembed only the last position
        return self._logits(x), cache

    def prefill(self, tokens, cache: KVCache):
        """Fill ``cache`` from a prompt, in place; returns (last-token
        logits (B, 1, V), cache)."""
        return self.forward(tokens, cache=cache, logits_last_only=True)

    # -------------------- decode --------------------
    @torch.no_grad()
    def decode_step(self, token, cache: KVCache, pos):
        """One-token step. token: (B, 1).

        ``pos`` is a () scalar (every row decodes at the same position) or a
        (B,) vector of per-row positions (the continuous-batching serve
        engine: each cache slot at its own offset; a row parked at
        ``pos >= max_seq`` attends but writes nothing). Writes this step's
        k/v into ``cache`` in place; returns (logits (B, 1, V), cache).
        """
        cfg, cc = self.cfg, self.cc
        token = self._tokens(token)
        x = embed(self.embed, token, cc.compute_dtype)
        B = x.shape[0]
        if isinstance(pos, torch.Tensor):
            pos = pos.to(self.device)
        positions = torch.as_tensor(pos, device=self.device).reshape(-1, 1).expand(B, 1)
        for l, blk in enumerate(self.blocks):
            x = blk(x, positions, cfg, cc, (cache[0][l], cache[1][l]), pos)
        return self._logits(x), cache


def build_model(cfg: ArchConfig, cc: Optional[CallConfig] = None, *, device=None,
                seed: int = 0) -> Model:
    return Model(cfg, cc, device=device, seed=seed)

