"""The model stack: ``Model`` / ``build_model``, for the dense and ssm families.

The port's copy of ``repro.models.transformer`` for two layer layouts:

* ``dense``: uniform ``[attn + mlp] x L``, a KV cache;
* ``ssm`` (xlstm-350m): ``L / 2`` pairs ``[mLSTM, sLSTM]``, a recurrent state.

Other families raise ``NotImplementedError`` until their slices are ported.

``Model`` is an ``nn.Module`` whose parameters keep the JAX package's names
and layouts: ``embed.table`` ``(V, D)``, ``ln_f.scale``, and per layer
``blocks.<l>.{ln1,attn,ln2,mlp}.<leaf>`` (dense) or per pair
``blocks.<g>.{ln_m,mlstm,ln_s,slstm}.<leaf>`` (ssm), a JAX leaf of the
stacked ``blocks`` pytree cut at ``l`` or ``g``
(:func:`repro_torch.convert.model_params_to_port`). Parameters are float32
and every product casts them to the compute dtype, as the reference does.

The cache is a tuple of tensors whose slot (batch) axis is 1. Dense: a pair
``(k, v)`` of ``(L, B, max_seq, KVH, hd)`` tensors. ssm: the seven float32
leaves of the reference's state pytree, in ``jax.tree.leaves`` order
(:data:`repro_torch.models.xlstm.STATE_LEAVES`: mLSTM ``C (NG, B, H, hd, hd)``,
``m (NG, B, H)``, ``n (NG, B, H, hd)``; sLSTM ``c, h, m, n``, each
``(NG, B, H, hd)``), stacked over the ``NG = L / 2`` pairs.
Prefill and decode write into the cache they are given, in place, where
JAX returns a new one.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.convert import resolve_device
from repro_torch.kernels.flash_attention import BLOCK_KV
from repro_torch.models import attention as attn_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.layers import embed, make_norm, mlp, mlp_params, norm_params, unembed

Cache = Tuple[torch.Tensor, ...]  # dense: (k, v); ssm: xlstm.STATE_LEAVES
FAMILIES = ("dense", "ssm")  # the ported layer layouts


@dataclass(frozen=True)
class CallConfig:
    """Per-call (not per-arch) knobs."""

    block_kv: int = BLOCK_KV                # the flash kernel's KV tile (built for one only)
    compute_dtype: torch.dtype = torch.bfloat16
    cache_dtype: torch.dtype = torch.bfloat16
    # the prefill's kernels (attention, the sLSTM recurrence): None lets the
    # tensors' device decide (the CUDA kernel on the card), "ref" runs the
    # plain version (repro_torch.kernels.ops)
    kernel_backend: Optional[str] = None


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
                cache: Optional[Cache] = None, cache_pos=None):
        norm = make_norm(cfg.norm)
        y = attn_lib.attention_block(
            self.attn, norm(self.ln1, x), positions, cfg.num_heads, cfg.num_kv_heads,
            rope_theta=cfg.rope_theta, rope_fraction=cfg.rope_fraction,
            block_kv=cc.block_kv, backend=cc.kernel_backend, kv_cache=cache, cache_pos=cache_pos)
        x = x + y
        if cfg.d_ff > 0:
            x = x + mlp(self.mlp, norm(self.ln2, x), cfg.activation)
        return x


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
        x = x + ym
        ys, st_s = xlstm_lib.slstm_forward(self.slstm, norm(self.ln_s, x), cfg.num_heads,
                                           return_state=True, backend=cc.kernel_backend)
        return x + ys, st_m, st_s

    def step(self, x, cfg: ArchConfig, st_m, st_s):
        """One token from the pair's states; returns ``x`` and the new states."""
        norm = make_norm(cfg.norm)
        ym, st_m = xlstm_lib.mlstm_decode_step(self.mlstm, norm(self.ln_m, x), st_m,
                                               cfg.num_heads)
        x = x + ym
        ys, st_s = xlstm_lib.slstm_decode_step(self.slstm, norm(self.ln_s, x), st_s,
                                               cfg.num_heads)
        return x + ys, st_m, st_s


def _write_ssm_states(cache: Cache, g: int, st_m, st_s) -> None:
    """Write pair ``g``'s new states into every cache leaf, in place."""
    for dst, src in zip(cache, xlstm_lib.state_leaves(st_m, st_s)):
        dst[g].copy_(src)


class Model(nn.Module):
    """Model facade: init / init_cache / forward / prefill / decode_step.

    ``device=None`` is the card; the parameters live there, drawn once from
    ``seed`` (:meth:`init` redraws them).
    """

    def __init__(self, cfg: ArchConfig, cc: Optional[CallConfig] = None, *, device=None,
                 seed: int = 0):
        super().__init__()
        if cfg.family not in FAMILIES:
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
        if cfg.family == "ssm":
            self.blocks = nn.ModuleList(XLSTMPair(cfg, gen) for _ in range(cfg.num_layers // 2))
        else:
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
    def init_cache(self, batch: int, max_seq: int, *, device=None) -> Cache:
        """The initial cache on the model's device (or ``device``, e.g.
        ``"meta"`` for shapes alone). Dense: zero ``(k, v)``, each
        ``(L, batch, max_seq, KVH, hd)`` in the cache dtype. ssm: the
        reference's initial states (zeros, ``m = -1e30``) as the float32
        leaves of ``xlstm.STATE_LEAVES``, whatever the cache dtype;
        ``max_seq`` is not used."""
        cfg = self.cfg
        dev = self.device if device is None else device
        if cfg.family == "ssm":
            args = (batch, cfg.d_model, cfg.num_heads, torch.float32, dev)
            pair = xlstm_lib.state_leaves(xlstm_lib.init_mlstm_state(*args),
                                          xlstm_lib.init_slstm_state(*args))
            ng = cfg.num_layers // 2
            return tuple(t.expand(ng, *t.shape).contiguous() for t in pair)
        shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
        return (torch.zeros(shape, dtype=self.cc.cache_dtype, device=dev),
                torch.zeros(shape, dtype=self.cc.cache_dtype, device=dev))

    def _tokens(self, tokens) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # -------------------- full-sequence forward (prefill) --------------------
    @torch.no_grad()
    def forward(self, tokens, *, cache: Optional[Cache] = None,
                logits_last_only: bool = False):
        """tokens: (B, S) -> ``(logits, cache)``. With ``cache`` given, every
        layer's RoPE'd k/v are written into its rows ``[0, S)`` (dense), or
        every leaf is overwritten with the final state of the prompt
        (ssm: the scans start from the zero state and never read the cache,
        as the reference's do)."""
        cfg, cc = self.cfg, self.cc
        tokens = self._tokens(tokens)
        x = embed(self.embed, tokens, cc.compute_dtype)
        B, S = tokens.shape
        if cfg.family == "ssm":
            for g, pair in enumerate(self.blocks):
                x, st_m, st_s = pair(x, cfg, cc)
                if cache is not None:
                    _write_ssm_states(cache, g, st_m, st_s)
            if logits_last_only:
                x = x[:, -1:]
            return self._logits(x), cache
        positions = torch.arange(S, device=self.device)[None, :].expand(B, S)
        for l, blk in enumerate(self.blocks):
            lc = None if cache is None else (cache[0][l], cache[1][l])
            x = blk(x, positions, cfg, cc, lc)
        if logits_last_only:
            x = x[:, -1:]  # prefill: unembed only the last position
        return self._logits(x), cache

    def prefill(self, tokens, cache: Cache):
        """Fill ``cache`` from a prompt, in place; returns (last-token
        logits (B, 1, V), cache)."""
        return self.forward(tokens, cache=cache, logits_last_only=True)

    # -------------------- decode --------------------
    @torch.no_grad()
    def decode_step(self, token, cache: Cache, pos):
        """One-token step. token: (B, 1).

        ``pos`` is a () scalar (every row decodes at the same position) or a
        (B,) vector of per-row positions (the continuous-batching serve
        engine: each cache slot at its own offset; a row parked at
        ``pos >= max_seq`` attends but writes nothing). Writes this step's
        k/v into ``cache`` in place; returns (logits (B, 1, V), cache).

        ssm: ``pos`` is ignored, as the reference ignores it; every row's
        state advances in place, parked rows too (admission's prefill
        overwrites a slot's every leaf before it is read again).
        """
        cfg, cc = self.cfg, self.cc
        token = self._tokens(token)
        x = embed(self.embed, token, cc.compute_dtype)
        B = x.shape[0]
        if cfg.family == "ssm":
            for g, pair in enumerate(self.blocks):
                x, st_m, st_s = pair.step(x, cfg, *xlstm_lib.leaf_states(t[g] for t in cache))
                _write_ssm_states(cache, g, st_m, st_s)
            return self._logits(x), cache
        if isinstance(pos, torch.Tensor):
            pos = pos.to(self.device)
        positions = torch.as_tensor(pos, device=self.device).reshape(-1, 1).expand(B, 1)
        for l, blk in enumerate(self.blocks):
            x = blk(x, positions, cfg, cc, (cache[0][l], cache[1][l]), pos)
        return self._logits(x), cache


def build_model(cfg: ArchConfig, cc: Optional[CallConfig] = None, *, device=None,
                seed: int = 0) -> Model:
    return Model(cfg, cc, device=device, seed=seed)

