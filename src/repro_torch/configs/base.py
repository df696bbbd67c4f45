"""Architecture & run configuration: the port's copy of ``repro.configs.base``.

Every assigned architecture gets a module ``configs/<id>.py`` exporting
``CONFIG: ArchConfig`` built from the exact public-literature numbers in the
assignment. ``ArchConfig.reduced()`` returns the shrunk same-family config
used by CPU smoke tests. The data is the JAX package's, field for field, so
a test can hold the two packages to the same configuration.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# Input shapes (assignment-defined; identical set for every LM arch)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    """One (seq_len, global_batch) workload cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


TRAIN_4K = ShapeSpec("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeSpec("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeSpec("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeSpec("long_500k", 524_288, 1, "decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    # fine-grained/shared experts are modelled as plain experts here
    capacity_factor: float = 1.25
    # MoE layer every N layers (1 = all layers; llama4-maverick interleaves
    # dense/MoE so moe_every=2 reproduces the 400B-total/17B-active naming)
    moe_every: int = 1
    # expert-parallel split: expert weights stored as (E*ep_split, D, F/ep_split)
    # and sharded over the FULL mesh (model x data) — tokens all-to-all to the
    # expert owners instead of re-gathering expert weights every microbatch
    # (EXPERIMENTS.md §Perf hillclimb #1). 1 = FSDP/TP baseline.
    ep_split: int = 1


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 64          # Mamba2 N (per-head state)
    conv_width: int = 4
    expand: int = 2              # inner dim = expand * d_model
    head_dim: int = 64           # Mamba2 P
    chunk: int = 256             # SSD chunk length


@dataclass(frozen=True)
class XLSTMConfig:
    # ratio of mLSTM blocks to sLSTM blocks, xLSTM[a:b] notation
    slstm_every: int = 2         # every 2nd block is sLSTM
    head_dim: int = 256


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    # options
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0           # phi4 uses partial rotary
    norm: str = "rmsnorm"                # rmsnorm | layernorm
    activation: str = "silu"             # silu | gelu
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    # hybrid (zamba2-style): 1 shared attention block applied every N mamba
    # blocks; 0 disables.
    hybrid_attn_every: int = 0
    # vlm (llama-3.2-vision-style): cross-attention layer every N layers.
    cross_attn_every: int = 0
    num_image_tokens: int = 0            # stub frontend sequence length
    # audio (musicgen): number of EnCodec codebooks summed at the input.
    num_codebooks: int = 0
    # which assigned shapes are supported (long_500k only for sub-quadratic)
    supports_long_context: bool = False
    notes: str = ""

    # ---------------- derived quantities ----------------
    @property
    def head_dim(self) -> int:
        return self.d_model // self.num_heads

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    def param_count(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        kvd = self.num_kv_heads * self.head_dim
        attn = d * d + 2 * d * kvd + d * d              # q, k, v, o
        if self.qkv_bias:
            attn += d + 2 * kvd
        if self.family == "ssm" and self.xlstm is not None:
            # xLSTM blocks: qkv + gates + out ~ treat as 4*d*d + proj ffn
            block = 6 * d * d
        elif self.ssm is not None and self.family in ("ssm", "hybrid"):
            inner = self.ssm.expand * d
            nheads = inner // self.ssm.head_dim
            block = d * (2 * inner + 2 * nheads * self.ssm.state_dim) + inner * d
            if self.hybrid_attn_every:
                # amortized shared attention + its ffn
                block += (attn + 3 * d * f) // max(1, self.hybrid_attn_every)
        else:
            block = attn
        if f > 0:
            ffn = 3 * d * f if self.activation in ("silu", "swiglu") else 2 * d * f
            if self.is_moe:
                # dense layers between MoE layers keep a single FFN
                frac_moe = 1.0 / self.moe.moe_every
                ffn = ffn * self.moe.num_experts * frac_moe + ffn * (1 - frac_moe)
            block += int(ffn)
        emb = v * d * (1 if self.tie_embeddings else 2)
        return emb + self.num_layers * block

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        n_moe_layers = self.num_layers // self.moe.moe_every
        ffn_total = 3 * d * f * self.moe.num_experts
        ffn_active = 3 * d * f * self.moe.top_k
        return self.param_count() - n_moe_layers * (ffn_total - ffn_active)

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.supports_long_context:
            out.append(LONG_500K)
        return tuple(out)

    def reduced(self) -> "ArchConfig":
        """Same-family shrunk config for CPU smoke tests."""
        changes = dict(
            num_layers=min(self.num_layers, 2 + (1 if self.hybrid_attn_every else 0)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads < self.num_heads else 4,
            d_ff=0 if self.d_ff == 0 else 256,
            vocab_size=512,
            num_image_tokens=16 if self.num_image_tokens else 0,
        )
        if self.moe is not None:
            changes["moe"] = MoEConfig(num_experts=4, top_k=min(self.moe.top_k, 2))
        if self.ssm is not None:
            changes["ssm"] = SSMConfig(state_dim=16, expand=2, head_dim=32, chunk=32)
        if self.xlstm is not None:
            changes["xlstm"] = XLSTMConfig(slstm_every=2, head_dim=32)
        if self.hybrid_attn_every:
            changes["hybrid_attn_every"] = 2
        if self.cross_attn_every:
            changes["cross_attn_every"] = 2
        return dataclasses.replace(self, **changes)


# registry filled in by configs/__init__.py
