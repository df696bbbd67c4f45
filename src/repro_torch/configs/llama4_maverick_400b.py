"""llama4-maverick-400b-a17b [moe] — 128 experts top-1, early fusion.

[hf:meta-llama/Llama-4-Scout-17B-16E; unverified] 48L d_model=5120 40H
(GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1. Early-fusion multimodal
frontend stubbed per assignment.
"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    moe=MoEConfig(num_experts=128, top_k=1, moe_every=2),  # interleaved MoE
    rope_theta=500_000.0,
    notes="moe_every=2 (interleaved dense/MoE as in Llama-4 Maverick) so the "
    "total lands at ~400B / ~14B active matching the 400b-a17b naming",
)
