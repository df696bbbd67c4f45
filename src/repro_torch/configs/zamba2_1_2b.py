"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf] 38L d_model=2048 32H d_ff=8192 vocab=32000 ssm_state=64.
Runs long_500k (linear-time scan).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm=SSMConfig(state_dim=64, expand=2, head_dim=64),
    hybrid_attn_every=6,   # shared attn+ffn block applied every 6 mamba blocks
    supports_long_context=True,
)
