"""llama-3.2-vision-90b [vlm] — cross-attn image layers.

[hf:meta-llama/Llama-3.2-11B-Vision; unverified] scaled per assignment:
100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
Vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (DESIGN.md §4).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    num_layers=100,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_every=5,
    num_image_tokens=1601,   # 1 tile of 560x560 @ patch 14 (+cls)
    notes="cross-attention to stub image embeddings every 5th layer",
)
