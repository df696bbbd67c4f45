"""musicgen-large [audio] — decoder-only over EnCodec tokens. [arXiv:2306.05284; hf]

48L d_model=2048 32H d_ff=8192 vocab=2048 (codebook size), 4 codebooks with
delay pattern; EnCodec frontend is a STUB (precomputed frame embeddings).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=2048,
    num_codebooks=4,
    norm="layernorm",
    activation="gelu",
)
