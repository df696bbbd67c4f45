"""Modality frontend stubs: the shapes of the vlm and audio families' inputs
and seeded synthetic inputs of those shapes.

The port's copy of ``repro.models.frontend``. The configs give the
transformer backbone only: a vlm model takes precomputed vision-tower patch
embeddings, an audio model EnCodec RVQ token grids. The synthetic inputs
are drawn from a ``torch.Generator`` on its device; the draws differ from
``jax.random``'s, so tests pass the same NumPy arrays to both packages.
"""
from __future__ import annotations

import torch


def image_embed_shape(cfg, batch: int):
    """Precomputed vision-tower patch embeddings for cross-attention."""
    return (batch, cfg.num_image_tokens, cfg.d_model)


def synth_image_embeds(gen: torch.Generator, cfg, batch: int, dtype=torch.bfloat16):
    """Normal image embeddings times 0.02, in ``dtype`` on ``gen``'s device."""
    x = torch.randn(image_embed_shape(cfg, batch), generator=gen, device=gen.device)
    return (x * 0.02).to(dtype)


def audio_token_shape(cfg, batch: int, seq: int):
    """EnCodec RVQ token grid: (B, S, num_codebooks)."""
    return (batch, seq, cfg.num_codebooks)


def synth_tokens(gen: torch.Generator, cfg, batch: int, seq: int):
    """Uniform tokens in ``[0, vocab_size)``: ``(B, S, K)`` for an audio
    config, ``(B, S)`` otherwise, on ``gen``'s device."""
    shape = audio_token_shape(cfg, batch, seq) if cfg.num_codebooks else (batch, seq)
    return torch.randint(0, cfg.vocab_size, shape, generator=gen, device=gen.device)
