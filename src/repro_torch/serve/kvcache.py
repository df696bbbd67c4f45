"""Slot-indexed cache for the continuous-batching serve engine.

The port's copy of the contiguous half of ``repro.serve.kvcache``; the
paged cache waits for a later slice. One preallocated cache
(``model.init_cache(batch, max_seq)``) backs a fixed pool of ``batch``
decode *slots*; the serve engine advances every slot with a single
``decode_step`` per token. :class:`SlotCache` owns the cache plus the
per-leaf batch-axis map (dense KV leaves are ``(L, B, S, KVH, hd)``, the
ssm state leaves ``(NG, B, H, ...)``: the slot axis is 1 in both),
discovered structurally by comparing ``init_cache(1)`` with
``init_cache(2)`` shapes on the ``meta`` device.

JAX's slot writers are jitted with donation; here every slot operation
writes the pool's tensors in place:

* :meth:`SlotCache.view`        — a batch-1 view of one slot, which prefill
  fills in place (the admission path: no copy of the slot).
* :meth:`SlotCache.write_prefill` — copy a batch-1 cache into one slot.
* :meth:`SlotCache.reset_slot`  — scrub a slot back to the initial cache.
* :meth:`SlotCache.read_slot`   — a batch-1 copy of one slot (tests).
"""
from __future__ import annotations

from typing import Tuple

import torch

Cache = Tuple[torch.Tensor, ...]


def cache_bytes(cache: Cache) -> int:
    """Total bytes held by a cache (sum over leaves of size x itemsize)."""
    return sum(t.numel() * t.element_size() for t in cache)


def batch_axes(model, max_seq: int) -> Tuple:
    """Per-leaf batch-axis index of ``model.init_cache``'s leaves: the one
    axis whose length changes between ``init_cache(1, max_seq)`` and
    ``init_cache(2, max_seq)`` (shapes only, on the ``meta`` device). A leaf
    with no such axis maps to ``None`` (shared between slots)."""
    s1 = model.init_cache(1, max_seq, device="meta")
    s2 = model.init_cache(2, max_seq, device="meta")

    def axis(a, b):
        cands = [i for i, (x, y) in enumerate(zip(a.shape, b.shape)) if x != y]
        if not cands:
            return None
        if len(cands) > 1:
            raise ValueError(f"ambiguous batch axis for cache leaf {tuple(a.shape)} vs "
                             f"{tuple(b.shape)}")
        return cands[0]

    return tuple(axis(a, b) for a, b in zip(s1, s2))


class SlotCache:
    """A fixed pool of ``batch`` decode slots over one shared cache.

    ``cache`` is the live pair of tensors handed to ``decode_step``, which
    writes it in place.
    """

    def __init__(self, model, batch: int, max_seq: int):
        self.model = model
        self.batch = batch
        self.max_seq = max_seq
        self.axes = batch_axes(model, max_seq)
        self.cache = model.init_cache(batch, max_seq)

    def view(self, slot: int) -> Cache:
        """``slot``'s rows as a batch-1 cache that aliases the pool: what is
        written into it lands in the pool."""
        return tuple(t if ax is None else t.narrow(ax, slot, 1)
                     for t, ax in zip(self.cache, self.axes))

    def write_prefill(self, slot: int, one_cache: Cache) -> None:
        """Copy a batch-1 cache (``init_cache(1, max_seq)`` layout) into
        ``slot``'s rows of the pool."""
        for dst, src, ax in zip(self.view(slot), one_cache, self.axes):
            if ax is not None:
                dst.copy_(src)

    def reset_slot(self, slot: int) -> None:
        """Scrub ``slot`` back to the initial cache state (KV zeros, fresh
        ssm state). Not needed on the serve path: admission's prefill
        overwrites a slot's ssm state whole, and a slot's KV rows past its
        prompt are never read unmasked (see
        :class:`repro_torch.serve.engine.Engine`)."""
        self.write_prefill(slot, self.model.init_cache(1, self.max_seq))

    def read_slot(self, slot: int) -> Cache:
        """``slot`` as a batch-1 copy (tests and introspection)."""
        return tuple(t.clone() for t in self.view(slot))


def init_slots(model, batch: int, max_seq: int) -> SlotCache:
    """Allocate the serve engine's slot pool: one shared
    ``model.init_cache(batch, max_seq)`` plus its slot-axis map."""
    return SlotCache(model, batch, max_seq)
