"""Continuous-batching LLM serving: the port's copy of ``repro.serve`` for the
contiguous slot cache.

``Engine`` serves request waves through a fixed pool of decode slots (one
``decode_step`` per token advances every active slot), backed by
``SlotCache``, with admission through ``AdmissionQueue``.
"""
from repro_torch.serve.admission import AdmissionQueue, Arrival, Rejection, VirtualClock
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.kvcache import SlotCache, batch_axes, cache_bytes, init_slots

__all__ = [
    "AdmissionQueue",
    "Arrival",
    "Engine",
    "Rejection",
    "Request",
    "SlotCache",
    "VirtualClock",
    "batch_axes",
    "cache_bytes",
    "init_slots",
]
