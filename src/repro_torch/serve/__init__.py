"""Continuous-batching LLM serving: the port's copy of ``repro.serve``.

``Engine`` serves request waves through a fixed pool of decode slots (one
``decode_step`` per token advances every active slot), backed by
``SlotCache`` (slot-indexed preallocated KV) or ``PagedSlotCache``
(fixed-size pages from a shared pool behind a slot→page table). The
streaming front door is ``Engine.serve`` over an ``AdmissionQueue``
(FIFO / latency-aware policies, admission-time rejection, virtual clock);
``TrafficProfile`` + ``simulate`` drive it with validated synthetic
workloads and emit latency/TTFT/goodput metrics.
"""
from repro_torch.serve.admission import (
    AdmissionQueue,
    Arrival,
    Rejection,
    VirtualClock,
    iter_async,
)
from repro_torch.serve.engine import Engine, Request
from repro_torch.serve.kvcache import (
    OutOfPages,
    PagedSlotCache,
    PagePool,
    SlotCache,
    batch_axes,
    cache_bytes,
    init_paged_slots,
    init_slots,
    seq_axes,
    trim_report,
)
from repro_torch.serve.traffic import (
    LengthMix,
    TrafficProfile,
    generate_arrivals,
    simulate,
)

__all__ = [
    "AdmissionQueue",
    "Arrival",
    "Engine",
    "LengthMix",
    "OutOfPages",
    "PagePool",
    "PagedSlotCache",
    "Rejection",
    "Request",
    "SlotCache",
    "TrafficProfile",
    "VirtualClock",
    "batch_axes",
    "cache_bytes",
    "generate_arrivals",
    "init_paged_slots",
    "init_slots",
    "iter_async",
    "seq_axes",
    "simulate",
    "trim_report",
]
