"""Admission layer for the serving tier: request streams, virtual clock,
FIFO / latency-aware scheduling, admission-time rejection.

The port's copy of ``repro.serve.admission`` (pure Python, no framework).

The continuous-batching engine used to pop pending requests from an
in-memory deque between decode steps; this module is the real front door.
A request *stream* is any time-sorted iterable of :class:`Arrival`
records (or bare ``(time, request)`` pairs) — materialized lists from the
traffic simulator of the JAX package), lazy generators, or an
``async`` iterator bridged through :func:`iter_async`. Arrivals are pulled
lazily as the :class:`VirtualClock` advances (one tick per jitted decode
step in the engine's serve loop), land in a ready set once due, and are
handed to free slots by the queue's scheduling policy:

* ``"fifo"``    — arrival order (the legacy deque behavior; the default).
* ``"latency"`` — latency-aware shortest-job-first: among due requests,
  admit the one with the smallest predicted service time
  (``max_new_tokens`` decode steps, prompt length as the prefill
  tiebreak). On bursty arrivals this minimizes mean completion latency at
  identical goodput; arrival index breaks remaining ties so scheduling is
  deterministic.

Rejection happens **at admission time, not mid-decode**: a request whose
prompt is empty, whose token budget is non-positive, or whose
``prompt + max_new_tokens`` cannot fit the engine's ``max_seq`` (or page
pool) is diverted to :attr:`AdmissionQueue.rejected` with a reason string
the moment it arrives, and never touches a slot. The engine's batch
``generate()`` entry point keeps its raise-on-invalid contract; streaming
admission must not let one malformed request kill the serving loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

POLICIES = ("fifo", "latency")


class VirtualClock:
    """A monotone virtual clock, denominated in decode-step ticks.

    The serve loop advances it by ``step_time`` per jitted decode step and
    fast-forwards it to the next arrival when the pool drains. Monotonicity
    is enforced: time never runs backwards, so latency/TTFT accounting and
    lazy stream consumption are well-defined.
    """

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    @property
    def now(self) -> float:
        return self._now

    def advance(self, dt: float) -> float:
        if dt < 0:
            raise ValueError(f"virtual clock cannot run backwards (dt={dt})")
        self._now += dt
        return self._now

    def advance_to(self, t: float) -> float:
        if t < self._now:
            raise ValueError(
                f"virtual clock cannot rewind from {self._now} to {t}"
            )
        self._now = float(t)
        return self._now


@dataclass(frozen=True)
class Arrival:
    """One request arriving at a virtual-clock time."""

    time: float
    request: Any


@dataclass(frozen=True)
class Rejection:
    """A request refused at admission time, with the reason.

    ``time`` is the virtual-clock instant the rejection was recorded (the
    ``poll`` that diverted the request), so rejection streams are
    auditable against the arrival trace. It defaults to ``0.0`` for
    compatibility with pre-deadline constructors.
    """

    index: int
    request: Any
    reason: str
    time: float = 0.0


class AdmissionQueue:
    """Policy-driven admission over a time-sorted request stream.

    ``arrivals`` yields :class:`Arrival` records (or ``(time, request)``
    pairs) in non-decreasing time order — violations raise, since an
    out-of-order stream would silently reorder the sampling key chain.
    ``max_seq`` enables capacity validation; ``validator`` may layer
    additional admission checks (the engine adds its page-pool bound) and
    returns a reason string to reject or ``None`` to accept.

    Each arrival gets a global arrival index — the identity the engine
    folds into its per-request PRNG key chain, so scheduling policy and
    slot assignment never change sampled tokens.
    """

    def __init__(self, arrivals: Iterable, *, policy: str = "fifo",
                 max_seq: Optional[int] = None,
                 validator: Optional[Callable[[Any], Optional[str]]] = None,
                 clock: Optional[VirtualClock] = None):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown admission policy {policy!r}; choose from {POLICIES}"
            )
        self.policy = policy
        self.max_seq = max_seq
        self.validator = validator
        self.clock = clock if clock is not None else VirtualClock()
        self._stream: Iterator = iter(arrivals)
        self._peek: Optional[Arrival] = None
        self._stream_done = False
        self._ready: List[Tuple[int, Arrival]] = []
        self._next_index = 0
        self._last_time = float("-inf")
        self._last_poll = float("-inf")
        self.rejected: List[Rejection] = []

    @classmethod
    def from_requests(cls, requests: Iterable, **kw) -> "AdmissionQueue":
        """A queue over a fully materialized wave arriving at t=0 — with
        the default FIFO policy this reproduces the legacy deque admission
        order exactly."""
        return cls([Arrival(0.0, r) for r in requests], **kw)

    # -------------------- stream consumption --------------------
    def _coerce(self, item) -> Arrival:
        if isinstance(item, Arrival):
            a = item
        else:
            t, req = item
            a = Arrival(float(t), req)
        if a.time < self._last_time:
            raise ValueError(
                f"arrival stream is not time-sorted: {a.time} after "
                f"{self._last_time}"
            )
        return a

    def _pull(self) -> Optional[Arrival]:
        """Load the next arrival into the peek buffer (None if exhausted)."""
        if self._peek is None and not self._stream_done:
            try:
                self._peek = self._coerce(next(self._stream))
                self._last_time = self._peek.time
            except StopIteration:
                self._stream_done = True
        return self._peek

    def check_request(self, req) -> Optional[str]:
        """Reason this request must be refused at admission, or None."""
        if len(req.prompt) == 0:
            return "empty prompt (prefill needs at least one token)"
        if req.max_new_tokens < 1:
            return (
                f"max_new_tokens={req.max_new_tokens} < 1: a zero-budget "
                "request has nothing to generate"
            )
        deadline = getattr(req, "deadline", None)
        if deadline is not None and deadline <= 0:
            return (
                f"deadline={deadline} <= 0 ticks: the admission deadline "
                "is relative to arrival and must be positive"
            )
        if self.max_seq is not None:
            need = len(req.prompt) + req.max_new_tokens
            if need > self.max_seq:
                return (
                    f"needs {need} cache rows (prompt {len(req.prompt)} + "
                    f"max_new_tokens {req.max_new_tokens}) but "
                    f"max_seq={self.max_seq}"
                )
        if self.validator is not None:
            return self.validator(req)
        return None

    def _deadline_of(self, a: Arrival) -> Optional[float]:
        """Absolute virtual-clock instant by which the request must be
        *admitted* (popped to a slot), or None if it has no deadline.
        ``Request.deadline`` is relative to arrival time."""
        d = getattr(a.request, "deadline", None)
        return None if d is None else a.time + d

    def _reject(self, idx: int, req, reason: str, now: float) -> None:
        if hasattr(req, "rejected"):
            req.rejected = reason
        self.rejected.append(Rejection(idx, req, reason, time=now))

    def poll(self, now: float) -> int:
        """Move arrivals due at ``now`` into the ready set; returns how
        many became ready. Rejections divert to :attr:`rejected` (the
        arrival still consumes its index, keeping key chains stable).

        Deadlines are enforced here, not mid-decode: a ready request whose
        admission deadline has lapsed (``now > arrival + deadline``) is
        purged to :attr:`rejected` with a ``deadline exceeded`` reason and
        the rejection's virtual-clock timestamp, and an arrival that is
        already past-deadline on intake (the engine fast-forwarded over
        it) is diverted the same way.
        """
        if now < self._last_poll:
            raise ValueError(
                f"poll time ran backwards: {now} after {self._last_poll}"
            )
        self._last_poll = now
        # purge ready entries whose admission deadline lapsed while they
        # waited for a slot
        kept: List[Tuple[int, Arrival]] = []
        for idx, a in self._ready:
            dl = self._deadline_of(a)
            if dl is not None and now > dl:
                self._reject(
                    idx, a.request,
                    f"deadline exceeded: admitted-by deadline was t={dl} "
                    f"(arrival {a.time} + deadline "
                    f"{getattr(a.request, 'deadline', None)}), now t={now}",
                    now)
            else:
                kept.append((idx, a))
        self._ready = kept
        added = 0
        while True:
            a = self._pull()
            if a is None or a.time > now:
                break
            self._peek = None
            idx = self._next_index
            self._next_index += 1
            req = a.request
            if hasattr(req, "arrival_time"):
                req.arrival_time = a.time
            reason = self.check_request(req)
            if reason is None:
                dl = self._deadline_of(a)
                if dl is not None and now > dl:
                    reason = (
                        f"deadline exceeded: admitted-by deadline was "
                        f"t={dl} (arrival {a.time} + deadline "
                        f"{req.deadline}), first poll at t={now}")
            if reason is not None:
                self._reject(idx, req, reason, now)
                continue
            self._ready.append((idx, a))
            added += 1
        return added

    # -------------------- scheduling --------------------
    def pop(self) -> Optional[Tuple[int, Any]]:
        """Admit the next ready request per policy (None if none ready)."""
        if not self._ready:
            return None
        if self.policy == "fifo":
            i = 0  # ready is appended in arrival order
        else:  # latency-aware shortest-job-first
            i = min(
                range(len(self._ready)),
                key=lambda j: (
                    self._ready[j][1].request.max_new_tokens,
                    len(self._ready[j][1].request.prompt),
                    self._ready[j][0],
                ),
            )
        idx, a = self._ready.pop(i)
        return idx, a.request

    def push_back(self, idx: int, req) -> None:
        """Return an admitted-but-not-started request to the head of the
        ready set (the engine defers admission when the page pool cannot
        yet reserve the request's worst case). The original arrival time
        is preserved so an admission deadline keeps counting from the true
        arrival, not the defer."""
        t = getattr(req, "arrival_time", None)
        if t is None:
            t = self._last_poll
        self._ready.insert(0, (idx, Arrival(t, req)))

    # -------------------- introspection --------------------
    def next_arrival_time(self) -> Optional[float]:
        a = self._pull()
        return a.time if a is not None else None

    @property
    def exhausted(self) -> bool:
        """True when the stream is drained and nothing is ready."""
        return not self._ready and self._pull() is None

    def __len__(self) -> int:
        return len(self._ready)


def iter_async(async_iterable) -> Iterator:
    """Bridge an ``async`` arrival stream into the synchronous serve loop.

    Pulls one item at a time through a private event loop, so an
    ``async def`` generator (e.g. fed by a socket or an asyncio queue) can
    be handed straight to :class:`AdmissionQueue`. The pull is lazy: the
    producer coroutine only runs while the engine is between decode steps,
    which keeps the bridge deterministic for simulated sources.
    """
    import asyncio

    loop = asyncio.new_event_loop()
    try:
        it = async_iterable.__aiter__()
        while True:
            try:
                yield loop.run_until_complete(it.__anext__())
            except StopAsyncIteration:
                return
    finally:
        loop.close()
