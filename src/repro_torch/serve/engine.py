"""Continuous-batching serving engine: one decode step per token.

The port's copy of ``repro.serve.engine``. A fixed pool of ``batch`` decode
*slots* is backed by one preallocated KV cache
(:class:`repro_torch.serve.kvcache.SlotCache`, or the paged
:class:`repro_torch.serve.kvcache.PagedSlotCache` when the engine is built
with ``page_size=``). Every generated token costs exactly one
``model.decode_step`` call that advances **all** active slots at once:
per-slot sequence offsets ride in a ``(batch,)`` position vector, idle
slots are parked at ``pos >= max_seq`` (their KV writes are dropped and
their outputs discarded; the recurrent state of an ssm or hybrid model
still advances on parked rows, which is harmless, because admission's prefill
overwrites every state leaf of a slot before reuse, so nothing a parked
row computes ever reaches a request). Finished sequences (EOS or length)
retire between steps and their slots are refilled through the admission
layer (:class:`repro_torch.serve.admission.AdmissionQueue`): refill =
prefill of the incoming prompt into the freed slot's cache rows.

Two front doors share one serve loop:

* :meth:`Engine.generate` — a materialized request list, validated up
  front (raises on any invalid request), admitted FIFO as if everything
  arrived at t=0.
* :meth:`Engine.serve` — the streaming API over an
  :class:`~repro_torch.serve.admission.AdmissionQueue` (e.g. from
  :mod:`repro_torch.serve.traffic`). A virtual clock ticks ``step_time``
  per decode step; invalid or over-capacity requests are rejected at
  admission time, and arrival/admission/finish times are stamped. With
  ``faults=`` (:class:`repro_torch.faults.TransientFaults`) a failed
  slot's step is discarded and the slot recovers by retry-and-re-prefill
  under a :class:`repro_torch.runtime.fault_tolerance.RestartPolicy`.

Where JAX donates the cache to a jitted step and gets a new one back, the
port updates the cache in place: ``decode_step`` writes each active row's
k/v into the pool, and contiguous admission prefills straight into a view
of the slot's rows. Dense KV rows past the new prompt may still hold the
previous occupant's values; they are never read unmasked, because a decode
step at ``pos`` writes row ``pos`` before it attends to rows ``<= pos``,
and a masked row enters the softmax with weight exactly 0. A recurrent
prefill (ssm, the hybrid's Mamba2 blocks) starts from the zero state and
overwrites the slot's state whole.

Paged mode (``page_size=``): admission is *reservation-based*: a request
is admitted only when the pool can commit its worst case
``ceil((prompt + max_new_tokens - 1) / page_size)`` pages, so
:class:`~repro_torch.serve.kvcache.OutOfPages` is unreachable mid-decode;
pages are still allocated as rows are written and return to the free list
at retirement. A prefill fills a batch-1 cache of the prompt's length,
which :meth:`PagedSlotCache.write_prefill` copies into the slot's pages.
The decode step gathers the dense view through the page table, runs the
same ``decode_step`` as the contiguous path, and scatters the view back:
the logits are bitwise the contiguous cache's. The hybrid family's Mamba2
states have no rows to page and stay dense per slot in the paged pool; the
ssm family has nothing to page and serves on the contiguous cache only.

Determinism contract (``tests/test_torch_serve.py``,
``tests/test_torch_traffic.py``, ``chip_smoke.py``):

* greedy (``temperature=0``) outputs are token-identical to
  :meth:`Engine.generate_sequential`, the per-request oracle loop;
* temperature sampling keeps the reference's key chain: a request's key is
  ``fold_in(seed, request_index)`` at prefill, then the *chained*
  ``key = fold_in(key, t)`` at its local decode step ``t``. Each key seeds
  a ``torch.Generator`` that draws the Gumbel noise of one categorical
  sample, so sampled outputs are seed-deterministic and independent of
  slot assignment. ``jax.random`` bits cannot be reproduced in torch, so
  sampled tokens are held to the port's own oracle, not to the JAX
  package's;
* with ``eos_id=None`` the virtual-clock schedule (admissions, latencies,
  makespan, rejections, pages, faults, retries) is a function of the
  arrival stream, the pool and the fault draws alone, and equals the JAX
  package's.

On the card a re-prefill recomputes the context's KV rows with the
prefill's products and the flash kernel, where the healthy path wrote them
from decode steps: their low bits differ, and in bfloat16 a retried
request's later tokens may differ from a fault-free run's. Requests whose
slot never failed are unaffected.

Every family of the reference is ported; the dense, moe, hybrid and ssm
families can be served. The guards of the reference stay: multi-codebook
audio needs ``(B, 1, K)`` token feedback, vlm prefill needs
``image_embeds`` (both run through ``Model.prefill`` / ``decode_step``
instead, as the reference's tests run them), and moe needs a drop-free
expert capacity at the pool size, checked with
:func:`repro_torch.models.moe.expert_capacity`, the formula the dispatch
itself uses.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.models.moe import expert_capacity
from repro_torch.runtime.fault_tolerance import RestartPolicy
from repro_torch.serve.admission import AdmissionQueue
from repro_torch.serve.kvcache import batch_axes, init_paged_slots, init_slots


@dataclass
class Request:
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False
    # admission deadline in virtual-clock ticks *relative to arrival*
    # (read by the admission queue). None = no deadline.
    deadline: Optional[float] = None
    # --- serving-tier accounting (virtual-clock ticks) ---
    arrival_time: float = 0.0
    admitted_time: Optional[float] = None   # = first-token time (prefill)
    finish_time: Optional[float] = None
    rejected: Optional[str] = None          # admission-rejection reason
    pages_peak: Optional[int] = None        # paged mode: max pages held


@dataclass
class _SlotState:
    """Host-side bookkeeping for one occupied slot."""

    req: Request
    produced: int   # tokens emitted so far (incl. the prefill-sampled one)
    key: int        # the request's sampling key, chained once a step
    step: int = 0   # local decode steps taken
    index: int = 0      # arrival index (the sampling key's identity)
    reserved: int = 0   # paged mode: worst-case pages committed


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from ``key`` and ``data`` (the role of
    ``jax.random.fold_in``; its bits are not reproduced)."""
    digest = hashlib.blake2b(f"{key}/{data}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class Engine:
    """Continuous-batching engine over the port's model.

    ``model`` holds its weights (:class:`repro_torch.models.transformer.Model`)
    and runs on its own device. ``batch`` is the slot-pool size (decode
    batch), ``max_seq`` the per-slot cache capacity (prompt + generated
    tokens must fit). With ``page_size=`` the KV cache is paged: slots draw
    fixed-size pages from a shared pool of ``pool_pages`` (default ``batch *
    ceil(max_seq / page_size)``, the contiguous footprint). After
    :meth:`generate` / :meth:`serve`, ``last_stats`` holds the counters
    (decode steps, generated tokens, prefills, occupancy; ``serve`` adds
    the streaming and fault fields).
    """

    def __init__(self, model, *, batch: int, max_seq: int, eos_id: Optional[int] = None,
                 page_size: Optional[int] = None, pool_pages: Optional[int] = None):
        if batch < 1:
            raise ValueError(f"batch (slot-pool size) must be >= 1, got {batch}")
        if max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {max_seq}")
        if page_size is not None and not (1 <= page_size <= max_seq):
            raise ValueError(f"page_size must be in [1, max_seq={max_seq}], got {page_size}")
        if pool_pages is not None:
            if page_size is None:
                raise ValueError("pool_pages requires page_size")
            pps = -(-max_seq // page_size)
            if pool_pages < pps:
                raise ValueError(
                    f"pool_pages={pool_pages} cannot back even one full-length slot ({pps} "
                    f"pages of {page_size} rows for max_seq={max_seq})")
        self.model = model
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        self.page_size = page_size
        self.pool_pages = pool_pages
        # one pool for the engine's lifetime, allocated on first use
        self._slots = None
        self.last_stats: Dict[str, Any] = {}

    @property
    def paged(self) -> bool:
        return self.page_size is not None

    @property
    def slots(self):
        """The engine's slot pool (allocated on first use)."""
        if self._slots is None:
            if self.paged:
                self._slots = init_paged_slots(self.model, self.batch, self.max_seq,
                                               self.page_size, pool_pages=self.pool_pages)
            else:
                self._slots = init_slots(self.model, self.batch, self.max_seq)
        return self._slots

    def _validate(self, requests: List[Request]) -> None:
        """Reject requests that cannot be served up front: an overflowing
        slot would silently drop KV writes at ``pos >= max_seq``; a
        zero-budget request has nothing to generate."""
        for ri, req in enumerate(requests):
            if len(req.prompt) == 0:
                raise ValueError(
                    f"request {ri} has an empty prompt; prefill needs at least one token")
            if req.max_new_tokens < 1:
                raise ValueError(
                    f"request {ri} has max_new_tokens={req.max_new_tokens}; a request must "
                    "budget at least one generated token (zero-budget requests are rejected "
                    "up front rather than occupying a slot)")
            need = len(req.prompt) + req.max_new_tokens
            if need > self.max_seq:
                raise ValueError(
                    f"request {ri} needs {need} cache rows (prompt {len(req.prompt)} + "
                    f"max_new_tokens {req.max_new_tokens}) but max_seq={self.max_seq}")

    def _family_guards(self) -> None:
        """Families the batched slot pool cannot serve token-identically."""
        cfg = getattr(self.model, "cfg", None)
        if getattr(cfg, "num_codebooks", 0):
            raise ValueError(
                "multi-codebook audio decoding needs (B, 1, K) token feedback the slot pool "
                "does not carry; serve audio configs through generate_sequential")
        if getattr(cfg, "family", None) == "vlm":
            raise ValueError(
                "vlm prefill needs image_embeds, which Request does not carry yet; the "
                "serve engine cannot serve vlm configs")
        moe = getattr(cfg, "moe", None)
        if moe is not None:
            # every decode row of a dispatch group routing to one expert must
            # fit, or batched outputs diverge from the batch-1 oracle
            _, tl, cap = expert_capacity(
                self.batch, top_k=moe.top_k, num_experts=moe.num_experts,
                capacity_factor=moe.capacity_factor,
                dp_size=getattr(getattr(self.model, "cc", None), "dp_size", 1))
            if cap < tl:
                ok_cf = (tl + 1) * moe.num_experts / (tl * moe.top_k)
                raise ValueError(
                    f"moe expert capacity {cap} < {tl} decode rows per dispatch group: "
                    "capacity-based token dropping routes per batch composition, so batched "
                    "outputs would silently diverge from the sequential oracle; use a "
                    f"drop-free capacity_factor (>= {ok_cf:.4g} for this pool)")

    # -------------------- sampling --------------------
    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float, key: int) -> int:
        """One token from one row of logits (V,): the argmax when greedy,
        else a categorical sample by the Gumbel-max trick, its noise drawn
        by a generator seeded with ``key`` on the logits' device."""
        if temperature <= 0:
            return int(logits.argmax())
        gen = torch.Generator(device=logits.device).manual_seed(key)
        u = torch.rand(logits.shape, generator=gen, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
        return int(((logits / temperature).float() + gumbel).argmax())

    def _next_tokens(self, logits: torch.Tensor, rows) -> List[int]:
        """This step's token for each ``(row, temperature, key)`` of a
        decode step's logits (B, 1, V): one argmax over the pool for the
        greedy rows, a sample for each sampling row."""
        greedy = logits[:, 0].argmax(dim=-1).tolist()
        return [greedy[b] if temp <= 0 else self._sample(logits[b, 0], temp, key)
                for b, temp, key in rows]

    def _prompt(self, req: Request) -> torch.Tensor:
        return torch.as_tensor(np.asarray(req.prompt), dtype=torch.long,
                               device=self.model.device)[None, :]

    # -------------------- front doors --------------------
    def generate(self, requests: List[Request], *, seed: int = 0) -> List[Request]:
        """Serve a materialized wave through the slot pool; one decode step
        per token across all active slots. Raises on any invalid request.
        Mutates and returns ``requests`` (tokens in ``out_tokens``); fills
        ``self.last_stats``."""
        if not requests:
            self.last_stats = dict(decode_steps=0, generated_tokens=0, prefills=0,
                                   occupancy=0.0, admission_order=[], batch=self.batch,
                                   n_requests=0)
            return requests
        self._family_guards()
        self._validate(requests)
        queue = AdmissionQueue.from_requests(requests, max_seq=self.max_seq)
        stats = self._serve_loop(queue, seed=seed)
        if queue.rejected:
            raise RuntimeError(f"a validated wave had rejections: {queue.rejected}")
        self.last_stats = dict(
            decode_steps=stats["decode_steps"], generated_tokens=stats["generated_tokens"],
            prefills=stats["prefills"], occupancy=stats["occupancy"],
            admission_order=stats["admission_order"], batch=self.batch,
            n_requests=len(requests))
        return requests

    def serve(self, queue: AdmissionQueue, *, seed: int = 0, do_sample: bool = True,
              step_time: float = 1.0, faults=None, restart_policy=None,
              backoff_cap: float = 64.0) -> List[Request]:
        """Drive the slot pool from an admission queue over a (possibly
        lazy) arrival stream. The queue's virtual clock advances
        ``step_time`` per decode step and fast-forwards to the next arrival
        whenever the pool drains. Invalid requests divert to
        ``queue.rejected`` (with ``req.rejected`` set) instead of raising.
        Returns the completed requests in finish order; ``last_stats``
        gains ``n_requests``, ``n_accepted``, ``n_rejected``,
        ``makespan_ticks`` and the fault counters.

        ``do_sample`` is accepted for the reference's signature: the JAX
        engine compiles its sampling branch out when it is False; here
        greedy rows always take the argmax and only sampling rows sample.

        ``faults`` (a :class:`repro_torch.faults.TransientFaults`) injects
        seeded per-step slot/page failures; a failed slot's step result is
        discarded and the slot recovers by **retry-and-re-prefill** under
        ``restart_policy`` (a
        :class:`repro_torch.runtime.fault_tolerance.RestartPolicy`, the
        default budget if None): backoff advances the virtual clock by
        ``min(policy.backoff(), backoff_cap)`` ticks and the slot's
        known-good context (prompt + tokens emitted so far) is re-prefilled
        before decoding resumes. A fault that repeats at the same (request,
        token) three times, or exhausts the restart budget, halts the loop
        with ``RuntimeError``.
        """
        self._family_guards()
        stats = self._serve_loop(queue, seed=seed, step_time=step_time, faults=faults,
                                 restart_policy=restart_policy, backoff_cap=backoff_cap)
        self.last_stats = stats
        return stats.pop("_completed")

    # -------------------- the shared serve loop --------------------
    def _serve_loop(self, queue: AdmissionQueue, *, seed: int, step_time: float = 1.0,
                    faults=None, restart_policy=None,
                    backoff_cap: float = 64.0) -> Dict[str, Any]:
        B = self.batch
        dev = self.model.device
        slots = self.slots
        paged = self.paged
        clock = queue.clock
        state: List[Optional[_SlotState]] = [None] * B
        if faults is not None and faults.is_empty:
            faults = None  # empty injection == no injection
        policy = restart_policy
        if faults is not None and policy is None:
            policy = RestartPolicy()
        tok = [0] * B
        pos = [self.max_seq] * B  # parked: no writes
        committed = 0  # paged: worst-case pages reserved by active slots
        completed: List[Request] = []
        stats: Dict[str, Any] = dict(decode_steps=0, generated_tokens=0, prefills=0,
                                     occupancy_sum=0, admission_order=[], batch=B,
                                     faults_injected=0, retries=0, reprefills=0)

        def worst_pages(req: Request) -> int:
            # the last decode step writes row prompt+max_new-2, so a non-EOS
            # request touches prompt+max_new-1 rows at most
            return slots.pages_needed(len(req.prompt) + req.max_new_tokens - 1)

        def hold(b: int, rows: int, req: Request) -> None:
            slots.ensure_rows(b, rows)
            req.pages_peak = max(req.pages_peak or 0, slots.pages_held(b))

        def prefill(b: int, prompt: torch.Tensor):
            """Prefill ``prompt`` (1, n) for slot ``b``: contiguous, into the
            slot's rows of the pool in place (returns the logits and None);
            paged, into a batch-1 cache of ``n`` rows, which the caller
            installs once the slot's pages are backed."""
            if paged:
                return self.model.prefill(prompt, self.model.init_cache(1, prompt.shape[1]))
            return self.model.prefill(prompt, slots.view(b))[0], None

        def admit(b: int) -> bool:
            """Refill slot ``b`` from the admission queue. Requests finishing
            at prefill (EOS or max_new_tokens <= 1) complete without
            occupying the slot. Returns False when paged admission stalls:
            the pool cannot commit the next request's worst case, so the
            request is pushed back until a retirement frees pages."""
            nonlocal committed
            while True:
                item = queue.pop()
                if item is None:
                    return True
                ri, req = item
                need = worst_pages(req) if paged else 0
                if paged and committed + need > slots.allocator.n_pages:
                    queue.push_back(ri, req)
                    return False
                stats["admission_order"].append(ri)
                req.admitted_time = clock.now
                prompt = self._prompt(req)
                logits, one = prefill(b, prompt)
                stats["prefills"] += 1
                key_r = fold_in(seed, ri)
                t0 = self._sample(logits[0, -1], req.temperature, key_r)
                req.out_tokens.append(t0)
                stats["generated_tokens"] += 1
                if req.max_new_tokens <= 1 or (self.eos_id is not None and t0 == self.eos_id):
                    req.done = True
                    req.finish_time = clock.now
                    if paged:
                        req.pages_peak = 0  # retired at prefill: no pages
                    completed.append(req)
                    continue
                if paged:
                    committed += need
                    hold(b, prompt.shape[1], req)
                    slots.write_prefill(b, one)
                state[b] = _SlotState(req=req, produced=1, key=key_r, index=ri, reserved=need)
                tok[b] = t0
                pos[b] = prompt.shape[1]
                return True

        while True:
            queue.poll(clock.now)
            can_admit = True
            for b in range(B):
                if state[b] is None and can_admit:
                    can_admit = admit(b)
            n_active = sum(1 for s in state if s is not None)
            if n_active == 0:
                if queue.exhausted:
                    break
                nxt = queue.next_arrival_time()
                if nxt is None:  # an empty pool always commits one request
                    break
                clock.advance_to(max(nxt, clock.now))
                continue
            toks = torch.tensor(tok, device=dev)[:, None]
            poss = torch.tensor(pos, device=dev)
            if paged:
                # back the row this step writes (pos[b]) for every active
                # slot; reservation admission guarantees the pool can
                for b, st in enumerate(state):
                    if st is not None:
                        hold(b, len(st.req.prompt) + st.produced, st.req)
                dense = slots.gather_dense()
                logits, _ = self.model.decode_step(toks, dense, poss)
                slots.scatter_dense(dense)
            else:
                logits, _ = self.model.decode_step(toks, slots.cache, poss)
            rows = []
            for b, st in enumerate(state):
                if st is not None:
                    st.key = fold_in(st.key, st.step)
                    st.step += 1
                    rows.append((b, float(st.req.temperature), st.key))
            new = dict(zip((b for b, _, _ in rows), self._next_tokens(logits, rows)))
            step_no = stats["decode_steps"]
            stats["decode_steps"] += 1
            stats["occupancy_sum"] += n_active
            clock.advance(step_time)
            pos = [p + 1 for p in pos]
            failed: set = set()
            if faults is not None:
                active = [(b, st.index, st.produced) for b, st in enumerate(state)
                          if st is not None]
                held = [slots.pages_held(b) for b, _, _ in active] if paged else None
                failed = set(faults.failed_slots(step_no, active, held))
            for b in sorted(failed):
                # this step's token for slot b is lost and its KV row is
                # treated as corrupt: back off, re-prefill the known-good
                # context (prompt + tokens emitted so far; the last emitted
                # token is the next decode input) and rebuild the key chain
                # the healthy path would hold, so the retried step samples
                # with the key the lost step used
                st = state[b]
                req = st.req
                stats["faults_injected"] += 1
                action = policy.on_fault(st.index * 1_000_000 + st.produced)
                if action == "halt":
                    raise RuntimeError(
                        f"serve loop halted after repeated faults at request {st.index}, "
                        f"token {st.produced} (restart budget {policy.max_restarts})")
                stats["retries"] += 1
                clock.advance(min(policy.backoff(), backoff_cap))
                ctx = [int(t) for t in req.prompt] + [int(t) for t in req.out_tokens[:-1]]
                prompt = torch.tensor(ctx, dtype=torch.long, device=dev)[None, :]
                _, one = prefill(b, prompt)
                if paged:
                    # pages stay reserved and held across the retry; the
                    # corrupt row is overwritten by the next decode write
                    hold(b, prompt.shape[1], req)
                    slots.write_prefill(b, one)
                stats["reprefills"] += 1
                k = fold_in(seed, st.index)
                for t in range(st.produced - 1):
                    k = fold_in(k, t)
                st.key, st.step = k, st.produced - 1
                tok[b] = int(req.out_tokens[-1])
                pos[b] = prompt.shape[1]
            for b in range(B):
                st = state[b]
                if st is None or b in failed:
                    continue
                t = new[b]
                tok[b] = t
                st.req.out_tokens.append(t)
                st.produced += 1
                stats["generated_tokens"] += 1
                if st.produced >= st.req.max_new_tokens or (
                        self.eos_id is not None and t == self.eos_id):
                    st.req.done = True
                    st.req.finish_time = clock.now
                    completed.append(st.req)
                    state[b] = None
                    if paged:
                        slots.free_slot(b)
                        committed -= st.reserved
                    pos[b] = self.max_seq  # park
        stats["occupancy"] = (stats["occupancy_sum"] / stats["decode_steps"]
                              if stats["decode_steps"] else 0.0)
        del stats["occupancy_sum"]
        stats["n_requests"] = len(completed) + len(queue.rejected)
        stats["n_accepted"] = len(completed)
        stats["n_rejected"] = len(queue.rejected)
        stats["makespan_ticks"] = clock.now
        stats["_completed"] = completed
        return stats

    # -------------------- per-request oracle --------------------
    def generate_sequential(self, requests: List[Request], *, seed: int = 0,
                            indices: Optional[Iterable[int]] = None) -> List[Request]:
        """The per-request loop, the determinism oracle: each request is
        served alone, with its own cache and one python decode loop, and
        :meth:`generate`'s outputs are held token-identical to it.

        Unlike the reference's oracle, which decodes at batch 1, the request
        sits in row 0 of a pool-sized cache with every other row parked, so
        each decode step runs the same shapes as :meth:`generate`'s: on the
        card the matrix-product library picks its algorithm by shape, and a
        batch-1 product may round differently from the same row in a batch.

        ``indices`` overrides the sampling identity of each request
        (default: list position)."""
        self._validate(requests)
        idxs = list(indices) if indices is not None else list(range(len(requests)))
        if len(idxs) != len(requests):
            raise ValueError(f"indices has {len(idxs)} entries for {len(requests)} requests")
        B, dev = self.batch, self.model.device
        axes = batch_axes(self.model, self.max_seq)
        for ri, req in zip(idxs, requests):
            cache = self.model.init_cache(B, self.max_seq)
            prompt = self._prompt(req)
            row0 = tuple(t if ax is None else t.narrow(ax, 0, 1) for t, ax in zip(cache, axes))
            logits, _ = self.model.prefill(prompt, row0)
            pos = prompt.shape[1]
            key_r = fold_in(seed, ri)
            tok = self._sample(logits[0, -1], req.temperature, key_r)
            req.out_tokens.append(tok)
            for t in range(req.max_new_tokens - 1):
                if self.eos_id is not None and tok == self.eos_id:
                    break
                toks, poss = [0] * B, [self.max_seq] * B
                toks[0], poss[0] = tok, pos
                logits, _ = self.model.decode_step(
                    torch.tensor(toks, device=dev)[:, None], cache,
                    torch.tensor(poss, device=dev))
                key_r = fold_in(key_r, t)
                tok = self._next_tokens(logits, [(0, float(req.temperature), key_r)])[0]
                req.out_tokens.append(tok)
                pos += 1
            req.done = True
        return requests
