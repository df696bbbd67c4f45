"""Continuous-batching serving engine: one decode step per token.

The port's copy of ``repro.serve.engine`` for the contiguous slot cache
(the paged cache, ``Engine.serve`` and fault injection wait for a later
slice). A fixed pool of ``batch`` decode *slots* is backed by one
preallocated KV cache (:class:`repro_torch.serve.kvcache.SlotCache`).
Every generated token costs exactly one ``model.decode_step`` call that
advances **all** active slots at once: per-slot sequence offsets ride in a
``(batch,)`` position vector, idle slots are parked at ``pos >= max_seq``
(their KV writes are dropped and their outputs discarded; the recurrent
state of an ssm model still advances on parked rows, which is harmless,
because admission's prefill overwrites every state leaf of a slot before
reuse, so nothing a parked row computes ever reaches a request). Finished
sequences (EOS or length) retire between steps and their slots are
refilled through the admission layer
(:class:`repro_torch.serve.admission.AdmissionQueue`): refill = prefill of
the incoming prompt at batch 1 into the freed slot's cache rows.

Where JAX donates the cache to a jitted step and gets a new one back, the
port updates the cache in place: ``decode_step`` writes each active row's
k/v into the pool, and admission prefills straight into a view of the
slot's rows. Dense KV rows past the new prompt may still hold the
previous occupant's values; they are never read unmasked, because a decode
step at ``pos`` writes row ``pos`` before it attends to rows ``<= pos``,
and a masked row enters the softmax with weight exactly 0. An ssm prefill
starts from the zero state and overwrites the slot's state whole.

Determinism contract (``tests/test_torch_serve.py``, ``chip_smoke.py``):

* greedy (``temperature=0``) outputs are token-identical to
  :meth:`Engine.generate_sequential`, the per-request oracle loop;
* temperature sampling keeps the reference's key chain: a request's key is
  ``fold_in(seed, request_index)`` at prefill, then the *chained*
  ``key = fold_in(key, t)`` at its local decode step ``t``. Each key seeds
  a ``torch.Generator`` that draws the Gumbel noise of one categorical
  sample, so sampled outputs are seed-deterministic and independent of
  slot assignment. ``jax.random`` bits cannot be reproduced in torch, so
  sampled tokens are held to the port's own oracle, not to the JAX
  package's.

The dense and ssm (xlstm) families are ported, so they can be served. The
guards of the reference stay: multi-codebook audio needs ``(B, 1, K)``
token feedback, vlm prefill needs ``image_embeds``, and moe needs a
drop-free expert capacity at the pool size.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from repro_torch.serve.admission import AdmissionQueue
from repro_torch.serve.kvcache import init_slots


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


@dataclass
class _SlotState:
    """Host-side bookkeeping for one occupied slot."""

    req: Request
    produced: int   # tokens emitted so far (incl. the prefill-sampled one)
    key: int        # the request's sampling key, chained once a step
    step: int = 0   # local decode steps taken


def fold_in(key: int, data: int) -> int:
    """A new 63-bit key from ``key`` and ``data`` (the role of
    ``jax.random.fold_in``; its bits are not reproduced)."""
    digest = hashlib.blake2b(f"{key}/{data}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def _expert_capacity(n_tokens: int, *, top_k: int, num_experts: int,
                     capacity_factor: float, dp_size: int = 1):
    """The (dp groups, tokens per group, per-expert buffer depth) of the
    reference's ``moe_forward`` for ``n_tokens`` (``repro.models.moe``'s
    ``expert_capacity``, copied for the guard until the moe family is ported)."""
    dp = max(1, min(dp_size, n_tokens))
    while n_tokens % dp:
        dp //= 2
    tl = n_tokens // dp
    return dp, tl, max(1, int((tl * top_k / num_experts) * capacity_factor))


class Engine:
    """Continuous-batching engine over the port's model.

    ``model`` holds its weights (:class:`repro_torch.models.transformer.Model`)
    and runs on its own device. ``batch`` is the slot-pool size (decode
    batch), ``max_seq`` the per-slot cache capacity (prompt + generated
    tokens must fit). After :meth:`generate`, ``last_stats`` holds the
    counters (decode steps, generated tokens, prefills, occupancy).
    """

    def __init__(self, model, *, batch: int, max_seq: int, eos_id: Optional[int] = None):
        if batch < 1:
            raise ValueError(f"batch (slot-pool size) must be >= 1, got {batch}")
        if max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {max_seq}")
        self.model = model
        self.batch = batch
        self.max_seq = max_seq
        self.eos_id = eos_id
        # one pool for the engine's lifetime, allocated on first generate()
        self._slots = None
        self.last_stats: Dict[str, Any] = {}

    @property
    def slots(self):
        """The engine's slot pool (allocated on first use)."""
        if self._slots is None:
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
            _, tl, cap = _expert_capacity(
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

    # -------------------- front door --------------------
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

    # -------------------- the serve loop --------------------
    def _serve_loop(self, queue: AdmissionQueue, *, seed: int) -> Dict[str, Any]:
        B = self.batch
        dev = self.model.device
        slots = self.slots
        clock = queue.clock
        state: List[Optional[_SlotState]] = [None] * B
        tok = [0] * B
        pos = [self.max_seq] * B  # parked: no writes
        stats: Dict[str, Any] = dict(decode_steps=0, generated_tokens=0, prefills=0,
                                     occupancy_sum=0, admission_order=[], batch=B)

        def admit(b: int) -> None:
            """Refill slot ``b`` from the admission queue: prefill into the
            slot's cache rows. Requests finishing at prefill (EOS or
            max_new_tokens <= 1) complete without occupying the slot."""
            while True:
                item = queue.pop()
                if item is None:
                    return
                ri, req = item
                stats["admission_order"].append(ri)
                req.admitted_time = clock.now
                prompt = self._prompt(req)
                logits, _ = self.model.prefill(prompt, slots.view(b))
                stats["prefills"] += 1
                key_r = fold_in(seed, ri)
                t0 = self._sample(logits[0, -1], req.temperature, key_r)
                req.out_tokens.append(t0)
                stats["generated_tokens"] += 1
                if req.max_new_tokens <= 1 or (self.eos_id is not None and t0 == self.eos_id):
                    req.done = True
                    req.finish_time = clock.now
                    continue
                state[b] = _SlotState(req=req, produced=1, key=key_r)
                tok[b] = t0
                pos[b] = prompt.shape[1]
                return

        while True:
            queue.poll(clock.now)
            for b in range(B):
                if state[b] is None:
                    admit(b)
            n_active = sum(1 for s in state if s is not None)
            if n_active == 0:
                if queue.exhausted:
                    break
                nxt = queue.next_arrival_time()
                if nxt is None:
                    break
                clock.advance_to(max(nxt, clock.now))
                continue
            logits, _ = self.model.decode_step(
                torch.tensor(tok, device=dev)[:, None], slots.cache,
                torch.tensor(pos, device=dev))
            rows = []
            for b, st in enumerate(state):
                if st is not None:
                    st.key = fold_in(st.key, st.step)
                    st.step += 1
                    rows.append((b, float(st.req.temperature), st.key))
            new = dict(zip((b for b, _, _ in rows), self._next_tokens(logits, rows)))
            stats["decode_steps"] += 1
            stats["occupancy_sum"] += n_active
            clock.advance(1.0)
            pos = [p + 1 for p in pos]
            for b in range(B):
                st = state[b]
                if st is None:
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
                    state[b] = None
                    pos[b] = self.max_seq  # park
        stats["occupancy"] = (stats["occupancy_sum"] / stats["decode_steps"]
                              if stats["decode_steps"] else 0.0)
        del stats["occupancy_sum"]
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
        for ri, req in zip(idxs, requests):
            cache = self.model.init_cache(B, self.max_seq)
            prompt = self._prompt(req)
            logits, _ = self.model.prefill(prompt, tuple(t[:, :1] for t in cache))
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
