"""AsyncFlow-style traffic simulator: validated workload profiles driving
the serve engine end-to-end.

The port's copy of ``repro.serve.traffic``: the same schema, messages,
draws and payload, so a profile gives the same arrivals (times, prompts,
budgets) here as in the JAX package, and the same virtual-clock numbers.

A :class:`TrafficProfile` is a declarative, strictly-validated description
of a request workload — arrival process, user count, prompt/output length
mixes, sampling temperature — in the spirit of AsyncFlow's simulation
input schema (SNIPPETS.md snippet 3): every field is checked up front with
a pointed error message, unknown keys are rejected (a typo'd field must
fail loudly, not silently fall back to a default), and the same profile
dict round-trips through JSON for committed example workloads under
``examples/``.

:func:`generate_arrivals` expands a profile into a deterministic
time-sorted arrival stream (``numpy.random.RandomState(seed)`` — same
profile, same arrivals, forever), and :func:`simulate` drives an
:class:`~repro_torch.serve.engine.Engine` through it, emitting the serving-tier
health numbers CI trends: p50/p99 request latency, p50/p99 TTFT
(time-to-first-token: admission stamps the prefill instant), goodput
(generated tokens per virtual tick), and the token-parity boolean
``matches_sequential`` against the per-request oracle replay.

Time is virtual: 1 tick == one decode step of the whole slot pool;
prefill is instantaneous (the TTFT cost a request pays is *queueing* —
waiting for a free slot and, in paged mode, for page reservations). That
makes every latency number scheduling-determined and bit-reproducible
across machines — CI gates on them exactly — while ``wall_s``/``tokens_s``
capture real hardware throughput informationally.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.serve.admission import AdmissionQueue, Arrival
from repro_torch.serve.engine import Request

ARRIVALS = ("poisson", "uniform", "burst")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


@dataclass(frozen=True)
class LengthMix:
    """A discrete length distribution: ``choices`` with ``weights``.

    Kept intentionally discrete (vs a continuous distribution) so a
    profile induces only ``len(choices)`` distinct prompt shapes (in the
    JAX package each distinct prompt length compiles its own prefill), so a
    profile's shape diversity is a *visible, validated* cost.
    """

    choices: Sequence[int]
    weights: Optional[Sequence[float]] = None

    def __post_init__(self):
        _require(len(self.choices) >= 1, "length mix needs at least one choice")
        _require(all(isinstance(c, int) and c >= 1 for c in self.choices),
                 f"length choices must be ints >= 1, got {list(self.choices)}")
        _require(len(set(self.choices)) == len(self.choices),
                 f"duplicate length choices: {list(self.choices)}")
        if self.weights is not None:
            _require(len(self.weights) == len(self.choices),
                     f"{len(self.weights)} weights for {len(self.choices)} "
                     "choices")
            _require(all(w >= 0 for w in self.weights) and sum(self.weights) > 0,
                     "weights must be non-negative and sum > 0")

    @property
    def probs(self) -> np.ndarray:
        if self.weights is None:
            return np.full(len(self.choices), 1.0 / len(self.choices))
        w = np.asarray(self.weights, dtype=np.float64)
        return w / w.sum()

    @property
    def max(self) -> int:
        return max(self.choices)

    def sample(self, rng: np.random.RandomState, n: int) -> np.ndarray:
        return rng.choice(np.asarray(self.choices), size=n, p=self.probs)

    @classmethod
    def from_obj(cls, obj: Any, field: str) -> "LengthMix":
        if isinstance(obj, LengthMix):
            return obj
        if isinstance(obj, (list, tuple)):
            return cls(choices=[int(c) for c in obj])
        if isinstance(obj, dict):
            unknown = set(obj) - {"choices", "weights"}
            _require(not unknown,
                     f"unknown keys in {field}: {sorted(unknown)} "
                     "(a length mix has 'choices' and optional 'weights')")
            _require("choices" in obj, f"{field} needs 'choices'")
            return cls(choices=[int(c) for c in obj["choices"]],
                       weights=obj.get("weights"))
        raise ValueError(
            f"{field} must be a list of lengths or a "
            f"{{choices, weights}} mapping, got {type(obj).__name__}"
        )

    def to_obj(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"choices": list(self.choices)}
        if self.weights is not None:
            out["weights"] = list(self.weights)
        return out


_PROFILE_FIELDS = {
    "name", "num_requests", "arrival", "num_users",
    "requests_per_user_tick", "burst_size", "prompt_lens", "output_lens",
    "temperature", "seed", "deadline",
}


@dataclass(frozen=True)
class TrafficProfile:
    """A validated serving workload description.

    * ``arrival`` — the arrival process over virtual ticks:
      ``"poisson"`` (exponential interarrivals at the aggregate rate),
      ``"uniform"`` (uniform interarrivals with the same mean), or
      ``"burst"`` (groups of ``burst_size`` simultaneous arrivals, spaced
      so the aggregate rate is preserved — the adversarial profile for
      admission queueing).
    * the aggregate rate is ``num_users * requests_per_user_tick``
      requests per tick (AsyncFlow's user-population framing: scale load
      by population, not by retuning a rate constant).
    * ``prompt_lens`` / ``output_lens`` — :class:`LengthMix` draws per
      request (``output_lens`` samples ``max_new_tokens``).
    """

    name: str
    num_requests: int
    arrival: str
    prompt_lens: LengthMix
    output_lens: LengthMix
    num_users: int = 1
    requests_per_user_tick: float = 0.1
    burst_size: int = 8
    temperature: float = 0.0
    seed: int = 0
    # admission deadline (virtual ticks relative to each arrival); a
    # request not admitted to a slot in time is diverted to the queue's
    # rejected list with a "deadline exceeded" reason. None = patient.
    deadline: Optional[float] = None

    def __post_init__(self):
        _require(isinstance(self.name, str) and self.name != "",
                 "profile needs a non-empty name")
        _require(self.num_requests >= 1,
                 f"num_requests must be >= 1, got {self.num_requests}")
        _require(self.arrival in ARRIVALS,
                 f"unknown arrival process {self.arrival!r}; "
                 f"choose from {ARRIVALS}")
        _require(self.num_users >= 1,
                 f"num_users must be >= 1, got {self.num_users}")
        _require(self.requests_per_user_tick > 0,
                 "requests_per_user_tick must be > 0, got "
                 f"{self.requests_per_user_tick}")
        _require(self.burst_size >= 1,
                 f"burst_size must be >= 1, got {self.burst_size}")
        _require(self.temperature >= 0,
                 f"temperature must be >= 0, got {self.temperature}")
        _require(self.deadline is None or self.deadline > 0,
                 f"deadline must be > 0 ticks (or None), got {self.deadline}")

    @property
    def rate(self) -> float:
        """Aggregate arrival rate (requests per virtual tick)."""
        return self.num_users * self.requests_per_user_tick

    @property
    def max_rows(self) -> int:
        """Cache rows the longest possible request needs (prompt + new)."""
        return self.prompt_lens.max + self.output_lens.max

    @classmethod
    def from_dict(cls, obj: Dict[str, Any]) -> "TrafficProfile":
        _require(isinstance(obj, dict),
                 f"profile must be a mapping, got {type(obj).__name__}")
        unknown = set(obj) - _PROFILE_FIELDS
        _require(not unknown,
                 f"unknown profile keys: {sorted(unknown)} "
                 f"(allowed: {sorted(_PROFILE_FIELDS)})")
        missing = {"name", "num_requests", "arrival", "prompt_lens",
                   "output_lens"} - set(obj)
        _require(not missing, f"profile is missing {sorted(missing)}")
        kw = dict(obj)
        kw["prompt_lens"] = LengthMix.from_obj(kw["prompt_lens"], "prompt_lens")
        kw["output_lens"] = LengthMix.from_obj(kw["output_lens"], "output_lens")
        return cls(**kw)

    @classmethod
    def from_json(cls, path: str) -> "TrafficProfile":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> Dict[str, Any]:
        out = dataclasses.asdict(self)
        out["prompt_lens"] = self.prompt_lens.to_obj()
        out["output_lens"] = self.output_lens.to_obj()
        return out


def generate_arrivals(profile: TrafficProfile, vocab_size: int) -> List[Arrival]:
    """Expand a profile into a deterministic time-sorted arrival stream.

    One ``RandomState(profile.seed)`` draws, in a fixed order: arrival
    times, then per-request prompt lengths, output budgets, and prompt
    tokens — so a profile is a *complete* description of its workload and
    two runs (or two machines) see identical requests at identical times.
    """
    _require(vocab_size >= 2, f"vocab_size must be >= 2, got {vocab_size}")
    rng = np.random.RandomState(profile.seed)
    n, rate = profile.num_requests, profile.rate
    if profile.arrival == "poisson":
        times = np.cumsum(rng.exponential(1.0 / rate, size=n))
    elif profile.arrival == "uniform":
        times = np.cumsum(rng.uniform(0.0, 2.0 / rate, size=n))
    else:  # burst: groups of burst_size at instants preserving the rate
        group = np.arange(n) // profile.burst_size
        times = group * (profile.burst_size / rate)
    plens = profile.prompt_lens.sample(rng, n)
    budgets = profile.output_lens.sample(rng, n)
    arrivals = []
    for i in range(n):
        prompt = rng.randint(1, vocab_size, size=int(plens[i])).astype(np.int32)
        req = Request(prompt=prompt, max_new_tokens=int(budgets[i]),
                      temperature=profile.temperature,
                      deadline=profile.deadline)
        arrivals.append(Arrival(float(times[i]), req))
    return arrivals


def simulate(engine, profile: TrafficProfile, *, policy: str = "fifo",
             check: bool = True, step_time: float = 1.0) -> Dict[str, Any]:
    """Drive ``engine`` through a profile's arrival stream; return the
    serving-tier metrics payload.

    Deterministic fields (CI gates exactly): request counts, generated
    tokens, decode steps, all latency/TTFT percentiles and goodput (virtual
    ticks), and ``matches_sequential`` — the accepted requests replayed
    through ``generate_sequential`` with their *arrival indices*, so the
    PRNG key chain matches the batched run even under rejections.
    ``wall_s`` / ``tokens_s`` are informational hardware throughput.
    """
    vocab = engine.model.cfg.vocab_size
    arrivals = generate_arrivals(profile, vocab)
    queue = AdmissionQueue(arrivals, policy=policy, max_seq=engine.max_seq)
    t0 = time.perf_counter()
    engine.serve(queue, seed=profile.seed,
                 do_sample=profile.temperature > 0, step_time=step_time)
    wall = time.perf_counter() - t0
    stats = engine.last_stats

    reqs = [a.request for a in arrivals]
    accepted = [(i, r) for i, r in enumerate(reqs) if r.rejected is None]
    lat = np.array([r.finish_time - r.arrival_time for _, r in accepted])
    ttft = np.array([r.admitted_time - r.arrival_time for _, r in accepted])

    def pct(a: np.ndarray, q: float) -> float:
        return float(np.percentile(a, q)) if a.size else 0.0

    # schema_version 2: adds the rejection audit trail (per-rejection
    # virtual-clock timestamps + reasons, deadline counts). Additive only —
    # payloads from version 1 baselines stay comparable on shared keys.
    payload: Dict[str, Any] = dict(
        schema_version=2,
        profile=profile.name,
        arrival=profile.arrival,
        policy=policy,
        seed=profile.seed,
        temperature=profile.temperature,
        deadline=profile.deadline,
        n_requests=profile.num_requests,
        n_accepted=len(accepted),
        n_rejected=len(queue.rejected),
        n_deadline_rejected=sum(
            1 for rj in queue.rejected
            if rj.reason.startswith("deadline exceeded")
        ),
        rejections=[
            dict(index=rj.index, time=rj.time, reason=rj.reason)
            for rj in queue.rejected
        ],
        generated_tokens=stats["generated_tokens"],
        decode_steps=stats["decode_steps"],
        prefills=stats["prefills"],
        occupancy=stats["occupancy"],
        latency_p50_ticks=pct(lat, 50),
        latency_p99_ticks=pct(lat, 99),
        ttft_p50_ticks=pct(ttft, 50),
        ttft_p99_ticks=pct(ttft, 99),
        makespan_ticks=stats["makespan_ticks"],
        goodput_tokens_per_tick=(
            stats["generated_tokens"] / stats["makespan_ticks"]
            if stats["makespan_ticks"] else 0.0
        ),
        wall_s=wall,
        tokens_s=stats["generated_tokens"] / max(wall, 1e-12),
    )
    if engine.paged:
        payload["page_size"] = engine.page_size
        payload["pool_pages"] = engine.slots.allocator.n_pages
        payload["pages_peak_max"] = max(
            (r.pages_peak or 0 for _, r in accepted), default=0
        )

    if check:
        clones = [
            Request(prompt=r.prompt.copy(), max_new_tokens=r.max_new_tokens,
                    temperature=r.temperature)
            for _, r in accepted
        ]
        ref = engine.generate_sequential(
            clones, seed=profile.seed, indices=[i for i, _ in accepted]
        )
        payload["matches_sequential"] = all(
            c.out_tokens == r.out_tokens for c, (_, r) in zip(ref, accepted)
        )
    return payload
