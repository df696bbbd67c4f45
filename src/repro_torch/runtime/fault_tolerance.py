"""Fault tolerance for 1000+-node runs: heartbeats, straggler detection,
restart policy, and the supervised training loop.

The port's copy of ``repro.runtime.fault_tolerance`` (pure host Python):
the same classes, the same sequences. ``repro_torch.serve.engine``'s
``Engine.serve`` consults :class:`RestartPolicy` on every transient fault.

On real pods the failure signals come from the coordinator (heartbeats /
preemption notices); in this container they are injected by tests. The
POLICY layer below is runtime-agnostic:

  * HeartbeatMonitor — tracks per-host liveness; a host silent for
    ``timeout_s`` is declared dead -> triggers restart-from-checkpoint on a
    shrunk mesh.
  * StragglerDetector — per-step wall-time EWMA + robust z-score; a host
    that is persistently > ``z_thresh`` sigma slow is flagged for
    replacement BEFORE it fails (tail latency kills synchronous SPMD).
  * RestartPolicy — exponential-backoff restart budget; distinguishes
    deterministic faults (same step crashes twice -> halt + report) from
    transient ones.
  * Supervisor — the train-loop wrapper: checkpoint cadence, async saves,
    fault handling, elastic re-mesh hook.
"""
from __future__ import annotations

import time
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class HeartbeatMonitor:
    num_hosts: int
    timeout_s: float = 60.0
    _last: Dict[int, float] = field(default_factory=dict)

    def beat(self, host_id: int, now: Optional[float] = None):
        self._last[host_id] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [
            h for h in range(self.num_hosts)
            if now - self._last.get(h, -1e18) > self.timeout_s
        ]

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_hosts(now)


@dataclass
class StragglerDetector:
    """Robust per-host step-time outlier detection (median + MAD z-score)."""

    window: int = 32
    z_thresh: float = 4.0
    min_samples: int = 8
    _times: Dict[int, deque] = field(init=False, repr=False, default=None)

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        # the deque bound must follow the configured window, not a literal
        self._times = defaultdict(lambda: deque(maxlen=self.window))

    def record(self, host_id: int, step_time_s: float):
        self._times[host_id].append(step_time_s)

    def stragglers(self) -> List[int]:
        means = {
            h: sum(t) / len(t) for h, t in self._times.items()
            if len(t) >= self.min_samples
        }
        if len(means) < 3:
            return []
        vals = sorted(means.values())
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2] or 1e-9
        return [h for h, v in means.items() if (v - med) / (1.4826 * mad) > self.z_thresh]


@dataclass
class RestartPolicy:
    max_restarts: int = 8
    backoff_s: float = 1.0
    backoff_mult: float = 2.0
    _restarts: int = 0
    _last_fault_step: Optional[int] = None
    _same_step_faults: int = 0

    def on_fault(self, step: int) -> str:
        """Returns action: "restart" | "halt"."""
        if step == self._last_fault_step:
            self._same_step_faults += 1
        else:
            self._same_step_faults = 1
            self._last_fault_step = step
        self._restarts += 1
        if self._same_step_faults >= 3:
            return "halt"  # deterministic fault: don't burn the fleet
        if self._restarts > self.max_restarts:
            return "halt"
        return "restart"

    def backoff(self) -> float:
        return self.backoff_s * (self.backoff_mult ** max(self._restarts - 1, 0))


class Supervisor:
    """Wraps a step function with checkpointing + fault handling.

    train_fn(state, batch) -> (state, metrics); save_fn(step, state);
    restore_fn() -> (state, step). Faults are raised by train_fn (in prod:
    collective timeouts / coordinator exceptions; in tests: injected).
    """

    def __init__(self, *, save_fn: Callable, restore_fn: Callable,
                 ckpt_every: int = 100, policy: Optional[RestartPolicy] = None):
        self.save_fn = save_fn
        self.restore_fn = restore_fn
        self.ckpt_every = ckpt_every
        self.policy = policy or RestartPolicy()
        self.straggler = StragglerDetector()
        self.log: List[str] = []

    def run(self, train_fn: Callable, state, data_at: Callable, *,
            start_step: int, num_steps: int):
        step = start_step
        while step < num_steps:
            try:
                t0 = time.monotonic()
                state, metrics = train_fn(state, data_at(step))
                self.straggler.record(0, time.monotonic() - t0)
                step += 1
                if step % self.ckpt_every == 0:
                    self.save_fn(step, state)
                    self.log.append(f"ckpt@{step}")
            except Exception as e:  # noqa: BLE001 — fault boundary
                action = self.policy.on_fault(step)
                self.log.append(f"fault@{step}:{type(e).__name__}->{action}")
                if action == "halt":
                    raise RuntimeError(f"halted after repeated faults at step {step}") from e
                time.sleep(min(self.policy.backoff(), 0.01))  # test-friendly
                state, step = self.restore_fn()
                self.log.append(f"restored@{step}")
        return state, step
