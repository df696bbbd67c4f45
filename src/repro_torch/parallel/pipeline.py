"""Pipeline parallelism over the 'pod' axis (an optional alternative to
pure pod data parallelism): a GPipe schedule planner and a functional
executor.

The port's copy of ``repro.parallel.pipeline`` (host logic on tensors). At
2 pods the win over pod-DP is marginal for these models (a gradient
all-reduce over 2 pods is cheap beside a 50% bubble at small microbatch
counts) — the planner makes that trade-off explicit, and the executor
exists so the schedule is testable end to end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch


@dataclass(frozen=True)
class PipelinePlan:
    n_stages: int
    n_microbatches: int

    @property
    def bubble_fraction(self) -> float:
        """GPipe bubble: (S-1)/(M+S-1)."""
        s, m = self.n_stages, self.n_microbatches
        return (s - 1) / (m + s - 1)

    def better_than_dp(self, *, grad_bytes: float, act_bytes_per_mb: float,
                       link_bw: float, step_compute_s: float) -> bool:
        """Compare PP bubble cost vs DP gradient all-reduce cost per step."""
        dp_cost = 2 * grad_bytes / link_bw          # cross-pod all-reduce
        pp_comm = self.n_microbatches * act_bytes_per_mb / link_bw
        pp_cost = step_compute_s * self.bubble_fraction + pp_comm
        return pp_cost < dp_cost


def plan(n_stages: int, global_batch: int, microbatch: int) -> PipelinePlan:
    return PipelinePlan(n_stages=n_stages, n_microbatches=max(1, global_batch // microbatch))


def gpipe_forward(stage_fns: Sequence[Callable], x_mbs: torch.Tensor) -> torch.Tensor:
    """GPipe forward over microbatches in one process (the single-host
    functional executor the tests drive).

    stage_fns: per-stage functions; x_mbs: (M, ...) microbatches. Returns
    (M, ...) outputs, run in the canonical skewed schedule: at tick t,
    stage s processes microbatch t - s.
    """
    S, M = len(stage_fns), x_mbs.shape[0]
    buf = [None] * S
    outs = []
    for t in range(M + S - 1):
        new_buf = [None] * S
        if t < M:
            new_buf[0] = stage_fns[0](x_mbs[t])
        for s in range(1, S):
            if buf[s - 1] is not None:
                new_buf[s] = stage_fns[s](buf[s - 1])
        if new_buf[S - 1] is not None:
            outs.append(new_buf[S - 1])
        buf = new_buf
    return torch.stack(outs)
