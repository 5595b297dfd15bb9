"""Elastic runtime: failure detection, remesh planning, straggler policy.

Single-controller control plane for 1000+-node posture:

  * `FailureDetector` -- heartbeat registry with timeout; in production the
    heartbeats are RPC pings, here they are clocked injections (tests drive
    time explicitly, trainer hooks call `beat`).
  * `remesh_plan` -- given surviving host count and the current (pod, data,
    model) preference, pick the largest legal mesh: model parallelism is
    preserved (weights must still divide), the data axis absorbs the loss,
    stragglers/failures therefore only shrink global batch.
  * `StragglerMonitor` -- per-step latency ring; flags a straggler regime
    (p95/median ratio) and recommends the mitigation the trainer applies
    (skip-and-backfill for EA islands / microbatch rebalance for SGD).

Recovery path (exercised in tests/test_elastic.py): detector fires ->
remesh_plan -> checkpoint.restore(shardings on the new mesh) ->
Pipeline.resume(new shard split) -> continue at the same step.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple


class FailureDetector:
    def __init__(self, hosts: List[str], timeout_s: float = 10.0):
        self.timeout = timeout_s
        self.last: Dict[str, float] = {h: 0.0 for h in hosts}

    def beat(self, host: str, now: Optional[float] = None) -> None:
        self.last[host] = time.monotonic() if now is None else now

    def dead(self, now: Optional[float] = None) -> List[str]:
        t = time.monotonic() if now is None else now
        return [h for h, ts in self.last.items() if t - ts > self.timeout]

    def alive(self, now: Optional[float] = None) -> List[str]:
        d = set(self.dead(now))
        return [h for h in self.last if h not in d]


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    dropped_hosts: int


def remesh_plan(n_alive_chips: int, model_parallel: int,
                pods: int = 1) -> MeshPlan:
    """Largest (pod, data, model) mesh with `model_parallel` preserved.

    Model parallelism is a *correctness* constraint (weight shards must
    divide); data parallelism absorbs the capacity loss -- failures shrink
    the global batch, never the layout.
    """
    if n_alive_chips < model_parallel:
        raise RuntimeError(
            f"cannot keep model_parallel={model_parallel} with "
            f"{n_alive_chips} chips")
    per_pod = n_alive_chips // max(pods, 1)
    data = max(per_pod // model_parallel, 1)
    used = pods * data * model_parallel
    if pods > 1:
        return MeshPlan((pods, data, model_parallel),
                        ("pod", "data", "model"),
                        n_alive_chips - used)
    return MeshPlan((data, model_parallel), ("data", "model"),
                    n_alive_chips - used)


class StragglerMonitor:
    """Detects a straggler regime from step latencies (p95/median ratio)."""

    def __init__(self, window: int = 50, ratio: float = 2.0):
        self.durations: Deque[float] = deque(maxlen=window)
        self.ratio = ratio

    def record(self, seconds: float) -> None:
        self.durations.append(seconds)

    def straggling(self) -> bool:
        if len(self.durations) < 10:
            return False
        xs = sorted(self.durations)
        med = xs[len(xs) // 2]
        p95 = xs[int(0.95 * (len(xs) - 1))]
        return med > 0 and (p95 / med) > self.ratio

    def recommendation(self) -> str:
        if not self.straggling():
            return "none"
        # EA islands: lengthen migration period (bounded staleness).
        # SGD: shrink per-host microbatch + backup-step the slow host.
        return "rebalance"
