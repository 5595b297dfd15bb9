"""Pluggable pool-stepping policies for the placement scheduler.

`PlacementScheduler.step()` advances exactly ONE pool's batched step per
call; *which* pool is a scheduling decision, extracted here behind the
`SteppingPolicy` protocol so traffic classes beyond FIFO fairness can be
served without touching the slot machinery:

  * `round_robin` -- the PR 2 default: pools take turns; the rotation
    pointer advances past the stepped pool (and past skipped empty pools)
    so no pool can starve behind a perpetually busy neighbour,
  * `priority`    -- highest-priority work first: a pool's urgency is the
    max `priority` over its inflight + pending jobs; ties rotate
    round-robin so equal-priority pools still share the accelerator,
  * `deadline`    -- earliest-deadline-first: a pool's urgency is the
    min `deadline` over inflight + pending jobs (absent deadlines sort
    last); ties rotate.

Policies only ever choose among pools with active slots, see a read-only
`PoolView` snapshot, and are consulted once per `step()` -- they cannot
change job results (per-job trajectories are pure functions of the job
spec; see `serve.placement_service`), only completion *order* and
latency.  `get_policy` resolves a name or passes an instance through.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Protocol, Sequence


@dataclasses.dataclass
class PoolView:
    """Read-only pool snapshot handed to a policy, one per known pool.

    `jobs` covers inflight + pending fleet jobs (each with `priority` /
    `deadline` attributes); `steppable` is whether stepping this pool now
    would advance any active slot.
    """

    key: Any
    index: int                 # stable position in the scheduler's rotation
    steppable: bool
    queue_depth: int
    jobs: List[Any]


class SteppingPolicy(Protocol):
    """Chooses which pool's batched step runs next."""

    name: str

    def select(self, views: Sequence[PoolView]) -> Optional[int]:
        """Index (into `views`) of the pool to step, or None if no pool is
        steppable.  Called once per scheduler step; may keep state (e.g. a
        rotation pointer)."""
        ...


class RoundRobinPolicy:
    """Fair rotation: each call starts scanning one past the last pool it
    stepped, so a busy pool cannot shadow the pools after it."""

    name = "round_robin"

    def __init__(self) -> None:
        self._next = 0

    def select(self, views: Sequence[PoolView]) -> Optional[int]:
        n = len(views)
        if n == 0:
            return None
        start = self._next % n
        for off in range(n):
            i = (start + off) % n
            if views[i].steppable:
                self._next = (i + 1) % n
                return i
        return None


class _UrgencyPolicy:
    """Shared shape of priority/deadline: score steppable pools, pick the
    best, rotate among ties so equal-urgency pools share the device."""

    def __init__(self) -> None:
        self._tick = 0
        self._last_stepped: dict = {}

    def _score(self, view: PoolView) -> float:
        raise NotImplementedError

    def select(self, views: Sequence[PoolView]) -> Optional[int]:
        best_i, best_rank = None, None
        for i, v in enumerate(views):
            if not v.steppable:
                continue
            # least-recently-stepped breaks score ties fairly
            rank = (self._score(v), self._last_stepped.get(v.key, -1))
            if best_rank is None or rank < best_rank:
                best_i, best_rank = i, rank
        if best_i is not None:
            self._tick += 1
            self._last_stepped[views[best_i].key] = self._tick
        return best_i


class PriorityPolicy(_UrgencyPolicy):
    """Weighted service: the pool holding the highest-priority job steps
    first (higher `priority` = more urgent; default 0.0)."""

    name = "priority"

    def _score(self, view: PoolView) -> float:
        best = max((float(getattr(j, "priority", 0.0) or 0.0)
                    for j in view.jobs), default=0.0)
        return -best                     # min-rank = highest priority


class DeadlinePolicy(_UrgencyPolicy):
    """Earliest-deadline-first over pending + inflight jobs; jobs without a
    deadline sort after every dated one."""

    name = "deadline"

    def _score(self, view: PoolView) -> float:
        return min((float(j.deadline) for j in view.jobs
                    if getattr(j, "deadline", None) is not None),
                   default=math.inf)


_POLICIES = {
    "round_robin": RoundRobinPolicy,
    "priority": PriorityPolicy,
    "deadline": DeadlinePolicy,
}


def get_policy(policy) -> SteppingPolicy:
    """Resolve a policy name to a fresh instance; instances pass through."""
    if isinstance(policy, str):
        try:
            return _POLICIES[policy]()
        except KeyError:
            raise KeyError(f"unknown stepping policy {policy!r}; "
                           f"have {sorted(_POLICIES)}") from None
    if not callable(getattr(policy, "select", None)):
        raise TypeError(f"policy must be a name or expose select(); "
                        f"got {type(policy)}")
    return policy
