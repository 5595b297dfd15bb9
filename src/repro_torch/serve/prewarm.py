"""AOT pool prewarming: build off the stepping loop, adopt when ready.

Port of `repro/serve/prewarm.py`; the code below this docstring is the
reference's but for its import line.  What a prewarm moves off the
stepping thread differs: eager PyTorch compiles no program per shape, so
the scheduler's pools block on two things instead -- the nvcc build of
the CUDA kernel libraries on the first launch of any kernel (persisted
across processes by `runtime.compile_cache`), and the first use of a
pool's shapes: the caching allocator's first allocations at a slot count
and the first pass through the batched step.  This module moves both onto
a worker thread:

  * `prewarm_pool(key, builder)` -- build a complete `PlacementService`
    for a pool signature on the worker thread (its fill and first
    evaluations run there, building the kernels if no library is built
    yet); `PlacementScheduler._pool` adopts the finished pool via
    `take(key)` instead of constructing synchronously,
  * `prewarm_grow(pool, n_slots)` -- run `pool.prewarm_size(n_slots)` on
    the worker thread: the pool's batched step at the larger slot count,
    on throwaway state, before the autoscaler's `grow()` lands,
  * predictions -- the `ChampionStore` records signature traffic
    (`note_traffic`/`predicted_keys`), so a fresh process can prewarm the
    pools its historical traffic says are coming
    (`PlacementScheduler.prewarm_predicted`).

Correctness contract: prewarming only moves *work that does not change
results* between threads.  A prewarmed pool is built by the exact builder
the scheduler would have called synchronously (same constructor
arguments, same seed), so per-job results stay pure functions of (config,
seed, budget, init_state) -- bitwise identical to a cold pool.  A failed
background build is recorded (`errors`) and `take()` returns None, so the
scheduler falls back to synchronous creation: prewarm failures cost
latency, never jobs.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Optional, Tuple

from repro_torch.serve import api


class Prewarmer:
    """Single worker thread executing pool builds / grow prewarms FIFO.

    One worker is deliberate: compilation is process-global (jit caches,
    persistent cache) and the point is to overlap compile with *stepping*,
    not to compile in parallel with itself.  The thread is a daemon and
    starts lazily on the first task.
    """

    def __init__(self, name: str = "pool-prewarm"):
        self._cv = threading.Condition()
        self._tasks: deque = deque()           # (kind, tag, thunk)
        self._inflight: Optional[Tuple[str, Any]] = None
        self._ready: Dict[Any, Any] = {}       # pool key -> built pool
        self._known: set = set()               # tags ever enqueued
        self.errors: Dict[str, str] = {}       # repr(tag) -> error note
        self.builds_done = 0
        self.grows_done = 0
        self.failures = 0
        self.adopted = 0
        self._name = name
        self._thread: Optional[threading.Thread] = None
        self._stop = False

    # ----------------------------------------------------------- enqueue

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop = False
            self._thread = threading.Thread(target=self._loop,
                                            name=self._name, daemon=True)
            self._thread.start()

    def _enqueue(self, kind: str, tag: Any, thunk: Callable[[], Any]
                 ) -> bool:
        with self._cv:
            if tag in self._known:
                return False                   # already queued/built/failed
            self._known.add(tag)
            self._tasks.append((kind, tag, thunk))
            self._cv.notify_all()
        self._ensure_thread()
        return True

    def prewarm_pool(self, key: Any, builder: Callable[[], Any]) -> bool:
        """Schedule a background pool build for `key`; returns False when
        the key was already requested (dedup, not an error)."""
        return self._enqueue("build", key, builder)

    def prewarm_grow(self, pool: Any, n_slots: int) -> bool:
        """Schedule `pool.prewarm_size(n_slots)` on the worker thread."""
        tag = ("grow", id(pool), int(n_slots))
        return self._enqueue("grow", tag,
                             lambda: pool.prewarm_size(n_slots))

    # ------------------------------------------------------------ consume

    def take(self, key: Any) -> Optional[Any]:
        """Pop the finished pool for `key` (None while building, after a
        failed build, or when never requested -- callers fall back to a
        synchronous build in every None case)."""
        with self._cv:
            pool = self._ready.pop(key, None)
            if pool is not None:
                self.adopted += 1
            return pool

    def pending(self, key: Any) -> bool:
        """True while `key`'s build is queued or running."""
        with self._cv:
            if self._inflight is not None and self._inflight[1] == key:
                return True
            return any(tag == key for _, tag, _ in self._tasks)

    def wait_idle(self, timeout: float = 120.0) -> bool:
        """Block until the queue drains (tests / orderly shutdown)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._tasks or self._inflight is not None:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(left)
            return True

    def stop(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    def close(self, timeout: float = 30.0) -> None:
        """Orderly shutdown: stop accepting work and join the worker.

        The in-flight task (if any) runs to completion -- interrupting an
        XLA compile mid-flight is not safe -- but queued tasks are
        abandoned.  Idempotent; safe to call when the thread never started.
        """
        with self._cv:
            self._tasks.clear()
            self._stop = True
            self._cv.notify_all()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout)

    # ------------------------------------------------------------- worker

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._tasks and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
                kind, tag, thunk = self._tasks.popleft()
                self._inflight = (kind, tag)
            try:
                out = thunk()
                with self._cv:
                    if kind == "build":
                        self._ready[tag] = out
                        self.builds_done += 1
                    else:
                        self.grows_done += 1
            except Exception as e:             # noqa: BLE001 -- a failed
                # prewarm must never kill the worker; the scheduler falls
                # back to a synchronous build and the error is surfaced
                with self._cv:
                    self.failures += 1
                    self.errors[repr(tag)] = f"{type(e).__name__}: {e}"
            finally:
                with self._cv:
                    self._inflight = None
                    self._cv.notify_all()

    # -------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._cv:
            return api.stats_payload(
                builds_done=self.builds_done,
                grows_done=self.grows_done,
                adopted=self.adopted,
                failures=self.failures,
                queued=len(self._tasks),
                ready=len(self._ready),
                errors=dict(self.errors),
            )
