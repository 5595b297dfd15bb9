"""The serve-layer public API: one request type, one handle type, one
versioned stats schema.

Until PR 9 the serve layer had two drifted `submit()` signatures
(`PlacementService.submit(cfg=, seed=, budget=, ...)` vs
`PlacementScheduler.submit(device, cfg, algo=, priority=, ...)`), callers
poked `job.result is not None` / `j.done` to learn job state, and
`stats()` returned ad-hoc dicts whose keys drifted per layer.  This module
is the single place the serving surface is defined:

  * **`JobRequest`** -- a frozen dataclass describing one placement job
    end to end (device, cfg, algo, seed, budget, target, priority,
    deadline, init_state, islands, fused, ...).  Both
    `PlacementService.submit` and `PlacementScheduler.submit` accept it;
    their old kwarg forms remain as thin shims that build a `JobRequest`
    and emit a `DeprecationWarning`.  A request is *pure data*: submitting
    the same request always produces bitwise the same result, whichever
    entry point or concurrency level carried it.
  * **`JobStatus` / `JobHandle`** -- the one job-lifecycle surface:
    `.status` (QUEUED / RUNNING / DONE / FAILED / CANCELLED),
    `.result(timeout=...)`, `.exception()`, `.cancel()`, and -- when the
    handle is served by the asyncio front-end (`serve.frontend`) --
    `await handle.wait()` and `async for update in handle.progress()`.
    The pre-PR attributes (`.done`, `.failed`) survive as deprecated
    properties so PR 1-8 call sites keep running.
  * **`ServiceStats` / `FleetStats` / `FrontendStats`** -- TypedDicts
    documenting every key `stats()` returns, stamped with
    `schema_version = STATS_SCHEMA_VERSION` so bench tooling
    (`benchmarks/bench_service.py`, `benchmarks/check_bench.py`) can read
    typed keys instead of guessing.

Nothing here touches jitted code: the API layer is pure host-side
bookkeeping, so adopting it cannot change placement results.
"""
from __future__ import annotations

import collections
import dataclasses
import enum
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple

from typing import TypedDict

from repro_torch.core.islands import IslandConfig

# bump when a stats key is renamed or changes meaning; ADDING keys is the
# normal append-only path and does not bump the version.
# v1 -> v2 (observability PR): no key was renamed or removed -- v2 marks
# the point where every layer's stats() carries the telemetry keys
# (latency histograms, convergence tails) and where the previously
# unversioned Prewarmer/ChampionStore dicts joined the versioned schema
# via `stats_payload()`.  v1 readers keep working on every old key.
STATS_SCHEMA_VERSION = 2


def stats_payload(**keys: Any) -> Dict[str, Any]:
    """The one way a serve-layer `stats()` builds its dict: stamps
    `schema_version` as the first key so the five builders
    (service/scheduler/frontend/prewarmer/champion store) cannot drift
    apart on the envelope.  Keys stay append-only per the bench contract.
    """
    out: Dict[str, Any] = {"schema_version": STATS_SCHEMA_VERSION}
    out.update(keys)
    return out


class JobStatus(enum.Enum):
    """Lifecycle of one placement job, whichever layer serves it."""

    QUEUED = "queued"          # accepted; waiting for a slot
    RUNNING = "running"        # occupying a pool slot, evolving
    DONE = "done"              # harvested; result available
    FAILED = "failed"          # admission/stepping error; exception set
    CANCELLED = "cancelled"    # cancelled before completion; slot freed

    @property
    def terminal(self) -> bool:
        return self in (JobStatus.DONE, JobStatus.FAILED,
                        JobStatus.CANCELLED)


class QueueFull(RuntimeError):
    """Non-blocking admission found the bounded queue at capacity."""


class JobFailedError(RuntimeError):
    """A job was surfaced as failed (repeated admission errors or a
    stepping-thread crash); the message carries the original note."""


class JobCancelledError(RuntimeError):
    """`result()` was called on a cancelled job."""


@dataclasses.dataclass(frozen=True, eq=False)
class JobRequest:
    """Everything that defines one placement job, as pure data.

    The result of a request is a pure function of
    (cfg, seed, budget, init_state, jitter, sigma_shrink) -- admission
    timing, co-tenant jobs, priorities and deadlines change *latency
    only*, never the answer (see `serve.placement_service`).

    Fields consumed by both layers: `cfg`, `seed`, `budget`, `target`,
    `init_state`, `jitter`, `sigma_shrink`, `fused`.  Scheduler-level
    routing fields (`device`, `algo`, `gens_per_step`, `islands`) and
    policy fields (`priority`, `deadline`) are ignored by a bare
    `PlacementService` pool except for validation (a request whose `algo`
    or `islands` disagrees with the pool is rejected loudly, not
    silently re-routed).

    `fused=None` leaves the config's own `fused` flag alone; True/False
    overrides it via `dataclasses.replace` (static pool identity, see
    `kernels.fused_eval`).  `seed=None` lets the admitting layer pick its
    deterministic default (the job id); pass an explicit seed whenever
    you care about reproducibility across submission orders.
    """

    device: Optional[str] = None
    cfg: Any = None
    algo: str = "nsga2"
    seed: Optional[int] = None
    budget: int = 64
    target: Optional[float] = None
    priority: float = 0.0
    deadline: Optional[float] = None
    init_state: Any = None
    islands: Optional[IslandConfig] = None
    fused: Optional[bool] = None
    gens_per_step: Optional[int] = None
    jitter: float = 0.15
    sigma_shrink: float = 0.25
    # observability only -- minted by the outermost layer that sees the
    # request when tracing is enabled; NOT part of the purity tuple (two
    # requests differing only in trace_id produce bitwise the same result)
    trace_id: Optional[str] = None

    def replace(self, **kw: Any) -> "JobRequest":
        return dataclasses.replace(self, **kw)

    def resolved_cfg(self, base_cfg: Any = None) -> Any:
        """The effective algorithm config: the request's own (falling back
        to `base_cfg`), with the `fused` override applied when set."""
        cfg = self.cfg if self.cfg is not None else base_cfg
        if (self.fused is not None and cfg is not None
                and hasattr(cfg, "fused") and cfg.fused != self.fused):
            cfg = dataclasses.replace(cfg, fused=self.fused)
        return cfg


def deprecated_kwargs_request(layer: str, **kw: Any) -> JobRequest:
    """Build a `JobRequest` from a legacy kwarg-form `submit()` call and
    emit the deprecation notice (shared by both shims, so the message and
    the stacklevel stay consistent)."""
    warnings.warn(
        f"{layer}.submit(**kwargs) is deprecated; build a "
        "serve.api.JobRequest and pass it instead (results are "
        "bitwise identical)", DeprecationWarning, stacklevel=3)
    return JobRequest(**kw)


@dataclasses.dataclass(frozen=True)
class ProgressUpdate:
    """One generation-boundary snapshot of a running job, streamed by
    `JobHandle.progress()`.

    `best_objs` is the (wl^2, max bbox) objective vector of the job's
    current champion; `eta_s` extrapolates remaining wallclock from the
    generations already served (None until the first boundary, None again
    whenever extrapolation would be garbage -- see
    `frontend._extrapolate_eta`).  `convergence` is the tail of the job's
    per-step convergence ring -- `(gens, metric)` pairs recorded at step
    boundaries -- so a progress consumer can plot the paper's Fig. 7
    curve live without waiting for the job to finish."""

    jid: int
    status: JobStatus
    gens: int
    budget: int
    metric: float
    best_objs: Any
    eta_s: Optional[float] = None
    convergence: Tuple[Tuple[int, float], ...] = ()


@dataclasses.dataclass(frozen=True)
class JobTrace:
    """`JobHandle.trace()`: everything recorded about one job's journey.

    `events` is the job's slice of the process tracer (empty unless
    tracing was enabled -- `serve.tracing.enabled()`); `convergence` is
    the full `(gens, metric)` history the handle accumulated from
    progress pushes (always on; bounded ring).  `phases` folds the
    begin/end span pairs among the events into `(name, seconds)` tuples.
    """

    trace_id: Optional[str]
    events: Tuple[Any, ...]
    convergence: Tuple[Tuple[int, float], ...]

    @property
    def phases(self) -> List[Tuple[str, float]]:
        from repro_torch.serve import tracing
        return tracing.span_pairs(list(self.events))


class JobHandle:
    """The one job-state surface callers hold, whichever layer serves it.

    Synchronous consumers use `.status`, `.result(timeout=...)`,
    `.exception()` and `.cancel()`; consumers inside the asyncio
    front-end additionally get `await handle.wait()` and
    `async for update in handle.progress()`.  Thread-safe: the serving
    layer resolves the handle from its stepping thread, callers may poll
    from any thread or task.
    """

    # progress buffer depth: a slow consumer sees the freshest updates,
    # never an unbounded backlog
    PROGRESS_BUFFER = 64
    # convergence ring depth: independent of the progress buffer because
    # trace() must see the whole curve even after progress() consumed the
    # updates (the deque is drained by iteration, this ring is not)
    CONVERGENCE_BUFFER = 256

    def __init__(self, jid: int, request: JobRequest) -> None:
        self.jid = jid
        self.request = request
        self._status = JobStatus.QUEUED
        self._result: Any = None           # PlacementJob once DONE
        self._exception: Optional[BaseException] = None
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._progress: collections.deque = collections.deque(
            maxlen=self.PROGRESS_BUFFER)
        self._convergence: collections.deque = collections.deque(
            maxlen=self.CONVERGENCE_BUFFER)
        self._cancel_fn = None             # installed by the serving layer
        # async plumbing (installed by serve.frontend when it owns the
        # handle): loop + event woken on every state/progress change
        self._loop = None
        self._aevent = None

    # ----------------------------------------------------------- reading

    @property
    def status(self) -> JobStatus:
        return self._status

    def result(self, timeout: Optional[float] = None):
        """Block until the job reaches a terminal state and return its
        `PlacementJob` result.  Raises `TimeoutError` on timeout, the
        recorded exception for FAILED, `JobCancelledError` for
        CANCELLED."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.jid} not finished within {timeout}s "
                f"(status={self._status.value})")
        if self._status is JobStatus.CANCELLED:
            raise JobCancelledError(f"job {self.jid} was cancelled")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[BaseException]:
        """Block until terminal; return the job's exception (None for
        DONE / CANCELLED)."""
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.jid} not finished within {timeout}s")
        return self._exception

    def trace(self) -> JobTrace:
        """Everything recorded about this job: its tracer events (when
        tracing is enabled) and its convergence curve (always).  Valid at
        any point in the lifecycle; after a terminal event it is the
        job's complete history."""
        from repro_torch.serve import tracing
        tid = self.request.trace_id if self.request is not None else None
        events = tuple(tracing.tracer().events(tid)) if tid else ()
        with self._lock:
            conv = tuple(self._convergence)
        return JobTrace(trace_id=tid, events=events, convergence=conv)

    def cancel(self) -> bool:
        """Request cancellation: the slot is freed at the next step
        boundary.  Returns False when the job is already terminal (too
        late), True when the request was accepted.  Terminal state after
        a successful cancel is CANCELLED (observe via `result()` /
        `wait()`)."""
        with self._lock:
            if self._status.terminal:
                return False
            fn = self._cancel_fn
        if fn is None:
            return False
        return bool(fn(self.jid))

    # ------------------------------------------------ async (frontend)

    async def wait(self):
        """Async `result()`: await terminal state, return the result (or
        raise, same contract as `result()`)."""
        if self._aevent is None:
            raise RuntimeError(
                "handle is not attached to an async front-end; use "
                "result(timeout=...) instead")
        while not self._done.is_set():
            await self._aevent.wait()
            self._aevent.clear()
        return self.result()

    async def progress(self):
        """Async iterator of `ProgressUpdate`s, one per step boundary the
        job was alive for, ending when the job reaches a terminal state.
        A slow consumer is never a backpressure source: updates overwrite
        a bounded ring, so it sees the freshest `PROGRESS_BUFFER`."""
        if self._aevent is None:
            raise RuntimeError(
                "progress streaming needs the async front-end "
                "(serve.frontend.PlacementFrontend)")
        while True:
            while True:
                with self._lock:
                    if not self._progress:
                        break
                    update = self._progress.popleft()
                yield update
            if self._done.is_set():
                return
            await self._aevent.wait()
            self._aevent.clear()

    # --------------------------------------- resolution (serving layer)

    def _attach_async(self, loop, aevent) -> None:
        self._loop = loop
        self._aevent = aevent

    def _wake(self) -> None:
        if self._loop is not None and self._aevent is not None:
            try:
                self._loop.call_soon_threadsafe(self._aevent.set)
            except RuntimeError:
                pass                       # loop already closed

    def _mark_running(self) -> None:
        with self._lock:
            if self._status is JobStatus.QUEUED:
                self._status = JobStatus.RUNNING

    def _push_progress(self, update: ProgressUpdate) -> None:
        with self._lock:
            self._progress.append(update)
            # accumulate the convergence curve separately: progress() is a
            # consuming iterator, trace() wants the whole history
            if (not self._convergence
                    or self._convergence[-1][0] != update.gens):
                self._convergence.append((update.gens, update.metric))
        self._wake()

    def _resolve(self, result: Any) -> None:
        with self._lock:
            if self._status.terminal:
                return
            self._status = JobStatus.DONE
            self._result = result
        self._done.set()
        self._wake()

    def _fail(self, exc: BaseException) -> None:
        with self._lock:
            if self._status.terminal:
                return
            self._status = JobStatus.FAILED
            self._exception = exc
        self._done.set()
        self._wake()

    def _cancelled(self) -> None:
        with self._lock:
            if self._status.terminal:
                return
            self._status = JobStatus.CANCELLED
        self._done.set()
        self._wake()

    # ------------------------------------------- deprecated (PR 1-8 API)

    @property
    def done(self) -> bool:
        """Deprecated: use `handle.status is JobStatus.DONE`."""
        warnings.warn("JobHandle.done is deprecated; use handle.status",
                      DeprecationWarning, stacklevel=2)
        return self._status is JobStatus.DONE

    @property
    def failed(self) -> bool:
        """Deprecated: use `handle.status is JobStatus.FAILED`."""
        warnings.warn("JobHandle.failed is deprecated; use handle.status",
                      DeprecationWarning, stacklevel=2)
        return self._status is JobStatus.FAILED

    def __repr__(self) -> str:
        return (f"JobHandle(jid={self.jid}, "
                f"status={self._status.value})")


# ---------------------------------------------------------- stats schemas

class ServiceStats(TypedDict):
    """`PlacementService.stats()`: one pool's serving + compile counters.

    Conventions (shared with `FleetStats` / `FrontendStats`): counters are
    bare nouns (`steps`, `useful_gens`), rates/latencies carry their unit
    suffix (`*_ms`, `*_secs`), booleans read as predicates.  Keys are
    append-only; renames bump `STATS_SCHEMA_VERSION`.
    """

    schema_version: int
    n_slots: int
    gens_per_step: int
    steps: int
    useful_gens: int
    step_compiles: int         # must stay 1 per slot-count ladder size
    sizes: List[int]           # every slot count this pool compiled
    n_islands: int
    migrate_every: int
    jobs_cancelled: int        # slots freed early by cancel()
    blocking_compiles: int
    blocking_compile_secs: float
    prewarm_compiles: int
    prewarm_compile_secs: float
    prewarmed_sizes: List[int]
    time_to_first_gen_ms: Optional[float]
    compiles_total: int
    recompiles_total: int
    compile_secs_total: float
    persistent_cache_dir: Optional[str]
    # --- appended under schema_version 2 (observability) ---
    step_ms_hist: Dict[str, Any]       # Histogram.to_dict() of step wall ms
    convergence: Dict[str, Any]        # jid -> tail of (gens, metric) ring
    tracing_enabled: bool


class FleetStats(TypedDict):
    """`PlacementScheduler.stats()`: fleet-level routing counters plus a
    per-pool map of `ServiceStats` (each augmented with `queue_depth`)."""

    schema_version: int
    n_pools: int
    jobs_submitted: int
    jobs_done: int
    jobs_failed: int
    jobs_cancelled: int
    policy: str
    autoscale_events: List[Tuple[str, int, int]]
    pools: Dict[str, Any]      # label -> ServiceStats + queue_depth
    # --- appended under schema_version 2 (observability) ---
    job_latency_ms_hist: Dict[str, Any]  # submit -> terminal wall ms
    # optional sections (present when the feature is attached):
    #   cache: ChampionStore.stats()      prewarm: Prewarmer.stats()


class FrontendStats(TypedDict):
    """`PlacementFrontend.stats()`: admission/backpressure counters around
    the wrapped scheduler's `FleetStats` (under the `fleet` key)."""

    schema_version: int
    max_queue: int
    submitted: int
    admitted: int
    completed: int
    cancelled: int
    failed: int
    backpressure_waits: int    # submits that had to await a credit
    queue_full_rejections: int  # submit_nowait calls that raised QueueFull
    draining: bool
    fleet: Any                 # FleetStats of the owned scheduler
    # --- appended under schema_version 2 (observability) ---
    job_latency_ms_hist: Dict[str, Any]  # async submit -> terminal wall ms
    tracing_enabled: bool
