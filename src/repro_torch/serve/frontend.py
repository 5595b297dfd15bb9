"""Asyncio job front-end: submit / stream-progress / cancel over a
background stepping thread.

Until PR 9 the serve layer was hand-pumped: callers owned the stepping
loop (`while sched.busy: sched.step()`), so a process serving concurrent
clients had to invent its own threading, its own admission control, and
its own job-state plumbing.  `PlacementFrontend` is that missing layer:

  * **one stepping thread** -- the front-end owns a daemon thread that is
    the ONLY code touching the wrapped `PlacementScheduler`.  Client
    coroutines talk to it through a command queue (submit / cancel), and
    it talks back by resolving `serve.api.JobHandle`s and scheduling
    wake-ups onto the event loop (`loop.call_soon_threadsafe`).  Because
    every scheduler call -- admission, stepping, cancellation -- happens
    on that one thread, cancels land *between* `step()` calls, i.e.
    exactly at the step boundary the slot contract requires, and the
    single-step-compile / zero-blocking-compile-grow invariants are
    untouched (compiles just happen on the stepping thread, where
    `runtime.compile_cache.CompileMeter` scopes them per-thread already).
  * **bounded admission with backpressure** -- at most `max_queue` jobs
    may be outstanding (submitted, not yet terminal).  `await submit()`
    suspends the *caller* when the bound is hit and resumes it as slots
    drain; `submit_nowait()` raises `serve.api.QueueFull` instead.  The
    stepping thread never blocks on admission and a slow progress
    consumer never blocks the stepping thread (bounded per-handle ring).
  * **streaming progress** -- after every scheduler step the front-end
    pushes a `ProgressUpdate` (generation, best objectives, metric) into
    each running job's handle, adding an `eta_s` extrapolated from that
    job's own generation throughput; consume with
    `async for update in handle.progress()`.
  * **graceful shutdown** -- `drain()` stops admission and waits for
    every outstanding job to finish; `aclose()` drains, joins the
    stepping thread, then `scheduler.close()` (persist the champion
    store, stop the prewarm worker).  `async with PlacementFrontend(...)`
    does both ends.

Correctness contract: the front-end adds *concurrency*, never *state* --
per-job results remain pure functions of (config, seed, budget,
init_state) because the scheduler underneath is stepped exactly as a
synchronous caller would step it, just from another thread.  Submission
order, backpressure stalls, cancellations of co-tenant jobs and progress
consumers change latency only (verified by the concurrent-vs-sequential
determinism test in `tests/test_frontend.py`).

Typical use::

    sched = PlacementScheduler(n_slots=4, store=store, prewarm=True)
    async with PlacementFrontend(sched, max_queue=32) as fe:
        handle = await fe.submit(JobRequest(device="xcvu3p-quad",
                                            cfg=cfg, seed=7, budget=64))
        async for update in handle.progress():
            print(update.gens, update.metric, update.eta_s)
        result = await handle.wait()
"""
from __future__ import annotations

import asyncio
import collections
import dataclasses
import math
import threading
import time
from typing import Deque, Dict, List, Optional, Set, Tuple

from repro_torch.runtime import telemetry
from repro_torch.serve import api, tracing
from repro_torch.serve.api import (FrontendStats, JobFailedError, JobHandle,
                             JobRequest, QueueFull)
from repro_torch.serve.scheduler import PlacementScheduler

__all__ = ["PlacementFrontend"]

# same registry instrument the scheduler records into, under its own
# layer label (frontend latency = async submit -> terminal, the
# end-to-end number a client actually experiences)
_M_LATENCY = telemetry.registry().histogram(
    "repro_job_latency_ms", "Submit -> terminal wall ms, per layer",
    buckets=telemetry.DEFAULT_LATENCY_BUCKETS_MS)


def _extrapolate_eta(gens: int, budget: int, elapsed: float,
                     metric: Optional[float] = None) -> Optional[float]:
    """Remaining-wallclock estimate from a job's own generation
    throughput, or None whenever extrapolation would be garbage:

      * no generations served yet (`gens <= 0`) -- nothing to extrapolate,
      * elapsed time ~0 (first boundary landing within clock resolution)
        -- per-gen rate would divide by ~zero and explode,
      * the metric is not finite yet (no evaluated champion, so the job
        has not measurably progressed) -- an ETA would suggest progress
        that has not happened.

    Never negative: a job past its (quantized-up) budget reads 0.0.
    """
    if gens <= 0 or elapsed <= 1e-6:
        return None
    if metric is not None and not math.isfinite(metric):
        return None
    return max(elapsed / gens * (budget - gens), 0.0)


class PlacementFrontend:
    """Async admission layer owning a `PlacementScheduler` stepping thread.

    `max_queue` bounds outstanding (non-terminal) jobs: `submit()` awaits
    a free credit, `submit_nowait()` raises `QueueFull`.  All public
    coroutines/methods must be called from the event loop that ran
    `start()` (or entered the async context manager); the stepping thread
    is an implementation detail and never executes user code.
    """

    def __init__(self, scheduler: PlacementScheduler, max_queue: int = 64,
                 name: str = "placement-frontend"):
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        self.scheduler = scheduler
        self.max_queue = max_queue
        self._name = name
        # ---- loop-side state (event-loop thread only) -----------------
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._credits = max_queue
        self._waiters: Deque[asyncio.Future] = collections.deque()
        self._outstanding = 0          # submitted, not yet terminal
        self._idle: Optional[asyncio.Event] = None
        self._draining = False
        self._closed = False
        # ---- shared state (command queue, guarded by _cv) -------------
        self._cv = threading.Condition()
        self._commands: Deque[Tuple[str, JobHandle]] = collections.deque()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.thread_error: Optional[str] = None
        # ---- stepping-thread-side state (that thread only) ------------
        self._by_jid: Dict[int, JobHandle] = {}
        self._live: Set[JobHandle] = set()
        self._first_seen: Dict[int, float] = {}
        # ---- counters (int increments; read-only elsewhere) -----------
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.cancelled = 0
        self.failed = 0
        self.backpressure_waits = 0
        self.queue_full_rejections = 0
        # end-to-end submit -> terminal latency (stats(); mirrors into
        # the registry histogram under layer="frontend")
        self._latency_hist = telemetry.Histogram(
            "job_latency_ms", buckets=telemetry.DEFAULT_LATENCY_BUCKETS_MS)

    # -------------------------------------------------------- lifecycle

    def start(self) -> "PlacementFrontend":
        """Capture the running loop and start the stepping thread
        (idempotent).  Must be called from within the event loop."""
        if self._closed:
            raise RuntimeError("front-end is closed")
        if self._thread is not None and self._thread.is_alive():
            return self
        self._loop = asyncio.get_running_loop()
        self._stop = False
        self._thread = threading.Thread(
            target=self._run, name=self._name, daemon=True)
        self._thread.start()
        return self

    async def __aenter__(self) -> "PlacementFrontend":
        return self.start()

    async def __aexit__(self, *exc) -> None:
        await self.aclose()

    async def drain(self) -> None:
        """Stop admitting new jobs and wait until every outstanding job
        reaches a terminal state (DONE / FAILED / CANCELLED).  Jobs are
        finished, never abandoned: nothing is lost and nothing runs
        twice.  New `submit()` calls raise after this."""
        self._draining = True
        if self._outstanding == 0:
            return
        if self._idle is None:
            self._idle = asyncio.Event()
        await self._idle.wait()

    async def aclose(self) -> None:
        """`drain()`, then join the stepping thread and close the
        scheduler (persist champion store, stop the prewarm worker).
        Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._thread is None:           # never started
            self.scheduler.close()
            return
        await self.drain()
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, self._thread.join, 30.0)
        await loop.run_in_executor(None, self.scheduler.close)

    # -------------------------------------------------------- admission

    async def submit(self, request: JobRequest) -> JobHandle:
        """Admit one job, awaiting a free admission credit when
        `max_queue` jobs are already outstanding (backpressure: the
        caller suspends, the stepping thread keeps going).  Returns a
        `JobHandle`; `handle.jid` is assigned by the stepping thread
        moments later."""
        self._check_open()
        await self._acquire_credit()
        return self._enqueue_submit(request)

    def submit_nowait(self, request: JobRequest) -> JobHandle:
        """Non-blocking `submit()`: raises `serve.api.QueueFull` instead
        of awaiting when no admission credit is free."""
        self._check_open()
        if self._credits <= 0:
            self.queue_full_rejections += 1
            raise QueueFull(
                f"admission queue full ({self.max_queue} jobs "
                "outstanding); await submit() for backpressure")
        self._credits -= 1
        return self._enqueue_submit(request)

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("front-end is closed")
        if self._draining:
            raise RuntimeError("front-end is draining; no new admissions")
        if self._thread is None or not self._thread.is_alive():
            raise RuntimeError("front-end not started (use `async with` "
                               "or call start() from the event loop)")

    async def _acquire_credit(self) -> None:
        if self._credits > 0:
            self._credits -= 1
            return
        self.backpressure_waits += 1
        fut = self._loop.create_future()
        self._waiters.append(fut)
        try:
            await fut                      # woken by _release_credit
            if self._draining or self._closed:
                self._release_credit()     # drain won the race: refuse
                raise RuntimeError(
                    "front-end is draining; no new admissions")
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                self._release_credit()     # granted, but caller bailed
            else:
                try:
                    self._waiters.remove(fut)
                except ValueError:
                    pass
            raise

    def _release_credit(self) -> None:
        # loop thread only: hand the credit to the oldest live waiter,
        # or bank it
        while self._waiters:
            fut = self._waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                return
        self._credits += 1

    def _enqueue_submit(self, request: JobRequest) -> JobHandle:
        if tracing.enabled() and request.trace_id is None:
            # the front-end is the outermost layer: mint here so the
            # whole journey -- including queueing behind the command
            # deque -- lands on one trace
            request = request.replace(trace_id=tracing.new_trace_id())
            tracing.tracer().instant("job.submit", request.trace_id,
                                     device=request.device,
                                     budget=request.budget,
                                     layer="frontend")
        handle = JobHandle(jid=-1, request=request)
        handle._t_submit = time.monotonic()
        handle._attach_async(self._loop, asyncio.Event())
        handle._cancel_fn = lambda _jid, h=handle: self._request_cancel(h)
        self.submitted += 1
        self._outstanding += 1
        with self._cv:
            stopped = self._stop
            if not stopped:
                self._commands.append(("submit", handle))
                self._cv.notify_all()
        if stopped:                        # thread already gone: fail
            # stats (counter + latency) and trace event land BEFORE the
            # handle resolves: a caller woken by the resolve must already
            # see a consistent stats()/trace view
            self.failed += 1
            self._observe_terminal_latency(handle)
            if tracing.enabled() and request.trace_id is not None:
                tracing.tracer().instant(
                    "job.failed", request.trace_id,
                    error="front-end stepping thread stopped")
            handle._fail(JobFailedError(   # loudly instead of hanging
                "front-end stepping thread stopped"))
            self._on_terminal()
        return handle

    def _request_cancel(self, handle: JobHandle) -> bool:
        """Queue a cancel for the stepping thread (FIFO after the
        handle's own submit, so the jid is always known by the time it
        executes).  Returns True = request accepted; the outcome lands on
        `handle.status` (CANCELLED, or DONE when the job finished
        first)."""
        with self._cv:
            if self._stop:
                return False
            self._commands.append(("cancel", handle))
            self._cv.notify_all()
        return True

    # -------------------------------------------- stepping thread (own)

    def _run(self) -> None:
        try:
            while True:
                with self._cv:
                    while (not self._commands and not self.scheduler.busy
                           and not self._stop):
                        self._cv.wait()
                    if self._stop:
                        break
                    cmds = list(self._commands)
                    self._commands.clear()
                for kind, handle in cmds:
                    if kind == "submit":
                        self._do_submit(handle)
                    else:
                        self._do_cancel(handle)
                if self.scheduler.busy:
                    self._do_step()
        except BaseException as e:  # noqa: BLE001 -- a stepping crash
            # must fail loudly through every handle, never hang callers
            self.thread_error = f"{type(e).__name__}: {e}"
        finally:
            self._fail_remaining()

    def _do_submit(self, handle: JobHandle) -> None:
        try:
            jid = self.scheduler.submit_request(handle.request)
        except Exception as e:  # noqa: BLE001 -- bad request: fail the
            # handle, not the thread (co-tenant jobs keep flowing)
            self.failed += 1
            self._observe_terminal_latency(handle)
            if tracing.enabled() and handle.request.trace_id is not None:
                # the scheduler raised before emitting anything for this
                # trace; the terminal event is ours to write
                tracing.tracer().instant(
                    "job.failed", handle.request.trace_id,
                    error=f"{type(e).__name__}: {e}")
            handle._fail(e)                # resolve last: see _do_step
            self._notify_terminal(handle)
            return
        handle.jid = jid
        self._by_jid[jid] = handle
        self._live.add(handle)
        self.admitted += 1

    def _do_cancel(self, handle: JobHandle) -> None:
        if handle not in self._live:
            return                         # already terminal (or failed)
        if self.scheduler.cancel(handle.jid):
            # the scheduler (or its pool) emitted the job.cancelled event
            self.cancelled += 1
            self._observe_terminal_latency(handle)
            handle._cancelled()            # resolve last: see _do_step
            self._forget(handle)
            self._notify_terminal(handle)
        # else: finished in the same breath; resolves via _do_step

    def _do_step(self) -> None:
        for job in self.scheduler.step():
            handle = self._by_jid.get(job.jid)
            if handle is None:
                continue                   # not ours (direct submitter)
            # counters AND the latency observation first, then resolve: a
            # caller woken by the resolve must already see consistent
            # stats() -- including the histogram.  Terminal trace events
            # (harvested / cache_hit / failed) were emitted by the layer
            # that decided the outcome -- the pool or the scheduler.
            self._observe_terminal_latency(handle)
            if job.status is api.JobStatus.DONE:
                self.completed += 1
                handle._resolve(job.result)
            else:                          # surfaced as failed
                self.failed += 1
                handle._fail(JobFailedError(
                    job.error or f"job {job.jid} failed"))
            self._forget(handle)
            self._notify_terminal(handle)
        now = time.monotonic()
        for u in self.scheduler.progress():
            handle = self._by_jid.get(u.jid)
            if handle is None:
                continue
            handle._mark_running()
            t0 = self._first_seen.setdefault(u.jid, now)
            eta = _extrapolate_eta(u.gens, u.budget, now - t0, u.metric)
            handle._push_progress(dataclasses.replace(u, eta_s=eta))

    def _forget(self, handle: JobHandle) -> None:
        self._live.discard(handle)
        self._by_jid.pop(handle.jid, None)
        self._first_seen.pop(handle.jid, None)

    def _notify_terminal(self, handle: JobHandle) -> None:
        """Bounce credit release / drain bookkeeping onto the loop."""
        try:
            self._loop.call_soon_threadsafe(self._on_terminal)
        except RuntimeError:
            pass                           # loop already closed

    def _on_terminal(self) -> None:
        # loop thread: one call per handle that reached a terminal state
        self._outstanding -= 1
        self._release_credit()
        if self._outstanding <= 0 and self._idle is not None:
            self._idle.set()

    def _fail_remaining(self) -> None:
        """Thread exit with work still attached (crash, or stop without
        drain): fail every live handle and every unprocessed command so
        no caller waits forever."""
        note = self.thread_error or "front-end stepping thread stopped"
        with self._cv:
            leftovers = [h for _, h in self._commands]
            self._commands.clear()
        for handle in list(self._live) + leftovers:
            if not handle._done.is_set():
                self.failed += 1
                self._observe_terminal_latency(handle)
                if (tracing.enabled()
                        and handle.request.trace_id is not None):
                    # the scheduler will never step again, so no other
                    # layer can write this job's terminal event
                    tracing.tracer().instant(
                        "job.failed", handle.request.trace_id, error=note)
                handle._fail(JobFailedError(note))   # resolve last
                self._notify_terminal(handle)
        self._live.clear()
        self._by_jid.clear()

    def _observe_terminal_latency(self, handle: JobHandle) -> None:
        """Record async submit -> terminal latency exactly once per
        handle (`_t_submit` is zeroed after observing)."""
        t0 = getattr(handle, "_t_submit", 0.0)
        if not t0:
            return
        handle._t_submit = 0.0
        ms = (time.monotonic() - t0) * 1e3
        self._latency_hist.observe(ms)
        _M_LATENCY.observe(ms, layer="frontend")

    # ------------------------------------------------------------ stats

    def stats(self) -> FrontendStats:
        return api.stats_payload(
            max_queue=self.max_queue,
            submitted=self.submitted,
            admitted=self.admitted,
            completed=self.completed,
            cancelled=self.cancelled,
            failed=self.failed,
            backpressure_waits=self.backpressure_waits,
            queue_full_rejections=self.queue_full_rejections,
            draining=self._draining,
            fleet=self.scheduler.stats(),
            # --- appended under schema_version 2 (observability) ---
            job_latency_ms_hist=self._latency_hist.to_dict(),
            tracing_enabled=tracing.enabled(),
        )
