"""Structured span/event tracing for the serving stack.

The metrics registry (`runtime.telemetry`) answers *aggregate* questions;
this module answers the per-request one -- "where did job X spend its
400ms" -- with a process-wide, thread-safe event log:

  * every job carries a **trace id** (`JobRequest.trace_id`, minted at the
    outermost layer that sees it) and emits a fixed event taxonomy on its
    way through: ``job.submit`` -> ``job.queued`` -> ``job.admitted``
    (slot/pool attrs) -> exactly one terminal event out of
    ``job.harvested`` / ``job.cancelled`` / ``job.failed`` /
    ``job.cache_hit``;
  * pools emit lifecycle **spans** (begin/end pairs): ``pool.build``,
    ``pool.grow``, ``pool.prewarm_size``, and per-batched-step
    ``pool.step`` windows, plus ``pool.prewarm_adopt`` instants;
  * timestamps are `time.monotonic()` (ordering/duration) with a wall
    clock alongside (correlation across processes).

**Disabled is the default and costs one module-level branch.**  Call
sites guard with ``if tracing.enabled():``; when off, no event object is
ever built.  The bench `telemetry` section hard-gates the disabled-path
overhead (`check_bench.py`).

Exporters (all opt-in):

  * **JSONL sink** -- `enable(jsonl_path=...)` / `REPRO_TRACE_FILE` /
    `launch/serve.py --trace-file`: one JSON object per event, written as
    events happen (the durable form; survives a crash).
  * **Chrome trace** -- `write_chrome_trace(path)`: the in-memory ring
    rendered as Chrome/Perfetto trace-event JSON (``B``/``E`` span pairs,
    ``i`` instants; load in `ui.perfetto.dev` or `chrome://tracing`).
  * **in-memory ring** -- bounded per-trace index backing
    `JobHandle.trace()`; oldest traces evicted FIFO so a long-lived
    process never grows unboundedly.
"""
from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Any, Dict, IO, List, Optional, Tuple

__all__ = [
    "TraceEvent", "Tracer", "tracer", "enabled", "enable", "disable",
    "maybe_enable_from_env", "new_trace_id", "TERMINAL_EVENTS",
    "JOB_EVENTS", "write_chrome_trace",
]

# one terminal event per job, exactly -- gated by bench + tests
TERMINAL_EVENTS = frozenset(
    {"job.harvested", "job.cancelled", "job.failed", "job.cache_hit"})
JOB_EVENTS = frozenset(
    {"job.submit", "job.queued", "job.admitted"}) | TERMINAL_EVENTS

# ring capacities: ~100 bytes/event in-memory; 64k events / 4k traces
# bounds a long-lived process at a few MB of trace state
MAX_EVENTS = 65536
MAX_TRACES = 4096
MAX_EVENTS_PER_TRACE = 1024

_ENABLED = False
_id_counter = itertools.count(1)


def enabled() -> bool:
    """The single branch every instrumentation site checks."""
    return _ENABLED


def new_trace_id(prefix: str = "job") -> str:
    """Process-unique trace id (monotone counter + pid for cross-process
    uniqueness in JSONL files merged from several workers)."""
    return f"{prefix}-{os.getpid()}-{next(_id_counter)}"


@dataclass(frozen=True)
class TraceEvent:
    """One event: an instant, or one side of a begin/end span pair."""

    name: str
    kind: str                    # "begin" | "end" | "instant"
    ts: float                    # time.monotonic() seconds
    wall: float                  # time.time() seconds
    trace_id: Optional[str] = None
    tid: int = 0                 # emitting thread ident
    attrs: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "kind": self.kind,
                               "ts": round(self.ts, 6),
                               "wall": round(self.wall, 6),
                               "tid": self.tid}
        if self.trace_id is not None:
            out["trace"] = self.trace_id
        if self.attrs:
            out["attrs"] = self.attrs
        return out


class Tracer:
    """Thread-safe bounded event log with optional JSONL sinks."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=MAX_EVENTS)
        self._by_trace: "OrderedDict[str, List[TraceEvent]]" = OrderedDict()
        self._sinks: List[IO[str]] = []
        self._t0 = time.monotonic()

    # ------------------------------------------------------------- record

    def _record(self, ev: TraceEvent) -> None:
        if not _ENABLED:
            # defense in depth: instrumentation sites gate on `enabled()`
            # before even constructing the event; this guard keeps a
            # stray ungated call from recording while tracing is off
            return
        with self._lock:
            self._events.append(ev)
            if ev.trace_id is not None:
                per = self._by_trace.get(ev.trace_id)
                if per is None:
                    while len(self._by_trace) >= MAX_TRACES:
                        self._by_trace.popitem(last=False)
                    per = self._by_trace[ev.trace_id] = []
                if len(per) < MAX_EVENTS_PER_TRACE:
                    per.append(ev)
            sinks = list(self._sinks)
        for f in sinks:
            try:
                f.write(json.dumps(ev.to_json(),
                                   separators=(",", ":")) + "\n")
                f.flush()
            except (OSError, ValueError):
                pass                       # a dead sink never kills serving

    def instant(self, name: str, trace_id: Optional[str] = None,
                **attrs: Any) -> None:
        self._record(TraceEvent(name=name, kind="instant",
                                ts=time.monotonic(), wall=time.time(),
                                trace_id=trace_id,
                                tid=threading.get_ident(), attrs=attrs))

    def begin(self, name: str, trace_id: Optional[str] = None,
              **attrs: Any) -> None:
        self._record(TraceEvent(name=name, kind="begin",
                                ts=time.monotonic(), wall=time.time(),
                                trace_id=trace_id,
                                tid=threading.get_ident(), attrs=attrs))

    def end(self, name: str, trace_id: Optional[str] = None,
            **attrs: Any) -> None:
        self._record(TraceEvent(name=name, kind="end",
                                ts=time.monotonic(), wall=time.time(),
                                trace_id=trace_id,
                                tid=threading.get_ident(), attrs=attrs))

    class _Span:
        __slots__ = ("_tracer", "_name", "_trace_id", "_attrs")

        def __init__(self, tracer: "Tracer", name: str,
                     trace_id: Optional[str], attrs: Dict[str, Any]):
            self._tracer = tracer
            self._name = name
            self._trace_id = trace_id
            self._attrs = attrs

        def __enter__(self) -> "Tracer._Span":
            self._tracer.begin(self._name, self._trace_id, **self._attrs)
            return self

        def __exit__(self, exc_type, exc, tb) -> None:
            attrs = dict(self._attrs)
            if exc_type is not None:
                attrs["error"] = exc_type.__name__
            self._tracer.end(self._name, self._trace_id, **attrs)

    def span(self, name: str, trace_id: Optional[str] = None,
             **attrs: Any) -> "Tracer._Span":
        """``with tracer().span("pool.step", pool=label): ...``"""
        return Tracer._Span(self, name, trace_id, attrs)

    # -------------------------------------------------------------- query

    def events(self, trace_id: Optional[str] = None) -> List[TraceEvent]:
        with self._lock:
            if trace_id is not None:
                return list(self._by_trace.get(trace_id, ()))
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._by_trace.clear()

    # -------------------------------------------------------------- sinks

    def add_jsonl_sink(self, path: str) -> None:
        f = open(path, "a", encoding="utf-8")
        with self._lock:
            self._sinks.append(f)

    def close_sinks(self) -> None:
        with self._lock:
            sinks, self._sinks = self._sinks, []
        for f in sinks:
            try:
                f.close()
            except OSError:
                pass

    # ------------------------------------------------------- chrome trace

    def chrome_trace(self) -> Dict[str, Any]:
        """The in-memory ring as a Chrome/Perfetto trace-event dict.

        Spans map to ``B``/``E`` phase pairs, instants to ``i``; ts is
        microseconds relative to tracer start; each trace id becomes an
        ``args.trace`` attribute so Perfetto's query view can group by
        job."""
        pid = os.getpid()
        phase = {"begin": "B", "end": "E", "instant": "i"}
        events = []
        for ev in self.events():
            out: Dict[str, Any] = {
                "name": ev.name,
                "ph": phase[ev.kind],
                "ts": (ev.ts - self._t0) * 1e6,
                "pid": pid,
                "tid": ev.tid,
            }
            args = dict(ev.attrs)
            if ev.trace_id is not None:
                args["trace"] = ev.trace_id
            if args:
                out["args"] = args
            if ev.kind == "instant":
                out["s"] = "t"             # thread-scoped instant
            events.append(out)
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def write_chrome_trace(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.chrome_trace(), f)


_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer (valid even while tracing is disabled --
    `enabled()` is what instrumentation sites gate on)."""
    return _TRACER


def enable(jsonl_path: Optional[str] = None) -> None:
    """Turn tracing on; optionally attach a JSONL sink."""
    global _ENABLED
    if jsonl_path:
        _TRACER.add_jsonl_sink(jsonl_path)
    _ENABLED = True


def disable(close_sinks: bool = True) -> None:
    global _ENABLED
    _ENABLED = False
    if close_sinks:
        _TRACER.close_sinks()


def maybe_enable_from_env(trace_file: Optional[str] = None) -> bool:
    """Enable tracing if `trace_file` or `$REPRO_TRACE_FILE` names a sink,
    or if `$REPRO_TELEMETRY` is a truthy flag (tracing without a file:
    in-memory ring + `JobHandle.trace()` only).  Returns enabled state."""
    path = trace_file or os.environ.get("REPRO_TRACE_FILE") or None
    flag = os.environ.get("REPRO_TELEMETRY", "").strip().lower()
    if path:
        enable(path)
    elif flag in ("1", "true", "on", "yes"):
        enable()
    return _ENABLED


def write_chrome_trace(path: str) -> None:
    """Module-level convenience over the global tracer."""
    _TRACER.write_chrome_trace(path)


def span_pairs(events: List[TraceEvent]) -> List[Tuple[str, float]]:
    """Fold begin/end pairs into (name, duration_s) tuples -- the
    ingredient for per-phase timing summaries in tests and tools."""
    open_spans: Dict[Tuple[str, int], float] = {}
    out: List[Tuple[str, float]] = []
    for ev in events:
        key = (ev.name, ev.tid)
        if ev.kind == "begin":
            open_spans[key] = ev.ts
        elif ev.kind == "end" and key in open_spans:
            out.append((ev.name, ev.ts - open_spans.pop(key)))
    return out
