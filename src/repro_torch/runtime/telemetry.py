"""Process-wide metrics registry: counters, gauges, fixed-bucket histograms.

The serving stack so far had exactly two observability surfaces: per-layer
`stats()` snapshot dicts and the PR 6 compile meter.  Neither answers a
live operational question ("is this pool still converging?", "what is the
p99 submit->champion latency *right now*?") without caller code polling
and diffing dicts.  This module is the metrics half of the observability
layer (`serve.tracing` is the span/event half):

  * **registry** -- one process-global `MetricsRegistry` (thread-safe)
    holding named `Counter` / `Gauge` / `Histogram` instruments, each
    optionally labelled (e.g. one `repro_pool_best_metric` gauge with a
    `pool` label per pool).  Instruments are cheap host-side arithmetic
    under one lock; the serving layers record into them unconditionally
    -- the cost is nanoseconds next to a jitted step -- and *exporters*
    are what the config flags gate.
  * **compile meter folded in** -- the registry's collect walk includes a
    collector reading `runtime.compile_cache.meter()`, so compile
    requests / real recompiles / persistent-cache hits appear in the same
    Prometheus scrape as job counters instead of living beside them in a
    separate dict.
  * **Prometheus text exposition** -- `prometheus_text()` renders the
    0.0.4 text format (HELP/TYPE comments, cumulative `_bucket{le=}`
    histogram series, `_sum`/`_count`); `start_http_server(port)` serves
    it from a stdlib `ThreadingHTTPServer` on `/metrics` (port 0 binds an
    ephemeral port; the bound port is returned).

Nothing here is load-bearing for results: instruments only *observe* the
host-side serving loop.  jitted programs never read them.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "registry",
    "start_http_server", "DEFAULT_LATENCY_BUCKETS_MS",
]

# shared default for latency-shaped histograms (milliseconds): sub-ms
# cache hits through multi-minute cold compiles
DEFAULT_LATENCY_BUCKETS_MS = (
    1.0, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0, 30000.0, 60000.0)

LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, Any]) -> LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _escape(value: str) -> str:
    return (value.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(key: LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{_escape(v)}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Instrument:
    """Shared base: a named instrument with per-label-set samples."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._samples: Dict[LabelKey, Any] = {}

    def samples(self) -> Dict[LabelKey, Any]:
        with self._lock:
            return dict(self._samples)

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for key, value in sorted(self.samples().items()):
            lines.append(f"{self.name}{_fmt_labels(key)} {_fmt_num(value)}")
        return lines


def _fmt_num(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class Counter(_Instrument):
    """Monotone counter; `inc(n, **labels)` (n must be >= 0)."""

    kind = "counter"

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease ({n})")
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + n

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._samples.get(_label_key(labels), 0.0))


class Gauge(_Instrument):
    """Point-in-time value; `set(v, **labels)` / `inc` / `dec`."""

    kind = "gauge"

    def set(self, v: float, **labels: Any) -> None:
        with self._lock:
            self._samples[_label_key(labels)] = float(v)

    def inc(self, n: float = 1.0, **labels: Any) -> None:
        key = _label_key(labels)
        with self._lock:
            self._samples[key] = self._samples.get(key, 0.0) + n

    def dec(self, n: float = 1.0, **labels: Any) -> None:
        self.inc(-n, **labels)

    def value(self, **labels: Any) -> float:
        with self._lock:
            return float(self._samples.get(_label_key(labels), 0.0))


class _HistState:
    __slots__ = ("counts", "overflow", "sum", "count")

    def __init__(self, n_buckets: int) -> None:
        self.counts = [0] * n_buckets      # per-bucket, non-cumulative
        self.overflow = 0                  # > last bound (+Inf bucket)
        self.sum = 0.0
        self.count = 0


class Histogram(_Instrument):
    """Fixed-bucket histogram: `observe(v, **labels)`.

    Buckets are upper bounds (ascending); values above the last bound land
    in the implicit +Inf bucket.  Exposition is cumulative per Prometheus
    convention; `to_dict()` embeds the non-cumulative counts into
    `stats()` payloads.  Standalone use (outside any registry) is fine --
    the serve layers keep per-instance histograms for their own `stats()`
    and mirror observations into the registry-global instrument.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS_MS
                 ) -> None:
        super().__init__(name, help)
        self.buckets = tuple(float(b) for b in buckets)
        if not self.buckets or any(a >= b for a, b in zip(self.buckets,
                                                          self.buckets[1:])):
            raise ValueError("buckets must be non-empty and ascending")

    def observe(self, v: float, **labels: Any) -> None:
        v = float(v)
        key = _label_key(labels)
        with self._lock:
            st = self._samples.get(key)
            if st is None:
                st = self._samples[key] = _HistState(len(self.buckets))
            st.sum += v
            st.count += 1
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    st.counts[i] += 1
                    break
            else:
                st.overflow += 1

    def to_dict(self, **labels: Any) -> Dict[str, Any]:
        """JSON-able snapshot for one label set (the `stats()` embedding):
        non-cumulative bucket counts + overflow + sum/count."""
        with self._lock:
            st = self._samples.get(_label_key(labels))
            if st is None:
                return {"buckets": list(self.buckets),
                        "counts": [0] * len(self.buckets),
                        "overflow": 0, "count": 0, "sum": 0.0}
            return {"buckets": list(self.buckets),
                    "counts": list(st.counts),
                    "overflow": st.overflow,
                    "count": st.count,
                    "sum": round(st.sum, 3)}

    def expose(self) -> List[str]:
        lines = [f"# HELP {self.name} {_escape(self.help)}",
                 f"# TYPE {self.name} histogram"]
        for key, st in sorted(self.samples().items(),
                              key=lambda kv: kv[0]):
            cum = 0
            for bound, n in zip(self.buckets, st.counts):
                cum += n
                le = 'le="%s"' % _fmt_num(bound)
                lines.append(
                    f"{self.name}_bucket{_fmt_labels(key, le)} {cum}")
            inf = 'le="+Inf"'
            lines.append(f"{self.name}_bucket"
                         f"{_fmt_labels(key, inf)} {st.count}")
            lines.append(f"{self.name}_sum{_fmt_labels(key)} "
                         f"{_fmt_num(st.sum)}")
            lines.append(f"{self.name}_count{_fmt_labels(key)} {st.count}")
        return lines


# collector: () -> iterable of (name, kind, help, [(labels_dict, value)])
Collector = Callable[[], Iterable[Tuple[str, str, str,
                                        List[Tuple[Dict[str, str],
                                                   float]]]]]


class MetricsRegistry:
    """Named instruments + collect-time collectors, one lock, no deps."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}
        self._collectors: List[Collector] = []

    def _get(self, cls, name: str, help: str, **kw: Any):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = self._instruments[name] = cls(name, help, **kw)
            elif not isinstance(inst, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{inst.kind}, not {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = DEFAULT_LATENCY_BUCKETS_MS
                  ) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def register_collector(self, fn: Collector) -> None:
        with self._lock:
            if fn not in self._collectors:
                self._collectors.append(fn)

    def prometheus_text(self) -> str:
        """The registry in Prometheus text exposition format 0.0.4."""
        with self._lock:
            instruments = list(self._instruments.values())
            collectors = list(self._collectors)
        lines: List[str] = []
        for inst in sorted(instruments, key=lambda i: i.name):
            lines.extend(inst.expose())
        for fn in collectors:
            for name, kind, help, samples in fn():
                lines.append(f"# HELP {name} {_escape(help)}")
                lines.append(f"# TYPE {name} {kind}")
                for labels, value in samples:
                    lines.append(f"{name}{_fmt_labels(_label_key(labels))}"
                                 f" {_fmt_num(value)}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """Plain-dict view (tests / debugging): name -> {labels: value}."""
        with self._lock:
            instruments = list(self._instruments.values())
        out: Dict[str, Any] = {}
        for inst in instruments:
            out[inst.name] = {
                _fmt_labels(key) or "": (v.count if isinstance(v, _HistState)
                                         else v)
                for key, v in inst.samples().items()}
        return out


def _compile_meter_collector():
    """Fold the PR 6 compile meter into the scrape (the registry is where
    compile observability lives now; `CompileMeter` stays the jax-facing
    listener)."""
    from repro_torch.runtime import compile_cache
    for name, kind, help, value in compile_cache.meter().telemetry_samples():
        yield name, kind, help, [({}, value)]


_REGISTRY = MetricsRegistry()
_REGISTRY.register_collector(_compile_meter_collector)


def registry() -> MetricsRegistry:
    """The process-global registry (serving layers all record into it)."""
    return _REGISTRY


# -------------------------------------------------------------- HTTP server

def start_http_server(port: int = 0,
                      reg: Optional[MetricsRegistry] = None,
                      host: str = "127.0.0.1"):
    """Serve `reg.prometheus_text()` on `http://host:port/metrics` from a
    stdlib threading HTTP server (daemon thread).  `port=0` binds an
    ephemeral port.  Returns `(server, bound_port)`; `server.shutdown()`
    stops it."""
    import http.server

    reg = reg or registry()

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):                                  # noqa: N802
            if self.path.split("?")[0] not in ("/", "/metrics"):
                self.send_error(404)
                return
            body = reg.prometheus_text().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a: Any) -> None:            # silence 200s
            pass

    server = http.server.ThreadingHTTPServer((host, port), _Handler)
    server.daemon_threads = True
    thread = threading.Thread(target=server.serve_forever,
                              name="metrics-http", daemon=True)
    thread.start()
    return server, server.server_address[1]
