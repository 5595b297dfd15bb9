"""Compile meter: what blocks a cold placement pool before its first generation.

The port's counterpart of `repro/runtime/compile_cache.py`'s compile
meter.  Eager PyTorch compiles no XLA program; what a cold pool waits on
here is the nvcc build of the CUDA kernels (`kernels/_build.py::build`,
on the first launch of any kernel), which reports to the one
process-wide `CompileMeter`:

  * `compiles` / `compile_secs` -- one count per library built, and the
    wall seconds of the whole parallel build;
  * `recompiles` -- builds that were not answered by a cache.  There is
    no persistent cache yet (ROADMAP queue 1 item 9b), so it equals
    `compiles`.

`measure()` scopes the count to the calling thread, as the reference's
does, which is how a pool attributes *blocking* builds (on the thread
that calls submit/step/grow) to itself.  Nothing here changes what a
program computes.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict


class _Scope:
    """One `measure()` window: builds observed on the opening thread."""

    __slots__ = ("compiles", "secs")

    def __init__(self) -> None:
        self.compiles = 0
        self.secs = 0.0


class CompileMeter:
    """Process-wide build counter and timer, fed by `record()`."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_secs = 0.0
        self._scopes: Dict[int, list] = {}     # thread id -> open scope stack

    def record(self, n: int, secs: float) -> None:
        """`n` builds that took `secs` wall seconds on the calling thread."""
        tid = threading.get_ident()
        with self._lock:
            self.compiles += n
            self.compile_secs += secs
            for scope in self._scopes.get(tid, ()):
                scope.compiles += n
                scope.secs += secs

    @property
    def recompiles(self) -> int:
        """Builds not answered by a cache: all of them (no persistent
        cache yet)."""
        return self.compiles

    @contextlib.contextmanager
    def measure(self):
        """Scope build counting to the calling thread::

            with meter.measure() as m:
                pool.step()              # may build
            m.compiles, m.secs           # builds on THIS thread only
        """
        scope = _Scope()
        tid = threading.get_ident()
        with self._lock:
            self._scopes.setdefault(tid, []).append(scope)
        try:
            yield scope
        finally:
            with self._lock:
                self._scopes[tid].remove(scope)
                if not self._scopes[tid]:
                    del self._scopes[tid]

    def telemetry_samples(self):
        """The meter as `(name, kind, help, value)` rows for the metrics
        registry's collect walk (`runtime.telemetry` registers a collector
        over this)."""
        with self._lock:
            return [
                ("repro_compiles_total", "counter",
                 "nvcc builds of the CUDA kernel libraries", float(self.compiles)),
                ("repro_recompiles_total", "counter",
                 "Builds not answered by a cache", float(self.recompiles)),
                ("repro_compile_seconds_total", "counter",
                 "Wall seconds inside builds", round(self.compile_secs, 6)),
            ]


_METER = CompileMeter()


def meter() -> CompileMeter:
    """The process-global compile meter."""
    return _METER


def enabled_dir() -> str:
    """Where built kernels persist across processes: the kernel build
    directory (`kernels/_build.py::BUILD_DIR`)."""
    from repro_torch.kernels import _build
    return str(_build.BUILD_DIR)
