"""Build-latency control: a persistent kernel-build cache and the compile meter.

The port's counterpart of `repro/runtime/compile_cache.py`, not a literal
port.  Eager PyTorch compiles no program per shape; what a cold process
waits on before its first generation is the nvcc build of the CUDA kernel
libraries (`kernels/_build.py::build`, on the first launch of any kernel).
So:

  * **persistent cache** -- `enable(cache_dir)` points the kernel build
    directory at `cache_dir`.  A restarted process, or one that shares the
    directory, loads the libraries from there instead of running nvcc.  A
    library's file name hashes its sources, the nvcc flags (the arch among
    them) and `nvcc --version`'s text, so a shared directory never serves a
    library another toolkit built.  `disable()` restores the default
    directory; `enabled_dir()` is the directory in use.
  * **compile meter** -- a process-wide counter and timer fed by
    `kernels/_build.py::build`, with the reference's meanings:
    `compiles` counts library requests (each library the first time this
    process asks for it, and every nvcc build), `cache_hits` the libraries
    found on disk, `recompiles` the real nvcc builds.  `measure()` scopes
    the nvcc builds to the calling thread, which is how a pool separates
    *blocking* builds (on the thread that calls submit/step/grow) from a
    background prewarm's.

Nothing here changes what a program computes: the directory and the meter
change when a library is built, never what it computes.
"""
from __future__ import annotations

import contextlib
import hashlib
import os
import threading
from typing import Any, Dict, Optional


class _Scope:
    """One `measure()` window: nvcc builds observed on the opening thread."""

    __slots__ = ("compiles", "secs")

    def __init__(self) -> None:
        self.compiles = 0
        self.secs = 0.0


class CompileMeter:
    """Process-wide build counter and timer, fed by `record()`.

    Counters:
      * `compiles`      -- library requests (cache-served ones included),
      * `compile_secs`  -- wall seconds of the `build()` calls that served
        them (a cache hit costs a file lookup, a miss the nvcc build),
      * `cache_hits`    -- requests answered by a library on disk,
      * `recompiles`    -- real nvcc builds: `compiles - cache_hits`
        (`cache_misses` is the same number, under the reference's name).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.compiles = 0
        self.compile_secs = 0.0
        self.cache_hits = 0
        self._scopes: Dict[int, list] = {}     # thread id -> open scope stack

    def record(self, n: int, secs: float, hits: int = 0) -> None:
        """`n` library requests, `hits` of them found on disk, served in
        `secs` wall seconds on the calling thread."""
        tid = threading.get_ident()
        with self._lock:
            self.compiles += n
            self.compile_secs += secs
            self.cache_hits += hits
            for scope in self._scopes.get(tid, ()):
                scope.compiles += n - hits
                scope.secs += secs

    @property
    def recompiles(self) -> int:
        """Real nvcc builds (requests the build directory did not answer)."""
        return self.compiles - self.cache_hits

    @property
    def cache_misses(self) -> int:
        return self.recompiles

    @contextlib.contextmanager
    def measure(self):
        """Scope build counting to the calling thread::

            with meter.measure() as m:
                pool.step()              # may build
            m.compiles, m.secs           # nvcc builds on THIS thread only
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

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "compiles": self.compiles,
                "recompiles": self.recompiles,
                "cache_hits": self.cache_hits,
                "cache_misses": self.cache_misses,
                "compile_secs": round(self.compile_secs, 3),
                "persistent_cache_dir": enabled_dir(),
            }

    def telemetry_samples(self):
        """The meter as `(name, kind, help, value)` rows for the metrics
        registry's collect walk (`runtime.telemetry` registers a collector
        over this)."""
        with self._lock:
            return [
                ("repro_compiles_total", "counter",
                 "CUDA kernel library requests (cache-served included)",
                 float(self.compiles)),
                ("repro_recompiles_total", "counter",
                 "Real nvcc builds (requests the build directory did not answer)",
                 float(self.recompiles)),
                ("repro_compile_seconds_total", "counter",
                 "Wall seconds inside kernel library requests",
                 round(self.compile_secs, 6)),
                ("repro_compile_cache_hits_total", "counter",
                 "Kernel libraries found built on disk", float(self.cache_hits)),
                ("repro_compile_cache_misses_total", "counter",
                 "Kernel libraries nvcc had to build", float(self.cache_misses)),
            ]


_METER = CompileMeter()


def meter() -> CompileMeter:
    """The process-global compile meter."""
    return _METER


# --------------------------------------------------------------- enabling

def enable(cache_dir: str) -> str:
    """Build kernel libraries into, and load them from, `cache_dir`.

    Safe to call more than once; the last directory wins.  A library this
    process already loaded stays loaded (`kernels/_build.py::library` is
    cached for the life of the process): only libraries first launched
    after the call come from `cache_dir`.  Returns the directory.
    """
    from repro_torch.kernels import _build
    os.makedirs(cache_dir, exist_ok=True)
    _build.set_build_dir(cache_dir)
    return cache_dir


def disable() -> None:
    """Back to the default build directory (`kernels/_build.py::BUILD_DIR`)."""
    from repro_torch.kernels import _build
    _build.set_build_dir(None)


def enabled_dir() -> str:
    """The kernel build directory in use."""
    from repro_torch.kernels import _build
    return str(_build.build_dir())


def maybe_enable_from_env(flag_dir: Optional[str] = None) -> Optional[str]:
    """`enable()` from an explicit flag value or the
    `REPRO_COMPILE_CACHE_DIR` environment variable; no-op when neither is
    set (entry points call this so `--compile-cache-dir` and the env var
    behave identically)."""
    cache_dir = flag_dir or os.environ.get("REPRO_COMPILE_CACHE_DIR")
    return enable(cache_dir) if cache_dir else None


# ------------------------------------------------------------------- salt

def cache_salt() -> str:
    """Human-readable torch-version/CUDA/device salt, for the layers around
    the build cache (CI cache keys, prewarm bookkeeping), as the
    reference's jax-version/backend/device-count string."""
    import torch
    if torch.cuda.is_available():
        name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    else:
        name, count = "cpu", 0
    return f"torch{torch.__version__}-cuda{torch.version.cuda}-{name}-d{count}"


def pool_token(pool_key: Any) -> str:
    """Stable short token for one pool signature under the current salt
    (prewarm bookkeeping / stats labels; not a cache key)."""
    text = repr((pool_key, cache_salt()))
    return hashlib.sha1(text.encode()).hexdigest()[:16]
