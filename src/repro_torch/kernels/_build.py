"""Build, load and launch the hand-written CUDA kernels under `csrc/`.

Each `csrc/<name>.cu` compiles with nvcc into its own shared library with a
plain C interface, loaded with ctypes (no PyTorch headers, so a build takes
seconds).  Libraries land in `build/repro_torch_kernels/` at the repository
root, or in the directory `runtime.compile_cache.enable` names, named by a
hash of their sources, the nvcc flags and `nvcc --version`'s text, so an
edited source or another toolkit rebuilds and an unchanged one is reused.
All missing libraries build at once, one nvcc process each, on the first
launch of any kernel; a module lock keeps two threads from building or
loading at once.

A `Kernel` is one wrapper's launcher and launch counter: it counts a launch
only after the C entry point returned cudaSuccess, and raises otherwise.
The placement kernels' wrappers are `torch.library.custom_op`s whose vmap
rules fold the mapped axis into the rows of one launch (`vmap_to_front`).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from repro_torch.runtime import compile_cache

SRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NAMES = ("bbox", "domination", "flash_attention", "fused_eval", "wirelength")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
DTYPE_TAGS = {torch.float32: "f32", torch.bfloat16: "bf16"}

_dir: Optional[Path] = None      # set by `runtime.compile_cache.enable`
_LOCK = threading.RLock()        # around build() and library()'s load
_COUNT_LOCK = threading.Lock()   # around Kernel.launches
_requested: set = set()          # library paths requested in this process


def build_dir() -> Path:
    """Where libraries are built and looked up: `BUILD_DIR` unless
    `set_build_dir` named another directory."""
    return BUILD_DIR if _dir is None else _dir


def set_build_dir(path: Optional[os.PathLike]) -> None:
    """Build into and load from `path` from now on (None: `BUILD_DIR`)."""
    global _dir
    _dir = None if path is None else Path(path)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin and PATH); the CUDA kernels "
                       "cannot be built")


@functools.cache
def _version_text(nvcc: str) -> str:
    proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=120)
    return proc.stdout + proc.stderr


def nvcc_version() -> str:
    """`nvcc --version`'s text, or "" where there is no nvcc (a build then
    raises naming the places it looked)."""
    try:
        return _version_text(_nvcc())
    except RuntimeError:
        return ""


def library_path(name: str) -> Path:
    """The library of `csrc/<name>.cu` under `build_dir()`, named by a hash
    of the flags (the arch among them), the toolkit's version text and the
    sources, so a shared directory never serves another toolkit's build."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    for src in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build() -> Dict[str, str]:
    """Compile every library not yet built, all nvcc processes at once.

    Returns {name: compiler output} for the libraries built by this call
    (ptxas reports registers, shared memory and spills per kernel).  Reports
    to the compile meter (`runtime.compile_cache`) each library requested
    for the first time in this process, whether it was found on disk, and
    every nvcc build, with the call's wall seconds.  Raises RuntimeError
    naming every source that failed.
    """
    with _LOCK:
        out_dir = build_dir()
        out_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        jobs, hits = [], 0
        for name in NAMES:
            out = library_path(name)
            if out.exists():
                if out not in _requested:
                    _requested.add(out)
                    hits += 1
                continue
            _requested.add(out)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((name, out, tmp, proc))
        logs, failed = {}, []
        for name, out, tmp, proc in jobs:
            log, _ = proc.communicate()
            logs[name] = log
            if proc.returncode == 0:
                os.replace(tmp, out)      # atomic: concurrent builds agree
            else:
                tmp.unlink(missing_ok=True)
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        if jobs or hits:
            compile_cache.meter().record(len(jobs) + hits, time.perf_counter() - t0,
                                         hits=hits)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        return logs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if missing.

    Cached for the life of the process: a library loaded once stays loaded
    (and is used) after `set_build_dir` / `compile_cache.enable` moves the
    directory; only libraries first loaded after the move come from there.
    """
    with _LOCK:
        build()
        lib = ctypes.CDLL(str(library_path(name)))
    err = getattr(lib, f"{name}_error_string")
    err.argtypes, err.restype = [ctypes.c_int], ctypes.c_char_p
    return lib


def check_inputs(what: str, floats: Sequence[torch.Tensor] = (),
                 ints: Sequence[torch.Tensor] = ()) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device, the
    `floats` share one dtype from DTYPE_TAGS and the `ints` are int32."""
    tensors = (*floats, *ints)
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{what}: expected CUDA tensors, got {t.device}")
        if t.device != dev:
            raise ValueError(f"{what}: tensors on {dev} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
    for t in floats:
        if t.dtype not in DTYPE_TAGS or t.dtype != floats[0].dtype:
            raise TypeError(f"{what}: float inputs must share one dtype of "
                            f"{tuple(DTYPE_TAGS)}, got {t.dtype}")
    for t in ints:
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: index inputs must be int32, got {t.dtype}")


def vmap_to_front(t: torch.Tensor, dim: Optional[int], batch_size: int) -> torch.Tensor:
    """Input `t` of a custom op's vmap rule with the mapped axis `dim` moved
    to the front; an unmapped input (`dim` None) is expanded along it."""
    if dim is None:
        return t.expand(batch_size, *t.shape)
    return t.movedim(dim, 0)


class Kernel:
    """Launcher and launch counter of one wrapper around library `name`."""

    def __init__(self, name: str, argtypes: Sequence):
        self.name = name
        self.argtypes = list(argtypes) + [ctypes.c_void_p]    # + stream
        self.launches = 0

    def _entry(self, tag: str):
        fn = getattr(library(self.name), f"{self.name}_{tag}")
        if fn.argtypes is None:
            fn.argtypes, fn.restype = self.argtypes, ctypes.c_int
        return fn

    def launch(self, dtype: torch.dtype, device: torch.device, *args,
               entry: Optional[str] = None) -> None:
        """Call entry point `<name>_<entry>` (default: the `dtype` tag, as
        in `domination_f32`) on `device`'s current stream."""
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self._entry(entry or DTYPE_TAGS[dtype])(*args, stream)
        if err != 0:
            msg = getattr(library(self.name), f"{self.name}_error_string")(err)
            raise RuntimeError(f"{self.name} kernel launch failed: "
                               f"{msg.decode()} (cudaError {err})")
        with _COUNT_LOCK:
            self.launches += 1
