"""Fault-tolerant checkpointing: atomic, async, restored onto the caller's device.

Port of `repro/ckpt/checkpoint.py`, with the reference's contract:

Layout per step:  <dir>/step_<n>/ {manifest.json, arrays.npz}
Write protocol:   tmp dir -> fsync -> atomic rename (a crashed save can never
shadow a good checkpoint); `keep` newest are retained; saves can run on one
background worker thread (async) so the training loop never blocks on disk.

A tree is nested dicts (lists, tuples) of tensors; its arrays are keyed by
their path in the tree, the dict keys joined by "/" (the port's parameter
names, e.g. ``params/blocks.0.attn.wq``, ``opt/m/embed``, ``opt/step``).
bf16 tensors are stored as fp32 (numpy has no bf16; the cast is exact)
and cast back on restore.  `restore` puts each array on the device and in
the dtype of the matching leaf of `like`, after checking its shape.  The
reference's `shardings` (restoring onto another mesh) waits for sharding
(ROADMAP.md, queue 1 item 11.5).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils import _pytree

_EXEC = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
_LOCK = threading.Lock()


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    def host(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {_key(path): host(leaf)
            for path, leaf in _pytree.tree_flatten_with_path(tree)[0]}


def save(directory: str, step: int, tree: Any,
         meta: Optional[Dict[str, Any]] = None, keep: int = 3,
         async_: bool = False) -> Optional[Future]:
    """Checkpoint `tree` at `step`.  Returns a Future when async_."""
    arrays = _flatten(tree)      # the copy to the host happens on the caller's thread

    def _write():
        with _LOCK:
            final = os.path.join(directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
            manifest = {"step": step, "meta": meta or {},
                        "n_arrays": len(arrays)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _gc(directory, keep)
        return final

    if async_:
        return _EXEC.submit(_write)
    _write()
    return None


def _gc(directory: str, keep: int) -> None:
    steps = sorted(latest_steps(directory))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def latest_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            if os.path.exists(os.path.join(directory, name, "manifest.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def restore(directory: str, like: Any, step: Optional[int] = None) -> Any:
    """Restore into the structure of `like`: each array on the device and in
    the dtype of its leaf there; a shape that differs raises ValueError."""
    steps = latest_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = step if step is not None else steps[-1]
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    flat, spec = _pytree.tree_flatten_with_path(like)
    leaves = []
    for pathk, leaf in flat:
        key = _key(pathk)
        a = arrays[key]
        if a.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {a.shape}, expected {tuple(leaf.shape)}")
        leaves.append(torch.from_numpy(a).to(device=leaf.device, dtype=leaf.dtype, copy=True))
    return _pytree.tree_unflatten(leaves, spec)


def manifest(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    steps = latest_steps(directory)
    step = step if step is not None else steps[-1]
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)
