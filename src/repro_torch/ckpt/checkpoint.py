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
the dtype of the matching leaf of `like`, after checking its shape.

A DTensor leaf is saved as its `full_tensor()` (the global array), so a
checkpoint does not depend on the mesh it was written from; gathering it
is a collective, so every rank calls `save` on such a tree and rank 0
writes.  `restore`
with `shardings` (a tree of (mesh, placements) leaves matching `like`, as
`sharding.logical.tree_shardings` builds) lays each array out on its mesh
with `distribute_tensor`, every rank taking its own shard of the array it
read (no collective): a checkpoint saved on one mesh, or on one device,
restores onto another, which is the reference's elastic path.
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
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.utils import _pytree

_EXEC = ThreadPoolExecutor(max_workers=1, thread_name_prefix="ckpt")
_LOCK = threading.Lock()


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


def _flatten(tree: Any) -> Dict[str, np.ndarray]:
    def host(t: torch.Tensor) -> np.ndarray:
        if isinstance(t, DTensor):
            t = t.full_tensor()
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return {_key(path): host(leaf)
            for path, leaf in _pytree.tree_flatten_with_path(tree)[0]}


def save(directory: str, step: int, tree: Any,
         meta: Optional[Dict[str, Any]] = None, keep: int = 3,
         async_: bool = False) -> Optional[Future]:
    """Checkpoint `tree` at `step`.  Returns a Future when async_.  With
    DTensor leaves every rank calls this and only rank 0 writes."""
    arrays = _flatten(tree)      # the copy to the host happens on the caller's thread
    if (any(isinstance(t, DTensor) for t in _pytree.tree_leaves(tree))
            and dist.get_rank() != 0):
        return None

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


def _is_sharding(x) -> bool:
    return isinstance(x, tuple) and len(x) == 2 and isinstance(x[0], DeviceMesh)


def restore(directory: str, like: Any, step: Optional[int] = None,
            shardings: Any = None) -> Any:
    """Restore into the structure of `like`: each array on the device and in
    the dtype of its leaf there; a shape that differs raises ValueError.
    With `shardings`, each array is laid out on its leaf's (mesh,
    placements) as a DTensor."""
    steps = latest_steps(directory)
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    step = step if step is not None else steps[-1]
    path = os.path.join(directory, f"step_{step:08d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    flat, spec = _pytree.tree_flatten_with_path(like)
    layouts = ([None] * len(flat) if shardings is None
               else _pytree.tree_flatten(shardings, is_leaf=_is_sharding)[0])
    if len(layouts) != len(flat):
        raise ValueError(f"shardings has {len(layouts)} leaves, like {len(flat)}")
    leaves = []
    for (pathk, leaf), layout in zip(flat, layouts):
        key = _key(pathk)
        a = arrays[key]
        if a.shape != tuple(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {a.shape}, expected {tuple(leaf.shape)}")
        dev = leaf.to_local().device if isinstance(leaf, DTensor) else leaf.device
        t = torch.from_numpy(a).to(device=dev, dtype=leaf.dtype, copy=True)
        if layout is not None:
            t = distribute_tensor(t, layout[0], layout[1], src_data_rank=None)
        leaves.append(t)
    return _pytree.tree_unflatten(leaves, spec)


def manifest(directory: str, step: Optional[int] = None) -> Dict[str, Any]:
    steps = latest_steps(directory)
    step = step if step is not None else steps[-1]
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)
