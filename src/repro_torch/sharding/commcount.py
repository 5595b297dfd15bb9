"""Per-device counts of a step traced on fake DTensors: collectives, flops,
traffic, live bytes.

The counterpart of `repro/sharding/hloparse.py`, which walks the compiled
per-device HLO.  Here the dry-run runs the step eagerly on DTensors whose
local shards are fake tensors (`FakeTensorMode`: nothing is allocated or
launched), and `CommCount`, a `TorchDispatchMode`, sees each rank's local
ops as DTensor dispatches them.  It sums, per device:

  * collective bytes by kind, sized by each collective's output tensors:
    `_c10d_functional.all_reduce` (and c10d's in-place `allreduce_`) ->
    all-reduce, `all_gather_into_tensor` -> all-gather,
    `reduce_scatter_tensor` -> reduce-scatter, `all_to_all_single` ->
    all-to-all, send / recv -> collective-permute, and DTensor's Shard ->
    Shard redistribution -> all-to-all (see `counting`);
  * dot flops, 2 x |out| x |contraction| of every mm / addmm / bmm /
    baddbmm, and 4 B H S T D for a flash-attention call (its two products,
    the causal half not subtracted);
  * an HBM traffic proxy: the bytes of the operands and outputs of every
    op that is not a view;
  * the peak of live bytes allocated inside the mode (outputs of ops that
    neither view nor write into an input, freed when their tensor is).

Eager mode runs every layer, so no loop trip count is needed (hloparse
recovers them from while-loop conditions).  An op seen with a DTensor
argument is handed back to DTensor (`NotImplemented`), which then runs the
rank's local ops under the mode.  The ops DTensor runs at global shapes to
derive output metadata (`ShardingPropagator`) are not counted: the mode
marks that call while it runs.
"""
from __future__ import annotations

import contextlib
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")
KINDS = {
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_": "all-reduce",
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.send": "collective-permute",
    "c10d.recv_": "collective-permute",
}
_MM = {"aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm"}
_FREE = {"aten.empty", "aten.empty_strided", "aten.empty_like", "aten.zeros",
         "aten.ones", "aten.full", "aten.arange", "prim.device", "aten.detach",
         "_c10d_functional.wait_tensor"}

_UNCOUNTED = [0]


def _name(func) -> str:
    return f"{func.namespace}.{func._opname}"


def _tensors(tree):
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def dot_flops(name: str, args, out) -> float:
    if name in ("aten.mm", "aten.addmm"):
        a = args[-2]
        return 2.0 * out.numel() * a.shape[-1]
    if name in ("aten.bmm", "aten.baddbmm"):
        a = args[-2]
        return 2.0 * out.numel() * a.shape[-1]
    if name == "repro_torch.flash_attention":
        q, k = args[0], args[1]
        b, h, s, d = q.shape
        return 4.0 * b * h * s * k.shape[2] * d
    return 0.0


class CommCount(TorchDispatchMode):
    """Per-device sums of one traced step; read `report()` after the
    `with` block."""

    def __init__(self):
        super().__init__()
        self.collectives: Dict[str, float] = defaultdict(float)
        self.calls: Dict[str, int] = defaultdict(int)
        self.flops = 0.0
        self.traffic = 0.0
        self.live = 0
        self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _UNCOUNTED[0]:
            return out
        name = _name(func)
        outs = _tensors(out)
        kind = KINDS.get(name)
        if kind is not None:
            self.collectives[kind] += sum(_nbytes(t) for t in outs)
            self.calls[kind] += 1
            return out
        if name in _FREE or func.is_view:
            return out
        ins = _tensors((args, kwargs))
        if name in _MM or name == "repro_torch.flash_attention":
            self.flops += dot_flops(name, ins, outs[0])
        self.traffic += sum(_nbytes(t) for t in ins + outs)
        if not any(r.alias_info is not None for r in func._schema.returns):
            for t in outs:
                n = _nbytes(t)
                self.live += n
                weakref.finalize(t, self._free, n)
            self.peak = max(self.peak, self.live)
        return out

    def report(self) -> Dict[str, object]:
        coll = {k: float(self.collectives.get(k, 0.0)) for k in COLLECTIVES}
        coll["total"] = float(sum(coll.values()))
        return {"collectives": coll, "collective_calls": dict(self.calls),
                "flops": self.flops, "traffic_bytes": self.traffic,
                "peak_live_bytes": self.peak}


@contextlib.contextmanager
def counting():
    """A `CommCount` active, with DTensor's metadata propagation left out
    of its sums and each Shard -> Shard redistribution booked as one
    all-to-all of its output's bytes.  DTensor runs that all-to-all as
    `_dtensor.shard_dim_alltoall` on a CUDA mesh and as an all-gather and
    a chunk on a CPU one; `Shard._to_new_shard_dim`, which both go
    through, is counted instead of the ops inside it, so a cell counts
    the same on either."""
    orig_meta = ShardingPropagator._propagate_tensor_meta_non_cached
    orig_a2a = Shard._to_new_shard_dim
    mode = CommCount()

    def marked(self, op_schema):
        _UNCOUNTED[0] += 1
        try:
            return orig_meta(self, op_schema)
        finally:
            _UNCOUNTED[0] -= 1

    def all_to_all(self, *args, **kwargs):
        _UNCOUNTED[0] += 1
        try:
            out = orig_a2a(self, *args, **kwargs)
        finally:
            _UNCOUNTED[0] -= 1
        if not _UNCOUNTED[0]:
            mode.collectives["all-to-all"] += _nbytes(out)
            mode.calls["all-to-all"] += 1
        return out

    ShardingPropagator._propagate_tensor_meta_non_cached = marked
    Shard._to_new_shard_dim = all_to_all
    try:
        with mode:
            yield mode
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = orig_meta
        Shard._to_new_shard_dim = orig_a2a
