"""Mesh construction and collectives over named mesh dims.

Port of `repro/runtime/jaxcompat.py`'s role: every sharded caller (the
split-KV decode, MoE's `_apply_ep`, the islands ring, the dry-run) reaches
`torch.distributed` through here.  The reference's version shims
(`shard_map`'s moved import, `make_mesh`'s `axis_types`) have no
counterpart: there is one torch.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with named dims.
Each collective takes the mesh and one dim name or a tuple of names; over
a tuple it runs dim by dim, innermost first, so an `all_gather` over
("data", "model") stacks the shards in the row-major order of their linear
index (`axis_index`), as `jax.lax.all_gather` over a tuple does.  These
are shard-local collectives (the body of a reference `shard_map`): they
act on each rank's own tensor.

Gradients follow shard_map's transposes under its replication checking.
A value is invariant over a mesh dim when every shard of that dim holds
the same copy, and varying where the shards differ.  `psum` and `pmean`
give an invariant result, whose cotangent is then the same on every
shard, so their backward is the identity (and 1/n).  `pvary` marks an
invariant value where it meets a varying one (jax inserts this cast
itself): the identity forward, and its backward sums the cotangent's
shard-local parts over the dims.  `pmax` and `all_gather` carry no
gradient: only the split-KV decode and the islands use them.

The group's backend decides the transport, and nothing falls back: on a
`gloo` group a CUDA tensor is copied to the host, reduced or gathered
there, and copied back (gloo carries only `broadcast` and `all_reduce` of
CUDA tensors in the installed torch, and NCCL takes one rank a card, so
two ranks on one card run gloo); any other backend gets the tensor as it
is.  `islands.Ring` decides its wire the same way.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

Axes = Union[str, Sequence[str]]


def make_mesh(shape: Sequence[int], names: Sequence[str],
              device_type: str = "cuda") -> DeviceMesh:
    """A `DeviceMesh` of `shape` with dims `names` over the default process
    group's ranks (which must number prod(shape))."""
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(names))


def _axes(axes: Axes) -> Tuple[str, ...]:
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh: DeviceMesh, axes: Axes) -> int:
    """The number of shards over one dim or the product over a tuple."""
    n = 1
    for a in _axes(axes):
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


def axis_index(mesh: DeviceMesh, axes: Axes) -> int:
    """This rank's row-major linear index over the named dims."""
    idx = 0
    for a in _axes(axes):
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + mesh.get_local_rank(a)
    return idx


def group_of(mesh: DeviceMesh, axes: Axes):
    """The process group over the named dims: one dim's own group, or that
    of the dims flattened (rank order = `axis_index`)."""
    axes = _axes(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _staged(x: torch.Tensor, group) -> bool:
    return x.device.type == "cuda" and dist.get_backend(group) == "gloo"


def _reduce(x: torch.Tensor, mesh: DeviceMesh, axes: Axes, op) -> torch.Tensor:
    out = x.contiguous().clone()
    for a in reversed(_axes(axes)):
        group = mesh.get_group(a)
        if _staged(out, group):
            host = out.cpu()
            dist.all_reduce(host, op=op, group=group)
            out = host.to(x.device)
        else:
            dist.all_reduce(out, op=op, group=group)
    return out


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _reduce(x, mesh, axes, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Vary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.mesh, ctx.axes, dist.ReduceOp.SUM), None, None


def psum(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """`x` summed over every shard of the named dims (backward: the
    identity)."""
    return _Sum.apply(x, mesh, axes)


def pvary(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """`x`, invariant over the named dims, as a value that varies over them:
    the identity, whose backward sums the cotangent over their shards."""
    return _Vary.apply(x, mesh, axes) if _axes(axes) else x


def pmax(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """The elementwise max of `x` over every shard of the named dims."""
    return _reduce(x, mesh, axes, dist.ReduceOp.MAX)


def pmean(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """The mean of `x` over every shard of the named dims (backward: 1/n)."""
    return psum(x, mesh, axes) / axis_size(mesh, axes)


def gather_list(x: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's `x` over a process group, in rank order, on x's device
    (staged through the host on a gloo group)."""
    staged = _staged(x, group)
    part = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(part) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, part, group=group)
    return [p.to(x.device) for p in parts] if staged else parts


def all_gather(x: torch.Tensor, mesh: DeviceMesh, axes: Axes) -> torch.Tensor:
    """[n, *x.shape]: every shard's `x` over the named dims, stacked in the
    order of `axis_index`."""
    out = x[None]
    for a in reversed(_axes(axes)):
        out = torch.stack(gather_list(out, mesh.get_group(a))).flatten(0, 1)
    return out


def ring_perm(n: int) -> List[Tuple[int, int]]:
    """The champion ring: shard i sends to shard (i + 1) % n, so every
    receiver adopts its left neighbour's payload (the direction of
    `torch.roll(x, 1, 0)` on an unsharded stack)."""
    return [(i, (i + 1) % n) for i in range(n)]
