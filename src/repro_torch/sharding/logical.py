"""Logical-axis sharding rules with divisibility-aware fallback.

Port of `repro/sharding/logical.py`.  Models name every parameter and
activation dim with a *logical* axis ("embed", "q_flat", "experts",
"batch", ...).  A `Rules` table maps logical names to mesh dims;
`spec_for` resolves a logical signature to a spec, one entry per tensor
dim (None, a mesh dim name, or a tuple of names: the contents of the
reference's `PartitionSpec`), dropping any assignment whose mesh-dim
product does not divide the dim and never spending a mesh dim twice.
`placements` turns a spec into DTensor placements on a `DeviceMesh`:
`Shard(d)` on each mesh dim that shards tensor dim d, `Replicate()`
elsewhere.  DTensor splits one tensor dim over several mesh dims in mesh
order, so a tuple of dims on one tensor dim must be in mesh order (every
tuple `default_rules` and `core.autoshard.SITES` produce is).

Usage:
    with activate(mesh, rules):
        logits = model(tokens)          # params and inputs are DTensors
Inside model code: `x = constrain(x, "batch", "seq", None)`.  Without an
active context, or on a plain tensor, `constrain` is the identity, so the
same model runs unmodified on one device.

`spec_for` takes a `DeviceMesh` or any object whose `shape` maps dim names
to sizes (the parity tests size 256- and 512-chip meshes without a
process group); `placements` needs a `DeviceMesh`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class Rules:
    """logical axis name -> mesh dim (or tuple of dims, or None)."""

    table: Tuple[Tuple[str, MeshAxes], ...]

    def get(self, name: str) -> MeshAxes:
        for k, v in self.table:
            if k == name:
                return v
        return None

    def override(self, **kv: MeshAxes) -> "Rules":
        items = [(k, v) for k, v in self.table if k not in kv]
        items += list(kv.items())
        return Rules(tuple(items))

    def as_dict(self) -> Dict[str, MeshAxes]:
        return dict(self.table)


def default_rules(multi_pod: bool = False) -> Rules:
    """The baseline layout: batch over (pod,)data; width over model."""
    batch = ("pod", "data") if multi_pod else ("data",)
    return Rules((
        ("batch", batch),
        ("seq", None),                 # sequence replicated by default
        ("kv_seq", "model"),           # KV caches: flash-decoding split-KV
        ("embed", None),
        ("q_flat", "model"),           # flattened H*dh -- divides everywhere
        ("kv_flat", "model"),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("head", None),
        ("mlp", "model"),
        ("experts", "model"),
        ("expert_mlp", None),
        ("vocab", "model"),
        ("ssm_inner", "model"),
        ("ssm_state", None),
        ("frontend", None),
    ))


# --------------------------------------------------------------- context

_ACTIVE: List[Tuple[object, Rules]] = []


@contextlib.contextmanager
def activate(mesh, rules: Rules):
    """Make (mesh, rules) the current context; DTensor ops that mix in a
    plain tensor (an `arange` of positions, a mask) replicate it."""
    from torch.distributed.tensor.experimental import implicit_replication
    _ACTIVE.append((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _ACTIVE.pop()


def current() -> Optional[Tuple[object, Rules]]:
    return _ACTIVE[-1] if _ACTIVE else None


def current_mesh():
    c = current()
    return c[0] if c else None


# ------------------------------------------------------------- resolution

def mesh_shape(mesh) -> Mapping[str, int]:
    """Dim name -> size, of a `DeviceMesh` or of an object whose `shape`
    is already such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return mesh.shape


def axes_size(mesh, axes: MeshAxes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int],
             mesh=None, rules: Optional[Rules] = None) -> Spec:
    """Resolve logical axes -> a spec with divisibility fallback."""
    ctx = current()
    if mesh is None or rules is None:
        if ctx is None:
            return (None,) * len(shape)
        mesh = mesh or ctx[0]
        rules = rules or ctx[1]
    sizes = mesh_shape(mesh)
    parts: List[MeshAxes] = []
    used: set = set()
    for name, dim in zip(axes, shape):
        assign = rules.get(name) if name else None
        if assign is not None:
            tup = (assign,) if isinstance(assign, str) else tuple(assign)
            tup = tuple(a for a in tup if a in sizes and a not in used)
            size = axes_size(mesh, tup)
            if size > 1 and dim % size == 0:
                parts.append(tup if len(tup) > 1 else tup[0])
                used.update(tup)
                continue
        parts.append(None)
    return tuple(parts)


def placements(spec: Spec, mesh) -> Tuple:
    """DTensor placements of `spec` on `mesh`: Shard(d) on every mesh dim
    that shards tensor dim d, Replicate() on the others."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        tup = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in tup]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: mesh dims {tup} on tensor dim {d} are not in "
                             f"mesh order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class _LayGradient(torch.autograd.Function):
    """The identity, whose backward redistributes the incoming gradient to
    the placements `want`: the transpose of a sharding constraint is the
    same constraint, as with the reference's `with_sharding_constraint`."""

    @staticmethod
    def forward(ctx, x, mesh, want):
        ctx.mesh, ctx.want = mesh, want
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and tuple(g.placements) != ctx.want:
            g = g.redistribute(ctx.mesh, ctx.want)
        return g, None, None


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Redistribute a DTensor to the layout of its logical axes, and lay
    its gradient out alike (also where the value is laid out so already);
    the identity on a plain tensor or without an active context."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    want = placements(spec_for(axes, x.shape, mesh, rules), mesh)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        x = _LayGradient.apply(x, mesh, want)
    return x


def named_sharding(axes: Sequence[Optional[str]], shape: Sequence[int],
                   mesh=None, rules: Optional[Rules] = None) -> Tuple[object, Tuple]:
    """(mesh, placements) of logical `axes` at `shape` (the reference's
    NamedSharding)."""
    ctx = current()
    mesh = mesh or (ctx[0] if ctx else None)
    rules = rules or (ctx[1] if ctx else None)
    if mesh is None:
        raise ValueError("no active mesh")
    return mesh, placements(spec_for(axes, shape, mesh, rules), mesh)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def tree_shardings(spec_tree, shape_tree, mesh=None, rules: Optional[Rules] = None):
    """Map a tree (dicts, lists) of logical-axis tuples and a tree of
    shapes of the same structure to a tree of (mesh, placements)."""
    if _is_axes(spec_tree):
        return named_sharding(spec_tree, tuple(shape_tree), mesh, rules)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, shape_tree[k], mesh, rules) for k, v in spec_tree.items()}
    return type(spec_tree)(tree_shardings(v, s, mesh, rules)
                           for v, s in zip(spec_tree, shape_tree))
