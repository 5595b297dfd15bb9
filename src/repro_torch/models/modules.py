"""Parameter specs and apply-side helpers: rmsnorm, dense, rope, swiglu,
and the training loss `softmax_xent`.

Port of `repro/models/modules.py`.  A `ParamSpec` gives a parameter's
shape and initializer; `param` realises it from an explicit
`torch.Generator` with the reference's distributions (normal x scale,
zeros, ones, const).  The two packages draw different numbers from the
same seed (the reference also folds a per-process salted hash of each
leaf's path into its key), so values are matched by carrying weights
across (`core/convert.py`), never by seed.  A spec also names each dim's
logical sharding axis (`sharding/logical.py`), as the reference's does;
`build` and `put` record them on the module (`_axes`), and
`transformer.param_axes` reads them back by parameter name.

Weights keep the reference's `[d_in, d_out]` layout: `dense` is `x @ w`.
The casts follow the reference: rmsnorm and rope compute in fp32 and cast
back, dense casts `w` to `x.dtype`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.sharding import logical


Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones | const
    scale: float = 1.0               # stddev for normal / value for const
    axes: Optional[Axes] = None      # logical sharding axes, len == ndim

    def __post_init__(self):
        if self.axes is not None and len(self.axes) != len(self.shape):
            raise ValueError(f"axes {self.axes} for shape {self.shape}")


def dense_spec(d_in: int, d_out: int, scale: Optional[float] = None,
               axes: Axes = (None, None)) -> ParamSpec:
    return ParamSpec((d_in, d_out), "normal",
                     scale if scale is not None else 1.0 / math.sqrt(d_in), axes)


def param(spec: ParamSpec, generator: Optional[torch.Generator], device,
          dtype=torch.float32) -> torch.nn.Parameter:
    """Realise one spec on `device`; with no generator the values are left
    uninitialised (for weights that are loaded next)."""
    t = torch.empty(spec.shape, dtype=torch.float32, device=device)
    if generator is not None:
        if spec.init == "normal":
            t.normal_(0.0, spec.scale, generator=generator)
        elif spec.init in ("zeros", "ones", "const"):
            t.fill_({"zeros": 0.0, "ones": 1.0, "const": spec.scale}[spec.init])
        else:
            raise ValueError(spec.init)
    return torch.nn.Parameter(t.to(dtype))


def build(module: torch.nn.Module, specs: Dict[str, Any],
          generator: Optional[torch.Generator], device, dtype=torch.float32) -> None:
    """Realise a tree of specs as `module`'s parameters, in the tree's order:
    a leaf becomes a parameter of its name, a nested dict a submodule, so
    the state dict's dotted names are the reference's tree paths."""
    for name, spec in specs.items():
        if isinstance(spec, dict):
            sub = torch.nn.Module()
            build(sub, spec, generator, device, dtype)
            setattr(module, name, sub)
        else:
            put(module, name, spec, generator, device, dtype)


def put(module: torch.nn.Module, name: str, spec: ParamSpec,
        generator: Optional[torch.Generator], device, dtype=torch.float32) -> None:
    """Realise `spec` as `module`'s parameter `name` and record its logical
    axes in `module._axes`."""
    setattr(module, name, param(spec, generator, device, dtype))
    if "_axes" not in module.__dict__:
        module._axes = {}
    module._axes[name] = spec.axes if spec.axes is not None else (None,) * len(spec.shape)


# ------------------------------------------------------------- apply-side

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)


class _LocalContiguousGrad(torch.autograd.Function):
    """Identity whose backward hands on a DTensor gradient with its local
    shard made contiguous: a matmul's backward views its output gradient
    flat, and DTensor judges that view by the global strides, which a
    local shard reached through transposes need not share."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor) and not g.to_local().is_contiguous():
            stride = torch.empty(g.shape, device="meta").stride()
            g = DTensor.from_local(g.to_local().contiguous(), g.device_mesh, g.placements,
                                   run_check=False, shape=g.shape, stride=stride)
        return g


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if isinstance(y, DTensor) and y.requires_grad:
        y = _LocalContiguousGrad.apply(y)
    return y


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x: [..., S, H, D] (D even); positions: [..., S]."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions[..., :, None].float() * freqs               # [..., S, D/2]
    cos = torch.cos(ang)[..., None, :]                           # [..., S, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wd: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(x, wg)) * dense(x, wu)
    return dense(h, wd)


def _gold_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """logits [..., V] at `targets` [...].  On DTensor logits sharded evenly
    over the vocab, each rank gathers the targets it holds and the partial
    sums reduce (a gather over the sharded dim would build its gradient at
    the global shape on every rank)."""
    last = logits.dim() - 1
    vocab_dims = ([i for i, p in enumerate(logits.placements) if p == Shard(last)]
                  if isinstance(logits, DTensor) else [])
    mesh = logits.device_mesh if vocab_dims else None
    n = math.prod(mesh.size(i) for i in vocab_dims) if vocab_dims else 1
    if not vocab_dims or logits.shape[-1] % n:
        return logical.constrain(torch.take_along_dim(logits, targets[..., None].long(), dim=-1),
                                 "batch", "seq", None)[..., 0]
    rest = [Replicate() if p == Shard(last) else p for p in logits.placements]
    if not isinstance(targets, DTensor):
        targets = DTensor.from_local(targets, mesh, [Replicate()] * mesh.ndim, run_check=False)
    local = logits.to_local()
    shard = 0
    for i in vocab_dims:
        shard = shard * mesh.size(i) + mesh.get_local_rank(i)
    idx = targets.redistribute(mesh, rest).to_local().long() - shard * local.shape[-1]
    mine = (idx >= 0) & (idx < local.shape[-1])
    gold = torch.take_along_dim(local, idx.clamp(0, local.shape[-1] - 1)[..., None], dim=-1)[..., 0]
    partial = [Partial() if p == Shard(last) else p for p in logits.placements]
    return DTensor.from_local(gold * mine.to(gold.dtype), mesh, partial,
                              run_check=False).redistribute(mesh, rest)


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean masked token cross-entropy with an fp32 logsumexp."""
    logits = logits.float()
    # on vocab-sharded DTensor logits both reduce over the vocab shards here
    lse = logical.constrain(torch.logsumexp(logits, dim=-1), "batch", "seq")
    gold = _gold_logits(logits, targets)
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
