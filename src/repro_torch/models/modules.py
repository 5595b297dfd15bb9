"""Parameter specs and apply-side helpers: rmsnorm, dense, rope, swiglu,
and the training loss `softmax_xent`.

Port of `repro/models/modules.py`.  A `ParamSpec` gives a parameter's
shape and initializer; `param` realises it from an explicit
`torch.Generator` with the reference's distributions (normal x scale,
zeros, ones, const).  The two packages draw different numbers from the
same seed (the reference also folds a per-process salted hash of each
leaf's path into its key), so values are matched by carrying weights
across (`core/convert.py`), never by seed.  There are no logical sharding
axes: the port runs on one device.

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


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones | const
    scale: float = 1.0               # stddev for normal / value for const


def dense_spec(d_in: int, d_out: int, scale: Optional[float] = None) -> ParamSpec:
    return ParamSpec((d_in, d_out), "normal",
                     scale if scale is not None else 1.0 / math.sqrt(d_in))


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
            setattr(module, name, param(spec, generator, device, dtype))


# ------------------------------------------------------------- apply-side

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * gamma.float()).to(dt)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


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


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean masked token cross-entropy with an fp32 logsumexp."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.take_along_dim(logits, targets[..., None].long(), dim=-1)[..., 0]
    nll = lse - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
