"""Config float fields as fp32 tensors: one batched program, many configs.

Port of `repro/core/hyper.py` (`split_config`, `merge_config`, `tracify`,
`stack_configs`).  A config's int/bool/str fields are *static*: they fix
shapes and branches, so members of one portfolio must agree on them.  Its
float fields are *traced*: fp32 tensors, 0-d for one run, [K] for K
members stacked along a batch axis that `torch.func.vmap` maps over.

The reference runs every optimisation loop on f32 scalars so that `1.0 / (eta + 1.0)`
and friends round the same way whether a config is static or batched.  A
Python float would make torch compute those in double; `tracify` keeps the
port's arithmetic in f32 like the reference, and a member of a stacked
config computes exactly what its `tracify`d config computes alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Sequence, Tuple

import torch

# (config class, ((name, value), ...)) of the int/bool/str fields
StaticKey = Tuple[type, Tuple[Tuple[str, Any], ...]]

_STATIC_ANNOTATIONS = {"int", "bool", "str"}


def _is_traced_field(f: dataclasses.Field) -> bool:
    """Classify by the declared type: a float hyperparameter passed as an
    int (``sbx_eta=20``) is still a float field."""
    t = f.type
    name = t if isinstance(t, str) else getattr(t, "__name__", str(t))
    if name == "float":
        return True
    if name in _STATIC_ANNOTATIONS:
        return False
    raise TypeError(f"config field {f.name!r} must be annotated "
                    f"int/bool/str/float, got {name!r}")


def tracify(cfg, device):
    """Float fields -> fp32 0-d tensors on `device`; other fields untouched."""
    kwargs = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        kwargs[f.name] = (torch.tensor(float(v), dtype=torch.float32, device=device)
                          if _is_traced_field(f) else v)
    return type(cfg)(**kwargs)


def split_fields(cfg) -> Tuple[StaticKey, Dict[str, Any]]:
    """Dataclass config -> (hashable key of the static fields, float fields
    as they are: Python numbers or fp32 tensors)."""
    static, traced = [], {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if _is_traced_field(f):
            traced[f.name] = v
        else:
            static.append((f.name, v))
    return (type(cfg), tuple(static)), traced


def split_config(cfg) -> Tuple[StaticKey, Dict[str, float]]:
    """Dataclass config -> (hashable key of the static fields, float fields
    as Python floats)."""
    static_key, traced = split_fields(cfg)
    return static_key, {n: float(v) for n, v in traced.items()}


def merge_config(static_key: StaticKey, traced: Dict[str, Any]):
    """Rebuild a config from its static key and its float fields (Python
    numbers or fp32 tensors, batched inside `torch.func.vmap`)."""
    cls, static = static_key
    return cls(**dict(static), **traced)


def stack_configs(cfgs: Sequence, device) -> Tuple[StaticKey, Dict[str, torch.Tensor]]:
    """K configs sharing their static fields -> (static key, {name: fp32 [K]}
    on `device`).  Raises if a member differs on a static field: it needs a
    program of its own (another portfolio or pool)."""
    if not cfgs:
        raise ValueError("empty portfolio")
    splits = [split_config(c) for c in cfgs]
    static_key = splits[0][0]
    for c, (sk, _) in zip(cfgs, splits):
        if sk != static_key:
            raise ValueError("portfolio members must agree on static fields "
                             f"(shapes/branches); {c} differs from {cfgs[0]}")
    stacked = {n: torch.tensor([t[n] for _, t in splits], dtype=torch.float32,
                               device=device)
               for n in splits[0][1]}
    return static_key, stacked


def unstack_config(static_key: StaticKey, traced: Dict[str, torch.Tensor], i: int):
    """Member `i` of a stacked config, its floats 0-d fp32 views."""
    return merge_config(static_key, {n: v[i] for n, v in traced.items()})


def as_f32(v, device) -> torch.Tensor:
    """A config float (Python number or 0-d tensor) as an fp32 0-d tensor on
    `device`; a Python number is filled in on the device, not copied there."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)
