"""Config float fields as fp32 tensors (port of `repro/core/hyper.py`:
`tracify` and `split_config`).

The reference runs every optimisation loop on f32 scalars so that `1.0 / (eta + 1.0)`
and friends round the same way whether a config is static or batched.  A
Python float would make torch compute those in double; `tracify` keeps the
port's arithmetic in f32 like the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

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


def split_config(cfg) -> Tuple[StaticKey, Dict[str, float]]:
    """Dataclass config -> (hashable key of the static fields, float fields)."""
    static, traced = [], {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if _is_traced_field(f):
            traced[f.name] = float(v)
        else:
            static.append((f.name, v))
    return (type(cfg), tuple(static)), traced


def as_f32(v, device) -> torch.Tensor:
    """A config float (Python number or 0-d tensor) as an fp32 0-d tensor on
    `device`; a Python number is filled in on the device, not copied there."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)
