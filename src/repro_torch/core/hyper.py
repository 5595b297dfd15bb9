"""Config float fields as fp32 tensors (port of `repro/core/hyper.py::tracify`).

The reference runs every optimisation loop on f32 scalars so that `1.0 / (eta + 1.0)`
and friends round the same way whether a config is static or batched.  A
Python float would make torch compute those in double; `tracify` keeps the
port's arithmetic in f32 like the reference.
"""
from __future__ import annotations

import dataclasses

import torch

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
