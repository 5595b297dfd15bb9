"""Production mesh construction (single-pod 16x16 / multi-pod 2x16x16).

Port of `repro/launch/mesh.py`.  Functions, not module-level constants:
importing this module touches no process group.  Each builds a
`DeviceMesh` over the ranks of the default process group, which the caller
initialises first (the dry-run a fake group of 256 or 512 ranks,
`launch/dryrun.py`; a real job one rank a card).
"""
from __future__ import annotations

import torch.distributed as dist

from repro_torch.runtime.collectives import make_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device_type)


def make_local_mesh(model_parallel: int = 1, device_type: str = "cuda"):
    """The ranks that exist, split (data, model)."""
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model_parallel={model_parallel}")
    return make_mesh((n // model_parallel, model_parallel), ("data", "model"), device_type)
