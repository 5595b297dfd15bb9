"""CUDA kernel: Pareto domination matrix, with or without dominated-by counts.

One kernel (`csrc/domination.cu`) replaces two TPU kernels:
`repro/kernels/domination.py::domination_pallas` (no counts) and
`repro/kernels/fused_eval.py::domination_counts_pallas` (counts).  Each use
has its own custom op (`repro_torch::domination`,
`repro_torch::domination_counts`) and launch counter.  Plain versions:
`ref.domination_ref`, `ref.domination_counts_ref`.

Every leading axis of objs [..., P, M] is a batch of independent problems
(portfolio members, islands), all solved in one launch; under
`torch.func.vmap` the ops' batching rules fold the mapped axis into it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import Kernel, check_inputs, vmap_to_front

MAX_OBJECTIVES = 8
MAX_BATCH = 65535                  # grid.z
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
KERNEL = Kernel("domination", _ARGS)
KERNEL_COUNTS = Kernel("domination", _ARGS)


def _launch(kernel: Kernel, objs: torch.Tensor, counts: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    if objs.dim() < 2 or not 1 <= objs.shape[-1] <= MAX_OBJECTIVES:
        raise ValueError(f"domination: objs must be [..., P, M] with 1 <= M <= "
                         f"{MAX_OBJECTIVES}, got {tuple(objs.shape)}")
    *lead, p, m = objs.shape
    b = math.prod(lead)
    if b > MAX_BATCH:
        raise ValueError(f"domination: {b} problems in one launch, at most {MAX_BATCH}")
    objs = objs.contiguous()
    check_inputs("domination", floats=(objs,))
    dom = torch.empty(*lead, p, p, dtype=torch.bool, device=objs.device)
    cnt = torch.empty(*lead, p, dtype=torch.int32, device=objs.device) if counts else None
    if b and p:
        kernel.launch(objs.dtype, objs.device, objs.data_ptr(), dom.data_ptr(),
                      None if cnt is None else cnt.data_ptr(), b, p, m)
    return dom, cnt


@torch.library.custom_op("repro_torch::domination", mutates_args=())
def domination(objs: torch.Tensor) -> torch.Tensor:
    """objs [..., P, M] -> bool [..., P, P]; out[..., i, j] iff i dominates
    j.  One launch for every leading axis."""
    return _launch(KERNEL, objs, counts=False)[0]


@torch.library.custom_op("repro_torch::domination_counts", mutates_args=())
def domination_counts(objs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """objs [..., P, M] -> (bool dom [..., P, P], int32 dominated-by counts
    [..., P]).  One launch for every leading axis."""
    return _launch(KERNEL_COUNTS, objs, counts=True)


@domination.register_vmap
def _domination_vmap(info, in_dims, objs):
    return domination(vmap_to_front(objs, in_dims[0], info.batch_size)), 0


@domination_counts.register_vmap
def _domination_counts_vmap(info, in_dims, objs):
    return domination_counts(vmap_to_front(objs, in_dims[0], info.batch_size)), (0, 0)
