"""CUDA kernel: Pareto domination matrix, with or without dominated-by counts.

One kernel (`csrc/domination.cu`) replaces two TPU kernels:
`repro/kernels/domination.py::domination_pallas` (no counts) and
`repro/kernels/fused_eval.py::domination_counts_pallas` (counts).  Each use
has its own wrapper and launch counter.  Plain versions:
`ref.domination_ref`, `ref.domination_counts_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import Kernel, check_inputs

MAX_OBJECTIVES = 8
_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
KERNEL = Kernel("domination", _ARGS)
KERNEL_COUNTS = Kernel("domination", _ARGS)


def _launch(kernel: Kernel, objs: torch.Tensor, counts: bool
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    check_inputs("domination", floats=(objs,))
    if objs.dim() != 2 or not 1 <= objs.shape[1] <= MAX_OBJECTIVES:
        raise ValueError(f"domination: objs must be [P, M] with 1 <= M <= "
                         f"{MAX_OBJECTIVES}, got {tuple(objs.shape)}")
    p, m = objs.shape
    dom = torch.empty(p, p, dtype=torch.bool, device=objs.device)
    cnt = torch.empty(p, dtype=torch.int32, device=objs.device) if counts else None
    if p:
        kernel.launch(objs.dtype, objs.device, objs.data_ptr(), dom.data_ptr(),
                      None if cnt is None else cnt.data_ptr(), p, m)
    return dom, cnt


def domination(objs: torch.Tensor) -> torch.Tensor:
    """objs [P, M] -> bool [P, P]; out[i, j] iff i dominates j."""
    return _launch(KERNEL, objs, counts=False)[0]


def domination_counts(objs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """objs [P, M] -> (bool dom [P, P], int32 dominated-by counts [P])."""
    return _launch(KERNEL_COUNTS, objs, counts=True)
