"""CUDA kernel: population-batched squared wirelength (paper Eq. 1).

Replaces `repro/kernels/wirelength.py::wirelength2_pallas`.  Source
`csrc/wirelength.cu`; plain version `ref.wirelength2_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, check_inputs

KERNEL = Kernel("wirelength", [ctypes.c_void_p] * 5
                + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int])


def wirelength2(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
                y2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x1, y1, x2, y2 [P, N]; w [N] (shared by every row) or [P, N]
    -> [P] fp32.  CUDA tensors only."""
    check_inputs("wirelength2", floats=(x1, y1, x2, y2, w))
    if x1.dim() != 2 or any(t.shape != x1.shape for t in (y1, x2, y2)):
        raise ValueError("wirelength2: endpoints must all be [P, N]")
    p, n = x1.shape
    if w.shape == (n,):
        w_stride = 0
    elif w.shape == (p, n):
        w_stride = n
    else:
        raise ValueError(f"wirelength2: w must be [N] or [P, N], got {tuple(w.shape)}")
    out = torch.empty(p, dtype=torch.float32, device=x1.device)
    if p:
        KERNEL.launch(x1.dtype, x1.device, x1.data_ptr(), y1.data_ptr(),
                      x2.data_ptr(), y2.data_ptr(), w.data_ptr(), w_stride,
                      out.data_ptr(), p, n)
    return out
