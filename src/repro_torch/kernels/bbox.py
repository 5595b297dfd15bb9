"""CUDA kernel: population-batched maximum bounding box (paper Eq. 2).

Replaces `repro/kernels/bbox.py::maxbbox_pallas`.  Source `csrc/bbox.cu`;
plain version `ref.maxbbox_ref`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, check_inputs

KERNEL = Kernel("bbox", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)


def maxbbox(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """ux, uy [P, U, B] -> [P] fp32 max over units of (width + height).
    CUDA tensors only."""
    check_inputs("maxbbox", floats=(ux, uy))
    if ux.dim() != 3 or uy.shape != ux.shape or 0 in ux.shape[1:]:
        raise ValueError(f"maxbbox: ux, uy must be [P, U, B] with U, B >= 1, "
                         f"got {tuple(ux.shape)} and {tuple(uy.shape)}")
    p, u, b = ux.shape
    out = torch.empty(p, dtype=torch.float32, device=ux.device)
    if p:
        KERNEL.launch(ux.dtype, ux.device, ux.data_ptr(), uy.data_ptr(),
                      out.data_ptr(), p, u, b)
    return out
