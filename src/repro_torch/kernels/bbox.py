"""CUDA kernel: population-batched maximum bounding box (paper Eq. 2).

Replaces `repro/kernels/bbox.py::maxbbox_pallas`.  Source `csrc/bbox.cu`;
plain version `ref.maxbbox_ref`.  The custom op `repro_torch::maxbbox`
flattens every leading axis into rows of one launch, and its vmap rule
folds the mapped axis in the same way.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import Kernel, check_inputs, vmap_to_front

KERNEL = Kernel("bbox", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3)


@torch.library.custom_op("repro_torch::maxbbox", mutates_args=())
def maxbbox(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """ux, uy [..., U, B] -> [...] fp32 max over units of (width + height),
    one launch for every leading axis.  CUDA tensors only."""
    if ux.dim() < 2 or uy.shape != ux.shape or 0 in ux.shape[-2:]:
        raise ValueError(f"maxbbox: ux, uy must be [..., U, B] with U, B >= 1, "
                         f"got {tuple(ux.shape)} and {tuple(uy.shape)}")
    *lead, u, b = ux.shape
    p = math.prod(lead)
    ux, uy = ux.reshape(p, u, b).contiguous(), uy.reshape(p, u, b).contiguous()
    check_inputs("maxbbox", floats=(ux, uy))
    out = torch.empty(p, dtype=torch.float32, device=ux.device)
    if p:
        KERNEL.launch(ux.dtype, ux.device, ux.data_ptr(), uy.data_ptr(),
                      out.data_ptr(), p, u, b)
    return out.reshape(lead)


@maxbbox.register_vmap
def _maxbbox_vmap(info, in_dims, ux, uy):
    b = info.batch_size
    return maxbbox(vmap_to_front(ux, in_dims[0], b), vmap_to_front(uy, in_dims[1], b)), 0
