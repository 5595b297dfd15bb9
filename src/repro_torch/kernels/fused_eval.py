"""CUDA kernel: fused placement evaluation (decode-gather, Eq. 1, Eq. 2).

Replaces `repro/kernels/fused_eval.py::fused_eval_pallas`.  Source
`csrc/fused_eval.cu`; plain version `ref.fused_eval_ref`.  Leading batch
axes (slots x islands x pop) flatten into one launch of one block per row.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import Kernel, check_inputs

MAX_SHARED_BYTES = 232448          # what one block may use on sm_90
KERNEL = Kernel("fused_eval", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5)


def fused_eval(cx: torch.Tensor, cy: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, w: torch.Tensor, uidx: torch.Tensor
               ) -> torch.Tensor:
    """cx, cy [..., G]; src, dst [N] int32; w [N]; uidx [U, B] int32
    -> [..., 2] fp32 = (wirelength^2, max bbox).  CUDA tensors only."""
    check_inputs("fused_eval", floats=(cx, cy, w), ints=(src, dst, uidx))
    if cy.shape != cx.shape or cx.dim() < 1:
        raise ValueError(f"fused_eval: cx {tuple(cx.shape)} vs cy {tuple(cy.shape)}")
    if src.dim() != 1 or dst.shape != src.shape or w.shape != src.shape:
        raise ValueError("fused_eval: src, dst and w must be [N]")
    if uidx.dim() != 2 or uidx.shape[0] == 0 or uidx.shape[1] == 0:
        raise ValueError("fused_eval: uidx must be [U, B] with U, B >= 1")
    g = cx.shape[-1]
    if 8 * g > MAX_SHARED_BYTES:
        raise ValueError(f"fused_eval: G = {g} needs {8 * g} bytes of shared "
                         f"memory, more than {MAX_SHARED_BYTES}")
    batch = cx.shape[:-1]
    p = math.prod(batch)
    out = torch.empty(*batch, 2, dtype=torch.float32, device=cx.device)
    if p:
        KERNEL.launch(cx.dtype, cx.device, cx.data_ptr(), cy.data_ptr(),
                      src.data_ptr(), dst.data_ptr(), w.data_ptr(),
                      uidx.data_ptr(), out.data_ptr(), p, g, src.shape[0],
                      uidx.shape[0], uidx.shape[1])
    return out
