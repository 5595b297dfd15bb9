"""CUDA kernel: fused placement evaluation (decode-gather, Eq. 1, Eq. 2).

Replaces `repro/kernels/fused_eval.py::fused_eval_pallas`.  Source
`csrc/fused_eval.cu`; plain version `ref.fused_eval_ref`.  Leading batch
axes (slots x islands x pop) flatten into one launch of one block per row;
the vmap rule of the custom op `repro_torch::fused_eval` folds the mapped
axis in the same way.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels._build import Kernel, check_inputs, direct, vmap_to_front

MAX_SHARED_BYTES = 232448          # what one block may use on sm_90
KERNEL = Kernel("fused_eval", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5)


def _fused_eval(cx: torch.Tensor, cy: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, w: torch.Tensor, uidx: torch.Tensor) -> torch.Tensor:
    cx, cy = cx.contiguous(), cy.contiguous()
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


_op = torch.library.custom_op("repro_torch::fused_eval", _fused_eval, mutates_args=())


def fused_eval(cx: torch.Tensor, cy: torch.Tensor, src: torch.Tensor,
               dst: torch.Tensor, w: torch.Tensor, uidx: torch.Tensor
               ) -> torch.Tensor:
    """cx, cy [..., G]; src, dst [N] int32; w [N]; uidx [U, B] int32
    -> [..., 2] fp32 = (wirelength^2, max bbox).  CUDA tensors only.
    Through the custom op `repro_torch::fused_eval` unless `direct` finds
    nothing (vmap, autograd, a dispatch mode) that needs its dispatcher."""
    if direct(cx, cy, src, dst, w, uidx):
        return _fused_eval(cx, cy, src, dst, w, uidx)
    return _op(cx, cy, src, dst, w, uidx)


@_op.register_vmap
def _fused_eval_vmap(info, in_dims, cx, cy, src, dst, w, uidx):
    if any(d is not None for d in in_dims[2:]):
        raise ValueError("fused_eval: src, dst, w and uidx are tables shared by "
                         "every row; a batch of tables is not taken")
    b = info.batch_size
    return fused_eval(vmap_to_front(cx, in_dims[0], b), vmap_to_front(cy, in_dims[1], b),
                      src, dst, w, uidx), 0
