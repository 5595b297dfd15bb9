"""CUDA kernel: population-batched squared wirelength (paper Eq. 1).

Replaces `repro/kernels/wirelength.py::wirelength2_pallas`.  Source
`csrc/wirelength.cu`; plain version `ref.wirelength2_ref`.  The custom op
`repro_torch::wirelength2` flattens every leading axis into rows of one
launch, and its vmap rule folds the mapped axis in the same way.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import Kernel, check_inputs, vmap_to_front

KERNEL = Kernel("wirelength", [ctypes.c_void_p] * 5
                + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_int])


def _launch(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
            y2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x1, y1, x2, y2 [P, N]; w [N] or [P, N] -> [P] fp32."""
    check_inputs("wirelength2", floats=(x1, y1, x2, y2, w))
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


@torch.library.custom_op("repro_torch::wirelength2", mutates_args=())
def wirelength2(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
                y2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x1, y1, x2, y2 [..., N]; w [N] (shared by every row) or [..., N]
    -> [...] fp32, one launch for every leading axis.  CUDA tensors only."""
    if x1.dim() < 1 or any(t.shape != x1.shape for t in (y1, x2, y2)):
        raise ValueError("wirelength2: endpoints must all be [..., N] of one shape")
    lead, n = x1.shape[:-1], x1.shape[-1]
    rows = [a.reshape(-1, n).contiguous() for a in (x1, y1, x2, y2)]
    if w.dim() != 1:
        if w.shape != x1.shape:
            raise ValueError(f"wirelength2: w must be [N] or the endpoints' shape "
                             f"{tuple(x1.shape)}, got {tuple(w.shape)}")
        w = w.reshape(-1, n)
    return _launch(*rows, w.contiguous()).reshape(lead)


@wirelength2.register_vmap
def _wirelength2_vmap(info, in_dims, x1, y1, x2, y2, w):
    b = info.batch_size
    ends = [vmap_to_front(a, d, b) for a, d in zip((x1, y1, x2, y2), in_dims[:4])]
    if in_dims[4] is not None or w.dim() != 1:    # per-row weights, laid out as the rows
        w = vmap_to_front(w, in_dims[4], b)
        w = w.reshape(b, *[1] * (ends[0].dim() - w.dim()), *w.shape[1:]).expand(ends[0].shape)
    return wirelength2(*ends, w), 0
