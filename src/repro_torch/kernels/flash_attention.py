"""CUDA kernel: causal flash attention (FA-2 online softmax), GQA-aware.

Replaces `repro/kernels/flash_attention.py::flash_attention_pallas`.  Source
`csrc/flash_attention.cu`; plain version `ref.flash_attention_ref`.  The
queries are the last S of T positions (bottom-right causal alignment), an
optional sliding window keeps keys with `k_pos > q_pos - window`, and the
kv head of query head h is `h // (H // Hkv)`, read in place.  A query row
with no visible key (only possible for S > T) outputs 0, where the plain
version gives NaN.

`route` picks the kernel variant from the dtype and head dim: `wgmma`
(bf16 on the tensor cores, P rounded to bf16 before P V), `tf32x3` (fp32
as three TF32 tensor-core products per product, hi*hi + hi*lo + lo*hi)
and `fma` (fp32 at D = 256 on the CUDA cores, where the tf32x3 tiles do
not fit).  Each variant is its own C entry point, `flash_attention_<route>`.
A head dim that no variant takes (the reduced configs' D = 16) is padded
with zeros to the next one that does, as the Pallas kernel pads its tiles:
zero columns of q and k add nothing to a logit, those of v give output
columns that are sliced off, and the scale stays 1/sqrt(D).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._build import Kernel, check_inputs

MAX_GRID_YZ = 65535
ROUTES = {(torch.bfloat16, 64): "wgmma", (torch.bfloat16, 128): "wgmma",
          (torch.bfloat16, 256): "wgmma", (torch.float32, 64): "tf32x3",
          (torch.float32, 128): "tf32x3", (torch.float32, 256): "fma"}
HEAD_DIMS = tuple(sorted({d for _, d in ROUTES}))
KERNEL = Kernel("flash_attention", [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                + [ctypes.c_float])


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel variant for inputs of `dtype` and head dim `d`; raises on
    a pair no variant takes."""
    if (dtype, d) not in ROUTES:
        raise ValueError(f"flash_attention: no kernel for {dtype} at head dim {d} "
                         f"(dtypes bfloat16, float32; head dims {HEAD_DIMS})")
    return ROUTES[(dtype, d)]


def padded_dim(dtype: torch.dtype, d: int) -> int:
    """The smallest head dim >= d that a variant takes in `dtype`; raises
    where none does."""
    dims = [hd for (dt, hd) in ROUTES if dt == dtype and hd >= d]
    if d < 1 or not dims:
        raise ValueError(f"flash_attention: no kernel for {dtype} at head dim {d} "
                         f"(dtypes bfloat16, float32; head dims up to {HEAD_DIMS[-1]})")
    return min(dims)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None
                    ) -> torch.Tensor:
    """q [B, H, S, D]; k, v [B, Hkv, T, D] -> [B, H, S, D] in q's dtype.
    CUDA tensors only; D <= 256 (padded to a variant's), window None or
    >= 1."""
    check_inputs("flash_attention", floats=(q, k, v))
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q must be [B, H, S, D] and k, v "
                         f"[B, Hkv, T, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same B and D, H a multiple of Hkv)")
    dp = padded_dim(q.dtype, d)
    variant = route(q.dtype, dp)
    if t == 0:
        raise ValueError("flash_attention: k, v hold no key (T = 0)")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got {window}")
    if h > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"flash_attention: B = {b}, H = {h} exceed the grid")
    if dp != d:
        q, k, v = (torch.nn.functional.pad(x, (0, dp - d)) for x in (q, k, v))
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_attention: q, k, v must be 16-byte aligned")
    out = torch.empty_like(q)
    if out.numel():
        KERNEL.launch(q.dtype, q.device, q.data_ptr(), k.data_ptr(),
                      v.data_ptr(), out.data_ptr(), b, h, hkv, s, t, dp,
                      int(causal), window or 0, 1.0 / math.sqrt(d), entry=variant)
    return out if dp == d else out[..., :d].contiguous()
