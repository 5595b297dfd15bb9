"""CUDA kernel: population-batched maximum bounding box (paper Eq. 2).

Replaces `repro/kernels/bbox.py::maxbbox_pallas`.  Source `csrc/bbox.cu`;
plain version `ref.maxbbox_ref`.  The custom op `repro_torch::maxbbox`
flattens every leading axis into rows of one launch, and its vmap rule
folds the mapped axis in the same way.

`plan(p, u, b)` decides the launch: one block per row, the tiles of the
row's units it stages in shared memory, and the lanes that share a unit.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels._build import Kernel, ceil_div, check_inputs, direct, vmap_to_front

MAX_TILE = 4096         # values a block stages at once, per array: 2 x 4100 floats, 32 KB
MAX_BLOCKS = MAX_TILE   # B: one unit must fit in a tile
UNROLL = 4              # 16-byte loads a thread keeps in flight per array (csrc kUnroll)
MAX_THREADS = 512       # per block (csrc kMaxThreads)
KERNEL = Kernel("bbox", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6)


class Plan(NamedTuple):
    tile_units: int     # units a block stages at once
    tiles: int          # per row, one after the other
    sub: int            # lanes per unit: the largest power of two <= 32 dividing B
    threads: int        # per block: one round of 16-byte f32 loads stages a tile
    grid: int           # P: one block per row


@functools.lru_cache(maxsize=4096)
def plan(p: int, u: int, b: int) -> Plan:
    """The launch of `p` rows of `u` units of `b` blocks (b <= MAX_BLOCKS)."""
    tile_units = min(u, MAX_TILE // b)
    per_round = 4 * UNROLL                  # f32 values a thread loads in a round (bf16: twice)
    threads = min(MAX_THREADS, max(64, 32 * ceil_div(ceil_div(tile_units * b, per_round), 32)))
    return Plan(tile_units, ceil_div(u, tile_units), min(32, b & -b), threads, p)


def _maxbbox(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    if ux.dim() < 2 or uy.shape != ux.shape or 0 in ux.shape[-2:]:
        raise ValueError(f"maxbbox: ux, uy must be [..., U, B] with U, B >= 1, "
                         f"got {tuple(ux.shape)} and {tuple(uy.shape)}")
    *lead, u, b = ux.shape
    if b > MAX_BLOCKS:
        raise ValueError(f"maxbbox: B = {b} blocks per unit, at most {MAX_BLOCKS}")
    p = math.prod(lead)
    if ux.dim() != 3:
        ux, uy = ux.reshape(p, u, b), uy.reshape(p, u, b)
    ux, uy = ux.contiguous(), uy.contiguous()
    check_inputs("maxbbox", floats=(ux, uy))
    out = torch.empty(p, dtype=torch.float32, device=ux.device)
    if p:
        pl = plan(p, u, b)
        KERNEL.launch(ux.dtype, ux.device, ux.data_ptr(), uy.data_ptr(), out.data_ptr(),
                      p, u, b, pl.tile_units, pl.sub, pl.threads)
    return out if len(lead) == 1 else out.reshape(lead)


_op = torch.library.custom_op("repro_torch::maxbbox", _maxbbox, mutates_args=())


def maxbbox(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """ux, uy [..., U, B] -> [...] fp32 max over units of (width + height),
    one launch for every leading axis.  CUDA tensors only.  Through the
    custom op `repro_torch::maxbbox` unless `direct` finds nothing (vmap,
    autograd, a dispatch mode) that needs its dispatcher."""
    if direct(ux, uy):
        return _maxbbox(ux, uy)
    return _op(ux, uy)


@_op.register_vmap
def _maxbbox_vmap(info, in_dims, ux, uy):
    b = info.batch_size
    return maxbbox(vmap_to_front(ux, in_dims[0], b), vmap_to_front(uy, in_dims[1], b)), 0
