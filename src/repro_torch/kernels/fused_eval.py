"""CUDA kernel: fused placement evaluation (decode-gather, Eq. 1, Eq. 2).

Replaces `repro/kernels/fused_eval.py::fused_eval_pallas`.  Source
`csrc/fused_eval.cu`; plain version `ref.fused_eval_ref`.  Leading batch
axes (slots x islands x pop) flatten into one launch of one block per row;
the vmap rule of the custom op `repro_torch::fused_eval` folds the mapped
axis in the same way.

`plan(p, g, n, u, b)` decides the launch from (G, N, U, B) only: the
threads of a row's block (every one takes nets), which of them are unit
lanes, the lanes per unit, and the shared memory.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels._build import Kernel, ceil_div, check_inputs, direct, vmap_to_front

MAX_SHARED_BYTES = 232448   # what one block may use on sm_90 (opt-in)
MAX_THREADS = 512           # per block (csrc kMaxThreads); the most unit lanes too
HEADER_FLOATS = 4 + 3 * 32  # the mbarrier, then wl, bb and bad of each warp (csrc kHeaderFloats)
KERNEL = Kernel("fused_eval", [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8)


def room_floats(n: int) -> int:
    """Shared floats per staged array of n values (csrc common.cuh)."""
    return ((n + 3) & ~3) + 4


def shared_bytes(g: int) -> int:
    """The block's whole shared memory for rows of g values: the kernel has
    no static shared memory, so this is what the launch asks for."""
    return 4 * (HEADER_FLOATS + 2 * room_floats(g))


# the largest G whose block fits: room_floats(G) <= the floats left per array
MAX_GIDS = ((MAX_SHARED_BYTES // 4 - HEADER_FLOATS) // 2 - 4) // 4 * 4


class Plan(NamedTuple):
    threads: int        # per block; thread t takes nets t, t + threads, ...
    unit_threads: int   # threads 0 .. unit_threads - 1 are unit lanes
    sub: int            # lanes per unit: the largest power of two <= 32 dividing B
    smem: int           # shared bytes per block
    grid: int           # P: one block per row


@functools.lru_cache(maxsize=4096)
def plan(p: int, g: int, n: int, u: int, b: int) -> Plan:
    """The launch of `p` rows of `g` coordinates, `n` nets and `u` units of
    `b` blocks.  Enough unit lanes for every unit in one pass where they
    fit in MAX_THREADS (more units take more passes), and at least a
    thread a net up to 256; every thread takes nets.  Everything but the
    grid depends on (g, n, u, b) only, so a row's sum is formed in the same
    order in any batch."""
    smem = shared_bytes(g)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"fused_eval: G = {g} needs {smem} bytes of shared memory, "
                         f"more than {MAX_SHARED_BYTES} (G <= {MAX_GIDS})")
    sub = min(32, b & -b)
    units = min(MAX_THREADS, 32 * ceil_div(u * sub, 32))
    nets = min(256, max(32, 32 * ceil_div(n, 32)))
    return Plan(max(units, nets), units, sub, smem, p)


def _launch(cx: torch.Tensor, cy: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
            w: torch.Tensor, uidx: torch.Tensor, pl: Plan) -> torch.Tensor:
    """cx, cy [P, G] contiguous -> [P, 2] fp32, launched as `pl` says."""
    p, g = cx.shape
    out = torch.empty(p, 2, dtype=torch.float32, device=cx.device)
    if p:
        KERNEL.launch(cx.dtype, cx.device, cx.data_ptr(), cy.data_ptr(),
                      src.data_ptr(), dst.data_ptr(), w.data_ptr(), uidx.data_ptr(),
                      out.data_ptr(), p, g, src.shape[0], uidx.shape[0], uidx.shape[1],
                      pl.threads, pl.unit_threads, pl.sub)
    return out


def _fused_eval(cx: torch.Tensor, cy: torch.Tensor, src: torch.Tensor,
                dst: torch.Tensor, w: torch.Tensor, uidx: torch.Tensor) -> torch.Tensor:
    if cy.shape != cx.shape or cx.dim() < 1:
        raise ValueError(f"fused_eval: cx {tuple(cx.shape)} vs cy {tuple(cy.shape)}")
    if src.dim() != 1 or dst.shape != src.shape or w.shape != src.shape:
        raise ValueError("fused_eval: src, dst and w must be [N]")
    if uidx.dim() != 2 or uidx.shape[0] == 0 or uidx.shape[1] == 0:
        raise ValueError("fused_eval: uidx must be [U, B] with U, B >= 1")
    *batch, g = cx.shape
    p = math.prod(batch)
    pl = plan(p, g, src.shape[0], *uidx.shape)     # raises where a row does not fit
    cx, cy = cx.contiguous(), cy.contiguous()
    check_inputs("fused_eval", floats=(cx, cy, w), ints=(src, dst, uidx))
    if cx.dim() != 2:
        cx, cy = cx.reshape(p, g), cy.reshape(p, g)
    out = _launch(cx, cy, src, dst, w, uidx, pl)
    return out if len(batch) == 1 else out.reshape(*batch, 2)


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
