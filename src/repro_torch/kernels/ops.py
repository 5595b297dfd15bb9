"""Dispatch on the tensor's device: CPU -> plain version, CUDA -> kernel.

Port of `repro/kernels/ops.py`.  There is no environment switch and no
fallback: a CUDA tensor always goes to its hand-written kernel, whose
wrapper raises on a shape or dtype it does not take, and only a CPU tensor
runs the plain version in `ref.py`.  Every leading axis is a batch that
shares one launch; under `torch.func.vmap` the placement kernels' custom
ops fold the mapped axis into that launch, and the plain versions batch
natively.

`flash_attention` is the custom op `repro_torch::flash_attention`: its
implementation is the device dispatch above (the plain version on the CPU,
the kernel on CUDA), with a fake implementation (the dry-run traces it
without a launch), an autograd rule whose backward recomputes through the
plain version, as the reference's custom VJP does (there is no backward
kernel), and a DTensor sharding rule: all replicated, or q, k and v
sharded alike on the batch dim, or on the heads dim where the kv heads
divide over the largest mesh dim (each rank then holds whole GQA groups;
the model lays q, k and v out on one mesh dim, `attention._flash_layout`);
any other layout is redistributed to one of these.
`decode_attention` has no kernel on either device: in the reference it is
XLA code, not a Pallas kernel.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding

from repro_torch.kernels import bbox as _bbox
from repro_torch.kernels import domination as _dom
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_eval as _fe
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import wirelength as _wl


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def wirelength2(x1, y1, x2, y2, w) -> torch.Tensor:
    """[..., N] endpoint coords, w [N] or [..., N] -> [...] fp32 (Eq. 1)."""
    if _on_cpu(x1):
        return _ref.wirelength2_ref(x1, y1, x2, y2, w)
    return _wl.wirelength2(x1, y1, x2, y2, w)


def maxbbox(ux, uy) -> torch.Tensor:
    """[..., U, B] unit-grouped coords -> [...] fp32 (Eq. 2)."""
    if _on_cpu(ux):
        return _ref.maxbbox_ref(ux, uy)
    return _bbox.maxbbox(ux, uy)


def domination_matrix(objs: torch.Tensor) -> torch.Tensor:
    """[..., P, M] objectives -> bool [..., P, P], minimisation domination."""
    if _on_cpu(objs):
        return _ref.domination_ref(objs)
    return _dom.domination(objs)


def fused_domination_counts(objs: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., P, M] objectives -> (bool dom [..., P, P], int32 dominated-by
    [..., P])."""
    if _on_cpu(objs):
        return _ref.domination_counts_ref(objs)
    return _dom.domination_counts(objs)


def fused_eval(bx, by, src, dst, w, uidx) -> torch.Tensor:
    """bx, by [..., G]; src/dst/w [N]; uidx [U, B] -> [..., 2] fp32 =
    (wirelength^2, max bbox), one launch for all leading axes on CUDA."""
    if _on_cpu(bx):
        return _ref.fused_eval_ref(bx, by, src, dst, w, uidx)
    return _fe.fused_eval(bx, by, src, dst, w, uidx)


# ------------------------------------------------------------- attention

def _flash_forward(q, k, v, causal, window, logit_soft_cap):
    if _on_cpu(q):
        return _ref.flash_attention_ref(q, k, v, causal, window, logit_soft_cap)
    if logit_soft_cap is not None:
        raise NotImplementedError(
            "flash_attention: logit_soft_cap has no CUDA kernel (the TPU "
            "kernel has none either and no config sets one)")
    return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal, window)


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
              window: Optional[int], logit_soft_cap: Optional[float]) -> torch.Tensor:
    return _flash_forward(q, k, v, causal, window, logit_soft_cap)


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, window, logit_soft_cap):
    return torch.empty_like(q, memory_format=torch.contiguous_format)


def _flash_setup(ctx, inputs, output):
    q, k, v, causal, window, logit_soft_cap = inputs
    ctx.save_for_backward(q, k, v)
    ctx.args = (causal, window, logit_soft_cap)
    ctx.layout = (output.device_mesh, output.placements) if isinstance(output, DTensor) else None


def _flash_grads(q, k, v, g, args):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        out = _ref.flash_attention_ref(q, k, v, *args)
        return torch.autograd.grad(out, (q, k, v), g)


def _flash_backward(ctx, g):
    q, k, v = ctx.saved_tensors
    if ctx.layout is None:
        return (*_flash_grads(q, k, v, g, ctx.args), None, None, None)
    # every layout the sharding rule takes is rank-local: recompute each
    # rank's shard, in the layout the forward ran in
    mesh, placements = ctx.layout
    q, k, v, g = (t.redistribute(mesh, placements) for t in (q, k, v, g))
    grads = _flash_grads(q.to_local(), k.to_local(), v.to_local(), g.to_local(), ctx.args)
    # each gradient in its input's local layout, so that the global strides hold
    return (*(DTensor.from_local(torch.empty_like(t.to_local()).copy_(d), mesh, placements,
                                 run_check=False, shape=t.shape, stride=t.stride())
              for d, t in zip(grads, (q, k, v))), None, None, None)


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def _head_shards(t) -> int:
    """The number of shards of dim 1 (heads) in a DTensor's (or a
    DTensorSpec's) layout."""
    return math.prod(t.device_mesh.size(i) if isinstance(t, DTensor) else t.mesh.size(i)
                     for i, p in enumerate(t.placements) if p == Shard(1))


@register_sharding(torch.ops.repro_torch.flash_attention.default)
def _flash_sharding(q, k, v, causal, window, logit_soft_cap):
    """Batch rows, or heads, are independent.  DTensor expands these
    strategies over every mesh dim and takes the one that moves the least,
    with no check that a dim splits evenly; so heads are offered only
    where Hkv divides by the shards q's heads already have (the layout
    `attention._flash_layout` gives q, k and v alike, taken at no cost),
    and `flash_attention` checks the layout that was taken."""
    rest = [None, None, None]
    out = [([Replicate()], [Replicate()] * 3 + rest),
           ([Shard(0)], [Shard(0)] * 3 + rest)]
    n = _head_shards(q)
    if n > 1 and k.shape[1] % n == 0:
        out.append(([Shard(1)], [Shard(1)] * 3 + rest))
    return out


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    logit_soft_cap: Optional[float] = None) -> torch.Tensor:
    """q [B, H, S, D]; k, v [B, Hkv, T, D] -> [B, H, S, D] in q's dtype."""
    out = _flash_op(q, k, v, causal, window, logit_soft_cap)
    if isinstance(out, DTensor) and k.shape[1] % _head_shards(out):
        raise ValueError(f"flash_attention: {k.shape[1]} kv heads split over "
                         f"{_head_shards(out)} shards ({out.placements}) would break "
                         "the GQA groups")
    return out


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Single-token decode, q [B, H, D] against caches [B, Hkv, T, D]."""
    return _ref.decode_attention_ref(q, k_cache, v_cache, cache_len)
