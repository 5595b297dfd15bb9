"""Dispatch on the tensor's device: CPU -> plain version, CUDA -> kernel.

Port of `repro/kernels/ops.py`.  There is no environment switch and no
fallback: a CUDA tensor always goes to its hand-written kernel, whose
wrapper raises on a shape or dtype it does not take, and only a CPU tensor
runs the plain version in `ref.py`.  Every leading axis is a batch that
shares one launch; under `torch.func.vmap` the placement kernels' custom
ops fold the mapped axis into that launch, and the plain versions batch
natively.

`flash_attention` carries an autograd Function whose backward recomputes
through the plain version, as the reference's custom VJP does; there is no
backward kernel.  `decode_attention` has no kernel on either device: in the
reference it is XLA code, not a Pallas kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

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


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, logit_soft_cap):
        ctx.save_for_backward(q, k, v)
        ctx.args = (causal, window, logit_soft_cap)
        return _flash_forward(q, k, v, causal, window, logit_soft_cap)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = _ref.flash_attention_ref(q, k, v, *ctx.args)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True, window: Optional[int] = None,
                    logit_soft_cap: Optional[float] = None) -> torch.Tensor:
    """q [B, H, S, D]; k, v [B, Hkv, T, D] -> [B, H, S, D] in q's dtype."""
    return _FlashAttention.apply(q, k, v, causal, window, logit_soft_cap)


def decode_attention(q, k_cache, v_cache, cache_len) -> torch.Tensor:
    """Single-token decode, q [B, H, D] against caches [B, Hkv, T, D]."""
    return _ref.decode_attention_ref(q, k_cache, v_cache, cache_len)
