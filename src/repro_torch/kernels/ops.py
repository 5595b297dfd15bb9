"""Dispatch on the tensor's device: CPU -> plain version, CUDA -> kernel.

Port of `repro/kernels/ops.py` (the placement entries).  There is no
environment switch and no fallback: a CUDA tensor always goes to its
hand-written kernel, whose wrapper raises on a shape or dtype it does not
take, and only a CPU tensor runs the plain version in `ref.py`.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import bbox as _bbox
from repro_torch.kernels import domination as _dom
from repro_torch.kernels import fused_eval as _fe
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import wirelength as _wl


def _on_cpu(t: torch.Tensor) -> bool:
    return t.device.type == "cpu"


def wirelength2(x1, y1, x2, y2, w) -> torch.Tensor:
    """[..., N] endpoint coords, w [N] or [..., N] -> [...] fp32 (Eq. 1)."""
    if _on_cpu(x1):
        return _ref.wirelength2_ref(x1, y1, x2, y2, w)
    lead, n = x1.shape[:-1], x1.shape[-1]
    rows = [a.reshape(-1, n).contiguous() for a in (x1, y1, x2, y2)]
    w = w if w.dim() == 1 else w.reshape(-1, n)
    return _wl.wirelength2(*rows, w.contiguous()).reshape(lead)


def maxbbox(ux, uy) -> torch.Tensor:
    """[..., U, B] unit-grouped coords -> [...] fp32 (Eq. 2)."""
    if _on_cpu(ux):
        return _ref.maxbbox_ref(ux, uy)
    lead, (u, b) = ux.shape[:-2], ux.shape[-2:]
    return _bbox.maxbbox(ux.reshape(-1, u, b).contiguous(),
                         uy.reshape(-1, u, b).contiguous()).reshape(lead)


def domination_matrix(objs: torch.Tensor) -> torch.Tensor:
    """[P, M] objectives -> bool [P, P], minimisation domination."""
    if _on_cpu(objs):
        return _ref.domination_ref(objs)
    return _dom.domination(objs.contiguous())


def fused_domination_counts(objs: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[P, M] objectives -> (bool dom [P, P], int32 dominated-by [P])."""
    if _on_cpu(objs):
        return _ref.domination_counts_ref(objs)
    return _dom.domination_counts(objs.contiguous())


def fused_eval(bx, by, src, dst, w, uidx) -> torch.Tensor:
    """bx, by [..., G]; src/dst/w [N]; uidx [U, B] -> [..., 2] fp32 =
    (wirelength^2, max bbox), one launch for all leading axes on CUDA."""
    if _on_cpu(bx):
        return _ref.fused_eval_ref(bx, by, src, dst, w, uidx)
    return _fe.fused_eval(bx.contiguous(), by.contiguous(), src, dst, w, uidx)
