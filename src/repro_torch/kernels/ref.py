"""Plain PyTorch versions of every kernel in this package.

Ported from `repro/kernels/ref.py` (the semantics of record).  On the CPU
`ops.py` dispatches here; on the card each hand-written kernel is checked
against the function here.  bf16 rounding follows the reference exactly:
`wirelength2_ref` forms dl in the input dtype before the fp32 square-sum,
`maxbbox_ref` reduces in the input dtype.
"""
from __future__ import annotations

from typing import Tuple

import torch


def wirelength2_ref(x1: torch.Tensor, y1: torch.Tensor, x2: torch.Tensor,
                    y2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 1: sum_n ((|dx_n| + |dy_n|) * w_n)^2 over the last axis."""
    dl = (torch.abs(x1 - x2) + torch.abs(y1 - y2)) * w
    return torch.sum(dl.float() ** 2, dim=-1)


def net_lengths_ref(x1, y1, x2, y2) -> torch.Tensor:
    """Per-net Manhattan wirelength, shape-preserving (pipelining input)."""
    return torch.abs(x1 - x2) + torch.abs(y1 - y2)


def maxbbox_ref(ux: torch.Tensor, uy: torch.Tensor) -> torch.Tensor:
    """Paper Eq. 2: max over units of (max-min)x + (max-min)y.

    ux, uy: [..., U, B] block coordinates grouped per conv unit.
    """
    w = torch.amax(ux, dim=-1) - torch.amin(ux, dim=-1)
    h = torch.amax(uy, dim=-1) - torch.amin(uy, dim=-1)
    return torch.amax(w + h, dim=-1)


def fused_eval_ref(bx: torch.Tensor, by: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, w: torch.Tensor, uidx: torch.Tensor
                   ) -> torch.Tensor:
    """bx, by: [..., G]; src/dst/w: [N]; uidx: [U, B] -> [..., 2] fp32.

    Composed from the per-objective versions, so on the CPU the fused path
    is bitwise the unfused one.
    """
    src, dst, uidx = src.long(), dst.long(), uidx.long()
    wl2 = wirelength2_ref(bx[..., src], by[..., src],
                          bx[..., dst], by[..., dst], w)
    bb = maxbbox_ref(bx[..., uidx], by[..., uidx])
    return torch.stack([wl2, bb.float()], dim=-1)


def domination_ref(objs: torch.Tensor) -> torch.Tensor:
    """objs [P, M] -> bool [P, P]; out[i, j] iff i dominates j (minimise)."""
    a = objs[:, None, :]
    b = objs[None, :, :]
    return torch.all(a <= b, dim=-1) & torch.any(a < b, dim=-1)


def domination_counts_ref(objs: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """objs [P, M] -> (bool dom [P, P], int32 dominated-by counts [P])."""
    dom = domination_ref(objs)
    return dom, torch.sum(dom, dim=0, dtype=torch.int32)
