"""Plain PyTorch versions of every kernel in this package.

Ported from `repro/kernels/ref.py` (the semantics of record).  On the CPU
`ops.py` dispatches here; on the card each hand-written kernel is checked
against the function here.  bf16 rounding follows the reference exactly:
`wirelength2_ref` forms dl in the input dtype before the fp32 square-sum,
`maxbbox_ref` reduces in the input dtype.
"""
from __future__ import annotations

from typing import Optional, Tuple

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
    """objs [..., P, M] -> bool [..., P, P]; out[..., i, j] iff i dominates
    j (minimise)."""
    a = objs[..., :, None, :]
    b = objs[..., None, :, :]
    return torch.all(a <= b, dim=-1) & torch.any(a < b, dim=-1)


def domination_counts_ref(objs: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """objs [..., P, M] -> (bool dom [..., P, P], int32 dominated-by counts
    [..., P])."""
    dom = domination_ref(objs)
    return dom, torch.sum(dom, dim=-2, dtype=torch.int32)


def _scale(d: int) -> float:
    """1 / sqrt(d) rounded as the reference's fp32 `1 / jnp.sqrt(d)`."""
    return float(1.0 / torch.sqrt(torch.tensor(d, dtype=torch.float32)))


def _gqa_expand(k: torch.Tensor, n_q_heads: int) -> torch.Tensor:
    """[B, Hkv, T, D] -> [B, H, T, D] by repeating each KV head."""
    return torch.repeat_interleave(k, n_q_heads // k.shape[1], dim=1)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, window: Optional[int] = None,
                        logit_soft_cap: Optional[float] = None) -> torch.Tensor:
    """Reference attention.  q [B, H, S, D]; k, v [B, Hkv, T, D] (GQA).

    Causal masking takes the queries as the *last* S positions of the T
    keys (self-attention S == T, decode S == 1); `window` keeps only keys
    with k_pos > q_pos - window.  fp32 math, output in q's dtype; a row
    with no visible key is NaN, as in the reference.
    """
    h, s, d = q.shape[1], q.shape[2], q.shape[3]
    t = k.shape[2]
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * _scale(d)
    if logit_soft_cap is not None:
        logits = logit_soft_cap * torch.tanh(logits / logit_soft_cap)
    q_pos = torch.arange(s, device=q.device) + (t - s)
    k_pos = torch.arange(t, device=q.device)
    mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", probs, v.float()).to(q.dtype)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len: torch.Tensor
                         ) -> torch.Tensor:
    """Single-token decode attention against a (padded) KV cache.

    q [B, H, D]; caches [B, Hkv, T, D]; cache_len [B] valid lengths.
    """
    h, d = q.shape[1], q.shape[2]
    t = k_cache.shape[2]
    k = _gqa_expand(k_cache, h).float()
    v = _gqa_expand(v_cache, h).float()
    logits = torch.einsum("bhd,bhtd->bht", q.float(), k) * _scale(d)
    valid = torch.arange(t, device=q.device)[None, :] < cache_len[:, None]
    logits = torch.where(valid[:, None, :], logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bht,bhtd->bhd", probs, v).to(q.dtype)
