"""AdamW from scratch: fp32 master weights, global-norm clip, LR schedules,
and an int8 + error-feedback gradient compressor.

Port of `repro/train/optimizer.py`, as plain functions on trees of tensors
(dicts, lists, tuples; `torch.utils._pytree`), computing what the
reference computes op for op; it is not `torch.optim.AdamW`.  The state
mirrors the parameter tree: every leaf keeps (master fp32, m, v), plus the
error-feedback residual `err` when compressing.  Parameters may be bf16:
updates always happen on the fp32 master, and the working copy is the
master cast to the parameter's dtype.  Nothing here writes a tensor in
place, so `init` lets an fp32 parameter share its master's storage, as
`update`'s new fp32 parameters do: the reference's `astype` to the same
dtype is no copy either.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
from torch.utils import _pytree


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"        # cosine | wsd | const
    compress_grads: bool = False    # int8 + error feedback


def schedule_lr(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at `step` (an integer tensor): linear warmup, then
    cosine, warmup-stable-decay (a 10% linear tail) or constant; fp32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "const":
        decay = 1.0
    elif cfg.schedule == "cosine":
        frac = torch.clamp((s - cfg.warmup_steps)
                           / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
        decay = 0.5 * (1.0 + torch.cos(math.pi * frac))
    elif cfg.schedule == "wsd":     # warmup-stable-decay (10% linear tail)
        tail = int(0.9 * cfg.total_steps)
        decay = torch.where(
            s < tail, 1.0,
            torch.clamp(1.0 - (s - tail) / max(cfg.total_steps - tail, 1), 0.05, 1.0))
    else:
        raise ValueError(cfg.schedule)
    return cfg.lr * warm * decay


def _zeros(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def init(params: Any, compress: bool = False) -> Dict[str, Any]:
    """Optimizer state for a parameter tree: the fp32 master (an fp32
    parameter's own storage, detached), zero m and v, step 0 (int32), and
    zero residuals `err` when compressing."""
    state = {
        "master": _pytree.tree_map(lambda p: p.detach().to(torch.float32), params),
        "m": _pytree.tree_map(_zeros, params),
        "v": _pytree.tree_map(_zeros, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=_pytree.tree_leaves(params)[0].device),
    }
    if compress:   # error-feedback residuals only exist when compressing
        state["err"] = _pytree.tree_map(_zeros, params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in _pytree.tree_leaves(tree)))


# ------------------------------------------------- gradient compression

def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8.  Returns (q, scale)."""
    amax = torch.clamp(torch.max(torch.abs(g)), min=1e-12)
    scale = amax / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(grads: Any, err: Any) -> Tuple[Any, Any]:
    """int8 round trip with error feedback: the quantisation residual is
    carried into the next step, so the compression is unbiased over time.
    Returns (dequantised grads, new residuals)."""

    def one(g, e):
        g = g.to(torch.float32) + e
        q, s = quantize_int8(g)
        deq = dequantize_int8(q, s)
        return deq, g - deq

    flat_g, spec = _pytree.tree_flatten(grads)
    outs = [one(g, e) for g, e in zip(flat_g, _pytree.tree_leaves(err))]
    return (_pytree.tree_unflatten([o[0] for o in outs], spec),
            _pytree.tree_unflatten([o[1] for o in outs], spec))


# ------------------------------------------------------------- update

def update(cfg: OptConfig, params: Any, grads: Any, state: Dict[str, Any]
           ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step: (new params in their dtypes, new state, {"grad_norm":
    the norm before clipping, "lr"})."""
    step = state["step"] + 1
    grads = _pytree.tree_map(lambda g: g.to(torch.float32), grads)

    if cfg.compress_grads:
        grads, new_err = compress_with_feedback(grads, state["err"])

    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    grads = _pytree.tree_map(lambda g: g * clip, grads)

    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    bc1 = 1.0 - b1 ** step.to(torch.float32)
    bc2 = 1.0 - b2 ** step.to(torch.float32)

    def upd(master, g, m, v):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * master
        return master - lr * delta, m, v

    flat_master, spec = _pytree.tree_flatten(state["master"])
    outs = [upd(*leaves) for leaves in zip(flat_master, _pytree.tree_leaves(grads),
                                           _pytree.tree_leaves(state["m"]),
                                           _pytree.tree_leaves(state["v"]))]
    new_master, new_m, new_v = (_pytree.tree_unflatten([o[i] for o in outs], spec)
                                for i in range(3))
    new_params = _pytree.tree_map(lambda mst, p: mst.to(p.dtype), new_master, params)
    new_state = {"master": new_master, "m": new_m, "v": new_v, "step": step}
    if cfg.compress_grads:
        new_state["err"] = new_err
    return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
