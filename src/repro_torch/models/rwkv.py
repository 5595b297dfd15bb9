"""RWKV-6 "Finch" block: attention-free, data-dependent decay recurrence.

Port of `repro/models/rwkv.py` (arXiv:2404.05892): per-channel decays
w_t are functions of the input (a low-rank MLP), and the WKV state is a
per-head [dh, dh] outer-product accumulator

    wkv_t = r_t . (S_{t-1} + (u * k_t) v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T

plus token-shift mixing and the squared-ReLU channel-mix FFN.  The state
is {S [B, H, dh, dh] fp32, x_tm, x_cm [B, d]}; decode is `RWKV.forward`
on one token against it, with no KV cache.

The WKV recurrence runs as a loop over tokens.  The reference's chunked
double scan (`rwkv.py:139-149`) exists to checkpoint the backward pass,
which serving does not run.  The state stays fp32: the reference's
`REPRO_RWKV_STATE_BF16` switch has no counterpart.  As in the reference,
the block's two norms use `rmsnorm`'s default eps, not the config's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import modules as M
from repro_torch.sharding import logical


@dataclasses.dataclass(frozen=True)
class RWKVArgs:
    d_model: int
    d_ff: int
    head_dim: int = 64
    decay_rank: int = 64

    @property
    def n_heads(self) -> int:
        return self.d_model // self.head_dim


def specs(a: RWKVArgs) -> Dict[str, object]:
    d = a.d_model
    emb = ("embed",)
    half = M.ParamSpec((d,), "const", 0.5, emb)
    return {
        "ln1": M.ParamSpec((d,), "ones", axes=emb),
        "ln2": M.ParamSpec((d,), "ones", axes=emb),
        "tm": {  # time-mix
            "mu_r": half, "mu_k": half, "mu_v": half, "mu_g": half, "mu_w": half,
            "wr": M.dense_spec(d, d, axes=("embed", "q_flat")),
            "wk": M.dense_spec(d, d, axes=("embed", "q_flat")),
            "wv": M.dense_spec(d, d, axes=("embed", "q_flat")),
            "wg": M.dense_spec(d, d, axes=("embed", "q_flat")),
            "wo": M.dense_spec(d, d, axes=("q_flat", "embed")),
            # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
            "w0": M.ParamSpec((d,), "const", -0.6, emb),
            "wa": M.dense_spec(d, a.decay_rank, 0.01, ("embed", None)),
            "wb": M.dense_spec(a.decay_rank, d, 0.01, (None, "embed")),
            "u": M.ParamSpec((d,), "const", 0.3, emb),  # bonus
        },
        "cm": {  # channel-mix
            "mu_r": half, "mu_k": half,
            "wr": M.dense_spec(d, d, axes=("embed", None)),
            "wk": M.dense_spec(d, a.d_ff, axes=("embed", "mlp")),
            "wv": M.dense_spec(a.d_ff, d, axes=("mlp", "embed")),
        },
    }


def _shift(x: torch.Tensor, x_last: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] shifted one token later, `x_last` [B, d] in front."""
    return torch.cat([x_last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _mix(x, xprev, mu):
    return x + (xprev - x) * mu.to(x.dtype)


def _decay(tm, xw: torch.Tensor) -> torch.Tensor:
    dd = M.dense(torch.tanh(M.dense(xw, tm.wa)), tm.wb)
    return torch.exp(-torch.exp(tm.w0.float() + dd.float()))


def time_mix(tm, a: RWKVArgs, x: torch.Tensor, state: torch.Tensor, x_last: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B, S, d]; state [B, H, dh, dh] fp32; x_last [B, d] (shift carry).
    Returns (out, new_state, new_x_last)."""
    b, s, d = x.shape
    heads = (a.n_heads, a.head_dim)
    xprev = _shift(x, x_last)
    r = M.dense(_mix(x, xprev, tm.mu_r), tm.wr).reshape(b, s, *heads).float()
    k = M.dense(_mix(x, xprev, tm.mu_k), tm.wk).reshape(b, s, *heads).float()
    v = M.dense(_mix(x, xprev, tm.mu_v), tm.wv).reshape(b, s, *heads).float()
    g = M.dense(_mix(x, xprev, tm.mu_g), tm.wg)
    w = _decay(tm, _mix(x, xprev, tm.mu_w)).reshape(b, s, *heads)        # [B, S, H, dh]
    u = tm.u.float().reshape(*heads)[..., None]                          # [H, dh, 1]
    S = state.float()
    outs = []
    with torch.profiler.record_function("rwkv.wkv"):     # the span under torch.profiler
        for t in range(s):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]               # [B, H, dh, dh]
            outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t], S + u * kv))
            S = w[:, t, :, :, None] * S + kv
    out = torch.stack(outs, dim=1).reshape(b, s, d).to(x.dtype)
    out = logical.constrain(out * F.silu(g), "batch", "seq", "q_flat")
    return logical.constrain(M.dense(out, tm.wo), "batch", "seq", "embed"), S, x[:, -1]


def channel_mix(cm, x: torch.Tensor, x_last: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    xprev = _shift(x, x_last)
    r = torch.sigmoid(M.dense(_mix(x, xprev, cm.mu_r), cm.wr))
    k = torch.square(torch.relu(M.dense(_mix(x, xprev, cm.mu_k), cm.wk)))
    return logical.constrain(r * M.dense(k, cm.wv), "batch", "seq", "embed"), x[:, -1]


def init_state(a: RWKVArgs, batch: int, device="cpu") -> Dict[str, torch.Tensor]:
    return {
        "S": torch.zeros((batch, a.n_heads, a.head_dim, a.head_dim), dtype=torch.float32,
                         device=device),
        "x_tm": torch.zeros((batch, a.d_model), dtype=torch.float32, device=device),
        "x_cm": torch.zeros((batch, a.d_model), dtype=torch.float32, device=device),
    }


class RWKV(nn.Module):
    """One full RWKV block (time-mix + channel-mix), pre-norm residuals."""

    def __init__(self, args: RWKVArgs, *, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.args = args
        M.build(self, specs(args), generator, device, dtype)

    def forward(self, x: torch.Tensor, state: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        y, s_new, xtm = time_mix(self.tm, self.args, M.rmsnorm(x, self.ln1),
                                 state["S"], state["x_tm"])
        x = x + y
        y, xcm = channel_mix(self.cm, M.rmsnorm(x, self.ln2), state["x_cm"])
        return x + y, {"S": s_new, "x_tm": xtm, "x_cm": xcm}
