"""Mamba (S6) selective-state-space block for the jamba hybrid.

Port of `repro/models/mamba.py`: `_causal_conv`, `_ssm_params`, `apply`
(here `Mamba.forward`), `init_cache` and `decode_step`, and the prefill's
decode cache, `_mamba_tail_state` of `repro/models/transformer.py`.  The
recurrence

    h_t = a_t * h_{t-1} + b_t,   a_t = exp(dt_t * A),  b_t = dt_t * B_t * u_t

runs chunk by chunk over the sequence, as in the reference; inside a
chunk a doubling (Hillis-Steele) scan composes the steps in log2(chunk)
passes, where the reference runs `lax.associative_scan`.  Products of the
decays stay in linear space: exp(-cumsum(dt * A)) would overflow over a
256-token chunk.  The prefill takes its decode cache from this scan (the
last state) rather than scanning a second time, as the reference does.

The reference asserts that a sequence longer than a chunk is a multiple
of it (`mamba.py:89`); the port raises ValueError on the same lengths.
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
class MambaArgs:
    d_model: int
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def rank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)


def specs(a: MambaArgs) -> Dict[str, M.ParamSpec]:
    di = a.d_inner
    return {
        "in_proj": M.dense_spec(a.d_model, 2 * di, axes=("embed", "ssm_inner")),
        "conv_w": M.ParamSpec((a.d_conv, di), "normal", 0.5, (None, "ssm_inner")),
        "conv_b": M.ParamSpec((di,), "zeros", axes=("ssm_inner",)),
        "x_proj": M.dense_spec(di, a.rank + 2 * a.d_state, axes=("ssm_inner", None)),
        "dt_proj": M.dense_spec(a.rank, di, axes=(None, "ssm_inner")),
        "dt_bias": M.ParamSpec((di,), "const", 0.1, ("ssm_inner",)),
        "a_log": M.ParamSpec((di, a.d_state), "const", 0.0, ("ssm_inner", "ssm_state")),
        "d_skip": M.ParamSpec((di,), "ones", axes=("ssm_inner",)),
        "out_proj": M.dense_spec(di, a.d_model, axes=("ssm_inner", "embed")),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along seq.  u [B, S, di]; w [K, di]."""
    k, s = w.shape[0], u.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = sum(up[:, i:i + s, :] * w[i] for i in range(k))
    return out + b


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the steps h -> a_t * h + b_t: returns
    (prod_{s<=t} a_s, the state at t from h = 0), by doubling."""
    n, shift = a.shape[1], 1
    while shift < n:
        b = torch.cat([b[:, :shift], a[:, shift:] * b[:, :-shift] + b[:, shift:]], 1)
        a = torch.cat([a[:, :shift], a[:, shift:] * a[:, :-shift]], 1)
        shift *= 2
    return a, b


def init_cache(a: MambaArgs, batch: int, dtype=torch.float32, device="cpu"
               ) -> Dict[str, torch.Tensor]:
    return {
        "conv": torch.zeros((batch, a.d_conv - 1, a.d_inner), dtype=dtype, device=device),
        "h": torch.zeros((batch, a.d_inner, a.d_state), dtype=torch.float32, device=device),
    }


class Mamba(nn.Module):
    def __init__(self, args: MambaArgs, *, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.args = args
        M.build(self, specs(args), generator, device, dtype)

    def _ssm_params(self, u: torch.Tensor):
        """u [..., di] -> (dt [..., di], Bc [..., ds], Cc [..., ds])."""
        a = self.args
        z = M.dense(u, self.x_proj)
        dt, bc, cc = torch.split(z, [a.rank, a.d_state, a.d_state], dim=-1)
        dt = F.softplus(M.dense(dt, self.dt_proj) + self.dt_bias.to(u.dtype))
        return dt, bc, cc

    def apply_and_cache(self, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full-sequence pass x [B, S, d] -> (y [B, S, d], the decode cache
        after the last token: the conv window's tail and the SSM state)."""
        a = self.args
        s = x.shape[1]
        ch = min(a.chunk, s)
        if s % ch:
            raise ValueError(f"mamba: a sequence of {s} tokens is not a multiple of "
                             f"the {ch}-token chunk")
        u_raw, gate = torch.chunk(M.dense(x, self.in_proj), 2, dim=-1)   # [B, S, di]
        u = F.silu(_causal_conv(u_raw, self.conv_w, self.conv_b))
        u = logical.constrain(u, "batch", "seq", "ssm_inner")
        a_mat = -torch.exp(self.a_log.float())                            # [di, ds]
        h = torch.zeros((x.shape[0], a.d_inner, a.d_state), dtype=torch.float32,
                        device=x.device)
        ys = []
        with torch.profiler.record_function("mamba.scan"):  # the span under torch.profiler
            for c0 in range(0, s, ch):
                u_ch = u[:, c0:c0 + ch]
                dt, bc, cc = self._ssm_params(u_ch)
                dtf = dt.float()
                ea = torch.exp(dtf[..., None] * a_mat)                    # [B, ch, di, ds]
                bu = (dtf * u_ch.float())[..., None] * bc.float()[..., None, :]
                ea_s, bu_s = _linear_scan(ea, bu)
                hs = ea_s * h[:, None] + bu_s
                y = torch.einsum("bcds,bcs->bcd", hs, cc.float())
                ys.append((y + self.d_skip.float() * u_ch.float()).to(x.dtype))
                h = hs[:, -1]
        y = torch.cat(ys, 1) * F.silu(gate)
        cache = {"conv": u_raw[:, -(a.d_conv - 1):], "h": h}
        return logical.constrain(M.dense(y, self.out_proj), "batch", "seq", "embed"), cache

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply_and_cache(x)[0]

    def decode_step(self, x1: torch.Tensor, cache: Dict[str, torch.Tensor]
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """O(1) decode.  x1 [B, 1, d]."""
        u, gate = torch.chunk(M.dense(x1[:, 0], self.in_proj), 2, dim=-1)   # [B, di]
        win = torch.cat([cache["conv"], u[:, None]], dim=1)                  # [B, K, di]
        conv = torch.einsum("bkd,kd->bd", win, self.conv_w.to(u.dtype)) + self.conv_b.to(u.dtype)
        u = F.silu(conv)
        dt, bc, cc = self._ssm_params(u)
        a_mat = -torch.exp(self.a_log.float())
        ea = torch.exp(dt.float()[..., None] * a_mat)
        bu = (dt * u)[..., None].float() * bc.float()[:, None, :]
        h = ea * cache["h"] + bu
        y = torch.einsum("bds,bs->bd", h, cc.float()) + self.d_skip.float() * u.float()
        y = y.to(x1.dtype) * F.silu(gate)
        return M.dense(y, self.out_proj)[:, None, :], {"conv": win[:, 1:], "h": h}
