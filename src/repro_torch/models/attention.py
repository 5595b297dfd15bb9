"""Attention layers: GQA + RoPE, sliding-window locals, KV-cache decode.

Port of the single-device paths of `repro/models/attention.py`:
`_project_qkv`, `apply` (here `Attention.forward`), `apply_and_cache`,
`_local_decode_attend` and `decode_step`'s branch without a mesh.  The
reference's sequence-sharded decode (`shard_map`), its logical sharding
constraints (the identity without a mesh) and its head padding
(`REPRO_PAD_HEADS`, off by default) have no counterpart here.

Full-sequence attention always goes through `ops.flash_attention` with the
layer's window: on the card that is the hand-written kernel.  The
reference's banded XLA route for long sequences under a short window
(`REPRO_BANDED`) computes the same function by another schedule, so the
port needs neither it nor its switch.

Decode writes the new token's K/V into the cache in place (one indexed
store per row) instead of the reference's full-cache `where`; the caches a
caller passes in are updated and returned.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models import modules as M


@dataclasses.dataclass(frozen=True)
class AttnArgs:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    window: Optional[int] = None     # sliding-window size for local layers


def specs(a: AttnArgs) -> Dict[str, M.ParamSpec]:
    return {
        "wq": M.dense_spec(a.d_model, a.n_heads * a.d_head),
        "wk": M.dense_spec(a.d_model, a.n_kv_heads * a.d_head),
        "wv": M.dense_spec(a.d_model, a.n_kv_heads * a.d_head),
        "wo": M.dense_spec(a.n_heads * a.d_head, a.d_model),
    }


def _local_decode_attend(q, kc, vc, cache_len, base: int, window: Optional[int]):
    """Partial (unnormalised) attention of one KV block.

    q [B, H, dh]; kc, vc [B, Hkv, Tl, dh] covering absolute positions
    [base, base + Tl); returns (m, l, o) for log-sum-exp merging.  Query
    heads are grouped per kv head instead of repeating K and V.
    """
    b, h, d = q.shape
    hkv, tl = kc.shape[1], kc.shape[2]
    g = h // hkv
    qg = (q.float() * (1.0 / d ** 0.5)).reshape(b, hkv, g, d)
    logits = torch.einsum("bkgd,bktd->bkgt", qg, kc.float()).reshape(b, h, tl)
    pos = base + torch.arange(tl, device=q.device)[None, :]       # [1, Tl]
    valid = pos < cache_len[:, None]                               # [B, Tl]
    if window is not None:
        valid = valid & (pos > cache_len[:, None] - 1 - window)
    logits = torch.where(valid[:, None, :], logits, -torch.inf)
    m = torch.amax(logits, dim=-1)                                 # [B, H]
    finite = torch.isfinite(m)
    msafe = torch.where(finite, m, 0.0)
    pr = torch.where(torch.isfinite(logits), torch.exp(logits - msafe[..., None]), 0.0)
    l = torch.sum(pr, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", pr.reshape(b, hkv, g, tl),
                     vc.float()).reshape(b, h, d)
    m = torch.where(finite, m, -1e30)
    return m, l, o


class Attention(nn.Module):
    def __init__(self, args: AttnArgs, *, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.args = args
        M.build(self, specs(args), generator, device, dtype)

    def _project_qkv(self, x: torch.Tensor, positions: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """x [B, S, d] -> q [B, S, H, dh], k, v [B, S, Hkv, dh], RoPE applied."""
        a = self.args
        b, s, _ = x.shape
        q = M.dense(x, self.wq).reshape(b, s, a.n_heads, a.d_head)
        k = M.dense(x, self.wk).reshape(b, s, a.n_kv_heads, a.d_head)
        v = M.dense(x, self.wv).reshape(b, s, a.n_kv_heads, a.d_head)
        return M.rope(q, positions, a.rope_theta), M.rope(k, positions, a.rope_theta), v

    def _attend(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = self._project_qkv(x, positions)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))       # [B, H, S, dh]
        out = ops.flash_attention(qt, kt, vt, True, self.args.window, None)
        out = out.transpose(1, 2).reshape(b, s, self.args.n_heads * self.args.d_head)
        return M.dense(out, self.wo), kt, vt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal attention (train / prefill)."""
        return self._attend(x)[0]

    def apply_and_cache(self, x: torch.Tensor
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Prefill: attention output + KV cache [B, Hkv, S, dh]."""
        y, kt, vt = self._attend(x)
        return y, {"k": kt, "v": vt}

    def decode_step(self, x1: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One-token decode.  x1 [B, 1, d]; cache k/v [B, Hkv, T, dh], written
        in place at position cache_len (a row whose cache is full is left
        as it is); cache_len [B] is the filled length before this token."""
        a = self.args
        b = x1.shape[0]
        q, k1, v1 = self._project_qkv(x1, cache_len[:, None])
        t_total = cache["k"].shape[2]
        rows = torch.arange(b, device=x1.device)
        pos = cache_len.clamp(max=t_total - 1).long()
        fits = (cache_len < t_total)[:, None, None]
        for name, new in (("k", k1[:, 0]), ("v", v1[:, 0])):        # [B, Hkv, dh]
            c = cache[name]
            c[rows, :, pos] = torch.where(fits, new.to(c.dtype), c[rows, :, pos])
        m, l, o = _local_decode_attend(q[:, 0], cache["k"], cache["v"],
                                       cache_len + 1, 0, a.window)
        out = (o / torch.clamp(l, min=1e-30)[..., None]).to(x1.dtype)
        return M.dense(out.reshape(b, 1, a.n_heads * a.d_head), self.wo), cache
