"""Attention layers: GQA + RoPE, sliding-window locals, KV-cache decode.

Port of `repro/models/attention.py`: `_project_qkv`, `apply` (here
`Attention.forward`), `apply_and_cache`, `_local_decode_attend`,
`_heads_shardable` and `decode_step`, with the reference's logical
sharding constraints (`sharding.logical.constrain`: the identity without
an active mesh or on a plain tensor).  Its head padding
(`REPRO_PAD_HEADS`, off by default) is a sharding lever left out.

Decode with a DTensor cache under an active mesh whose "kv_seq" rule
shards the cache sequence (and divides it) runs the flash-decoding
split-KV scheme, the reference's shard_map, as `split_kv_decode_local` on
each rank's own shards: every shard writes the new token only where it
owns the position, attends its slice from `base = shard_index * T_local`,
and the partials merge by `pmax` of m and `psum` of l e^(m - m_g) and of
o e^(m - m_g) over the kv dims (`runtime.collectives`).  Otherwise the
same local function runs with no kv dim (no collective): on each rank's
shards of a DTensor cache, or on a plain cache as it is.

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
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ops
from repro_torch.models import modules as M
from repro_torch.runtime import collectives
from repro_torch.sharding import logical


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
        "wq": M.dense_spec(a.d_model, a.n_heads * a.d_head, axes=("embed", "q_flat")),
        "wk": M.dense_spec(a.d_model, a.n_kv_heads * a.d_head, axes=("embed", "kv_flat")),
        "wv": M.dense_spec(a.d_model, a.n_kv_heads * a.d_head, axes=("embed", "kv_flat")),
        "wo": M.dense_spec(a.n_heads * a.d_head, a.d_model, axes=("q_flat", "embed")),
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


def _split_heads(t: torch.Tensor, h: int, d: int) -> torch.Tensor:
    """[B, S, h * d] -> [B, S, h, d].  A DTensor whose flat dim is sharded
    over more ranks than divide h is gathered on that dim first (DTensor
    splits a sharded dim only where the shards hold whole heads)."""
    if isinstance(t, DTensor):
        n = 1
        for i, p in enumerate(t.placements):
            if p == Shard(2):
                n *= t.device_mesh.size(i)
        if h % n:
            t = t.redistribute(t.device_mesh, [Replicate() if p == Shard(2) else p
                                               for p in t.placements])
    return t.reshape(*t.shape[:2], h, d)


def _pad_cache(kv: torch.Tensor, max_len: int) -> torch.Tensor:
    s = kv.shape[2]
    if s >= max_len:
        return kv[:, :, :max_len].contiguous()
    if isinstance(kv, DTensor) and Shard(2) not in kv.placements:
        # the sequence is whole on every rank: pad each shard where it is
        # (torch 2.11's DTensor gathers the input of a pad first, and its
        # planner fails on that redistribution)
        shape = (*kv.shape[:2], max_len, kv.shape[3])
        local = torch.nn.functional.pad(kv.to_local(), (0, 0, 0, max_len - s))
        return DTensor.from_local(local, kv.device_mesh, kv.placements, run_check=False,
                                  shape=shape, stride=torch.empty(shape, device="meta").stride())
    return torch.nn.functional.pad(kv, (0, 0, 0, max_len - s))


def _heads_shardable(a: AttnArgs) -> bool:
    ctx = logical.current()
    if ctx is None:
        return True
    return logical.spec_for(("heads",), (a.n_heads,), *ctx)[0] is not None


def _flash_layout(a: AttnArgs, qt, kt, vt):
    """q, k, v [B, H(kv), S, dh] laid out for the flash op under an active
    mesh: q on ("batch", "heads"), and k, v on the same heads where q's
    heads are sharded.  Where the kv heads do not divide over q's shards,
    k and v are first repeated to one kv head per query head (each rank
    then holds whole GQA groups, the layout GSPMD gives the reference).
    The identity on plain tensors or without a mesh."""
    if logical.current() is None or not isinstance(qt, DTensor):
        return qt, kt, vt
    qt = logical.constrain(qt, "batch", "heads", "seq", "head")
    if not _heads_shardable(a):
        return qt, kt, vt
    n = logical.axes_size(logical.current_mesh(), logical.spec_for(("heads",), (a.n_heads,))[0])
    if a.n_kv_heads % n:
        g = a.n_heads // a.n_kv_heads
        kt, vt = kt.repeat_interleave(g, dim=1), vt.repeat_interleave(g, dim=1)
    return (qt, logical.constrain(kt, "batch", "heads", "seq", "head"),
            logical.constrain(vt, "batch", "heads", "seq", "head"))


def split_kv_decode_local(q1, k1, v1, kc, vc, cache_len, window: Optional[int],
                          mesh=None, axes: Tuple[str, ...] = ()):
    """One rank's part of the split-KV decode.  q1 [B, H, dh]; k1, v1 [B,
    Hkv, dh] (the new token's); kc, vc [B, Hkv, Tl, dh] this rank's cache
    slice, shard `axis_index(mesh, axes)` of the kv dims `axes` (none: the
    whole cache); cache_len [B] the global filled length.  Writes the new
    token in place where this shard owns its position and returns (out
    [B, H, dh] fp32, kc, vc)."""
    b, tl = q1.shape[0], kc.shape[2]
    if axes:
        base = collectives.axis_index(mesh, axes) * tl
        local = cache_len.long() - base
        own = ((local >= 0) & (local < tl))[:, None, None]
        pos = local.clamp(0, tl - 1)
    else:                       # the whole cache: a full row is left as it is
        base, own, pos = 0, (cache_len < tl)[:, None, None], cache_len.clamp(max=tl - 1).long()
    rows = torch.arange(b, device=q1.device)
    for c, new in ((kc, k1), (vc, v1)):
        c[rows, :, pos] = torch.where(own, new.to(c.dtype), c[rows, :, pos])
    m, l, o = _local_decode_attend(q1, kc, vc, cache_len + 1, base, window)
    if axes:
        mg = collectives.pmax(m, mesh, axes)
        corr = torch.exp(m - mg)
        l = collectives.psum(l * corr, mesh, axes)
        o = collectives.psum(o * corr[..., None], mesh, axes)
    return o / torch.clamp(l, min=1e-30)[..., None], kc, vc


def _decode_sharded(a: AttnArgs, q1, k1, v1, cache, cache_len):
    """`decode_step`'s attention on a DTensor cache under the active mesh:
    each input laid out as the split-KV scheme takes it, then
    `split_kv_decode_local` on the local shards."""
    mesh, rules = logical.current()
    sizes = logical.mesh_shape(mesh)
    kv = rules.get("kv_seq")
    axes = tuple(ax for ax in ((kv,) if isinstance(kv, str) else tuple(kv or ()))
                 if ax in sizes)
    t_total, b = cache["k"].shape[2], q1.shape[0]
    if logical.axes_size(mesh, axes) <= 1 or t_total % logical.axes_size(mesh, axes):
        axes = ()
    bax = rules.get("batch")
    bax = tuple(ax for ax in ((bax,) if isinstance(bax, str) else tuple(bax or ()))
                if ax in sizes and ax not in axes and b % sizes[ax] == 0)
    bspec = bax if len(bax) > 1 else (bax[0] if bax else None)
    kvspec = None if not axes else (axes if len(axes) > 1 else axes[0])

    def local(x, spec):
        if not isinstance(x, DTensor):
            x = DTensor.from_local(x, mesh, logical.placements((None,) * x.dim(), mesh),
                                   run_check=False)
        return x.redistribute(mesh, logical.placements(spec, mesh)).to_local()

    cache_p = logical.placements((bspec, None, kvspec, None), mesh)
    out, kc, vc = split_kv_decode_local(
        local(q1, (bspec, None, None)), local(k1, (bspec, None, None)),
        local(v1, (bspec, None, None)), local(cache["k"], (bspec, None, kvspec, None)),
        local(cache["v"], (bspec, None, kvspec, None)), local(cache_len, (bspec,)),
        a.window, mesh, axes)
    out = DTensor.from_local(out, mesh, logical.placements((bspec, None, None), mesh),
                             run_check=False)
    return out, {n: DTensor.from_local(c, mesh, cache_p, run_check=False)
                 for n, c in (("k", kc), ("v", vc))}


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
        q = logical.constrain(M.dense(x, self.wq), "batch", "seq", "q_flat")
        k = logical.constrain(M.dense(x, self.wk), "batch", "seq", "kv_flat")
        v = logical.constrain(M.dense(x, self.wv), "batch", "seq", "kv_flat")
        q = _split_heads(q, a.n_heads, a.d_head)
        k = _split_heads(k, a.n_kv_heads, a.d_head)
        v = _split_heads(v, a.n_kv_heads, a.d_head)
        return M.rope(q, positions, a.rope_theta), M.rope(k, positions, a.rope_theta), v

    def _attend(self, x: torch.Tensor, cache: bool
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device)[None, :]
        q, k, v = self._project_qkv(x, positions)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))       # [B, H, S, dh]
        out = ops.flash_attention(*_flash_layout(self.args, qt, kt, vt), True,
                                  self.args.window, None)
        out = out.transpose(1, 2).reshape(b, s, self.args.n_heads * self.args.d_head)
        if not cache:
            out = logical.constrain(out, "batch", "seq", "q_flat")
        return logical.constrain(M.dense(out, self.wo), "batch", "seq", "embed"), kt, vt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Full-sequence causal attention (train / prefill)."""
        return self._attend(x, False)[0]

    def apply_and_cache(self, x: torch.Tensor, max_len: Optional[int] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Prefill: attention output + KV cache [B, Hkv, max_len, dh] (S
        without `max_len`): padded with zeros or cut to max_len before it
        takes its kv_seq layout, so a sharded cache is never padded."""
        y, kt, vt = self._attend(x, True)
        return y, {n: logical.constrain(_pad_cache(t, max_len or t.shape[2]),
                                        "batch", "kv_heads", "kv_seq", "head")
                   for n, t in (("k", kt), ("v", vt))}

    def decode_step(self, x1: torch.Tensor, cache: Dict[str, torch.Tensor],
                    cache_len: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One-token decode.  x1 [B, 1, d]; cache k/v [B, Hkv, T, dh], written
        in place at position cache_len (a row whose cache is full is left
        as it is); cache_len [B] is the filled length before this token.
        A DTensor cache under an active mesh takes the split-KV scheme and
        comes back as new DTensors."""
        a = self.args
        b = x1.shape[0]
        q, k1, v1 = self._project_qkv(x1, cache_len[:, None])
        if logical.current() is not None and isinstance(cache["k"], DTensor):
            out, cache = _decode_sharded(a, q[:, 0], k1[:, 0], v1[:, 0], cache, cache_len)
        else:
            out, _, _ = split_kv_decode_local(q[:, 0], k1[:, 0], v1[:, 0], cache["k"],
                                              cache["v"], cache_len, a.window)
        y = M.dense(out.to(x1.dtype).reshape(b, 1, a.n_heads * a.d_head), self.wo)
        return logical.constrain(y, "batch", "seq", "embed"), cache
