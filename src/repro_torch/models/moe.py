"""Mixture-of-Experts layer: shared + fine-grained routed experts.

Port of `repro/models/moe.py`: `_route` (here `route` / `MoE.route`),
`apply` (here `MoE.forward`), `_apply_reference` (here `MoE.dense`),
`_ranks_by_expert` and the expert-parallel `_apply_ep`.
Covers deepseek-moe (2 shared + 64 routed top-6), qwen2-moe (4 shared +
60 routed top-4, padded to 64; padded experts are router-masked) and
jamba's 16-expert top-2 layers.

The layer is split the way the port splits a stochastic operator: `route`
computes the routes (top-k indices, renormalised gates, and the Switch aux
term where training asks for it: serving skips its ~8 ops a layer), and two
bodies take the routes as tensors and compute the same
function as `_apply_reference`:

  * `dispatch` (the model's path) groups the (token, k) pairs by expert
    and runs each expert's SwiGLU on its own tokens only.  It reads the
    groups' bounds back to the host once per call (the layer's one host
    sync), to slice them; there is no capacity and no token is dropped,
    as in the reference's single-device route.
  * `dense` runs every expert on every token and gathers by route, as
    `_apply_reference` does: O(E) work, for the tests and the card's
    check of `dispatch`; the model never calls it.

Under an active mesh (`sharding.logical.activate`) the layer runs
`_apply_ep`, as the reference's does: expert parallelism over the
"experts" rule's mesh dims, each rank holding E / ep experts and every
token of its batch shard, with capacity
`cap = int(capacity_factor * top_k * T_local / E) + 1` per expert.
`apply_ep_local` is one rank's part (the reference's shard_map body): the
(token, k) pairs are ranked within their expert by a stable sort
(`ranks_by_expert`), so the pairs past capacity are the reference's
dropped pairs; y is summed over the EP dims and aux averaged over the
whole mesh (`runtime.collectives`).  ep <= 1 or E % ep != 0 runs `dense`,
the reference's `_apply_reference`, on each rank's tokens with every
expert, and its aux from the statistics of every token (averaged over the
batch dims), as the reference computes it on the whole batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.models import modules as M
from repro_torch.runtime import collectives
from repro_torch.sharding import logical


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    d_model: int
    n_routed: int                 # logical routed experts (pre-padding)
    top_k: int
    d_expert: int                 # per-expert FFN width (fine-grained)
    n_shared: int = 0
    n_padded: int = 0             # physical experts incl. padding (>= routed)
    capacity_factor: float = 1.25
    aux_weight: float = 0.01

    @property
    def e_phys(self) -> int:
        return max(self.n_padded, self.n_routed)


def specs(a: MoEArgs) -> Dict[str, object]:
    e = a.e_phys
    s: Dict[str, object] = {
        "router": M.dense_spec(a.d_model, e, scale=0.02, axes=("embed", None)),
        "wg": M.ParamSpec((e, a.d_model, a.d_expert), "normal", 1.0 / (a.d_model ** 0.5),
                          ("experts", "embed", "expert_mlp")),
        "wu": M.ParamSpec((e, a.d_model, a.d_expert), "normal", 1.0 / (a.d_model ** 0.5),
                          ("experts", "embed", "expert_mlp")),
        "wd": M.ParamSpec((e, a.d_expert, a.d_model), "normal", 1.0 / (a.d_expert ** 0.5),
                          ("experts", "expert_mlp", "embed")),
    }
    if a.n_shared:
        s["shared"] = {
            "wg": M.dense_spec(a.d_model, a.n_shared * a.d_expert, axes=("embed", "mlp")),
            "wu": M.dense_spec(a.d_model, a.n_shared * a.d_expert, axes=("embed", "mlp")),
            "wd": M.dense_spec(a.n_shared * a.d_expert, a.d_model, axes=("mlp", "embed")),
        }
    return s


def _route(a: MoEArgs, router: torch.Tensor, xf: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf [T, d] -> (top-k indices [T, k], renormalised gates [T, k], the
    softmax over every expert [T, E] fp32)."""
    logits = M.dense(xf.float(), router)
    if a.e_phys > a.n_routed:                       # mask padded experts
        pad = torch.arange(a.e_phys, device=xf.device) >= a.n_routed
        logits = torch.where(pad[None, :], -1e30, logits)
    gates_full = torch.softmax(logits, dim=-1)
    gates, inds = torch.topk(gates_full, a.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return inds, gates.to(xf.dtype), gates_full


def switch_stats(a: MoEArgs, inds: torch.Tensor, gates_full: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f, p) [E]: each expert's share of the routed pairs (counted with
    index_add_: bincount reads its input's range back to the host) and
    its mean gate."""
    flat = inds.reshape(-1)
    f = torch.zeros(a.e_phys, device=inds.device).index_add_(
        0, flat, torch.ones(flat.shape, device=inds.device)) / flat.numel()
    return f, gates_full.mean(0)


def switch_aux(a: MoEArgs, f: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Switch-style load balance aux: E * sum_e f_e * p_e, weighted."""
    return a.aux_weight * a.n_routed * torch.sum(f * p)


def route(a: MoEArgs, router: torch.Tensor, xf: torch.Tensor, aux: bool = True
          ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """xf [T, d] -> (top-k indices [T, k], gates [T, k], aux loss); the
    aux term is None unless `aux` (training's loss uses it, serving does
    not)."""
    inds, gates, gates_full = _route(a, router, xf)
    return inds, gates, (switch_aux(a, *switch_stats(a, inds, gates_full)) if aux else None)


def ranks_by_expert(flat_e: torch.Tensor, e: int) -> torch.Tensor:
    """Position of each (token, k) pair within its expert's arrival order."""
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    counts = torch.zeros(e, dtype=torch.int64, device=flat_e.device).index_add_(
        0, flat_e, torch.ones(n, dtype=torch.int64, device=flat_e.device))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n, device=flat_e.device) - starts[flat_e[order]]
    return torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)


def dense(xf, inds, gates, wg, wu, wd) -> torch.Tensor:
    """The routed experts' output the reference's way: every expert on
    every token, gathered by route (`_apply_reference`)."""
    h = (F.silu(torch.einsum("td,edf->tef", xf, wg.to(xf.dtype)))
         * torch.einsum("td,edf->tef", xf, wu.to(xf.dtype)))
    y_all = torch.einsum("tef,efd->ted", h, wd.to(xf.dtype))
    sel = torch.take_along_dim(y_all, inds[:, :, None], dim=1)      # [T, k, d]
    return torch.sum(sel * gates[:, :, None], dim=1)


def expert_ffn(wg, wu, wd, buf: torch.Tensor) -> torch.Tensor:
    """Each expert's SwiGLU on its capacity buffer: buf [e, cap, d]."""
    h = (F.silu(torch.einsum("ecd,edf->ecf", buf, wg.to(buf.dtype)))
         * torch.einsum("ecd,edf->ecf", buf, wu.to(buf.dtype)))
    return torch.einsum("ecf,efd->ecd", h, wd.to(buf.dtype))


def ep_experts(a: MoEArgs, xs, inds, gates, wg, wu, wd, cap: int, e0: int) -> torch.Tensor:
    """The routed experts e0 .. e0 + len(wg) - 1 on the tokens xs [T, d]
    routed by (inds, gates) [T, k], at capacity `cap` per expert: their
    part of y [T, d].  The pairs past capacity, ranked by
    `ranks_by_expert`, are dropped."""
    t, d = xs.shape
    e_loc = wg.shape[0]
    flat_e = inds.reshape(-1)
    ranks = ranks_by_expert(flat_e, a.e_phys)
    mine = (flat_e >= e0) & (flat_e < e0 + e_loc) & (ranks < cap)
    slot = torch.where(mine, (flat_e - e0) * cap + ranks, e_loc * cap)
    tok = torch.arange(t, device=xs.device).repeat_interleave(a.top_k)
    keep = mine[:, None].to(xs.dtype)
    buf = torch.zeros((e_loc * cap + 1, d), dtype=xs.dtype, device=xs.device)
    buf = buf.index_add(0, slot, xs[tok] * keep)
    yb = expert_ffn(wg, wu, wd, buf[:-1].reshape(e_loc, cap, d)).reshape(e_loc * cap, d)
    yb = torch.cat([yb, torch.zeros((1, d), dtype=yb.dtype, device=yb.device)])
    contrib = yb[slot] * (gates.reshape(-1, 1) * keep)
    return contrib.reshape(t, a.top_k, d).sum(1)


def apply_ep_local(a: MoEArgs, xs, router, wg, wu, wd, cap: int, mesh,
                   ep_axes: Tuple[str, ...], batch_axes: Tuple[str, ...], aux: bool = True
                   ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """One rank's expert-parallel MoE (the reference's `_apply_ep` body).
    xs [T_local, d] this rank's tokens, its shard of `batch_axes`; wg, wu,
    wd its E / ep experts, shard `axis_index(mesh, ep_axes)`; returns (the
    routed experts' y [T_local, d] summed over the EP dims, aux averaged
    over every mesh dim, or None).  xs and the gates meet this rank's own
    experts through `pvary`, so their gradients are summed over the EP
    dims; the aux is the same on every shard but of the batch dims."""
    e0 = collectives.axis_index(mesh, ep_axes) * wg.shape[0]
    inds, gates, loss = route(a, router, xs, aux)
    y = ep_experts(a, collectives.pvary(xs, mesh, ep_axes), inds,
                   collectives.pvary(gates, mesh, ep_axes), wg, wu, wd, cap, e0)
    y = collectives.psum(y, mesh, ep_axes)
    if loss is not None:
        names = tuple(mesh.mesh_dim_names)
        loss = collectives.pmean(collectives.pvary(
            loss, mesh, tuple(ax for ax in names if ax not in batch_axes)), mesh, names)
    return y, loss


class MoE(nn.Module):
    def __init__(self, args: MoEArgs, *, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.args = args
        M.build(self, specs(args), generator, device, dtype)

    def route(self, xf: torch.Tensor, aux: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """`route` with this layer's router."""
        return route(self.args, self.router, xf, aux)

    def dispatch(self, xf: torch.Tensor, inds: torch.Tensor, gates: torch.Tensor
                 ) -> torch.Tensor:
        """The routed experts' output [T, d] for routes (inds, gates) [T, k]:
        each expert's SwiGLU on the (token, k) pairs routed to it."""
        t, k = inds.shape
        flat = inds.reshape(-1)
        order = torch.argsort(flat, stable=True)
        experts = torch.arange(self.args.e_phys + 1, device=flat.device)
        bounds = torch.searchsorted(flat[order], experts).tolist()   # the one host read
        rows = xf[order // k]
        outs = [M.swiglu(rows[lo:hi], self.wg[e], self.wu[e], self.wd[e])
                for e, (lo, hi) in enumerate(zip(bounds, bounds[1:])) if hi > lo]
        y = torch.empty_like(rows)
        y[order] = torch.cat(outs) * gates.reshape(-1)[order, None]
        return y.reshape(t, k, -1).sum(1)

    def dense(self, xf: torch.Tensor, inds: torch.Tensor, gates: torch.Tensor
              ) -> torch.Tensor:
        """`dispatch`'s function the reference's way (`dense`)."""
        return dense(xf, inds, gates, self.wg, self.wu, self.wd)

    def _apply_ep(self, x: torch.Tensor, aux: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The routed experts under the active mesh: each rank runs
        `apply_ep_local` on its batch shard of x [B, S, d], flattened to its
        tokens on the rank (a DTensor reshape's backward can meet a
        gradient laid out too oddly to view), and its experts.  The router's
        and the experts' gradients on a rank come from its own tokens, and
        are summed over the batch dims (`Partial`)."""
        a = self.args
        mesh, rules = logical.current()
        sizes = logical.mesh_shape(mesh)
        spec = logical.spec_for(("batch", None, None), x.shape, mesh, rules)
        bax = () if spec[0] is None else ((spec[0],) if isinstance(spec[0], str) else spec[0])
        ep = rules.get("experts") or "model"
        ep_axes = tuple(ax for ax in ((ep,) if isinstance(ep, str) else ep)
                        if ax in sizes and ax not in bax)
        n_ep = logical.axes_size(mesh, ep_axes)

        def local(t, s, summed=()):
            if not isinstance(t, DTensor):
                t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
            t = t.redistribute(mesh, logical.placements(s, mesh))
            return t.to_local(grad_placements=[
                Partial() if ax in summed else p for ax, p in zip(mesh.mesh_dim_names, t.placements)])

        x3 = local(x, spec)
        xs, router = x3.reshape(-1, x3.shape[-1]), local(self.router, (None, None), bax)
        if n_ep <= 1 or a.e_phys % n_ep:      # every expert on every rank
            w = [local(t, (None, None, None), bax) for t in (self.wg, self.wu, self.wd)]
            inds, gates, gates_full = _route(a, router, xs)
            y, loss = dense(xs, inds, gates, *w), None
            if aux:   # the reference's `_apply_reference`: the aux of every token
                f, p = switch_stats(a, inds, gates_full)
                loss = switch_aux(a, collectives.pmean(f, mesh, bax),
                                  collectives.pmean(p, mesh, bax))
        else:
            wspec = (ep_axes if len(ep_axes) > 1 else ep_axes[0], None, None)
            cap = int(a.capacity_factor * a.top_k * xs.shape[0] / a.e_phys) + 1
            y, loss = apply_ep_local(a, xs, router, *(local(t, wspec, bax) for t in (
                self.wg, self.wu, self.wd)), cap, mesh, ep_axes, bax, aux)
        y = DTensor.from_local(y.reshape(x3.shape), mesh, logical.placements(spec, mesh),
                               run_check=False)
        if loss is not None:
            loss = DTensor.from_local(loss, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return y, loss

    def forward(self, x: torch.Tensor, aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x [B, S, d] -> (y [B, S, d], aux scalar, None unless `aux`).
        Under an active mesh the routed experts run `_apply_ep`.  Under
        torch.profiler the layer is the span "moe"."""
        with torch.profiler.record_function("moe"):
            b, s, d = x.shape
            if logical.current() is not None:
                y, aux = self._apply_ep(x, aux)
            else:
                xf = x.reshape(b * s, d)
                inds, gates, aux = self.route(xf, aux)
                y = self.dispatch(xf, inds, gates).reshape(b, s, d)
            if self.args.n_shared:
                sh = self.shared
                y = y + M.swiglu(x, sh.wg, sh.wu, sh.wd)
            return logical.constrain(y, "batch", "seq", "embed"), aux
