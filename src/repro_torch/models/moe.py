"""Mixture-of-Experts layer: shared + fine-grained routed experts.

Port of the single-device route of `repro/models/moe.py`: `_route` (here
`MoE.route`) and `apply` without a mesh, which runs `_apply_reference`.
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

The reference's expert-parallel `_apply_ep` (shard_map over the model
axis, capacity-bounded) waits for the sharding slice (ROADMAP queue 1
item 11.5).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import modules as M


@dataclasses.dataclass(frozen=True)
class MoEArgs:
    d_model: int
    n_routed: int                 # logical routed experts (pre-padding)
    top_k: int
    d_expert: int                 # per-expert FFN width (fine-grained)
    n_shared: int = 0
    n_padded: int = 0             # physical experts incl. padding (>= routed)
    aux_weight: float = 0.01

    @property
    def e_phys(self) -> int:
        return max(self.n_padded, self.n_routed)


def specs(a: MoEArgs) -> Dict[str, object]:
    e = a.e_phys
    s: Dict[str, object] = {
        "router": M.dense_spec(a.d_model, e, scale=0.02),
        "wg": M.ParamSpec((e, a.d_model, a.d_expert), "normal", 1.0 / (a.d_model ** 0.5)),
        "wu": M.ParamSpec((e, a.d_model, a.d_expert), "normal", 1.0 / (a.d_model ** 0.5)),
        "wd": M.ParamSpec((e, a.d_expert, a.d_model), "normal", 1.0 / (a.d_expert ** 0.5)),
    }
    if a.n_shared:
        s["shared"] = {
            "wg": M.dense_spec(a.d_model, a.n_shared * a.d_expert),
            "wu": M.dense_spec(a.d_model, a.n_shared * a.d_expert),
            "wd": M.dense_spec(a.n_shared * a.d_expert, a.d_model),
        }
    return s


class MoE(nn.Module):
    def __init__(self, args: MoEArgs, *, device, dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.args = args
        M.build(self, specs(args), generator, device, dtype)

    def route(self, xf: torch.Tensor, aux: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
        """xf [T, d] -> (top-k indices [T, k], gates [T, k], aux loss); the
        aux term is None unless `aux` (training's loss uses it, serving
        does not)."""
        a = self.args
        logits = M.dense(xf.float(), self.router)
        if a.e_phys > a.n_routed:                       # mask padded experts
            pad = torch.arange(a.e_phys, device=xf.device) >= a.n_routed
            logits = torch.where(pad[None, :], -1e30, logits)
        gates_full = torch.softmax(logits, dim=-1)
        gates, inds = torch.topk(gates_full, a.top_k, dim=-1)
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
        if not aux:
            return inds, gates.to(xf.dtype), None
        # Switch-style load balance aux: E * sum_e f_e * p_e (counted with
        # index_add_: bincount reads its input's range back to the host)
        flat = inds.reshape(-1)
        f = torch.zeros(a.e_phys, device=xf.device).index_add_(
            0, flat, torch.ones(flat.shape, device=xf.device)) / flat.numel()
        loss = a.aux_weight * a.n_routed * torch.sum(f * gates_full.mean(0))
        return inds, gates.to(xf.dtype), loss

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
        """`dispatch`'s function the reference's way: every expert on every
        token, gathered by route (`_apply_reference`)."""
        h = (F.silu(torch.einsum("td,edf->tef", xf, self.wg.to(xf.dtype)))
             * torch.einsum("td,edf->tef", xf, self.wu.to(xf.dtype)))
        y_all = torch.einsum("tef,efd->ted", h, self.wd.to(xf.dtype))
        sel = torch.take_along_dim(y_all, inds[:, :, None], dim=1)      # [T, k, d]
        return torch.sum(sel * gates[:, :, None], dim=1)

    def forward(self, x: torch.Tensor, aux: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x [B, S, d] -> (y [B, S, d], aux scalar, None unless `aux`).
        Under torch.profiler the layer is the span "moe"."""
        with torch.profiler.record_function("moe"):
            b, s, d = x.shape
            xf = x.reshape(b * s, d)
            inds, gates, aux = self.route(xf, aux)
            y = self.dispatch(xf, inds, gates).reshape(b, s, d)
            if self.args.n_shared:
                sh = self.shared
                y = y + M.swiglu(x, sh.wg, sh.wu, sh.wd)
            return y, aux
