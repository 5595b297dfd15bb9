"""Analytical roofline cost model: the autoshard fitness function.

Port of `repro/sharding/costmodel.py`, formula for formula, in numpy.
Instead of tracing every sharding candidate through the dry-run, estimate
the three roofline terms from closed-form byte and FLOP counts:

  compute_s    = step FLOPs / (chips * peak_flops)
  memory_s     = per-device HBM traffic / hbm_bw
                 (params read + activations r/w + KV traffic)
  collective_s = per-device collective bytes / link_bw, summing
                 - DP gradient all-reduce      2 * P_sharded * (n-1)/n
                 - TP activation all-reduces    2 per layer matmul pair
                 - EP combine psums             token bytes per MoE layer
                 - vocab logits reductions      LSE partials

The chip is a `Hardware` argument.  The default, `H100`, is one H100 SXM
from its data sheet at 700 W: 989e12 FLOP/s bf16 dense, 3.35e12 B/s HBM3,
and 450e9 B/s NVLink each way.  Numbers are bf16 (2 bytes).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import SHAPES, ShapeSpec
from repro_torch.models.transformer import ArchConfig

BYTES = 2                    # bf16


@dataclasses.dataclass(frozen=True)
class Hardware:
    peak_flops: float        # FLOP/s per chip at the step's dtype
    hbm_bw: float            # bytes/s per chip
    link_bw: float           # bytes/s per chip-to-chip link, each way


H100 = Hardware(peak_flops=989e12, hbm_bw=3.35e12, link_bw=450e9)


@dataclasses.dataclass(frozen=True)
class MeshShape:
    pod: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model

    def size(self, axes) -> int:
        if axes is None:
            return 1
        if isinstance(axes, str):
            axes = (axes,)
        out = 1
        for a in axes:
            out *= {"pod": self.pod, "data": self.data,
                    "model": self.model}[a]
        return out


@dataclasses.dataclass(frozen=True)
class CostReport:
    compute_s: float
    memory_s: float
    collective_s: float
    bytes_per_device: float
    model_flops: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        # optimistic overlap: max of the three terms (roofline bound)
        return max(self.compute_s, self.memory_s, self.collective_s)


def model_flops_per_step(cfg: ArchConfig, shape: ShapeSpec) -> float:
    """6 * N_active * D for train, 2 * N_active * D for inference."""
    n_active = _active_params(cfg)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch        # decode: one token per sequence
    return 2.0 * n_active * tokens


def _active_params(cfg: ArchConfig) -> float:
    """Per-token active parameters (MoE: top_k + shared only)."""
    total = cfg.param_count()
    if not cfg.moe_every:
        return float(total)
    # replace full expert banks by the activated fraction
    e = max(cfg.n_padded, cfg.n_routed)
    expert_p = 3 * cfg.d_model * cfg.d_expert
    n_moe_layers = cfg.n_layers // cfg.moe_every
    routed_all = n_moe_layers * e * expert_p
    routed_active = n_moe_layers * cfg.top_k * expert_p
    return float(total - routed_all + routed_active)


def _param_bytes(cfg: ArchConfig) -> float:
    return cfg.param_count() * BYTES


def estimate(cfg: ArchConfig, shape_name: str, mesh: MeshShape,
             rules: Optional[Dict[str, object]] = None,
             hw: Hardware = H100) -> CostReport:
    """Three-term roofline estimate for one (arch, shape, mesh, rules) on
    chips of `hw`."""
    shape = SHAPES[shape_name]
    rules = rules or {}
    batch_ax = rules.get("batch", ("pod", "data"))
    model_ax = rules.get("model_dim", "model")    # width sharding axis
    kvseq_ax = rules.get("kv_seq", "model")
    # axis-claim ordering mirrors logical.spec_for: an axis spent on the
    # batch cannot also shard weights (a model that ignores this lets the
    # search claim layouts no mesh can hold)
    def _axes_tuple(ax):
        if ax is None:
            return ()
        return (ax,) if isinstance(ax, str) else tuple(ax)

    claimed = set(_axes_tuple(batch_ax))
    tp_axes = tuple(a for a in _axes_tuple(model_ax) if a not in claimed)
    claimed |= set(tp_axes)
    dp = mesh.size(batch_ax)
    tp = mesh.size(tp_axes) if tp_axes else 1
    # width dims must actually divide; else weights replicate
    if tp > 1 and (cfg.d_ff % tp or (cfg.moe_every and
                                     max(cfg.n_padded, cfg.n_routed) % tp)):
        tp = 1
    chips = mesh.chips

    flops = model_flops_per_step(cfg, shape)
    compute_s = flops / (chips * hw.peak_flops)

    b, s = shape.global_batch, shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers

    # ---- per-device memory traffic
    p_bytes = _param_bytes(cfg) / max(tp, 1)       # weights read once/step
    if shape.kind == "train":
        tok_loc = b * s / max(dp, 1)
        act_rw = 12 * tok_loc * d * BYTES * L / max(tp, 1)  # r+w main tensors
        p_traffic = 3 * p_bytes                     # fwd read, bwd read, upd
    elif shape.kind == "prefill":
        tok_loc = b * s / max(dp, 1)
        act_rw = 6 * tok_loc * d * BYTES * L / max(tp, 1)
        p_traffic = p_bytes
    else:  # decode: KV cache scan dominates
        kv_heads_bytes = (2 * cfg.n_kv_heads * cfg.d_head * BYTES
                          if not cfg.rwkv else 0)
        n_attn = _n_attn_layers(cfg)
        kv_total = b * s * kv_heads_bytes * n_attn
        act_rw = kv_total / (max(dp, 1) * mesh.size(kvseq_ax)) \
            if kv_heads_bytes else 0.0
        # ssm/rwkv state traffic
        if cfg.rwkv or cfg.attn_every:
            n_ssm = L - n_attn
            state = b * (d // 64) * 64 * 64 * 4 if cfg.rwkv \
                else b * 2 * d * cfg.d_state * 4
            act_rw += 2 * state * n_ssm / max(dp, 1)
        p_traffic = p_bytes
    memory_s = (p_traffic + act_rw) / hw.hbm_bw

    # ---- collective bytes per device
    coll = 0.0
    if shape.kind == "train" and dp > 1:
        grad_bytes = _param_bytes(cfg) / max(tp, 1)
        coll += 2.0 * grad_bytes * (dp - 1) / dp          # ring all-reduce
    if tp > 1:
        tok_loc = (b * s if shape.kind != "decode" else b) / max(dp, 1)
        # 2 all-reduces (attn out + mlp out) per layer, activation-sized
        per_layer = 2.0 * tok_loc * d * BYTES * (tp - 1) / tp
        mult = 2.0 if shape.kind == "train" else 1.0      # bwd doubles it
        coll += per_layer * L * mult
        # vocab-sharded logits LSE partials
        if shape.kind == "train":
            coll += 2.0 * tok_loc * 4 * (tp - 1)
    if cfg.moe_every and tp > 1 and shape.kind != "decode":
        tok_loc = b * s / max(dp, 1)
        n_moe = cfg.n_layers // cfg.moe_every
        mult = 2.0 if shape.kind == "train" else 1.0
        coll += tok_loc * d * BYTES * n_moe * mult * (tp - 1) / tp  # EP psum
    if shape.kind == "decode" and mesh.size(kvseq_ax) > 1:
        n_attn = _n_attn_layers(cfg)
        coll += b * cfg.n_heads * (cfg.d_head + 2) * 4 * n_attn \
            * (mesh.size(kvseq_ax) - 1) / mesh.size(kvseq_ax)
    collective_s = coll / hw.link_bw

    # ---- per-device residency (the bbox analogue): params+opt+act+cache
    # fsdp may only spend axes not already claimed by batch/width
    fsdp_axes = tuple(a for a in _axes_tuple(rules.get("fsdp", None))
                      if a not in claimed)
    fsdp = mesh.size(fsdp_axes) if fsdp_axes else 1
    res = _param_bytes(cfg) / max(tp, 1)
    if shape.kind == "train":
        res = res / max(fsdp, 1)
        res += 3 * 4 * cfg.param_count() / (max(tp, 1) * max(fsdp, 1))
        res += 2 * (b * s / max(dp, 1)) * d * BYTES * np.sqrt(L)  # remat live
    elif shape.kind == "decode":
        n_attn = _n_attn_layers(cfg)
        kv = (b * s * 2 * cfg.n_kv_heads * cfg.d_head * BYTES * n_attn
              if not cfg.rwkv else 0)
        res += kv / (max(dp, 1) * mesh.size(kvseq_ax))
    else:
        res += (b * s / max(dp, 1)) * d * BYTES * 4

    return CostReport(compute_s=compute_s, memory_s=memory_s,
                      collective_s=collective_s, bytes_per_device=res,
                      model_flops=flops)


def _n_attn_layers(cfg: ArchConfig) -> int:
    if cfg.rwkv:
        return 0
    if cfg.attn_every:
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers
