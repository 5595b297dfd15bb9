"""Architecture registry (--arch <id>), shape registry, reduced variants,
input specs.

Port of `repro/configs/base.py`.  Each architecture lives in its own
module (`configs/<id>.py`, copied from the reference with only the import
line changed) exporting CONFIG.  `input_specs` gives the model inputs of
an (arch, shape) cell as tensors without storage (device "meta", or the
device of the caller's fake-tensor mode): the dry-run's stand-ins for the
reference's ShapeDtypeStructs.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Optional

import torch

from repro_torch.models import stubs
from repro_torch.models.transformer import ArchConfig

ARCHS = (
    "deepseek-moe-16b", "qwen2-moe-a2.7b", "gemma3-12b", "yi-6b",
    "mistral-large-123b", "granite-8b", "llava-next-34b", "jamba-v0.1-52b",
    "musicgen-large", "rwkv6-1.6b",
)

_MODULE = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def list_archs():
    return ARCHS


def get_arch(name: str) -> ArchConfig:
    if name == "vu_systolic":      # the paper's own design, for EA dry-runs
        raise KeyError("vu_systolic is a placement config; use repro_torch.fpga")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE[name]}")
    return mod.CONFIG


def shape_applicable(cfg: ArchConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic attention (the reference's skip table)."""
    if shape == "long_500k":
        return cfg.subquadratic
    return True


def get_reduced(name: str) -> ArchConfig:
    """Family-preserving smoke-test config: tiny widths/depths, same block
    pattern, same MoE/hybrid/ssm structure."""
    c = get_arch(name)
    period = c.period
    n_heads = min(c.n_heads, 4)
    kv = max(1, min(c.n_kv_heads, n_heads))
    while n_heads % kv:
        kv -= 1
    return dataclasses.replace(
        c,
        n_layers=2 * period,
        d_model=64,
        n_heads=n_heads,
        n_kv_heads=kv,
        d_head=16,
        d_ff=128,
        vocab=512,
        window=min(c.window, 32) if c.window else None,
        n_routed=min(c.n_routed, 8) if c.n_routed else 0,
        n_padded=min(c.n_padded, 8) if c.n_padded else 0,
        top_k=min(c.top_k, 2) if c.top_k else 0,
        n_shared=min(c.n_shared, 1) if c.n_shared else 0,
        d_expert=32 if c.d_expert else 0,
        n_frontend_tokens=8 if c.frontend else 0,
    )


def input_specs(cfg: ArchConfig, shape: str, max_cache: Optional[int] = None,
                device="meta") -> Dict[str, Any]:
    """Storage-free int32 stand-ins for every model input of (arch, shape).

    train:   {tokens, targets [, frontend_embeds]}
    prefill: {tokens [, frontend_embeds]}
    decode:  {token, cache_len}  (the caches are built by the dry-run)
    """
    ss = SHAPES[shape]
    b, s = ss.global_batch, ss.seq_len

    def i32(*dims):
        return torch.empty(dims, dtype=torch.int32, device=device)

    if ss.kind in ("train", "prefill"):
        out = {"tokens": i32(b, s)}
        if ss.kind == "train":
            out["targets"] = i32(b, s)
        fe = stubs.frontend_spec(cfg.frontend, b, cfg.n_frontend_tokens, cfg.d_model, device)
        if fe is not None:
            out["frontend_embeds"] = fe
        return out
    if ss.kind == "decode":
        return {"token": i32(b), "cache_len": i32(b)}
    raise ValueError(ss.kind)
