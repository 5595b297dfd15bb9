"""Architecture registry (--arch <id>), shape registry, reduced variants.

Port of `repro/configs/base.py`.  Each architecture lives in its own
module (`configs/<id>.py`, copied from the reference with only the import
line changed) exporting CONFIG.  The reference's `input_specs`, which builds
JAX ShapeDtypeStructs for its dry-run, has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict

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


def get_arch(name: str) -> ArchConfig:
    if name == "vu_systolic":      # the paper's own design, for EA dry-runs
        raise KeyError("vu_systolic is a placement config; use repro_torch.fpga")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE[name]}")
    return mod.CONFIG


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
