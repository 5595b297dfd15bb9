"""Modality frontend stubs for [vlm] / [audio] architectures.

Port of `repro/models/stubs.py`.  llava-next and musicgen are served as
transformer backbones: the vision tower and the EnCodec tokenizer are
stubs whose output -- patch or frame embeddings in d_model -- arrives as
a model input (`Transformer.forward` / `prefill`'s `frontend_embeds`),
prepended to the token embeddings.  The reference's `frontend_spec` builds
a JAX ShapeDtypeStruct for its dry-run and has no counterpart here until
the dry-run is ported (ROADMAP queue 1 item 11.5).
"""
from __future__ import annotations

from typing import Optional

import torch

# anyres default tile of llava-next (24x24 patches); musicgen: 50 Hz frames
FRONTEND_TOKENS = {"vision": 576, "audio": 250}


def frontend_tokens(kind: Optional[str], override: int = 0) -> int:
    if kind is None:
        return 0
    return override or FRONTEND_TOKENS[kind]


def synth_frontend(generator: torch.Generator, kind: str, batch: int, n_tokens: int,
                   d_model: int, dtype=torch.bfloat16) -> torch.Tensor:
    """Deterministic stand-in embeddings, drawn from `generator` on its
    device (the reference draws from a JAX key, so the values differ)."""
    scale = 0.02 if kind == "vision" else 0.05
    x = torch.randn((batch, n_tokens, d_model), generator=generator,
                    device=generator.device, dtype=torch.float32)
    return (x * scale).to(dtype)
