"""Modality frontend stubs for [vlm] / [audio] architectures.

Port of `repro/models/stubs.py`.  llava-next and musicgen are served as
transformer backbones: the vision tower and the EnCodec tokenizer are
stubs whose output -- patch or frame embeddings in d_model -- arrives as
a model input (`Transformer.forward` / `prefill`'s `frontend_embeds`),
prepended to the token embeddings.  `frontend_spec` is the dry-run's
storage-free stand-in for that input (`configs.base.input_specs`).
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


def frontend_spec(kind: Optional[str], batch: int, n_tokens: int, d_model: int,
                  device="meta") -> Optional[torch.Tensor]:
    """A bf16 [batch, n_tokens, d_model] tensor without storage (device
    "meta", or that of the caller's fake-tensor mode); None without a
    frontend."""
    if kind is None:
        return None
    return torch.empty((batch, n_tokens, d_model), dtype=torch.bfloat16, device=device)
