"""PyTorch + CUDA port of the RapidLayout placement system.

`repro_torch` mirrors `repro` module for module; `repro` (JAX/Pallas) stays
the reference every ported piece is tested against.  Entry points run on
the CUDA device unless the caller asks for the CPU, which runs the plain
PyTorch version of every kernel.
"""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` -> torch.device; raises rather than fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
