"""Dense SwiGLU MLP (the llama-family FFN of every dense arch).

Port of `repro/models/mlp.py`; weights in the reference's [d_in, d_out]
layout.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.models import modules as M
from repro_torch.sharding import logical


def specs(d_model: int, d_ff: int) -> Dict[str, M.ParamSpec]:
    return {
        "wg": M.dense_spec(d_model, d_ff, axes=("embed", "mlp")),
        "wu": M.dense_spec(d_model, d_ff, axes=("embed", "mlp")),
        "wd": M.dense_spec(d_ff, d_model, axes=("mlp", "embed")),
    }


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, device,
                 dtype=torch.float32, generator: Optional[torch.Generator] = None):
        super().__init__()
        M.build(self, specs(d_model, d_ff), generator, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return logical.constrain(M.swiglu(x, self.wg, self.wu, self.wd),
                                 "batch", "seq", "embed")
