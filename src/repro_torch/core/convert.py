"""Carry genotypes, algorithm states and LM weights between the reference
and the port.

A population state (NSGA-II, GA) is `{"pop": {"dist"|"loc"|"perm": (URAM,
DSP, BRAM)}, "objs"}` (a reduced population is a tuple of three
permutations), each leaf with a leading population axis.  The port's
layout is the same, as torch tensors, with int64 permutations; the numpy
side uses the reference's dtypes (float32, int32 permutations).  A point
state (CMA-ES, SA) is a flat dict of float32 arrays and 0-d scalars with
int32 counters (`gen`, `k`), kept as such on both sides.

The reference's LM parameters are a tree `{"embed", "ln_f", "head",
"blocks": [per pattern position {"ln1", "attn" | "mamba", "ln2", "mlp" |
"moe" (with "shared")} or {"rwkv": {"ln1", "ln2", "tm", "cm"}}]}` whose
block leaves are stacked over periods; the port's `Transformer` holds one
block per layer, layer `l` being position `l % period` of period
`l // period`, and names each weight by its path in that tree.  Both keep
dense weights [d_in, d_out] and expert weights [E, d_in, d_out].
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.genotype import tree_map


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = torch.int64 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.tensor(a, dtype=dtype, device=device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.astype(np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32)


def genotype_from_numpy(g, device="cpu"):
    """Full genotype dict or reduced permutation tuple -> port tensors."""
    return tree_map(lambda a: _leaf_to_torch(a, device), g)


def genotype_to_numpy(g):
    """Port genotype (full or reduced) -> numpy in the reference's dtypes."""
    return tree_map(_leaf_to_numpy, g)


def _point_leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = torch.int32 if np.issubdtype(a.dtype, np.integer) else torch.float32
    return torch.tensor(a, dtype=dtype, device=device)


def state_from_numpy(state: Dict, device="cpu") -> Dict:
    if "pop" not in state:
        return {k: _point_leaf_to_torch(v, device) for k, v in state.items()}
    return {"pop": genotype_from_numpy(state["pop"], device),
            "objs": _leaf_to_torch(state["objs"], device)}


def state_to_numpy(state: Dict) -> Dict:
    if "pop" not in state:
        return {k: _leaf_to_numpy(v) for k, v in state.items()}
    return {"pop": genotype_to_numpy(state["pop"]),
            "objs": _leaf_to_numpy(state["objs"])}


def lm_params_from_numpy(cfg, params: Dict[str, Any], device="cpu",
                         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The reference's `init_params` tree, as numpy, -> the state dict of the
    port's `Transformer(cfg)`."""
    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device).to(dtype)

    def leaves(tree, prefix):
        for name, a in tree.items():
            if isinstance(a, dict):
                yield from leaves(a, f"{prefix}{name}.")
            else:
                yield f"{prefix}{name}", a

    state = {name: t(params[name]) for name in ("embed", "ln_f", "head")}
    for layer in range(cfg.n_layers):
        block = params["blocks"][layer % cfg.period]
        for key, a in leaves(block, f"blocks.{layer}."):
            state[key] = t(np.asarray(a)[layer // cfg.period])
    return state
