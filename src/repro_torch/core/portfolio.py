"""Champion extraction from one algorithm state.

Port of `repro/core/portfolio.py::best_genotype` only: the transfer flow
needs it.  The rest of the module (K configs batched as one run, the race)
is ROADMAP.md queue 1 item 8.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem


def best_genotype(problem: Problem, algo: str, state: Dict,
                  cfg=None) -> Tuple[G.Genotype, torch.Tensor]:
    """The best full genotype (1-D leaves) and its objectives [2].

    Handles population states (`pop`/`objs`), flat-encoding states
    (`best_z`: CMA-ES, SA) and the NSGA-II reduced (mapping-only)
    population, lifted back to the full encoding.  Selection stays on the
    device.
    """
    if "best_z" in state:
        g = G.from_flat(problem, state["best_z"][None])
        return G.tree_map(lambda a: a[0], g), state["best_objs"]
    objs = state["objs"]
    i = torch.argmin(O.combined_metric(objs)).reshape(1)
    g = G.tree_map(lambda a: a.index_select(0, i), state["pop"])
    if cfg is not None and getattr(cfg, "reduced", False):
        g = G.reduced_to_full(problem, g)
    return G.tree_map(lambda a: a[0], g), objs.index_select(0, i)[0]
