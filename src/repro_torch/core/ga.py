"""Single-objective GA baseline (paper Table I column "GA").

Port of `repro/core/ga.py`: the NSGA-II variation operators (SBX +
polynomial mutation on the real tiers, OX + swap on the permutations), a
plain fitness tournament on the scalarized objective, and elitist
truncation over parents + children.

`step_impl` is a draw step (`_draws`: the two tournaments' index pairs and
the variation draws) followed by the pure `step_body`, so the body can be
held against the reference on the reference's own random numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import genotype as G
from repro_torch.core import nsga2 as N
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem


@dataclasses.dataclass(frozen=True)
class GAConfig:
    pop_size: int = 64
    crossover_prob: float = 0.9
    sbx_eta: float = 15.0
    mut_eta: float = 20.0
    real_mut_prob: float = 0.1
    perm_swaps: int = 2
    perm_swap_prob: float = 0.6
    elite: int = 4
    fused: bool = False


def init_state(problem: Problem, gen: torch.Generator, cfg: GAConfig) -> Dict:
    """A random population of cfg.pop_size on `gen`'s device, evaluated."""
    pop = G.random_genotype(problem, cfg.pop_size, gen)
    return {"pop": pop, "objs": O.evaluate_population(problem, pop, cfg.fused)}


def _draws(gen: torch.Generator, cfg: GAConfig, pop: G.Genotype):
    """(ia1, ib1, ia2, ib2) [P] for the two tournaments, then the draws of
    `nsga2._vary_body` for P children."""
    p = cfg.pop_size
    tour = tuple(torch.randint(0, p, (p,), generator=gen, device=gen.device)
                 for _ in range(4))
    return tour, N._vary_draws(gen, pop, cfg)


def step_body(problem: Problem, cfg: GAConfig, state: Dict, tour, vary) -> Dict:
    """One generation from its draws: tournaments (a tie keeps ia), P
    children, truncation to the P fittest of parents + children."""
    pop, objs = state["pop"], state["objs"]
    fit = O.scalarize(objs)
    ia1, ib1, ia2, ib2 = tour
    pa = torch.where(fit[ia1] <= fit[ib1], ia1, ib1)
    pb = torch.where(fit[ia2] <= fit[ib2], ia2, ib2)

    def take(idx):
        return G.tree_map(lambda a: a[idx], pop)

    children = N._vary_body(take(pa), take(pb), vary, cfg)
    cobjs = O.evaluate_population(problem, children, cfg.fused)

    allpop = G.tree_map(lambda a, b: torch.cat([a, b]), pop, children)
    allobjs = torch.cat([objs, cobjs])
    order = torch.argsort(O.scalarize(allobjs), stable=True)[:cfg.pop_size]
    return {"pop": G.tree_map(lambda a: a[order], allpop), "objs": allobjs[order]}


def step_impl(problem: Problem, cfg: GAConfig, state: Dict,
              gen: torch.Generator) -> Dict:
    return step_body(problem, cfg, state, *_draws(gen, cfg, state["pop"]))
