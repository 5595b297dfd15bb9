"""Hyperparameter portfolio: K placement runs advanced as one batched program.

Port of `repro/core/portfolio.py`.  The reference vmaps K (config, seed)
runs of `evolve.run` into one jitted program.  Here each generation of all
K members is one `torch.func.vmap` of the algorithm's pure `step_body` over
the stacked states, the members' draws and their stacked float
hyperparameters (`core.hyper`), so every kernel launches once per
generation whatever K is (the kernels' custom ops fold the member axis
into their rows).  The draws are made per member, from its own
`torch.Generator`, before the batched body: a member computes exactly what
`evolve.run(problem, algo, cfgs[i], gens[i], n_gens)` computes alone (on
the CPU bit for bit; on the card a batched reduction may round otherwise).

Two entry points:

  * `run_portfolio` -- fixed budget: all K members run `n_gens`
    generations; the history [K, n_gens, 2] stays on the device.
  * `race`          -- early champion selection: members advance in rounds
    of `gens_per_round` generations; after each round the host reads the
    champion's combined metric once and stops once it stalls for
    `patience` rounds.

Static config fields (pop_size, perm_swaps, reduced, schedule, fused) must
agree across members: they fix shapes and branches.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import evolve, hyper
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem


def stack(trees: Sequence) -> Dict:
    """Trees of tensors of one structure -> one tree with a leading axis."""
    return G.tree_map(lambda *xs: torch.stack(xs), *trees)


def member(tree, i: int):
    """Row `i` of every leaf of a stacked tree (views, no device op)."""
    return G.tree_map(lambda a: a[i], tree)


def member_generators(k: int, gens: Optional[Sequence[torch.Generator]],
                      gen: Optional[torch.Generator], device: torch.device
                      ) -> List[torch.Generator]:
    """The K members' generators: `gens` as given, or K generators seeded
    from K draws of `gen` (the counterpart of `jax.random.split(key, K)`)."""
    if gens is None:
        if gen is None:
            raise ValueError("pass gens= (one generator per member) or gen=")
        seeds = torch.randint(0, 2 ** 62, (k,), generator=gen, device=gen.device)
        gens = [torch.Generator(device=device).manual_seed(s) for s in seeds.tolist()]
    if len(gens) != k:
        raise ValueError(f"{len(gens)} generators for {k} members")
    for g in gens:
        if g.device.type != device.type:
            raise ValueError(f"generator is on {g.device}, run on {device}")
    return list(gens)


# --------------------------------------------------------- member programs

def member_draws(problem: Problem, algo: str, cfgs: Sequence, states: Dict,
                 gens: Sequence[torch.Generator]):
    """One generation's draws of B stacked members: member i draws from
    `gens[i]` with its config `cfgs[i]`; the draws are stacked [B, ...]."""
    m = evolve.get_algo(algo)
    return stack([m.step_draws(problem, c, member(states, i), g)
                  for i, (c, g) in enumerate(zip(cfgs, gens))])


def batched_body(problem: Problem, algo: str, static_key: hyper.StaticKey):
    """`step_body` vmapped over (float fields [B], states [B, ...], draws
    [B, ...]); each member's config is merged inside, as the reference's
    lambda does.  Randomness inside is an error (vmap's default)."""
    m = evolve.get_algo(algo)

    def body(tr, st, dr):
        return m.step_body(problem, hyper.merge_config(static_key, tr), st, *dr)

    return torch.func.vmap(body)


def batched_step(problem: Problem, algo: str, static_key: hyper.StaticKey,
                 traced: Dict[str, torch.Tensor], cfgs: Sequence, states: Dict,
                 gens: Sequence[torch.Generator]) -> Dict:
    """One generation of B stacked members: `member_draws`, then one
    `batched_body` (`traced` holds the float fields stacked [B])."""
    draws = member_draws(problem, algo, cfgs, states, gens)
    return batched_body(problem, algo, static_key)(traced, states, draws)


def best_objs(states: Dict) -> torch.Tensor:
    """Stacked states -> each member's best (wl^2, bbox) [B, 2]."""
    return torch.func.vmap(evolve.state_best_objs)(states)


def advance(problem: Problem, algo: str, static_key: hyper.StaticKey,
            traced: Dict[str, torch.Tensor], states: Dict,
            gens: Sequence[torch.Generator], n_gens: int) -> Tuple[Dict, torch.Tensor]:
    """`n_gens` batched generations; returns (states, history [B, n_gens,
    2] of each member's best after each generation, on the device)."""
    cfgs = [hyper.unstack_config(static_key, traced, i) for i in range(len(gens))]
    dev = next(iter(traced.values())).device
    hist = torch.empty(len(gens), n_gens, 2, device=dev)
    for g in range(n_gens):
        states = batched_step(problem, algo, static_key, traced, cfgs, states, gens)
        hist[:, g] = best_objs(states)
    return states, hist


def member_init(problem: Problem, algo: str, static_key: hyper.StaticKey,
                traced: Dict[str, torch.Tensor],
                gens: Sequence[torch.Generator]) -> Dict:
    """Stacked initial states of the members (`traced` stacked [K]), each
    drawn from its own generator."""
    m = evolve.get_algo(algo)
    return stack([m.init_state(problem, g, hyper.unstack_config(static_key, traced, i))
                  for i, g in enumerate(gens)])


def member_round(problem: Problem, algo: str, static_key: hyper.StaticKey,
                 n_gens: int, traced: Dict[str, torch.Tensor], states: Dict,
                 gens: Sequence[torch.Generator]) -> Tuple[Dict, torch.Tensor]:
    """Advance the stacked members `n_gens` generations; returns (states,
    each member's best objectives [K, 2])."""
    states, _ = advance(problem, algo, static_key, traced, states, gens, n_gens)
    return states, best_objs(states)


# ------------------------------------------------------------- fixed budget

@dataclasses.dataclass
class PortfolioResult:
    states: Dict                 # stacked member states (leading K axis)
    history: torch.Tensor        # [K, n_gens, 2] per-generation best objectives
    best_objs: torch.Tensor      # [K, 2] final best per member
    metric: torch.Tensor         # [K] combined metric per member
    champion: int                # argmin(metric)

    def member_state(self, i: int) -> Dict:
        return member(self.states, i)

    @property
    def champion_objs(self) -> torch.Tensor:
        return self.best_objs[self.champion]


def run_portfolio(problem: Problem, algo: str, cfgs: Sequence,
                  gens: Optional[Sequence[torch.Generator]] = None,
                  gen: Optional[torch.Generator] = None, n_gens: int = 50,
                  device="cuda") -> PortfolioResult:
    """Run K = len(cfgs) (config, generator) members as one batched program.

    `gens` gives each member its generator; with only `gen`, K member seeds
    are drawn from it once.  Member i matches `evolve.run(problem, algo,
    cfgs[i], gens[i], n_gens, device=device)`.
    """
    dev = resolve_device(device)
    static_key, traced = hyper.stack_configs(cfgs, dev)
    gens = member_generators(len(cfgs), gens, gen, dev)
    states = member_init(problem, algo, static_key, traced, gens)
    states, hist = advance(problem, algo, static_key, traced, states, gens, n_gens)
    best = best_objs(states)
    metric = O.combined_metric(best)
    return PortfolioResult(states=states, history=hist, best_objs=best, metric=metric,
                           champion=int(torch.argmin(metric)))


# ------------------------------------------------------------------ racing

@dataclasses.dataclass
class RaceResult:
    states: Dict                 # stacked member states at stop time
    history: torch.Tensor        # [rounds, K, 2] best objs after each round
    best_objs: torch.Tensor      # [K, 2]
    metric: torch.Tensor         # [K]
    champion: int
    rounds: int                  # rounds actually run (<= max budget)
    gens: int                    # generations per member actually run

    def member_state(self, i: int) -> Dict:
        return member(self.states, i)

    @property
    def champion_objs(self) -> torch.Tensor:
        return self.best_objs[self.champion]


def race(problem: Problem, algo: str, cfgs: Sequence,
         gen: Optional[torch.Generator] = None, max_gens: int = 200,
         gens_per_round: int = 10, patience: int = 2, rtol: float = 1e-3,
         gens: Optional[Sequence[torch.Generator]] = None,
         device="cuda") -> RaceResult:
    """Portfolio racing with early champion selection.

    All members advance together in rounds of `gens_per_round` batched
    generations; the budget quantizes up to whole rounds (15 generations in
    rounds of 10 run 20).  After each round the champion's combined metric
    is read on the host, and the race stops once it fails to improve by a
    relative `rtol` for `patience` consecutive rounds.  The members draw
    from their generators as in `run_portfolio`, so a race's states after r
    rounds are `run_portfolio`'s after r * gens_per_round generations.
    """
    if max_gens < 1:
        raise ValueError(f"max_gens must be >= 1, got {max_gens}")
    dev = resolve_device(device)
    static_key, traced = hyper.stack_configs(cfgs, dev)
    gens = member_generators(len(cfgs), gens, gen, dev)
    states = member_init(problem, algo, static_key, traced, gens)
    gens_per_round = min(gens_per_round, max_gens)
    n_rounds = -(-max_gens // gens_per_round)
    best_metric, stall, rounds = math.inf, 0, 0
    hist: List[torch.Tensor] = []
    for r in range(n_rounds):
        states, best = member_round(problem, algo, static_key, gens_per_round,
                                    traced, states, gens)
        rounds = r + 1
        hist.append(best)
        m = float(O.combined_metric(best).min())
        if m < best_metric * (1.0 - rtol):
            best_metric, stall = m, 0
        else:
            stall += 1
            if stall >= patience:
                break
    metric = O.combined_metric(best)
    return RaceResult(states=states, history=torch.stack(hist), best_objs=best,
                      metric=metric, champion=int(torch.argmin(metric)),
                      rounds=rounds, gens=rounds * gens_per_round)


# --------------------------------------------------------------- champions

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
