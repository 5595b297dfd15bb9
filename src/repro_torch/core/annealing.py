"""Simulated annealing baseline with the paper's cooling-schedule sweep.

Port of `repro/core/annealing.py`: four cooling schedules (Fig. 8), moves
that perturb one distribution gene, perturb one location gene, or swap two
mapping keys inside one permutation block, and Metropolis acceptance on
the scalarized log(wl^2 x bbox).

The state keeps the reference's shapes: `z` and `best_z` flat [n], the
scalars 0-d, `k` int32.  A step draws its random numbers (`step_draws`) and
hands them to the pure `step_body`; the reference's three-way `lax.switch`
move becomes `_move_body`, which computes all three candidates and picks
one with `torch.where`.  Acceptance and the best-so-far update stay on the
device, so `run_chain` issues its steps without waiting for the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import genotype as G
from repro_torch.core import hyper
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem

SCHEDULES = ("exponential", "linear", "hyperbolic", "adaptive")


@dataclasses.dataclass(frozen=True)
class SAConfig:
    schedule: str = "hyperbolic"
    t0: float = 2.0
    alpha: float = 0.999           # exponential decay
    beta: float = 5e-3             # hyperbolic 1/(1+beta k)
    n_steps: int = 20000           # linear schedule horizon
    move_sigma: float = 0.6
    adapt_target: float = 0.3      # adaptive: target acceptance rate
    fused: bool = False            # route evaluation through ops.fused_eval


def _temperature(cfg: SAConfig, k: torch.Tensor, t_adapt: torch.Tensor
                 ) -> torch.Tensor:
    """Temperature at step k; float fields as `hyper.tracify` gives them."""
    kf = k.to(torch.float32)
    if cfg.schedule == "exponential":
        return cfg.t0 * cfg.alpha ** kf
    if cfg.schedule == "linear":
        return cfg.t0 * torch.clamp(1.0 - kf / cfg.n_steps, min=1e-4)
    if cfg.schedule == "hyperbolic":
        return cfg.t0 / (1.0 + cfg.beta * kf)
    if cfg.schedule == "adaptive":
        return t_adapt
    raise ValueError(cfg.schedule)


def init_state(problem: Problem, gen: torch.Generator, cfg: SAConfig) -> Dict:
    dev = gen.device
    z = torch.randn(problem.continuous_dim, generator=gen, device=dev) * 0.1
    objs = O.evaluate_flat_population(problem, z[None], cfg.fused)[0]
    return {"z": z, "fit": O.scalarize(objs), "objs": objs,
            "k": torch.zeros((), dtype=torch.int32, device=dev),
            "t_adapt": hyper.as_f32(cfg.t0, dev),
            "acc_ema": torch.full((), 0.5, device=dev),
            "best_z": z, "best_objs": objs}


def _perm_block(problem: Problem, t: torch.Tensor):
    """(start, size) of permutation block t in the flat vector, on t's
    device without a copy from the host."""
    sl = G.flat_split(problem)[6:9]
    lo = torch.where(t == 0, sl[0][0], torch.where(t == 1, sl[1][0], sl[2][0]))
    hi = torch.where(t == 0, sl[0][1], torch.where(t == 1, sl[1][1], sl[2][1]))
    return lo, hi - lo


def _move_draws(problem: Problem, gen: torch.Generator) -> Dict:
    """kind in {0, 1, 2}; a gene index in the distribution tier and one in
    the location tier; the noise; the permutation block t and two offsets
    inside it."""
    sl = G.flat_split(problem)
    dev = gen.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (), generator=gen, device=dev)

    kind = randint(0, 3)
    i_dist = randint(sl[0][0], sl[2][1])
    i_loc = randint(sl[3][0], sl[5][1])
    noise = torch.randn((), generator=gen, device=dev)
    t = randint(0, 3)
    _, size = _perm_block(problem, t)
    u = torch.rand(2, generator=gen, device=dev)
    off = torch.minimum((u * size).to(torch.int64), size - 1)
    return dict(kind=kind, i_dist=i_dist, i_loc=i_loc, noise=noise, t=t,
                i=off[0], j=off[1])


def _move_body(problem: Problem, z: torch.Tensor, sigma, kind, i_dist, i_loc,
               noise, t, i, j) -> torch.Tensor:
    """The moved z [n]: kind 0 adds noise * sigma to gene i_dist, kind 1 to
    gene i_loc, kind 2 swaps offsets i and j of permutation block t.

    XLA compiles the reference's perturbation into one fused multiply-add.
    The fp32 product is exact in fp64, so adding it there and rounding once
    to fp32 gives the same gene.  The gene is picked by a position mask, not
    `index_add`, whose vmap rule loops over the batch when the index is
    batched."""
    step = noise.double() * hyper.as_f32(sigma, z.device).double()
    z64 = z.double()
    pos = torch.arange(z.shape[0], device=z.device)
    z_dist = torch.where(pos == i_dist, z64 + step, z64).float()
    z_loc = torch.where(pos == i_loc, z64 + step, z64).float()
    lo, _ = _perm_block(problem, t)
    ii, jj = (lo + i).reshape(1), (lo + j).reshape(1)
    z_swap = z.index_copy(0, ii, z.index_select(0, jj)).index_copy(
        0, jj, z.index_select(0, ii))
    return torch.where(kind == 0, z_dist, torch.where(kind == 1, z_loc, z_swap))


def step_draws(problem: Problem, cfg: SAConfig, state: Dict, gen: torch.Generator):
    """(move, u): the move's draws, then the acceptance uniform u."""
    move = _move_draws(problem, gen)
    return move, torch.rand((), generator=gen, device=gen.device)


def step_body(problem: Problem, cfg: SAConfig, state: Dict, move: Dict,
              u: torch.Tensor) -> Dict:
    """One Metropolis step from its draws."""
    t = _temperature(cfg, state["k"], state["t_adapt"])
    z_new = _move_body(problem, state["z"], cfg.move_sigma, **move)
    objs_new = O.evaluate_flat_population(problem, z_new[None], cfg.fused)[0]
    fit_new = O.scalarize(objs_new)
    delta = fit_new - state["fit"]
    accept = (delta <= 0) | (u < torch.exp(-delta / torch.clamp(t, min=1e-8)))
    z = torch.where(accept, z_new, state["z"])
    fit = torch.where(accept, fit_new, state["fit"])
    objs = torch.where(accept, objs_new, state["objs"])

    acc_ema = 0.99 * state["acc_ema"] + 0.01 * accept.to(torch.float32)
    t_adapt = state["t_adapt"] * torch.where(acc_ema > cfg.adapt_target, 0.999, 1.001)

    better = fit < O.scalarize(state["best_objs"])
    return {"z": z, "fit": fit, "objs": objs, "k": state["k"] + 1,
            "t_adapt": t_adapt, "acc_ema": acc_ema,
            "best_z": torch.where(better, z, state["best_z"]),
            "best_objs": torch.where(better, objs, state["best_objs"])}


def step_impl(problem: Problem, cfg: SAConfig, state: Dict,
              gen: torch.Generator) -> Dict:
    return step_body(problem, cfg, state, *step_draws(problem, cfg, state, gen))



def run_chain(problem: Problem, cfg: SAConfig, gen: torch.Generator,
              n_steps: int, state: Dict) -> Dict:
    """`n_steps` steps from `state`; history[s] is the best objectives
    before step s, kept on the device as in the reference's scan."""
    cfg = hyper.tracify(cfg, gen.device)
    hist = torch.empty(n_steps, 2, device=gen.device)
    for s in range(n_steps):
        hist[s] = state["best_objs"]
        state = step_impl(problem, cfg, state, gen)
    return {"state": state, "history": hist}
