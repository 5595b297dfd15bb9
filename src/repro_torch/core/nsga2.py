"""NSGA-II for hard-block placement on population-batched tensors.

Port of `repro/core/nsga2.py`: fast non-dominated sorting from the P x P
domination matrix (CUDA kernel on the card), crowding distance with exact
per-front ranges, crowded binary tournament, SBX + polynomial mutation on
the real tiers, order crossover + swap mutation on the permutations, and
the SS IV-B2 reduced genotype.

Each stochastic operator is a draw step on an explicit `torch.Generator`
followed by a pure body that takes the draws as tensors (`*_body`), so the
bodies can be held against the reference on the same random numbers.  No
function here syncs with the host: a generation is a fixed sequence of
device operations.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem
from repro_torch.kernels import ops

INF = 1e9


@dataclasses.dataclass(frozen=True)
class NSGA2Config:
    pop_size: int = 64
    crossover_prob: float = 0.9
    sbx_eta: float = 15.0
    mut_eta: float = 20.0
    real_mut_prob: float = 0.1     # per-gene polynomial mutation prob
    perm_swaps: int = 2            # swap mutations per child permutation
    perm_swap_prob: float = 0.6
    reduced: bool = False          # SS IV-B2 mapping-only genotype
    fused: bool = False            # route evaluation through ops.fused_eval


# ------------------------------------------------- non-dominated sorting

def nondominated_rank(objs: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """[P, M] objectives -> [P] int64 Pareto front index (0 = best).

    `fused=True` takes the matrix and its column counts from one kernel
    launch.  The peeling runs a fixed P rounds of device operations (the
    reference's fori_loop) rather than stopping early, which would need a
    host sync per round.
    """
    p = objs.shape[0]
    if fused:
        dom_b, ndom = ops.fused_domination_counts(objs)
    else:
        dom_b = ops.domination_matrix(objs)
        ndom = torch.sum(dom_b, dim=0, dtype=torch.int32)
    dom = dom_b.to(torch.int32)                        # dom[i, j]: i beats j
    rank = torch.full((p,), p, dtype=torch.int64, device=objs.device)
    nd = ndom
    for r in range(p):
        front = (nd == 0) & (rank == p)
        rank = torch.where(front, r, rank)
        release = torch.sum(dom * front[:, None], dim=0, dtype=torch.int32)
        nd = torch.where(front, -1, nd - release)
    return rank


def crowding_distance(objs: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """Crowding distance within each front (boundaries get INF)."""
    p, m = objs.shape
    dev = objs.device
    crowd = torch.zeros(p, device=dev)
    no = torch.zeros(1, dtype=torch.bool, device=dev)
    for mm in range(m):
        f = objs[:, mm].float()
        # exact per-front ranges via scatter-max/min into rank buckets
        fmax = torch.full((p,), -torch.inf, device=dev).scatter_reduce(
            0, rank, f, "amax", include_self=True)[rank]
        fmin = torch.full((p,), torch.inf, device=dev).scatter_reduce(
            0, rank, f, "amin", include_self=True)[rank]
        rng = torch.clamp(fmax - fmin, min=1e-12)
        # exact lexicographic (rank, f) sort: two stable argsorts
        o1 = torch.argsort(f, stable=True)
        order = o1[torch.argsort(rank[o1], stable=True)]
        fs, rs = f[order], rank[order]
        prev = torch.cat([fs[:1], fs[:-1]])
        nxt = torch.cat([fs[1:], fs[-1:]])
        same_prev = torch.cat([no, rs[1:] == rs[:-1]])
        same_next = torch.cat([rs[:-1] == rs[1:], no])
        d = torch.where(same_prev & same_next, (nxt - prev) / rng[order], INF)
        crowd = crowd + torch.zeros(p, device=dev).scatter(0, order, d)
    return crowd


# ------------------------------------------------------------- operators

def _uniform(gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(like.shape, generator=gen, device=like.device)


def _sbx_body(a, b, u, sign, do, eta):
    """Simulated binary crossover from draws u (uniform), sign and do
    (bool) of a's shape."""
    e = 1.0 / (eta + 1.0)
    beta = torch.where(u <= 0.5, (2.0 * u) ** e,
                       (1.0 / (2.0 * (1.0 - u) + 1e-12)) ** e)
    s = torch.where(sign, 1.0, -1.0)
    child = 0.5 * ((a + b) + s * beta * (a - b))
    return torch.where(do, child, a)


def _sbx_draws(gen, a, prob):
    return _uniform(gen, a), _uniform(gen, a) < 0.5, _uniform(gen, a) < prob


def _poly_mut_body(x, u, do, eta, scale: float = 1.0):
    """Polynomial mutation from draws u (uniform) and do (bool)."""
    e = 1.0 / (eta + 1.0)
    d = torch.where(u < 0.5, (2.0 * u) ** e - 1.0,
                    1.0 - (2.0 * (1.0 - u)) ** e)
    return x + torch.where(do, d * scale, 0.0)


def _poly_mut_draws(gen, x, prob):
    return _uniform(gen, x), _uniform(gen, x) < prob


def _ox_body(p1: torch.Tensor, p2: torch.Tensor, a: torch.Tensor,
             b: torch.Tensor) -> torch.Tensor:
    """Order crossover, batched: child row k keeps p1[k]'s segment
    [a[k], b[k]) and fills the other slots left to right with p2[k]'s
    values in p2 order.  p1, p2 [P, n] int64; a <= b [P]."""
    p, n = p1.shape
    pos = torch.arange(n, device=p1.device)
    seg = (pos >= a[:, None]) & (pos < b[:, None])
    taken = torch.zeros(p, n + 1, dtype=torch.bool, device=p1.device).scatter(
        1, torch.where(seg, p1, n), True)[:, :n]
    # order positions: non-segment slots first (stable), then segment slots
    pos_order = torch.argsort(seg.to(torch.int32), dim=-1, stable=True)
    # order values: untaken values in p2 order first, then the taken ones
    val_order = torch.argsort(torch.gather(taken, 1, p2).to(torch.int32),
                              dim=-1, stable=True)
    n_free = n - (b - a)
    fill = torch.where(pos < n_free[:, None], torch.gather(p2, 1, val_order),
                       torch.gather(p1, 1, pos_order))
    return torch.zeros_like(p1).scatter(1, pos_order, fill)


def _ox_draws(gen, p1):
    """Sorted cut pairs (a, b), each [P]."""
    p, n = p1.shape
    cuts = torch.randint(0, n + 1, (p, 2), generator=gen, device=p1.device)
    cuts = torch.sort(cuts, dim=-1).values
    return cuts[:, 0], cuts[:, 1]


def _swap_mut_body(perm: torch.Tensor, i: torch.Tensor, j: torch.Tensor,
                   do: torch.Tensor) -> torch.Tensor:
    """Sequential swap mutations: for s in order, row k swaps positions
    i[k, s] and j[k, s] when do[k, s]."""
    perm = perm.clone()
    for s in range(i.shape[1]):
        ii, jj, dd = i[:, s:s + 1], j[:, s:s + 1], do[:, s:s + 1]
        pi, pj = torch.gather(perm, 1, ii), torch.gather(perm, 1, jj)
        perm.scatter_(1, ii, torch.where(dd, pj, pi))
        perm.scatter_(1, jj, torch.where(dd, pi, pj))
    return perm


def _swap_mut_draws(gen, perm, n_swaps: int, prob):
    """Positions i, j [P, n_swaps] and whether each swap happens."""
    p, n = perm.shape
    shape = (p, n_swaps)
    i = torch.randint(0, n, shape, generator=gen, device=perm.device)
    j = torch.randint(0, n, shape, generator=gen, device=perm.device)
    do = torch.rand(shape, generator=gen, device=perm.device) < prob
    return i, j, do


def _vary_reduced_draws(gen, g1, cfg: NSGA2Config):
    """Per type: OX cuts (a, b), then swap draws (i, j, do)."""
    return [_ox_draws(gen, g1[t])
            + _swap_mut_draws(gen, g1[t], cfg.perm_swaps, cfg.perm_swap_prob)
            for t in range(3)]


def _vary_draws(gen, g1: G.Genotype, cfg: NSGA2Config):
    """Every draw of `_vary_body` for one child per row of `g1`: per type,
    the SBX then polynomial-mutation draws of dist, then of loc; then the
    permutation draws."""
    real = [_sbx_draws(gen, g1[part][t], cfg.crossover_prob)
            + _poly_mut_draws(gen, g1[part][t], cfg.real_mut_prob)
            for t in range(3) for part in ("dist", "loc")]
    return {"real": real, "perm": _vary_reduced_draws(gen, g1["perm"], cfg)}


def _vary_reduced_body(g1, g2, draws):
    return tuple(_swap_mut_body(_ox_body(g1[t], g2[t], a, b), i, j, do)
                 for t, (a, b, i, j, do) in enumerate(draws))


def _vary_body(g1: G.Genotype, g2: G.Genotype, draws, cfg: NSGA2Config
               ) -> G.Genotype:
    """One child per row of the parent populations (full genotype), from
    the draws of `_vary_draws`."""
    out = {"dist": [], "loc": []}
    for k, (u, sign, do, mu, mdo) in enumerate(draws["real"]):
        t, part = divmod(k, 2)
        part, scale = (("dist", 1.0), ("loc", 0.25))[part]
        x = _sbx_body(g1[part][t], g2[part][t], u, sign, do, cfg.sbx_eta)
        out[part].append(_poly_mut_body(x, mu, mdo, cfg.mut_eta, scale))
    return {"dist": tuple(out["dist"]),
            "loc": tuple(torch.clamp(l, 0.0, 1.0) for l in out["loc"]),
            "perm": _vary_reduced_body(g1["perm"], g2["perm"], draws["perm"])}


def _vary(gen, g1: G.Genotype, g2: G.Genotype, cfg: NSGA2Config) -> G.Genotype:
    return _vary_body(g1, g2, _vary_draws(gen, g1, cfg), cfg)


def _vary_reduced(gen, g1, g2, cfg: NSGA2Config):
    return _vary_reduced_body(g1, g2, _vary_reduced_draws(gen, g1, cfg))


# ------------------------------------------------------------- algorithm

def _tournament_body(rank, crowd, ia, ib) -> torch.Tensor:
    better = (rank[ia] < rank[ib]) | ((rank[ia] == rank[ib]) & (crowd[ia] > crowd[ib]))
    return torch.where(better, ia, ib)


def _tournament(gen, rank, crowd, n: int) -> torch.Tensor:
    p = rank.shape[0]
    ia = torch.randint(0, p, (n,), generator=gen, device=rank.device)
    ib = torch.randint(0, p, (n,), generator=gen, device=rank.device)
    return _tournament_body(rank, crowd, ia, ib)


def _lexsort_rank_crowd(rank, crowd):
    order1 = torch.argsort(-crowd, stable=True)
    order2 = torch.argsort(rank[order1], stable=True)
    return order1[order2]


def _eval_reduced(problem: Problem, perms, fused: bool = False) -> torch.Tensor:
    bx, by = G.decode_reduced(problem, perms)
    return torch.stack(O.objectives_from_coords(problem, bx, by, fused), dim=-1)


def init_state(problem: Problem, gen: torch.Generator, cfg: NSGA2Config
               ) -> Dict[str, torch.Tensor]:
    """A random population of cfg.pop_size on `gen`'s device, evaluated."""
    pop = G.random_genotype(problem, cfg.pop_size, gen)
    if cfg.reduced:
        pop = tuple(pop["perm"])
        objs = _eval_reduced(problem, pop, cfg.fused)
    else:
        objs = O.evaluate_population(problem, pop, cfg.fused)
    return {"pop": pop, "objs": objs}


def step_impl(problem: Problem, cfg: NSGA2Config, state, gen: torch.Generator):
    """One NSGA-II generation: P children, (mu+lambda) truncation."""
    pop, objs = state["pop"], state["objs"]
    p = cfg.pop_size
    rank = nondominated_rank(objs, cfg.fused)
    crowd = crowding_distance(objs, rank)
    pa = _tournament(gen, rank, crowd, p)
    pb = _tournament(gen, rank, crowd, p)

    def take(idx):
        return G.tree_map(lambda a: a[idx], pop)

    vary = _vary_reduced if cfg.reduced else _vary
    children = vary(gen, take(pa), take(pb), cfg)
    cobjs = (_eval_reduced(problem, children, cfg.fused) if cfg.reduced
             else O.evaluate_population(problem, children, cfg.fused))

    # (mu + lambda) environmental selection on the combined population
    allpop = G.tree_map(lambda a, b: torch.cat([a, b]), pop, children)
    allobjs = torch.cat([objs, cobjs])
    arank = nondominated_rank(allobjs, cfg.fused)
    acrowd = crowding_distance(allobjs, arank)
    order = _lexsort_rank_crowd(arank, acrowd)[:p]
    return {"pop": G.tree_map(lambda a: a[order], allpop),
            "objs": allobjs[order]}


step = step_impl


def best(state) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best combined-metric objectives, index)."""
    i = torch.argmin(O.combined_metric(state["objs"]))
    return state["objs"].index_select(0, i.reshape(1))[0], i
