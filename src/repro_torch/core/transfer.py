"""Transfer learning across UltraScale+ devices (paper SS IV-D, Table II).

Port of `repro/core/transfer.py`.  A converged genotype on a seed device
warm-starts the search on a sibling device; its three tiers migrate
independently:

  distribution : per-column genes map by relative x position (nearest
                 fractional-width neighbour between the two column sets),
  location     : per-chain genes tile periodically when the design grows,
  mapping      : the permutation extends order-preservingly (argsort of
                 tiled rank keys), keeping the seed's relative structure.

`migrate` is the reference's numpy on the host, once per transfer; its
result lands on the genotype's device and seeds NSGA-II (population :=
seed + jitter) or CMA-ES (mean := seed, small sigma).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import genotype as G
from repro_torch.fpga.netlist import Problem


def _norm01(x: np.ndarray) -> np.ndarray:
    """Column x coordinates -> relative positions in [0, 1].

    Single-column geometries (and coincident columns, e.g. BRAM parity
    sub-column pairs sharing one physical x) have zero spread; every column
    then sits at relative 0.
    """
    x = np.asarray(x, np.float64)
    if x.size == 0:
        raise ValueError("empty column set")
    span = float(np.ptp(x))
    if x.size == 1 or span <= 0.0:
        return np.zeros_like(x)
    return (x - x.min()) / span


def _map_columns(src_x: np.ndarray, dst_x: np.ndarray) -> np.ndarray:
    """For each dst column, the src column at the nearest relative x.

    Distance ties (BRAM parity sub-columns share one physical x) break by
    relative ordinal, so identical column sets map to the identity.
    """
    sx = _norm01(src_x)
    dx = _norm01(dst_x)
    d = np.abs(dx[:, None] - sx[None, :])
    so = np.arange(sx.size) / max(sx.size - 1, 1)
    do = np.arange(dx.size) / max(dx.size - 1, 1)
    d += np.abs(do[:, None] - so[None, :]) * 1e-6
    return np.argmin(d, axis=1)


def migrate(src: Problem, dst: Problem, g: G.Genotype) -> G.Genotype:
    """Project one genotype (1-D leaves) from the seed device's problem onto
    the target's, on the genotype's device."""
    dev = g["dist"][0].device
    host = G.tree_map(lambda a: a.detach().cpu().numpy(), g)
    dist, loc, perm = [], [], []
    for t in G.TYPES:
        gs, gd = src.geom[t], dst.geom[t]
        cmap = _map_columns(np.asarray(gs.col_x), np.asarray(gd.col_x))
        dist.append(host["dist"][t][cmap])
        idx = np.arange(gd.n_chains) % gs.n_chains
        loc.append(host["loc"][t][idx])
        # tile the seed permutation block-wise into rank keys; argsort gives
        # a permutation keeping the seed's relative order in every block
        ps = host["perm"][t]
        n_rep = -(-gd.n_chains // gs.n_chains)
        keys = np.concatenate(
            [ps + r * gs.n_chains for r in range(n_rep)])[:gd.n_chains]
        perm.append(np.argsort(np.argsort(keys)))
    return {"dist": tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in dist),
            "loc": tuple(torch.as_tensor(a, dtype=torch.float32, device=dev) for a in loc),
            "perm": tuple(torch.as_tensor(a, dtype=torch.int64, device=dev) for a in perm)}


def auto_migrate(src: Problem, dst: Problem, g: G.Genotype) -> G.Genotype:
    """Identity when the problems' content signatures agree, else `migrate`."""
    if src.signature == dst.signature:
        return g
    return migrate(src, dst, g)


def converge_champion(problem: Problem, gen: torch.Generator, pop_size: int,
                      n_gens: int) -> G.Genotype:
    """Converge an NSGA-II champion on `gen`'s device to seed transfers from."""
    from repro_torch.core import evolve
    from repro_torch.core import nsga2 as N
    from repro_torch.core import portfolio as P
    cfg = N.NSGA2Config(pop_size=pop_size)
    state, _ = evolve.run(problem, "nsga2", cfg, gen, n_gens, device=gen.device)
    g, _objs = P.best_genotype(problem, "nsga2", state, cfg)
    return g


def seed_population(problem: Problem, g_seed: G.Genotype, gen: torch.Generator,
                    pop_size: int, jitter: float = 0.15) -> Dict:
    """NSGA-II warm start on `gen`'s device: seed + mutated copies (row 0
    stays exact)."""
    from repro_torch.core import warmstart as W
    from repro_torch.core.nsga2 import NSGA2Config
    dev = gen.device
    pop, fresh = W.canonicalize(problem, g_seed, pop_size, device=dev)
    return W.warm_state(problem, "nsga2", NSGA2Config(pop_size=pop_size), pop,
                        fresh, gen, torch.full((), jitter, device=dev),
                        torch.ones((), device=dev))


def seed_cmaes(problem: Problem, g_seed: G.Genotype, gen: torch.Generator,
               sigma0: float = 0.08) -> Tuple[Dict, object]:
    """CMA-ES warm-start state centred on the migrated genotype."""
    from repro_torch.core import cmaes as C
    from repro_torch.core import warmstart as W
    dev = gen.device
    cfg = C.CMAESConfig(sigma0=sigma0)
    pop, fresh = W.canonicalize(problem, g_seed, 1, device=dev)
    state = W.warm_state(problem, "cmaes", cfg, pop, fresh, gen,
                         torch.zeros((), device=dev), torch.ones((), device=dev))
    return state, cfg
