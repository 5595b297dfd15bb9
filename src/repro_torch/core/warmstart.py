"""Warm-start state construction: seed any algorithm from a genotype.

Port of `repro/core/warmstart.py`.  Transfer (paper SS IV-D, Table II)
makes a migrated champion the initial state of an algorithm:

  * `canonicalize` -- a seed (one genotype, a stacked population of K, or a
    reduced tuple of permutations) becomes a stacked block of `n_rows`
    genotypes, best first, tiled cyclically or truncated; the tiled copies
    are flagged `fresh`.  It evaluates a stacked seed on the seed's device
    (the reference evaluates on the host).
  * `warm_state` -- nsga2 / ga: the block with its fresh rows jittered
    (Gaussian noise on the real tiers, swap mutations on the mapping); row 0
    is always the unperturbed seed.  cmaes: mean := flat(seed), sigma :=
    sigma0 * sigma_shrink.  sa: the chain starts at flat(seed).

`jitter == 0` reproduces exact copies; the default 0.15 swaps each
permutation at probability 0.5.  `member_warm_init`, the pool-level entry,
waits for the portfolio (ROADMAP.md queue 1 item 8).
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from repro_torch.core import genotype as G
from repro_torch.core import hyper
from repro_torch.core import nsga2 as N
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem

# algorithms whose state carries a full population of genotypes
POPULATION_ALGOS = ("nsga2", "ga")

Seed = Union[G.Genotype, Tuple[torch.Tensor, ...]]


def seed_rows(algo: str, static_key: hyper.StaticKey) -> int:
    """Rows of the canonical seed block for a pool: the static pop_size
    for population algorithms, 1 (the champion) for point algorithms."""
    if algo in POPULATION_ALGOS:
        return dict(static_key[1])["pop_size"]
    return 1


def _leaf(a, device) -> torch.Tensor:
    t = torch.as_tensor(a, device=device)
    return t.long() if not t.is_floating_point() else t.float()


def canonicalize(problem: Problem, init: Seed, n_rows: int, device=None
                 ) -> Tuple[G.Genotype, torch.Tensor]:
    """Normalise a seed to (stacked genotype [n_rows], bool fresh [n_rows]).

    `init` is one genotype (1-D leaves), a stacked population (2-D leaves)
    or a reduced tuple of three permutations (lifted by
    `G.reduced_to_full`); tensors or numpy arrays.  The block lands on
    `device` (default: the device of the seed's tensors).  A stacked seed is
    ordered best-first by combined metric, so truncation keeps the
    champions and row 0 is the best member.
    """
    if isinstance(init, (tuple, list)):
        perms = tuple(_leaf(p, device)[None] for p in init)
        init = G.tree_map(lambda a: a[0], G.reduced_to_full(problem, perms))
    if not isinstance(init, dict) or set(init) != {"dist", "loc", "perm"}:
        raise TypeError(
            "init_state must be a genotype dict (dist/loc/perm), a stacked "
            f"population of them, or a reduced perm tuple; got {type(init)}")
    init = G.tree_map(lambda a: _leaf(a, device), init)
    leaves = [a for part in init.values() for a in part]
    stacked = all(a.dim() == 2 for a in leaves)
    single = all(a.dim() == 1 for a in leaves)
    if not (stacked or single):
        raise ValueError("seed leaves must all be rank-1 (one genotype) or "
                         "all rank-2 (stacked population)")
    dev = leaves[0].device
    rows = torch.arange(n_rows, device=dev)
    if single:
        pop = G.tree_map(lambda a: a[None].expand(n_rows, *a.shape).clone(), init)
        return pop, rows >= 1
    k = leaves[0].shape[0]
    if any(a.shape[0] != k for a in leaves):
        raise ValueError("stacked seed leaves disagree on population size")
    metric = O.combined_metric(O.evaluate_population(problem, init))
    idx = torch.argsort(metric, stable=True)[rows % k]
    return G.tree_map(lambda a: a[idx], init), rows >= k


def _jitter_draws(gen: torch.Generator, pop: G.Genotype, jitter) -> Dict:
    """Per type: Gaussian noise of dist's and loc's shapes, then two swap
    mutations of the permutation at probability clip(jitter * 0.5/0.15)."""
    swap_prob = torch.clamp(jitter * (0.5 / 0.15), 0.0, 1.0)

    def randn(a):
        return torch.randn(a.shape, generator=gen, device=a.device)

    return {"dist": [randn(a) for a in pop["dist"]],
            "loc": [randn(a) for a in pop["loc"]],
            "perm": [N._swap_mut_draws(gen, p, 2, swap_prob) for p in pop["perm"]]}


def _jitter_body(pop: G.Genotype, draws: Dict, jitter) -> G.Genotype:
    """Perturbed copies of every row of `pop`, from `_jitter_draws`."""
    return {"dist": tuple(a + n * jitter for a, n in zip(pop["dist"], draws["dist"])),
            "loc": tuple(torch.clamp(a + n * jitter, 0.0, 1.0)
                         for a, n in zip(pop["loc"], draws["loc"])),
            "perm": tuple(N._swap_mut_body(p, *d)
                          for p, d in zip(pop["perm"], draws["perm"]))}


def jitter_genotype(problem: Problem, gen: torch.Generator, pop: G.Genotype,
                    jitter: torch.Tensor) -> G.Genotype:
    """One perturbed copy of each row of `pop` (`jitter` a 0-d tensor)."""
    return _jitter_body(pop, _jitter_draws(gen, pop, jitter), jitter)


def _jitter_rows(problem: Problem, gen: torch.Generator, pop: G.Genotype,
                 fresh: torch.Tensor, jitter: torch.Tensor) -> G.Genotype:
    """Perturb exactly the `fresh` rows of a stacked genotype block."""
    jittered = jitter_genotype(problem, gen, pop, jitter)
    return G.tree_map(lambda a, b: torch.where(fresh[:, None], b, a), pop, jittered)


def warm_state(problem: Problem, algo: str, cfg, pop: G.Genotype,
               fresh: torch.Tensor, gen: torch.Generator,
               jitter: torch.Tensor, sigma_shrink: torch.Tensor) -> Dict:
    """Algorithm state seeded from a `canonicalize` block (row 0 is the
    unperturbed champion), on the block's device."""
    if algo in POPULATION_ALGOS:
        pop = _jitter_rows(problem, gen, pop, fresh, jitter)
        if getattr(cfg, "reduced", False):
            perms = pop["perm"]
            return {"pop": perms, "objs": N._eval_reduced(problem, perms)}
        return {"pop": pop, "objs": O.evaluate_population(problem, pop)}

    z = G.to_flat(problem, G.tree_map(lambda a: a[:1], pop))[0]
    objs = O.evaluate(problem, G.tree_map(lambda a: a[0], pop))
    if algo == "cmaes":
        from repro_torch.core import cmaes as C
        state = C.init_state(problem, gen, cfg, mean0=z)
        state["sigma"] = hyper.as_f32(cfg.sigma0, z.device) * sigma_shrink
        state["best_objs"] = objs
        state["best_z"] = z
        return state
    if algo == "sa":
        return {"z": z, "fit": O.scalarize(objs), "objs": objs,
                "k": torch.zeros((), dtype=torch.int32, device=z.device),
                "t_adapt": hyper.as_f32(cfg.t0, z.device),
                "acc_ema": torch.full((), 0.5, device=z.device),
                "best_z": z, "best_objs": objs}
    raise KeyError(f"warm start not implemented for algo {algo!r}")


def member_warm_init(*args, **kwargs) -> Dict:
    """The pool-level warm init of the reference needs `hyper.merge_config`
    and the portfolio's pools."""
    raise NotImplementedError(
        "member_warm_init is not ported yet (ROADMAP.md, queue 1 item 8)")
