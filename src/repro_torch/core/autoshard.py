"""autoshard: the paper's placement EA re-targeted at sharding layouts.

Port of `repro/core/autoshard.py`.  The same NSGA-II machinery that
places FPGA hard blocks searches the assignment of *logical tensor axes
to mesh dims*:

    hard blocks      -> logical axes (batch, width, experts, kv_seq, fsdp)
    columns/sites    -> mesh dims (pod / data / model) + None
    wirelength^2     -> collective seconds   (congestion/link time)
    max bbox         -> peak bytes/device    (critical resource)
    cascade legality -> divisibility (handled downstream by spec_for)
    Vivado run       -> the dry-run (verification only, on the winner)

Genotype: int vector, one gene per decision site, each selecting one option
from that site's menu.  Fitness: `sharding.costmodel.estimate`, an
analytical roofline taking microseconds.  The operators are numpy, drawn
from `default_rng(seed)` in the reference's order; ranking and crowding
reuse `core.nsga2` on float32 objectives, as the reference ranks its
objectives in float32 (so ties below float32 resolution fall alike).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import nsga2
from repro_torch.models.transformer import ArchConfig
from repro_torch.sharding import costmodel as cm
from repro_torch.sharding.logical import Rules, default_rules

# decision sites and their option menus (None = replicate)
SITES: Tuple[Tuple[str, Tuple[object, ...]], ...] = (
    ("batch",     (("data",), ("pod", "data"), ("pod", "data", "model"))),
    ("model_dim", ("model", None, ("data", "model"))),
    ("kv_seq",    ("model", None, ("data", "model"))),
    ("fsdp",      (None, ("data",), ("pod", "data"))),
)


def genotype_to_rules(genes: Sequence[int]) -> Dict[str, object]:
    return {name: opts[g % len(opts)]
            for g, (name, opts) in zip(genes, SITES)}


def rules_to_logical(rules_dict: Dict[str, object],
                     multi_pod: bool) -> Rules:
    """Map an autoshard decision vector onto the model's logical rule table."""
    base = default_rules(multi_pod)
    width = rules_dict.get("model_dim", "model")
    return base.override(
        batch=rules_dict.get("batch"),
        kv_seq=rules_dict.get("kv_seq"),
        q_flat=width, kv_flat=width, heads=width, kv_heads=width,
        mlp=width, experts=width, vocab=width, ssm_inner=width,
    )


@dataclasses.dataclass
class SearchResult:
    best_rules: Dict[str, object]
    best_report: cm.CostReport
    pareto: List[Tuple[Dict[str, object], cm.CostReport]]
    baseline: cm.CostReport
    evaluations: int


def _evaluate(cfg: ArchConfig, shape: str, mesh: cm.MeshShape, genes: np.ndarray,
              hw: cm.Hardware) -> Tuple[np.ndarray, List[cm.CostReport]]:
    reports = []
    objs = np.empty((len(genes), 2), np.float64)
    for i, g in enumerate(genes):
        r = cm.estimate(cfg, shape, mesh, genotype_to_rules(g), hw)
        reports.append(r)
        # objective 1 = step time bound (collective+compute+memory roofline);
        # objective 2 = peak residency -- wirelength^2 / maxbbox analogues
        objs[i] = (r.collective_s + 0.02 * r.step_s, r.bytes_per_device)
    return objs, reports


def _rank_crowd(objs: np.ndarray, dev) -> Tuple[np.ndarray, np.ndarray]:
    o = torch.tensor(objs, dtype=torch.float32, device=dev)
    rank = nsga2.nondominated_rank(o)
    return rank.cpu().numpy(), nsga2.crowding_distance(o, rank).cpu().numpy()


def search(cfg: ArchConfig, shape: str, mesh: cm.MeshShape,
           pop_size: int = 32, n_gens: int = 30, seed: int = 0,
           hbm_limit: float = 80e9, hw: cm.Hardware = cm.H100,
           device="cuda") -> SearchResult:
    """NSGA-II over sharding genotypes on chips of `hw` with `hbm_limit`
    bytes each (one H100's 80 GB by default).  Small dims -> numpy
    operators; ranking and crowding run `core.nsga2` on `device`."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    n_sites = len(SITES)
    n_opts = np.array([len(o) for _, o in SITES])
    pop = rng.integers(0, n_opts, size=(pop_size, n_sites))
    evals = 0

    baseline = cm.estimate(cfg, shape, mesh, genotype_to_rules([0] * n_sites), hw)

    def penalised(objs, reports):
        out = objs.copy()
        for i, r in enumerate(reports):
            if r.bytes_per_device > hbm_limit:     # infeasible: push off front
                out[i] += 1e6 * (r.bytes_per_device / hbm_limit)
        return out

    objs, reports = _evaluate(cfg, shape, mesh, pop, hw)
    evals += len(pop)
    objs_p = penalised(objs, reports)

    for _ in range(n_gens):
        rank, crowd = _rank_crowd(objs_p, dev)
        # binary tournament -> uniform crossover -> site reset mutation
        def pick():
            a, b = rng.integers(0, pop_size, 2)
            if (rank[a], -crowd[a]) <= (rank[b], -crowd[b]):
                return a
            return b

        children = np.empty_like(pop)
        for i in range(pop_size):
            p1, p2 = pop[pick()], pop[pick()]
            mask = rng.random(n_sites) < 0.5
            child = np.where(mask, p1, p2)
            mut = rng.random(n_sites) < (1.0 / n_sites)
            child = np.where(mut, rng.integers(0, n_opts), child)
            children[i] = child
        cobjs, creports = _evaluate(cfg, shape, mesh, children, hw)
        evals += pop_size
        cobjs_p = penalised(cobjs, creports)

        allpop = np.concatenate([pop, children])
        allobjs = np.concatenate([objs_p, cobjs_p])
        allrep = reports + creports
        arank, acrowd = _rank_crowd(allobjs, dev)
        order = np.lexsort((-acrowd, arank))[:pop_size]
        pop = allpop[order]
        objs_p = allobjs[order]
        reports = [allrep[i] for i in order]

    # champion: feasible, minimal step-time bound
    feas = [i for i, r in enumerate(reports)
            if r.bytes_per_device <= hbm_limit]
    pool = feas if feas else list(range(len(reports)))
    best_i = min(pool, key=lambda i: reports[i].step_s)
    rank = _rank_crowd(objs_p, dev)[0]
    pareto = [(genotype_to_rules(pop[i]), reports[i])
              for i in range(pop_size) if rank[i] == 0]
    return SearchResult(
        best_rules=genotype_to_rules(pop[best_i]),
        best_report=reports[best_i],
        pareto=pareto,
        baseline=baseline,
        evaluations=evals,
    )
