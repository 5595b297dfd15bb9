"""Evolution loop: one population or one point, init + n_gens generations.

Port of `repro/core/evolve.py` (`get_algo`, `state_best_objs`, `run`,
`run_islands`) for NSGA-II, the GA, sep-CMA-ES and simulated annealing.
The reference scans the generations inside one XLA program; here a Python
loop issues each generation's device operations and writes the
per-generation best into a history tensor that stays on the device, so
the loop never waits for the card (the reference's jitted `_run_impl` has
no counterpart: `run` is that loop).

`run_islands` is the legacy round-synchronous runtime: one island per rank
of a `torch.distributed` process group; every `gens_per_round` generations
the islands `all_gather` their champions and each adopts its right
neighbour's into its worst member.  `core.islands` is the newer model
(per-generation cadence, a point-to-point ring, service integration).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import genotype as G
from repro_torch.core import hyper
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem


def get_algo(name: str):
    if name == "nsga2":
        from repro_torch.core import nsga2 as m
    elif name == "cmaes":
        from repro_torch.core import cmaes as m
    elif name == "sa":
        from repro_torch.core import annealing as m
    elif name == "ga":
        from repro_torch.core import ga as m
    else:
        raise KeyError(name)
    return m


def state_best_objs(state: Dict) -> torch.Tensor:
    """Best (wl^2, bbox) of a population or point state, without a host sync."""
    if "objs" in state and state["objs"].dim() == 2:
        objs = state["objs"]
        i = torch.argmin(O.combined_metric(objs)).reshape(1)
        return objs.index_select(0, i)[0]
    if "best_objs" in state:
        return state["best_objs"]
    return state["objs"]


def run(problem: Problem, algo: str, cfg, gen: torch.Generator, n_gens: int,
        islands=None, device="cuda") -> Tuple[Dict, torch.Tensor]:
    """Full optimisation on `device`, drawing from `gen` (on that device).

    Returns (state, history[n_gens, 2]), the history on the device.  With
    `islands=IslandConfig(P, migrate_every)` the run dispatches to
    `core.islands.run`: island-stacked states [P, ...] and per-island
    history [n_gens, P, 2] (the single-population result at P = 1).
    Raises if `device` is CUDA and no card is present: the CPU runs only
    when asked.
    """
    if islands is not None:
        from repro_torch.core import islands as I
        return I.run(problem, algo, cfg, gen, n_gens, islands=islands, device=device)
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator is on {gen.device}, run on {dev}")
    m = get_algo(algo)
    cfg = hyper.tracify(cfg, dev)
    state = m.init_state(problem, gen, cfg)
    hist = torch.empty(n_gens, 2, device=dev)
    for i in range(n_gens):
        state = m.step_impl(problem, cfg, state, gen)
        hist[i] = state_best_objs(state)
    return state, hist


def run_islands(problem: Problem, algo: str, cfg, gen: torch.Generator, rounds: int,
                gens_per_round: int, group=None, device="cuda", mesh=None,
                axis="data") -> Tuple[Dict, torch.Tensor]:
    """Island-model evolution, one island per rank of `group` (population
    algorithms: NSGA-II, the GA).

    `group=None` is a world of one island, as the reference on one device.
    Every rank passes a `gen` seeded alike; W island generators are drawn
    from it and rank r evolves island r.  After each round of
    `gens_per_round` generations the champions and their objectives are
    gathered over the ranks (`islands.Ring.all_gather`), and island r
    adopts island (r + 1) % W's into its worst member.  Returns the states
    stacked [W, ...] and the history [rounds, W, 2] of each island's best
    after each round, on every rank.  A `mesh` (a `DeviceMesh`) puts one
    island on each of its ranks over the dim `axis`, or over a tuple of
    dims flattened, as the reference's shard_map over `axis` does; it
    takes the place of `group`.
    """
    from repro_torch.core import islands as I
    from repro_torch.core import portfolio
    from repro_torch.runtime import collectives
    if mesh is not None:
        group = collectives.group_of(mesh, axis)
    if algo not in ("nsga2", "ga"):
        raise ValueError(f"run_islands takes population algorithms (nsga2, ga), not {algo!r}")
    dev = resolve_device(device)
    ring = None if group is None else I.Ring(group, dev)
    w, r = (1, 0) if ring is None else (ring.size, ring.rank)
    m = get_algo(algo)
    cfg = hyper.tracify(cfg, dev)
    my = portfolio.member_generators(w, None, gen, dev)[r]
    state = m.init_state(problem, my, cfg)
    hist = torch.empty(rounds, 2, device=dev)

    def gather(tree, dim=0):
        tree = G.tree_map(lambda a: a.unsqueeze(dim), tree)
        return tree if ring is None else ring.all_gather(tree, dim)

    for i in range(rounds):
        for _ in range(gens_per_round):
            state = m.step_impl(problem, cfg, state, my)
        champs, cobjs = gather(I.champion(state))
        nbr = (r + 1) % w
        state = I.adopt(state, G.tree_map(lambda a: a[nbr], champs), cobjs[nbr])
        hist[i] = state_best_objs(state)
    return gather(state), gather(hist, dim=1)
