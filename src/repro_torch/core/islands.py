"""Island-model evolution: P sub-populations, ring migration, one batched program.

Port of `repro/core/islands.py`, on one device.  P independent
sub-populations ("islands") of any algorithm evolve side by side and pass
their champions around a ring every `migrate_every` generations.  The
island axis is one more batch axis: each generation is one
`portfolio.batched_step`, a `torch.func.vmap` of the algorithm's pure
`step_body` over the island-stacked states, so every kernel launches once
per generation whatever P is.

  * `IslandConfig` -- (n_islands, migrate_every); frozen and hashable, a
    static part of a run or a pool like pop_size.
  * `member_init` / `member_round` / `member_warm_init` -- one slot's
    island-stacked states ``[P, ...]``, mirroring `core.portfolio` and
    `core.warmstart`.  Warm seeds land on island 0 and reach the others
    through migration.  `pool_round` advances S such slots as one batch
    (the placement service's islands pools).
  * `run` -- the full-run entry (`evolve.run(islands=...)` dispatches here).

Each island draws from its own `torch.Generator` (`island_generators`):
with P == 1 that is the caller's generator unchanged, so ``islands(P=1)``
is the single-population run bit for bit; with P > 1, P island seeds are
drawn from it once.  Migration is a pure function of the stacked states:
island i adopts the champion of island (i - 1) % P (one `torch.roll`).
Population states replace their worst member; point states (CMA-ES, SA)
adopt the incoming champion only when it beats their own best, restarting
the mean / chain there.

The reference's sharded ring (`shard_map` + `ppermute` over a mesh) is not
ported: passing `mesh=` raises.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple, Union

import torch

from repro_torch import resolve_device
from repro_torch.core import evolve, hyper, portfolio, warmstart
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem

MESH_NOT_PORTED = ("islands over several devices (shard_map/ppermute ring) are "
                   "not ported yet (ROADMAP.md, queue 1 item 8b)")


@dataclasses.dataclass(frozen=True)
class IslandConfig:
    """Static island topology.  `migrate_every == 0` never migrates;
    `n_islands == 1` is the single-population degeneracy."""
    n_islands: int = 1
    migrate_every: int = 0         # generations between ring migrations

    def __post_init__(self):
        if self.n_islands < 1:
            raise ValueError(f"n_islands must be >= 1, got {self.n_islands}")
        if self.migrate_every < 0:
            raise ValueError(
                f"migrate_every must be >= 0, got {self.migrate_every}")

    @property
    def active(self) -> bool:
        """True when this config actually changes the computation."""
        return self.n_islands > 1


def island_generators(gen: torch.Generator, n: int) -> List[torch.Generator]:
    """The P islands' generators.  `n == 1` returns the caller's generator
    itself: the P = 1 run consumes the same stream as the single-population
    run.  Otherwise P seeds are drawn from `gen` once."""
    if n == 1:
        return [gen]
    return portfolio.member_generators(n, None, gen, gen.device)


# ----------------------------------------------------------- migration

def champion(state: Dict) -> Tuple:
    """(champion payload, its objectives [2]) of ONE island's state.

    Population states ship their best genotype (the reduced genotype's
    permutations for reduced NSGA-II); point states their flat `best_z`.
    """
    if "best_z" in state:
        return state["best_z"], state["best_objs"]
    b = torch.argmin(O.combined_metric(state["objs"])).reshape(1)
    return (G.tree_map(lambda a: a.index_select(0, b)[0], state["pop"]),
            state["objs"].index_select(0, b)[0])


def adopt(state: Dict, champ, champ_objs: torch.Tensor) -> Dict:
    """One island adopts an incoming champion.

    Population states replace their worst member unconditionally (elitist
    truncation culls it anyway if the local pool is stronger), through a
    one-hot row mask so that `torch.func.vmap` batches it.  Point states
    adopt only on strict improvement, restarting the CMA-ES mean / SA chain
    at the migrant.
    """
    st = dict(state)
    if "best_z" in state:
        better = (O.combined_metric(champ_objs)
                  < O.combined_metric(state["best_objs"]))
        st["best_z"] = torch.where(better, champ, state["best_z"])
        st["best_objs"] = torch.where(better, champ_objs, state["best_objs"])
        if "mean" in state:                                   # cmaes
            st["mean"] = torch.where(better, champ, state["mean"])
        if "z" in state:                                      # sa
            st["z"] = torch.where(better, champ, state["z"])
            st["objs"] = torch.where(better, champ_objs, state["objs"])
            st["fit"] = torch.where(better, O.scalarize(champ_objs), state["fit"])
        return st
    objs = state["objs"]
    w = torch.argmax(O.combined_metric(objs))
    row = torch.arange(objs.shape[0], device=objs.device) == w

    def put(a, b):
        return torch.where(row.reshape(-1, *[1] * (a.dim() - 1)), b, a)

    st["pop"] = G.tree_map(put, state["pop"], champ)
    st["objs"] = put(objs, champ_objs)
    return st


def migrate_ring(state: Dict) -> Dict:
    """Ring migration over island-stacked states ``[P, ...]``: island i
    adopts the champion of island i - 1 (mod P), one roll of the stacked
    champions."""
    champs, cobjs = torch.func.vmap(champion)(state)
    inc = G.tree_map(lambda a: torch.roll(a, 1, dims=0), champs)
    return torch.func.vmap(adopt)(state, inc, torch.roll(cobjs, 1, dims=0))


# ------------------------------------------------------ generation loop

def round_impl(problem: Problem, algo: str, icfg: IslandConfig, cfg,
               state: Dict, gens: Sequence[torch.Generator], n_gens: int,
               g0: Union[int, torch.Tensor]) -> Tuple[Dict, torch.Tensor]:
    """Advance island-stacked states by `n_gens` generations.

    `cfg` is the islands' shared config, `gens` the islands' generators
    and `g0` the global generation count already run.  Ring migration
    fires after every generation g with ``g % migrate_every == 0``,
    counted globally, so a pool stepping a few generations at a time
    migrates on the same generations as one long run.  With a Python int `g0` the host decides
    when to migrate; with a tensor (slots of a pool at different counts)
    every generation computes the migration and keeps it where due.
    Returns (state, per-island best objectives ``[n_gens, P, 2]``).
    """
    p, dev = len(gens), torch.device(gens[0].device)
    static_key, fields = hyper.split_fields(cfg)
    fields = {n: hyper.as_f32(v, dev) for n, v in fields.items()}
    cfg = hyper.merge_config(static_key, fields)      # draws and bodies alike in fp32
    traced = {n: v.expand(p) for n, v in fields.items()}
    cfgs = [cfg] * p
    migrating = icfg.active and icfg.migrate_every > 0
    hist = torch.empty(n_gens, p, 2, device=dev)
    g = g0
    for i in range(n_gens):
        state = portfolio.batched_step(problem, algo, static_key, traced, cfgs, state, gens)
        g = g + 1
        if migrating:
            if isinstance(g, torch.Tensor):
                do = (g % icfg.migrate_every) == 0
                state = G.tree_map(lambda a, b: torch.where(do, b, a),
                                   state, migrate_ring(state))
            elif g % icfg.migrate_every == 0:
                state = migrate_ring(state)
        hist[i] = portfolio.best_objs(state)
    return state, hist


def best_over_islands(state: Dict) -> torch.Tensor:
    """Best (wl^2, bbox) across an island-stacked state, on the device."""
    best = portfolio.best_objs(state)                       # [P, 2]
    return best.index_select(0, torch.argmin(O.combined_metric(best)).reshape(1))[0]


# ------------------------------------------- slot-level member programs

def member_init(problem: Problem, algo: str, static_key: hyper.StaticKey,
                icfg: IslandConfig, traced: Dict[str, torch.Tensor],
                gens: Sequence[torch.Generator]) -> Dict:
    """One slot's island-stacked initial state ``[P, ...]``; `traced` holds
    the slot's float fields (0-d), `gens` its `island_generators`."""
    _check_islands(icfg, gens)
    cfg = hyper.merge_config(static_key, traced)
    m = evolve.get_algo(algo)
    return portfolio.stack([m.init_state(problem, g, cfg) for g in gens])


def member_round(problem: Problem, algo: str, static_key: hyper.StaticKey,
                 icfg: IslandConfig, n_gens: int, traced: Dict[str, torch.Tensor],
                 state: Dict, gens: Sequence[torch.Generator],
                 g0: Union[int, torch.Tensor]) -> Tuple[Dict, torch.Tensor]:
    """Advance one slot's islands `n_gens` generations; returns (state,
    best objectives across all islands [2])."""
    _check_islands(icfg, gens)
    cfg = hyper.merge_config(static_key, traced)
    state, _ = round_impl(problem, algo, icfg, cfg, state, gens, n_gens, g0)
    return state, best_over_islands(state)


def member_warm_init(problem: Problem, algo: str, static_key: hyper.StaticKey,
                     icfg: IslandConfig, traced: Dict[str, torch.Tensor],
                     pop: G.Genotype, fresh: torch.Tensor, jitter: torch.Tensor,
                     sigma_shrink: torch.Tensor,
                     gens: Sequence[torch.Generator]) -> Dict:
    """Warm-start one slot's islands from a canonical seed block
    (`warmstart.canonicalize`).

    The seed lands on **island 0** (`warmstart.warm_state`, drawn from
    `gens[0]`, as a pool without islands does); islands 1..P-1 start cold
    from their own generators and pick the transferred champion up through
    ring migration.
    """
    _check_islands(icfg, gens)
    cfg = hyper.merge_config(static_key, traced)
    m = evolve.get_algo(algo)
    warm0 = warmstart.warm_state(problem, algo, cfg, pop, fresh, gens[0], jitter,
                                 sigma_shrink)
    return portfolio.stack([warm0] + [m.init_state(problem, g, cfg) for g in gens[1:]])


def pool_round(problem: Problem, algo: str, static_key: hyper.StaticKey,
               icfg: IslandConfig, n_gens: int, traced: Dict[str, torch.Tensor],
               states: Dict, gens: Sequence[Sequence[torch.Generator]],
               g0: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
    """Advance S slots of island-stacked states ``[S, P, ...]`` `n_gens`
    generations as one batch of S * P members, so that every kernel
    launches once per generation whatever S and P are.

    Slot s has its float fields ``traced[k][s]``, its islands'
    generators ``gens[s]`` and its own global generation count ``g0[s]``
    (an int tensor [S]); migration is computed every generation and kept
    where due, the tensor form of `round_impl`.  Slot s computes what
    ``member_round(..., {k: traced[k][s]}, states[s], gens[s], g0[s])``
    computes alone.  Returns (states, each slot's best objectives across
    its islands [S, 2]).
    """
    s, p = len(gens), icfg.n_islands
    for slot_gens in gens:
        _check_islands(icfg, slot_gens)
    flat_traced = {n: v[:, None].expand(s, p).reshape(s * p) for n, v in traced.items()}
    flat_gens = [g for slot_gens in gens for g in slot_gens]
    cfgs = [hyper.unstack_config(static_key, flat_traced, i) for i in range(s * p)]

    def unflatten(st):
        return G.tree_map(lambda a: a.unflatten(0, (s, p)), st)

    flat = G.tree_map(lambda a: a.flatten(0, 1), states)
    g = g0
    for _ in range(n_gens):
        flat = portfolio.batched_step(problem, algo, static_key, flat_traced, cfgs, flat, flat_gens)
        g = g + 1
        if icfg.migrate_every > 0:
            st = unflatten(flat)
            do = (g % icfg.migrate_every) == 0
            st = G.tree_map(lambda a, b: torch.where(do.reshape(-1, *[1] * (a.dim() - 1)), b, a),
                            st, torch.func.vmap(migrate_ring)(st))
            flat = G.tree_map(lambda a: a.flatten(0, 1), st)
    states = unflatten(flat)
    return states, torch.func.vmap(best_over_islands)(states)


def _check_islands(icfg: IslandConfig, gens: Sequence[torch.Generator]) -> None:
    if len(gens) != icfg.n_islands:
        raise ValueError(f"{len(gens)} generators for {icfg.n_islands} islands")


def best_genotype(problem: Problem, algo: str, state: Dict,
                  cfg=None) -> Tuple[G.Genotype, torch.Tensor]:
    """Best full genotype + objectives across one slot's islands: pick the
    champion island, then `portfolio.best_genotype` on its state."""
    best = portfolio.best_objs(state)
    i = int(torch.argmin(O.combined_metric(best)))
    return portfolio.best_genotype(problem, algo, portfolio.member(state, i), cfg)


# ------------------------------------------------------- full-run entry

def run(problem: Problem, algo: str, cfg, gen: torch.Generator, n_gens: int,
        islands: IslandConfig = IslandConfig(), mesh=None, device="cuda"
        ) -> Tuple[Dict, torch.Tensor]:
    """P islands of a full optimisation on `device`, drawing from `gen`.

    Returns (island-stacked states ``[P, ...]``, per-island history
    ``[n_gens, P, 2]`` on the device).  P = 1 is `evolve.run` bit for bit.
    """
    if mesh is not None:
        raise NotImplementedError(MESH_NOT_PORTED)
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator is on {gen.device}, run on {dev}")
    cfg = hyper.tracify(cfg, dev)
    static_key, traced = hyper.split_fields(cfg)
    gens = island_generators(gen, islands.n_islands)
    state = member_init(problem, algo, static_key, islands, traced, gens)
    return round_impl(problem, algo, islands, cfg, state, gens, n_gens, 0)
