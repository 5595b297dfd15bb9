"""Island-model evolution: P sub-populations, ring migration, one batched program.

Port of `repro/core/islands.py`.  P independent
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
    Over a `torch.distributed` process group of W ranks (``group=``, or
    the default group when it is initialised, W > 1 and W divides P) each
    rank evolves its own L = P / W islands and the ring crosses ranks
    through `Ring`; every rank returns the whole island-stacked result.

Each island draws from its own `torch.Generator` (`island_generators`):
with P == 1 that is the caller's generator unchanged, so ``islands(P=1)``
is the single-population run bit for bit; with P > 1, P island seeds are
drawn from it once.  Migration is a pure function of the stacked states:
island i adopts the champion of island (i - 1) % P (one `torch.roll`).
Population states replace their worst member; point states (CMA-ES, SA)
adopt the incoming champion only when it beats their own best, restarting
the mean / chain there.

Across processes, migration is the local roll plus one ring exchange
(`Ring.exchange`): each rank posts an `isend` of its last island's
champion to rank r + 1 and an `irecv` from rank r - 1, then waits, so the
ring cannot deadlock; the champion lands on the next rank's island 0.  At
the end one `all_gather` per leaf gives every rank the global ``[P, ...]``
states and ``[n_gens, P, 2]`` history.  The group's backend decides the
transport and nothing falls back: `nccl` (one card per rank) sends the CUDA
tensors themselves, device to device; `gloo` sends no CUDA tensor, so each
payload is copied to the host explicitly and back after the receive.  One
H100 takes one NCCL rank only, so ranks that share a card run `gloo` with
that host staging: the reference's "no host round-trip" holds only across
several cards.  `mesh=` (a `DeviceMesh` with an "islands" dim, the
reference's shard_map axis) spreads the islands over that dim's process
group, the same `group=` path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils import _pytree

from repro_torch import resolve_device
from repro_torch.core import evolve, hyper, portfolio, warmstart
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem
from repro_torch.runtime import collectives

AXIS = "islands"


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


class Ring:
    """The island ring over the ranks of a process group (`None`: the
    default group).  Rank r holds islands [r L, (r + 1) L); its last
    island's champion goes to rank r + 1.  The backend fixes the wire:
    `gloo` carries host tensors (each payload is copied to the host and
    back), `nccl` carries the CUDA tensors themselves; any other backend,
    or `nccl` with host tensors, raises."""

    def __init__(self, group, device: torch.device):
        self.group, self.device = group, torch.device(device)
        self.size, self.rank = dist.get_world_size(group), dist.get_rank(group)
        backend = dist.get_backend(group)
        if backend == "gloo":
            self.wire = torch.device("cpu")
        elif backend == "nccl" and self.device.type == "cuda":
            self.wire = self.device
        else:
            raise ValueError(f"islands over a {backend!r} group cannot carry "
                             f"{self.device.type} tensors: use gloo, or nccl on CUDA")
        group = dist.group.WORLD if group is None else group
        self.next = dist.get_global_rank(group, (self.rank + 1) % self.size)
        self.prev = dist.get_global_rank(group, (self.rank - 1) % self.size)

    def exchange(self, tree):
        """Send `tree` to the next rank and return the previous rank's."""
        leaves, spec = _pytree.tree_flatten(tree)
        out = [a.to(self.wire).contiguous() for a in leaves]
        inc = [torch.empty_like(a) for a in out]
        reqs = [dist.isend(a, self.next, group=self.group, tag=i) for i, a in enumerate(out)]
        reqs += [dist.irecv(a, self.prev, group=self.group, tag=i) for i, a in enumerate(inc)]
        for req in reqs:
            req.wait()
        return _pytree.tree_unflatten([a.to(self.device) for a in inc], spec)

    def all_gather(self, tree, dim: int = 0):
        """Every rank's `tree`, each leaf concatenated along `dim` in rank order."""
        leaves, spec = _pytree.tree_flatten(tree)
        return _pytree.tree_unflatten(
            [torch.cat(collectives.gather_list(a, self.group), dim=dim) for a in leaves], spec)


def migrate_ring(state: Dict, ring: Optional[Ring] = None) -> Dict:
    """Ring migration over island-stacked states ``[L, ...]``: island i
    adopts the champion of island i - 1 (mod P, globally).

    In one process (`ring=None`, L = P) one roll of the stacked champions;
    across ranks the local roll plus one `Ring.exchange` carrying this
    rank's last champion to the next rank's island 0."""
    champs, cobjs = torch.func.vmap(champion)(state)
    if ring is None:
        inc = G.tree_map(lambda a: torch.roll(a, 1, dims=0), champs)
        inc_objs = torch.roll(cobjs, 1, dims=0)
    else:
        bound, bound_objs = ring.exchange((G.tree_map(lambda a: a[-1], champs), cobjs[-1]))
        inc = G.tree_map(lambda b, a: torch.cat([b[None], a[:-1]]), bound, champs)
        inc_objs = torch.cat([bound_objs[None], cobjs[:-1]])
    return torch.func.vmap(adopt)(state, inc, inc_objs)


# ------------------------------------------------------ generation loop

def round_impl(problem: Problem, algo: str, icfg: IslandConfig, cfg,
               state: Dict, gens: Sequence[torch.Generator], n_gens: int,
               g0: Union[int, torch.Tensor], ring: Optional[Ring] = None
               ) -> Tuple[Dict, torch.Tensor]:
    """Advance island-stacked states by `n_gens` generations.

    `cfg` is the islands' shared config, `gens` the generators of the L
    islands held here (all P of them without a `ring`) and `g0` the global
    generation count already run.  Ring migration
    fires after every generation g with ``g % migrate_every == 0``,
    counted globally, so a pool stepping a few generations at a time
    migrates on the same generations as one long run.  With a Python int `g0` the host decides
    when to migrate; with a tensor (slots of a pool at different counts)
    every generation computes the migration and keeps it where due.
    Returns (state, per-island best objectives ``[n_gens, L, 2]``).
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
                                   state, migrate_ring(state, ring))
            elif g % icfg.migrate_every == 0:
                state = migrate_ring(state, ring)
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

def _process_group(n: int, group):
    """The group the islands spread over, or None for one process.  An
    explicit `group` must have a size dividing `n`; without one, the
    default group is used when it is initialised, has W > 1 ranks and W
    divides `n` (the reference's ``shard="auto"``)."""
    if group is None:
        if not (dist.is_available() and dist.is_initialized()):
            return None
        w = dist.get_world_size()
        return dist.group.WORLD if w > 1 and n % w == 0 else None
    w = dist.get_world_size(group)
    if n % w:
        raise ValueError(f"a process group of {w} ranks must divide n_islands={n}")
    return group if w > 1 else None


def run(problem: Problem, algo: str, cfg, gen: torch.Generator, n_gens: int,
        islands: IslandConfig = IslandConfig(), mesh=None, device="cuda",
        group=None, shard="auto") -> Tuple[Dict, torch.Tensor]:
    """P islands of a full optimisation on `device`, drawing from `gen`.

    Returns (island-stacked states ``[P, ...]``, per-island history
    ``[n_gens, P, 2]`` on the device).  P = 1 is `evolve.run` bit for bit.
    Over a process group (`group`, or the default one when it is
    initialised and its size divides P) every rank passes a `gen` seeded alike,
    builds the same P island generators, evolves its own P / W islands and
    returns the whole result, the single-process run's.  A `mesh` must
    have an "islands" dim whose size divides P; its process group is the
    `group`.  Without either, `shard="auto"` uses the default group as
    `_process_group` says and `shard=False` keeps every island in this
    process.
    """
    if mesh is not None:
        names = mesh.mesh_dim_names or ()
        if AXIS not in names or islands.n_islands % collectives.axis_size(mesh, AXIS):
            raise ValueError(f"mesh must carry an {AXIS!r} axis dividing n_islands="
                             f"{islands.n_islands}; got axes {names} shape {tuple(mesh.shape)}")
        group = collectives.group_of(mesh, AXIS)
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator is on {gen.device}, run on {dev}")
    cfg = hyper.tracify(cfg, dev)
    static_key, traced = hyper.split_fields(cfg)
    gens = island_generators(gen, islands.n_islands)
    if group is not None or shard == "auto":
        group = _process_group(islands.n_islands, group)
    if group is None:
        state = member_init(problem, algo, static_key, islands, traced, gens)
        return round_impl(problem, algo, islands, cfg, state, gens, n_gens, 0)
    ring = Ring(group, dev)
    per = islands.n_islands // ring.size
    mine = gens[ring.rank * per:(ring.rank + 1) * per]
    state = member_init(problem, algo, static_key,
                        dataclasses.replace(islands, n_islands=per), traced, mine)
    state, hist = round_impl(problem, algo, islands, cfg, state, mine, n_gens, 0, ring)
    return ring.all_gather(state), ring.all_gather(hist, dim=1)
