"""Placement-as-a-service: slot-based continuous batching of placement jobs.

Port of `repro/serve/placement_service.py`, the slot pool.  A fixed pool
of `n_slots` *job slots* shares one batched step for a single
device/problem:

  submit()  -> pick a free slot, initialise the job's algorithm state and
               write it into the slot's rows of the pool's tensors (its
               own seed + float hyperparameters)
  step()    -> one batched step advances every slot by `gens_per_step`
               generations: per generation, the slots' draws are made
               per slot and one `torch.func.vmap` of the algorithm's pure
               `step_body` runs over all of them (`portfolio.member_round`),
               so each placement kernel launches once per generation
               whatever the number of slots or active jobs
  finished  -> jobs whose generation budget is exhausted -- or whose
               combined metric hit their `target` -- are harvested (best
               genotype + objectives), the slot is freed

Jobs are reproducible: every draw comes from a generator derived on the
host from the *job's* seed and its own generation counter
(`job_generators`), never from a shared stream, a slot index or the
pool's size, so a job's result is a pure function of (config, seed,
budget, gens_per_step, init_state) -- independent of co-tenant jobs,
cancellations, `grow()` and admission timing.  On the CPU that holds bit
for bit; on the card a batched reduction may round otherwise than a lone
slot's.

Shapes are static: jobs come and go by overwriting slot *contents* (state
rows, hyperparameter rows, mask entries), never shapes, so a step runs
the same ops at one slot count whatever its occupancy (`step_compiles`
counts the slot counts stepped).  Vacant slots keep evolving whatever
state they hold, from their stale (seed, generation); their work is
masked out of accounting and their results are never read.

Static config fields (pop_size, perm_swaps, reduced, fused, ...) are
fixed per pool at construction; a job whose config disagrees on them
needs a pool of its own.  Warm starts: `submit(init_state=...)` seeds a
job from a genotype (`core.warmstart`).  Islands:
`PlacementService(..., islands=IslandConfig(P, migrate_every))` makes
every slot hold P island sub-populations (`islands.pool_round`); P == 1
keeps the plain pool bit for bit.

`prewarm_size(n)` runs the batched step at a future slot count on
throwaway state, off the stepping thread (`serve.prewarm`), so a later
`grow(n)` finds its kernels built and its allocations cached.  Every entry
point runs with the pool's card as the calling thread's current device:
the scheduler's front-end and prewarm threads issue CUDA work too, all on
the default stream.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import convert, hyper, portfolio, warmstart
from repro_torch.core import genotype as G
from repro_torch.core import islands as islands_mod
from repro_torch.core import objectives as O
from repro_torch.core.islands import IslandConfig
from repro_torch.fpga.netlist import Problem
from repro_torch.runtime import compile_cache, telemetry
from repro_torch.serve import api, tracing
from repro_torch.serve.api import JobRequest, ServiceStats

# registry-global instruments, under the reference's names
_REG = telemetry.registry()
_M_STEPS = _REG.counter(
    "repro_service_steps_total", "Batched service step() calls")
_M_GENS = _REG.counter(
    "repro_useful_gens_total", "Active-slot generations actually served")
_M_HARVESTED = _REG.counter(
    "repro_jobs_harvested_total", "Jobs harvested at budget/target")
_M_CANCELLED = _REG.counter(
    "repro_jobs_cancelled_total", "In-flight slots freed early by cancel()")
_M_STEP_MS = _REG.histogram(
    "repro_service_step_ms", "Wall ms per batched service step",
    buckets=telemetry.DEFAULT_LATENCY_BUCKETS_MS)
_M_BEST = _REG.gauge(
    "repro_pool_best_metric",
    "Best combined metric across a pool's active slots (live convergence)")

# per-job convergence ring depth: (gens, metric) pairs at step boundaries
CONVERGENCE_RING = 256
# tail length surfaced through stats() (the full ring stays on the job)
CONVERGENCE_TAIL = 8

_POOL_COUNTER = itertools.count(1)
_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """A bijection on 64-bit words that scatters neighbouring inputs."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def job_generators(seed: int, g: Optional[int], n_islands: int,
                   device) -> List[torch.Generator]:
    """The generators a job draws from on `device`, derived on the host:
    its init (`g` None) from its seed alone; the step that starts at
    generation `g` from (seed, g) -- the counterpart of the reference's
    ``fold_in(PRNGKey(seed), g)``.  One generator per island; with one
    island, the job's own stream.

    Each generator is seeded with splitmix64 of the word ``(seed mod 2**32)
    * 2**32 + tag_g * 2**8 + tag_i``: ``tag_g`` is 0 at init, else g + 1;
    ``tag_i`` is 0 for the job's own stream, else i + 1 for island i of
    P > 1.  The word is one to one in (seed, g, island) for
    g < 2**24 - 1 and P < 2**8, and splitmix64 is a bijection, so no two
    of these streams share a seed.
    """
    tag_g = 0 if g is None else int(g) + 1
    if tag_g >= 1 << 24 or n_islands >= 1 << 8:
        raise ValueError(f"generation {g} or {n_islands} islands out of the streams' range")
    word = ((int(seed) & 0xFFFFFFFF) << 32) | (tag_g << 8)
    tags = [0] if n_islands == 1 else range(1, n_islands + 1)
    return [torch.Generator(device=device).manual_seed(_splitmix64(word | t)) for t in tags]


def make_job_specs(n: int, pop_size: int, budget: int, seed: int = 0,
                   eta_range=(5.0, 25.0), mut_range=(0.05, 0.3),
                   fused: bool = False) -> List[Dict]:
    """Synthetic placement workload: n NSGA-II jobs with jittered float
    hyperparameters, the reference's draws from numpy's `default_rng`.

    `fused=True` routes every job's evaluation through the fused kernels;
    it is a static config field, so fused and unfused jobs belong to
    different pools."""
    from repro_torch.core import nsga2
    rng = np.random.default_rng(seed)
    return [dict(seed=seed * 10_000 + i, budget=budget,
                 cfg=nsga2.NSGA2Config(
                     pop_size=pop_size,
                     sbx_eta=float(rng.uniform(*eta_range)),
                     real_mut_prob=float(rng.uniform(*mut_range)),
                     fused=fused))
            for i in range(n)]


@dataclasses.dataclass
class PlacementJob:
    jid: int
    cfg: Any                       # full config (floats may differ per job)
    seed: int
    budget: int                    # generation budget
    target: Optional[float]        # finish early if combined metric <= this
    slot: int = -1
    gens: int = 0                  # generations run so far
    warm: bool = False             # seeded via submit(init_state=...)
    done: bool = False
    cancelled: bool = False        # slot freed early by cancel()
    best_objs: Optional[np.ndarray] = None   # [2] = (wl^2, max bbox)
    metric: float = float("inf")             # combined metric of best_objs
    genotype: Any = None                     # best full genotype at harvest (numpy)
    trace_id: Optional[str] = None           # observability only
    # per-step convergence ring: (gens, metric) recorded at every step
    # boundary the job was alive for
    history: Any = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=CONVERGENCE_RING))


class PlacementService:
    """Continuous-batching placement engine for one `Problem` on one device."""

    def __init__(self, problem: Problem, base_cfg, algo: str = "nsga2",
                 n_slots: int = 8, gens_per_step: int = 4, seed: int = 0,
                 islands: Optional[IslandConfig] = None,
                 label: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.problem, self.algo = problem, algo
        self.n_slots, self.gens_per_step = n_slots, gens_per_step
        # observability-only pool name (metric label / span attr)
        self.label = label or f"pool{next(_POOL_COUNTER)}/{algo}"
        if tracing.enabled():
            tracing.tracer().begin("pool.build", pool=self.label,
                                   n_slots=n_slots, algo=algo)
        # island topology is static pool identity, like pop_size; P == 1
        # keeps the plain pool's programs bit for bit
        self.islands = islands or IslandConfig()
        self.static_key, base_traced = hyper.split_config(base_cfg)
        self.base_cfg = base_cfg
        self._base_traced = dict(base_traced)   # grow() fills new slots
        self.size_history: List[int] = [n_slots]
        # host mirror of the per-slot float hyperparameters
        self.traced = {k: np.full(n_slots, v, np.float32)
                       for k, v in base_traced.items()}
        self.active = np.zeros(n_slots, bool)
        self.slot_job: List[Optional[PlacementJob]] = [None] * n_slots
        # per-slot (seed, generation counter): the step's generators derive
        # from these alone (`job_generators`)
        self.slot_seed = np.zeros(n_slots, np.uint32)
        self.slot_gens = np.zeros(n_slots, np.int32)
        self.next_jid = 0
        # the throwaway fill of vacant slots draws from the pool's own stream
        self._fill_gen = torch.Generator(device=self.device).manual_seed(seed)
        self.total_steps = 0
        self.useful_gens = 0       # active-slot generations actually served
        self.jobs_cancelled = 0    # slots freed early via cancel()
        # kernel builds (on a first launch) on the thread calling
        # submit/step/grow
        self._meter = compile_cache.meter()
        self.blocking_compiles = 0
        self.blocking_compile_secs = 0.0
        # builds seen on the thread running prewarm_size (serve.prewarm)
        self.prewarm_compiles = 0
        self.prewarm_compile_secs = 0.0
        self._prewarmed_sizes = set()
        self._stepped_sizes = set()    # slot counts stepped (`step_compiles`)
        self._created_at = time.perf_counter()
        self._first_gen_ms: Optional[float] = None
        self._seed_rows = warmstart.seed_rows(algo, self.static_key)
        # per-pool step-latency histogram (the registry-global one
        # aggregates across pools; this instance feeds stats())
        self._step_hist = telemetry.Histogram(
            "step_ms", buckets=telemetry.DEFAULT_LATENCY_BUCKETS_MS)
        with self._blocking():
            self.states = self._fill(n_slots, self._fill_gen)
        if tracing.enabled():
            tracing.tracer().end("pool.build", pool=self.label,
                                 n_slots=n_slots, algo=algo)

    def _on_device(self):
        """The pool's card as the calling thread's current device."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def _blocking(self):
        """Attribute builds on the calling thread to this pool's blocking
        counters (the stepping loop's build latency)."""
        with self._on_device(), self._meter.measure() as m:
            yield
        self.blocking_compiles += m.compiles
        self.blocking_compile_secs += m.secs

    def _fill(self, n: int, fill_gen: torch.Generator) -> Dict:
        """Throwaway states for `n` vacant slots, at the base config, drawn
        from `fill_gen`."""
        traced = {k: torch.full((n,), v, dtype=torch.float32, device=self.device)
                  for k, v in self._base_traced.items()}
        gens = portfolio.member_generators(n, None, fill_gen, self.device)
        icfg = self.islands
        if not icfg.active:
            return portfolio.member_init(self.problem, self.algo, self.static_key,
                                         traced, gens)
        return portfolio.stack([
            islands_mod.member_init(self.problem, self.algo, self.static_key, icfg,
                                    {k: v[i] for k, v in traced.items()},
                                    islands_mod.island_generators(g, icfg.n_islands))
            for i, g in enumerate(gens)])

    # ------------------------------------------------------------- admit

    def submit(self, cfg=None, seed: Optional[int] = None, budget: int = 64,
               target: Optional[float] = None, init_state=None,
               jitter: float = 0.15,
               sigma_shrink: float = 0.25) -> Optional[int]:
        """Admit one job; returns its jid, or None if the pool is full.

        The canonical form is `submit(request)` with a `serve.api.JobRequest`
        as the only argument; the kwarg form is a deprecated shim that
        builds the same request.

        Budgets are quantized UP to the pool's `gens_per_step` granularity;
        `job.budget` records the quantized value, which the job then runs
        exactly.  `init_state` warm-starts the job from a seed genotype on
        *this* pool's problem (`core.warmstart`): NSGA-II/GA populations
        keep the seed at row 0 and fill the rest with `jitter`-scaled
        copies, CMA-ES starts its mean at the seed with `sigma0 *
        sigma_shrink`, SA starts its chain there.
        """
        if isinstance(cfg, JobRequest):
            request = cfg
        else:
            request = api.deprecated_kwargs_request(
                "PlacementService", cfg=cfg, seed=seed, budget=budget,
                target=target, init_state=init_state, jitter=jitter,
                sigma_shrink=sigma_shrink, algo=self.algo)
        return self.submit_request(request)

    def submit_request(self, request: JobRequest) -> Optional[int]:
        """`submit()` on the unified request type: admit one job described
        by a `serve.api.JobRequest`; returns its jid, or None when the pool
        is full.  A request whose routing fields disagree with this pool
        raises; nothing re-routes it."""
        if request.algo is not None and request.algo != self.algo:
            raise ValueError(
                f"request.algo={request.algo!r} does not match this "
                f"pool's algo={self.algo!r}; route via PlacementScheduler")
        if (request.islands is not None
                and request.islands != self.islands):
            raise ValueError(
                f"request.islands={request.islands} does not match this "
                f"pool's islands={self.islands}; route via "
                "PlacementScheduler")
        if (request.gens_per_step is not None
                and request.gens_per_step != self.gens_per_step):
            raise ValueError(
                f"request.gens_per_step={request.gens_per_step} does not "
                f"match this pool's gens_per_step={self.gens_per_step}")
        cfg = request.resolved_cfg(self.base_cfg)
        seed, target = request.seed, request.target
        budget = -(-request.budget // self.gens_per_step) \
            * self.gens_per_step
        static_key, traced = hyper.split_config(cfg)
        if static_key != self.static_key:
            raise ValueError(
                "job config disagrees with the pool's static fields "
                f"({static_key[1]} vs {self.static_key[1]}); "
                "open a separate pool for it")
        free = np.where(~self.active)[0]
        if len(free) == 0:
            return None
        slot = int(free[0])
        seed = self.next_jid if seed is None else seed
        trace_id = request.trace_id
        if tracing.enabled() and trace_id is None:
            # direct pool submission: this layer is the outermost, so it
            # mints and announces
            trace_id = tracing.new_trace_id()
            tracing.tracer().instant("job.submit", trace_id,
                                     algo=self.algo, budget=budget)
        job = PlacementJob(self.next_jid, cfg, seed, budget, target,
                           slot=slot, warm=request.init_state is not None,
                           trace_id=trace_id)
        self.next_jid += 1
        if tracing.enabled():
            tracing.tracer().instant("job.admitted", trace_id,
                                     slot=slot, pool=self.label,
                                     warm=job.warm)
        with self._blocking():
            one = self._init_job(traced, seed, request)
        # the job's rows of the pool's tensors, written out of place: the
        # pool's earlier tensors (and whatever still reads them) stay as
        # they were
        idx = torch.tensor([slot], device=self.device)
        self.states = G.tree_map(lambda pool, a: pool.index_copy(0, idx, a[None]),
                                 self.states, one)
        for k, v in traced.items():
            self.traced[k][slot] = v
        self._traced_cache = None          # hyperparameter row changed
        self.slot_seed[slot] = np.uint32(seed & 0xFFFFFFFF)
        self.slot_gens[slot] = 0
        self.active[slot] = True
        self.slot_job[slot] = job
        return job.jid

    def _init_job(self, traced: Dict[str, float], seed: int,
                  request: JobRequest) -> Dict:
        """One job's initial state (islands: ``[P, ...]``), drawn from
        `job_generators(seed, None, P)`."""
        dev, icfg = self.device, self.islands
        tr = {k: torch.tensor(v, dtype=torch.float32, device=dev) for k, v in traced.items()}
        gens = job_generators(seed, None, icfg.n_islands, dev)
        gen = gens[0]
        if request.init_state is None:
            if icfg.active:
                return islands_mod.member_init(self.problem, self.algo, self.static_key,
                                               icfg, tr, gens)
            return portfolio.member(portfolio.member_init(
                self.problem, self.algo, self.static_key,
                {k: v[None] for k, v in tr.items()}, [gen]), 0)
        pop, fresh = warmstart.canonicalize(self.problem, request.init_state,
                                            self._seed_rows, device=dev)
        jitter = torch.tensor(request.jitter, dtype=torch.float32, device=dev)
        shrink = torch.tensor(request.sigma_shrink, dtype=torch.float32, device=dev)
        if icfg.active:
            return islands_mod.member_warm_init(self.problem, self.algo, self.static_key,
                                                icfg, tr, pop, fresh, jitter, shrink, gens)
        return warmstart.member_warm_init(self.problem, self.algo, self.static_key, tr,
                                          pop, fresh, jitter, shrink, gen)

    # ------------------------------------------------------------- cancel

    def cancel(self, jid: int) -> bool:
        """Cancel an in-flight job: its slot is freed immediately (the
        vacant slot keeps evolving garbage that is never read) and is
        reusable by the next `submit()`.  Call between `step()`s.  Returns
        False when the jid is not in flight.  Cancellation cannot perturb
        co-tenant jobs: their draws depend only on their own (seed, gens)."""
        for slot in np.where(self.active)[0]:
            job = self.slot_job[slot]
            if job is not None and job.jid == jid:
                job.cancelled = True
                self.active[slot] = False
                self.slot_job[slot] = None
                self.jobs_cancelled += 1
                _M_CANCELLED.inc()
                if tracing.enabled():
                    tracing.tracer().instant(
                        "job.cancelled", job.trace_id,
                        slot=int(slot), gens=job.gens)
                return True
        return False

    def job(self, jid: int) -> Optional[PlacementJob]:
        """The in-flight job with this jid (None once harvested/cancelled)."""
        for slot in np.where(self.active)[0]:
            job = self.slot_job[slot]
            if job is not None and job.jid == jid:
                return job
        return None

    def inflight(self) -> List[PlacementJob]:
        """Snapshot of the jobs currently occupying slots."""
        return [self.slot_job[slot] for slot in np.where(self.active)[0]
                if self.slot_job[slot] is not None]

    # -------------------------------------------------------------- grow

    def grow(self, n_slots: int) -> None:
        """Rebuild the pool at a larger slot count, carrying every live
        slot's state over.  In-flight jobs keep their slot index, rows,
        seeds and generation counters, and a job's draws depend only on
        (seed, gens), so results stay identical to a never-grown pool.
        New slots arrive vacant, filled with throwaway states."""
        if n_slots <= self.n_slots:
            raise ValueError(
                f"grow() only grows: {n_slots} <= current {self.n_slots}")
        if tracing.enabled():
            tracing.tracer().begin("pool.grow", pool=self.label,
                                   from_slots=self.n_slots,
                                   to_slots=n_slots)
        extra = n_slots - self.n_slots
        with self._blocking():
            fill = self._fill(extra, self._fill_gen)
            self.states = G.tree_map(lambda a, b: torch.cat([a, b]), self.states, fill)
        self.traced = {
            k: np.concatenate(
                [v, np.full(extra, self._base_traced[k], np.float32)])
            for k, v in self.traced.items()}
        self._traced_cache = None
        self.active = np.concatenate([self.active, np.zeros(extra, bool)])
        self.slot_job.extend([None] * extra)
        self.slot_seed = np.concatenate(
            [self.slot_seed, np.zeros(extra, np.uint32)])
        self.slot_gens = np.concatenate(
            [self.slot_gens, np.zeros(extra, np.int32)])
        self.n_slots = n_slots
        self.size_history.append(n_slots)
        if tracing.enabled():
            tracing.tracer().end("pool.grow", pool=self.label,
                                 to_slots=n_slots)

    def prewarm_size(self, n_slots: int) -> bool:
        """Run the pool's batched step at a future `grow(n_slots)`'s width,
        ahead of time: a fill of the base hyperparameters at `n_slots`
        slots, then one `step()`'s worth of generations on it, from fresh
        generators.

        The state is throwaway: the pool's tensors, host mirrors and
        generators are never read or written, so this may run on another
        thread (`serve.prewarm.Prewarmer`) while the pool keeps stepping.
        What it leaves behind is what a first step at the new width would
        otherwise pay in the stepping loop: the kernel builds, if none is
        built yet, and the caching allocator's blocks at that width.  Builds
        seen on the calling thread land in the prewarm counters, not the
        blocking ones.  Returns True when work was done, False for an
        already-prewarmed or non-growing size.
        """
        if n_slots <= self.n_slots or n_slots in self._prewarmed_sizes:
            return False
        if tracing.enabled():
            tracing.tracer().begin("pool.prewarm_size", pool=self.label,
                                   n_slots=n_slots)
        dev = self.device
        with self._on_device(), self._meter.measure() as m:
            states = self._fill(n_slots, torch.Generator(device=dev).manual_seed(n_slots))
            traced = {k: torch.tensor(np.full(n_slots, v, np.float32), device=dev)
                      for k, v in self._base_traced.items()}
            _, best = self._round(traced, states, np.zeros(n_slots, np.uint32),
                                  np.zeros(n_slots, np.int32))
            O.combined_metric(best.cpu().numpy())
        self._prewarmed_sizes.add(n_slots)
        self.prewarm_compiles += m.compiles
        self.prewarm_compile_secs += m.secs
        if tracing.enabled():
            tracing.tracer().end("pool.prewarm_size", pool=self.label,
                                 n_slots=n_slots, compiles=m.compiles)
        return True

    # -------------------------------------------------------------- step

    _traced_cache: Optional[Dict[str, torch.Tensor]] = None

    def _traced_dev(self) -> Dict[str, torch.Tensor]:
        """Device copy of the per-slot hyperparameters, uploaded again only
        when submit() or grow() changed a row.  `torch.tensor` copies, so
        the numpy mirrors that submit() mutates in place are never
        aliased."""
        if self._traced_cache is None:
            self._traced_cache = {k: torch.tensor(v, device=self.device)
                                  for k, v in self.traced.items()}
        return self._traced_cache

    def _round(self, traced: Dict[str, torch.Tensor], states: Dict, slot_seed: np.ndarray,
               slot_gens: np.ndarray):
        """`gens_per_step` batched generations of every slot of `states`,
        slot i drawing from `job_generators(slot_seed[i], slot_gens[i])`;
        returns (states, each slot's best objectives [S, 2] on the device)."""
        problem, algo, sk, icfg = self.problem, self.algo, self.static_key, self.islands
        gens = [job_generators(s, g, icfg.n_islands, self.device)
                for s, g in zip(slot_seed.tolist(), slot_gens.tolist())]
        if icfg.active:
            # the slots' generation counts double as their migration
            # phases: boundaries count each slot's global generations
            return islands_mod.pool_round(problem, algo, sk, icfg, self.gens_per_step, traced,
                                          states, gens, torch.tensor(slot_gens, device=self.device))
        return portfolio.member_round(problem, algo, sk, self.gens_per_step, traced, states,
                                      [g for (g,) in gens])

    def step(self) -> List[PlacementJob]:
        """Advance every slot `gens_per_step` generations in one batched
        step; harvest and return newly finished jobs.  The step reads the
        slots' best objectives [S, 2] on the host once."""
        if not self.active.any():
            return []
        n_active = int(self.active.sum())
        traced_on = tracing.enabled()
        if traced_on:
            tracing.tracer().begin("pool.step", pool=self.label,
                                   active=n_active)
        t_step = time.perf_counter()
        with self._blocking():
            self.states, best = self._round(self._traced_dev(), self.states,
                                            self.slot_seed, self.slot_gens)
        self._stepped_sizes.add(self.n_slots)
        self.total_steps += 1
        self.useful_gens += n_active * self.gens_per_step
        self.slot_gens += self.gens_per_step
        best = best.cpu().numpy().copy()
        metric = O.combined_metric(best)
        if self._first_gen_ms is None:
            # the pool's cold-start latency: construction + first submit +
            # first step, builds included
            self._first_gen_ms = (time.perf_counter()
                                  - self._created_at) * 1e3
        finished = []
        best_active = float("inf")
        for slot in np.where(self.active)[0]:
            job = self.slot_job[slot]
            job.gens += self.gens_per_step
            job.best_objs = best[slot]
            job.metric = float(metric[slot])
            job.history.append((job.gens, job.metric))
            best_active = min(best_active, job.metric)
            hit_target = job.target is not None and job.metric <= job.target
            if job.gens >= job.budget or hit_target:
                self._harvest(slot, job)
                finished.append(job)
                self.active[slot] = False
                self.slot_job[slot] = None
                _M_HARVESTED.inc()
                if traced_on:
                    tracing.tracer().instant(
                        "job.harvested", job.trace_id, slot=int(slot),
                        gens=job.gens, metric=job.metric,
                        hit_target=hit_target)
        step_ms = (time.perf_counter() - t_step) * 1e3
        self._step_hist.observe(step_ms)
        _M_STEP_MS.observe(step_ms)
        _M_STEPS.inc()
        _M_GENS.inc(int(self.active.sum() + len(finished))
                    * self.gens_per_step)
        if best_active != float("inf"):
            _M_BEST.set(best_active, pool=self.label)
        if traced_on:
            tracing.tracer().end("pool.step", pool=self.label,
                                 harvested=len(finished))
        return finished

    def _harvest(self, slot: int, job: PlacementJob) -> None:
        """The slot's best full genotype and objectives, copied to the host."""
        state = portfolio.member(self.states, slot)
        if self.islands.active:
            g, objs = islands_mod.best_genotype(self.problem, self.algo,
                                                state, job.cfg)
        else:
            g, objs = portfolio.best_genotype(self.problem, self.algo,
                                              state, job.cfg)
        job.genotype = convert.genotype_to_numpy(g)
        job.best_objs = objs.cpu().numpy().copy()
        job.metric = float(O.combined_metric(job.best_objs))
        job.done = True

    # ------------------------------------------------------- conveniences

    @property
    def step_compiles(self) -> int:
        """Distinct slot counts stepped: 1 for a fixed-size pool, at most
        `len(size_history)` after `grow()`.  Eager PyTorch builds no step
        program; a step runs the same ops at one slot count whatever jobs
        come and go (held by the op-count test)."""
        return len(self._stepped_sizes)

    def run_jobs(self, specs: List[Dict]) -> List[PlacementJob]:
        """Rolling admission: submit specs as slots free up, step until
        every job finishes.  Each spec is a `serve.api.JobRequest` or a
        dict of its fields (the `make_job_specs` shape)."""
        queue = [s if isinstance(s, JobRequest)
                 else JobRequest(algo=self.algo, **s) for s in specs]
        done: List[PlacementJob] = []
        while queue or self.active.any():
            while queue:
                if self.submit_request(queue[0]) is None:
                    break
                queue.pop(0)
            done.extend(self.step())
        return done

    def stats(self) -> ServiceStats:
        return api.stats_payload(
            n_slots=self.n_slots,
            gens_per_step=self.gens_per_step,
            steps=self.total_steps,
            useful_gens=self.useful_gens,
            step_compiles=self.step_compiles,
            sizes=list(self.size_history),
            n_islands=self.islands.n_islands,
            migrate_every=self.islands.migrate_every,
            jobs_cancelled=self.jobs_cancelled,
            blocking_compiles=self.blocking_compiles,
            blocking_compile_secs=round(self.blocking_compile_secs, 3),
            prewarm_compiles=self.prewarm_compiles,
            prewarm_compile_secs=round(self.prewarm_compile_secs, 3),
            prewarmed_sizes=sorted(self._prewarmed_sizes),
            time_to_first_gen_ms=(
                None if self._first_gen_ms is None
                else round(self._first_gen_ms, 1)),
            compiles_total=self._meter.compiles,
            recompiles_total=self._meter.recompiles,
            compile_secs_total=round(self._meter.compile_secs, 3),
            persistent_cache_dir=compile_cache.enabled_dir(),
            step_ms_hist=self._step_hist.to_dict(),
            convergence={
                job.jid: list(job.history)[-CONVERGENCE_TAIL:]
                for job in self.inflight()},
            tracing_enabled=tracing.enabled(),
        )
