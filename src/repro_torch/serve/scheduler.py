"""Placement control plane: signature cache, stepping policies, autoscaling.

`PlacementService` pools are deliberately rigid: static config fields
(pop_size, perm_swaps, reduced, schedule, ...), the algorithm, and the
device problem are baked into each pool's compiled programs, which is what
keeps its batched step recompile-free.  The scheduler is the layer above
that restores flexibility without giving that up -- and, since PR 3, the
layer where cross-job knowledge lives:

  * **routing** -- jobs are routed by *pool signature* (device, algo,
    static config fields, gens_per_step); a `PlacementService` pool is
    created lazily the first time a signature appears, and jobs that find
    their pool full wait in a per-pool FIFO, admitting as slots free up,
  * **champion cache** (`serve.champion_store`) -- every harvested result
    writes its champion back under the problem's content signature
    (`fpga.netlist.Problem.signature`).  On `submit()` the store is
    consulted first: an exact-signature entry already meeting the job's
    `target` is served *instantly* -- a finished job, zero generations, no
    slot burned -- and otherwise the best exact-or-sibling champion is
    auto-migrated (`core.transfer.auto_migrate`) into the job's
    `init_state`, so the Table II transfer speedup happens inside the
    serving layer instead of in caller code,
  * **stepping policy** (`serve.policy`) -- each `step()` advances exactly
    one pool's batched step; *which* pool is pluggable: `round_robin`
    (default, PR 2 behaviour), `priority` (highest job priority first), or
    `deadline` (earliest deadline first over pending + inflight),
  * **autoscaling** -- with `autoscale=True`, a pool whose FIFO depth
    crosses `autoscale_threshold` is rebuilt at the next size of a
    geometric slot ladder (`PlacementService.grow`: live slots carry over;
    one step recompile per ladder size, never per job, sizes capped at
    `max_slots`).

Each pool still compiles its step once per slot-count size; per-job
results remain pure functions of (config, seed, budget, init_state) --
identical to running the same job on a standalone service -- because
pools never share PRNG streams and slot state is per-job (see
`placement_service`).  The cache changes *which* init_state a job gets,
never the result of a given spec; with no store attached the scheduler is
bitwise identical to the PR 2 router.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import resolve_device
from repro_torch.core import hyper
from repro_torch.core.islands import IslandConfig
from repro_torch.fpga.netlist import Problem
from repro_torch.runtime import telemetry
from repro_torch.serve import api, tracing
from repro_torch.serve import policy as P
from repro_torch.serve.api import (FleetStats, JobRequest, JobStatus,
                             ProgressUpdate)
from repro_torch.serve.champion_store import ChampionStore
from repro_torch.serve.placement_service import (CONVERGENCE_TAIL, PlacementJob,
                                           PlacementService)
from repro_torch.serve.prewarm import Prewarmer

_REG = telemetry.registry()
_M_SUBMITTED = _REG.counter(
    "repro_jobs_submitted_total", "Jobs submitted to the scheduler")
_M_CACHE_HITS = _REG.counter(
    "repro_jobs_cache_hits_total",
    "Jobs answered instantly from the champion store")
_M_FAILED = _REG.counter(
    "repro_jobs_failed_total", "Jobs surfaced as failed")
_M_CANCELLED_PENDING = _REG.counter(
    "repro_jobs_cancelled_pending_total",
    "Pending (never-admitted) jobs cancelled out of the queue")
_M_LATENCY = _REG.histogram(
    "repro_job_latency_ms", "Submit -> terminal wall ms, per layer",
    buckets=telemetry.DEFAULT_LATENCY_BUCKETS_MS)

# (device, algo, static config fields, gens_per_step, island config) --
# everything that picks a compiled program, so each pool compiles once
PoolKey = Tuple[str, str, hyper.StaticKey, int, IslandConfig]


def _default_cfg(algo: str, pop_size: Optional[int]):
    """Default config for a store-predicted pool (prediction records the
    dominant static field, pop_size; float hyperparameters don't matter --
    they are traced, not part of the compiled-program signature)."""
    from repro_torch.core import annealing, cmaes, ga, nsga2
    cls = {"nsga2": nsga2.NSGA2Config, "ga": ga.GAConfig,
           "cmaes": cmaes.CMAESConfig, "sa": annealing.SAConfig}[algo]
    fields = {f.name for f in dataclasses.fields(cls)}
    if pop_size and "pop_size" in fields:
        return cls(pop_size=int(pop_size))
    return cls()


@dataclasses.dataclass
class FleetJob:
    """A scheduler-level job: the request, routing info, and the pool job
    once finished.  `status` is the unified lifecycle view
    (`serve.api.JobStatus`); `.done`/`.failed` survive from the PR 3 API
    (new code should read `status` -- or hold a `serve.api.JobHandle`
    from the async front-end instead of a raw FleetJob)."""
    jid: int                       # scheduler-global id
    device: str
    algo: str
    pool_key: PoolKey
    request: JobRequest            # the unified job description
    priority: float = 0.0          # higher = more urgent (priority policy)
    deadline: Optional[float] = None   # smaller = sooner (deadline policy)
    pool_jid: Optional[int] = None  # set at admission
    result: Optional[PlacementJob] = None
    cached: bool = False           # served straight from the champion store
    warm_from_cache: bool = False  # init_state injected by the store
    cancelled: bool = False        # cancelled before completion
    error: Optional[str] = None    # last admission-failure note (re-queued)
    attempts: int = 0              # failed admission attempts so far
    t_submit: float = 0.0          # monotonic submit time (latency hist);
    #                                zeroed once the terminal latency is
    #                                observed so a job records exactly once

    @property
    def trace_id(self) -> Optional[str]:
        return self.request.trace_id

    @property
    def status(self) -> JobStatus:
        if self.cancelled:
            return JobStatus.CANCELLED
        if self.result is not None and self.result.done:
            return JobStatus.DONE
        if self.failed:
            return JobStatus.FAILED
        if self.pool_jid is not None:
            return JobStatus.RUNNING
        return JobStatus.QUEUED

    @property
    def spec(self) -> Dict[str, Any]:
        """Deprecated PR 3-8 view of the request as submit() kwargs."""
        return {"cfg": self.request.cfg, "seed": self.request.seed,
                "budget": self.request.budget,
                "target": self.request.target,
                "init_state": self.request.init_state,
                "jitter": self.request.jitter,
                "sigma_shrink": self.request.sigma_shrink}

    @property
    def done(self) -> bool:
        return self.result is not None and self.result.done

    @property
    def failed(self) -> bool:
        """Gave up after repeated admission failures (never silently
        dropped: the error note says why)."""
        return self.result is None and self.error is not None \
            and self.attempts >= PlacementScheduler.ADMIT_RETRIES


class PlacementScheduler:
    """Routes placement jobs across lazily created per-signature pools.

    `store=ChampionStore(...)` turns on the champion cache, `policy=`
    selects the stepping policy ("round_robin" / "priority" / "deadline"
    or a `serve.policy.SteppingPolicy` instance), and `autoscale=True`
    lets queue depth grow pools along a geometric slot ladder.
    """

    # admission attempts per job before it is surfaced as failed (attempt
    # 1 = the original; each re-queue carries an error note)
    ADMIT_RETRIES = 3

    def __init__(self, problems: Optional[Dict[str, Problem]] = None,
                 n_slots: int = 4, gens_per_step: int = 4, seed: int = 0,
                 policy="round_robin", store: Optional[ChampionStore] = None,
                 autoscale: bool = False,
                 autoscale_threshold: Optional[int] = None,
                 max_slots: Optional[int] = None,
                 prewarm: bool = False,
                 device="cuda",
                 prewarmer: Optional[Prewarmer] = None):
        self.device = resolve_device(device)   # every pool's torch device
        self.n_slots, self.gens_per_step = n_slots, gens_per_step
        self.seed = seed
        self.policy = P.get_policy(policy)
        self.store = store
        self.autoscale = autoscale
        # `prewarm=True` attaches a background AOT compiler
        # (`serve.prewarm.Prewarmer`): predicted / explicitly requested
        # pools build off-thread and `grow()` sizes pre-compile, so the
        # stepping loop stops blocking on XLA
        self.prewarmer = prewarmer if prewarmer is not None else (
            Prewarmer() if prewarm else None)
        # default trigger: a full extra wave of jobs waiting behind the pool
        self.autoscale_threshold = (n_slots if autoscale_threshold is None
                                    else autoscale_threshold)
        self.max_slots = 4 * n_slots if max_slots is None else max_slots
        self.autoscale_events: List[Tuple[str, int, int]] = []
        self._problems: Dict[str, Problem] = dict(problems or {})
        self._pools: Dict[PoolKey, PlacementService] = {}
        self._pending: Dict[PoolKey, List[FleetJob]] = {}
        self._inflight: Dict[Tuple[PoolKey, int], FleetJob] = {}
        self._rotation: List[PoolKey] = []     # stable pool order
        self._cached_done: List[FleetJob] = []  # instant cache hits to drain
        self._failed: List[FleetJob] = []      # gave up admitting; drained
        self.next_jid = 0
        self.jobs: Dict[int, FleetJob] = {}
        # fleet-level submit -> terminal latency (stats(); the registry
        # histogram aggregates across scheduler instances under a layer
        # label)
        self._latency_hist = telemetry.Histogram(
            "job_latency_ms", buckets=telemetry.DEFAULT_LATENCY_BUCKETS_MS)

    # ------------------------------------------------------------ routing

    def problem(self, device_name: str) -> Problem:
        """The (cached) placement problem for a device name."""
        if device_name not in self._problems:
            from repro_torch.fpga import device, netlist
            self._problems[device_name] = netlist.make_problem(
                device.get_device(device_name))
        return self._problems[device_name]

    def pool_key(self, device_name: str, algo: str, cfg,
                 gens_per_step: Optional[int] = None,
                 islands: Optional[IslandConfig] = None) -> PoolKey:
        static_key, _ = hyper.split_config(cfg)
        return (device_name, algo, static_key,
                gens_per_step or self.gens_per_step,
                islands or IslandConfig())

    def _builder(self, key: PoolKey, cfg):
        """The one true pool constructor for a signature: the synchronous
        path and the background prewarm build share it, which is what
        makes an adopted pool bitwise identical to a cold one (same
        constructor arguments, same seed)."""
        device_name, algo, _static, gps, icfg = key

        def build() -> PlacementService:
            return PlacementService(
                self.problem(device_name), cfg, algo=algo,
                n_slots=self.n_slots, gens_per_step=gps,
                seed=self.seed, islands=icfg,
                label=self._label(key), device=self.device)
        return build

    def _pool(self, key: PoolKey, cfg) -> PlacementService:
        if key not in self._pools:
            svc = (self.prewarmer.take(key)
                   if self.prewarmer is not None else None)
            if svc is not None and tracing.enabled():
                tracing.tracer().instant("pool.prewarm_adopt",
                                         pool=svc.label)
            if svc is None:    # not prewarmed (or its build failed): cold
                svc = self._builder(key, cfg)()
            self._pools[key] = svc
            self._pending[key] = []
            self._rotation.append(key)
            if (self.prewarmer is not None and self.autoscale
                    and 2 * svc.n_slots <= self.max_slots):
                # pre-compile the next ladder size before the queue backs
                # up, so an eventual grow() is pure host-side surgery
                self.prewarmer.prewarm_grow(svc, 2 * svc.n_slots)
        return self._pools[key]

    # ------------------------------------------------------------ prewarm

    def prewarm(self, device: str, cfg, algo: str = "nsga2",
                gens_per_step: Optional[int] = None,
                islands: Optional[IslandConfig] = None) -> PoolKey:
        """Request a background build of the pool for this signature (the
        pool a later `submit()` with the same arguments would create).
        No-op without a prewarmer or when the pool already exists."""
        key = self.pool_key(device, algo, cfg, gens_per_step, islands)
        if self.prewarmer is not None and key not in self._pools:
            self.prewarmer.prewarm_pool(key, self._builder(key, cfg))
        return key

    def prewarm_predicted(self, top_k: int = 4) -> List[PoolKey]:
        """Prewarm the pools the champion store's signature-traffic
        distribution predicts: a restarted process starts compiling its
        historical working set before the first job arrives."""
        if self.store is None or self.prewarmer is None:
            return []
        keys = []
        for pred in self.store.predicted_keys(top_k):
            try:
                cfg = _default_cfg(pred.algo, pred.pop_size)
            except KeyError:
                continue                        # unknown algo in old JSON
            keys.append(self.prewarm(pred.device_name, cfg,
                                     algo=pred.algo))
        return keys

    # -------------------------------------------------------------- cache

    def _consult_store(self, job: FleetJob, problem: Problem) -> bool:
        """Champion-store fast paths for a submitted job.

        Returns True when the job was answered instantly (exact-signature
        entry already meeting its `target`: finished result, zero
        generations, no pool touched).  Otherwise injects the best
        exact-or-sibling champion as the job's `init_state` (unless the
        caller supplied one) and returns False so the job runs warm.
        """
        entry, kind = self.store.lookup(problem)
        if entry is None:
            return False
        target = job.request.target
        if kind == "exact" and target is not None and entry.metric <= target:
            job.result = PlacementJob(
                jid=-1, cfg=job.request.cfg, seed=job.request.seed,
                budget=0, target=target, gens=0, done=True,
                best_objs=entry.best_objs.copy(), metric=entry.metric,
                genotype={t: tuple(a.copy() for a in leaves)
                          for t, leaves in entry.genotype.items()})
            job.cached = True
            self._cached_done.append(job)
            return True
        if job.request.init_state is None:
            job.request = job.request.replace(
                init_state=self.store.seed_for(
                    problem, entry, problem_of=self.problem))
            job.warm_from_cache = True
        return False

    def _write_back(self, job: FleetJob, problem: Problem) -> None:
        pj = job.result
        self.store.put(problem, pj.genotype, pj.metric, pj.best_objs,
                       provenance={"device": job.device, "algo": job.algo,
                                   "seed": pj.seed, "gens": pj.gens,
                                   "fleet_jid": job.jid})

    # ------------------------------------------------------------- admit

    def submit(self, device=None, cfg=None, algo: str = "nsga2",
               gens_per_step: Optional[int] = None, priority: float = 0.0,
               deadline: Optional[float] = None,
               islands: Optional[IslandConfig] = None, **spec) -> int:
        """Enqueue one job; returns its scheduler-global jid.

        The canonical form is `submit(request)` with a
        `serve.api.JobRequest` as the only argument; the kwarg form
        survives as a deprecated shim that builds the same request
        (results are bitwise identical).

        Unlike a raw pool, this never rejects: a full pool queues the job
        FIFO and admits it when a slot frees.  `priority` / `deadline`
        only matter to the matching stepping policies (they bias
        completion order, never results).  With a champion store attached,
        an exact-signature cache hit meeting `target` finishes the job
        immediately -- no pool is created and no slot is burned -- and any
        other exact-or-sibling champion warm-starts it via `init_state`
        injection.  `islands` routes the job to an island-model pool
        (`core.islands`): island topology is part of the pool signature,
        so islands and single-population traffic for the same config
        coexist in separate pools, each still compiling once.
        """
        if isinstance(device, JobRequest):
            request = device
        else:
            request = api.deprecated_kwargs_request(
                "PlacementScheduler", device=device, cfg=cfg, algo=algo,
                gens_per_step=gens_per_step, priority=priority,
                deadline=deadline, islands=islands, **spec)
        return self.submit_request(request)

    def submit_request(self, request: JobRequest) -> int:
        """`submit()` on the unified request type (no shim, no warning)."""
        if request.device is None:
            raise ValueError("JobRequest.device is required at the "
                             "scheduler (it picks the problem and pool)")
        if request.cfg is None:
            raise ValueError("JobRequest.cfg is required at the scheduler "
                             "(pools have no shared base config)")
        device, algo = request.device, request.algo
        cfg = request.resolved_cfg()
        if cfg is not request.cfg:          # fused override applied
            request = request.replace(cfg=cfg, fused=None)
        traced_on = tracing.enabled()
        if traced_on and request.trace_id is None:
            # outermost traced layer for this request: mint + announce
            # (the front-end mints first when it is above us)
            request = request.replace(trace_id=tracing.new_trace_id())
            tracing.tracer().instant("job.submit", request.trace_id,
                                     device=device, algo=algo,
                                     budget=request.budget)
        key = self.pool_key(device, algo, cfg, request.gens_per_step,
                            request.islands)
        job = FleetJob(self.next_jid, device, algo, key, request=request,
                       priority=request.priority,
                       deadline=request.deadline,
                       t_submit=time.monotonic())
        self.next_jid += 1
        self.jobs[job.jid] = job
        _M_SUBMITTED.inc()
        if self.store is not None:
            problem = self.problem(device)
            # signature-traffic bookkeeping: what `prewarm_predicted`
            # mines after a restart (persists with the store JSON)
            self.store.note_traffic(
                problem, algo=algo,
                pop_size=getattr(cfg, "pop_size", None))
            if self._consult_store(job, problem):
                _M_CACHE_HITS.inc()
                self._observe_terminal(job)    # cache hits are terminal too
                if traced_on:
                    tracing.tracer().instant(
                        "job.cache_hit", job.trace_id,
                        metric=job.result.metric)
                return job.jid             # served from cache, zero slots
        self._pool(key, cfg)               # create lazily
        if traced_on:
            tracing.tracer().instant("job.queued", job.trace_id,
                                     pool=self._label(key),
                                     queue_depth=len(self._pending[key]))
        self._pending[key].append(job)
        if len(self._pending[key]) == 1:   # a waiting head means pool full
            self._admit(key)
        return job.jid

    # ------------------------------------------------------------- cancel

    def cancel(self, jid: int) -> bool:
        """Cancel a job at the next step boundary: a pending job leaves
        its FIFO, an in-flight job's slot is freed and refilled from the
        queue.  Returns False when the job is already terminal.  Like
        `PlacementService.cancel`, call between `step()`s -- the async
        front-end executes cancels on its stepping thread, which
        guarantees the boundary."""
        job = self.jobs.get(jid)
        if job is None or job.status.terminal:
            return False
        if job.pool_jid is not None:       # in flight: free the slot
            self._inflight.pop((job.pool_key, job.pool_jid), None)
            # the pool emits the job.cancelled trace event + counter
            self._pools[job.pool_key].cancel(job.pool_jid)
            job.cancelled = True
            self._observe_terminal(job)
            self._admit(job.pool_key)      # the freed slot refills now
            return True
        # pending (or cached-but-undrained): pull it out of the queue
        queue = self._pending.get(job.pool_key)
        if queue is not None and job in queue:
            queue.remove(job)
            job.cancelled = True
            self._observe_terminal(job)
            _M_CANCELLED_PENDING.inc()
            if tracing.enabled():
                tracing.tracer().instant("job.cancelled", job.trace_id,
                                         pending=True)
            return True
        if job in self._cached_done:       # cache hit not yet drained:
            return False                   # already answered, too late
        return False

    def _admit(self, key: PoolKey) -> None:
        """Drain the pool's FIFO head into free slots: O(jobs admitted),
        with an O(1) early-out when the pool is already full.

        Resilient to a job whose admission raises (a seed genotype that
        fails canonicalization, a pool left inconsistent by a failed
        prewarm, ...): the job is RE-QUEUED at the back with an error note
        instead of being dropped or wedging the FIFO head, and after
        `ADMIT_RETRIES` failed attempts it is surfaced as failed via
        `step()` so `run_all()` still terminates and co-queued jobs keep
        flowing."""
        pool, queue = self._pools[key], self._pending[key]
        admissible = len(queue)            # each job gets one try per drain
        while queue and admissible > 0 and not pool.active.all():
            admissible -= 1
            job = queue[0]
            try:
                pool_jid = pool.submit_request(job.request)
            except Exception as e:         # noqa: BLE001 -- never drop a job
                queue.pop(0)
                job.attempts += 1
                job.error = (f"admission to pool failed "
                             f"(attempt {job.attempts}): "
                             f"{type(e).__name__}: {e}")
                if job.attempts >= self.ADMIT_RETRIES:
                    self._failed.append(job)   # drained by step()
                    _M_FAILED.inc()
                    if tracing.enabled():
                        tracing.tracer().instant(
                            "job.failed", job.trace_id,
                            error=job.error, attempts=job.attempts)
                else:
                    queue.append(job)          # re-queued, not dropped
                continue
            if pool_jid is None:           # pool full
                break
            queue.pop(0)
            job.pool_jid = pool_jid
            self._inflight[(key, pool_jid)] = job

    def _maybe_grow(self, key: PoolKey) -> None:
        """Queue-depth autoscaling: double the pool along the geometric
        slot ladder (n0, 2*n0, 4*n0, ... <= max_slots) when its FIFO
        backs up.  Doubling keeps the compile count O(log max/n0) while
        absorbing any sustained burst."""
        pool = self._pools[key]
        if (len(self._pending[key]) >= self.autoscale_threshold
                and 2 * pool.n_slots <= self.max_slots):
            old = pool.n_slots
            pool.grow(2 * old)
            self.autoscale_events.append((self._label(key), old,
                                          pool.n_slots))
            if (self.prewarmer is not None
                    and 2 * pool.n_slots <= self.max_slots):
                # keep one ladder rung ahead of the traffic
                self.prewarmer.prewarm_grow(pool, 2 * pool.n_slots)
            self._admit(key)               # the new slots fill immediately

    # -------------------------------------------------------------- step

    @property
    def busy(self) -> bool:
        return (bool(self._inflight) or bool(self._cached_done)
                or bool(self._failed) or any(self._pending.values()))

    def _views(self) -> List[P.PoolView]:
        by_pool: Dict[PoolKey, List[FleetJob]] = {k: [] for k
                                                  in self._rotation}
        for (key, _), job in self._inflight.items():
            by_pool[key].append(job)
        views = []
        for i, key in enumerate(self._rotation):
            pending = self._pending[key]
            views.append(P.PoolView(
                key=key, index=i,
                steppable=bool(self._pools[key].active.any()),
                queue_depth=len(pending),
                jobs=by_pool[key] + pending))
        return views

    def _observe_terminal(self, job: FleetJob) -> None:
        """Record the job's submit -> terminal latency exactly once
        (`t_submit` is zeroed after observing)."""
        if job.t_submit <= 0.0:
            return
        ms = (time.monotonic() - job.t_submit) * 1e3
        job.t_submit = 0.0
        self._latency_hist.observe(ms)
        _M_LATENCY.observe(ms, layer="fleet")

    def step(self) -> List[FleetJob]:
        """Admit what fits everywhere (growing backed-up pools when
        autoscaling), let the policy pick ONE pool, advance its batched
        step; returns newly finished fleet jobs (instant cache hits are
        drained here too)."""
        finished, self._cached_done = self._cached_done, []
        finished += self._failed           # surfaced, never silently lost
        self._failed = []
        for key in self._rotation:
            if self._pending[key]:
                if self.autoscale:
                    self._maybe_grow(key)
                self._admit(key)
        i = self.policy.select(self._views())
        if i is not None:
            key = self._rotation[i]
            pool = self._pools[key]
            for pj in pool.step():
                job = self._inflight.pop((key, pj.jid))
                job.result = pj
                if self.store is not None:
                    self._write_back(job, self.problem(job.device))
                finished.append(job)
            self._admit(key)               # freed slots refill now
        for job in finished:
            self._observe_terminal(job)
        return finished

    def run_all(self) -> List[FleetJob]:
        """Step until every submitted job finishes (admission order may
        interleave pools; per-job results don't depend on it)."""
        done: List[FleetJob] = []
        while self.busy:
            done.extend(self.step())
        return done

    def progress(self) -> List[ProgressUpdate]:
        """Generation-boundary snapshot of every in-flight job (the async
        front-end streams these through `JobHandle.progress()` after each
        `step()`; ETA extrapolation is the front-end's job -- the
        scheduler reports ground truth only)."""
        out: List[ProgressUpdate] = []
        for (key, pool_jid), job in list(self._inflight.items()):
            pj = self._pools[key].job(pool_jid)
            if pj is None:
                continue
            out.append(ProgressUpdate(
                jid=job.jid, status=JobStatus.RUNNING, gens=pj.gens,
                budget=pj.budget, metric=pj.metric,
                best_objs=pj.best_objs,
                convergence=tuple(
                    list(pj.history)[-CONVERGENCE_TAIL:])))
        return out

    # ------------------------------------------------------------ closing

    def close(self) -> None:
        """Orderly shutdown of the attached background machinery: stop
        (and join) the prewarm worker and persist the champion store when
        it was constructed with a path.  Idempotent; in-flight jobs are
        NOT waited for -- drain with `run_all()` (or the front-end's
        `drain()`) first."""
        if self.prewarmer is not None:
            self.prewarmer.close()
        if self.store is not None and self.store.path is not None:
            self.store.save()

    # -------------------------------------------------------------- stats

    def _label(self, key: PoolKey) -> str:
        device_name, algo, static_key, gps, icfg = key
        label = f"{device_name}/{algo}/" + ",".join(
            f"{k}={v}" for k, v in static_key[1]) + f"/gps={gps}"
        if icfg.active:
            label += f"/isl={icfg.n_islands}x{icfg.migrate_every}"
        return label

    def stats(self) -> FleetStats:
        pools = {}
        for key in self._rotation:
            pools[self._label(key)] = dict(
                self._pools[key].stats(),
                queue_depth=len(self._pending[key]))
        statuses = [j.status for j in self.jobs.values()]
        out = api.stats_payload(
            n_pools=len(self._pools),
            jobs_submitted=self.next_jid,
            jobs_done=sum(s is JobStatus.DONE for s in statuses),
            jobs_failed=sum(s is JobStatus.FAILED for s in statuses),
            jobs_cancelled=sum(s is JobStatus.CANCELLED
                               for s in statuses),
            policy=getattr(self.policy, "name", type(self.policy).__name__),
            autoscale_events=list(self.autoscale_events),
            pools=pools,
            # --- appended under schema_version 2 (observability) ---
            job_latency_ms_hist=self._latency_hist.to_dict(),
        )
        if self.store is not None:
            out["cache"] = self.store.stats()
        if self.prewarmer is not None:
            out["prewarm"] = self.prewarmer.stats()
        return out
