"""The port's placement control plane on the CPU: champion store, stepping
policies, the scheduler, prewarm and the kernel build cache.

Mirrors `tests/test_control_plane.py`, `tests/test_compile_prewarm.py` and
`tests/test_warmstart_scheduler.py`'s scheduler cases on the port, at their
smallest budgets, and adds what only the port has to show:
  * a store file moves between the two packages in both directions, and a
    sibling `seed_for` equals the reference's migrated genotype exactly;
  * every scheduler job equals the same request on a standalone pool bit
    for bit -- under every policy, across autoscale grows, from a pool
    prewarmed on another thread;
  * the kernel build cache: `enable` moves `_build`'s directory, a
    library's name hashes the toolkit's version text, a second process
    finds every library on disk, and threads that race to build run one
    nvcc per library.
"""
import contextlib
import io
import json
import stat
import sys
import threading
import warnings

import numpy as np
import pytest
import torch
from test_torch_service import assert_reference_agrees, assert_same_job

from repro.core import transfer as RT
from repro.fpga import device as rdev
from repro.fpga import netlist as rnet
from repro.serve import champion_store as RCS
from repro_torch.core import cmaes as TC
from repro_torch.core import convert
from repro_torch.core import genotype as TG
from repro_torch.core import islands as TI
from repro_torch.core import nsga2 as TN
from repro_torch.core import objectives as TO
from repro_torch.core import portfolio as TP
from repro_torch.core import transfer as TT
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.runtime import compile_cache
from repro_torch.serve import tracing
from repro_torch.serve.api import JobRequest
from repro_torch.serve.champion_store import ChampionStore
from repro_torch.serve.placement_service import PlacementService
from repro_torch.serve.policy import (DeadlinePolicy, PoolView, PriorityPolicy,
                                      RoundRobinPolicy, get_policy)
from repro_torch.serve.prewarm import Prewarmer
from repro_torch.serve.scheduler import PlacementScheduler

BASE = tnet.make_problem(tdev.get_device("xcvu_test"))
SIB = tnet.make_problem(tdev.get_device("xcvu_test2"))
RBASE = rnet.make_problem(rdev.get_device("xcvu_test"))
RSIB = rnet.make_problem(rdev.get_device("xcvu_test2"))
CFG = TN.NSGA2Config(pop_size=8)


@pytest.fixture(autouse=True)
def no_batching_fallback():
    """vmap running an op slice by slice (no batching rule) is an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*batching rule")
        yield


def sched(**kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("gens_per_step", 2)
    return PlacementScheduler(device="cpu", **kw)


def service(problem=BASE, cfg=CFG, **kw):
    kw.setdefault("n_slots", 1)
    kw.setdefault("gens_per_step", 2)
    return PlacementService(problem, cfg, device="cpu", **kw)


def req(seed, budget=4, device="xcvu_test", cfg=CFG, **kw):
    return JobRequest(device=device, cfg=cfg, seed=seed, budget=budget, **kw)


def run(sch, requests):
    """Submit every request, run the scheduler dry; results by request."""
    jids = [sch.submit_request(r) for r in requests]
    done = {j.jid: j for j in sch.run_all()}
    assert sorted(done) == sorted(jids)
    return [done[j] for j in jids]


def standalone(r, problem=BASE):
    """The request alone on a one-slot pool of the same signature."""
    (job,) = service(problem, r.cfg, algo=r.algo).run_jobs([r.replace(device=None)])
    return job


def metric(problem, g) -> float:
    return float(TO.combined_metric(TO.evaluate(problem, convert.genotype_from_numpy(g))))


def objs(problem, g) -> np.ndarray:
    return TO.evaluate(problem, convert.genotype_from_numpy(g)).numpy()


def random_genotype(seed):
    g = TG.random_genotype(BASE, 1, torch.Generator().manual_seed(seed))
    return convert.genotype_to_numpy(TG.tree_map(lambda a: a[0], g))


def put(store, problem, g, **kw):
    return store.put(problem, g, metric(problem, g), objs(problem, g), **kw)


@pytest.fixture(scope="module")
def champion():
    """A converged xcvu_test champion, as numpy (the store's form)."""
    g = TT.converge_champion(BASE, torch.Generator().manual_seed(0), 16, 40)
    return convert.genotype_to_numpy(g)


def assert_genotypes_equal(a, b):
    for tier in ("dist", "loc", "perm"):
        for x, y in zip(a[tier], b[tier], strict=True):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype, tier
            np.testing.assert_array_equal(x, y)


# --------------------------------------------------------- champion store

def test_store_write_back_only_on_improvement(champion):
    store = ChampionStore()
    g_bad = random_genotype(1)
    assert put(store, BASE, g_bad)
    assert put(store, BASE, champion)
    assert not put(store, BASE, g_bad)              # a worse genotype never replaces it
    entry, kind = store.lookup(BASE)
    assert kind == "exact" and len(store) == 1
    assert entry.metric == metric(BASE, champion)
    assert_genotypes_equal(entry.genotype, champion)


def test_store_takes_tensors_and_keeps_the_reference_dtypes(champion):
    store = ChampionStore()
    g = convert.genotype_from_numpy(champion)
    assert g["perm"][0].dtype == torch.int64
    store.put(BASE, g, metric(BASE, champion), torch.as_tensor(objs(BASE, champion)))
    entry = store.get(BASE.signature)
    assert_genotypes_equal(entry.genotype, champion)     # int32 perms, float32 reals
    assert entry.best_objs.dtype == np.float32


def test_store_persistence_round_trip(tmp_path, champion):
    store = ChampionStore()
    put(store, BASE, champion, provenance={"algo": "nsga2", "seed": 0})
    path = str(tmp_path / "champions.json")
    store.save(path)
    with open(path) as f:
        assert json.load(f)["champion_store"] == 1
    entry, kind = ChampionStore(path=path).lookup(BASE)
    assert kind == "exact" and entry.provenance["algo"] == "nsga2"
    assert_genotypes_equal(entry.genotype, champion)
    assert metric(BASE, entry.genotype) == entry.metric
    (tmp_path / "torn.json").write_text('{"champion_store": 1, "entr')
    with pytest.warns(UserWarning, match="unreadable"):
        assert len(ChampionStore(path=str(tmp_path / "torn.json"))) == 0


def test_exact_hit_serves_without_slot(champion):
    store = ChampionStore()
    put(store, BASE, champion)
    sch = sched(store=store)
    target = metric(BASE, champion) * 1.001
    jid = sch.submit_request(req(3, budget=32, target=target))
    assert sch.stats()["n_pools"] == 0               # answered at submit
    (job,) = sch.run_all()
    assert job.jid == jid and job.cached and job.done and job.result.gens == 0
    assert job.result.metric <= target
    assert_genotypes_equal(job.result.genotype, champion)
    assert sch.stats()["n_pools"] == 0


@pytest.fixture(scope="module")
def sibling_race(champion):
    """xcvu_test2 jobs chasing the migrated champion's metric, cold (no
    store) and warm (the store finds the xcvu_test champion as a sibling)."""
    store = ChampionStore()
    put(store, BASE, champion)
    g_mig = convert.genotype_to_numpy(TT.migrate(BASE, SIB, convert.genotype_from_numpy(champion)))
    target = metric(SIB, g_mig)
    r = req(0, budget=60, device="xcvu_test2", cfg=TN.NSGA2Config(pop_size=16), target=target)
    (cold,) = run(sched(n_slots=1), [r])
    warm_sch = sched(n_slots=1, store=store)
    (warm,) = run(warm_sch, [r])
    return store, r, g_mig, target, cold, warm


def test_sibling_hit_warm_beats_cold(sibling_race):
    store, _, _, target, cold, warm = sibling_race
    assert warm.warm_from_cache and not warm.cached and not cold.warm_from_cache
    assert warm.result.metric <= target
    assert warm.result.gens < cold.result.gens, (warm.result.gens, cold.result.gens)
    entry, kind = store.lookup(SIB)                 # written back under its own signature
    assert kind == "exact" and entry.device_name == "xcvu_test2"
    assert_reference_agrees(RSIB, warm.result)


def test_sibling_seed_is_the_migrated_champion(sibling_race):
    """The store's sibling seed is `transfer.migrate` of the donor, and the
    warm job equals a standalone pool seeded with it, bit for bit."""
    _, r, g_mig, _, _, warm = sibling_race
    assert_genotypes_equal(warm.request.init_state, g_mig)
    assert_same_job(warm.result, standalone(r.replace(init_state=g_mig), SIB))


def test_explicit_init_state_wins_over_cache(champion):
    g_explicit = random_genotype(2)
    store = ChampionStore()
    put(store, BASE, champion)
    r = req(2, budget=4, init_state=g_explicit)
    (job,) = run(sched(n_slots=1, store=store), [r])
    assert not job.warm_from_cache
    assert_same_job(job.result, standalone(r))


def test_no_store_is_the_plain_router():
    r = req(5, budget=6, cfg=TN.NSGA2Config(pop_size=8, sbx_eta=7.0), device="xcvu_test2")
    (job,) = run(sched(), [r])
    assert not job.warm_from_cache and not job.cached
    assert_same_job(job.result, standalone(r, SIB))
    assert "cache" not in sched().stats()


def test_traffic_counts_merge_on_load_and_drive_prewarm_predicted(tmp_path):
    store = ChampionStore()
    sch = sched(store=store)
    run(sch, [req(0, budget=2), req(1, budget=2), req(0, budget=2, device="xcvu_test2")])
    path = str(tmp_path / "store.json")
    store.save(path)

    fresh = ChampionStore(path=path)                # the restarted process
    preds = fresh.predicted_keys()
    assert [p.count for p in preds] == [2, 1]
    assert (preds[0].device_name, preds[0].algo, preds[0].pop_size) == ("xcvu_test", "nsga2", 8)
    fresh.load(path)                                # counts add on a merge
    assert [p.count for p in fresh.predicted_keys()] == [4, 2]

    sch2 = sched(store=ChampionStore(path=path), prewarm=True)
    try:
        assert len(sch2.prewarm_predicted(top_k=1)) == 1
        assert sch2.prewarmer.wait_idle(timeout=120)
        assert sch2.prewarmer.builds_done == 1
        # only static fields route: other floats adopt the prewarmed pool
        (job,) = run(sch2, [req(3, budget=2, cfg=TN.NSGA2Config(pop_size=8, sbx_eta=19.0))])
        assert job.done and sch2.prewarmer.adopted == 1
    finally:
        sch2.close()


# ------------------------------------------------------ across packages

def test_reference_store_file_loads_in_the_port(tmp_path, champion):
    ref = RCS.ChampionStore()
    ref.put(RBASE, champion, metric(BASE, champion), objs(BASE, champion),
            provenance={"algo": "nsga2"})
    ref.note_traffic(RBASE, algo="nsga2", pop_size=8)
    path = str(tmp_path / "ref.json")
    ref.save(path)
    port = ChampionStore(path=path)
    entry, kind = port.lookup(BASE)
    assert kind == "exact" and entry.metric == metric(BASE, champion)
    assert_genotypes_equal(entry.genotype, champion)
    np.testing.assert_array_equal(entry.best_objs, objs(BASE, champion))
    assert [(p.signature, p.count) for p in port.predicted_keys()] == [(BASE.signature, 1)]


def test_port_store_file_loads_in_the_reference(tmp_path, champion):
    port = ChampionStore()
    port.put(BASE, convert.genotype_from_numpy(champion), metric(BASE, champion),
             torch.as_tensor(objs(BASE, champion)))
    path = str(tmp_path / "port.json")
    port.save(path)
    entry, kind = RCS.ChampionStore(path=path).lookup(RBASE)
    assert kind == "exact" and entry.metric == metric(BASE, champion)
    assert_genotypes_equal(entry.genotype, champion)


def test_sibling_seed_for_equals_the_reference(champion):
    port, ref = ChampionStore(), RCS.ChampionStore()
    put(port, BASE, champion)
    ref.put(RBASE, champion, metric(BASE, champion), objs(BASE, champion))
    (p_entry, p_kind), (r_entry, r_kind) = port.lookup(SIB), ref.lookup(RSIB)
    assert p_kind == r_kind == "sibling"
    got = port.seed_for(SIB, p_entry)
    want = {t: tuple(np.asarray(a) for a in leaves)
            for t, leaves in ref.seed_for(RSIB, r_entry).items()}
    assert_genotypes_equal(got, want)
    assert port.seed_for(BASE, p_entry) is p_entry.genotype       # exact: untouched
    # the seed canonicalizes with its permutations unchanged
    from repro_torch.core import warmstart as TW
    pop, _ = TW.canonicalize(SIB, got, 4)
    for p, g in zip(pop["perm"], got["perm"]):
        np.testing.assert_array_equal(p[0].numpy(), g)
    np.testing.assert_array_equal(
        np.asarray(RT.migrate(RBASE, RSIB, champion)["perm"][0]), got["perm"][0])


# --------------------------------------------------------------- policies

def _view(key, steppable, jobs, index=0):
    return PoolView(key=key, index=index, steppable=steppable, queue_depth=0, jobs=jobs)


class _J:
    def __init__(self, priority=0.0, deadline=None):
        self.priority, self.deadline = priority, deadline


def test_round_robin_pointer_advances_past_stepped_pools():
    rr = RoundRobinPolicy()
    views = [_view("a", True, []), _view("b", True, []), _view("c", False, [])]
    assert [rr.select(views) for _ in range(4)] == [0, 1, 0, 1]
    views[2] = _view("c", True, [])
    assert rr.select(views) == 2


def test_priority_and_deadline_policies_order():
    assert PriorityPolicy().select([_view("a", True, [_J(priority=1.0)]),
                                    _view("b", True, [_J(priority=5.0)])]) == 1
    edf = DeadlinePolicy()
    views = [_view("a", True, [_J(deadline=None)]),
             _view("b", True, [_J(deadline=9.0), _J(deadline=2.0)]),
             _view("c", True, [_J(deadline=5.0)])]
    assert edf.select(views) == 1
    with pytest.raises(KeyError):
        get_policy("nope")


def test_scheduler_fairness_two_uneven_pools():
    sch = sched()
    for s in range(6):                              # pool A: always busy
        sch.submit_request(req(s, budget=8, cfg=TN.NSGA2Config(pop_size=16)))
    small = [sch.submit_request(req(s, budget=4)) for s in range(2)]
    done_at, t = {}, 0
    while sch.busy:
        t += 1
        for j in sch.step():
            done_at[j.jid] = t
    assert all(done_at[j] <= 6 for j in small), done_at
    assert max(done_at[j] for j in small) < max(done_at.values())


@pytest.mark.parametrize("policy", ["deadline", "priority"])
def test_urgent_pool_first_and_results_unchanged(policy):
    """An urgent job submitted after bulk work finishes first under EDF or
    priority, not under round-robin, and every job's result is the same
    under all three policies."""
    bulk = [req(s, budget=4, cfg=TN.NSGA2Config(pop_size=16)) for s in range(2)]
    urgent = req(0, budget=4, deadline=1.0, priority=10.0)

    results = {}
    for name in ("round_robin", policy):
        sch = sched(n_slots=1, policy=name)
        jids = [sch.submit_request(r) for r in bulk + [urgent]]
        order = [j.jid for j in sch.run_all()]
        results[name] = ([order.index(j) for j in jids],
                         {j.jid: j for j in sch.jobs.values()})
    (rr_pos, rr_jobs), (p_pos, p_jobs) = results["round_robin"], results[policy]
    assert p_pos[2] < min(p_pos[:2])                # urgent first
    assert rr_pos[2] > min(rr_pos[:2])              # round-robin interleaves
    for jid in rr_jobs:
        assert_same_job(p_jobs[jid].result, rr_jobs[jid].result)


# -------------------------------------------------------------- scheduler

def test_scheduler_results_equal_standalone_pools():
    """Routing through the scheduler never changes an answer: co-tenants in
    the same pool and in other pools, queueing, bit for bit."""
    r = req(5, budget=6, device="xcvu_test2", cfg=TN.NSGA2Config(pop_size=8, sbx_eta=7.0))
    cma = req(0, budget=4, device="xcvu_test2", cfg=TC.CMAESConfig(pop_size=8), algo="cmaes")
    done = run(sched(), [r, req(9, budget=4, device="xcvu_test2"), cma,
                         req(1, budget=4, cfg=TN.NSGA2Config(pop_size=16)), r.replace(seed=6)])
    assert_same_job(done[0].result, standalone(r, SIB))
    assert_same_job(done[2].result, standalone(cma, SIB))
    for job in done:
        assert_reference_agrees(RSIB if job.device == "xcvu_test2" else RBASE, job.result)


def test_jobs_queue_beyond_the_slots_and_finish():
    sch = sched(n_slots=1)
    jids = [sch.submit_request(req(i)) for i in range(4)]
    assert sch.busy
    (label,) = sch.stats()["pools"]
    assert sch.stats()["pools"][label]["queue_depth"] == 3
    done = sch.run_all()
    assert sorted(j.jid for j in done) == jids and not sch.busy
    s = sch.stats()["pools"][label]
    assert s["queue_depth"] == 0 and s["step_compiles"] == 1


def test_mixed_signatures_get_one_pool_each():
    sch = sched()
    reqs = [req(s, device=d, cfg=TN.NSGA2Config(pop_size=p))
            for d in ("xcvu_test", "xcvu_test2") for p in (8, 16) for s in range(3)]
    reqs.append(req(0, device="xcvu_test2", cfg=TC.CMAESConfig(pop_size=8), algo="cmaes"))
    done = run(sch, reqs)
    assert all(j.done for j in done)
    stats = sch.stats()
    assert stats["n_pools"] == 5 and stats["jobs_done"] == len(reqs)
    assert all(s["step_compiles"] == 1 for s in stats["pools"].values())
    assert sch.device == torch.device("cpu")
    assert all(p.device == torch.device("cpu") for p in sch._pools.values())


def test_autoscale_grows_on_queue_depth_and_grown_jobs_equal_standalone():
    sch = sched(n_slots=1, autoscale=True, autoscale_threshold=2, max_slots=4)
    reqs = [req(i, budget=4) for i in range(6)]
    done = run(sch, reqs)
    assert sch.autoscale_events
    (s,) = sch.stats()["pools"].values()
    assert s["sizes"] == [1, 2, 4] and s["queue_depth"] == 0
    assert s["step_compiles"] <= len(s["sizes"])
    for r, job in zip(reqs, done):
        assert_same_job(job.result, standalone(r))


def test_the_scheduler_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device does not raise")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        PlacementScheduler()


def _sabotaged(fail):
    """A scheduler whose pool's submit_request raises while fail(request)."""
    sch = sched(n_slots=1)
    pool = sch._pool(sch.pool_key("xcvu_test", "nsga2", CFG), CFG)
    orig = pool.submit_request

    def submit_request(r):
        if fail(r):
            raise RuntimeError("slot allocator hiccup")
        return orig(r)
    pool.submit_request = submit_request
    return sch


def test_admission_failure_is_requeued_then_recovers():
    calls = []
    sch = _sabotaged(lambda r: calls.append(1) or len(calls) <= 2)
    jid = sch.submit_request(req(0, budget=2))
    job = sch.jobs[jid]
    assert job.attempts == 1 and "hiccup" in job.error and not job.failed
    (done,) = sch.run_all()
    assert done.done and done.attempts == 2


def test_permanent_admission_failure_surfaces_without_wedging():
    sch = _sabotaged(lambda r: r.seed == 1)
    bad, good = sch.submit_request(req(1, budget=2)), sch.submit_request(req(2, budget=2))
    done = {j.jid: j for j in sch.run_all()}
    assert done.keys() == {bad, good}
    assert done[good].done and not done[good].failed
    assert done[bad].failed and done[bad].result is None
    assert done[bad].attempts == PlacementScheduler.ADMIT_RETRIES
    assert sch.stats()["jobs_failed"] == 1 and not sch.busy


# ---------------------------------------------------------------- prewarm

def test_prewarmed_pool_equals_a_cold_one_bitwise():
    r = req(5, budget=4)
    warm_sch = sched(prewarm=True)
    try:
        warm_sch.prewarm("xcvu_test", CFG)
        assert warm_sch.prewarmer.wait_idle(timeout=120)
        assert warm_sch.prewarmer.builds_done == 1
        (warm,) = run(warm_sch, [r])
        assert warm_sch.prewarmer.adopted == 1       # the pool built on the worker thread
        assert warm_sch.stats()["prewarm"]["errors"] == {}
    finally:
        warm_sch.close()
    (cold,) = run(sched(), [r])
    assert_same_job(warm.result, cold.result)


def test_failed_prewarm_build_falls_back_to_synchronous():
    sch = sched(prewarm=True)
    key = sch.pool_key("xcvu_test", "nsga2", CFG)
    sch.prewarmer.prewarm_pool(key, lambda: 1 / 0)
    assert sch.prewarmer.wait_idle(timeout=60)
    assert sch.prewarmer.failures == 1 and sch.prewarmer.take(key) is None
    (job,) = run(sch, [req(0, budget=2)])
    assert job.done
    assert "ZeroDivisionError" in json.dumps(sch.prewarmer.stats()["errors"])
    sch.close()


def test_prewarmer_dedups_and_reports():
    pw = Prewarmer()
    built = []
    assert pw.prewarm_pool("k1", lambda: built.append(1) or "pool")
    assert not pw.prewarm_pool("k1", lambda: built.append(2) or "dup")
    assert pw.wait_idle(timeout=60)
    assert built == [1] and pw.take("k1") == "pool" and pw.take("k1") is None
    s = pw.stats()
    assert s["builds_done"] == 1 and s["adopted"] == 1
    pw.close()


@pytest.fixture
def builds_per_width(monkeypatch):
    """Stand in for the card's first-use builds: the first batched step at
    each slot count reports one build to the meter, on the calling thread."""
    seen, lock = set(), threading.Lock()
    member_round = TP.member_round

    def counted(problem, algo, sk, n_gens, traced, states, gens):
        with lock:
            first = len(gens) not in seen
            seen.add(len(gens))
        if first:
            compile_cache.meter().record(1, 0.0)
        return member_round(problem, algo, sk, n_gens, traced, states, gens)
    monkeypatch.setattr(TP, "member_round", counted)
    return seen


def test_grow_at_a_prewarmed_size_blocks_on_no_build(builds_per_width):
    def grown(prewarm):
        builds_per_width.clear()                     # a new process
        svc = service(n_slots=2)
        svc.submit(req(7, budget=8).replace(device=None))
        svc.step()
        assert svc.blocking_compiles == 1            # the first width, cold
        if prewarm:
            pw = Prewarmer()
            assert pw.prewarm_grow(svc, 4)
            assert pw.wait_idle(timeout=60) and pw.errors == {}
            pw.close()
            assert not svc.prewarm_size(4) and not svc.prewarm_size(2)
        svc.grow(4)
        svc.submit(req(8, budget=8).replace(device=None))
        done = svc.run_jobs([])
        return svc, {j.seed: j for j in done}

    warm, warm_jobs = grown(True)
    s = warm.stats()
    assert (s["blocking_compiles"], s["prewarm_compiles"], s["prewarmed_sizes"]) == (1, 1, [4])
    cold, cold_jobs = grown(False)                  # the new width blocks the step
    assert cold.stats()["blocking_compiles"] == 2
    for seed in warm_jobs:
        assert_same_job(warm_jobs[seed], cold_jobs[seed])


@pytest.mark.parametrize("islands", [None, TI.IslandConfig(2, 1)], ids=["plain", "islands"])
def test_prewarm_size_never_touches_the_pool(islands):
    svc = service(n_slots=2, islands=islands)
    svc.submit(req(3, budget=8, islands=islands).replace(device=None))
    svc.step()
    before = (convert.state_to_numpy(TP.member(svc.states, 0)), svc.slot_gens.copy(),
              svc._fill_gen.get_state().clone(), svc.n_slots)
    assert svc.prewarm_size(4)
    after = (convert.state_to_numpy(TP.member(svc.states, 0)), svc.slot_gens.copy(),
             svc._fill_gen.get_state().clone(), svc.n_slots)
    for a, b in zip(torch.utils._pytree.tree_leaves(before),
                    torch.utils._pytree.tree_leaves(after), strict=True):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert svc.stats()["prewarmed_sizes"] == [4]


# ----------------------------------------------------- kernel build cache

@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A stand-in compiler that writes its -o file (after a pause, so racing
    threads overlap) and answers --version; a fresh meter and request set,
    as in a new process."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nif [ "$1" = "--version" ]; then echo "fake nvcc 1.0"; exit 0; fi\n'
                    'sleep 0.2\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "_requested", set())
    monkeypatch.setattr(compile_cache, "_METER", compile_cache.CompileMeter())
    yield fake
    compile_cache.disable()


def test_enable_disable_and_env_move_the_build_dir(tmp_path, monkeypatch):
    default = str(_build.BUILD_DIR)
    try:
        assert compile_cache.enabled_dir() == default
        d = str(tmp_path / "kc")
        assert compile_cache.enable(d) == d
        assert compile_cache.enabled_dir() == d and _build.build_dir() == tmp_path / "kc"
        assert _build.library_path("bbox").parent == tmp_path / "kc"
        compile_cache.disable()
        assert compile_cache.enabled_dir() == default
        monkeypatch.delenv("REPRO_COMPILE_CACHE_DIR", raising=False)
        assert compile_cache.maybe_enable_from_env(None) is None
        assert compile_cache.enabled_dir() == default
        monkeypatch.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path / "env"))
        assert compile_cache.maybe_enable_from_env(None) == str(tmp_path / "env")
        assert compile_cache.maybe_enable_from_env(d) == d      # the flag wins
        assert compile_cache.enabled_dir() == d
    finally:
        compile_cache.disable()


def test_library_path_hashes_the_toolkit(monkeypatch):
    names = {}
    for text in ("Cuda compilation tools, release 12.4", "Cuda compilation tools, release 12.8"):
        monkeypatch.setattr(_build, "nvcc_version", lambda text=text: text)
        names[text] = _build.library_path("domination")
    assert len(set(names.values())) == 2
    assert _build.library_path("domination") == names[text]     # stable


def test_cache_salt_and_pool_token_are_stable():
    salt = compile_cache.cache_salt()
    assert salt == compile_cache.cache_salt() and torch.__version__ in salt
    key = sched().pool_key("xcvu_test", "nsga2", CFG)
    tok = compile_cache.pool_token(key)
    assert tok == compile_cache.pool_token(key) and len(tok) == 16
    assert tok != compile_cache.pool_token(sched().pool_key("xcvu_test2", "nsga2", CFG))


def test_a_second_process_finds_every_library_on_disk(tmp_path, fake_nvcc, monkeypatch):
    compile_cache.enable(str(tmp_path / "kc"))
    meter = compile_cache.meter()
    assert sorted(_build.build()) == sorted(_build.NAMES)
    assert (meter.compiles, meter.cache_hits, meter.recompiles) == (5, 0, 5)
    assert _build.build() == {} and meter.compiles == 5        # requested already
    monkeypatch.setattr(_build, "_requested", set())            # a new process
    monkeypatch.setattr(compile_cache, "_METER", compile_cache.CompileMeter())
    assert _build.build() == {}
    meter = compile_cache.meter()
    assert (meter.compiles, meter.cache_hits, meter.recompiles) == (5, 5, 0)
    samples = {name: value for name, _, _, value in meter.telemetry_samples()}
    assert samples["repro_compile_cache_hits_total"] == 5
    assert samples["repro_recompiles_total"] == 0


def test_racing_threads_run_one_nvcc_per_library(tmp_path, fake_nvcc):
    compile_cache.enable(str(tmp_path / "kc"))
    barrier, errors = threading.Barrier(6), []
    interval = sys.getswitchinterval()

    def build():
        try:
            barrier.wait(timeout=30)
            _build.build()
        except Exception as e:       # noqa: BLE001 -- reported below
            errors.append(e)
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=build) for _ in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    meter = compile_cache.meter()
    assert (meter.compiles, meter.recompiles) == (5, 5)


# ---------------------------------------------------------------- launcher

def test_control_plane_launcher_on_cpu(tmp_path):
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            serve.main(["--placement", "--torch-device", "cpu", "--requests", "3", "--slots",
                        "1", "--pop", "8", "--gens", "4", "--gens-per-step", "2", "--cache",
                        "--cache-path", str(tmp_path / "store.json"), "--policy", "deadline",
                        "--autoscale", "--prewarm", "--compile-cache-dir", str(tmp_path / "kc"),
                        "--chrome-trace", str(tmp_path / "trace.json"),
                        "--metrics-dump", str(tmp_path / "metrics.txt")])
    finally:
        tracing.disable()
    text = out.getvalue()
    spans = {e["name"] for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"pool.build", "pool.step", "pool.grow", "job.cache_hit"} <= spans
    metrics = (tmp_path / "metrics.txt").read_text()
    assert "repro_jobs_cache_hits_total" in metrics and "repro_compiles_total" in metrics
    assert f"kernel build cache: {tmp_path / 'kc'}" in text
    assert "urgent job finished 1/4" in text
    assert text.count("[cache-hit]   0 gens") == 3
    assert "autoscale events (pool, old, new): [(" in text
    assert ChampionStore(path=str(tmp_path / "store.json")).predicted_keys()
    assert compile_cache.enabled_dir() == str(tmp_path / "kc")
    compile_cache.disable()
