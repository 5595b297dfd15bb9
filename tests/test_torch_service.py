"""The port's placement service (`repro_torch.serve.placement_service`) on the CPU.

The slot pool carries the reference's serving contracts, held here on the
plain PyTorch versions:
  * a job's result is a pure function of its request: alone, beside
    co-tenants, with a co-tenant cancelled, across a `grow()`, bit for
    bit; and it is exactly the run `job_generators` derives (init from the
    seed, each step from (seed, generation));
  * the reported objectives are what the reference computes for the
    harvested genotype, and every champion passes the reference's
    `validate_placement`;
  * one step program per slot count, and the aten ops of a step do not
    depend on how many slots are occupied;
  * routing fields are validated as the reference validates them, and
    `stats()` has the reference's `ServiceStats` keys.
The workload mirrors `tests/test_portfolio_service.py` and
`tests/test_warmstart_scheduler.py` at their smallest budgets.
"""
import contextlib
import io
import os
import stat
import threading
import warnings

import numpy as np
import pytest
import torch
from _kernel_sweeps import tol
from test_torch_portfolio import OpCount, assert_trees_equal

from repro.core import objectives as RO
from repro.fpga import device as rdev
from repro.fpga import netlist as rnet
from repro.serve import api as rapi
from repro.serve import placement_service as RS
from repro_torch.core import annealing as TA
from repro_torch.core import cmaes as TC
from repro_torch.core import ga as TGA
from repro_torch.core import hyper as TH
from repro_torch.core import islands as TI
from repro_torch.core import nsga2 as TN
from repro_torch.core import objectives as TO
from repro_torch.core import portfolio as TP
from repro_torch.core import transfer as TT
from repro_torch.core import warmstart as TW
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet
from repro_torch.kernels import _build
from repro_torch.launch import serve
from repro_torch.runtime import compile_cache, telemetry
from repro_torch.serve import placement_service as TS
from repro_torch.serve import tracing
from repro_torch.serve.api import JobRequest

PORT = tnet.make_problem(tdev.get_device("xcvu_test"))
REF = rnet.make_problem(rdev.get_device("xcvu_test"))
SIB = tnet.make_problem(tdev.get_device("xcvu_test2"))
RSIB = rnet.make_problem(rdev.get_device("xcvu_test2"))
BASE = TN.NSGA2Config(pop_size=8)


@pytest.fixture(autouse=True)
def no_batching_fallback():
    """vmap running an op slice by slice (no batching rule) is an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*batching rule")
        yield


def pool(base=BASE, **kw):
    kw.setdefault("n_slots", 3)
    kw.setdefault("gens_per_step", 2)
    problem = SIB if kw.pop("sib", False) else PORT
    return TS.PlacementService(problem, base, device="cpu", **kw)


def request(seed, budget=4, **kw):
    cfg = kw.pop("cfg", TN.NSGA2Config(pop_size=8, real_mut_prob=0.1 + 0.02 * (seed % 7)))
    return JobRequest(seed=seed, budget=budget, cfg=cfg, **kw)


def by_seed(done):
    return {j.seed: j for j in done}


def assert_same_job(a, b):
    assert (a.gens, a.budget, a.warm) == (b.gens, b.budget, b.warm)
    np.testing.assert_array_equal(a.best_objs, b.best_objs)
    for x, y in zip(torch.utils._pytree.tree_leaves(a.genotype),
                    torch.utils._pytree.tree_leaves(b.genotype), strict=True):
        np.testing.assert_array_equal(x, y)
    assert list(a.history) == list(b.history)


def assert_reference_agrees(ref_problem, job):
    """Legal under the reference's re-checker; its objectives are the
    reference's evaluation of the harvested genotype."""
    checks = RO.validate_placement(ref_problem, job.genotype)
    assert all(checks.values()), checks
    np.testing.assert_allclose(job.best_objs, np.asarray(RO.evaluate(ref_problem, job.genotype)),
                               **tol(np.float32))
    assert job.metric == float(job.best_objs[0] * job.best_objs[1])


# ------------------------------------------------------------- workload

@pytest.mark.parametrize("fused", [False, True])
def test_make_job_specs_matches_reference(fused):
    got = TS.make_job_specs(5, 8, 6, seed=3, fused=fused)
    want = RS.make_job_specs(5, 8, 6, seed=3, fused=fused)
    assert [(s["seed"], s["budget"]) for s in got] == [(s["seed"], s["budget"]) for s in want]
    for g, w in zip(got, want):
        assert isinstance(g["cfg"], TN.NSGA2Config)
        assert vars(g["cfg"]) == vars(w["cfg"])


def test_job_generator_streams():
    def draw(seed, g, n=1):
        return [tuple(torch.rand(4, generator=x).tolist())
                for x in TS.job_generators(seed, g, n, "cpu")]
    streams = [x for s in (0, 1, 7) for g in (None, 0, 1, 2, 8) for n in (1, 3)
               for x in draw(s, g, n)]
    assert len(set(streams)) == len(streams)
    assert draw(5, 3) == draw(5, 3)
    # the seed counts modulo 2**32, as the reference's uint32 slot seeds
    assert draw(5 + 2 ** 32, 3, 2) == draw(5, 3, 2)
    for g, n in ((2 ** 24 - 1, 1), (0, 256)):
        with pytest.raises(ValueError, match="out of the streams' range"):
            TS.job_generators(0, g, n, "cpu")


# ------------------------------------------------------------- the pool

@pytest.fixture(scope="module")
def rolling():
    """5 jobs through a 3-slot pool, rolling admission; budgets 3-6
    quantize up to the pool's 2 generations per step."""
    svc = pool()
    specs = [request(i, budget=3 + (i % 4)) for i in range(5)]
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*batching rule")
        done = svc.run_jobs(specs)
    return svc, specs, done


def test_jobs_finish_legal_with_quantized_budgets(rolling):
    svc, specs, done = rolling
    assert sorted(j.seed for j in done) == list(range(5))
    for j in done:
        spec = specs[j.seed]
        assert j.done and not j.cancelled
        assert j.budget == -(-spec.budget // 2) * 2 and j.gens == j.budget
        assert [g for g, _ in j.history] == list(range(2, j.gens + 1, 2))
        assert_reference_agrees(REF, j)


def test_one_step_program_and_useful_gens(rolling):
    svc, _, done = rolling
    assert svc.step_compiles == 1
    s = svc.stats()
    assert s["useful_gens"] == sum(j.budget for j in done)
    assert s["steps"] == svc.total_steps and s["sizes"] == [3]
    # nothing builds on the CPU: the wrappers run their plain versions
    assert (s["blocking_compiles"], s["blocking_compile_secs"]) == (0, 0.0)


def test_stats_keys_are_the_reference_schema(rolling):
    svc, _, _ = rolling
    s = svc.stats()
    assert list(s) == list(rapi.ServiceStats.__annotations__)
    assert s["schema_version"] == rapi.STATS_SCHEMA_VERSION
    assert s["persistent_cache_dir"] == str(_build.BUILD_DIR)
    assert s["prewarmed_sizes"] == [] and s["step_ms_hist"]["count"] == svc.total_steps


def test_jobs_are_their_own_runs(rolling):
    """A pool job is the run `job_generators` derives: `member_init` from
    the seed, then one `member_round` per step from (seed, generation)."""
    _, _, done = rolling
    j = by_seed(done)[3]
    sk, traced = TH.stack_configs([j.cfg], "cpu")
    state = TP.member_init(PORT, "nsga2", sk, traced, TS.job_generators(3, None, 1, "cpu"))
    for g in range(0, j.budget, 2):
        state, best = TP.member_round(PORT, "nsga2", sk, 2, traced, state,
                                      TS.job_generators(3, g, 1, "cpu"))
    assert j.history[-1][1] == float(best[0, 0] * best[0, 1])
    gen, objs = TP.best_genotype(PORT, "nsga2", TP.member(state, 0), j.cfg)
    np.testing.assert_array_equal(objs.numpy(), j.best_objs)
    for x, y in zip(torch.utils._pytree.tree_leaves(gen),
                    torch.utils._pytree.tree_leaves(j.genotype), strict=True):
        np.testing.assert_array_equal(x.numpy(), y)


def test_backpressure_and_static_fields():
    svc = pool(n_slots=2)
    assert svc.submit(request(0)) is not None
    assert svc.submit(request(1)) is not None
    assert svc.submit(request(2)) is None              # pool full
    with pytest.warns(DeprecationWarning):
        assert svc.submit(budget=4) is None            # the kwarg shim
    with pytest.raises(ValueError, match="static fields"):
        svc.submit(request(3, cfg=TN.NSGA2Config(pop_size=16)))
    while svc.active.any():
        svc.step()
    assert svc.step_compiles == 1


@pytest.mark.parametrize("field", ["algo", "islands", "gens_per_step", "fused", "pop_size"])
def test_routing_fields_are_validated(field):
    """Each routing mismatch raises the reference's ValueError; none is
    re-routed."""
    svc = pool(n_slots=1)
    bad, match = {
        "algo": (dict(algo="cmaes"), "does not match this pool's algo"),
        "islands": (dict(islands=TI.IslandConfig(2, 1)), "does not match this pool's islands"),
        "gens_per_step": (dict(gens_per_step=3), "does not match this pool's gens_per_step"),
        "fused": (dict(fused=True), "static fields"),
        "pop_size": (dict(cfg=TN.NSGA2Config(pop_size=4)), "static fields"),
    }[field]
    with pytest.raises(ValueError, match=match):
        svc.submit(request(0, **bad))
    assert not svc.active.any() and svc.next_jid == 0


def test_target_finishes_early():
    svc = pool(n_slots=1)
    svc.submit(request(0, budget=50, target=float("inf")))
    (job,) = svc.step()                                # any metric beats +inf
    assert job.gens == 2 < job.budget == 50 and job.done
    assert svc.stats()["useful_gens"] == 2


# ------------------------------------------------------------ co-tenancy

@pytest.fixture(scope="module")
def alone():
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*batching rule")
        return by_seed(pool(n_slots=1).run_jobs([request(42, budget=8)]))[42]


def test_job_alone_equals_job_in_a_loaded_pool(alone):
    svc = pool(n_slots=3)
    done = svc.run_jobs([request(7, 6), request(42, 8), request(8, 4), request(9, 8)])
    assert_same_job(by_seed(done)[42], alone)


def test_cancel_and_grow_do_not_perturb_a_job(alone):
    svc = pool(n_slots=2)
    a = svc.submit(request(7, budget=8))
    svc.submit(request(42, budget=8))
    done = svc.step()
    assert svc.cancel(a) and not svc.cancel(a) and svc.job(a) is None
    svc.submit(request(8, budget=6))
    done += svc.step()
    svc.grow(4)
    with pytest.raises(ValueError, match="only grows"):
        svc.grow(4)
    svc.submit(request(9, budget=4))
    svc.submit(request(10, budget=4))
    assert len(svc.inflight()) == 4
    while svc.active.any():
        done += svc.step()
    assert_same_job(by_seed(done)[42], alone)
    assert 7 not in by_seed(done)
    s = svc.stats()
    assert (s["step_compiles"], s["sizes"], s["jobs_cancelled"]) == (2, [2, 4], 1)


# ------------------------------------------------------------- algorithms

@pytest.mark.parametrize("algo,cfg", [("cmaes", TC.CMAESConfig(pop_size=8)),
                                      ("sa", TA.SAConfig()),
                                      ("ga", TGA.GAConfig(pop_size=8))])
def test_baseline_pools(algo, cfg):
    svc = pool(cfg, algo=algo, n_slots=2, gens_per_step=3)
    done = svc.run_jobs([dict(seed=i, budget=6) for i in range(3)])
    assert len(done) == 3 and svc.step_compiles == 1
    for j in done:
        assert j.gens == 6
        assert_reference_agrees(REF, j)
    # the job alone computes the same
    (solo,) = pool(cfg, algo=algo, n_slots=1, gens_per_step=3).run_jobs(
        [dict(seed=2, budget=6)])
    assert_same_job(by_seed(done)[2], solo)


def test_fused_pool_matches_unfused_champions():
    def run(fused):
        svc = pool(TN.NSGA2Config(pop_size=8, fused=fused), n_slots=2)
        done = svc.run_jobs([request(i, cfg=TN.NSGA2Config(
            pop_size=8, real_mut_prob=0.1 + 0.05 * i, fused=fused)) for i in range(4)])
        assert svc.step_compiles == 1
        return {j.seed: j.best_objs for j in done}

    cold, hot = run(False), run(True)
    assert cold.keys() == hot.keys()
    for seed in cold:
        np.testing.assert_array_equal(cold[seed], hot[seed])


# ------------------------------------------------------------ warm starts

@pytest.fixture(scope="module")
def migrated_champion():
    """A short-converged xcvu_test champion migrated onto xcvu_test2."""
    champ = TT.converge_champion(PORT, torch.Generator().manual_seed(0), 16, 12)
    return TT.migrate(PORT, SIB, champ)


def test_warm_jobs_reproducible_and_cotenant_independent(migrated_champion):
    spec = request(11, budget=6, init_state=migrated_champion)
    (job_a,) = pool(n_slots=1, sib=True).run_jobs([spec])
    svc = pool(n_slots=3, sib=True)
    done = svc.run_jobs([request(7, 8), spec, request(8, 8), request(9, 4)])
    job_b = by_seed(done)[11]
    assert job_a.warm and job_b.warm and not by_seed(done)[7].warm
    assert_same_job(job_a, job_b)
    assert_reference_agrees(RSIB, job_b)
    seed_metric = float(TO.combined_metric(TO.evaluate(SIB, migrated_champion)))
    assert job_b.metric <= seed_metric             # the seed row survives truncation


def test_warm_cmaes_keeps_the_seed(migrated_champion):
    svc = pool(TC.CMAESConfig(pop_size=8), algo="cmaes", n_slots=1, sib=True)
    svc.submit(JobRequest(algo="cmaes", seed=0, budget=4, init_state=migrated_champion,
                          sigma_shrink=0.25))
    (job,) = svc.run_jobs([])
    seed_metric = float(TO.combined_metric(TO.evaluate(SIB, migrated_champion)))
    assert job.metric <= seed_metric * (1 + 1e-6)
    assert_reference_agrees(RSIB, job)


# --------------------------------------------------------------- islands

def test_one_island_pool_is_the_plain_pool():
    specs = [request(i, budget=4) for i in range(4)]
    plain = by_seed(pool(n_slots=2).run_jobs(specs))
    svc = pool(n_slots=2, islands=TI.IslandConfig(1, 2))
    one = by_seed(svc.run_jobs([s.replace(islands=TI.IslandConfig(1, 2)) for s in specs]))
    for seed in plain:
        assert_same_job(one[seed], plain[seed])


def test_islands_pool_slot_is_its_own_islands_run(migrated_champion):
    """An islands pool's slot equals `islands.member_round` on the slot's
    own generators and generation count; a warm seed lands on island 0."""
    icfg = TI.IslandConfig(3, 2)
    svc = pool(n_slots=2, islands=icfg, sib=True)
    cold = svc.submit(request(5, budget=6))
    warm = svc.submit(request(6, budget=6, init_state=migrated_champion))
    assert (cold, warm) == (0, 1)
    cfg = svc.job(warm).cfg
    sk, traced = TH.split_fields(TH.tracify(cfg, "cpu"))
    gens = TS.job_generators(6, None, 3, "cpu")
    pop, fresh = TW.canonicalize(SIB, migrated_champion, 8)
    want = TI.member_warm_init(SIB, "nsga2", sk, icfg, traced, pop, fresh,
                               torch.tensor(0.15), torch.tensor(0.25), gens)
    assert_trees_equal(TP.member(svc.states, 1), want)
    svc.step()
    done = svc.step()
    assert done == []
    for g in (0, 2):
        want, best = TI.member_round(SIB, "nsga2", sk, icfg, 2, traced, want,
                                     TS.job_generators(6, g, 3, "cpu"),
                                     torch.tensor(g, dtype=torch.int32))
    assert_trees_equal(TP.member(svc.states, 1), want)
    np.testing.assert_array_equal(svc.job(warm).best_objs, best.numpy())
    done = svc.run_jobs([])
    for j in done:
        assert_reference_agrees(RSIB, j)
    assert svc.stats()["n_islands"] == 3 and svc.step_compiles == 1


# ----------------------------------------------------- one program a step

@pytest.mark.parametrize("case", ["nsga2", "nsga2_fused", "islands"])
def test_step_ops_do_not_depend_on_occupancy(case):
    """The aten ops of a step are the same with 1 and with 3 of 3 slots
    occupied: vacant slots run the same batched program."""
    base = TN.NSGA2Config(pop_size=8, fused=case == "nsga2_fused")
    icfg = TI.IslandConfig(2, 1) if case == "islands" else None
    ops = {}
    for n_active in (1, 3):
        svc = pool(base, n_slots=3, islands=icfg)
        for i in range(n_active):
            svc.submit(request(i, budget=8, cfg=base, islands=icfg))
        with OpCount() as mode:
            assert svc.step() == []
        ops[n_active] = mode.ops
    assert len(ops[1]) > 0 and ops[1] == ops[3]


@pytest.mark.parametrize("case", ["nsga2", "islands"])
def test_step_derives_its_generators_on_the_host(case, monkeypatch):
    """A step seeds every slot's (and island's) generator from host words:
    it draws no seeds on the device, which on the card is a read back per
    slot."""
    icfg = TI.IslandConfig(3, 2) if case == "islands" else None
    svc = pool(n_slots=2, islands=icfg)
    svc.submit(request(0, budget=4, islands=icfg))

    def device_seeds(*args, **kw):
        raise AssertionError("a step drew generator seeds on the device")
    monkeypatch.setattr(TP, "member_generators", device_seeds)
    monkeypatch.setattr(TI, "island_generators", device_seeds)
    assert svc.step() == [] and svc.step()[0].gens == 4


# --------------------------------------------------- meter, tracing, metrics

def test_compile_meter_scopes_builds_to_the_thread():
    meter = compile_cache.meter()
    before = meter.compiles
    with meter.measure() as outer:
        other = threading.Thread(target=meter.record, args=(2, 0.5))
        other.start()
        other.join(timeout=30)
        assert not other.is_alive()
        with meter.measure() as inner:
            meter.record(1, 0.25)
    assert (inner.compiles, inner.secs) == (1, 0.25)
    assert (outer.compiles, outer.secs) == (1, 0.25)
    assert meter.compiles == before + 3 and meter.recompiles == meter.compiles


def test_kernel_builds_report_to_the_meter(tmp_path, monkeypatch):
    """`_build.build` counts every library it compiled (here with a stand-in
    compiler that answers --version and writes its -o file) on the calling
    thread's scope."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nif [ "$1" = "--version" ]; then echo "fake nvcc"; exit 0; fi\n'
                    'while [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    meter = compile_cache.meter()
    before = meter.compiles
    with meter.measure() as m:
        logs = _build.build()
        assert _build.build() == {}                   # cached: nothing built
    assert sorted(logs) == sorted(_build.NAMES)
    assert m.compiles == len(_build.NAMES) == meter.compiles - before
    assert all(os.path.exists(_build.library_path(n)) for n in _build.NAMES)
    assert compile_cache.enabled_dir() == str(tmp_path / "build")


def test_tracing_spans_and_metrics_keep_the_reference_names():
    tracing.enable()
    try:
        tracing.tracer().clear()
        svc = pool(n_slots=2, label="traced-pool")
        jid = svc.submit(request(0, budget=2))
        svc.submit(request(1, budget=4))
        svc.step()
        assert svc.prewarm_size(3) and not svc.prewarm_size(3)
        svc.grow(3)
        svc.cancel(jid + 1)
        names = [(e.name, e.kind) for e in tracing.tracer().events()]
    finally:
        tracing.disable()
    for want in [("pool.build", "begin"), ("pool.build", "end"), ("job.submit", "instant"),
                 ("job.admitted", "instant"), ("pool.step", "begin"), ("pool.step", "end"),
                 ("job.harvested", "instant"), ("pool.prewarm_size", "begin"),
                 ("pool.prewarm_size", "end"), ("pool.grow", "begin"), ("pool.grow", "end"),
                 ("job.cancelled", "instant")]:
        assert want in names
    assert svc.stats()["prewarmed_sizes"] == [3]
    text = telemetry.registry().prometheus_text()
    for name in ("repro_service_steps_total", "repro_useful_gens_total",
                 "repro_jobs_harvested_total", "repro_jobs_cancelled_total",
                 "repro_service_step_ms_bucket", 'repro_pool_best_metric{pool="traced-pool"}',
                 "repro_compiles_total", "repro_compile_seconds_total"):
        assert name in text


# -------------------------------------------------------------- launcher

def test_placement_launcher_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--placement", "--torch-device", "cpu", "--requests", "3",
                    "--slots", "2", "--pop", "8", "--gens", "4", "--gens-per-step", "2",
                    "--islands", "2", "--migrate-every", "2"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["job0", "job1", "job2"]
    assert "2 islands/slot (migrate every 2)" in lines[-1]
    assert lines[-1].endswith("step compiles: 1")
