"""The port's asyncio front-end (`repro_torch.serve.frontend`) on the CPU.

Mirrors `tests/test_frontend.py` on the port: one request type for the
pool and the scheduler (the kwarg shims give the same jobs bit for bit),
versioned stats, cancellation at step boundaries, backpressure, drain,
progress streams and failure isolation.  The front-end steps the scheduler
on a thread of its own, so the concurrent-submit case also holds the
port's batched step (`torch.func.vmap` and the kernels' custom-op vmap
rules) on that thread against the same requests stepped on the main
thread, bit for bit.

No pytest-asyncio in the toolchain: async scenarios run under
`asyncio.run()` inside synchronous tests.
"""
import asyncio
import contextlib
import io
import json
import warnings

import numpy as np
import pytest
from test_torch_service import assert_same_job

from repro_torch.core import nsga2 as TN
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet
from repro_torch.launch import serve
from repro_torch.serve import tracing
from repro_torch.serve.api import (JobCancelledError, JobRequest, JobStatus,
                                   QueueFull)
from repro_torch.serve.frontend import PlacementFrontend
from repro_torch.serve.placement_service import PlacementService
from repro_torch.serve.scheduler import PlacementScheduler

BASE = tnet.make_problem(tdev.get_device("xcvu_test"))
CFG = TN.NSGA2Config(pop_size=8)


@pytest.fixture(autouse=True)
def no_batching_fallback():
    """vmap running an op slice by slice (no batching rule) is an error, on
    the stepping thread too (warning filters are process-wide)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*batching rule")
        yield


def sched(n_slots=1):
    return PlacementScheduler(n_slots=n_slots, gens_per_step=2, device="cpu")


def _req(seed: int, budget: int = 4, **kw) -> JobRequest:
    return JobRequest(device="xcvu_test", cfg=CFG, seed=seed, budget=budget, **kw)


def _drain_service(svc) -> dict:
    done = {}
    while svc.active.any():
        for j in svc.step():
            done[j.jid] = j
    return done


# ------------------------------------------------- unified request type

def test_service_kwargs_vs_request_bitwise_identical():
    svc_kw = PlacementService(BASE, CFG, n_slots=1, gens_per_step=2, device="cpu")
    with pytest.warns(DeprecationWarning, match="JobRequest"):
        jid_kw = svc_kw.submit(cfg=CFG, seed=7, budget=4)
    svc_rq = PlacementService(BASE, CFG, n_slots=1, gens_per_step=2, device="cpu")
    jid_rq = svc_rq.submit_request(JobRequest(cfg=CFG, seed=7, budget=4))
    assert_same_job(_drain_service(svc_kw)[jid_kw], _drain_service(svc_rq)[jid_rq])


def test_scheduler_kwargs_vs_request_bitwise_identical():
    s_kw = sched()
    with pytest.warns(DeprecationWarning, match="JobRequest"):
        jid_kw = s_kw.submit("xcvu_test", CFG, seed=9, budget=4)
    s_rq = sched()
    jid_rq = s_rq.submit_request(_req(seed=9))
    a = {j.jid: j for j in s_kw.run_all()}[jid_kw].result
    b = {j.jid: j for j in s_rq.run_all()}[jid_rq].result
    assert_same_job(a, b)


def test_request_validation_rejects_mismatched_routing():
    svc = PlacementService(BASE, CFG, n_slots=1, gens_per_step=2, device="cpu")
    with pytest.raises(ValueError, match="algo"):
        svc.submit_request(JobRequest(cfg=CFG, algo="cmaes", seed=0))
    with pytest.raises(ValueError, match="gens_per_step"):
        svc.submit_request(JobRequest(cfg=CFG, seed=0, gens_per_step=7))
    with pytest.raises(ValueError, match="device"):
        sched().submit_request(JobRequest(cfg=CFG, seed=0))
    with pytest.raises(ValueError, match="cfg"):
        sched().submit_request(JobRequest(device="xcvu_test", seed=0))


def test_stats_schema_versioned_across_layers():
    sch = sched()
    sch.submit_request(_req(seed=3))
    sch.run_all()
    f = sch.stats()
    assert f["schema_version"] == 2
    assert f["jobs_done"] == 1 and f["jobs_cancelled"] == 0
    assert "job_latency_ms_hist" in f
    assert all(p["schema_version"] == 2 for p in f["pools"].values())


# --------------------------------------------------------- cancellation

def test_scheduler_cancel_pending_and_inflight():
    sch = sched()
    running = sch.submit_request(_req(seed=1, budget=8))
    queued = sch.submit_request(_req(seed=2))
    waiting = sch.submit_request(_req(seed=3))
    assert sch.jobs[running].status is JobStatus.RUNNING
    assert sch.jobs[queued].status is JobStatus.QUEUED
    assert sch.cancel(queued) is True              # leaves the FIFO
    assert sch.cancel(running) is True             # frees + refills the slot
    assert sch.jobs[waiting].status is JobStatus.RUNNING
    assert {j.jid for j in sch.run_all()} == {waiting}
    assert sch.cancel(waiting) is False            # terminal: too late
    s = sch.stats()
    assert s["jobs_cancelled"] == 2 and s["jobs_done"] == 1


def test_frontend_cancel_frees_slot_at_step_boundary():
    async def main():
        async with PlacementFrontend(sched(), max_queue=4) as fe:
            big = await fe.submit(_req(seed=1, budget=10_000))
            small = await fe.submit(_req(seed=2, budget=4))
            async for _ in big.progress():      # the long job holds the slot
                break
            assert big.cancel() is True
            with pytest.raises(JobCancelledError):
                await big.wait()
            assert big.status is JobStatus.CANCELLED
            r = await small.wait()              # ran in the freed slot
            assert r.done and r.gens == 4
            return fe.stats()
    s = asyncio.run(main())
    assert s["cancelled"] == 1 and s["completed"] == 1
    assert s["fleet"]["jobs_cancelled"] == 1


# --------------------------------------------------------- backpressure

def test_backpressure_blocks_then_drains():
    async def main():
        async with PlacementFrontend(sched(n_slots=2), max_queue=2) as fe:
            h1 = fe.submit_nowait(_req(seed=1, budget=10_000))
            h2 = fe.submit_nowait(_req(seed=2, budget=10_000))
            with pytest.raises(QueueFull):
                fe.submit_nowait(_req(seed=3))
            assert fe.queue_full_rejections == 1
            blocked = asyncio.create_task(fe.submit(_req(seed=4)))
            await asyncio.sleep(0.05)
            assert not blocked.done()           # caller suspended, not erroring
            assert fe.backpressure_waits == 1
            assert h1.cancel() is True          # frees one admission credit
            h4 = await blocked
            assert (await h4.wait()).done
            h2.cancel()
            with pytest.raises(JobCancelledError):
                await h2.wait()
    asyncio.run(main())


# ------------------------------------------------------ drain under load

def test_drain_under_load_loses_and_duplicates_nothing():
    seeds = list(range(20, 28))

    async def main():
        async with PlacementFrontend(sched(n_slots=2), max_queue=len(seeds)) as fe:
            handles = [await fe.submit(_req(seed=s)) for s in seeds]
            await fe.drain()
            with pytest.raises(RuntimeError, match="draining"):
                await fe.submit(_req(seed=99))
            assert all(h.status is JobStatus.DONE for h in handles)
            results = [h.result(timeout=0) for h in handles]
            assert len({id(r) for r in results}) == len(seeds)
            assert sorted(r.seed for r in results) == seeds
            assert all(r.done and r.gens == 4 for r in results)
            s = fe.stats()
            assert s["submitted"] == s["completed"] == len(seeds)
            assert s["failed"] == 0 and s["cancelled"] == 0
            assert s["fleet"]["jobs_done"] == len(seeds)
    asyncio.run(main())


# --------------------------------------- concurrent-submit determinism

def test_concurrent_submit_matches_sequential_bitwise():
    """The stepping thread's results equal the same requests stepped on
    the main thread: the batched step (vmap and the custom ops' batching
    rules) computes the same on either thread."""
    reqs = [_req(seed=100 + i, budget=6) for i in range(5)]
    sch = sched(n_slots=2)
    jids = [sch.submit_request(r) for r in reqs]
    by_jid = {j.jid: j for j in sch.run_all()}
    ref = {r.seed: by_jid[j].result for r, j in zip(reqs, jids)}

    async def main():
        async with PlacementFrontend(sched(n_slots=2), max_queue=8) as fe:
            handles = await asyncio.gather(*[fe.submit(r) for r in reqs])
            return await asyncio.gather(*[h.wait() for h in handles])

    for r, got in zip(reqs, asyncio.run(main())):
        assert_same_job(got, ref[r.seed])


# ----------------------------------------------------- progress stream

def test_progress_stream_monotone_and_terminates():
    async def main():
        async with PlacementFrontend(sched(), max_queue=2) as fe:
            h = await fe.submit(_req(seed=5, budget=12))
            gens = []
            async for u in h.progress():
                assert u.status is JobStatus.RUNNING and np.isfinite(u.metric)
                gens.append(u.gens)
            assert gens == sorted(gens) and gens and gens[-1] <= 12
            assert h.status is JobStatus.DONE
            assert (await h.wait()).gens == 12
    asyncio.run(main())


def test_frontend_bad_request_fails_handle_not_thread():
    async def main():
        async with PlacementFrontend(sched(), max_queue=4) as fe:
            bad = await fe.submit(JobRequest(cfg=CFG, seed=0))   # no device
            with pytest.raises(ValueError, match="device"):
                await bad.wait()
            assert bad.status is JobStatus.FAILED
            good = await fe.submit(_req(seed=6))
            assert (await good.wait()).done      # co-tenants keep flowing
            s = fe.stats()
            assert s["failed"] == 1 and s["completed"] == 1
            assert fe.thread_error is None
    asyncio.run(main())


# ---------------------------------------------------------------- launcher

def test_frontend_launcher_on_cpu(tmp_path):
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            serve.main(["--placement", "--frontend", "--torch-device", "cpu", "--requests", "4",
                        "--slots", "2", "--pop", "8", "--gens", "4", "--gens-per-step", "2",
                        "--max-queue", "2", "--cancel-every", "4",
                        "--trace-file", str(tmp_path / "events.jsonl"),
                        "--profile-dir", str(tmp_path / "prof")])
    finally:
        tracing.disable()
    text = out.getvalue()
    events = [json.loads(ln) for ln in (tmp_path / "events.jsonl").read_text().splitlines()]
    assert {"job.submit", "job.harvested"} <= {e["name"] for e in events}
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "  client 3: [cancelled]" in text or "  client 3: [done]" in text
    assert [f"client{i:2d}: job" in text for i in range(3)] == [True] * 3
    assert "1 pool(s) (cpu); per-pool sizes/compiles: [2]x1" in text
