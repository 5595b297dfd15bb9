"""Serving launcher of the PyTorch port: an LM engine or the placement service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch <any of configs.ARCHS> [--reduced]
        [--requests 4] [--max-new 16] [--torch-device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        [--device xcvu_test] [--slots 8] [--pop 32] [--gens 64] \
        [--gens-per-step 4] [--fused] [--islands N --migrate-every G] \
        [--warm-from xcvu_test --warm-gens 100] [--torch-device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        --cache [--cache-path P] [--policy round_robin|priority|deadline] \
        [--autoscale] [--prewarm] [--compile-cache-dir D]
    PYTHONPATH=src python -m repro_torch.launch.serve --placement --frontend \
        [--requests 16] [--max-queue 8] [--cancel-every 5]

The LM branch of `repro/launch/serve.py`: builds `--arch` (any of the ten:
dense, MoE, hybrid mamba, RWKV or a frontend backbone; full width, or its
reduced smoke-test variant) in fp32 with weights drawn from seed 0,
serves `--requests` random prompts of 4-10 tokens (numpy `default_rng(0)`)
through an `Engine` with max(2, requests // 2) slots and max_len 96, and
prints one `reqN:` line of generated tokens per request.

`--placement` is the reference's `placement_main`: `--requests` NSGA-II
jobs (`make_job_specs`) through one `serve.placement_service` pool on the
FPGA device `--device`, printing each job's result and the pool's jobs/s,
gens/s and the slot counts it stepped ("step compiles", 1 for a pool
that does not grow).  `--warm-from BASE` first converges a champion on
BASE (`transfer.converge_champion`, pop 2 x `--pop`), migrates it onto
`--device`, and races every job cold and transfer-seeded to the migrated
champion's metric.

The control-plane flags are the reference's `control_plane_main`: the same
workload through `serve.scheduler.PlacementScheduler` instead of a bare
pool, in two waves.  `--cache [--cache-path P]` attaches a champion store
(the second wave of identical jobs is answered from the cache),
`--policy {round_robin,priority,deadline}` picks the pool-stepping policy
(under `deadline` an urgent job of half the pop size, submitted last, gets
its own pool), `--autoscale` lets queue depth grow pools along the slot
ladder, and `--prewarm` attaches the background prewarmer
(`serve.prewarm`): store-predicted pools build off the stepping thread
and the next ladder size runs ahead of `grow()`.  `--compile-cache-dir D`
(or `REPRO_COMPILE_CACHE_DIR`) builds and loads the CUDA kernel libraries
in D (`runtime.compile_cache`), so a restarted launcher runs no nvcc.
`--frontend` serves the workload through the asyncio front-end
(`serve.frontend.PlacementFrontend`): one client task per request,
client 0 streaming progress, `--cancel-every K` cancelling every K-th job,
`--max-queue` bounding outstanding admissions; it composes with every
control-plane flag.

Observability (`runtime.telemetry`, `serve.tracing`): `--metrics-port N`
serves Prometheus text at `/metrics` (0 = an ephemeral port, printed),
`--trace-file P` writes trace events as JSONL (also `REPRO_TRACE_FILE`),
`--chrome-trace P` a Chrome trace of every span at exit, `--metrics-dump P`
the exposition body at exit, and `--profile-dir D` a `torch.profiler`
trace of the workload under D.  `--arch A --dry-run [--shape S]
[--multi-pod]` traces the full config's step on the production mesh through
`launch.dryrun`, in a fresh interpreter.

Both run on the CUDA card unless `--torch-device cpu` is given, and raise
when there is no card.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_arch, get_reduced
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine


def _telemetry_setup(args):
    """Start the flagged exporters; returns a finalizer to run at exit.

    Tracing is enabled before any pool or scheduler is built, so pool.build
    spans and job.submit events are captured from the first request.  The
    finalizer stops the profiler, writes the one-shot exports
    (--chrome-trace, --metrics-dump) and flushes file sinks.
    """
    from repro_torch.runtime import telemetry
    from repro_torch.serve import tracing

    if args.trace_file or args.chrome_trace:
        # a chrome-trace export needs the in-memory span ring even when no
        # JSONL sink was requested
        tracing.enable(jsonl_path=args.trace_file)
    else:
        tracing.maybe_enable_from_env()

    metrics_url = None
    if args.metrics_port is not None:
        _, port = telemetry.start_http_server(args.metrics_port)
        metrics_url = f"http://127.0.0.1:{port}/metrics"
        print(f"metrics: {metrics_url}")

    prof = None
    if args.profile_dir:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if args.torch_device == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()

    def finalize():
        if prof is not None:
            prof.stop()
            os.makedirs(args.profile_dir, exist_ok=True)
            path = os.path.join(args.profile_dir, "trace.json")
            prof.export_chrome_trace(path)
            print(f"torch profile: {path}")
        if args.chrome_trace:
            tracing.write_chrome_trace(args.chrome_trace)
            print(f"chrome trace: {args.chrome_trace}")
        if args.metrics_dump:
            # scrape our own endpoint so the dump exercises the HTTP
            # exporter end to end (exposition headers included via GET)
            if metrics_url is not None:
                import urllib.request
                with urllib.request.urlopen(metrics_url, timeout=10) as r:
                    body = r.read().decode("utf-8")
            else:
                body = telemetry.registry().prometheus_text()
            with open(args.metrics_dump, "w", encoding="utf-8") as f:
                f.write(body)
            print(f"metrics dump: {args.metrics_dump}")
        if tracing.enabled():
            tracing.tracer().close_sinks()

    return finalize


def _island_config(args):
    """--islands N [--migrate-every G] -> IslandConfig (None when off)."""
    if args.islands <= 1:
        return None
    from repro_torch.core.islands import IslandConfig
    return IslandConfig(args.islands, args.migrate_every)


def placement_main(args) -> None:
    from repro_torch.core import nsga2
    from repro_torch.fpga import device, netlist
    from repro_torch.serve.placement_service import PlacementService, make_job_specs

    dev = resolve_device(args.torch_device)
    prob = netlist.make_problem(device.get_device(args.device))
    base = nsga2.NSGA2Config(pop_size=args.pop, fused=args.fused)
    svc = PlacementService(prob, base, n_slots=args.slots,
                           gens_per_step=args.gens_per_step,
                           islands=_island_config(args), device=dev)
    specs = make_job_specs(args.requests, args.pop, args.gens, fused=args.fused)

    if args.warm_from:
        from repro_torch.core import objectives as O
        from repro_torch.core import transfer

        base_prob = netlist.make_problem(device.get_device(args.warm_from))
        print(f"converging champion on {args.warm_from} "
              f"({args.warm_gens} gens)...")
        champ = transfer.converge_champion(
            base_prob, torch.Generator(device=dev).manual_seed(0), 2 * args.pop,
            args.warm_gens)
        g_mig = transfer.migrate(base_prob, prob, champ)
        target = float(O.combined_metric(O.evaluate(prob, g_mig)))
        print(f"migrated champion metric on {args.device}: {target:.3e}; "
              "racing warm vs cold to that target")
        # every spec twice: cold and warm-seeded, chasing the same target
        specs = [dict(s, target=target) for s in specs] + \
                [dict(s, target=target, init_state=g_mig) for s in specs]

    t0 = time.perf_counter()
    done = svc.run_jobs(specs)
    dt = time.perf_counter() - t0
    for j in sorted(done, key=lambda j: j.jid):
        tag = " warm" if j.warm else ""
        print(f"job{j.jid}{tag}: {j.gens} gens  wl2={j.best_objs[0]:.3e}  "
              f"bbox={j.best_objs[1]:.0f}  metric={j.metric:.3e}")
    if args.warm_from:
        cold = [j.gens for j in done if not j.warm]
        warm = [j.gens for j in done if j.warm]
        print(f"gens to target: cold mean {np.mean(cold):.1f}, "
              f"warm mean {np.mean(warm):.1f} "
              f"({np.mean(cold) / max(np.mean(warm), 1e-9):.1f}x fewer)")
    s = svc.stats()
    isl = (f", {s['n_islands']} islands/slot "
           f"(migrate every {s['migrate_every']})"
           if s["n_islands"] > 1 else "")
    print(f"{len(done)} jobs in {dt:.2f}s "
          f"({len(done)/dt:.2f} jobs/s, {s['useful_gens']/dt:.1f} gens/s) "
          f"on {args.slots} slots{isl} ({dev}); step compiles: "
          f"{s['step_compiles']}")


def _scheduler(args):
    """The control plane the flags describe, on `--torch-device`."""
    from repro_torch.serve.champion_store import ChampionStore
    from repro_torch.serve.scheduler import PlacementScheduler

    store = (ChampionStore(path=args.cache_path)
             if (args.cache or args.cache_path) else None)
    return PlacementScheduler(n_slots=args.slots, gens_per_step=args.gens_per_step,
                              policy=args.policy, store=store, autoscale=args.autoscale,
                              prewarm=args.prewarm, device=args.torch_device), store


def control_plane_main(args) -> None:
    """Placement traffic through the scheduler control plane: champion
    cache (`--cache`), stepping policy (`--policy`), pool autoscaling
    (`--autoscale`) -- two waves of the same workload so cache effects are
    visible live."""
    from repro_torch.core import nsga2
    from repro_torch.serve.api import JobRequest
    from repro_torch.serve.placement_service import make_job_specs

    sch, store = _scheduler(args)
    icfg = _island_config(args)
    if args.prewarm and store is not None:
        # a persisted store carries its historical signature traffic:
        # start building the predicted working set before the first job
        keys = sch.prewarm_predicted()
        if keys:
            print(f"prewarming {len(keys)} store-predicted pool(s) "
                  "in the background...")

    if args.warm_from:
        # control-plane spelling of --warm-from: converge a champion on
        # the base device and seed the STORE with it -- every job on
        # --device then warm-starts via signature discovery
        if store is None:
            raise SystemExit("--warm-from with a control-plane flag needs "
                             "--cache (the champion rides in the store)")
        from repro_torch.core import objectives as O
        from repro_torch.core import transfer

        base_prob = sch.problem(args.warm_from)
        print(f"seeding store from {args.warm_from} "
              f"({args.warm_gens} gens)...")
        champ = transfer.converge_champion(
            base_prob, torch.Generator(device=sch.device).manual_seed(0), 2 * args.pop,
            args.warm_gens)
        objs = O.evaluate(base_prob, champ)
        store.put(base_prob, champ, float(O.combined_metric(objs)), objs,
                  provenance={"source": "warm_from", "algo": "nsga2"})

    def wave(tag, specs, **kw):
        t0 = time.perf_counter()
        jids = [sch.submit_request(JobRequest(
                    device=args.device, cfg=s["cfg"], seed=s["seed"],
                    budget=s["budget"], target=s.get("target"),
                    islands=icfg, **kw))
                for s in specs]
        done = {j.jid: j for j in sch.run_all()}
        dt = time.perf_counter() - t0
        for jid in jids:
            j, r = done[jid], done[jid].result
            how = ("cache-hit" if j.cached else
                   "warm" if j.warm_from_cache else "cold")
            print(f"  job{jid} [{how:9s}] {r.gens:3d} gens  "
                  f"metric={r.metric:.3e}")
        print(f"  {tag}: {len(jids)} jobs in {dt:.2f}s")
        return done

    specs = make_job_specs(args.requests, args.pop, args.gens, fused=args.fused)
    if args.policy == "deadline":
        # the last-submitted job is the most urgent; EDF picks which POOL
        # steps, so the urgent job gets its own pool (half the pop size)
        # and is served ahead of the earlier-submitted bulk pool
        print("wave 1 (deadline policy: last job has the tight deadline)")
        urgent_cfg = nsga2.NSGA2Config(pop_size=max(2, args.pop // 2), fused=args.fused)
        for s in specs:
            sch.submit_request(JobRequest(
                device=args.device, cfg=s["cfg"], seed=s["seed"],
                budget=s["budget"], deadline=1e9, islands=icfg))
        ujid = sch.submit_request(JobRequest(
            device=args.device, cfg=urgent_cfg, seed=0,
            budget=args.gens, deadline=1.0, islands=icfg))
        order = [j.jid for j in sch.run_all()]
        print(f"  urgent job finished {order.index(ujid) + 1}/{len(order)}")
    else:
        print("wave 1 (cold)")
        wave("wave 1", specs)
    if store is not None:
        # target against the serving device's OWN champion when it has
        # one (metrics don't compare across devices), else the best entry
        own = store.get(sch.problem(args.device).signature)
        best = (own.metric if own is not None
                else min(e.metric for e in store.entries()))
        print(f"wave 2 (served against cache, target={best:.3e})")
        wave("wave 2", [dict(s, target=best * 1.001) for s in specs])
        print(f"  cache: {store.stats()}")
        if args.cache_path:
            print(f"  persisted {len(store)} champions -> "
                  f"{store.save(args.cache_path)}")
    sch.close()
    s = sch.stats()
    if args.autoscale:
        print(f"autoscale events (pool, old, new): {s['autoscale_events']}")
    print(f"{s['n_pools']} pools, policy={s['policy']} ({sch.device}); per-pool "
          f"sizes/compiles: " + ", ".join(
              f"{ps['sizes']}x{ps['step_compiles']}"
              for ps in s["pools"].values()))


def frontend_main(args) -> None:
    """--frontend: the same placement workload, served through the asyncio
    front-end -- N concurrent client coroutines, mixed priorities, optional
    mid-flight cancellations, live progress for client 0, and per-client
    submit->result latency percentiles at the end."""
    import asyncio

    from repro_torch.serve.api import JobRequest
    from repro_torch.serve.frontend import PlacementFrontend
    from repro_torch.serve.placement_service import make_job_specs

    sch, _ = _scheduler(args)
    icfg = _island_config(args)
    specs = make_job_specs(args.requests, args.pop, args.gens, fused=args.fused)
    lat: list = []

    async def client(fe, i, spec):
        req = JobRequest(device=args.device, cfg=spec["cfg"],
                         seed=spec["seed"], budget=spec["budget"],
                         priority=float(i % 3), islands=icfg)
        t0 = time.perf_counter()
        handle = await fe.submit(req)
        if i == 0:                         # one client streams progress
            async for u in handle.progress():
                eta = f"  eta={u.eta_s:.1f}s" if u.eta_s else ""
                print(f"  job{u.jid} progress: gen {u.gens}/{u.budget}"
                      f"  metric={u.metric:.3e}{eta}")
        if args.cancel_every and (i + 1) % args.cancel_every == 0:
            handle.cancel()
            try:
                await handle.wait()
            except Exception:              # noqa: BLE001 -- demo client
                pass
            print(f"  client{i:2d}: [{handle.status.value}]")
            return
        r = await handle.wait()
        lat.append(time.perf_counter() - t0)
        print(f"  client{i:2d}: job{handle.jid} {r.gens:3d} gens  "
              f"metric={r.metric:.3e}")

    async def run():
        t0 = time.perf_counter()
        async with PlacementFrontend(sch, max_queue=args.max_queue) as fe:
            await asyncio.gather(*[client(fe, i, s)
                                   for i, s in enumerate(specs)])
            stats = fe.stats()
        return stats, time.perf_counter() - t0

    stats, dt = asyncio.run(run())
    if lat:
        p50, p99 = np.percentile(np.array(lat) * 1e3, [50, 99])
        print(f"submit->result latency: p50={p50:.0f}ms p99={p99:.0f}ms")
    print(f"{stats['completed']} done / {stats['cancelled']} cancelled / "
          f"{stats['failed']} failed in {dt:.2f}s "
          f"({stats['completed'] / dt:.2f} jobs/s); backpressure waits: "
          f"{stats['backpressure_waits']}")
    fleet = stats["fleet"]
    print(f"{fleet['n_pools']} pool(s) ({sch.device}); per-pool sizes/compiles: "
          + ", ".join(f"{p['sizes']}x{p['step_compiles']}"
                      for p in fleet["pools"].values()))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dry-run", action="store_true",
                    help="trace the full config's step on the production mesh")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    # placement-service mode
    ap.add_argument("--placement", action="store_true",
                    help="serve placement jobs instead of an LM")
    ap.add_argument("--device", default="xcvu_test",
                    help="FPGA device of the placement jobs")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--gens", type=int, default=64,
                    help="generation budget per placement job")
    ap.add_argument("--gens-per-step", type=int, default=4)
    ap.add_argument("--fused", action="store_true",
                    help="evaluate through the fused kernels (fused_eval, "
                         "domination with counts); static pool identity")
    ap.add_argument("--islands", type=int, default=1, metavar="N",
                    help="island sub-populations per slot (core.islands); "
                         "1 = single-population pools")
    ap.add_argument("--migrate-every", type=int, default=4, metavar="G",
                    help="generations between ring champion migrations "
                         "inside an islands slot")
    ap.add_argument("--warm-from", default=None, metavar="DEVICE",
                    help="transfer-seed jobs from a champion converged on "
                         "this base device (e.g. xcvu_test)")
    ap.add_argument("--warm-gens", type=int, default=100,
                    help="generations to converge the base champion")
    # control-plane flags (route through serve.scheduler)
    ap.add_argument("--cache", action="store_true",
                    help="attach a champion store: repeat jobs are served "
                         "from cache / warm-started by signature")
    ap.add_argument("--cache-path", default=None, metavar="JSON",
                    help="persist the champion store to this JSON file")
    ap.add_argument("--policy", default="round_robin",
                    choices=("round_robin", "priority", "deadline"),
                    help="pool stepping policy (serve.policy)")
    ap.add_argument("--autoscale", action="store_true",
                    help="grow pools along the slot ladder on queue depth")
    ap.add_argument("--compile-cache-dir", default=None, metavar="DIR",
                    help="build and load the CUDA kernel libraries in this "
                         "directory (also honoured via the "
                         "REPRO_COMPILE_CACHE_DIR environment variable): a "
                         "restarted process loads them instead of running nvcc")
    ap.add_argument("--prewarm", action="store_true",
                    help="background pool prewarmer (serve.prewarm): "
                         "store-predicted pools and autoscale ladder sizes "
                         "are built and stepped off the stepping thread")
    # observability flags (runtime.telemetry / serve.tracing)
    ap.add_argument("--metrics-port", type=int, default=None, metavar="N",
                    help="serve Prometheus text exposition at "
                         "http://127.0.0.1:N/metrics (0 = pick an "
                         "ephemeral port, printed at startup)")
    ap.add_argument("--trace-file", default=None, metavar="JSONL",
                    help="enable structured tracing (serve.tracing) with "
                         "a JSONL event sink at this path; also honoured "
                         "via the REPRO_TRACE_FILE environment variable")
    ap.add_argument("--chrome-trace", default=None, metavar="JSON",
                    help="write a Perfetto-loadable Chrome trace of all "
                         "spans at exit (implies tracing on)")
    ap.add_argument("--metrics-dump", default=None, metavar="TXT",
                    help="at exit, scrape this process's own /metrics "
                         "endpoint (or render the registry directly when "
                         "--metrics-port is absent) and write the body")
    ap.add_argument("--profile-dir", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the workload "
                         "(trace.json) under this directory")
    # async front-end flags (route through serve.frontend)
    ap.add_argument("--frontend", action="store_true",
                    help="serve through the asyncio front-end "
                         "(serve.frontend): concurrent clients, streaming "
                         "progress, cancellation, backpressure")
    ap.add_argument("--max-queue", type=int, default=32,
                    help="front-end admission bound: submits beyond this "
                         "many outstanding jobs await a free credit")
    ap.add_argument("--cancel-every", type=int, default=0, metavar="K",
                    help="with --frontend, cancel every K-th job "
                         "mid-flight (0 = never)")
    args = ap.parse_args(argv)

    if args.placement:
        from repro_torch.runtime import compile_cache
        enabled = compile_cache.maybe_enable_from_env(args.compile_cache_dir)
        if enabled:
            print(f"kernel build cache: {enabled} ({compile_cache.cache_salt()})")
        finalize = _telemetry_setup(args)
        try:
            if args.frontend:
                frontend_main(args)
            elif (args.cache or args.cache_path or args.autoscale
                  or args.prewarm or args.policy != "round_robin"):
                control_plane_main(args)
            else:
                placement_main(args)
        finally:
            finalize()
        return
    if args.arch is None:
        ap.error("--arch is required")
    if args.dry_run:     # a fresh interpreter: the fake process group is process-global
        import subprocess

        from repro_torch.launch import dryrun
        cmd, env = dryrun.command(args.arch, args.shape, args.multi_pod,
                                  device=args.torch_device)
        raise SystemExit(subprocess.run(cmd, env=env).returncode)

    dev = resolve_device(args.torch_device)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    model = Transformer(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, n_slots=max(2, args.requests // 2), max_len=96, eos_id=-1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 10)).astype(np.int32)
               for _ in range(args.requests)]
    for i, toks in eng.generate(prompts, max_new=args.max_new).items():
        print(f"req{i}: {toks}")


if __name__ == "__main__":
    main()
