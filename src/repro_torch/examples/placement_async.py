"""Async placement serving: concurrent clients, cancellation, backpressure.

Port of `examples/placement_async.py`:

    PYTHONPATH=src python -m repro_torch.examples.placement_async [--clients 12] [--torch-device cpu]

The asyncio front-end (`serve.frontend.PlacementFrontend`) owns a
background stepping thread over a `PlacementScheduler`; this example runs
N concurrent client coroutines against it:

  * every client builds a `serve.api.JobRequest` (mixed priorities: every
    third client is "urgent" under the priority stepping policy) and
    `await`s admission -- with `--max-queue` smaller than the client
    count, later clients experience real backpressure (their submit
    suspends until earlier jobs finish),
  * one client streams live progress (`async for u in handle.progress()`:
    generation, best metric, ETA),
  * every `--cancel-every`-th client cancels its job mid-flight and shows
    the slot being reused by the remaining traffic,
  * at the end: per-client submit->result latency percentiles, front-end
    counters, and each pool's slot counts and `step_compiles` --
    concurrency changed latency, never results.
"""
import argparse
import asyncio
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import nsga2
from repro_torch.serve.api import JobCancelledError, JobRequest
from repro_torch.serve.frontend import PlacementFrontend
from repro_torch.serve.scheduler import PlacementScheduler


async def client(fe, i, args, latencies):
    rng = np.random.default_rng(1000 + i)
    req = JobRequest(
        device=args.device,
        cfg=nsga2.NSGA2Config(pop_size=args.pop,
                              sbx_eta=float(rng.uniform(5.0, 25.0)),
                              real_mut_prob=float(rng.uniform(0.05, 0.3))),
        seed=1000 + i, budget=args.budget,
        priority=2.0 if i % 3 == 0 else 0.0)
    t0 = time.perf_counter()
    handle = await fe.submit(req)          # may suspend: bounded admission
    t_admit = time.perf_counter() - t0

    if i == 0:                             # one client narrates progress
        async for u in handle.progress():
            eta = f"  eta={u.eta_s:.1f}s" if u.eta_s else ""
            print(f"    job{u.jid}: gen {u.gens}/{u.budget}  "
                  f"metric={u.metric:.3e}{eta}")

    if args.cancel_every and (i + 1) % args.cancel_every == 0:
        # let it run a moment, then cancel mid-flight: the slot frees at
        # the next step boundary and co-tenant jobs are untouched
        await asyncio.sleep(0.05)
        handle.cancel()
        try:
            await handle.wait()
        except JobCancelledError:
            pass
        print(f"  client{i:2d}: [{handle.status.value}]  "
              f"(admitted after {t_admit * 1e3:.0f}ms)")
        return

    result = await handle.wait()
    dt = time.perf_counter() - t0
    latencies.append(dt)
    urgent = " *urgent*" if req.priority > 0 else ""
    print(f"  client{i:2d}: job{handle.jid} {result.gens:3d} gens  "
          f"metric={result.metric:.3e}  {dt * 1e3:.0f}ms"
          f"  (admit {t_admit * 1e3:.0f}ms){urgent}")


async def run(args):
    sched = PlacementScheduler(n_slots=args.slots,
                               gens_per_step=args.gens_per_step,
                               policy="priority",
                               device=resolve_device(args.torch_device))
    latencies = []
    t0 = time.perf_counter()
    async with PlacementFrontend(sched, max_queue=args.max_queue) as fe:
        print(f"{args.clients} clients -> max_queue={args.max_queue}, "
              f"{args.slots} slots (backpressure when the bound is hit)")
        await asyncio.gather(*[client(fe, i, args, latencies)
                               for i in range(args.clients)])
        stats = fe.stats()
    wall = time.perf_counter() - t0        # aclose drained + persisted

    print()
    if latencies:
        p50, p99 = np.percentile(np.array(latencies) * 1e3, [50, 99])
        print(f"submit->result latency: p50={p50:.0f}ms  p99={p99:.0f}ms")
    print(f"{stats['completed']} done / {stats['cancelled']} cancelled in "
          f"{wall:.2f}s ({stats['completed'] / wall:.2f} jobs/s); "
          f"{stats['backpressure_waits']} submits saw backpressure")
    fleet = stats["fleet"]
    compiles = ", ".join(f"{p['sizes']}x{p['step_compiles']}"
                         for p in fleet["pools"].values())
    print(f"fleet: {fleet['n_pools']} pool(s), sizes/step-compiles "
          f"{compiles} -- concurrency changed latency, never compiles")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="xcvu_test")
    ap.add_argument("--clients", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--budget", type=int, default=16)
    ap.add_argument("--gens-per-step", type=int, default=4)
    ap.add_argument("--max-queue", type=int, default=8,
                    help="admission bound; < --clients shows backpressure")
    ap.add_argument("--cancel-every", type=int, default=5, metavar="K",
                    help="cancel every K-th client's job mid-flight "
                         "(0 = never)")
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
