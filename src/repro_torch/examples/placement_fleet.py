"""Fleet placement: one design, every UltraScale+ device, one process.

Port of `examples/placement_fleet.py`:

    PYTHONPATH=src python -m repro_torch.examples.placement_fleet [--base xcvu_test] [--torch-device cpu]

The paper's transfer result (SS IV-D) turned into a serving pattern: a
single champion is converged once on the base device, then migrated
(`core.transfer`) onto EVERY device in `device.list_devices()` and
submitted warm (`submit(init_state=...)`) through the multi-pool
scheduler (`serve.scheduler.PlacementScheduler`).  Each (device, algo,
static config) signature gets its own lazily created `PlacementService`
pool; pools step round-robin, each stepping at one slot count
(`step_compiles` is 1).  One process, heterogeneous fleet, warm
everywhere.

Default budgets are demo-sized (the big parts get a few generations of
polish, not a converged placement); raise --budget for quality.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import cmaes, nsga2, transfer
from repro_torch.core import objectives as O
from repro_torch.fpga import device, netlist
from repro_torch.serve.api import JobRequest
from repro_torch.serve.scheduler import PlacementScheduler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default="xcvu_test",
                    help="device to converge the seed champion on")
    ap.add_argument("--base-gens", type=int, default=80)
    ap.add_argument("--pop", type=int, default=8)
    ap.add_argument("--budget", type=int, default=12,
                    help="warm generations per fleet job")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    tdev = resolve_device(args.torch_device)

    base_prob = netlist.make_problem(device.get_device(args.base))
    print(f"converging champion on {args.base} "
          f"({base_prob.n_units} units, {args.base_gens} gens)...")
    champ = transfer.converge_champion(
        base_prob, torch.Generator(device=tdev).manual_seed(0),
        4 * args.pop, args.base_gens)
    print(f"  champion metric: "
          f"{float(O.combined_metric(O.evaluate(base_prob, champ))):.3e}")

    sched = PlacementScheduler(n_slots=args.slots, gens_per_step=4,
                               device=tdev)
    jids = {}
    t0 = time.perf_counter()
    for dst in device.list_devices():
        prob = sched.problem(dst)
        g_mig = transfer.migrate(base_prob, prob, champ)
        O.assert_valid(prob, g_mig)
        # every device warm-starts NSGA-II; the base device additionally
        # races CMA-ES from the same seed -- a heterogeneous pool mix
        jids[sched.submit(JobRequest(
            device=dst, cfg=nsga2.NSGA2Config(pop_size=args.pop), seed=1,
            budget=args.budget, init_state=g_mig))] = (dst, "nsga2")
        if dst == args.base:
            jids[sched.submit(JobRequest(
                device=dst, cfg=cmaes.CMAESConfig(pop_size=args.pop),
                algo="cmaes", seed=1, budget=args.budget,
                init_state=g_mig))] = (dst, "cmaes")

    done = sched.run_all()
    dt = time.perf_counter() - t0
    print(f"\nfleet: {len(done)} jobs across "
          f"{sched.stats()['n_pools']} pools in {dt:.1f}s")
    for job in sorted(done, key=lambda j: j.jid):
        dst, algo = jids[job.jid]
        r = job.result
        O.assert_valid(sched.problem(dst), r.genotype)
        print(f"  {dst:10s} {algo:6s} {r.gens:3d} warm gens  "
              f"wl2={r.best_objs[0]:.3e}  bbox={r.best_objs[1]:.0f}")
    for label, s in sched.stats()["pools"].items():
        assert s["step_compiles"] in (1, -1), label
    print("every pool stepped at one slot count (step_compiles == 1)")


if __name__ == "__main__":
    main()
