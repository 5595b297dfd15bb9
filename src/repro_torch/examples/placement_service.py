"""Placement-as-a-service + hyperparameter portfolios, end to end.

Port of `examples/placement_service.py`:

    PYTHONPATH=src python -m repro_torch.examples.placement_service [--device xcvu_test] [--torch-device cpu]

Part 1 runs the continuous-batching placement service: a pool of job slots
advances many concurrent placement jobs (each with its own seed, budget,
and float hyperparameters) through one batched step -- requests come and
go without changing the step's shapes, the serving discipline of
`serve/engine.py` applied to placement traffic.

Part 2 races a hyperparameter portfolio: K NSGA-II configs run as one
vmapped program (`core/portfolio.py`) with early champion selection, and
the champion's placement is validated and summarised.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import nsga2, portfolio, objectives as O
from repro_torch.fpga import device, netlist
from repro_torch.serve.placement_service import (
    PlacementService, make_job_specs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="xcvu_test",
                    help=f"one of {device.list_devices()}")
    ap.add_argument("--jobs", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--budget", type=int, default=24)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    tdev = resolve_device(args.torch_device)

    prob = netlist.make_problem(device.get_device(args.device))
    print(f"{args.device}: {prob.n_blocks} hard blocks, {prob.n_nets} nets")

    # ---- part 1: continuous-batching service -------------------------
    svc = PlacementService(prob, nsga2.NSGA2Config(pop_size=args.pop),
                           n_slots=args.slots, gens_per_step=4, device=tdev)
    specs = make_job_specs(args.jobs, args.pop, args.budget)
    t0 = time.perf_counter()
    done = svc.run_jobs(specs)
    dt = time.perf_counter() - t0
    print(f"\nservice: {len(done)} jobs over {args.slots} slots "
          f"in {dt:.2f}s -- {len(done)/dt:.2f} jobs/s, "
          f"{svc.stats()['useful_gens']/dt:.1f} gens/s, "
          f"{svc.stats()['step_compiles']} step compile(s)")
    for j in sorted(done, key=lambda j: j.metric)[:4]:
        print(f"  job{j.jid}: metric={j.metric:.3e} "
              f"(wl2={j.best_objs[0]:.3e}, bbox={j.best_objs[1]:.0f})")

    # ---- part 2: portfolio racing ------------------------------------
    cfgs = [nsga2.NSGA2Config(pop_size=args.pop, sbx_eta=eta,
                              real_mut_prob=mp)
            for eta in (5.0, 15.0, 25.0) for mp in (0.1, 0.25)]
    t0 = time.perf_counter()
    res = portfolio.race(prob, "nsga2", cfgs,
                         torch.Generator(device=tdev).manual_seed(1),
                         max_gens=args.budget * 2, gens_per_round=6,
                         patience=2, device=tdev)
    dt = time.perf_counter() - t0
    print(f"\nportfolio: {len(cfgs)} configs raced {res.gens} gens "
          f"({res.rounds} rounds) in one vmapped program, {dt:.2f}s")
    print(f"  champion: cfg#{res.champion} "
          f"(sbx_eta={cfgs[res.champion].sbx_eta}, "
          f"mut={cfgs[res.champion].real_mut_prob}) "
          f"metric={res.metric[res.champion]:.3e}")
    g, objs = portfolio.best_genotype(prob, "nsga2",
                                      res.member_state(res.champion),
                                      cfgs[res.champion])
    O.assert_valid(prob, g)
    print("  champion placement validated legal")


if __name__ == "__main__":
    main()
