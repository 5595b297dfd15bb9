"""Islands-per-job demo: P sub-populations under one service slot.

Port of `examples/placement_islands.py`:

    PYTHONPATH=src python -m repro_torch.examples.placement_islands [--islands 4] [--torch-device cpu]

The control plane (cache, policies, autoscaling) scales placement
*across* jobs; `core.islands` scales quality *within* one.  A slot of an
islands pool holds P independent sub-populations that exchange champions
over a ring every `migrate_every` generations -- one more batch axis in
the same batched step, so a service step costs the same number of
sequential generations while evaluating P x the candidates.

The demo races the same job spec to the same combined-metric target:

  1. a **single-population** pool needs N generations,
  2. an **islands** pool (P sub-populations, ring migration) reaches it
     in fewer,
  3. `islands=IslandConfig(1, 0)` is the degeneracy check: identical
     results to the single-population pool, bit for bit.
"""
import argparse

import numpy as np

from repro_torch import resolve_device
from repro_torch.core import nsga2
from repro_torch.core.islands import IslandConfig
from repro_torch.fpga import device, netlist
from repro_torch.serve.api import JobRequest
from repro_torch.serve.placement_service import PlacementService


def gens_to_target(prob, cfg, islands, seed, budget, target, gps, tdev):
    svc = PlacementService(prob, cfg, n_slots=1, gens_per_step=gps,
                           islands=islands, device=tdev)
    svc.submit(JobRequest(seed=seed, budget=budget, target=target))
    done = []
    while svc.active.any():
        done.extend(svc.step())
    (job,) = done
    return job


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="xcvu_test")
    ap.add_argument("--pop", type=int, default=16)
    ap.add_argument("--islands", type=int, default=4)
    ap.add_argument("--migrate-every", type=int, default=4)
    ap.add_argument("--budget", type=int, default=48)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    tdev = resolve_device(args.torch_device)

    prob = netlist.make_problem(device.get_device(args.device))
    cfg = nsga2.NSGA2Config(pop_size=args.pop)
    gps = 2

    # target: where a single population lands with ~2/3 of the budget --
    # reachable by both contestants, so gens-to-target is well defined
    probe = gens_to_target(prob, cfg, None, seed=123,
                           budget=(2 * args.budget) // 3, target=None,
                           gps=gps, tdev=tdev)
    target = probe.metric
    print(f"target metric (single-pop, {probe.gens} gens): {target:.3e}\n")

    single = gens_to_target(prob, cfg, None, 0, args.budget, target, gps, tdev)
    print(f"single population : {single.gens:3d} gens  "
          f"metric={single.metric:.3e}")

    icfg = IslandConfig(args.islands, args.migrate_every)
    isl = gens_to_target(prob, cfg, icfg, 0, args.budget, target, gps, tdev)
    print(f"{args.islands} islands/slot    : {isl.gens:3d} gens  "
          f"metric={isl.metric:.3e}  "
          f"({single.gens / max(isl.gens, 1):.1f}x fewer steps)")

    one = gens_to_target(prob, cfg, IslandConfig(1, 0), 0, args.budget,
                         target, gps, tdev)
    same = (one.gens == single.gens
            and np.array_equal(one.best_objs, single.best_objs))
    print(f"islands(P=1)      : {one.gens:3d} gens  "
          f"metric={one.metric:.3e}  "
          f"(identical to single-population: {same})")


if __name__ == "__main__":
    main()
