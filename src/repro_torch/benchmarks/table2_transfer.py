"""Paper Table II / Fig. 10: transfer learning across UltraScale+ devices.

Port of `benchmarks/table2_transfer.py`:

    python -m repro_torch.benchmarks.table2_transfer [--full] [--torch-device cpu]

Seed device VU3P is optimized from scratch; siblings VU5P/VU7P/VU9P start
from the migrated genotype.  Metric: evaluations to reach the scratch run's
final QoR (the paper reports 11-14x placement-runtime speedups) plus final
frequency deltas (paper: -2%..+7%).  The warm leg is a loop of NSGA-II's
`step_impl` from `transfer.seed_population`, its history filled on the
device as `evolve.run` fills one.  Each target's row also keeps the
champions (`g_seed`, `g_scratch`, `g_transfer`) and histories
(`hist_scratch`, `hist_transfer`) on the run's device.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.benchmarks import common
from repro_torch.core import evolve, hyper, nsga2, pipelining, transfer
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga import device, netlist

SEED_DEVICE = "xcvu3p"
TARGETS = ("xcvu5p", "xcvu7p", "xcvu9p")
POP = 32
QUICK_GENS, FULL_GENS = 60, 300


def _best(state):
    i = int(torch.argmin(O.combined_metric(state["objs"])))
    return G.tree_map(lambda a: a[i], state["pop"]), state["objs"][i]


def _evals_to_target(hist: np.ndarray, target: float, per_gen: int) -> int:
    comb = hist[:, 0] * hist[:, 1]
    hit = np.where(comb <= target)[0]
    return int((hit[0] + 1) * per_gen) if len(hit) else len(hist) * per_gen


def run(quick: bool = True, seed: int = 0, torch_device="cuda"
        ) -> Dict[str, Dict[str, float]]:
    def gen(*path):
        return common.generator(torch_device, seed, *path)

    cfg = nsga2.NSGA2Config(pop_size=POP)
    gens = QUICK_GENS if quick else FULL_GENS
    prob_seed = netlist.make_problem(device.get_device(SEED_DEVICE))
    g0 = gen()
    st_seed, _ = evolve.run(prob_seed, "nsga2", cfg, g0, gens, device=g0.device)
    g_seed, _ = _best(st_seed)

    out: Dict[str, Dict[str, float]] = {}
    for dst in TARGETS:
        prob = netlist.make_problem(device.get_device(dst))
        # scratch
        st_s, hist_s = evolve.run(prob, "nsga2", cfg, gen(1), gens,
                                  device=g0.device)
        g_s, objs_s = _best(st_s)
        target = float(O.combined_metric(objs_s)) * 1.05
        # transfer: migrate + seeded population, same budget
        g_mig = transfer.migrate(prob_seed, prob, g_seed)
        st_t = transfer.seed_population(prob, g_mig, gen(2), cfg.pop_size)
        m = evolve.get_algo("nsga2")
        tcfg, step_gen = hyper.tracify(cfg, g0.device), gen(3)
        hist_t = torch.empty(gens, 2, device=g0.device)
        for i in range(gens):
            st_t = m.step_impl(prob, tcfg, st_t, step_gen)
            hist_t[i] = evolve.state_best_objs(st_t)
        g_t, objs_t = _best(st_t)

        ev_scratch = _evals_to_target(hist_s.cpu().numpy(), target,
                                      cfg.pop_size)
        ev_transfer = _evals_to_target(hist_t.cpu().numpy(), target,
                                       cfg.pop_size)
        out[dst] = {
            "units": device.get_device(dst).units_total,
            "evals_scratch": ev_scratch,
            "evals_transfer": ev_transfer,
            "speedup": ev_scratch / max(ev_transfer, 1),
            "mhz_scratch": pipelining.frequency_at_depth(prob, g_s, 1),
            "mhz_transfer": pipelining.frequency_at_depth(prob, g_t, 1),
            "g_seed": g_seed, "g_scratch": g_s, "g_transfer": g_t,
            "hist_scratch": hist_s, "hist_transfer": hist_t,
        }
    return out


def report(rows) -> None:
    print("device,units,evals_scratch,evals_transfer,speedup,"
          "mhz_scratch,mhz_transfer,freq_delta_pct")
    for dev_name, r in rows.items():
        dpct = 100 * (r["mhz_transfer"] / r["mhz_scratch"] - 1)
        print(f"{dev_name},{r['units']},{r['evals_scratch']},"
              f"{r['evals_transfer']},{r['speedup']:.1f},"
              f"{r['mhz_scratch']:.0f},{r['mhz_transfer']:.0f},{dpct:+.1f}")
    print("# paper: 11-14x placement speedup, freq delta -2%..+7%")


def main(quick: bool = True, torch_device="cuda") -> None:
    report(run(quick=quick, torch_device=torch_device))


if __name__ == "__main__":
    args = common.parse_args()
    main(quick=not args.full, torch_device=args.torch_device)
