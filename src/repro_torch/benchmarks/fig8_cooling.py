"""Paper Fig. 8: SA cooling-schedule tuning (4 schedules x parameter sets).

Port of `benchmarks/fig8_cooling.py`:

    python -m repro_torch.benchmarks.fig8_cooling [--full] [--torch-device cpu]

Fidelity target: the hyperbolic schedule yields the best final combined QoR
(the paper selects it for Table I).  The sixteen chains run one after
another, chain i from generators seeded from (seed, i) and (seed, 100 + i).
"""
from __future__ import annotations

import numpy as np

from repro_torch.benchmarks import common
from repro_torch.core import annealing

PARAM_SETS = {
    "exponential": [dict(t0=t0, alpha=a) for t0 in (1.0, 3.0)
                    for a in (0.999, 0.9995)],
    "linear": [dict(t0=t0, n_steps=n) for t0 in (1.0, 3.0)
               for n in (4000, 8000)],
    "hyperbolic": [dict(t0=t0, beta=b) for t0 in (1.0, 3.0)
                   for b in (1e-3, 5e-3)],
    "adaptive": [dict(t0=t0, adapt_target=at) for t0 in (1.0, 3.0)
                 for at in (0.2, 0.4)],
}
QUICK_STEPS, FULL_STEPS = 1500, 8000


def run(quick: bool = True, seed: int = 0, dev: str = "xcvu11p",
        torch_device="cuda"):
    prob = common.problem(dev)
    steps = QUICK_STEPS if quick else FULL_STEPS
    rows = []
    for sched, psets in PARAM_SETS.items():
        best = np.inf
        for i, ps in enumerate(psets):
            cfg = annealing.SAConfig(schedule=sched, **ps)
            st0 = annealing.init_state(
                prob, common.generator(torch_device, seed, i), cfg)
            res = annealing.run_chain(
                prob, cfg, common.generator(torch_device, seed, 100 + i),
                steps, st0)
            objs = res["state"]["best_objs"].cpu().numpy()
            comb = float(objs[0] * objs[1])
            rows.append((sched, i, float(objs[0]), float(objs[1]), comb))
            best = min(best, comb)
    return rows


def report(rows) -> None:
    print("schedule,param_set,wl2,bbox,combined")
    for r in rows:
        print(f"{r[0]},{r[1]},{r[2]:.4g},{r[3]:.1f},{r[4]:.4g}")
    bests = {}
    for r in rows:
        bests[r[0]] = min(bests.get(r[0], np.inf), r[4])
    winner = min(bests, key=bests.get)
    print(f"# best schedule: {winner} (paper: hyperbolic)")


def main(quick: bool = True, torch_device="cuda") -> None:
    report(run(quick=quick, torch_device=torch_device))


if __name__ == "__main__":
    args = common.parse_args()
    main(quick=not args.full, torch_device=args.torch_device)
