"""Paper Fig. 9: clock frequency vs pipelining depth per placement method.

Port of `benchmarks/fig9_pipelining.py`:

    python -m repro_torch.benchmarks.fig9_pipelining [--full] [--torch-device cpu]

Fidelity targets: NSGA-II >= 650 MHz with zero extra stages; others need
>= 1 stage; NSGA-II/CMA-ES reach 750+ MHz by depth 2; everyone saturates
toward the hard-block Fmax with depth.
"""
from __future__ import annotations

import torch

from repro_torch.benchmarks import common
from repro_torch.core import annealing, cmaes, evolve, nsga2, pipelining
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O

QUICK_SCALE = 0.25
NSGA2_GENS, CMAES_GENS, SA_STEPS = 300, 600, 8000


def best_placements(quick: bool = True, seed: int = 0, dev: str = "xcvu11p",
                    torch_device="cuda"):
    prob = common.problem(dev)
    scale = QUICK_SCALE if quick else 1.0

    def one(g):
        return G.tree_map(lambda a: a[0], g)

    out = {}
    gen = common.generator(torch_device, seed)
    st, _ = evolve.run(prob, "nsga2", nsga2.NSGA2Config(pop_size=48),
                       gen, int(NSGA2_GENS * scale), device=gen.device)
    i = int(torch.argmin(O.combined_metric(st["objs"])))
    out["nsga2"] = G.tree_map(lambda a: a[i], st["pop"])
    gen = common.generator(torch_device, seed)
    cst, _ = evolve.run(prob, "cmaes", cmaes.CMAESConfig(pop_size=24),
                        gen, int(CMAES_GENS * scale), device=gen.device)
    out["cmaes"] = one(G.from_flat(prob, cst["best_z"][None]))
    sa_cfg = annealing.SAConfig(schedule="hyperbolic", beta=2e-3)
    gen = common.generator(torch_device, seed)
    st0 = annealing.init_state(prob, gen, sa_cfg)
    res = annealing.run_chain(prob, sa_cfg, gen, int(SA_STEPS * scale), st0)
    out["sa"] = one(G.from_flat(prob, res["state"]["best_z"][None]))
    out["random(manual-proxy)"] = one(G.random_genotype(
        prob, 1, common.generator(torch_device, seed)))
    return prob, out


def sweeps(prob, placements):
    """{method: depth_sweep(prob, g, 4)}."""
    return {name: pipelining.depth_sweep(prob, g, 4)
            for name, g in placements.items()}


def report(sweep_by_method) -> None:
    print("method,depth,freq_mhz,registers")
    for name, sweep in sweep_by_method.items():
        for d in range(5):
            print(f"{name},{d},{sweep[d]['freq_mhz']:.0f},"
                  f"{sweep[d]['registers']}")
    print("# paper: NSGA-II 650MHz@d0; CMA-ES/SA need >=1 stage; "
          "750+ by d2 for NSGA-II/CMA-ES")


def main(quick: bool = True, torch_device="cuda") -> None:
    prob, placements = best_placements(quick=quick, torch_device=torch_device)
    report(sweeps(prob, placements))


if __name__ == "__main__":
    args = common.parse_args()
    main(quick=not args.full, torch_device=args.torch_device)
