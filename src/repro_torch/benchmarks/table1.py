"""Paper Table I: runtime / wirelength / max-bbox / pipelining registers /
frequency for NSGA-II, NSGA-II (reduced), CMA-ES, SA, GA on the VU11P rect.

Port of `benchmarks/table1.py`:

    python -m repro_torch.benchmarks.table1 [--full] [--torch-device cpu]

Paper reference values are printed alongside for the fidelity check:
CMA-ES fastest (30x vs SA), NSGA-II best bbox + fewest registers, SA best
raw wirelength, GA worst QoR.  Absolute wirelength units differ from the
paper (reconstructed netlist weights); ratios are the reproduction target.
Each row also keeps its champion genotype (`champion`, 1-D leaves) and
its per-generation best objectives (`history`), both on the run's device.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.benchmarks import common
from repro_torch.core import annealing, cmaes, evolve, ga, nsga2, portfolio
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O

PAPER = {  # Table I (runtime s, wirelength, bbox, regs, MHz)
    "nsga2": (586, 3.5e3, 1183, 256e3, 733),
    "nsga2_reduced": (323, 3.5e3, 1543, 273e3, 688),
    "cmaes": (51, 4.4e3, 1606, 273e3, 708),
    "sa": (1577, 3.1e3, 1387, 273e3, 711),
    "ga": (850, 9.2e3, 1908, 323e3, 585),
}
QUICK_SCALE = 0.25
NSGA2_GENS, CMAES_GENS, GA_GENS, SA_STEPS = 300, 600, 300, 8000


def run(quick: bool = True, seed: int = 0, dev: str = "xcvu11p",
        torch_device="cuda") -> Dict[str, Dict[str, float]]:
    prob = common.problem(dev)
    scale = QUICK_SCALE if quick else 1.0
    budgets = {
        "nsga2": ("nsga2", nsga2.NSGA2Config(pop_size=48),
                  int(NSGA2_GENS * scale)),
        "nsga2_reduced": ("nsga2",
                          nsga2.NSGA2Config(pop_size=48, reduced=True),
                          int(NSGA2_GENS * scale)),
        "cmaes": ("cmaes", cmaes.CMAESConfig(pop_size=24),
                  int(CMAES_GENS * scale)),
        "ga": ("ga", ga.GAConfig(pop_size=48), int(GA_GENS * scale)),
    }
    rows: Dict[str, Dict[str, float]] = {}
    for name, (algo, cfg, gens) in budgets.items():
        gen = common.generator(torch_device, seed)
        dt, (state, hist) = common.timed(
            evolve.run, prob, algo, cfg, gen, gens, device=gen.device)
        if algo == "cmaes":
            g, objs = cmaes.best_genotype(prob, state)
        elif getattr(cfg, "reduced", False):
            # the reference's choice: population member 0, lifted
            perms = tuple(p[:1] for p in state["pop"])
            g = G.tree_map(lambda a: a[0], G.reduced_to_full(prob, perms))
            objs = state["objs"][0]
        else:
            i = int(torch.argmin(O.combined_metric(state["objs"])))
            g = G.tree_map(lambda a: a[i], state["pop"])
            objs = state["objs"][i]
        row = common.summarize(prob, g, objs)
        row["runtime_s"] = dt
        row["evaluations"] = gens * getattr(cfg, "pop_size", 24)
        row.update(champion=g, history=hist)
        rows[name] = row

    # SA: one chain
    sa_cfg = annealing.SAConfig(schedule="hyperbolic", t0=2.0, beta=2e-3)
    n_steps = int(SA_STEPS * scale)
    gen = common.generator(torch_device, seed)
    st0 = annealing.init_state(prob, gen, sa_cfg)
    dt, out = common.timed(annealing.run_chain, prob, sa_cfg, gen, n_steps, st0)
    g, objs = portfolio.best_genotype(prob, "sa", out["state"])
    row = common.summarize(prob, g, objs)
    row["runtime_s"] = dt
    row["evaluations"] = n_steps
    row.update(champion=g, history=out["history"])
    rows["sa"] = row
    return rows


def report(rows) -> None:
    hdr = ("method", "runtime_s", "evals", "wirelength", "max_bbox",
           "regs@650", "MHz(d0)", "MHz(piped)")
    print(",".join(hdr))
    for name, r in rows.items():
        print(f"{name},{r['runtime_s']:.1f},{r['evaluations']},"
              f"{r['wirelength']:.0f},{r['max_bbox']:.0f},"
              f"{r['pipeline_regs_650']},{r['freq_mhz_unpipelined']:.0f},"
              f"{r['freq_mhz_pipelined']:.0f}")
    print("\n# paper Table I reference (runtime_s, WL, bbox, regs, MHz):")
    for k, v in PAPER.items():
        print(f"#   {k}: {v}")
    # fidelity ratios mirroring the paper's headline claims
    sa, cm_, ns = rows["sa"], rows["cmaes"], rows["nsga2"]
    red = rows["nsga2_reduced"]
    print("\n# fidelity checks (paper expectation):")
    print(f"# CMA-ES vs SA runtime: {sa['runtime_s']/cm_['runtime_s']:.1f}x "
          f"faster (paper ~30x)")
    print(f"# NSGA-II vs SA bbox: {sa['max_bbox']/ns['max_bbox']:.2f}x "
          f"(paper ~1.2x better)")
    print(f"# NSGA-II regs vs GA: {rows['ga']['pipeline_regs_650']/max(ns['pipeline_regs_650'],1):.2f}x "
          f"(paper ~1.3x)")
    print(f"# reduced-vs-full NSGA-II runtime: "
          f"{ns['runtime_s']/max(red['runtime_s'],1e-9):.2f}x (paper ~1.8x)")


def main(quick: bool = True, torch_device="cuda") -> None:
    report(run(quick=quick, torch_device=torch_device))


if __name__ == "__main__":
    args = common.parse_args()
    main(quick=not args.full, torch_device=args.torch_device)
