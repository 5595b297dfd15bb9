"""Paper Fig. 7b: convergence of wirelength^2/bbox/combined per algorithm.

Port of `benchmarks/fig7_convergence.py`:

    python -m repro_torch.benchmarks.fig7_convergence [--full] [--torch-device cpu]

Emits CSV rows (method, generation, evaluations, wl2, bbox, combined) for
NSGA-II, NSGA-II-reduced, CMA-ES, GA (per-generation) and SA (per-step,
subsampled).  The fidelity target is qualitative: CMA-ES drops bbox within
hundreds of evaluations; NSGA-II reaches the best combined QoR by the end;
reduced-genotype tracks full NSGA-II with a bbox gap (paper SS IV-B2).
"""
from __future__ import annotations

from repro_torch.benchmarks import common
from repro_torch.core import annealing, cmaes, evolve, ga, nsga2

QUICK_SCALE = 0.2
GENS = {"nsga2": 250, "nsga2_reduced": 250, "cmaes": 500, "ga": 250}
SA_STEPS = 6000

def run(quick: bool = True, seed: int = 0, dev: str = "xcvu11p",
        torch_device="cuda"):
    prob = common.problem(dev)
    scale = QUICK_SCALE if quick else 1.0
    out = {}
    algos = {
        "nsga2": ("nsga2", nsga2.NSGA2Config(pop_size=32)),
        "nsga2_reduced": ("nsga2",
                          nsga2.NSGA2Config(pop_size=32, reduced=True)),
        "cmaes": ("cmaes", cmaes.CMAESConfig(pop_size=24)),
        "ga": ("ga", ga.GAConfig(pop_size=32)),
    }
    for name, (algo, cfg) in algos.items():
        gen = common.generator(torch_device, seed)
        _, hist = evolve.run(prob, algo, cfg, gen, int(GENS[name] * scale),
                             device=gen.device)
        out[name] = (hist.cpu().numpy(),
                     getattr(cfg, "pop_size", 24))
    sa_cfg = annealing.SAConfig(schedule="hyperbolic", beta=2e-3)
    gen = common.generator(torch_device, seed)
    st0 = annealing.init_state(prob, gen, sa_cfg)
    res = annealing.run_chain(prob, sa_cfg, gen, int(SA_STEPS * scale), st0)
    out["sa"] = (res["history"].cpu().numpy(), 1)
    return out

def report(out) -> None:
    print("method,generation,evaluations,wl2,bbox,combined")
    for name, (hist, per_gen) in out.items():
        stride = max(1, len(hist) // 60)
        for g in range(0, len(hist), stride):
            wl2, bb = float(hist[g, 0]), float(hist[g, 1])
            print(f"{name},{g},{(g + 1) * per_gen},{wl2:.4g},{bb:.1f},"
                  f"{wl2 * bb:.4g}")

def main(quick: bool = True, torch_device="cuda") -> None:
    report(run(quick=quick, torch_device=torch_device))

if __name__ == "__main__":
    args = common.parse_args()
    main(quick=not args.full, torch_device=args.torch_device)
