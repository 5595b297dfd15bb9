"""Transfer learning demo (paper SS IV-D): seed VU3P -> sibling devices.

Port of `examples/placement_transfer.py`:

    PYTHONPATH=src python -m repro_torch.examples.placement_transfer [--torch-device cpu]

Optimizes the seed device from scratch, migrates the champion genotype to
each sibling, and compares warm-started vs from-scratch convergence.
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import evolve, hyper, nsga2, transfer
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga import device, netlist

GENS = 40
POP = 24


def best_of(state):
    i = int(torch.argmin(O.combined_metric(state["objs"])))
    return (G.tree_map(lambda a: a[i], state["pop"]),
            state["objs"][i].cpu().numpy())


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    tdev = resolve_device(ap.parse_args(argv).torch_device)

    def gen():
        return torch.Generator(device=tdev).manual_seed(0)

    cfg = nsga2.NSGA2Config(pop_size=POP)
    seed_prob = netlist.make_problem(device.get_device("xcvu3p"))
    print(f"optimizing seed xcvu3p ({seed_prob.n_units} units)...")
    st, _ = evolve.run(seed_prob, "nsga2", cfg, gen(), GENS, device=tdev)
    g_seed, objs = best_of(st)
    print(f"  seed champion: wl2={objs[0]:.3e} bbox={objs[1]:.0f}")

    for dst in ("xcvu5p", "xcvu7p", "xcvu9p"):
        prob = netlist.make_problem(device.get_device(dst))
        gm = transfer.migrate(seed_prob, prob, g_seed)
        O.assert_valid(prob, gm)
        o_mig = O.evaluate(prob, gm).cpu().numpy()
        rand = G.tree_map(lambda a: a[0], G.random_genotype(prob, 1, gen()))
        o_rand = O.evaluate(prob, rand).cpu().numpy()
        step_gen = gen()
        st0 = transfer.seed_population(prob, gm, step_gen, POP)
        m = evolve.get_algo("nsga2")
        tcfg = hyper.tracify(cfg, tdev)
        t0 = time.time()
        for _ in range(GENS // 4):          # 1/4 the budget suffices
            st0 = m.step_impl(prob, tcfg, st0, step_gen)
        _, o_final = best_of(st0)
        print(f"{dst}: migrated seed wl2={o_mig[0]:.3e} "
              f"(random init {o_rand[0]:.3e}); after {GENS//4} warm gens: "
              f"wl2={o_final[0]:.3e} bbox={o_final[1]:.0f} "
              f"[{time.time()-t0:.1f}s]")


if __name__ == "__main__":
    main()
