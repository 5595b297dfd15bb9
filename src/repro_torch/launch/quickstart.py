"""Quickstart: NSGA-II hard-block placement end to end with the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.quickstart --device xcvu11p

Runs NSGA-II on the FPGA device's repeating rectangle on the CUDA card
(`--torch-device cpu` runs the plain PyTorch path instead), prints the
Pareto front, validates the champion placement, and prints its ASCII
floorplan and post-placement pipelining report.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.core import evolve, nsga2, pipelining
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga import device, floorplan, netlist


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="xcvu_test",
                    help=f"FPGA device, one of {device.list_devices()}")
    ap.add_argument("--generations", type=int, default=60)
    ap.add_argument("--pop", type=int, default=64)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    dev = device.get_device(args.device)
    prob = netlist.make_problem(dev)
    print(f"{dev.name}: {prob.n_units} conv units/rect x {dev.n_rects} "
          f"rects, {prob.n_blocks} hard blocks, {prob.n_nets} nets, "
          f"util={ {k: f'{v:.1%}' for k, v in dev.utilization().items()} }")

    tdev = resolve_device(args.torch_device)
    gen = torch.Generator(device=tdev).manual_seed(0)
    cfg = nsga2.NSGA2Config(pop_size=args.pop)
    t0 = time.perf_counter()
    state, _ = evolve.run(prob, "nsga2", cfg, gen, args.generations, device=tdev)
    rank = nsga2.nondominated_rank(state["objs"]).cpu()
    objs = state["objs"].cpu()
    elapsed = time.perf_counter() - t0
    print(f"\n{args.generations} generations in {elapsed:.2f}s on {tdev}; "
          f"Pareto front ({int((rank == 0).sum())} candidates):")
    for i in torch.nonzero(rank == 0).flatten()[:8].tolist():
        print(f"  wl2={objs[i, 0]:.3e}  max_bbox={objs[i, 1]:.0f}")

    best = int(torch.argmin(O.combined_metric(objs)))
    g = G.tree_map(lambda a: a[best], state["pop"])
    O.assert_valid(prob, g)
    print(f"\nchampion {best}: combined metric "
          f"{float(O.combined_metric(objs[best])):.4e} (validated legal)")
    print(floorplan.ascii_floorplan(prob, g, width=100, height=24))

    rep = pipelining.auto_pipeline(prob, g, target_mhz=650.0)
    print(f"\npipelining to 650 MHz: {rep.total_registers} registers, "
          f"achieved {rep.freq_mhz:.0f} MHz "
          f"(unpipelined {pipelining.frequency_at_depth(prob, g, 0):.0f} MHz,"
          f" longest net {rep.max_net_rpm:.0f} RPM)")


if __name__ == "__main__":
    main()
