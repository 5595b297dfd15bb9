"""The dry-run artifacts as the three-term roofline table.

Port of `benchmarks/roofline.py`:

    python -m repro_torch.benchmarks.roofline [--dir experiments/dryrun]

reads <dir>/*.json (written by `repro_torch.launch.dryrun`), prints the
per-(arch x shape x mesh) roofline terms with the dominant bottleneck, and
nominates three cells: the worst roofline fraction, the most
collective-bound, and the expert-placement MoE cell that stands for the
paper's technique.  The roofline fraction is the model flops' time at one
H100's bf16 peak (`sharding.costmodel.H100`, the rate the dry-run's terms
use) over the largest of the three terms.

`--kernels` (the reference's fused-vs-unfused evaluation roofline, which
reads the placement benchmark's JSON) waits for the port's benchmark
(ROADMAP item 10b) and raises.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

from repro_torch.sharding.costmodel import H100

KERNELS_NOT_PORTED = ("--kernels reads the placement benchmark's JSON, which the port "
                      "does not have yet (ROADMAP item 10b)")


def load(dirname: str = "experiments/dryrun") -> List[Dict]:
    rows = []
    for path in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return rows


def _chips(mesh: str) -> int:
    return 512 if "2x16" in mesh else 256


def fraction(r: Dict) -> float:
    t = r["roofline"]
    bound = max(t["compute_s"], t["memory_s"], t["collective_s"])
    return (t["model_flops"] / (_chips(r["mesh"]) * H100.peak_flops)) / bound if bound else 0.0


def table(rows: List[Dict], mesh: str = "pod16x16") -> None:
    print("arch,shape,mesh,status,peak_GiB,compute_s,memory_s,collective_s,"
          "dominant,useful_ratio,roofline_fraction")
    for r in rows:
        if r["mesh"] != mesh:
            continue
        t = r.get("roofline", {})
        if r["status"] != "ok" or "compute_s" not in t:
            # skipped and failed cells, and vu_systolic (it executes the EA
            # rather than tracing a step: no roofline terms)
            print(f"{r['arch']},{r['shape']},{r['mesh']},{r['status']},,,,,,,")
            continue
        peak = r["memory"]["peak_estimate_bytes"] / 2 ** 30
        print(f"{r['arch']},{r['shape']},{r['mesh']},ok,{peak:.2f},"
              f"{t['compute_s']:.4f},{t['memory_s']:.4f},{t['collective_s']:.4f},"
              f"{t['dominant']},{t['useful_ratio']:.3f},{fraction(r):.4f}")


def nominate(rows: List[Dict]) -> None:
    ok = [r for r in rows if r["status"] == "ok" and r["mesh"] == "pod16x16"
          and "compute_s" in r.get("roofline", {})]
    if not ok:
        print("\n# hillclimb nominations: no traced pod16x16 cell")
        return

    def coll_share(r):
        t = r["roofline"]
        tot = t["compute_s"] + t["memory_s"] + t["collective_s"]
        return t["collective_s"] / tot if tot else 0

    worst = min(ok, key=fraction)
    collb = max(ok, key=coll_share)
    print("\n# hillclimb nominations:")
    print(f"#  worst roofline fraction: {worst['arch']} x {worst['shape']} "
          f"({fraction(worst):.4f})")
    print(f"#  most collective-bound:   {collb['arch']} x {collb['shape']} "
          f"({100 * coll_share(collb):.1f}% of step)")
    if any(r["arch"] == "deepseek-moe-16b" and r["shape"] == "train_4k" for r in ok):
        print("#  paper-representative:    deepseek-moe-16b x train_4k "
              "(expert placement == hard-block placement)")


def main(dirname: str = "experiments/dryrun") -> None:
    rows = load(dirname)
    if not rows:
        print(f"# no dry-run artifacts under {dirname}; run "
              "PYTHONPATH=src python -m repro_torch.launch.dryrun --all first")
        return
    for mesh in ("pod16x16", "pod2x16x16"):
        table(rows, mesh)
        print()
    nominate(rows)


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun")
    ap.add_argument("--kernels", action="store_true",
                    help="evaluation-pipeline roofline (waits for the port's benchmark)")
    args = ap.parse_args(argv)
    if args.kernels:
        raise NotImplementedError(KERNELS_NOT_PORTED)
    main(args.dir)


if __name__ == "__main__":
    cli()
