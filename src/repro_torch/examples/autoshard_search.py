"""autoshard: the paper's placement EA applied to sharding layouts.

Port of `examples/autoshard_search.py`:

    PYTHONPATH=src python -m repro_torch.examples.autoshard_search \
        [--arch deepseek-moe-16b] [--shape train_4k] [--multi-pod] [--verify] \
        [--torch-device cuda|cpu]

NSGA-II searches the assignment of logical tensor axes to mesh dims
against the analytical roofline cost model on H100s
(`sharding.costmodel.H100`; collective-seconds vs bytes/device, the
wirelength^2 / max-bbox analogues), prints the Pareto front and the
champion layout, and with --verify traces the champion through the port's
dry-run (`launch.dryrun`, in its own process: the paper's estimate-fast /
verify-slow loop).
"""
import argparse
import json
import subprocess
import time

from repro_torch.configs import get_arch
from repro_torch.core import autoshard
from repro_torch.launch import dryrun
from repro_torch.sharding import costmodel as cm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="deepseek-moe-16b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--verify", action="store_true",
                    help="trace the champion layout through launch.dryrun")
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    mesh = cm.MeshShape(2 if args.multi_pod else 1, 16, 16)
    t0 = time.time()
    res = autoshard.search(cfg, args.shape, mesh, pop_size=32, n_gens=25,
                           device=args.torch_device)
    dt = time.time() - t0

    print(f"arch={args.arch} shape={args.shape} mesh={mesh} "
          f"({res.evaluations} layout evaluations in {dt:.1f}s -- the "
          f"fast analytical objective)")
    b = res.baseline
    print(f"\nbaseline layout : coll={b.collective_s*1e3:8.2f}ms "
          f"mem={b.memory_s*1e3:8.2f}ms comp={b.compute_s*1e3:8.2f}ms "
          f"resident={b.bytes_per_device/2**30:6.2f}GiB")
    r = res.best_report
    print(f"champion layout : coll={r.collective_s*1e3:8.2f}ms "
          f"mem={r.memory_s*1e3:8.2f}ms comp={r.compute_s*1e3:8.2f}ms "
          f"resident={r.bytes_per_device/2**30:6.2f}GiB")
    print(f"champion rules  : {res.best_rules}")
    print(f"\nPareto front ({len(res.pareto)} layouts):")
    for rules, rep in res.pareto[:8]:
        print(f"  step<={rep.step_s*1e3:7.2f}ms "
              f"res={rep.bytes_per_device/2**30:6.2f}GiB  {rules}")

    if args.verify:
        rules_json = json.dumps({k: (list(v) if isinstance(v, tuple) else v)
                                 for k, v in res.best_rules.items()
                                 if k in ("batch", "kv_seq")})
        cmd, env = dryrun.command(args.arch, args.shape, args.multi_pod,
                                  out="experiments/autoshard", device=args.torch_device)
        cmd += ["--rules", rules_json]
        print(f"\nverifying the champion with a dry-run trace: {' '.join(cmd)}")
        subprocess.run(cmd, check=True, env=env)


if __name__ == "__main__":
    main()
