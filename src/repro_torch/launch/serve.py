"""Serving launcher of the PyTorch port: an LM engine or the placement service.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b [--reduced]
        [--requests 4] [--max-new 16] [--torch-device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve --placement \
        [--device xcvu_test] [--slots 8] [--pop 32] [--gens 64] \
        [--gens-per-step 4] [--fused] [--islands N --migrate-every G] \
        [--warm-from xcvu_test --warm-gens 100] [--torch-device cuda|cpu]

The LM branch of `repro/launch/serve.py`: builds `--arch` (full width, or
its reduced smoke-test variant) in fp32 with weights drawn from seed 0,
serves `--requests` random prompts of 4-10 tokens (numpy `default_rng(0)`)
through an `Engine` with max(2, requests // 2) slots and max_len 96, and
prints one `reqN:` line of generated tokens per request.

`--placement` is the reference's `placement_main`: `--requests` NSGA-II
jobs (`make_job_specs`) through one `serve.placement_service` pool on the
FPGA device `--device`, printing each job's result and the pool's jobs/s,
gens/s and the slot counts it stepped ("step compiles", 1 for a pool
that does not grow).  `--warm-from BASE` first converges a champion on
BASE (`transfer.converge_champion`, pop 2 x `--pop`), migrates it onto
`--device`, and races every job cold and transfer-seeded to the migrated
champion's metric.  The scheduler's flags (`--frontend`,
`--cache`, `--autoscale`, `--policy`, `--prewarm`) and the dry-run
(`--dry-run`) are not ported yet.

Both run on the CUDA card unless `--torch-device cpu` is given, and raise
when there is no card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_arch, get_reduced
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine

SCHEDULER_FLAGS = ("frontend", "cache", "autoscale", "policy", "prewarm")


def _island_config(args):
    """--islands N [--migrate-every G] -> IslandConfig (None when off)."""
    if args.islands <= 1:
        return None
    from repro_torch.core.islands import IslandConfig
    return IslandConfig(args.islands, args.migrate_every)


def placement_main(args) -> None:
    from repro_torch.core import nsga2
    from repro_torch.fpga import device, netlist
    from repro_torch.serve.placement_service import PlacementService, make_job_specs

    dev = resolve_device(args.torch_device)
    prob = netlist.make_problem(device.get_device(args.device))
    base = nsga2.NSGA2Config(pop_size=args.pop, fused=args.fused)
    svc = PlacementService(prob, base, n_slots=args.slots,
                           gens_per_step=args.gens_per_step,
                           islands=_island_config(args), device=dev)
    specs = make_job_specs(args.requests, args.pop, args.gens, fused=args.fused)

    if args.warm_from:
        from repro_torch.core import objectives as O
        from repro_torch.core import transfer

        base_prob = netlist.make_problem(device.get_device(args.warm_from))
        print(f"converging champion on {args.warm_from} "
              f"({args.warm_gens} gens)...")
        champ = transfer.converge_champion(
            base_prob, torch.Generator(device=dev).manual_seed(0), 2 * args.pop,
            args.warm_gens)
        g_mig = transfer.migrate(base_prob, prob, champ)
        target = float(O.combined_metric(O.evaluate(prob, g_mig)))
        print(f"migrated champion metric on {args.device}: {target:.3e}; "
              "racing warm vs cold to that target")
        # every spec twice: cold and warm-seeded, chasing the same target
        specs = [dict(s, target=target) for s in specs] + \
                [dict(s, target=target, init_state=g_mig) for s in specs]

    t0 = time.perf_counter()
    done = svc.run_jobs(specs)
    dt = time.perf_counter() - t0
    for j in sorted(done, key=lambda j: j.jid):
        tag = " warm" if j.warm else ""
        print(f"job{j.jid}{tag}: {j.gens} gens  wl2={j.best_objs[0]:.3e}  "
              f"bbox={j.best_objs[1]:.0f}  metric={j.metric:.3e}")
    if args.warm_from:
        cold = [j.gens for j in done if not j.warm]
        warm = [j.gens for j in done if j.warm]
        print(f"gens to target: cold mean {np.mean(cold):.1f}, "
              f"warm mean {np.mean(warm):.1f} "
              f"({np.mean(cold) / max(np.mean(warm), 1e-9):.1f}x fewer)")
    s = svc.stats()
    isl = (f", {s['n_islands']} islands/slot "
           f"(migrate every {s['migrate_every']})"
           if s["n_islands"] > 1 else "")
    print(f"{len(done)} jobs in {dt:.2f}s "
          f"({len(done)/dt:.2f} jobs/s, {s['useful_gens']/dt:.1f} gens/s) "
          f"on {args.slots} slots{isl} ({dev}); step compiles: "
          f"{s['step_compiles']}")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dry-run", action="store_true",
                    help="not ported yet (ROADMAP queue 1 item 11)")
    # placement-service mode
    ap.add_argument("--placement", action="store_true",
                    help="serve placement jobs instead of an LM")
    ap.add_argument("--device", default="xcvu_test",
                    help="FPGA device of the placement jobs")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--pop", type=int, default=32)
    ap.add_argument("--gens", type=int, default=64,
                    help="generation budget per placement job")
    ap.add_argument("--gens-per-step", type=int, default=4)
    ap.add_argument("--fused", action="store_true",
                    help="evaluate through the fused kernels (fused_eval, "
                         "domination with counts); static pool identity")
    ap.add_argument("--islands", type=int, default=1, metavar="N",
                    help="island sub-populations per slot (core.islands); "
                         "1 = single-population pools")
    ap.add_argument("--migrate-every", type=int, default=4, metavar="G",
                    help="generations between ring champion migrations "
                         "inside an islands slot")
    ap.add_argument("--warm-from", default=None, metavar="DEVICE",
                    help="transfer-seed jobs from a champion converged on "
                         "this base device (e.g. xcvu_test)")
    ap.add_argument("--warm-gens", type=int, default=100,
                    help="generations to converge the base champion")
    for flag in ("--frontend", "--cache", "--autoscale", "--prewarm"):
        ap.add_argument(flag, action="store_true",
                        help="not ported yet (ROADMAP queue 1 item 9b)")
    ap.add_argument("--policy", default=None, metavar="NAME",
                    help="not ported yet (ROADMAP queue 1 item 9b)")
    args = ap.parse_args(argv)

    if args.placement:
        given = [f"--{f}" for f in SCHEDULER_FLAGS if getattr(args, f)]
        if given:
            raise NotImplementedError(
                f"{', '.join(given)}: the placement scheduler and front-end are "
                "not ported yet (ROADMAP queue 1 item 9b)")
        placement_main(args)
        return
    if args.dry_run:
        raise NotImplementedError("--dry-run: the dry-run is not ported yet "
                                  "(ROADMAP queue 1 item 11)")
    if args.arch is None:
        ap.error("--arch is required")

    dev = resolve_device(args.torch_device)
    cfg = get_reduced(args.arch) if args.reduced else get_arch(args.arch)
    model = Transformer(cfg, device=dev, dtype=torch.float32,
                        generator=torch.Generator(device=dev).manual_seed(0))
    eng = Engine(model, n_slots=max(2, args.requests // 2), max_len=96, eos_id=-1)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, rng.integers(4, 10)).astype(np.int32)
               for _ in range(args.requests)]
    for i, toks in eng.generate(prompts, max_new=args.max_new).items():
        print(f"req{i}: {toks}")


if __name__ == "__main__":
    main()
