"""Benchmark entry point: one function per paper table/figure.

Port of `benchmarks/run.py`:

    python -m repro_torch.benchmarks.run [--full] [--only NAME] [--torch-device cpu]
        [--dryrun-dir experiments/dryrun]

executes the quick variants of every benchmark and finishes with a
`name,us_per_call,derived` CSV summary.  Pass --full for paper-scale
budgets.  `roofline` reads the dry-run's artifacts from --dryrun-dir
(`repro_torch.benchmarks.roofline`).  The placement service benchmark is
not ported yet: a full run says so in its output and its summary, and
`--only placement_service` raises `NotImplementedError`.
"""
from __future__ import annotations

import argparse
import io
import time
from contextlib import redirect_stdout

NOT_PORTED = {
    "placement_service": "benchmarks/bench_service.py is not ported yet "
                         "(ROADMAP queue 1 item 10b: bench_torch.py)",
}


def _run(name, fn, *args, **kw):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        fn(*args, **kw)
    dt = time.perf_counter() - t0
    print(f"\n===== {name} ({dt:.1f}s) =====")
    print(buf.getvalue().rstrip())
    return dt


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--only", default=None)
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dryrun-dir", default="experiments/dryrun")
    args = ap.parse_args(argv)
    quick, dev = not args.full, args.torch_device
    if args.only in NOT_PORTED:
        raise NotImplementedError(f"{args.only}: {NOT_PORTED[args.only]}")

    from repro_torch.benchmarks import (fig7_convergence, fig8_cooling,
                                        fig9_pipelining, roofline, table1,
                                        table2_transfer)

    benches = {
        "placement_service": None,
        "table1_qor": lambda: table1.main(quick=quick, torch_device=dev),
        "fig7_convergence": lambda: fig7_convergence.main(
            quick=quick, torch_device=dev),
        "fig8_cooling": lambda: fig8_cooling.main(quick=quick, torch_device=dev),
        "fig9_pipelining": lambda: fig9_pipelining.main(
            quick=quick, torch_device=dev),
        "table2_transfer": lambda: table2_transfer.main(
            quick=quick, torch_device=dev),
        "roofline": lambda: roofline.main(args.dryrun_dir),
    }
    rows = []
    for name, fn in benches.items():
        if args.only and args.only != name:
            continue
        if fn is None:
            print(f"\n===== {name}: not run: {NOT_PORTED[name]} =====")
            rows.append((name, None, f"not run: {NOT_PORTED[name]}"))
            continue
        dt = _run(name, fn)
        rows.append((name, dt * 1e6, "see section above"))

    print("\n===== summary (name,us_per_call,derived) =====")
    for name, us, derived in rows:
        print(f"{name},{'' if us is None else f'{us:.0f}'},{derived}")


if __name__ == "__main__":
    main()
