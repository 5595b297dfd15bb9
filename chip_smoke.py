#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds the five CUDA kernels from `src/repro_torch/csrc/` for sm_90a.
2. Holds each kernel against its plain PyTorch version on the card over
   the sweep shapes and the main paths' shapes (SA's 1 row, CMA-ES's 24,
   the xcvu9p width), in f32 and bf16 (flash
   attention over the reference's test grid, the serving path's prefill
   shapes, gemma3's D = 256 under a window and the tile edges of its
   tensor-core routes; domination bitwise, at the edges of its tiles too).
3. Runs the placement path, NSGA-II on xcvu11p (80 conv units, pop 64, 200
   generations), through `repro_torch.core.evolve.run`, once unfused and
   once fused, with every launch counter set to 0 just before each run and
   read just after; checks the champion's legality, the improvement over
   the initial population, and the final objectives against the plain
   versions on the CPU.  Then runs the quickstart entry point on the card
   for a few generations and checks the launches of its evaluation and
   its final Pareto sort.
   Then the paper's Table I on xcvu11p at benchmarks/table1.py's quick
   budgets, unfused: the GA (pop 48, 75 generations) and sep-CMA-ES
   (lambda 24, 150 generations) through `evolve.run`, SA (hyperbolic, 2000
   steps) through `annealing.run_chain`, and each of SA's four schedules
   for 50 steps fused; and Table II at table2_transfer.py's quick scale:
   NSGA-II pop 32 x 60 generations on xcvu3p, its champion migrated to
   xcvu9p, then a scratch and a warm-started run there.  Each run has its
   launches counted and checked, its champion checked for legality and
   against the plain versions on the CPU, and its improvement checked;
   the warm start's first generation must be at least as good as the
   scratch run's.  Each champion is pipelined to 650 MHz.
   Then serves yi-6b at full width (fp32, weights from seed 0) through
   `repro_torch.serve.engine.Engine`: 8 requests of 77-2048 prompt tokens
   and 32 new tokens each over 4 slots, with the launch counters set to 0
   just before and read just after; every prefill attention layer must
   launch the flash-attention kernel, and the last-token prefill logits
   through the kernel must match those through the plain attention.  A
   torch.profiler trace of a pool decode step and of the longest prefill
   gives their device busy share and top kernels.
4. Times each kernel and its plain version with CUDA events at the path's
   shapes, at the baselines' and the transfer's shapes, and at 2048 rows
   (and each call's device time from a
   torch.profiler trace: the kernel and any memset or copy the call
   issues), domination against its plain version over
   SWEEP_ROWS, flash attention at the serving path's longest prefill
   against `scaled_dot_product_attention` as a yardstick (f32 beside its
   FMA and 3xTF32 bounds), and a generation against its rank peeling and
   its device busy share.

Prints the card's name and power limit, one JSON line of kernel figures,
and as its last line `{"ok": true, "device": {...}}`.  Exits non-zero,
without that line, when no CUDA device is present or any phase fails.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

FPGA_DEVICE = "xcvu11p"
POP, GENS, SEED = 64, 200, 0
SWEEP_ROWS = (1, 7, 64, 127, 128, 129, 200, 2048)
# (gids, nets, units, blocks): the reference's tile-crossing sweep extents,
# then the main path's xcvu11p extents
EVAL_SHAPES = ((37, 11, 5, 7), (96, 511, 3, 28), (96, 512, 3, 28),
               (96, 513, 3, 28), (640, 40, 127, 5), (640, 40, 128, 5),
               (640, 40, 129, 5), (3640, 999, 130, 28), (2240, 1999, 80, 28))
# flash attention: (b, h, hkv, s, t, d, window, input scale) -- the
# reference's test grid (inputs x 0.02 as there), the serving path's
# prefill shapes, gemma3's D = 256 under its window, and S > T; then the
# tile edges of the tensor-core routes (64-row q tiles in bf16, 128 in f32,
# 64-key kv tiles): S and T both ragged with S < T (TMA zero fill at both
# tails), B = 2 with one kv head, and D = 64 and 256 under a window
FLASH_CASES = ([(b, h, hkv, s, s, d, None, 0.02) for b, h, hkv, s, d in (
                   (1, 2, 2, 128, 64), (2, 4, 2, 200, 64), (1, 8, 1, 384, 128),
                   (1, 2, 2, 96, 64))]
               + [(1, 2, 2, 256, 256, 64, w, 0.02) for w in (32, 128)]
               + [(2, 4, 2, 64, 320, 64, None, 0.02)]
               + [(1, 32, 4, s, s, 128, None, 1.0) for s in (77, 128, 257, 1024, 2048)]
               + [(1, 16, 8, 1500, 1500, 256, 1024, 1.0), (1, 4, 2, 100, 60, 128, None, 1.0)]
               + [(1, 4, 2, 190, 333, 128, None, 1.0), (1, 4, 2, 129, 1000, 64, None, 1.0),
                  (2, 8, 1, 257, 257, 128, None, 1.0),
                  (1, 4, 2, 300, 300, 64, 100, 1.0), (1, 4, 2, 300, 300, 256, 100, 1.0)])
# domination: the reference's sweep, the tile edges (P % 16 != 0 gives byte
# stores; 256 x 16 tiles up to 256 rows, 64 x 64 tiles and a memset above)
# and a size past the island batch
DOM_SIZES = (1, 3, 7, 32, 63, 64, 65, 127, 128, 129, 200, 255, 256, 257, 2048, 4096)
# the baselines' and the transfer's shapes: SA's 1 row, CMA-ES's lambda = 24
# (and 25 past it), the GA's 48, and the transfer's 32 and 64 rows, at the
# xcvu11p width and the xcvu3p / xcvu9p width (gids, nets, units, blocks)
SLICE_ROWS = (1, 24, 25, 32, 48, 64)
SLICE_SHAPES = ((2240, 1999, 80, 28), (3444, 3074, 123, 28))
# Table I at benchmarks/table1.py's quick scale (budgets x 0.25) on xcvu11p
GA_POP, GA_GENS = 48, 75
CMAES_POP, CMAES_GENS = 24, 150
SA_STEPS, SA_SCHEDULE_STEPS = 2000, 50
# Table II at benchmarks/table2_transfer.py's quick scale, one target device
TRANSFER_SRC, TRANSFER_DST = "xcvu3p", "xcvu9p"
TRANSFER_POP, TRANSFER_GENS = 32, 60
SERVE_ARCH = "yi-6b"
SERVE_PROMPTS = (2048, 1531, 1024, 700, 512, 257, 128, 77)
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_MAX_NEW = 4, 2080, 32
# kernel vs plain attention through the whole model: the per-layer fp32
# differences (~1e-6 of the attention output) pass through 32 layers
LOGITS_TOL = dict(rtol=1e-4, atol=1e-4)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense


def tol(dtype, kernel: str = ""):
    """The placement kernels: rtol 1e-5 / atol 1e-6.  Flash attention in f32:
    the reference's own flash tests' rtol 2e-5 / atol 1e-5, because with
    unit-scale q and k the fp32 logits of a 128-term dot product differ by
    ~1e-6 between two summation orders, and exp passes that on to every
    weight of the sum over T."""
    import torch
    if dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2)
    if kernel == "flash_attention":
        return dict(rtol=2e-5, atol=1e-5)
    return dict(rtol=1e-5, atol=1e-6)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ------------------------------------------------------------ phase 2

def check_kernels(rng):
    """Every kernel against its plain version on the card; returns the max
    abs error of each kernel over the f32 cases."""
    import torch

    from repro_torch.kernels import bbox, domination, flash_attention, fused_eval, ref, wirelength

    dev = torch.device("cuda")
    errs = {"fused_eval": 0.0, "wirelength2": 0.0, "maxbbox": 0.0, "domination": 0.0,
            "domination_counts": 0.0, "flash_attention": 0.0}
    n_cases = dict.fromkeys(errs, 0)

    def coords(*shape):
        return torch.tensor(rng.normal(size=shape) * 50, dtype=torch.float32, device=dev)

    def ints(hi, *shape):
        return torch.tensor(rng.integers(0, hi, size=shape), dtype=torch.int32, device=dev)

    def close(name, got, want, dtype):
        torch.cuda.synchronize()
        got, want = got.float(), want.float()
        torch.testing.assert_close(got, want, **tol(dtype, name), msg=lambda m: f"{name}: {m}")
        if dtype == torch.float32:
            errs[name] = max(errs[name], float((got - want).abs().max()))
        n_cases[name] += 1

    for dtype in (torch.float32, torch.bfloat16):
        for g, n, u, b in EVAL_SHAPES:
            src, dst, uidx = ints(g, n), ints(g, n), ints(g, u, b)
            w = (coords(n).abs() * 0.002).to(dtype)
            for p in SWEEP_ROWS:
                cx, cy = coords(p, g).to(dtype), coords(p, g).to(dtype)
                close("fused_eval", fused_eval.fused_eval(cx, cy, src, dst, w, uidx),
                      ref.fused_eval_ref(cx, cy, src, dst, w, uidx), dtype)
        for n in (7, 512, 1999, 4097):
            for p in SWEEP_ROWS:
                xs = [coords(p, n).to(dtype) for _ in range(4)]
                for w in ((coords(n).abs() * 0.1).to(dtype),
                          (coords(p, n).abs() * 0.1).to(dtype)):
                    close("wirelength2", wirelength.wirelength2(*xs, w),
                          ref.wirelength2_ref(*xs, w), dtype)
        for u, b in ((6, 28), (80, 28), (123, 28), (130, 5), (128, 32)):
            for p in SWEEP_ROWS:
                ux, uy = coords(p, u, b).to(dtype), coords(p, u, b).to(dtype)
                close("maxbbox", bbox.maxbbox(ux, uy), ref.maxbbox_ref(ux, uy), dtype)
        for g, n, u, b in SLICE_SHAPES:
            src, dst, uidx = ints(g, n), ints(g, n), ints(g, u, b)
            w = (coords(n).abs() * 0.002).to(dtype)
            for p in SLICE_ROWS:
                cx, cy = coords(p, g).to(dtype), coords(p, g).to(dtype)
                close("fused_eval", fused_eval.fused_eval(cx, cy, src, dst, w, uidx),
                      ref.fused_eval_ref(cx, cy, src, dst, w, uidx), dtype)
                xs = [coords(p, n).to(dtype) for _ in range(4)]
                close("wirelength2", wirelength.wirelength2(*xs, w),
                      ref.wirelength2_ref(*xs, w), dtype)
                ux, uy = coords(p, u, b).to(dtype), coords(p, u, b).to(dtype)
                close("maxbbox", bbox.maxbbox(ux, uy), ref.maxbbox_ref(ux, uy), dtype)
        for p in DOM_SIZES:
            for m in (2, 3):
                objs = torch.tensor(rng.uniform(size=(p, m)), dtype=torch.float32)
                if p >= 2:
                    objs[1] = objs[0]                  # full duplicate row
                if p >= 4:
                    objs[3, 0] = objs[2, 0]            # tie on one objective
                if p >= 8:
                    objs[p // 2:] = torch.round(objs[p // 2:] * 4) / 4   # many ties
                objs = objs.to(device=dev, dtype=dtype)
                want, want_cnt = ref.domination_counts_ref(objs)
                got = domination.domination(objs)
                got2, cnt = domination.domination_counts(objs)
                torch.cuda.synchronize()
                for d in (got, got2):
                    if not torch.equal(d, want):
                        raise AssertionError(f"domination differs at P={p}, M={m}, {dtype}")
                if not torch.equal(cnt, want_cnt):
                    raise AssertionError(f"domination counts differ at P={p}, M={m}, {dtype}")
                n_cases["domination"] += 1
                n_cases["domination_counts"] += 1
        for b, h, hkv, s, t, d, window, scale in FLASH_CASES:
            q = (coords(b, h, s, d) * (scale / 50)).to(dtype)
            k, v = ((coords(b, hkv, t, d) * (scale / 50)).to(dtype) for _ in range(2))
            got = flash_attention.flash_attention(q, k, v, True, window)
            want = ref.flash_attention_ref(q, k, v, True, window)
            if s > t:   # rows with no visible key: 0 from the kernel, NaN plain
                torch.cuda.synchronize()
                if not (got[:, :, : s - t] == 0).all():
                    raise AssertionError("flash_attention: a row with no key is not 0")
                got, want = got[:, :, s - t:], want[:, :, s - t:]
            close("flash_attention", got, want, dtype)

    # bounds: kernels read nothing past the real N, U and P -- the tails of
    # the buffers they are sliced from hold indices far out of range and
    # huge coordinates, which would show as NaN or a wrong max if read.
    g, n, u, b, p = 96, 513, 9, 7, 4
    src_buf, dst_buf = ints(g, 2 * n), ints(g, 2 * n)
    src_buf[n:] = g + 1000
    dst_buf[n:] = g + 1000
    uidx_buf = ints(g, 2 * u, b)
    uidx_buf[u:] = g + 1000
    cx_buf, cy_buf = coords(2 * p, g), coords(2 * p, g)
    cx_buf[p:], cy_buf[p:] = 3.0e37, -3.0e37
    w = coords(n).abs() * 0.01
    src, dst, uidx, cx, cy = src_buf[:n], dst_buf[:n], uidx_buf[:u], cx_buf[:p], cy_buf[:p]
    close("fused_eval", fused_eval.fused_eval(cx, cy, src, dst, w, uidx),
          ref.fused_eval_ref(cx, cy, src, dst, w, uidx), torch.float32)
    # an index out of range yields NaN instead of a read out of bounds
    bad = fused_eval.fused_eval(cx, cy, src_buf[: n + 1], dst_buf[: n + 1],
                                coords(n + 1).abs(), uidx)
    torch.cuda.synchronize()
    if not torch.isnan(bad).all():
        raise AssertionError("fused_eval: an out-of-range net index did not yield NaN")
    return errs, n_cases


# ------------------------------------------------------------ phase 3

def counted(kernels, fn):
    """fn() with every launch counter set to 0 just before and read just
    after; returns (result, seconds, {label: launches})."""
    import torch
    for k in kernels.values():
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {n: k.launches for n, k in kernels.items()}


def expect_launches(what, launches, want):
    """Each counter must equal `want` ({label: count}, the rest 0)."""
    full = {n: want.get(n, 0) for n in launches}
    if launches != full:
        raise AssertionError(f"{what}: launches {launches}, expected {full}")
    return launches


def run_main_path(problem, fused: bool, kernels):
    import torch

    from repro_torch.core import evolve, hyper, nsga2
    from repro_torch.core import genotype as G
    from repro_torch.core import objectives as O
    from repro_torch.kernels import ref

    dev = torch.device("cuda")
    cfg = nsga2.NSGA2Config(pop_size=POP, fused=fused)
    init = nsga2.init_state(problem, torch.Generator(device=dev).manual_seed(SEED),
                            hyper.tracify(cfg, dev))
    init_best = float(O.combined_metric(init["objs"]).min())

    (state, hist), seconds, launches = counted(kernels, lambda: evolve.run(
        problem, "nsga2", cfg, torch.Generator(device=dev).manual_seed(SEED), GENS,
        device="cuda"))

    if hist.shape != (GENS, 2) or not torch.isfinite(hist).all():
        raise AssertionError(f"history is not finite [{GENS}, 2]")
    final = O.combined_metric(state["objs"])
    final_best = float(final.min())
    if not final_best < init_best:
        raise AssertionError(f"no improvement: {final_best} vs initial {init_best}")
    champ = int(torch.argmin(final))
    O.assert_valid(problem, G.tree_map(lambda a: a[champ], state["pop"]))
    # the card's objectives against the plain versions on the CPU
    bx, by = G.decode(problem, state["pop"])
    tabs = [torch.as_tensor(a) for a in (problem.net_src, problem.net_dst, problem.net_w)]
    uidx = O.unit_index(problem, "cpu")
    want = ref.fused_eval_ref(bx.cpu(), by.cpu(), *tabs, uidx)
    torch.testing.assert_close(state["objs"].cpu(), want, **tol(torch.float32))
    return dict(seconds=seconds, gens_per_s=GENS / seconds,
                evals_per_s=POP * (GENS + 1) / seconds, init_best=init_best,
                final_best=final_best, launches=launches, coords=(bx, by),
                objs=state["objs"], champion=G.tree_map(lambda a: a[champ], state["pop"]),
                champion_objs=state["objs"][champ])


def run_quickstart(kernels, generations: int = 5):
    """The user's entry point on the card; returns its launches and output."""
    import io

    from repro_torch.launch import quickstart

    out = io.StringIO()

    def run():
        with contextlib.redirect_stdout(out):
            quickstart.main(["--device", FPGA_DEVICE, "--generations", str(generations),
                             "--pop", str(POP)])

    _, _, launches = counted(kernels, run)
    text = out.getvalue()
    if "validated legal" not in text or "Pareto front" not in text:
        raise AssertionError(f"quickstart output lacks its result:\n{text}")
    return launches, text


# ------------------------------------------------------------ phase 3c

def check_champion(problem, g, objs):
    """Legal, and its card objectives equal the plain versions on the CPU
    over the card's decoded coordinates."""
    import torch

    from repro_torch.core import genotype as G
    from repro_torch.core import objectives as O
    from repro_torch.kernels import ref

    O.assert_valid(problem, g)
    bx, by = G.decode(problem, G.tree_map(lambda a: a[None], g))
    tabs = [torch.as_tensor(a) for a in (problem.net_src, problem.net_dst, problem.net_w)]
    want = ref.fused_eval_ref(bx.cpu(), by.cpu(), *tabs, O.unit_index(problem, "cpu"))[0]
    torch.testing.assert_close(objs.cpu(), want, **tol(torch.float32))


def summarize(problem, g, objs):
    """Table I's columns, as benchmarks/common.py::summarize computes them."""
    from repro_torch.core import genotype as G
    from repro_torch.core import objectives as O
    from repro_torch.core import pipelining
    from repro_torch.core.tables import problem_tensors

    lens = O.net_lengths(problem, G.tree_map(lambda a: a[None], g))[0]
    rep = pipelining.auto_pipeline(problem, g, target_mhz=650.0)
    return {"wirelength": float((lens * problem_tensors(problem, lens.device).net_w).sum()),
            "wl2": float(objs[0]), "max_bbox": float(objs[1]),
            "pipeline_regs_650": rep.total_registers,
            "freq_mhz_unpipelined": pipelining.frequency_at_depth(problem, g, 0),
            "freq_mhz_pipelined": rep.freq_mhz}


def run_table1(problem, kernels):
    """GA, sep-CMA-ES and SA (hyperbolic) at table1.py's quick budgets,
    unfused, then SA's four schedules fused; returns Table I's rows and
    each path's launches."""
    import torch

    from repro_torch.core import annealing, cmaes, evolve, ga, portfolio
    from repro_torch.core import objectives as O

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    def unfused(n):
        return {"wirelength2": n, "maxbbox": n}

    rows, paths = {}, {}
    for name, cfg, gens, n_evals in (
            ("ga", ga.GAConfig(pop_size=GA_POP), GA_GENS, GA_GENS + 1),
            ("cmaes", cmaes.CMAESConfig(pop_size=CMAES_POP), CMAES_GENS, CMAES_GENS)):
        (state, hist), dt, launches = counted(
            kernels, lambda: evolve.run(problem, name, cfg, gen(SEED), gens, device="cuda"))
        paths[name] = expect_launches(name, launches, unfused(n_evals))
        first, last = (float(O.combined_metric(h)) for h in (hist[0], hist[-1]))
        if not last < first:
            raise AssertionError(f"{name}: no improvement, {last} vs first {first}")
        g, objs = portfolio.best_genotype(problem, name, state)
        check_champion(problem, g, objs)
        rows[name] = dict(summarize(problem, g, objs), runtime_s=dt,
                          evaluations=gens * cfg.pop_size, step_ms=dt / gens * 1e3,
                          first=first, best=last)

    cfg = annealing.SAConfig(schedule="hyperbolic", t0=2.0, beta=2e-3)
    st0 = annealing.init_state(problem, gen(SEED), cfg)
    out, dt, launches = counted(
        kernels, lambda: annealing.run_chain(problem, cfg, gen(SEED + 1), SA_STEPS, st0))
    paths["sa"] = expect_launches("sa", launches, unfused(SA_STEPS))
    first = float(O.combined_metric(out["history"][0]))
    best = float(O.combined_metric(out["state"]["best_objs"]))
    if not best < first:
        raise AssertionError(f"sa: no improvement, {best} vs first {first}")
    g, objs = portfolio.best_genotype(problem, "sa", out["state"])
    check_champion(problem, g, objs)
    rows["sa"] = dict(summarize(problem, g, objs), runtime_s=dt, evaluations=SA_STEPS,
                      step_ms=dt / SA_STEPS * 1e3, first=first, best=best)

    schedules = {}
    for schedule in annealing.SCHEDULES:
        cfg = annealing.SAConfig(schedule=schedule, fused=True)
        st0 = annealing.init_state(problem, gen(SEED + 2), cfg)
        out, dt, launches = counted(kernels, lambda: annealing.run_chain(
            problem, cfg, gen(SEED + 3), SA_SCHEDULE_STEPS, st0))
        paths[f"sa_{schedule}_fused"] = expect_launches(
            f"sa {schedule} fused", launches, {"fused_eval": SA_SCHEDULE_STEPS})
        first = float(O.combined_metric(out["history"][0]))
        best = float(O.combined_metric(out["state"]["best_objs"]))
        if not (math.isfinite(best) and best <= first):
            raise AssertionError(f"sa {schedule}: best {best} vs first {first}")
        g, objs = portfolio.best_genotype(problem, "sa", out["state"])
        check_champion(problem, g, objs)
        schedules[schedule] = dict(first=first, best=best, step_ms=dt / SA_SCHEDULE_STEPS * 1e3)
    return rows, schedules, paths


def run_table2(kernels):
    """NSGA-II on TRANSFER_SRC, its champion migrated to TRANSFER_DST, then
    a scratch and a warm-started run there (table2_transfer.py at quick)."""
    import torch

    from repro_torch.core import evolve, hyper, nsga2, pipelining, portfolio, transfer
    from repro_torch.core import objectives as O
    from repro_torch.fpga import device, netlist

    src, dst = (netlist.make_problem(device.get_device(n)) for n in (TRANSFER_SRC, TRANSFER_DST))
    cfg = nsga2.NSGA2Config(pop_size=TRANSFER_POP)
    want = {"wirelength2": TRANSFER_GENS + 1, "maxbbox": TRANSFER_GENS + 1,
            "domination": 2 * TRANSFER_GENS}
    paths, runs = {}, {}

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    for name, problem, seed in (("seed", src, SEED), ("scratch", dst, SEED + 1)):
        (state, hist), dt, launches = counted(kernels, lambda: evolve.run(
            problem, "nsga2", cfg, gen(seed), TRANSFER_GENS, device="cuda"))
        paths[f"transfer_{name}"] = expect_launches(name, launches, want)
        first, last = (float(O.combined_metric(h)) for h in (hist[0], hist[-1]))
        if not last < first:
            raise AssertionError(f"transfer {name}: no improvement, {last} vs first {first}")
        g, objs = portfolio.best_genotype(problem, "nsga2", state)
        check_champion(problem, g, objs)
        runs[name] = dict(g=g, objs=objs, hist=hist, seconds=dt)

    g_mig = transfer.migrate(src, dst, runs["seed"]["g"])
    O.assert_valid(dst, g_mig)

    def warm():
        g = gen(SEED + 2)
        state = transfer.seed_population(dst, g_mig, g, TRANSFER_POP)
        tcfg = hyper.tracify(cfg, "cuda")
        hist = torch.empty(TRANSFER_GENS, 2, device="cuda")
        for i in range(TRANSFER_GENS):
            state = nsga2.step_impl(dst, tcfg, state, g)
            hist[i] = evolve.state_best_objs(state)
        return state, hist

    (state, hist), dt, launches = counted(kernels, warm)
    paths["transfer_warm"] = expect_launches("warm", launches, want)
    g, objs = portfolio.best_genotype(dst, "nsga2", state)
    check_champion(dst, g, objs)
    runs["warm"] = dict(g=g, objs=objs, hist=hist, seconds=dt)

    scratch_first, warm_first = (float(O.combined_metric(runs[k]["hist"][0]))
                                 for k in ("scratch", "warm"))
    if not warm_first <= scratch_first:
        raise AssertionError(f"warm start's first generation {warm_first} is worse than "
                             f"scratch's {scratch_first}")
    target = float(O.combined_metric(runs["scratch"]["objs"])) * 1.05

    def evals_to_target(hist):
        comb = O.combined_metric(hist).cpu()
        hit = torch.nonzero(comb <= target).flatten()
        return int(hit[0] + 1) * TRANSFER_POP if len(hit) else len(comb) * TRANSFER_POP

    ev_s, ev_t = (evals_to_target(runs[k]["hist"]) for k in ("scratch", "warm"))
    row = dict(evals_scratch=ev_s, evals_transfer=ev_t, speedup=ev_s / max(ev_t, 1),
               mhz_scratch=pipelining.frequency_at_depth(dst, runs["scratch"]["g"], 1),
               mhz_transfer=pipelining.frequency_at_depth(dst, runs["warm"]["g"], 1),
               first_scratch=scratch_first, first_warm=warm_first, target=target,
               seconds={k: v["seconds"] for k, v in runs.items()})
    return row, paths


# ------------------------------------------------------------ phase 4

def time_ms(fn, iters=200) -> float:
    import torch
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, symbol: str, iters: int = 50, traces: int = 3):
    """(device ms, device ops) of one call of `fn`, from a torch.profiler
    trace: the kernels whose names hold `symbol` and every memset or copy
    the call issues besides (domination's launcher zeroes its counts with
    a memset above 256 rows), divided by the launches of `symbol`.  A trace
    now and then comes back without the kernel's events; up to `traces`
    are taken, and (None, None) means none of them showed it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(traces):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us, ops, launches = 0.0, 0, 0
        for e in prof.key_averages():
            if symbol in e.key or e.key.startswith(("Memset", "Memcpy")):
                us += e.device_time_total
                ops += e.count
            if symbol in e.key:
                launches += e.count
        if launches and us:
            return us / launches / 1e3, ops / launches
    return None, None


def device_ms(fn, symbol: str, iters: int = 50, traces: int = 3):
    """Device ms of one call of `fn`, as `device_profile` counts it."""
    return device_profile(fn, symbol, iters, traces)[0]


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


SYMBOLS = {"fused_eval": "fused_eval_kernel", "wirelength2": "wirelength_kernel",
           "maxbbox": "bbox_kernel", "domination": "domination_kernel",
           "domination_counts": "domination_kernel"}


def kernel_calls(problem, bx, by, objs):
    """(kernel call, plain call, bytes, operations) of each placement kernel
    on coordinates bx, by [P, G] of `problem` and objectives objs [Q, 2]."""
    from repro_torch.core.tables import problem_tensors
    from repro_torch.kernels import bbox, domination, fused_eval, ref, wirelength

    tabs = problem_tensors(problem, "cuda")
    s, d, w, uidx = tabs.net_src, tabs.net_dst, tabs.net_w, tabs.unit_index
    (p, g), n, (u, b), q = bx.shape, s.shape[0], uidx.shape, objs.shape[0]
    x1, y1, x2, y2 = (a.index_select(1, idx).contiguous() for idx in (s, d) for a in (bx, by))
    ux, uy = bx.reshape(p, u, b), by.reshape(p, u, b)
    return {
        "fused_eval": (lambda: fused_eval.fused_eval(bx, by, s, d, w, uidx),
                       lambda: ref.fused_eval_ref(bx, by, s, d, w, uidx),
                       8 * p * g + 12 * n + 4 * u * b + 8 * p,
                       p * (8 * n + 4 * u * b + 3 * u)),
        "wirelength2": (lambda: wirelength.wirelength2(x1, y1, x2, y2, w),
                        lambda: ref.wirelength2_ref(x1, y1, x2, y2, w),
                        16 * p * n + 4 * n + 4 * p, 8 * p * n),
        "maxbbox": (lambda: bbox.maxbbox(ux, uy), lambda: ref.maxbbox_ref(ux, uy),
                    8 * p * u * b + 4 * p, p * (4 * u * b + 3 * u)),
        "domination": (lambda: domination.domination(objs),
                       lambda: ref.domination_ref(objs), 8 * q + q * q, 6 * q * q),
        "domination_counts": (lambda: domination.domination_counts(objs),
                              lambda: ref.domination_counts_ref(objs),
                              8 * q + q * q + 4 * q, 6 * q * q),
    }


def kernel_figures(problem, coords, objs, errs, launches):
    import torch

    from repro_torch.kernels import domination, ref

    n, g = problem.n_nets, coords[0].shape[1]
    u, b = problem.n_units, coords[0].shape[1] // problem.n_units
    objs128 = torch.cat([objs, objs.flip(0) * 1.01]).contiguous()
    rows = {}

    def shapes_at(p):
        reps = math.ceil(p / coords[0].shape[0])
        bx, by = (c.repeat(reps, 1)[:p].contiguous() for c in coords)
        o = objs128 if p == POP else torch.rand(p, 2, device="cuda")
        return kernel_calls(problem, bx, by, o)

    at_path = shapes_at(POP)
    at_2048 = shapes_at(2048)
    meta = {
        "fused_eval": ("src/repro_torch/csrc/fused_eval.cu",
                       "src/repro/kernels/fused_eval.py:106 (fused_eval_pallas, body :52)",
                       f"[{POP}, {g}] f32, N={n}, U={u}, B={b}"),
        "wirelength2": ("src/repro_torch/csrc/wirelength.cu",
                        "src/repro/kernels/wirelength.py:51 (wirelength2_pallas, body :28)",
                        f"[{POP}, {n}] f32, w [{n}]"),
        "maxbbox": ("src/repro_torch/csrc/bbox.cu",
                    "src/repro/kernels/bbox.py:56 (maxbbox_pallas, body :27)",
                    f"[{POP}, {u}, {b}] f32"),
        "domination": ("src/repro_torch/csrc/domination.cu",
                       "src/repro/kernels/domination.py:44 (domination_pallas, body :23)",
                       f"[{2 * POP}, 2] f32, no counts (unfused paths)"),
        "domination_counts": ("src/repro_torch/csrc/domination.cu",
                              "src/repro/kernels/fused_eval.py:162 (domination_counts_pallas, "
                              "body :131)",
                              f"[{2 * POP}, 2] f32 with counts (fused paths)"),
    }
    for name, (src, replaces, shape) in meta.items():
        kern, plain, nbytes, nops = at_path[name]
        k2, p2, nbytes2, nops2 = at_2048[name]
        bms, by_what = bound_ms(nbytes, nops)
        bms2, by2 = bound_ms(nbytes2, nops2)
        dev, ops = device_profile(kern, SYMBOLS[name])
        dev2, ops2 = device_profile(k2, SYMBOLS[name])
        rows[name] = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": bms, "bound_by": by_what, "library_ms": None,
            "shape": shape, "ms_2048": time_ms(k2), "plain_ms_2048": time_ms(p2),
            "bound_ms_2048": bms2, "bound_by_2048": by2,
            "device_ms": dev, "device_ops": ops,
            "device_ms_2048": dev2, "device_ops_2048": ops2,
        }
    # domination against its plain version over the sweep sizes
    sweep = {}
    for p in SWEEP_ROWS:
        o = torch.rand(p, 2, device="cuda")
        kern, plain = (lambda: domination.domination_counts(o)), (lambda: ref.domination_counts_ref(o))
        dev, ops = device_profile(kern, SYMBOLS["domination"])
        sweep[p] = dict(ms=time_ms(kern), plain_ms=time_ms(plain), device_ms=dev,
                        device_ops=ops)
    rows["domination_counts"]["sweep"] = sweep
    return [rows[k] for k in meta]


def slice_figures():
    """Each placement kernel at the shapes the baselines and the transfer
    give it: SA's 1 row, CMA-ES's lambda, the GA's population (xcvu11p), the
    transfer's population on xcvu9p, and domination at the transfer's P and
    2P; per call (CUDA events), device time, bound and plain version."""
    import torch

    from repro_torch.fpga import device, netlist

    out = {k: {} for k in ("fused_eval", "wirelength2", "maxbbox", "domination")}

    def record(name, key, calls):
        kern, plain, nbytes, nops = calls
        bms, by_what = bound_ms(nbytes, nops)
        dev, ops = device_profile(kern, SYMBOLS[name])
        out[name][key] = dict(ms=time_ms(kern), device_ms=dev, device_ops=ops,
                              bound_ms=bms, bound_by=by_what, plain_ms=time_ms(plain))

    for path, dev_name, p in (("sa", FPGA_DEVICE, 1), ("cmaes", FPGA_DEVICE, CMAES_POP),
                              ("ga", FPGA_DEVICE, GA_POP),
                              ("transfer", TRANSFER_DST, TRANSFER_POP)):
        problem = netlist.make_problem(device.get_device(dev_name))
        bx, by = (torch.rand(p, problem.n_blocks, device="cuda") * 100 for _ in range(2))
        calls = kernel_calls(problem, bx, by, torch.rand(p, 2, device="cuda"))
        for name in ("fused_eval", "wirelength2", "maxbbox"):
            record(name, f"{path} [{p}, {problem.n_blocks}]", calls[name])
        if path == "transfer":
            for q in (p, 2 * p):      # unfused, as the transfer runs
                record("domination", f"{path} [{q}, 2]",
                       kernel_calls(problem, bx, by, torch.rand(q, 2, device="cuda"))["domination"])
    return out


def profiled(fn, reps: int):
    """`reps` calls of `fn` under torch.profiler: (host-clock µs, device ops
    per call, the device's busy share -- kernel time over wall time -- and
    the profile)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return wall_us, len(kernels) / reps, (busy_us / wall_us if kernels else None), prof


def generation_profile(problem):
    """Per generation at the path's shapes: host-clock time of a step and of
    its two rank peels (P and 2P), and the device's busy share of a step."""
    import torch

    from repro_torch.core import hyper, nsga2

    out = {}
    for fused in (False, True):
        dev = torch.device("cuda")
        gen = torch.Generator(device=dev).manual_seed(SEED + 1)
        cfg = hyper.tracify(nsga2.NSGA2Config(pop_size=POP, fused=fused), dev)
        st = nsga2.init_state(problem, gen, cfg)
        both = torch.cat([st["objs"], st["objs"].flip(0) * 1.01]).contiguous()

        def timed(fn, reps=20):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps

        def step():
            return nsga2.step_impl(problem, cfg, st, gen)

        step_s = timed(step)
        peel_s = timed(lambda: (nsga2.nondominated_rank(st["objs"], fused),
                                nsga2.nondominated_rank(both, fused)))
        _, ops, busy, _ = profiled(step, reps=5)
        out["fused" if fused else "unfused"] = dict(
            step_ms=step_s * 1e3, peel_ms=peel_s * 1e3, peel_share=peel_s / step_s,
            device_ops_per_step=ops, device_busy_share=busy)
    return out


def baseline_profile(problem, reps: int = 5):
    """Per step of each baseline at Table I's shapes (unfused): host-clock
    ms, device ops and the device's busy share under torch.profiler."""
    import torch

    from repro_torch.core import annealing, cmaes, ga, hyper

    out = {}
    for name, m, cfg in (("ga", ga, ga.GAConfig(pop_size=GA_POP)),
                         ("cmaes", cmaes, cmaes.CMAESConfig(pop_size=CMAES_POP)),
                         ("sa", annealing, annealing.SAConfig(schedule="hyperbolic", beta=2e-3))):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
        cfg = hyper.tracify(cfg, "cuda")
        st = m.init_state(problem, gen, cfg)
        wall_us, ops, busy, _ = profiled(lambda: m.step_impl(problem, cfg, st, gen), reps)
        out[name] = dict(step_ms=wall_us / reps / 1e3, device_ops_per_step=ops,
                         device_busy_share=busy)
    return out


# ------------------------------------------------------------ phase 3b

@contextlib.contextmanager
def plain_attention():
    """Route the model's full-sequence attention through the plain version
    (for the kernel-vs-plain check of the logits, outside counted runs)."""
    from repro_torch.kernels import ops, ref
    kernel_path = ops.flash_attention
    ops.flash_attention = (lambda q, k, v, causal=True, window=None, cap=None:
                           ref.flash_attention_ref(q, k, v, causal, window, cap))
    try:
        yield
    finally:
        ops.flash_attention = kernel_path


def run_serving(kernels):
    """Serve SERVE_PROMPTS through the Engine at full width; returns the
    launches, figures and the model (for the logits check)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine

    cfg = get_arch(SERVE_ARCH)
    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", dtype=torch.float32,
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    eng = Engine(model, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, eos_id=-1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in SERVE_PROMPTS]

    # Engine.generate's loop, with each prefill and each step timed (both
    # end in a host read of the sampled tokens, so the clock is synchronised)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    queue, rid_of, results = list(range(len(prompts))), {}, {}
    prefill_s, ttft_s, decode_s, decode_tokens = {}, {}, 0.0, 0
    start = time.perf_counter()
    while queue or eng.active.any():
        while queue:
            t0 = time.perf_counter()
            rid = eng.submit(prompts[queue[0]], SERVE_MAX_NEW)
            if rid is None:
                break
            t1 = time.perf_counter()
            i = queue.pop(0)
            rid_of[rid], prefill_s[i], ttft_s[i] = i, t1 - t0, t1 - start
        n_active = int(eng.active.sum())
        t0 = time.perf_counter()
        done = eng.step()
        decode_s += time.perf_counter() - t0
        decode_tokens += n_active
        for req in done:
            results[rid_of[req.rid]] = req.out
    wall_s = time.perf_counter() - start
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    if sorted(results) != list(range(len(prompts))):
        raise AssertionError(f"served {sorted(results)} of {len(prompts)} requests")
    for i, out in results.items():
        if len(out) != SERVE_MAX_NEW or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"request {i}: {len(out)} tokens, expected "
                                 f"{SERVE_MAX_NEW} in [0, {cfg.vocab})")
    return dict(cfg=cfg, model=model, prompts=prompts, results=results,
                launches=launches, init_s=init_s, wall_s=wall_s, peak_bytes=peak,
                prefill_s=prefill_s, ttft_s=ttft_s, decode_s=decode_s,
                decode_tokens=decode_tokens)


def check_serving_logits(served):
    """The last-token prefill logits of the longest and the shortest prompt
    through the kernel and through the plain attention, on the card."""
    import torch
    model, prompts, results = served["model"], served["prompts"], served["results"]
    out = {}
    for i in (SERVE_PROMPTS.index(max(SERVE_PROMPTS)), SERVE_PROMPTS.index(min(SERVE_PROMPTS))):
        toks = torch.as_tensor(prompts[i], dtype=torch.long, device="cuda")[None]
        kern = model.prefill(toks, toks.shape[1])[0][0]
        with plain_attention():
            plain = model.prefill(toks, toks.shape[1])[0][0]
        torch.cuda.synchronize()
        if not torch.isfinite(kern).all():
            raise AssertionError(f"prompt {i}: non-finite logits")
        torch.testing.assert_close(kern, plain, **LOGITS_TOL,
                                   msg=lambda m: f"prompt of {toks.shape[1]} tokens: {m}")
        if int(kern.argmax()) != int(plain.argmax()) or int(kern.argmax()) != results[i][0]:
            raise AssertionError(f"prompt {i}: argmax kernel {int(kern.argmax())}, plain "
                                 f"{int(plain.argmax())}, served {results[i][0]}")
        out[toks.shape[1]] = dict(max_abs_diff=float((kern - plain).abs().max()),
                                  max_abs_logit=float(plain.abs().max()),
                                  argmax=int(kern.argmax()))
    return out


def serving_profile(served, reps: int = 3):
    """Where a serving step's time goes: a pool decode step (all slots
    active) and the longest prefill, each under torch.profiler -- host-clock
    ms per call, the device's busy share, and the top kernels by device
    time (ms per call)."""
    import torch

    from repro_torch.serve.engine import Engine

    model, prompts = served["model"], served["prompts"]
    longest = prompts[SERVE_PROMPTS.index(max(SERVE_PROMPTS))]
    eng = Engine(model, n_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, eos_id=-1)
    for i in range(SERVE_SLOTS):
        eng.submit(prompts[i], max_new=reps + 2)
    toks = torch.as_tensor(longest, dtype=torch.long, device="cuda")[None]
    out = {}
    for name, fn in (("decode_step", eng.step),
                     ("prefill_%d" % len(longest), lambda: model.prefill(toks, SERVE_MAX_LEN))):
        wall_us, ops, busy, prof = profiled(fn, reps)
        top = sorted(((e.device_time_total, e.key) for e in prof.key_averages()
                      if e.device_time_total > 0), reverse=True)[:5]
        out[name] = dict(ms=wall_us / reps / 1e3, device_ops=ops, device_busy_share=busy,
                         top_kernels_ms={k[:70]: us / reps / 1e3 for us, k in top})
    return out


def flash_figures(errs, launches):
    """Kernel, plain version and SDPA at the serving path's longest prefill.

    bf16 runs on the wgmma route, bounded by 989 TFLOP/s.  f32 runs on the
    tf32x3 route: three TF32 products per product, so its least time is
    3 x operations / 495 TFLOP/s, below the CUDA cores' 67 TFLOP/s FMA
    bound; the row states both and divides by the smaller."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention, ref

    cfg = get_arch(SERVE_ARCH)
    cfg_h, cfg_hkv, d, s = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, max(SERVE_PROMPTS)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    row = {"name": "flash_attention", "route": "cuda",
           "source": "src/repro_torch/csrc/flash_attention.cu",
           "replaces": "src/repro/kernels/flash_attention.py:104 "
                       "(flash_attention_pallas, body :32)",
           "launches": launches, "max_abs_err": errs["flash_attention"],
           "shape": f"q [1, {cfg_h}, {s}, {d}], k/v [1, {cfg_hkv}, {s}, {d}], causal"}
    pairs = s * (s + 1) // 2                      # visible (query, key) pairs
    n_ops = 4 * cfg_h * d * pairs
    fma_ms, tf32x3_ms = n_ops / FP32_OPS_PER_S * 1e3, 3 * n_ops / TF32_OPS_PER_S * 1e3
    row.update(bound_ms_fma=fma_ms, bound_ms_tf32x3=tf32x3_ms,
               bound_divides_by="tf32x3" if tf32x3_ms <= fma_ms else "fma")
    for dtype, tag, peak in ((torch.float32, "", 1e3 * n_ops / min(fma_ms, tf32x3_ms)),
                             (torch.bfloat16, "_bf16", BF16_OPS_PER_S)):
        q = torch.randn(1, cfg_h, s, d, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(1, cfg_hkv, s, d, generator=gen, device="cuda").to(dtype)
                for _ in range(2))

        def kern():
            return flash_attention.flash_attention(q, k, v, True, None)

        n_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / peak
        row.update({
            f"variant{tag}": flash_attention.route(dtype, d),
            f"ms{tag}": time_ms(kern, iters=20),
            f"plain_ms{tag}": time_ms(lambda: ref.flash_attention_ref(q, k, v, True, None),
                                      iters=5),
            f"bound_ms{tag}": max(t_bytes, t_ops) * 1e3,
            f"bound_by{tag}": "bytes" if t_bytes >= t_ops else "operations",
            f"library_ms{tag}": time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), iters=20),
            f"device_ms{tag}": device_ms(kern, "flash_attention_kernel", iters=10),
        })
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.fpga import device, netlist
    from repro_torch.kernels import (_build, bbox, domination, flash_attention, fused_eval,
                                     wirelength)

    torch.backends.cuda.matmul.allow_tf32 = False
    start = time.perf_counter()

    # phase 1: build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s for {sorted(logs) or 'nothing (cached)'}")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if any(w in line.lower() for w in ("entry function", "registers", "spill",
                                               "error", "warn", "performance loss")):
                print(f"  {name}: {line.strip()}")
    if sorted(_build.NAMES) != sorted(p.name.split("-")[0] for p in
                                      map(_build.library_path, _build.NAMES) if p.exists()):
        raise AssertionError(f"not every library of {_build.NAMES} was built")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

    # phase 2: every kernel against its plain version on the card
    errs, n_cases = check_kernels(np.random.default_rng(SEED))
    print(f"kernels vs plain on the card: {n_cases} cases passed, "
          f"max abs err (f32) {errs}")

    # phase 3: the main path, unfused then fused
    problem = netlist.make_problem(device.get_device(FPGA_DEVICE))
    print(f"{FPGA_DEVICE}: {problem.n_units} units, G={problem.n_blocks}, "
          f"N={problem.n_nets}; NSGA-II pop {POP}, {GENS} generations")
    kernels = {"fused_eval": fused_eval.KERNEL, "wirelength2": wirelength.KERNEL,
               "maxbbox": bbox.KERNEL, "domination": domination.KERNEL,
               "domination+counts": domination.KERNEL_COUNTS,
               "flash_attention": flash_attention.KERNEL}
    expect = {False: ("wirelength2", "maxbbox", "domination"),
              True: ("fused_eval", "domination+counts")}
    by_path = {}        # path -> {kernel label: launches in that path's counted run}
    runs = {}
    for fused in (False, True):
        r = run_main_path(problem, fused, kernels)
        counts = r["launches"]
        missing = [n for n in expect[fused] if counts[n] == 0]
        if missing:
            raise AssertionError(f"fused={fused}: kernels never launched: {missing}")
        by_path[f"nsga2_{'fused' if fused else 'unfused'}"] = counts
        runs[fused] = r
        print(f"main path fused={fused}: {r['seconds']:.3f} s, "
              f"{r['gens_per_s']:.2f} gens/s, {r['evals_per_s']:.1f} evals/s; "
              f"best combined {r['init_best']:.4e} -> {r['final_best']:.4e}; "
              f"launches {counts}")

    # the quickstart entry point: its evaluation and its final Pareto sort
    # both run on the card (unfused: 1 + 5 evaluations, 2 x 5 + 1 sorts)
    qs, text = run_quickstart(kernels)
    by_path["quickstart"] = expect_launches(
        "quickstart", qs, {"wirelength2": 6, "maxbbox": 6, "domination": 11})
    print(f"quickstart on the card: {text.strip().splitlines()[-1]}; launches "
          f"{by_path['quickstart']}")

    # Table I: the baselines on the main path's device, each champion
    # pipelined to 650 MHz; NSGA-II's row is the unfused main path's
    print(f"[{time.perf_counter() - start:.1f} s] Table I on {FPGA_DEVICE} "
          f"(table1.py's quick budgets): GA pop {GA_POP} x {GA_GENS} gens, CMA-ES "
          f"lambda {CMAES_POP} x {CMAES_GENS} gens, SA hyperbolic {SA_STEPS} steps, unfused; "
          f"each SA schedule {SA_SCHEDULE_STEPS} steps fused")
    table1, schedules, paths = run_table1(problem, kernels)
    by_path.update(paths)
    r = runs[False]
    table1 = {"nsga2": dict(summarize(problem, r["champion"], r["champion_objs"]),
                            runtime_s=r["seconds"], evaluations=GENS * POP,
                            step_ms=r["seconds"] / GENS * 1e3, first=r["init_best"],
                            best=r["final_best"]), **table1}
    print("  method: runtime_s, evaluations, wirelength, max_bbox, regs@650, MHz(d0), "
          "MHz(piped); ms per step; best combined first -> last")
    for name, v in table1.items():
        print(f"  {name}: {v['runtime_s']:.3f}, {v['evaluations']}, {v['wirelength']:.1f}, "
              f"{v['max_bbox']:.1f}, {v['pipeline_regs_650']}, "
              f"{v['freq_mhz_unpipelined']:.1f}, {v['freq_mhz_pipelined']:.1f}; "
              f"{v['step_ms']:.3f} ms; {v['first']:.4e} -> {v['best']:.4e}; "
              f"launches {by_path.get(name, by_path['nsga2_unfused'])}")
    for name, v in schedules.items():
        print(f"  sa {name} (fused, {SA_SCHEDULE_STEPS} steps): {v['step_ms']:.3f} ms per step; "
              f"best combined {v['first']:.4e} -> {v['best']:.4e}; "
              f"launches {by_path[f'sa_{name}_fused']}")

    # Table II: transfer from TRANSFER_SRC to TRANSFER_DST
    print(f"[{time.perf_counter() - start:.1f} s] Table II: NSGA-II pop {TRANSFER_POP} x "
          f"{TRANSFER_GENS} gens on {TRANSFER_SRC}, champion migrated to {TRANSFER_DST}, "
          f"scratch vs warm start there")
    table2, paths = run_table2(kernels)
    by_path.update(paths)
    print(f"  {TRANSFER_DST}: evaluations to target (1.05 x scratch final, "
          f"{table2['target']:.4e}) scratch {table2['evals_scratch']}, transfer "
          f"{table2['evals_transfer']}, speedup {table2['speedup']:.2f}; MHz at depth 1 "
          f"scratch {table2['mhz_scratch']:.1f}, transfer {table2['mhz_transfer']:.1f}; "
          f"first-generation best scratch {table2['first_scratch']:.4e}, warm "
          f"{table2['first_warm']:.4e}; seconds {table2['seconds']}")
    for name in ("transfer_seed", "transfer_scratch", "transfer_warm"):
        print(f"  launches {name}: {by_path[name]}")
    print(f"[{time.perf_counter() - start:.1f} s] serving")

    # the serving path at full width: every prefill attention layer runs
    # the flash kernel (n_layers per request) and nothing else launches
    served = run_serving(kernels)
    cfg = served["cfg"]
    by_path["serving"] = expect_launches(
        "serving", served["launches"], {"flash_attention": cfg.n_layers * len(SERVE_PROMPTS)})
    n_prompt = sum(SERVE_PROMPTS)
    print(f"serving {SERVE_ARCH} (full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"{cfg.param_count()} params fp32, built in {served['init_s']:.3f} s): "
          f"{len(SERVE_PROMPTS)} requests over {SERVE_SLOTS} slots, max_len {SERVE_MAX_LEN}, "
          f"max_new {SERVE_MAX_NEW}; wall {served['wall_s']:.3f} s")
    print(f"  prefill: {n_prompt} tokens in {sum(served['prefill_s'].values()):.4f} s, "
          f"{n_prompt / sum(served['prefill_s'].values()):.1f} tokens/s")
    for i, n in enumerate(SERVE_PROMPTS):
        print(f"  request {i} ({n} prompt tokens): prefill "
              f"{served['prefill_s'][i] * 1e3:.2f} ms, time to first token from the "
              f"start {served['ttft_s'][i] * 1e3:.2f} ms")
    print(f"  decode: {served['decode_tokens']} tokens in {served['decode_s']:.4f} s over "
          f"the pool, {served['decode_tokens'] / served['decode_s']:.1f} tokens/s")
    print(f"  flash_attention launches {served['launches']['flash_attention']} "
          f"(= {cfg.n_layers} x {len(SERVE_PROMPTS)}); "
          f"torch.cuda.max_memory_allocated {served['peak_bytes']} bytes")
    logit_check = check_serving_logits(served)
    print(f"  last-token prefill logits, kernel vs plain attention (tol {LOGITS_TOL}): "
          f"{logit_check}")
    for name, v in serving_profile(served).items():
        print(f"  profile {name}: {v['ms']:.3f} ms per call, {v['device_ops']:.0f} device ops, "
              f"device busy {v['device_busy_share']}; top kernels (ms per call) "
              f"{v['top_kernels_ms']}")
    del served
    torch.cuda.empty_cache()

    # phase 4: times, bounds, rank peeling
    print(f"[{time.perf_counter() - start:.1f} s] kernel figures")
    row_label = {"domination_counts": "domination+counts"}
    launches = {n: sum(c[row_label.get(n, n)] for c in by_path.values())
                for n in ("fused_eval", "wirelength2", "maxbbox", "domination",
                          "domination_counts", "flash_attention")}
    rows = kernel_figures(problem, runs[True]["coords"], runs[True]["objs"], errs, launches)
    rows.append(flash_figures(errs, launches["flash_attention"]))
    shapes = slice_figures()
    for row in rows:
        name = row["name"]
        row["launches_by_path"] = {p: c[row_label.get(name, name)] for p, c in by_path.items()}
        if name in shapes:
            row["shapes"] = shapes[name]
    for name, per_shape in shapes.items():
        for key, v in per_shape.items():
            print(f"{name} at {key}: {v['ms']:.4f} ms per call, device {v['device_ms']} ms in "
                  f"{v['device_ops']} ops, bound {v['bound_ms']:.6f} ms ({v['bound_by']}), "
                  f"plain {v['plain_ms']:.4f} ms")
    print("domination vs plain over SWEEP_ROWS (per-call ms, device ms): "
          + "; ".join(f"P={p}: {v['ms']:.4f} vs {v['plain_ms']:.4f}, device {v['device_ms']} "
                      f"in {v['device_ops']} ops"
                      for p, v in next(r for r in rows if r["name"] == "domination_counts")
                      ["sweep"].items()))
    for fused, v in generation_profile(problem).items():
        print(f"generation ({fused}): step {v['step_ms']:.3f} ms, two rank peels "
              f"{v['peel_ms']:.3f} ms ({100 * v['peel_share']:.1f}% of the step); "
              f"{v['device_ops_per_step']:.0f} device ops per step, device busy "
              f"{v['device_busy_share']}")
    for name, v in baseline_profile(problem).items():
        print(f"{name} step under the profiler: {v['step_ms']:.3f} ms, "
              f"{v['device_ops_per_step']:.0f} device ops per step, device busy "
              f"{v['device_busy_share']}")
    print(f"[{time.perf_counter() - start:.1f} s] done")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
