#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds the five CUDA kernels from `src/repro_torch/csrc/` for sm_90a.
2. Holds each kernel against its plain PyTorch version on the card over
   the sweep shapes and the main paths' shapes (SA's 1 row, CMA-ES's 24,
   the xcvu9p width), in f32 and bf16 (flash
   attention over the reference's test grid, the serving path's prefill
   shapes, gemma3's D = 256 under a window and the tile edges of its
   tensor-core routes; domination bitwise, at the edges of its tiles too,
   and with its batch axis, B in {1, 4, 8} x P in {16, 64, 128}, directly
   and under `torch.func.vmap`; the evaluation kernels under vmap).
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
   Then the portfolio, racing and islands at xcvu11p full width: K = 4
   NSGA-II configs (sbx_eta, real_mut_prob; pop 64, 20 generations)
   through `portfolio.run_portfolio`, unfused and fused, and K = 8 SA
   chains (200 steps), each at K = 1 too, with exact launches (one per
   kernel and generation whatever K, plus one evaluation per member at
   init), each member held against its own `evolve.run` on the card
   (integers exactly, floats within tol), and ms and device ops per
   generation batched against independent; `portfolio.race` (K = 4,
   rounds of 5, patience 2); islands (P = 4, migrate every 5, 20
   generations) with their launches, P = 1 against `evolve.run` bit for
   bit, and BENCH_placement.json["islands"]'s gens to target on xcvu_test.
   Then the placement service's slot pool (`serve.placement_service`) at
   xcvu11p full width: 12 jobs of `make_job_specs` (pop 64, 20
   generations) through 8 slots at 4 generations per step, unfused and
   fused, every champion legal and its objectives `O.evaluate`'s; the
   job with seed 42 alone against the same job in a loaded pool with a
   co-tenant cancelled; exact launches per step at 1 and 8 active slots
   (gens_per_step x the per-generation counts) and, unfused, device ops
   per step;
   `grow()` 4 -> 8 against a pool that never grows; an islands pool (4
   slots x P 4) and P = 1 against the plain pool bit for bit;
   BENCH_placement.json["transfer"] (xcvu_test -> xcvu_test2, cold against
   warm gens to target); and the `--placement` launcher.
   Then the control plane (`serve.scheduler`, `serve.champion_store`,
   `serve.prewarm`, `serve.frontend`) at xcvu11p full width, 4-slot pools
   at 4 generations per step: 12 NSGA-II and 4 GA jobs routed to two
   pools, every champion legal, one job of each against a standalone pool;
   the same jobs under the deadline policy (the urgent job finishes in
   fewer scheduler steps, every result unchanged); autoscaling 4 -> 8 ->
   16 slots on a queue of 16 jobs with exact launches per step; Table II's
   xcvu3p champion in a champion store seeding xcvu9p jobs (gens to the
   migrated metric, warm against cold), a second wave answered from the
   cache, save/load; a store-predicted pool prewarmed off-thread and
   adopted, the first step after a grow with and without `prewarm_grow`,
   and a second process that finds every kernel library built; 16 asyncio
   clients through the front-end, one cancelled, against a sequential
   scheduler; and the launcher with every control-plane flag.
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
   SWEEP_ROWS and batched at [4, 128, 2] and [8, 128, 2], flash attention at the serving path's longest prefill
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
# domination's batch axis: B problems of P rows in one launch, at every
# (B, P) the paths give it: portfolio members and islands (B 4, 8), service
# pools of 1, 2, 4 and 8 slots and the islands pool's 4 slots x P 4 (B 16),
# the control plane's ladder (4, 8, 16) and its prewarmed grow (B 12), at
# pop 16 (the transfer and the launchers), 32 and 64 (P = pop and 2 pop)
DOM_BATCHES, DOM_BATCH_SIZES = (1, 2, 4, 8, 12, 16), (16, 32, 64, 128)
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
# the portfolio, racing and islands at xcvu11p full width: K NSGA-II
# configs (sbx_eta, real_mut_prob), SA chains with K t0s, a race, P islands;
# then BENCH_placement.json["islands"]'s contract on xcvu_test
PF_ETA_MUT = ((10.0, 0.05), (15.0, 0.1), (20.0, 0.2), (30.0, 0.3))
PF_GENS = 20
SA_K_T0, SA_K_STEPS = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 4.0, 6.0), 200
RACE_MAX_GENS, RACE_GENS_PER_ROUND = 40, 5
ISL_P, ISL_MIGRATE, ISL_GENS, ISL_P1_GENS = 4, 5, 20, 10
ISL_BENCH_P, ISL_BENCH_POP, ISL_BENCH_MIGRATE, ISL_BENCH_BUDGET = 4, 16, 2, 48
# the placement service at xcvu11p full width: SVC_JOBS NSGA-II jobs
# (`make_job_specs`, pop 64) through SVC_SLOTS slots, an islands pool; then
# BENCH_placement.json["transfer"]'s contract at its own scale on
# xcvu_test -> xcvu_test2
SVC_SLOTS, SVC_GENS_PER_STEP, SVC_JOBS, SVC_BUDGET = 8, 4, 12, 20
SVC_ISL_SLOTS, SVC_ISL_P, SVC_ISL_MIGRATE, SVC_ISL_BUDGET = 4, 4, 4, 12
SVC_TRANSFER_BASE_POP, SVC_TRANSFER_BASE_GENS = 32, 100
SVC_TRANSFER_POP, SVC_TRANSFER_BUDGET, SVC_TRANSFER_GENS_PER_STEP = 16, 40, 2
SVC_TRANSFER_SEEDS = (0, 1, 2, 3)
# the control plane at xcvu11p full width: schedulers of CP_SLOTS-slot pools
# at CP_GENS_PER_STEP; CP_NSGA_JOBS NSGA-II (pop 64) and CP_GA_JOBS GA jobs;
# autoscaling CP_SLOTS -> CP_MAX_SLOTS on a queue of CP_AUTOSCALE_JOBS; Table
# II's xcvu3p champion in a champion store, xcvu9p jobs at Table II's pop
# and budget; a prewarmed grow to CP_PREWARM_SLOTS; the asyncio front-end
CP_SLOTS, CP_GENS_PER_STEP, CP_BUDGET = 4, 4, 12
CP_NSGA_JOBS, CP_GA_JOBS, CP_GA_POP = 12, 4, 48
CP_AUTOSCALE_JOBS, CP_AUTOSCALE_THRESHOLD, CP_MAX_SLOTS = 16, 4, 16
CP_STORE_SEEDS, CP_PREWARM_SLOTS = (0, 1, 2, 3), 12
CP_FE_CLIENTS, CP_FE_QUEUE, CP_FE_BUDGET, CP_FE_CANCEL = 16, 8, 12, 5
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
        # the batch axis of domination (portfolio members, islands): one
        # launch for B problems, directly and through vmap's rule
        for nb in DOM_BATCHES:
            for p in DOM_BATCH_SIZES:
                objs = torch.tensor(rng.uniform(size=(nb, p, 2)), dtype=torch.float32)
                objs[:, p // 2:] = torch.round(objs[:, p // 2:] * 4) / 4     # ties
                objs = objs.to(device=dev, dtype=dtype)
                want, want_cnt = ref.domination_counts_ref(objs)
                got = domination.domination(objs)
                got2, cnt = domination.domination_counts(objs)
                got3 = torch.func.vmap(domination.domination)(objs)
                got4, cnt4 = torch.func.vmap(domination.domination_counts)(objs)
                torch.cuda.synchronize()
                for d, c in ((got, None), (got2, cnt), (got3, None), (got4, cnt4)):
                    if not torch.equal(d, want) or (c is not None and not torch.equal(c, want_cnt)):
                        raise AssertionError(f"batched domination differs at B={nb}, P={p}, {dtype}")
                n_cases["domination"] += 2
                n_cases["domination_counts"] += 2
        # the evaluation kernels under vmap: the member axis folded into rows
        g, n, u, b = SLICE_SHAPES[0]
        src, dst, uidx = ints(g, n), ints(g, n), ints(g, u, b)
        w = (coords(n).abs() * 0.002).to(dtype)
        cx, cy = coords(4, 16, g).to(dtype), coords(4, 16, g).to(dtype)
        close("fused_eval", torch.func.vmap(fused_eval.fused_eval, in_dims=(0, 0) + (None,) * 4)(
            cx, cy, src, dst, w, uidx), ref.fused_eval_ref(cx, cy, src, dst, w, uidx), dtype)
        xs = [coords(4, 16, n).to(dtype) for _ in range(4)]
        close("wirelength2", torch.func.vmap(wirelength.wirelength2, in_dims=(0,) * 4 + (None,))(
            *xs, w), ref.wirelength2_ref(*xs, w), dtype)
        ux, uy = coords(4, 16, u, b).to(dtype), coords(4, 16, u, b).to(dtype)
        close("maxbbox", torch.func.vmap(bbox.maxbbox)(ux, uy), ref.maxbbox_ref(ux, uy), dtype)
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
               seconds={k: v["seconds"] for k, v in runs.items()},
               seed_champion=(runs["seed"]["g"], runs["seed"]["objs"]))
    return row, paths


# ------------------------------------------------------------ phase 3d

def same_run(what, got, want):
    """A batched member against its independent run on the card: integer
    leaves (permutations, counters) exactly, floats within tol(float32),
    and, for a population, the final Pareto ranks exactly."""
    import torch

    from repro_torch.core import nsga2

    got_l, want_l = (torch.utils._pytree.tree_leaves(t) for t in (got, want))
    for a, b in zip(got_l, want_l, strict=True):
        if a.is_floating_point():
            torch.testing.assert_close(a, b, **tol(torch.float32), msg=lambda m: f"{what}: {m}")
        elif not torch.equal(a, b):
            raise AssertionError(f"{what}: an integer leaf differs")
    if "pop" in got and not torch.equal(nsga2.nondominated_rank(got["objs"]),
                                        nsga2.nondominated_rank(want["objs"])):
        raise AssertionError(f"{what}: final ranks differ")


def batched_gen_profile(problem, algo, cfgs, reps: int = 1):
    """One batched generation of len(cfgs) members under torch.profiler:
    (host ms, device ops, device busy share)."""
    import torch

    from repro_torch.core import hyper
    from repro_torch.core import portfolio as TP

    static_key, traced = hyper.stack_configs(cfgs, "cuda")
    gens = [torch.Generator(device="cuda").manual_seed(SEED + 50 + i) for i in range(len(cfgs))]
    states = TP.member_init(problem, algo, static_key, traced, gens)
    member_cfgs = [hyper.unstack_config(static_key, traced, i) for i in range(len(cfgs))]
    wall_us, ops, busy, _ = profiled(lambda: TP.batched_step(
        problem, algo, static_key, traced, member_cfgs, states, gens), reps)
    return dict(ms=wall_us / reps / 1e3, device_ops=ops, busy=busy)


def run_portfolio_phase(problem, kernels):
    """Portfolios of NSGA-II (one member per PF_ETA_MUT, unfused and fused)
    and of SA chains (one per SA_K_T0): launches per generation at K = 1
    and K, each member against its independent `evolve.run` on the card,
    and ms and device ops per generation, batched against independent."""
    import torch

    from repro_torch.core import annealing, evolve, nsga2
    from repro_torch.core import portfolio as TP

    def gens(seeds):
        return [torch.Generator(device="cuda").manual_seed(s) for s in seeds]

    out, paths = {}, {}
    runs = [("nsga2", f, [nsga2.NSGA2Config(pop_size=POP, fused=f, sbx_eta=e, real_mut_prob=m)
                          for e, m in PF_ETA_MUT], PF_GENS) for f in (False, True)]
    runs.append(("sa", False, [annealing.SAConfig(schedule="hyperbolic", beta=2e-3, t0=t)
                               for t in SA_K_T0], SA_K_STEPS))
    for algo, fused, cfgs, n in runs:
        t0 = time.perf_counter()
        name = f"portfolio_{algo}_{'fused' if fused else 'unfused'}"
        k, n1 = len(cfgs), max(n // 4, 10)      # K = 1 runs a quarter of the generations
        seeds = [SEED + 10 + i for i in range(k)]
        res, dt, launches = counted(kernels, lambda: TP.run_portfolio(
            problem, algo, cfgs, gens=gens(seeds), n_gens=n, device="cuda"))
        res1, dt1, launches1 = counted(kernels, lambda: TP.run_portfolio(
            problem, algo, cfgs[:1], gens=gens(seeds[:1]), n_gens=n1, device="cuda"))
        for kk, nn, got in ((k, n, launches), (1, n1, launches1)):
            want = ({"fused_eval": kk + nn, "domination+counts": 2 * nn} if fused else
                    {"wirelength2": kk + nn, "maxbbox": kk + nn} |
                    ({"domination": 2 * nn} if algo == "nsga2" else {}))
            paths[f"{name}_k{kk}"] = expect_launches(f"{name} K={kk}", got, want)
        # each member (SA: the first and the last) against its own run
        solo_s = 0.0
        for i in (range(k) if algo == "nsga2" else (0, k - 1)):
            (st, hist), dts, solo_launches = counted(kernels, lambda: evolve.run(
                problem, algo, cfgs[i], gens(seeds[i:i + 1])[0], n, device="cuda"))
            paths[f"{name}_solo{i}"] = solo_launches
            solo_s += dts
            same_run(f"{name} member {i}", res.member_state(i), st)
            torch.testing.assert_close(res.history[i], hist, **tol(torch.float32))
        n_solo = k if algo == "nsga2" else 2
        prof1 = batched_gen_profile(problem, algo, cfgs[:1])
        prof = batched_gen_profile(problem, algo, cfgs)
        out[name] = dict(k=k, gens=n, gens_k1=n1, ms_per_gen=dt / n * 1e3,
                         ms_per_gen_k1=dt1 / n1 * 1e3, phase_s=time.perf_counter() - t0,
                         solo_ms_per_gen=solo_s / n_solo / n * 1e3,
                         independent_ms_per_gen_for_k=solo_s / n_solo / n * 1e3 * k,
                         device_ops_per_gen_k1=prof1["device_ops"],
                         device_ops_per_gen=prof["device_ops"],
                         busy_k1=prof1["busy"], busy=prof["busy"],
                         profiled_ms_k1=prof1["ms"], profiled_ms=prof["ms"],
                         best=float(res.metric.min()), members_checked=n_solo)
    return out, paths


def run_race_phase(problem, kernels):
    """`portfolio.race` of the unfused NSGA-II portfolio: the rounds it ran
    and its champion (legal, its objectives the plain versions' on the CPU)."""
    import torch

    from repro_torch.core import nsga2
    from repro_torch.core import portfolio as TP

    cfgs = [nsga2.NSGA2Config(pop_size=POP, sbx_eta=e, real_mut_prob=m) for e, m in PF_ETA_MUT]
    res, dt, launches = counted(kernels, lambda: TP.race(
        problem, "nsga2", cfgs, gen=torch.Generator(device="cuda").manual_seed(SEED + 20),
        max_gens=RACE_MAX_GENS, gens_per_round=RACE_GENS_PER_ROUND, patience=2, device="cuda"))
    n = res.gens
    expect_launches("race", launches, {"wirelength2": len(cfgs) + n, "maxbbox": len(cfgs) + n,
                                       "domination": 2 * n})
    if res.history.shape != (res.rounds, len(cfgs), 2) or not torch.isfinite(res.history).all():
        raise AssertionError("race: history is not finite [rounds, K, 2]")
    g, objs = TP.best_genotype(problem, "nsga2", res.member_state(res.champion))
    check_champion(problem, g, objs)
    return dict(rounds=res.rounds, gens=n, champion=res.champion, seconds=dt,
                metric=[float(m) for m in res.metric],
                round_best=[float(r.min()) for r in (res.history[..., 0] * res.history[..., 1])]
                ), launches


def run_islands_phase(problem, kernels):
    """Islands on the card: P = ISL_P at xcvu11p (launches, ms and device
    ops per generation, the champion), P = 1 against `evolve.run` bit for
    bit, and BENCH_placement.json["islands"]'s gens to target on xcvu_test."""
    import torch

    from repro_torch.core import evolve, nsga2
    from repro_torch.core import islands as TI
    from repro_torch.core import objectives as O
    from repro_torch.fpga import device, netlist

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    paths, out = {}, {}
    cfg = nsga2.NSGA2Config(pop_size=POP)
    icfg = TI.IslandConfig(ISL_P, ISL_MIGRATE)
    (st, hist), dt, launches = counted(kernels, lambda: evolve.run(
        problem, "nsga2", cfg, gen(SEED + 30), ISL_GENS, islands=icfg, device="cuda"))
    paths["islands"] = expect_launches("islands", launches, {
        "wirelength2": ISL_P + ISL_GENS, "maxbbox": ISL_P + ISL_GENS, "domination": 2 * ISL_GENS})
    if hist.shape != (ISL_GENS, ISL_P, 2) or not torch.isfinite(hist).all():
        raise AssertionError("islands: history is not finite [gens, P, 2]")
    g, objs = TI.best_genotype(problem, "nsga2", st)
    check_champion(problem, g, objs)
    prof = batched_gen_profile(problem, "nsga2", [cfg] * ISL_P)
    out["xcvu11p"] = dict(ms_per_gen=dt / ISL_GENS * 1e3, device_ops_per_gen=prof["device_ops"],
                          busy=prof["busy"], first=float(O.combined_metric(hist[0]).min()),
                          best=float(O.combined_metric(objs)))

    # P = 1 is the single-population run, bit for bit
    (s1, h1), _, launches = counted(kernels, lambda: evolve.run(
        problem, "nsga2", cfg, gen(SEED + 31), ISL_P1_GENS, islands=TI.IslandConfig(1, 0),
        device="cuda"))
    paths["islands_p1"] = launches
    (s0, h0), _, launches = counted(kernels, lambda: evolve.run(
        problem, "nsga2", cfg, gen(SEED + 31), ISL_P1_GENS, device="cuda"))
    paths["islands_p1_single"] = launches
    if not torch.equal(h1[:, 0], h0) or not all(
            torch.equal(a[0], b) for a, b in zip(torch.utils._pytree.tree_leaves(s1),
                                                 torch.utils._pytree.tree_leaves(s0),
                                                 strict=True)):
        raise AssertionError("islands(P=1) differs from evolve.run")

    # BENCH_placement.json["islands"] at its own scale: the target is a
    # probe single population's final metric after 2/3 of the budget; the
    # islands' own budget is budget / P generations (the same evaluations),
    # and they run the whole budget so that a later hit shows too
    small = netlist.make_problem(device.get_device("xcvu_test"))
    scfg = nsga2.NSGA2Config(pop_size=ISL_BENCH_POP)

    def gens_to_target(hist, target):
        comb = O.combined_metric(hist).cpu()
        comb = comb.min(dim=-1).values if comb.dim() == 2 else comb
        hit = torch.nonzero(comb <= target).flatten()
        return int(hit[0]) + 1 if len(hit) else None

    (probe, _), _, paths["islands_bench_probe"] = counted(kernels, lambda: evolve.run(
        small, "nsga2", scfg, gen(123), 2 * ISL_BENCH_BUDGET // 3, device="cuda"))
    target = float(O.combined_metric(evolve.state_best_objs(probe)))
    (_, hs), dts, paths["islands_bench_single"] = counted(kernels, lambda: evolve.run(
        small, "nsga2", scfg, gen(SEED), ISL_BENCH_BUDGET, device="cuda"))
    n_isl = ISL_BENCH_BUDGET // ISL_BENCH_P
    (_, hi), dti, paths["islands_bench_islands"] = counted(kernels, lambda: evolve.run(
        small, "nsga2", scfg, gen(SEED), ISL_BENCH_BUDGET,
        islands=TI.IslandConfig(ISL_BENCH_P, ISL_BENCH_MIGRATE), device="cuda"))
    def best_after(hist, n):
        return float(O.combined_metric(hist[:n]).min())

    out["bench_xcvu_test"] = dict(target=target, single_gens_to_target=gens_to_target(hs, target),
                                  islands_gens_to_target=gens_to_target(hi, target),
                                  single_best=best_after(hs, ISL_BENCH_BUDGET),
                                  islands_best_at_budget=best_after(hi, n_isl),
                                  islands_best=best_after(hi, ISL_BENCH_BUDGET),
                                  single_budget=ISL_BENCH_BUDGET, islands_budget=n_isl,
                                  single_s=dts, islands_s=dti)
    return out, paths


# ------------------------------------------------------------ phase 3e

def same_job(what, got, want):
    """Two harvested jobs of one request: gens exactly, the genotype's
    integer leaves exactly and its floats and objectives within
    tol(float32)."""
    import numpy as np
    import torch

    if got.gens != want.gens:
        raise AssertionError(f"{what}: {got.gens} gens against {want.gens}")
    for a, b in zip(torch.utils._pytree.tree_leaves(got.genotype),
                    torch.utils._pytree.tree_leaves(want.genotype), strict=True):
        if np.issubdtype(a.dtype, np.integer):
            if not np.array_equal(a, b):
                raise AssertionError(f"{what}: an integer leaf of the genotype differs")
        else:
            np.testing.assert_allclose(a, b, **tol(torch.float32), err_msg=what)
    np.testing.assert_allclose(got.best_objs, want.best_objs, **tol(torch.float32),
                               err_msg=what)


def check_job(problem, job, fused: bool):
    """A harvested champion: legal, and its reported objectives equal
    `O.evaluate` of the harvested genotype on the card and the plain
    versions on the CPU, within tol."""
    import torch

    from repro_torch.core import convert
    from repro_torch.core import objectives as O

    g = convert.genotype_from_numpy(job.genotype, "cuda")
    objs = torch.as_tensor(job.best_objs)
    torch.testing.assert_close(O.evaluate(problem, g, fused).cpu(), objs, **tol(torch.float32))
    check_champion(problem, g, objs)


def per_step(fused: bool, steps: int, submits: int = 0, islands: int = 1):
    """The launches of `steps` service steps and `submits` admissions:
    SVC_GENS_PER_STEP x the per-generation counts, and one evaluation per
    island at each admission."""
    n, e = steps * SVC_GENS_PER_STEP, submits * islands
    if fused:
        return {"fused_eval": n + e, "domination+counts": 2 * n}
    return {"wirelength2": n + e, "maxbbox": n + e, "domination": 2 * n}


def run_service_phase(problem, kernels):
    """The placement service's slot pool on the card (`serve.placement_service`):
    (a) rolling admission of SVC_JOBS jobs through SVC_SLOTS slots,
    unfused and fused; (b) a job alone against the same job beside
    co-tenants, one of them cancelled; (c) launches per step at 1 and at
    SVC_SLOTS active slots and device ops per step; (d) `grow()`; (e) an
    islands pool, and P = 1 against the plain pool bit for bit; (f)
    BENCH_placement.json["transfer"] through the service; (g) the
    `--placement` launcher."""
    import io

    import torch

    from repro_torch.core import nsga2, transfer
    from repro_torch.core import objectives as O
    from repro_torch.core.islands import IslandConfig
    from repro_torch.fpga import device, netlist
    from repro_torch.launch import serve
    from repro_torch.serve.api import JobRequest
    from repro_torch.serve.placement_service import PlacementService, make_job_specs

    out, paths = {}, {}

    def service(fused=False, n_slots=SVC_SLOTS, problem=problem, pop=POP, **kw):
        kw.setdefault("gens_per_step", SVC_GENS_PER_STEP)
        return PlacementService(problem, nsga2.NSGA2Config(pop_size=pop, fused=fused),
                                n_slots=n_slots, device="cuda", **kw)

    # (a) rolling admission
    part_s, t_part = {}, time.perf_counter()
    for fused in (False, True):
        name = f"service_{'fused' if fused else 'unfused'}"
        svc = service(fused)
        specs = make_job_specs(SVC_JOBS, POP, SVC_BUDGET, fused=fused)
        done, dt, launches = counted(kernels, lambda: svc.run_jobs(specs))
        s = svc.stats()
        paths[name] = expect_launches(name, launches,
                                      per_step(fused, s["steps"], submits=SVC_JOBS))
        if len(done) != SVC_JOBS or s["step_compiles"] != 1:
            raise AssertionError(f"{name}: {len(done)} jobs, "
                                 f"{s['step_compiles']} slot counts stepped")
        for j in done:
            if j.gens != SVC_BUDGET:
                raise AssertionError(f"{name}: job {j.jid} ran {j.gens} gens")
            check_job(problem, j, fused)
        out[name] = dict(seconds=dt, jobs_per_s=len(done) / dt, gens_per_s=s["useful_gens"] / dt,
                         ms_per_step=dt / s["steps"] * 1e3, steps=s["steps"],
                         step_compiles=s["step_compiles"],
                         best=min(j.metric for j in done),
                         blocking_compile_secs=s["blocking_compile_secs"])
    part_s["rolling"] = time.perf_counter() - t_part

    # (b) co-tenancy and cancel: the job alone against the loaded pool
    t_part = time.perf_counter()
    spec = JobRequest(seed=42, budget=SVC_BUDGET, cfg=nsga2.NSGA2Config(
        pop_size=POP, sbx_eta=12.5, real_mut_prob=0.15))
    (alone,), _, paths["service_alone"] = counted(
        kernels, lambda: service(n_slots=1).run_jobs([spec]))
    svc = service()
    others = [JobRequest(**s) for s in make_job_specs(SVC_SLOTS - 1, POP, SVC_BUDGET, seed=1)]
    for r in others[:3] + [spec] + others[3:]:
        svc.submit_request(r)
    svc.step()
    if not svc.cancel(0):
        raise AssertionError("service: cancel of an in-flight job failed")
    done = svc.run_jobs([])
    loaded = next(j for j in done if j.seed == 42)
    same_job("service co-tenancy", loaded, alone)
    check_job(problem, loaded, False)
    part_s["cotenancy"] = time.perf_counter() - t_part

    # (c) launches per step at 1 and SVC_SLOTS active slots, and device ops
    t_part = time.perf_counter()
    for fused in (False, True):
        name = f"service_{'fused' if fused else 'unfused'}_occupancy"
        svc = service(fused)
        reqs = [JobRequest(**s) for s in make_job_specs(SVC_SLOTS, POP, 64, seed=2, fused=fused)]
        for n_active, batch in ((1, reqs[:1]), (SVC_SLOTS, reqs[1:])):
            _, _, sub = counted(kernels, lambda: [svc.submit_request(r) for r in batch])
            expect_launches(f"{name} submit", sub, per_step(fused, 0, submits=len(batch)))
            (_, syncs), dts, launches = counted(kernels, lambda: host_syncs(svc.step))
            paths[f"{name}_{n_active}"] = expect_launches(f"{name} {n_active} active", launches,
                                                          per_step(fused, 1))
            out[f"{name}_{n_active}"] = dict(step_ms=dts * 1e3, host_syncs=syncs)
            if not fused:
                ms, ops, busy = device_trace(svc.step)
                out[f"{name}_{n_active}"].update(device_ops_per_step=ops, busy=busy,
                                                 profiled_step_ms=ms)
        if len(svc.inflight()) != SVC_SLOTS:
            raise AssertionError(f"{name}: a job left the pool before its budget")
    part_s["occupancy"] = time.perf_counter() - t_part

    # (d) grow() mid-run against a pool that never grows
    t_part = time.perf_counter()
    reqs = [JobRequest(**s) for s in make_job_specs(4, POP, 2 * SVC_GENS_PER_STEP, seed=3)]
    never = {j.seed: j for j in service(n_slots=4).run_jobs(reqs)}
    svc = service(n_slots=4)
    for r in reqs:
        svc.submit_request(r)
    svc.step()
    svc.grow(SVC_SLOTS)
    extra = make_job_specs(SVC_SLOTS - 4, POP, 2 * SVC_GENS_PER_STEP, seed=4)
    done = svc.run_jobs(extra)
    grown = {j.seed: j for j in done}
    for seed, j in never.items():
        same_job(f"service grow, seed {seed}", grown[seed], j)
    if svc.stats()["sizes"] != [4, SVC_SLOTS] or svc.step_compiles != 2:
        raise AssertionError(f"service grow: {svc.stats()['sizes']}, "
                             f"{svc.step_compiles} slot counts stepped")
    out["grow"] = dict(jobs=len(done), sizes=svc.stats()["sizes"], step_compiles=svc.step_compiles)
    part_s["grow"] = time.perf_counter() - t_part

    # (e) islands: SVC_ISL_SLOTS slots x P islands, then P = 1 against the plain pool
    t_part = time.perf_counter()
    icfg = IslandConfig(SVC_ISL_P, SVC_ISL_MIGRATE)
    svc = service(n_slots=SVC_ISL_SLOTS, islands=icfg)
    reqs = [JobRequest(islands=icfg, **s)
            for s in make_job_specs(SVC_ISL_SLOTS, POP, SVC_ISL_BUDGET, seed=5)]
    _, _, sub = counted(kernels, lambda: [svc.submit_request(r) for r in reqs])
    expect_launches("service islands submit", sub,
                    per_step(False, 0, submits=len(reqs), islands=SVC_ISL_P))
    syncs, done = [], []

    def islands_run():
        while svc.active.any():
            finished, n = host_syncs(svc.step)
            syncs.append(n)
            done.extend(finished)

    _, dt, launches = counted(kernels, islands_run)
    steps = SVC_ISL_BUDGET // SVC_GENS_PER_STEP
    paths["service_islands"] = expect_launches("service islands", launches, per_step(False, steps))
    if len(done) != SVC_ISL_SLOTS or len(syncs) != steps:
        raise AssertionError(f"service islands: {len(done)} jobs in {len(syncs)} steps")
    for j in done:
        check_job(problem, j, False)
    # host syncs of the steps that harvested nothing (a harvest reads back);
    # then the same jobs again, to trace two of their steps
    for r in reqs:
        svc.submit_request(r.replace(budget=4 * SVC_GENS_PER_STEP))
    ms, ops, busy = device_trace(svc.step)
    out["islands"] = dict(ms_per_step=dt / steps * 1e3, jobs=len(done), seconds=dt,
                          best=min(j.metric for j in done), step_compiles=svc.step_compiles,
                          host_syncs=syncs[:-1], profiled_step_ms=ms, device_ops_per_step=ops,
                          busy=busy)
    reqs = [JobRequest(**s) for s in make_job_specs(2, POP, 2 * SVC_GENS_PER_STEP, seed=6)]
    plain = {j.seed: j for j in service(n_slots=2).run_jobs(reqs)}
    one = IslandConfig(1, SVC_ISL_MIGRATE)
    p1 = {j.seed: j for j in service(n_slots=2, islands=one).run_jobs(
        [r.replace(islands=one) for r in reqs])}
    for seed, j in plain.items():
        leaves = zip(torch.utils._pytree.tree_leaves(p1[seed].genotype),
                     torch.utils._pytree.tree_leaves(j.genotype), strict=True)
        if not all((a == b).all() for a, b in leaves) or not (p1[seed].best_objs
                                                              == j.best_objs).all():
            raise AssertionError(f"service islands(P=1) differs from the plain pool, seed {seed}")
    part_s["islands"] = time.perf_counter() - t_part

    # (f) BENCH_placement.json["transfer"] at its own scale, through the service
    t_part = time.perf_counter()
    base = netlist.make_problem(device.get_device("xcvu_test"))
    sib = netlist.make_problem(device.get_device("xcvu_test2"))
    t0 = time.perf_counter()
    champ = transfer.converge_champion(base, torch.Generator(device="cuda").manual_seed(0),
                                       SVC_TRANSFER_BASE_POP, SVC_TRANSFER_BASE_GENS)
    g_mig = transfer.migrate(base, sib, champ)
    target = float(O.combined_metric(O.evaluate(sib, g_mig)))
    converge_s = time.perf_counter() - t0
    svc = service(n_slots=2 * len(SVC_TRANSFER_SEEDS), problem=sib, pop=SVC_TRANSFER_POP,
                  gens_per_step=SVC_TRANSFER_GENS_PER_STEP)
    reqs = [JobRequest(seed=s, budget=SVC_TRANSFER_BUDGET, target=target, init_state=init)
            for init in (None, g_mig) for s in SVC_TRANSFER_SEEDS]
    done, dt, paths["service_transfer"] = counted(kernels, lambda: svc.run_jobs(reqs))
    cold = {j.seed: j.gens if j.metric <= target else None for j in done if not j.warm}
    warm = {j.seed: j.gens if j.metric <= target else None for j in done if j.warm}
    if any(warm[s] is None for s in SVC_TRANSFER_SEEDS):
        raise AssertionError(f"service transfer: a warm job missed its own seed's metric {warm}")
    out["transfer"] = dict(target=target, cold=cold, warm=warm, converge_s=converge_s,
                           seconds=dt)
    part_s["transfer"] = time.perf_counter() - t_part

    # (g) the launcher
    t_part = time.perf_counter()
    text = io.StringIO()

    def launch():
        with contextlib.redirect_stdout(text):
            serve.main(["--placement", "--device", "xcvu_test", "--requests", "4",
                        "--slots", "2", "--pop", "16", "--gens", "8"])

    _, dt, paths["service_launcher"] = counted(kernels, launch)
    lines = text.getvalue().strip().splitlines()
    if (len(lines) != 5 or [ln.split(":")[0] for ln in lines[:4]] != [f"job{i}" for i in range(4)]
            or not lines[-1].endswith("step compiles: 1")):
        raise AssertionError(f"launcher output:\n{text.getvalue()}")
    out["launcher"] = dict(seconds=dt, last_line=lines[-1])
    part_s["launcher"] = time.perf_counter() - t_part
    out["part_s"] = part_s
    return out, paths


# ------------------------------------------------------------ phase 3f

def cp_launches(nsga_steps: int, evals: int, ga_steps: int = 0):
    """The launches of scheduler steps on unfused pools: CP_GENS_PER_STEP x
    the per-generation counts (NSGA-II: one evaluation, two domination
    sorts; GA: one evaluation), plus `evals` single-genotype-population
    evaluations (one per slot a fill or a grow initialises, one per job
    admitted)."""
    n = CP_GENS_PER_STEP
    e = n * (nsga_steps + ga_steps) + evals
    return {"wirelength2": e, "maxbbox": e, "domination": 2 * n * nsga_steps}


def drive(sch):
    """Step a scheduler dry on this thread; returns ({jid: fleet job},
    {jid: scheduler steps until it finished}, {pool label: [ms per step]})."""
    import torch

    done, finished_at, ms = {}, {}, {}
    n = 0
    while sch.busy:
        before = {sch._label(k): p.total_steps for k, p in sch._pools.items()}
        t0 = time.perf_counter()
        finished = sch.step()
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) * 1e3
        n += 1
        for k, p in sch._pools.items():
            if p.total_steps != before.get(sch._label(k), 0):
                ms.setdefault(sch._label(k), []).append(dt)
        for j in finished:
            done[j.jid], finished_at[j.jid] = j, n
    return done, finished_at, ms


def trimmed(stats):
    """A stats payload without its histograms and convergence tails."""
    if isinstance(stats, dict):
        return {k: trimmed(v) for k, v in stats.items()
                if not k.endswith("_hist") and k != "convergence"}
    return stats


CACHE_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, "src")
from repro_torch.runtime import compile_cache
compile_cache.enable(sys.argv[1])
from repro_torch.kernels import bbox, domination, flash_attention, fused_eval, ops, wirelength
dev = "cuda"
x, w = torch.rand(2, 8, device=dev), torch.ones(8, device=dev)
ops.wirelength2(x, x, x, x, w)
ops.maxbbox(torch.rand(2, 3, 4, device=dev), torch.rand(2, 3, 4, device=dev))
objs = torch.rand(16, 2, device=dev)
ops.domination_matrix(objs)
ops.fused_domination_counts(objs)
bx, idx = torch.rand(2, 12, device=dev), torch.arange(8, dtype=torch.int32, device=dev)
uidx = torch.arange(12, dtype=torch.int32, device=dev).reshape(3, 4)
ops.fused_eval(bx, bx, idx, idx + 1, w, uidx)
q = torch.rand(1, 2, 64, 64, device=dev)
ops.flash_attention(q, q, q)
torch.cuda.synchronize()
print(json.dumps({"meter": compile_cache.meter().stats(), "launches": {
    k.name + ("+counts" if k is domination.KERNEL_COUNTS else ""): k.launches
    for k in (bbox.KERNEL, domination.KERNEL, domination.KERNEL_COUNTS, flash_attention.KERNEL,
              fused_eval.KERNEL, wirelength.KERNEL)}}))
"""


def run_control_plane_phase(problem, kernels, table2_champion, first_build):
    """The placement control plane on the card (`serve.scheduler`,
    `serve.champion_store`, `serve.prewarm`, `serve.frontend`), at xcvu11p
    full width unless a part says otherwise: (a) routing of NSGA-II and GA
    jobs to two pools, stepped round-robin, against standalone pools; (b)
    the deadline policy; (c) autoscaling on queue depth; (d) Table II
    through the scheduler and a champion store, and cache hits; (e) a
    prewarmed pool, a prewarmed grow and the kernel build cache in a
    second process; (f) the asyncio front-end; (g) the launcher."""
    import asyncio
    import io
    import tempfile

    import numpy as np
    import torch

    from repro_torch.core import ga, nsga2, transfer
    from repro_torch.core import objectives as O
    from repro_torch.fpga import device, netlist
    from repro_torch.kernels import _build
    from repro_torch.launch import serve
    from repro_torch.runtime import compile_cache
    from repro_torch.serve.api import JobRequest, JobStatus
    from repro_torch.serve.champion_store import ChampionStore
    from repro_torch.serve.frontend import PlacementFrontend
    from repro_torch.serve.placement_service import PlacementService, make_job_specs
    from repro_torch.serve.prewarm import Prewarmer
    from repro_torch.serve.scheduler import PlacementScheduler

    out, paths, part_s = {}, {}, {}
    tmpdir = tempfile.TemporaryDirectory()

    def scheduler(**kw):
        kw.setdefault("n_slots", CP_SLOTS)
        return PlacementScheduler(gens_per_step=CP_GENS_PER_STEP, device="cuda", **kw)

    def standalone(r, problem=problem, n_slots=CP_SLOTS):
        svc = PlacementService(problem, r.cfg, algo=r.algo or "nsga2", n_slots=n_slots,
                               gens_per_step=CP_GENS_PER_STEP, device="cuda")
        (job,) = svc.run_jobs([r.replace(device=None, deadline=None, priority=0.0)])
        return job

    nsga_reqs = [JobRequest(device=FPGA_DEVICE, **s)
                 for s in make_job_specs(CP_NSGA_JOBS, POP, CP_BUDGET, seed=7)]
    ga_reqs = [JobRequest(device=FPGA_DEVICE, algo="ga", seed=700 + i, budget=CP_BUDGET,
                          cfg=ga.GAConfig(pop_size=CP_GA_POP, real_mut_prob=0.1 + 0.05 * i))
               for i in range(CP_GA_JOBS)]
    reqs = nsga_reqs + ga_reqs

    # (a) routing: two pools stepped round-robin
    t_part = time.perf_counter()
    sch = scheduler()

    def route():
        jids = [sch.submit_request(r) for r in reqs]
        return jids, drive(sch)

    (jids, (done, finished_at, ms)), dt, launches = counted(kernels, route)
    stats = sch.stats()
    pools = {label: p["steps"] for label, p in stats["pools"].items()}
    if len(done) != len(reqs) or stats["n_pools"] != 2:
        raise AssertionError(f"control plane: {len(done)} jobs in {stats['n_pools']} pools")
    nsga_steps, ga_steps = (next(n for label, n in pools.items() if f"/{algo}/" in label)
                            for algo in ("nsga2", "ga"))
    paths["control_plane_routing"] = expect_launches(
        "control plane routing", launches,
        cp_launches(nsga_steps, 2 * CP_SLOTS + len(reqs), ga_steps))
    for jid in jids:
        if done[jid].result.gens != CP_BUDGET:
            raise AssertionError(f"control plane: job {jid} ran {done[jid].result.gens} gens")
        check_job(problem, done[jid].result, False)
    for i in (0, CP_NSGA_JOBS):                  # one NSGA-II job and one GA job
        same_job(f"control plane job {i} against a standalone pool",
                 done[jids[i]].result, standalone(reqs[i]))
    rr = {jid: done[jid] for jid in jids}
    out["routing"] = dict(jobs=len(done), seconds=dt, jobs_per_s=len(done) / dt,
                          steps=sum(len(v) for v in ms.values()),
                          ms_per_step={k: float(np.mean(v)) for k, v in ms.items()},
                          steps_per_pool=pools, stats=trimmed(stats))
    part_s["routing"] = time.perf_counter() - t_part

    # (b) the deadline policy: one tight deadline on the last NSGA-II job
    t_part = time.perf_counter()
    urgent = CP_NSGA_JOBS - 1
    sch = scheduler(policy="deadline")
    jids_b = [sch.submit_request(r.replace(deadline=1.0) if i == urgent else r)
              for i, r in enumerate(reqs)]
    done_b, finished_b, _ = drive(sch)
    steps_rr, steps_edf = finished_at[jids[urgent]], finished_b[jids_b[urgent]]
    if not steps_edf < steps_rr:
        raise AssertionError(f"deadline policy: the urgent job took {steps_edf} scheduler "
                             f"steps, round-robin {steps_rr}")
    for a, b in zip(jids, jids_b):
        same_job(f"deadline policy, job {a}", done_b[b].result, rr[a].result)
    out["policy"] = dict(urgent_steps_deadline=steps_edf, urgent_steps_round_robin=steps_rr,
                         total_steps_deadline=max(finished_b.values()),
                         total_steps_round_robin=max(finished_at.values()))
    part_s["policy"] = time.perf_counter() - t_part

    # (c) autoscaling on queue depth: CP_SLOTS -> 2 CP_SLOTS -> CP_MAX_SLOTS
    t_part = time.perf_counter()
    sch = scheduler(autoscale=True, autoscale_threshold=CP_AUTOSCALE_THRESHOLD,
                    max_slots=CP_MAX_SLOTS)
    a_reqs = [JobRequest(device=FPGA_DEVICE, **s)
              for s in make_job_specs(CP_AUTOSCALE_JOBS, POP, CP_BUDGET, seed=8)]
    (a_jids, _, sub) = counted(kernels, lambda: [sch.submit_request(r) for r in a_reqs])
    expect_launches("autoscale submit", sub, cp_launches(0, 2 * CP_SLOTS))
    (pool,) = sch._pools.values()
    done_c, per_step_launches = {}, []
    while sch.busy:
        n_slots, admitted = pool.n_slots, len(sch._inflight)
        finished, _, launches = counted(kernels, sch.step)
        grown = pool.n_slots - n_slots
        admitted = len(sch._inflight) + len(finished) - admitted
        expect_launches(f"autoscale step at {pool.n_slots} slots", launches,
                        cp_launches(1, grown + admitted))
        per_step_launches.append((pool.n_slots, launches))
        done_c.update((j.jid, j) for j in finished)
    events = [(old, new) for _, old, new in sch.autoscale_events]
    if events != [(CP_SLOTS, 2 * CP_SLOTS), (2 * CP_SLOTS, CP_MAX_SLOTS)]:
        raise AssertionError(f"autoscale events {sch.autoscale_events}")
    for i in (0, CP_AUTOSCALE_JOBS - 1):         # admitted at 4 slots, and at 16
        same_job(f"autoscaled job {i}", done_c[a_jids[i]].result, standalone(a_reqs[i]))
    paths["control_plane_autoscale"] = {
        n: sum(c[n] for _, c in per_step_launches) + sub[n] for n in sub}
    out["autoscale"] = dict(events=sch.autoscale_events, sizes=pool.stats()["sizes"],
                            steps=len(per_step_launches),
                            launches_per_step=[(n, {k: v for k, v in c.items() if v})
                                               for n, c in per_step_launches])
    part_s["autoscale"] = time.perf_counter() - t_part

    # (d) Table II through the scheduler: the xcvu3p champion in a store
    t_part = time.perf_counter()
    src, dst = (netlist.make_problem(device.get_device(n)) for n in (TRANSFER_SRC, TRANSFER_DST))
    g_src, objs_src = table2_champion
    store = ChampionStore()
    store.put(src, g_src, float(O.combined_metric(objs_src)), objs_src,
              provenance={"source": "table2", "algo": "nsga2"})
    target = float(O.combined_metric(O.evaluate(dst, transfer.migrate(src, dst, g_src))))
    t_reqs = [JobRequest(device=TRANSFER_DST, cfg=nsga2.NSGA2Config(pop_size=TRANSFER_POP),
                         seed=s, budget=TRANSFER_GENS, target=target) for s in CP_STORE_SEEDS]
    gens_to_target, t_done = {}, {}
    for name, st in (("cold", None), ("warm", store)):
        sch = scheduler(store=st)
        jids_d = [sch.submit_request(r) for r in t_reqs]
        done_d, _, ms_d = drive(sch)
        t_done[name] = done_d
        if any(done_d[j].warm_from_cache != (name == "warm") for j in jids_d):
            raise AssertionError(f"store: {name} jobs' warm_from_cache is wrong")
        for j in jids_d:
            check_job(dst, done_d[j].result, False)
        gens_to_target[name] = [done_d[j].result.gens if done_d[j].result.metric <= target
                                else None for j in jids_d]
    if any(g is None for g in gens_to_target["warm"]):
        raise AssertionError(f"store: a warm job missed the migrated metric {gens_to_target}")
    stored = store.get(dst.signature)
    if stored is None:
        raise AssertionError("store: no xcvu9p champion was written back")
    steps_before = sum(p.total_steps for p in sch._pools.values())
    hits, _, hit_launches = counted(kernels, lambda: run_cached(sch, t_reqs, stored.metric))
    if (not all(j.cached and j.result.gens == 0 for j in hits)
            or sum(p.total_steps for p in sch._pools.values()) != steps_before
            or any(hit_launches.values())):
        raise AssertionError("store: the second wave was not answered from the cache")
    path = store.save(str(Path(tmpdir.name) / "champions.json"))
    if ([e.to_json() for e in ChampionStore(path=path).entries()]
            != [e.to_json() for e in store.entries()]):
        raise AssertionError("store: save then load changed the entries")
    out["store"] = dict(target=target, gens_to_target=gens_to_target,
                        stored_metric=stored.metric, cache_hits=len(hits),
                        store_stats=store.stats())
    part_s["store"] = time.perf_counter() - t_part

    # (e) prewarm: the saved store's traffic predicts a pool, built off the
    # stepping thread; a scheduler on another copy of the store, without
    # prewarm, runs the same request; then a prewarmed grow, and the kernel
    # build cache in a second process
    t_part = time.perf_counter()
    r_pred = JobRequest(device=TRANSFER_DST, cfg=nsga2.NSGA2Config(pop_size=TRANSFER_POP),
                        seed=11, budget=2 * CP_GENS_PER_STEP)
    stores = [ChampionStore(), ChampionStore()]
    for st in stores:
        st.load(path)
    sch = scheduler(store=stores[0], prewarm=True)
    keys = sch.prewarm_predicted(top_k=1)
    if not sch.prewarmer.wait_idle(timeout=300) or sch.prewarmer.errors:
        raise AssertionError(f"prewarm: {sch.prewarmer.stats()}")
    sch.submit_request(r_pred)
    (pred_job,) = drive(sch)[0].values()
    pool_stats = next(iter(sch.stats()["pools"].values()))
    if sch.prewarmer.adopted != 1 or pool_stats["blocking_compiles"] != 0:
        raise AssertionError(f"prewarm: adopted {sch.prewarmer.adopted}, blocking builds "
                             f"{pool_stats['blocking_compiles']}")
    sch.close()
    cold_sch = scheduler(store=stores[1])
    cold_sch.submit_request(r_pred)
    (cold_job,) = drive(cold_sch)[0].values()
    if not (pred_job.warm_from_cache and cold_job.warm_from_cache):
        raise AssertionError("prewarm: the store did not seed both jobs")
    same_job("prewarmed pool against a cold one", pred_job.result, cold_job.result)
    check_job(dst, pred_job.result, False)

    first_step_ms = {}
    for prewarm in (False, True, False, True):
        torch.cuda.empty_cache()                 # the caching allocator starts empty
        svc = PlacementService(problem, nsga2.NSGA2Config(pop_size=POP), n_slots=CP_SLOTS,
                               gens_per_step=CP_GENS_PER_STEP, device="cuda")
        grow_reqs = [JobRequest(**s) for s in make_job_specs(CP_PREWARM_SLOTS, POP, 64, seed=9)]
        for r in grow_reqs[:CP_SLOTS]:
            svc.submit_request(r)
        svc.step()
        if prewarm:
            pw = Prewarmer()
            pw.prewarm_grow(svc, CP_PREWARM_SLOTS)
            if not pw.wait_idle(timeout=300) or pw.errors:
                raise AssertionError(f"prewarm_grow: {pw.stats()}")
            pw.close()
        svc.grow(CP_PREWARM_SLOTS)
        for r in grow_reqs[CP_SLOTS:]:
            svc.submit_request(r)
        torch.cuda.synchronize()
        times = []
        for _ in range(2):
            t0 = time.perf_counter()
            svc.step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        first_step_ms.setdefault("prewarmed" if prewarm else "cold", []).append(times)
    del svc

    child = subprocess.run([sys.executable, "-c", CACHE_CHILD, str(_build.build_dir())],
                           capture_output=True, text=True, timeout=300,
                           cwd=Path(__file__).resolve().parent)
    if child.returncode != 0:
        raise AssertionError(f"kernel cache process failed:\n{child.stderr}")
    cached = json.loads(child.stdout.strip().splitlines()[-1])
    if (cached["meter"]["recompiles"] != 0 or cached["meter"]["cache_hits"] != len(_build.NAMES)
            or not all(cached["launches"].values())):
        raise AssertionError(f"kernel cache process: {cached}")
    out["prewarm"] = dict(predicted=[str(k[:2]) for k in keys], adopted=1,
                          first_step_ms=first_step_ms, first_build=first_build,
                          cached_process=cached["meter"])
    part_s["prewarm"] = time.perf_counter() - t_part

    # (f) the asyncio front-end: concurrent clients, one cancelled
    t_part = time.perf_counter()
    f_reqs = [JobRequest(device=FPGA_DEVICE, **s)
              for s in make_job_specs(CP_FE_CLIENTS, POP, CP_FE_BUDGET, seed=10)]
    latency, progress, handles = {}, {}, {}

    async def client(fe, i, r):
        t0 = time.perf_counter()
        h = handles[i] = await fe.submit(r)
        gens = progress[i] = []
        async for u in h.progress():
            gens.append(u.gens)
            if i == CP_FE_CANCEL:
                h.cancel()
                break
        try:
            result = await h.wait()
        except Exception:                        # noqa: BLE001 -- the cancelled job
            result = None
        latency[i] = (time.perf_counter() - t0) * 1e3
        return result

    async def serve_all():
        async with PlacementFrontend(scheduler(), max_queue=CP_FE_QUEUE) as fe:
            t0 = time.perf_counter()
            results = await asyncio.gather(*[client(fe, i, r) for i, r in enumerate(f_reqs)])
            dt = time.perf_counter() - t0
            await fe.drain()
            return results, dt, fe.stats()

    results, dt, fe_stats = asyncio.run(serve_all())
    if handles[CP_FE_CANCEL].status is not JobStatus.CANCELLED:
        raise AssertionError(f"front-end: job {CP_FE_CANCEL} is {handles[CP_FE_CANCEL].status}")
    seq = scheduler()
    seq_jids = {i: seq.submit_request(r) for i, r in enumerate(f_reqs) if i != CP_FE_CANCEL}
    seq_done = drive(seq)[0]
    for i, jid in seq_jids.items():
        same_job(f"front-end job {i} against the sequential scheduler", results[i],
                 seq_done[jid].result)
        if progress[i] != sorted(progress[i]):
            raise AssertionError(f"front-end: job {i}'s progress {progress[i]} is not monotone")
    finished = [r for i, r in enumerate(results) if i != CP_FE_CANCEL]
    if (len({id(r) for r in finished}) != CP_FE_CLIENTS - 1
            or fe_stats["completed"] != CP_FE_CLIENTS - 1 or fe_stats["cancelled"] != 1
            or fe_stats["failed"] != 0 or fe_stats["submitted"] != CP_FE_CLIENTS):
        raise AssertionError(f"front-end: drain lost or duplicated a job: {trimmed(fe_stats)}")
    lat = [latency[i] for i in seq_jids]
    out["frontend"] = dict(seconds=dt, jobs_per_s=len(finished) / dt,
                           p50_ms=float(np.percentile(lat, 50)),
                           p99_ms=float(np.percentile(lat, 99)),
                           backpressure_waits=fe_stats["backpressure_waits"],
                           cancelled_at_gens=progress[CP_FE_CANCEL])
    part_s["frontend"] = time.perf_counter() - t_part

    # (g) the launcher, every control-plane flag and the front-end
    t_part = time.perf_counter()
    text = io.StringIO()

    def launch():
        with contextlib.redirect_stdout(text):
            serve.main(["--placement", "--device", "xcvu_test", "--requests", "4",
                        "--slots", "2", "--pop", "16", "--gens", "8", "--cache",
                        "--policy", "deadline", "--autoscale", "--prewarm", "--frontend",
                        "--compile-cache-dir", str(_build.build_dir())])
        compile_cache.disable()

    _, dt, paths["control_plane_launcher"] = counted(kernels, launch)
    lines = text.getvalue().strip().splitlines()
    if (not lines[0].startswith(f"kernel build cache: {_build.build_dir()}")
            or "4 done / 0 cancelled / 0 failed" not in text.getvalue()
            or [f"client{i:2d}: job" in text.getvalue() for i in range(4)] != [True] * 4):
        raise AssertionError(f"control-plane launcher output:\n{text.getvalue()}")
    out["launcher"] = dict(seconds=dt, lines=lines[-2:])
    part_s["launcher"] = time.perf_counter() - t_part
    out["part_s"] = part_s
    tmpdir.cleanup()
    return out, paths


def run_cached(sch, reqs, metric):
    """The requests again with `target` at the stored metric: answered from
    the champion store at submit."""
    jids = [sch.submit_request(r.replace(target=metric)) for r in reqs]
    done = {j.jid: j for j in sch.step()}
    return [done[j] for j in jids]


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
    # the batch axis: B problems of 128 rows in one launch (islands, members)
    for name in ("domination", "domination_counts"):
        rows[name]["batched"] = {}
        for nb in (4, 8):
            o = torch.rand(nb, 2 * POP, 2, device="cuda")
            kern = ((lambda o=o: domination.domination(o)) if name == "domination" else
                    (lambda o=o: domination.domination_counts(o)))
            plain = ((lambda o=o: ref.domination_ref(o)) if name == "domination" else
                     (lambda o=o: ref.domination_counts_ref(o)))
            q = 2 * POP
            bms, by_what = bound_ms(nb * (8 * q + q * q + (4 * q if name != "domination" else 0)),
                                    nb * 6 * q * q)
            dev, ops = device_profile(kern, SYMBOLS[name])
            rows[name]["batched"][f"[{nb}, {q}, 2]"] = dict(
                ms=time_ms(kern), device_ms=dev, device_ops=ops, bound_ms=bms,
                bound_by=by_what, plain_ms=time_ms(plain))
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


def host_syncs(fn):
    """(fn(), the calls in it that made the host wait on the card), counted
    by torch's CUDA sync debug mode: reads back, and copies from pageable
    host memory."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchronizing" in str(w.message) for w in caught)


def device_trace(fn):
    """One call of `fn` (after one untraced call) under a CUDA-only
    torch.profiler trace: (host-clock ms, device ops, the device's busy
    share).  Left out of the trace, the CPU ops (~16,000 in a service step)
    add nothing to the trace's read-back and slow the host less, so the
    busy share reads higher than `profiled`'s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    return wall_us / 1e3, len(kernels), (busy_us / wall_us if kernels else None)


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
    from repro_torch.runtime import compile_cache

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
    meter = compile_cache.meter()
    first_build = dict(nvcc_builds=meter.recompiles, cache_hits=meter.cache_hits,
                       seconds=meter.compile_secs)
    print(f"build meter: {first_build['nvcc_builds']} nvcc builds, {first_build['cache_hits']} "
          f"found on disk, {first_build['seconds']:.2f} s")
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

    # the portfolio, racing and islands: K members or P islands per launch
    print(f"[{time.perf_counter() - start:.1f} s] portfolio: NSGA-II K = {len(PF_ETA_MUT)} "
          f"pop {POP} x {PF_GENS} gens unfused and fused, SA K = {len(SA_K_T0)} x "
          f"{SA_K_STEPS} steps; race; islands P = {ISL_P}")
    portfolios, paths = run_portfolio_phase(problem, kernels)
    by_path.update(paths)
    for name, v in portfolios.items():
        print(f"  {name} ({v['phase_s']:.1f} s): K = {v['k']}, {v['gens']} gens: "
              f"{v['ms_per_gen']:.3f} ms per gen batched (K = 1, {v['gens_k1']} gens: "
              f"{v['ms_per_gen_k1']:.3f}); independent {v['solo_ms_per_gen']:.3f} ms per "
              f"gen each, {v['independent_ms_per_gen_for_k']:.3f} for K; device ops per gen "
              f"K = 1 {v['device_ops_per_gen_k1']:.0f}, K = {v['k']} {v['device_ops_per_gen']:.0f}; "
              f"device busy {v['busy_k1']} / {v['busy']}; one generation under the profiler "
              f"{v['profiled_ms_k1']:.3f} / {v['profiled_ms']:.3f} ms; {v['members_checked']} "
              f"members equal "
              f"their independent runs; best combined {v['best']:.4e}")
        for kk in (1, v["k"]):
            print(f"    launches K = {kk}: {by_path[f'{name}_k{kk}']}")
    print(f"[{time.perf_counter() - start:.1f} s] race")
    race, by_path["race"] = run_race_phase(problem, kernels)
    print(f"  race (K = {len(PF_ETA_MUT)}, rounds of {RACE_GENS_PER_ROUND}, max {RACE_MAX_GENS} "
          f"gens, patience 2): {race['rounds']} rounds, {race['gens']} gens, {race['seconds']:.3f} s; "
          f"champion member {race['champion']}, metrics {race['metric']}; best per round "
          f"{race['round_best']}; launches {by_path['race']}")
    print(f"[{time.perf_counter() - start:.1f} s] islands")
    islands, paths = run_islands_phase(problem, kernels)
    by_path.update(paths)
    v = islands["xcvu11p"]
    print(f"  islands P = {ISL_P}, migrate every {ISL_MIGRATE}, pop {POP} x {ISL_GENS} gens: "
          f"{v['ms_per_gen']:.3f} ms per gen, {v['device_ops_per_gen']:.0f} device ops per gen, "
          f"device busy {v['busy']}; best combined {v['first']:.4e} -> {v['best']:.4e}; "
          f"launches {by_path['islands']}; islands(P=1) == evolve.run over {ISL_P1_GENS} gens: True")
    v = islands["bench_xcvu_test"]
    print(f"  BENCH islands on xcvu_test (P {ISL_BENCH_P}, pop {ISL_BENCH_POP}, migrate every "
          f"{ISL_BENCH_MIGRATE}): target {v['target']:.4e}; gens to target single "
          f"{v['single_gens_to_target']} of {v['single_budget']} ({v['single_s']:.3f} s), islands "
          f"{v['islands_gens_to_target']} (their equal-evaluation budget {v['islands_budget']}, "
          f"{ISL_BENCH_BUDGET} run in {v['islands_s']:.3f} s); best combined single after "
          f"{ISL_BENCH_BUDGET} gens {v['single_best']:.4e}, islands after {v['islands_budget']} "
          f"{v['islands_best_at_budget']:.4e} and after {ISL_BENCH_BUDGET} {v['islands_best']:.4e}")
    print(f"[{time.perf_counter() - start:.1f} s] placement service: {SVC_JOBS} jobs x "
          f"{SVC_BUDGET} gens over {SVC_SLOTS} slots, {SVC_GENS_PER_STEP} gens per step")
    t0 = time.perf_counter()
    svc, paths = run_service_phase(problem, kernels)
    by_path.update(paths)
    for name in ("service_unfused", "service_fused"):
        v = svc[name]
        print(f"  {name}: {SVC_JOBS} jobs in {v['seconds']:.3f} s, {v['jobs_per_s']:.3f} jobs/s, "
              f"{v['gens_per_s']:.2f} active-slot gens/s, {v['ms_per_step']:.3f} ms per step "
              f"({v['steps']} steps); step compiles {v['step_compiles']}; blocking build "
              f"{v['blocking_compile_secs']} s; best combined {v['best']:.4e}; "
              f"launches {by_path[name]}")
        for n in (1, SVC_SLOTS):
            o = svc[f"{name}_occupancy_{n}"]
            prof = (f", under a CUDA-only trace {o['profiled_step_ms']:.3f} ms, "
                    f"{o['device_ops_per_step']:.0f} device ops per step, device busy {o['busy']}"
                    if "busy" in o else "")
            print(f"    {n} active: launches per step {by_path[f'{name}_occupancy_{n}']}; "
                  f"step {o['step_ms']:.3f} ms, host syncs {o['host_syncs']}{prof}")
    print(f"  co-tenancy: seed 42 alone == beside {SVC_SLOTS - 1} co-tenants, one cancelled "
          f"(integers exactly, floats within tol): True")
    v = svc["grow"]
    print(f"  grow 4 -> {SVC_SLOTS}: sizes {v['sizes']}, step compiles {v['step_compiles']}; "
          f"the in-flight jobs equal a never-grown pool's: True")
    v = svc["islands"]
    print(f"  islands {SVC_ISL_SLOTS} slots x P {SVC_ISL_P} (migrate every {SVC_ISL_MIGRATE}), "
          f"{SVC_ISL_SLOTS} jobs x {SVC_ISL_BUDGET} gens: {v['ms_per_step']:.3f} ms per step, "
          f"host syncs per step before the harvest {v['host_syncs']}, "
          f"under a CUDA-only trace {v['profiled_step_ms']:.3f} ms, "
          f"{v['device_ops_per_step']:.0f} device ops per step, device busy {v['busy']}; "
          f"launches {by_path['service_islands']}; best combined {v['best']:.4e}; "
          f"islands(P=1) == the plain pool bit for bit: True")
    v = svc["transfer"]
    print(f"  BENCH transfer xcvu_test -> xcvu_test2 (base pop {SVC_TRANSFER_BASE_POP} x "
          f"{SVC_TRANSFER_BASE_GENS} gens in {v['converge_s']:.3f} s; pop {SVC_TRANSFER_POP}, "
          f"budget {SVC_TRANSFER_BUDGET}, {SVC_TRANSFER_GENS_PER_STEP} gens per step): target "
          f"{v['target']:.4e}; gens to target by seed (None: not reached) cold {v['cold']}, "
          f"warm {v['warm']}; {v['seconds']:.3f} s")
    print(f"  launcher: {svc['launcher']['last_line']} ({svc['launcher']['seconds']:.3f} s); "
          f"the phase {time.perf_counter() - t0:.1f} s, by part (s) {svc['part_s']}")
    print(f"[{time.perf_counter() - start:.1f} s] control plane: schedulers of {CP_SLOTS}-slot "
          f"pools at {CP_GENS_PER_STEP} gens per step")
    t0 = time.perf_counter()
    cp, paths = run_control_plane_phase(problem, kernels, table2["seed_champion"], first_build)
    by_path.update(paths)
    v = cp["routing"]
    print(f"  routing: {CP_NSGA_JOBS} NSGA-II (pop {POP}) + {CP_GA_JOBS} GA (pop {CP_GA_POP}) "
          f"jobs x {CP_BUDGET} gens, 2 pools round-robin: {v['seconds']:.3f} s, "
          f"{v['jobs_per_s']:.3f} jobs/s, {v['steps']} scheduler steps {v['steps_per_pool']}, "
          f"ms per step by pool {v['ms_per_step']}; launches {by_path['control_plane_routing']}; "
          f"every champion legal and O.evaluate's, one NSGA-II and one GA job == a standalone "
          f"pool: True")
    print(f"  routing stats: {json.dumps(v['stats'])}")
    v = cp["policy"]
    print(f"  deadline policy: the urgent job finished after {v['urgent_steps_deadline']} "
          f"scheduler steps (round-robin {v['urgent_steps_round_robin']}), all jobs after "
          f"{v['total_steps_deadline']} ({v['total_steps_round_robin']}); results unchanged: True")
    v = cp["autoscale"]
    print(f"  autoscale ({CP_AUTOSCALE_JOBS} jobs, threshold {CP_AUTOSCALE_THRESHOLD}, max "
          f"{CP_MAX_SLOTS}): events {v['events']}, sizes {v['sizes']}, {v['steps']} steps; "
          f"launches per step (slots, counts) {v['launches_per_step']}; grown jobs == "
          f"standalone: True")
    v = cp["store"]
    print(f"  store: {TRANSFER_SRC} champion -> {TRANSFER_DST} jobs (pop {TRANSFER_POP}, budget "
          f"{TRANSFER_GENS}, seeds {CP_STORE_SEEDS}), target {v['target']:.4e}: gens to target "
          f"cold {v['gens_to_target']['cold']}, warm from the store "
          f"{v['gens_to_target']['warm']}; stored {TRANSFER_DST} metric "
          f"{v['stored_metric']:.4e}; second wave {v['cache_hits']} cache hits, 0 gens, no pool "
          f"step, no launch; save/load round trip: True; {v['store_stats']}")
    v = cp["prewarm"]
    print(f"  prewarm: predicted {v['predicted']} built off-thread and adopted, blocking builds "
          f"0, result == a cold pool's: True; first two steps after grow({CP_SLOTS} -> "
          f"{CP_PREWARM_SLOTS}) ms {v['first_step_ms']}; the script's first build "
          f"{v['first_build']}; a second process with the build dir: {v['cached_process']}")
    v = cp["frontend"]
    print(f"  front-end: {CP_FE_CLIENTS} clients (max_queue {CP_FE_QUEUE}, budget "
          f"{CP_FE_BUDGET}), job {CP_FE_CANCEL} cancelled at gens {v['cancelled_at_gens']}: "
          f"{v['seconds']:.3f} s, {v['jobs_per_s']:.3f} jobs/s, submit-to-terminal p50 "
          f"{v['p50_ms']:.1f} ms, p99 {v['p99_ms']:.1f} ms, backpressure waits "
          f"{v['backpressure_waits']}; == the sequential scheduler: True")
    print(f"  control-plane launcher: {cp['launcher']['lines']} "
          f"({cp['launcher']['seconds']:.3f} s; launches {by_path['control_plane_launcher']}); "
          f"the phase {time.perf_counter() - t0:.1f} s, by part (s) {cp['part_s']}")
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
    for name in ("domination", "domination_counts"):
        for key, v in next(r for r in rows if r["name"] == name)["batched"].items():
            print(f"{name} batched {key}: {v['ms']:.4f} ms per call, device {v['device_ms']} ms "
                  f"in {v['device_ops']} ops, bound {v['bound_ms']:.6f} ms ({v['bound_by']}), "
                  f"plain {v['plain_ms']:.4f} ms")
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
