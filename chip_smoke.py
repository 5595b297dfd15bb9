#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (`src/repro_torch`) on one NVIDIA card.

    python3 chip_smoke.py

1. Builds the five CUDA kernels from `src/repro_torch/csrc/` for sm_90a.
2. Holds each kernel against its plain PyTorch version on the card over
   the sweep shapes and the main paths' shapes (SA's 1 row, CMA-ES's 24,
   the xcvu9p width), in f32 and bf16 (flash
   attention over the reference's test grid, the serving path's prefill
   shapes, gemma3's D = 256 under a window, the tile edges of its
   tensor-core routes and head dims 16 and 96, zero-padded to the next
   variant's; domination bitwise, at the edges of its tiles too,
   and with its batch axis, B in {1, 2, 4, 8, 12, 16} x P in {16, 32, 64,
   128} (DOM_BATCHES x DOM_BATCH_SIZES), directly and under
   `torch.func.vmap`; the evaluation kernels under vmap; wirelength2 at N
   in WL_EDGE_NETS, maxbbox at (U, B) in BBOX_EDGE_UNITS and fused_eval at
   (G, N, U, B) in FE_EDGE_SHAPES, at every row count of PLAN_ROWS,
   directly and under vmap, and fused_eval at the largest G its plan
   takes).  Then batch invariance, bit for bit: each row of a [1024, ...]
   input to wirelength2 (w [N] and [P, N]), maxbbox and fused_eval (at
   FE_INVARIANCE_SHAPES), f32 and bf16, alone, in a [64, ...] slice at
   another offset and in the whole batch, directly and under vmap.
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
   Then the same islands over ISL_WORLD = 2 processes spawned on the one
   card (`torch.distributed` on gloo, a FileStore; ring exchanges staged
   through the host): the gathered states and history against the
   single-process run from the same seed, each rank's launches by the
   single-process formula with P / 2 islands, ms per generation per rank
   and host ms per ring exchange; and `evolve.run_islands` over the two
   ranks (3 rounds x 4 generations: a finite history, a legal champion).
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
   Then the paper's runners (`repro_torch.benchmarks`) at their quick
   budgets: Table I on xcvu11p (all five methods), Table II xcvu3p ->
   xcvu5p, xcvu7p and xcvu9p, Figs. 7 and 9 on xcvu11p and Fig. 8 at
   FIG8_STEPS steps a chain, each in one counted window with exact
   launches; every champion legal, every history non-increasing,
   evaluations = generations x population, Table II's warm start at or
   below scratch in its first generation on every target.  Then every
   example (`repro_torch.examples`) at its own defaults: its key lines and
   its launches (exact for placement_transfer, and for serve_lm, whose
   reduced yi-6b runs flash attention at D = 16 padded to 64; the others
   launch the unfused path's kernels and no other).
   Then serves yi-6b at full width (fp32, weights from seed 0) through
   `repro_torch.serve.engine.Engine`: 8 requests of 77-2048 prompt tokens
   and 32 new tokens each over 4 slots, with the launch counters set to 0
   just before and read just after; every prefill attention layer must
   launch the flash-attention kernel, and the last-token prefill logits
   through the kernel must match those through the plain attention.  A
   torch.profiler trace of a pool decode step and of the longest prefill
   gives their device busy share and top kernels (and flash attention's
   device µs per launch in that prefill).
   Then the other families (FAMILIES), one model at a time, each freed
   before the next: deepseek-moe-16b at full width (28 layers, 64 routed
   experts top-6 + 2 shared) with yi-6b's 8 requests, rwkv6-1.6b in full,
   jamba-v0.1-52b at full width over one period (8 of 32 layers), and
   reduced qwen2-moe, llava-next and musicgen; each with exact flash
   launches (attention layers x requests), the shortest prompt's logits
   through the kernel against the plain attention (and the (token,
   layer) routes the two runs chose differently; llava and musicgen also
   behind their stub frontend embeddings), for MoE models the dispatch
   body against the dense one at one layer's hidden states from the
   longest prompt, and a profile of a decode step (host syncs, the
   host's time blocked in them) and of the longest prefill with the
   share of each model span ("moe", "rwkv.wkv", "mamba.scan").
   Then training (`train.trainer.Trainer`), the serving models freed
   first: yi-6b at full width over TRAIN_LAYERS = 8 of its 32 layers
   (fp32; batch 4 x 2048 of the synthetic pipeline), the first batch's
   loss and every parameter's gradient through the kernel against plain
   attention, then TRAIN_STEPS = 5 steps with flash launches exactly 2 per
   attention layer a step (the forward and its remat recompute), finite
   losses and norms, s per step, tokens/s, peak memory, a profiled step's
   busy share and the share of the fp32 peak; one bf16 step at 2 layers
   (the wgmma route) held against plain attention; reduced
   deepseek-moe-16b, jamba-v0.1-52b and rwkv6-1.6b for 3 steps each;
   `examples/train_lm` at its defaults (the loss falls), then with
   --inject 150 (the recovered losses against the uninterrupted run's);
   and the training launcher for 20 steps of reduced yi-6b.
   (The dry-run cells of phase 5 (c) start here, in a process of their
   own with a fake process group, tracing on the host's CPU while the card
   serves and trains.)
4. Times each kernel and its plain version with CUDA events at the path's
   shapes, at the baselines' and the transfer's shapes, and at 2048 rows
   (and each call's device time from a
   torch.profiler trace: the kernel and any memset or copy the call
   issues), domination against its plain version over
   SWEEP_ROWS and batched at [4, 128, 2] and [8, 128, 2], flash attention at the serving path's longest prefill
   against `scaled_dot_product_attention` as a yardstick (f32 beside its
   FMA and 3xTF32 bounds), and a generation against its rank peeling and
   its device busy share.  wirelength2, maxbbox and fused_eval are also
   timed at the path's width and at the floor (N = 7; U = B = 1; (G, N, U,
   B) = (7, 7, 1, 1)) over FIGURE_ROWS rows, and must issue one device op
   per call at every shape reported; each placement wrapper's host µs per
   call is split by stage (`host_split`).
5. Sharding and the dry-run (`run_sharding_phase`; its launches join the
   kernel rows): (a) on a world-1 NCCL mesh (1, 1) in a spawned process,
   yi-6b at full width over SHARD_LAYERS = 8 layers (fp32) with DTensor
   parameters laid out by `spec_for(param_axes)`: a 2048-token prefill
   and 16 decode steps under `activate`, the logits against the
   unsharded model's on the same weights and the flash launches through
   the custom op and its sharding rule, then one training step on the
   prompt (the gradient constraint, flash's custom op under autograd):
   its loss and every parameter's gradient against the unsharded
   model's; (b) two gloo ranks spawned on the
   card, computing on CUDA with their collectives staged through the
   host: yi-6b's split-KV decode attention over a 4096-token cache split
   2 ways, heads-sharded flash prefill (16 / 2 heads a rank), `_apply_ep`
   on one deepseek-moe-16b MoE layer at full width (32 of 64 experts a
   rank) with capacity not binding (against `dense`) and at
   capacity_factor 1.0 (against the same two shards in one process), and
   `islands.run(mesh=)` over a 2-rank "islands" mesh bit for bit against
   `group=`; (c) `launch.dryrun` on (16, 16) for yi-6b at train_4k,
   prefill_32k and decode_32k, musicgen-large at decode_32k, rwkv6-1.6b
   at long_500k, deepseek-moe-16b at train_4k on (2, 16, 16), and
   vu_systolic's ea_round executed on the card, each cell's JSON under
   experiments/dryrun, gated: the train cells' flops per device within
   TRAIN_FLOPS_RTOL of yi-6b's unsharded step over the world and of the
   reference's count (REF_FLOPS), the forward cells' flops equal to
   FWD_FLOPS, one Shard -> Shard redistribution booked as one all-to-all
   of its bytes on a cuda and on a cpu mesh, and yi-6b train_4k's flops
   and collective bytes the same, kind by kind, traced on either mesh.
   (c) starts with the phase, after every timed phase before it, and
   traces in its own process while (a) and (b) run: their times share the
   host with it.  A (2, 2) mesh of CUDA DTensors would take four gloo
   ranks on the card, and those crash (SIGSEGV in
   `_c10d_functional.wait_tensor`, torch 2.11) in DTensor's first
   redistribution: the CPU tests hold the (2, 2) mesh.

Prints the card's name and power limit, one JSON line of kernel figures,
and as its last line `{"ok": true, "device": {...}}`.  Exits non-zero,
without that line, when no CUDA device is present or any phase fails.

    python3 chip_smoke.py --launch-path [--src DIR]

prints only the per-call host, CUDA-event and device µs of the placement
wrappers at the main path's shape (wirelength2, maxbbox and fused_eval
also at 2048 rows and at the floor, fused_eval at the baselines' and the
transfer's shapes), importing `repro_torch` from DIR (the
`src` of another checkout) when given, to compare two trees in one call.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import tempfile
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
                  (1, 4, 2, 300, 300, 64, 100, 1.0), (1, 4, 2, 300, 300, 256, 100, 1.0)]
               # head dims no variant takes, zero-padded: the reduced configs'
               # D = 16 at serve_lm's prompt lengths and under a window, and 96
               + [(1, 4, 4, s, s, 16, None, 1.0) for s in (3, 8)]
               + [(1, 4, 2, 64, 64, 16, 32, 1.0), (1, 4, 2, 100, 100, 96, None, 1.0)])
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
# wirelength2 and maxbbox at the edges of their designs (odd N starts most
# rows unaligned and takes the scalar route; (130, 5) rows of 2600 bytes
# take a scalar head and tail; B = 32 puts a warp on each unit), at every
# row count the paths launch them with (SA 1, SA K = 8, the transfer 16,
# CMA-ES 24, Table II 32, the GA 48, the main path 64, service pools of
# 192 to 1024 rows) and 2048; then each row of INVARIANCE_ROWS alone, in a
# slice of INVARIANCE_SLICE rows at another offset and in the whole batch
WL_EDGE_NETS = (1, 3, 4, 5, 1999, 2000, 3074, 4097)
BBOX_EDGE_UNITS = ((1, 1), (80, 28), (123, 28), (130, 5), (128, 32), (33, 3))
# fused_eval (G, N, U, B) at the edges of its plan: odd G (rows start
# unaligned: a scalar head and tail), B odd (sub = 1), B = 32 (a warp per
# unit), 800 unit lanes (two passes of 512), N below the threads, B / sub
# past the 7 indices a lane holds, and the floor; then the shapes whose
# rows are held bit for bit: the path, xcvu3p's and an odd G
FE_EDGE_SHAPES = ((2239, 1999, 80, 28), (97, 511, 13, 7), (1000, 300, 10, 32),
                  (3444, 3074, 200, 28), (2240, 5, 80, 28), (331, 100, 9, 27), (7, 7, 1, 1))
FE_INVARIANCE_SHAPES = ((2240, 1999, 80, 28), (3444, 3074, 123, 28), (2239, 1999, 80, 28))
PLAN_ROWS = (1, 7, 8, 16, 24, 32, 48, 64, 192, 256, 512, 768, 1024, 2048)
INVARIANCE_ROWS, INVARIANCE_SLICE = 1024, 64
# the floor: the same kernels at N = 7, at U = B = 1 and at (G, N, U, B) =
# (7, 7, 1, 1); each, and the path's width, timed at FIGURE_ROWS rows
FLOOR_NETS, FLOOR_UNITS, FLOOR_EVAL = 7, (1, 1), (7, 7, 1, 1)
FIGURE_ROWS = (1, 8, 64, 256, 512, 768, 1024, 2048)
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
# the paper's runners at their quick budgets, Fig. 8 cut to FIG8_STEPS steps
# a chain (fig8_cooling.QUICK_STEPS is 1500) for the phase's time
FIG8_STEPS = 250
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
# the other families: deepseek-moe-16b at full width (the slice's main
# path, 8 requests as yi-6b's); rwkv6-1.6b at full width and depth;
# jamba-v0.1-52b at full width over one period (8 of 32 layers, for memory:
# 32 layers are 206 GB in fp32); qwen2-moe, llava-next and musicgen reduced
# (`get_reduced`).  (arch, reduced, n_layers or None, prompt lengths,
# max_new, slots, the prompt whose prefill is traced); a jamba prompt past
# 256 tokens is a multiple of 256.  rwkv's 512-token prefill issues 75k
# device ops, whose trace takes the profiler minutes to read: its 128
FAMILIES = (
    ("deepseek-moe-16b", False, None, SERVE_PROMPTS, SERVE_MAX_NEW, SERVE_SLOTS, 2048),
    ("rwkv6-1.6b", False, None, (512, 257, 128, 77), 16, 2, 128),
    ("jamba-v0.1-52b", False, 8, (2048, 512, 256, 77), 16, 2, 2048),
    ("qwen2-moe-a2.7b", True, None, (48, 33, 17, 9), 8, 2, 48),
    ("llava-next-34b", True, None, (48, 33, 17, 9), 8, 2, 48),
    ("musicgen-large", True, None, (48, 33, 17, 9), 8, 2, 48),
)
# MoE dispatch against the dense body on the same routes: the same fp32
# products summed in other orders (cuBLAS GEMMs of other shapes over
# d_model and d_expert terms, up to 14336), as LOGITS_TOL
MOE_TOL = dict(rtol=1e-4, atol=1e-4)
# islands across processes: run_islands_phase's islands (ISL_P of pop POP,
# migrate every ISL_MIGRATE, ISL_GENS generations) over ISL_WORLD ranks
# spawned on the one card (gloo, host staging: NCCL takes one rank a card),
# and evolve.run_islands over the ranks for ISL_DIST_ROUNDS rounds of
# ISL_DIST_GENS_PER_ROUND generations; a rank that takes longer than
# ISL_DIST_TIMEOUT_S fails the phase
ISL_WORLD, ISL_DIST_ROUNDS, ISL_DIST_GENS_PER_ROUND, ISL_DIST_TIMEOUT_S = 2, 3, 4, 300
# training: yi-6b at full width cut to TRAIN_LAYERS of 32 layers (fp32
# params, master, m, v and gradients: 1.91 B x 20 bytes), TRAIN_STEPS steps
# at TRAIN_BATCH x TRAIN_SEQ tokens; the first step's loss and every
# gradient through the kernel against plain attention: the loss within
# rtol TRAIN_LOSS_RTOL, each gradient within TRAIN_GRAD_TOL of its own max
# |g| (fp32 attention outputs differ by ~1e-6 between the two, and the
# backward passes that through 8 layers and the head); then one step at
# TRAIN_BF16_LAYERS layers in bf16 (the wgmma route), its loss within rtol
# TRAIN_BF16_RTOL of plain attention's in bf16 (bf16 keeps 8 bits: each
# rounding is up to 2^-8 of its value); reduced TRAIN_FAMILIES for
# TRAIN_FAMILY_STEPS steps each; examples/train_lm at its defaults, then
# with --inject TRAIN_LM_INJECT: its logged losses within rtol
# TRAIN_LM_RTOL of the uninterrupted run's (the embedding's backward sums
# in a fixed order and the two runs have been bit for bit on the card, but
# nothing promises that every CUDA op is deterministic; the phase prints
# whether they were); the launcher for TRAIN_LAUNCH_STEPS steps
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = "yi-6b", 8, 5, 4, 2048
TRAIN_LOSS_RTOL, TRAIN_GRAD_TOL = 1e-4, 1e-3
TRAIN_BF16_LAYERS, TRAIN_BF16_RTOL = 2, 1e-2
TRAIN_FAMILIES = ("deepseek-moe-16b", "jamba-v0.1-52b", "rwkv6-1.6b")
TRAIN_FAMILY_STEPS, TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ = 3, 4, 64
TRAIN_LM_INJECT, TRAIN_LM_RTOL, TRAIN_LAUNCH_STEPS = 150, 1e-2, 20
# sharding: (a) yi-6b at full width over SHARD_LAYERS layers on a world-1
# NCCL mesh, a SHARD_PROMPT-token prefill and SHARD_DECODE decode steps,
# against the unsharded model (the same local ops: SHARD_TOL allows the
# DTensor path's other op order); (b) over 2 gloo ranks on the card:
# split-KV decode at SPLIT_KV_B rows of SPLIT_KV_LENS filled lengths over a
# SPLIT_KV_T cache (the merge adds two partials in another order than one
# pass: SHARD_TOL), heads-sharded flash at SHARD_PROMPT tokens, `_apply_ep`
# on deepseek-moe-16b's layer at EP_TOKENS tokens (capacity not binding at
# EP_FREE_CF, binding at 1.0), islands P = ISL_P over ISL_WORLD ranks for
# SHARD_ISL_GENS generations; (c) DRYRUN_CELLS (arch, shape, multi-pod)
SHARD_LAYERS, SHARD_PROMPT, SHARD_DECODE = 8, 2048, 16
SHARD_TOL = dict(rtol=1e-5, atol=1e-5)
SPLIT_KV_B, SPLIT_KV_T, SPLIT_KV_LENS = 4, 4096, (100, 2047, 2048, 4000)
EP_TOKENS, EP_FREE_CF, SHARD_ISL_GENS, SHARD_TIMEOUT_S = 1024, 11.0, 10, 300
DRYRUN_CELLS = (("yi-6b", "train_4k", False), ("yi-6b", "prefill_32k", False),
                ("yi-6b", "decode_32k", False), ("musicgen-large", "decode_32k", False),
                ("rwkv6-1.6b", "long_500k", False), ("deepseek-moe-16b", "train_4k", True),
                ("vu_systolic", "ea_round", False))
DRYRUN_TIMEOUT_S = 700
# (a) also takes one training step on its prompt, loss within SHARD_TOL and
# every gradient within SHARD_GRAD_TOL of its max |g|; (c) gates: a train
# cell's flops per device within TRAIN_FLOPS_RTOL of an independent count:
# yi-6b's unsharded step (one data-parallel replica's rows, divided by the
# "model" size: the whole batch's trace divided by the world), and the
# reference's count of the same cell (`repro.launch.dryrun` on the CPU:
# XLA's HLO for 256 / 512 host devices), the only yardstick for
# deepseek-moe-16b, whose sharded experts compute capacity-padded buffers
# (the unsharded model's dispatch reads its routing to the host, which
# fake tensors cannot); the forward cells' flops equal FWD_FLOPS (5 digits:
# their counts before the gradient constraint, which a forward pass skips)
SHARD_GRAD_TOL, TRAIN_FLOPS_RTOL = 1e-5, 0.03
REF_FLOPS = {"yi-6b train_4k": 2.1562e14, "deepseek-moe-16b train_4k": 5.6950e13}
FWD_FLOPS = {"yi-6b prefill_32k": 1.1572e14, "yi-6b decode_32k": 1.4389e10,
             "musicgen-large decode_32k": 9.6679e9, "rwkv6-1.6b long_500k": 3.8207e8}
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM fp32 outside the tensor cores
TF32_OPS_PER_S = 495e12            # H100 SXM TF32 tensor cores, dense
BF16_OPS_PER_S = 989e12            # H100 SXM bf16 tensor cores, dense


def tol(dtype, kernel: str = ""):
    """The placement kernels: rtol 1e-5 / atol 1e-6 in f32 and in bf16, which
    they upcast on load and add in f32, so a bf16 case is held against the
    plain version on the same inputs upcast to f32 (`plain`): only the
    order of an f32 sum differs, whatever the draw.  Flash attention in
    f32: the reference's own flash tests' rtol 2e-5 / atol 1e-5, because
    with unit-scale q and k the fp32 logits of a 128-term dot product
    differ by ~1e-6 between two summation orders, and exp passes that on
    to every weight of the sum over T; in bf16 (bf16 products on the
    tensor cores, against the plain version in bf16) rtol / atol 2e-2."""
    import torch
    if kernel == "flash_attention":
        if dtype == torch.bfloat16:
            return dict(rtol=2e-2, atol=2e-2)
        return dict(rtol=2e-5, atol=1e-5)
    return dict(rtol=1e-5, atol=1e-6)


def plain(fn, *args):
    """A placement kernel's plain version on `args`, every bf16 tensor
    among them upcast to f32 first (what the kernel computes)."""
    import torch
    return fn(*(a.float() if isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16 else a
                for a in args))


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
                      plain(ref.fused_eval_ref, cx, cy, src, dst, w, uidx), dtype)
        for n in (7, 512, 1999, 4097):
            for p in SWEEP_ROWS:
                xs = [coords(p, n).to(dtype) for _ in range(4)]
                for w in ((coords(n).abs() * 0.1).to(dtype),
                          (coords(p, n).abs() * 0.1).to(dtype)):
                    close("wirelength2", wirelength.wirelength2(*xs, w),
                          plain(ref.wirelength2_ref, *xs, w), dtype)
        for u, b in ((6, 28), (80, 28), (123, 28), (130, 5), (128, 32)):
            for p in SWEEP_ROWS:
                ux, uy = coords(p, u, b).to(dtype), coords(p, u, b).to(dtype)
                close("maxbbox", bbox.maxbbox(ux, uy), plain(ref.maxbbox_ref, ux, uy), dtype)
        for g, n, u, b in SLICE_SHAPES:
            src, dst, uidx = ints(g, n), ints(g, n), ints(g, u, b)
            w = (coords(n).abs() * 0.002).to(dtype)
            for p in SLICE_ROWS:
                cx, cy = coords(p, g).to(dtype), coords(p, g).to(dtype)
                close("fused_eval", fused_eval.fused_eval(cx, cy, src, dst, w, uidx),
                      plain(ref.fused_eval_ref, cx, cy, src, dst, w, uidx), dtype)
                xs = [coords(p, n).to(dtype) for _ in range(4)]
                close("wirelength2", wirelength.wirelength2(*xs, w),
                      plain(ref.wirelength2_ref, *xs, w), dtype)
                ux, uy = coords(p, u, b).to(dtype), coords(p, u, b).to(dtype)
                close("maxbbox", bbox.maxbbox(ux, uy), plain(ref.maxbbox_ref, ux, uy), dtype)
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
            cx, cy, src, dst, w, uidx), plain(ref.fused_eval_ref, cx, cy, src, dst, w, uidx),
            dtype)
        xs = [coords(4, 16, n).to(dtype) for _ in range(4)]
        close("wirelength2", torch.func.vmap(wirelength.wirelength2, in_dims=(0,) * 4 + (None,))(
            *xs, w), plain(ref.wirelength2_ref, *xs, w), dtype)
        ux, uy = coords(4, 16, u, b).to(dtype), coords(4, 16, u, b).to(dtype)
        close("maxbbox", torch.func.vmap(bbox.maxbbox)(ux, uy), plain(ref.maxbbox_ref, ux, uy),
              dtype)
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

    check_plan_edges(close)

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
          plain(ref.fused_eval_ref, cx, cy, src, dst, w, uidx), torch.float32)
    # an index out of range yields NaN instead of a read out of bounds
    bad = fused_eval.fused_eval(cx, cy, src_buf[: n + 1], dst_buf[: n + 1],
                                coords(n + 1).abs(), uidx)
    torch.cuda.synchronize()
    if not torch.isnan(bad).all():
        raise AssertionError("fused_eval: an out-of-range net index did not yield NaN")
    return errs, n_cases


def check_plan_edges(close):
    """wirelength2, maxbbox and fused_eval against their plain versions at
    the edges of their designs and at every row count of PLAN_ROWS, f32 and
    bf16, directly and under `torch.func.vmap` (the row axis mapped); then
    fused_eval at the largest G its plan takes."""
    import torch

    from repro_torch.kernels import bbox, fused_eval, ref, wirelength

    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def coords(*shape):
        return torch.randn(*shape, generator=gen, device="cuda") * 50

    wl_rows = torch.func.vmap(wirelength.wirelength2, in_dims=(0, 0, 0, 0, None))
    wl_rows_w = torch.func.vmap(wirelength.wirelength2)
    bb_rows = torch.func.vmap(bbox.maxbbox)
    for dtype in (torch.float32, torch.bfloat16):
        for n in WL_EDGE_NETS:
            for p in PLAN_ROWS:
                xs = [coords(p, n).to(dtype) for _ in range(4)]
                for w, rows in (((coords(n).abs() * 0.1).to(dtype), wl_rows),
                                ((coords(p, n).abs() * 0.1).to(dtype), wl_rows_w)):
                    want = plain(ref.wirelength2_ref, *xs, w)
                    close("wirelength2", wirelength.wirelength2(*xs, w), want, dtype)
                    close("wirelength2", rows(*xs, w), want, dtype)
        for u, b in BBOX_EDGE_UNITS:
            for p in PLAN_ROWS:
                ux, uy = coords(p, u, b).to(dtype), coords(p, u, b).to(dtype)
                want = plain(ref.maxbbox_ref, ux, uy)
                close("maxbbox", bbox.maxbbox(ux, uy), want, dtype)
                close("maxbbox", bb_rows(ux, uy), want, dtype)
        for g, n, u, b in FE_EDGE_SHAPES:
            tabs = eval_tables(gen, g, n, u, b, dtype)
            fe_rows = torch.func.vmap(lambda x, y: fused_eval.fused_eval(x, y, *tabs))
            for p in PLAN_ROWS:
                cx, cy = coords(p, g).to(dtype), coords(p, g).to(dtype)
                want = plain(ref.fused_eval_ref, cx, cy, *tabs)
                close("fused_eval", fused_eval.fused_eval(cx, cy, *tabs), want, dtype)
                close("fused_eval", fe_rows(cx, cy), want, dtype)
    g = fused_eval.MAX_GIDS
    cx, cy = coords(2, g), coords(2, g)
    tabs = eval_tables(gen, g, 3, 1, 1, torch.float32)
    close("fused_eval", fused_eval.fused_eval(cx, cy, *tabs),
          plain(ref.fused_eval_ref, cx, cy, *tabs), torch.float32)


def eval_tables(gen, g, n, u, b, dtype):
    """fused_eval's tables of `n` nets and `u` units of `b` blocks over `g`
    gids on the card, drawn from `gen`: (src, dst, w, uidx)."""
    import torch

    def ints(*shape):
        return torch.randint(0, g, shape, generator=gen, device="cuda", dtype=torch.int32)

    w = (torch.rand(n, generator=gen, device="cuda") * 0.1).to(dtype)
    return ints(n), ints(n), w, ints(u, b)


def check_batch_invariance():
    """Each row of an [INVARIANCE_ROWS, ...] input gives the same bits
    alone ([1, ...]), inside an [INVARIANCE_SLICE, ...] slice at another
    offset (unaligned where N is odd) and in the whole batch, directly and
    under vmap: wirelength2 at every N of WL_EDGE_NETS with w [N] and
    [P, N], maxbbox at every (U, B) of BBOX_EDGE_UNITS, fused_eval at every
    (G, N, U, B) of FE_INVARIANCE_SHAPES, f32 and bf16.  Returns the number
    of rows checked."""
    import torch

    from repro_torch.kernels import bbox, fused_eval, wirelength

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, width = INVARIANCE_ROWS, INVARIANCE_SLICE
    # slices [o, o + width) from rows 0, 1, 64, 127, ... and rows - width:
    # every row in one at another position than its own, most of them
    # starting unaligned where N is odd
    offsets = sorted({0, *range(1, rows - width + 1, width - 1), rows - width})
    checked = 0

    def same(what, full, parts):
        torch.cuda.synchronize()
        for name, got, lo in parts:
            if not torch.equal(got, full[lo:lo + got.shape[0]]):
                bad = int((got != full[lo:lo + got.shape[0]]).nonzero()[0, 0]) + lo
                raise AssertionError(f"{what}: row {bad} {name} differs from the whole batch")

    def check(what, fn, vfn, args):
        """fn on rows of args (each [rows, ...]) alone, in slices and whole;
        vfn is fn under vmap over a leading axis split off the rows."""
        full = fn(*args)
        parts = [("alone", torch.cat([fn(*(a[r:r + 1] for a in args)) for r in range(rows)]), 0)]
        parts += [(f"in the slice at {o}", fn(*(a[o:o + width] for a in args)), o)
                  for o in offsets]
        # under vmap: the batch as [rows / width, width, ...], each slice as
        # [4, width / 4, ...], each row alone as [1, 1, ...]
        parts.append(("under vmap, whole",
                      vfn(*(a.reshape(rows // width, width, *a.shape[1:]) for a in args))
                      .flatten(0, 1), 0))
        parts += [(f"under vmap, in the slice at {o}",
                   vfn(*(a[o:o + width].reshape(4, width // 4, *a.shape[1:]) for a in args))
                   .flatten(0, 1), o) for o in offsets]
        parts.append(("alone under vmap", torch.cat(
            [vfn(*(a[r:r + 1].unsqueeze(0) for a in args)).flatten(0, 1) for r in range(rows)]), 0))
        same(what, full, parts)

    for dtype in (torch.float32, torch.bfloat16):
        for n in WL_EDGE_NETS:
            xs = [(torch.randn(rows, n, generator=gen, device="cuda") * 50).to(dtype)
                  for _ in range(4)]
            w = (torch.rand(n, generator=gen, device="cuda") * 5).to(dtype)
            check(f"wirelength2 N={n} {dtype} w [N]",
                  lambda *a: wirelength.wirelength2(*a, w),
                  lambda *a: torch.func.vmap(lambda *b: wirelength.wirelength2(*b, w))(*a), xs)
            wp = (torch.rand(rows, n, generator=gen, device="cuda") * 5).to(dtype)
            check(f"wirelength2 N={n} {dtype} w [P, N]", wirelength.wirelength2,
                  torch.func.vmap(wirelength.wirelength2), [*xs, wp])
            checked += 2 * rows
        for u, b in BBOX_EDGE_UNITS:
            ux, uy = ((torch.randn(rows, u, b, generator=gen, device="cuda") * 50).to(dtype)
                      for _ in range(2))
            check(f"maxbbox ({u}, {b}) {dtype}", bbox.maxbbox, torch.func.vmap(bbox.maxbbox),
                  [ux, uy])
            checked += rows
        for g, n, u, b in FE_INVARIANCE_SHAPES:
            tabs = eval_tables(gen, g, n, u, b, dtype)
            cx, cy = ((torch.randn(rows, g, generator=gen, device="cuda") * 50).to(dtype)
                      for _ in range(2))
            check(f"fused_eval ({g}, {n}, {u}, {b}) {dtype}",
                  lambda x, y: fused_eval.fused_eval(x, y, *tabs),
                  torch.func.vmap(lambda x, y: fused_eval.fused_eval(x, y, *tabs)), [cx, cy])
            checked += rows
    return checked


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


# ------------------------------------------------------------ phase 3d, across processes

def islands_rank(rank, store_path, out_path):
    """One rank of the islands-across-processes phase (a spawned process on
    the card; the kernels come from the parent's build directory):
    `evolve.run(islands=...)` through the default gloo group, then
    `evolve.run_islands`, each with its launches counted; every ring
    exchange's host time is recorded.  Saves its results to `out_path`."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch.core import evolve, nsga2
    from repro_torch.core import islands as TI
    from repro_torch.fpga import device, netlist
    from repro_torch.kernels import bbox, domination, wirelength
    from repro_torch.runtime import compile_cache

    dist.init_process_group("gloo", store=dist.FileStore(store_path, ISL_WORLD), rank=rank,
                            world_size=ISL_WORLD,
                            timeout=datetime.timedelta(seconds=ISL_DIST_TIMEOUT_S))
    try:
        problem = netlist.make_problem(device.get_device(FPGA_DEVICE))
        kernels = {"wirelength2": wirelength.KERNEL, "maxbbox": bbox.KERNEL,
                   "domination": domination.KERNEL}
        exchanges, exchange = [], TI.Ring.exchange

        def timed(self, tree):
            t0 = time.perf_counter()
            out = exchange(self, tree)
            exchanges.append(time.perf_counter() - t0)
            return out

        TI.Ring.exchange = timed
        cfg, icfg = nsga2.NSGA2Config(pop_size=POP), TI.IslandConfig(ISL_P, ISL_MIGRATE)
        # warm-up (the process's first CUDA, cuBLAS and kernel-library work),
        # through the ring: migration fires after generation ISL_MIGRATE
        evolve.run(problem, "nsga2", cfg, torch.Generator(device="cuda").manual_seed(SEED),
                   ISL_MIGRATE, islands=icfg, device="cuda")
        exchanges.clear()
        dist.barrier()
        (st, hist), dt, launches = counted(kernels, lambda: evolve.run(
            problem, "nsga2", cfg, torch.Generator(device="cuda").manual_seed(SEED + 30),
            ISL_GENS, islands=icfg, device="cuda"))
        dist.barrier()
        (rst, rhist), rdt, rlaunches = counted(kernels, lambda: evolve.run_islands(
            problem, "nsga2", cfg, torch.Generator(device="cuda").manual_seed(SEED + 32),
            ISL_DIST_ROUNDS, ISL_DIST_GENS_PER_ROUND, group=dist.group.WORLD, device="cuda"))
        cpu = torch.utils._pytree.tree_map(lambda a: a.cpu(), (st, hist, rst, rhist))
        torch.save(dict(run=cpu[:2], run_islands=cpu[2:], seconds=dt, launches=launches,
                        run_islands_seconds=rdt, run_islands_launches=rlaunches,
                        exchanges=exchanges, nvcc_builds=compile_cache.meter().recompiles),
                   out_path)
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(target, args_of, world: int, timeout_s: float):
    """Start `world` spawned processes target(*args_of(r)), join them
    within `timeout_s` in all; a rank that hangs or fails raises."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=args_of(r)) for r in range(world)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(max(t0 + timeout_s - time.perf_counter(), 0))
    hung = [r for r, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(10)
    if hung or any(proc.exitcode != 0 for proc in procs):
        raise AssertionError(f"{target.__name__}: ranks {hung} hung, exit codes "
                             f"{[proc.exitcode for proc in procs]}")
    return time.perf_counter() - t0


def run_islands_dist_phase(problem, kernels):
    """Islands across ISL_WORLD processes on the one card: their gathered
    states and history against the single-process `evolve.run(islands=...)`
    from the same seed (bit for bit, else integers exactly and floats
    within tol, with the leaves that differ counted), each rank's launches
    by the single-process formula with L = ISL_P / ISL_WORLD islands, ms per
    generation per rank and host ms per ring exchange; then
    `evolve.run_islands` over the ranks (finite history, a legal
    champion).  A rank that fails or hangs fails the phase."""
    import tempfile

    import torch

    from repro_torch.core import evolve, nsga2
    from repro_torch.core import islands as TI

    cfg, icfg = nsga2.NSGA2Config(pop_size=POP), TI.IslandConfig(ISL_P, ISL_MIGRATE)
    want, single_s, _ = counted(kernels, lambda: evolve.run(
        problem, "nsga2", cfg, torch.Generator(device="cuda").manual_seed(SEED + 30), ISL_GENS,
        islands=icfg, device="cuda"))
    want = torch.utils._pytree.tree_map(lambda a: a.cpu(), want)
    with tempfile.TemporaryDirectory() as tmp:
        outs = [Path(tmp) / f"rank{r}.pt" for r in range(ISL_WORLD)]
        wall = spawn_ranks(islands_rank, lambda r: (r, str(Path(tmp) / "store"), str(outs[r])),
                           ISL_WORLD, ISL_DIST_TIMEOUT_S)
        ranks = [torch.load(o, weights_only=False) for o in outs]
    per = ISL_P // ISL_WORLD
    out, paths = dict(wall_s=wall, single_ms_per_gen=single_s / ISL_GENS * 1e3, ranks=[]), {}
    for r, res in enumerate(ranks):
        got_l = torch.utils._pytree.tree_leaves(res["run"])
        want_l = torch.utils._pytree.tree_leaves(want)
        differ = sum(not torch.equal(a, b) for a, b in zip(got_l, want_l, strict=True))
        if differ:
            same_run(f"islands rank {r}", res["run"][0], want[0])
            torch.testing.assert_close(res["run"][1], want[1], **tol(torch.float32))
        paths[f"islands_{ISL_WORLD}proc_rank{r}"] = expect_launches(
            f"islands rank {r}", res["launches"] | {"fused_eval": 0, "domination+counts": 0,
                                                    "flash_attention": 0},
            {"wirelength2": per + ISL_GENS, "maxbbox": per + ISL_GENS,
             "domination": 2 * ISL_GENS})
        n = ISL_DIST_ROUNDS * ISL_DIST_GENS_PER_ROUND
        paths[f"run_islands_{ISL_WORLD}proc_rank{r}"] = expect_launches(
            f"run_islands rank {r}", res["run_islands_launches"] | {
                "fused_eval": 0, "domination+counts": 0, "flash_attention": 0},
            {"wirelength2": 1 + n, "maxbbox": 1 + n, "domination": 2 * n})
        rst, rhist = res["run_islands"]
        if rhist.shape != (ISL_DIST_ROUNDS, ISL_WORLD, 2) or not torch.isfinite(rhist).all():
            raise AssertionError(f"run_islands rank {r}: history not finite "
                                 f"[{ISL_DIST_ROUNDS}, {ISL_WORLD}, 2]")
        if r == 0:
            g, objs = TI.best_genotype(problem, "nsga2", torch.utils._pytree.tree_map(
                lambda a: a.cuda(), rst))
            check_champion(problem, g, objs)
        ex = res["exchanges"]
        out["ranks"].append(dict(
            leaves_differ=differ, leaves=len(want_l), ms_per_gen=res["seconds"] / ISL_GENS * 1e3,
            exchanges=len(ex), exchange_ms_mean=sum(ex) / len(ex) * 1e3,
            exchange_ms_max=max(ex) * 1e3, run_islands_s=res["run_islands_seconds"],
            nvcc_builds=res["nvcc_builds"],
            run_islands_best=float(rhist[-1].prod(-1).min())))
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


# ------------------------------------------------------------ phase 3g

def non_increasing(what, hist):
    """A history's best combined metric never rises."""
    import torch

    from repro_torch.core import objectives as O

    comb = O.combined_metric(torch.as_tensor(hist).cpu())
    if not (torch.isfinite(comb).all() and (comb[1:] <= comb[:-1]).all()):
        raise AssertionError(f"{what}: history is not finite and non-increasing")


def unfused(evals: int, ranks: int = 0):
    """Launches of `evals` unfused evaluations and `ranks` NSGA-II sorts."""
    return {"wirelength2": evals, "maxbbox": evals, "domination": ranks}


def run_runners(kernels):
    """Table I, Table II and Figs. 7-9 through `repro_torch.benchmarks` at
    their quick budgets (Fig. 8 at FIG8_STEPS steps a chain), each in one
    counted window; returns ({runner: result}, {runner: seconds}, paths)."""
    import torch

    from repro_torch.benchmarks import (fig7_convergence, fig8_cooling, fig9_pipelining,
                                        table1, table2_transfer)
    from repro_torch.core import objectives as O
    from repro_torch.fpga import device, netlist

    out, secs, paths = {}, {}, {}
    problem = netlist.make_problem(device.get_device(FPGA_DEVICE))

    # Table I: NSGA-II, NSGA-II reduced, CMA-ES, GA, then an SA chain
    s = table1.QUICK_SCALE
    gens = {"nsga2": int(table1.NSGA2_GENS * s), "nsga2_reduced": int(table1.NSGA2_GENS * s),
            "cmaes": int(table1.CMAES_GENS * s), "ga": int(table1.GA_GENS * s),
            "sa": int(table1.SA_STEPS * s)}
    pops = {"nsga2": 48, "nsga2_reduced": 48, "cmaes": 24, "ga": 48, "sa": 1}
    rows, secs["table1"], launches = counted(
        kernels, lambda: table1.run(quick=True, dev=FPGA_DEVICE, torch_device="cuda"))
    evals = sum(n + (k != "cmaes") for k, n in gens.items())
    paths["table1"] = expect_launches("table1", launches,
                                      unfused(evals, 2 * (gens["nsga2"] + gens["nsga2_reduced"])))
    if sorted(rows) != sorted(table1.PAPER):
        raise AssertionError(f"table1: methods {list(rows)}")
    for name, row in rows.items():
        if row["evaluations"] != gens[name] * pops[name] or row["history"].shape != (gens[name], 2):
            raise AssertionError(f"table1 {name}: {row['evaluations']} evaluations, history "
                                 f"{tuple(row['history'].shape)}")
        non_increasing(f"table1 {name}", row["history"])
        check_champion(problem, row["champion"], torch.tensor([row["wl2"], row["max_bbox"]]))
    out["table1"] = rows

    # Table II: xcvu3p, then scratch and warm on each target
    n = table2_transfer.QUICK_GENS
    rows, secs["table2"], launches = counted(
        kernels, lambda: table2_transfer.run(quick=True, torch_device="cuda"))
    runs = 1 + 2 * len(table2_transfer.TARGETS)
    paths["table2"] = expect_launches("table2", launches, unfused(runs * (n + 1), runs * 2 * n))
    if list(rows) != list(table2_transfer.TARGETS):
        raise AssertionError(f"table2: targets {list(rows)}")
    src = netlist.make_problem(device.get_device(table2_transfer.SEED_DEVICE))
    for name, r in rows.items():
        dst = netlist.make_problem(device.get_device(name))
        O.assert_valid(src, r["g_seed"])
        for k in ("scratch", "transfer"):
            O.assert_valid(dst, r[f"g_{k}"])
            non_increasing(f"table2 {name} {k}", r[f"hist_{k}"])
            if r[f"evals_{k}"] % table2_transfer.POP or not 0 < r[f"evals_{k}"] <= n * table2_transfer.POP:
                raise AssertionError(f"table2 {name}: evals_{k} {r[f'evals_{k}']}")
        first = {k: float(r[f"hist_{k}"][0].prod()) for k in ("scratch", "transfer")}
        if not first["transfer"] <= first["scratch"]:
            raise AssertionError(f"table2 {name}: the warm start's first generation "
                                 f"{first['transfer']} is worse than scratch's {first['scratch']}")
        r["first"] = first
    out["table2"] = rows

    # Fig. 7: the four population methods and an SA chain
    s = fig7_convergence.QUICK_SCALE
    gens = {k: int(v * s) for k, v in fig7_convergence.GENS.items()}
    n_sa = int(fig7_convergence.SA_STEPS * s)
    hists, secs["fig7"], launches = counted(
        kernels, lambda: fig7_convergence.run(quick=True, dev=FPGA_DEVICE, torch_device="cuda"))
    evals = sum(v + (k != "cmaes") for k, v in gens.items()) + n_sa + 1
    paths["fig7"] = expect_launches("fig7", launches,
                                    unfused(evals, 2 * (gens["nsga2"] + gens["nsga2_reduced"])))
    want = {**{k: (v, {"cmaes": 24}.get(k, 32)) for k, v in gens.items()}, "sa": (n_sa, 1)}
    for name, (hist, per_gen) in hists.items():
        if (len(hist), per_gen) != want.pop(name):
            raise AssertionError(f"fig7 {name}: {len(hist)} rows of {per_gen}")
        non_increasing(f"fig7 {name}", hist)
    if want:
        raise AssertionError(f"fig7: no history for {sorted(want)}")
    out["fig7"] = hists

    # Fig. 8: the four schedules x four parameter sets, FIG8_STEPS steps a chain
    quick_steps = fig8_cooling.QUICK_STEPS
    fig8_cooling.QUICK_STEPS = FIG8_STEPS
    try:
        rows, secs["fig8"], launches = counted(
            kernels, lambda: fig8_cooling.run(quick=True, dev=FPGA_DEVICE, torch_device="cuda"))
    finally:
        fig8_cooling.QUICK_STEPS = quick_steps
    chains = sum(len(v) for v in fig8_cooling.PARAM_SETS.values())
    paths["fig8"] = expect_launches("fig8", launches, unfused(chains * (FIG8_STEPS + 1)))
    if len(rows) != chains or not all(math.isfinite(r[4]) and r[4] > 0 for r in rows):
        raise AssertionError(f"fig8: rows {rows}")
    out["fig8"] = rows

    # Fig. 9: NSGA-II, CMA-ES, SA and a random genotype, then the depth sweep
    s = fig9_pipelining.QUICK_SCALE
    g_n, g_c, n_sa = (int(v * s) for v in (fig9_pipelining.NSGA2_GENS,
                                           fig9_pipelining.CMAES_GENS, fig9_pipelining.SA_STEPS))
    (prob9, placements), secs["fig9"], launches = counted(
        kernels, lambda: fig9_pipelining.best_placements(quick=True, dev=FPGA_DEVICE,
                                                         torch_device="cuda"))
    paths["fig9"] = expect_launches("fig9", launches, unfused(g_n + 1 + g_c + n_sa + 1, 2 * g_n))
    sweeps = fig9_pipelining.sweeps(prob9, placements)
    for name, g in placements.items():
        O.assert_valid(prob9, g)
        mhz = [sweeps[name][d]["freq_mhz"] for d in range(5)]
        if mhz != sorted(mhz):
            raise AssertionError(f"fig9 {name}: MHz by depth {mhz}")
    out["fig9"] = sweeps
    return out, secs, paths


def print_runners(paper, secs, by_path):
    """The runners' tables, as each runner's `report` prints them (Fig. 7:
    each method's first and last generation), with seconds and launches."""
    import io

    from repro_torch.benchmarks import fig8_cooling, fig9_pipelining, table1, table2_transfer

    def indented(report, result):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            report(result)
        for line in text.getvalue().splitlines():
            if line:
                print(f"    {line}")

    rows = paper["table1"]
    print(f"  Table I on {FPGA_DEVICE} ({secs['table1']:.3f} s; launches {by_path['table1']}):")
    indented(table1.report, rows)
    print("    runtime against the paper's: " + ", ".join(
        f"{k} {v['runtime_s']:.3f} s / {table1.PAPER[k][0]} s" for k, v in rows.items()))
    print(f"  Table II ({secs['table2']:.3f} s; launches {by_path['table2']}):")
    indented(table2_transfer.report, paper["table2"])
    for name, r in paper["table2"].items():
        print(f"    {name}: speedup {r['speedup']:.2f}, MHz delta "
              f"{r['mhz_transfer'] - r['mhz_scratch']:+.3f} "
              f"({100 * (r['mhz_transfer'] / r['mhz_scratch'] - 1):+.2f}%), first-generation best "
              f"scratch {r['first']['scratch']:.4e}, warm {r['first']['transfer']:.4e}")
    print(f"  Fig. 7 ({secs['fig7']:.3f} s; launches {by_path['fig7']}):")
    for name, (h, per_gen) in paper["fig7"].items():
        print(f"    {name}: {len(h)} generations of {per_gen} evaluations; wl2, bbox "
              f"{h[0, 0]:.4g}, {h[0, 1]:.1f} -> {h[-1, 0]:.4g}, {h[-1, 1]:.1f}; combined "
              f"{h[0, 0] * h[0, 1]:.4e} -> {h[-1, 0] * h[-1, 1]:.4e}")
    print(f"  Fig. 8 ({secs['fig8']:.3f} s, {FIG8_STEPS} steps a chain; launches "
          f"{by_path['fig8']}):")
    indented(fig8_cooling.report, paper["fig8"])
    print(f"  Fig. 9 ({secs['fig9']:.3f} s; launches {by_path['fig9']}):")
    indented(fig9_pipelining.report, paper["fig9"])


# example -> lines its output at its defaults must hold
EXAMPLES = {
    "placement_service": ("1 step compile(s)", "champion placement validated legal"),
    "placement_transfer": ("seed champion: wl2=", "xcvu9p: migrated seed wl2="),
    "placement_islands": ("(identical to single-population: True)",),
    "placement_cache": ("0 generations, no slot burned", "a fresh store reloads 2"),
    "placement_fleet": ("fleet: 9 jobs across 9 pools", "every pool stepped at one slot count"),
    "placement_async": ("submit->result latency:", "sizes/step-compiles [4]x1"),
    "serve_lm": ("arch=yi-6b slots=4 requests=6", "tokens in "),
}


def run_examples(kernels):
    """Every example's main() on the card at its own defaults, each in one
    counted window; returns ({example: (seconds, output)}, paths)."""
    import importlib
    import io

    from repro_torch.configs import get_reduced
    from repro_torch.examples import placement_transfer

    out, paths = {}, {}
    for name, lines in EXAMPLES.items():
        main = importlib.import_module(f"repro_torch.examples.{name}").main
        text = io.StringIO()

        def run():
            with contextlib.redirect_stdout(text):
                main([])

        _, dt, launches = counted(kernels, run)
        text = text.getvalue()
        missing = [line for line in lines if line not in text]
        if missing:
            raise AssertionError(f"{name}: output lacks {missing}:\n{text}")
        if name == "serve_lm":      # one prefill of each of its 6 requests
            want = {"flash_attention": get_reduced("yi-6b").n_layers * 6}
        elif name == "placement_transfer":
            # the seed run, then per target two evaluations, the seeded
            # population's and GENS // 4 generations
            g, q = placement_transfer.GENS, placement_transfer.GENS // 4
            want = unfused(g + 1 + 3 * (3 + q), 2 * g + 3 * 2 * q)
        else:
            # the number of generations depends on targets and timing: the
            # path's kernels launch, and no other
            want = {k: launches[k] for k in ("wirelength2", "maxbbox", "domination")}
            if not all(want.values()):
                raise AssertionError(f"{name}: kernels not launched: {launches}")
        paths[f"example_{name}"] = expect_launches(name, launches, want)
        out[name] = (dt, text)
    return out, paths


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


def device_profile(fn, symbol: str, iters: int = 50, traces: int = 12):
    """(device ms, device ops) of one call of `fn`, from a torch.profiler
    trace: the kernels whose names hold `symbol` and every memset or copy
    the call issues besides (domination's launcher zeroes its counts with
    a memset above 256 rows), divided by the launches of `symbol`.  A trace
    now and then comes back without the kernel's events (eight in a row,
    half a second apart, at several shapes of one run); up to `traces` are
    taken, a second apart, and (None, None) means none of them showed it."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(traces):
        if attempt:
            time.sleep(1.0)
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


def device_ms(fn, symbol: str, iters: int = 50, traces: int = 12):
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
                       *eval_work(p, g, n, u, b)),
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


def plan_figures(problem):
    """wirelength2, maxbbox and fused_eval at the main path's width (N =
    problem's nets; U, B its units and blocks; G its gids) and at the floor
    (N = FLOOR_NETS, (U, B) = FLOOR_UNITS, (G, N, U, B) = FLOOR_EVAL) over
    FIGURE_ROWS: per call (CUDA events), device time and ops, bound and
    plain version."""
    import torch

    from repro_torch.core.tables import problem_tensors
    from repro_torch.kernels import bbox, fused_eval, ref, wirelength

    n, u = problem.n_nets, problem.n_units
    b = problem.n_blocks // u
    tabs = problem_tensors(problem, "cuda")
    path_tabs = (tabs.net_src, tabs.net_dst, tabs.net_w, tabs.unit_index)
    floor_tabs = eval_tables(torch.Generator(device="cuda").manual_seed(SEED), *FLOOR_EVAL,
                             torch.float32)
    out = {"wirelength2": {}, "maxbbox": {}, "fused_eval": {}}

    def record(name, key, kern, plain, nbytes, nops):
        bms, by_what = bound_ms(nbytes, nops)
        dev, ops = device_profile(kern, SYMBOLS[name])
        out[name][key] = dict(ms=time_ms(kern), device_ms=dev, device_ops=ops,
                              bound_ms=bms, bound_by=by_what, plain_ms=time_ms(plain))

    for p in FIGURE_ROWS:
        for label, nn in (("path", n), ("floor", FLOOR_NETS)):
            xs = [torch.rand(p, nn, device="cuda") * 100 for _ in range(4)]
            w = torch.rand(nn, device="cuda")
            record("wirelength2", f"{label} [{p}, {nn}]",
                   lambda xs=xs, w=w: wirelength.wirelength2(*xs, w),
                   lambda xs=xs, w=w: ref.wirelength2_ref(*xs, w),
                   16 * p * nn + 4 * nn + 4 * p, 8 * p * nn)
        for label, (uu, bb) in (("path", (u, b)), ("floor", FLOOR_UNITS)):
            ux, uy = (torch.rand(p, uu, bb, device="cuda") * 100 for _ in range(2))
            record("maxbbox", f"{label} [{p}, {uu}, {bb}]",
                   lambda ux=ux, uy=uy: bbox.maxbbox(ux, uy),
                   lambda ux=ux, uy=uy: ref.maxbbox_ref(ux, uy),
                   8 * p * uu * bb + 4 * p, p * (4 * uu * bb + 3 * uu))
        for label, t in (("path", path_tabs), ("floor", floor_tabs)):
            (g, nn), (uu, bb) = (problem.n_blocks if label == "path" else FLOOR_EVAL[0],
                                 t[0].shape[0]), t[3].shape
            bx, by = (torch.rand(p, g, device="cuda") * 100 for _ in range(2))
            record("fused_eval", f"{label} [{p}, {g}]",
                   lambda bx=bx, by=by, t=t: fused_eval.fused_eval(bx, by, *t),
                   lambda bx=bx, by=by, t=t: ref.fused_eval_ref(bx, by, *t),
                   *eval_work(p, g, nn, uu, bb))
    return out


def eval_work(p, g, n, u, b):
    """(bytes, operations) of fused_eval on [p, g] rows in f32: each row
    read once, the tables once, [p, 2] written; ~8 flops a net and 4 a
    block, 3 a unit."""
    return 8 * p * g + 12 * n + 4 * u * b + 8 * p, p * (8 * n + 4 * u * b + 3 * u)


def placement_cases(problem):
    """The four placement wrappers at the main path's shapes ([POP, G]
    coordinates of `problem`, [2 POP, 2] objectives), with what
    `host_split` times of each: the call, the custom op, the implementation,
    its inputs, the reshapes every call made before the launch path was
    trimmed, the output allocation, the Kernel and its C arguments."""
    import torch

    from repro_torch.core.tables import problem_tensors
    from repro_torch.kernels import bbox, domination, fused_eval, wirelength

    tabs = problem_tensors(problem, "cuda")
    s, d, w, uidx = tabs.net_src, tabs.net_dst, tabs.net_w, tabs.unit_index
    p, g, n, (u, b), q = POP, problem.n_blocks, s.shape[0], uidx.shape, 2 * POP
    bx, by = (torch.rand(p, g, device="cuda") * 100 for _ in range(2))
    x1, y1, x2, y2 = (a.index_select(1, idx).contiguous() for idx in (s, d) for a in (bx, by))
    ux, uy = bx.reshape(p, u, b), by.reshape(p, u, b)
    objs = torch.rand(q, 2, device="cuda")
    dev = bx.device
    out_p, out_fe = torch.empty(p, device=dev), torch.empty(p, 2, device=dev)
    dom = torch.empty(q, q, dtype=torch.bool, device=dev)
    wl, bb, fe = wirelength.plan(p, n), bbox.plan(p, u, b), fused_eval.plan(p, g, n, u, b)
    return {
        "wirelength2": dict(
            call=lambda: wirelength.wirelength2(x1, y1, x2, y2, w),
            op=lambda: wirelength._op(x1, y1, x2, y2, w),
            impl=lambda: wirelength._wirelength2(x1, y1, x2, y2, w),
            inputs=(x1, y1, x2, y2, w), floats=(x1, y1, x2, y2, w), ints=(),
            reshape=lambda: ([a.reshape(-1, n).contiguous() for a in (x1, y1, x2, y2)],
                             w.contiguous(), out_p.reshape(p)),
            empty=lambda: torch.empty(p, dtype=torch.float32, device=dev),
            kernel=wirelength.KERNEL,
            args=(x1.data_ptr(), y1.data_ptr(), x2.data_ptr(), y2.data_ptr(), w.data_ptr(), 0,
                  out_p.data_ptr(), p, n, wl.threads)),
        "maxbbox": dict(
            call=lambda: bbox.maxbbox(ux, uy), op=lambda: bbox._op(ux, uy),
            impl=lambda: bbox._maxbbox(ux, uy), inputs=(ux, uy), floats=(ux, uy), ints=(),
            reshape=lambda: (ux.reshape(p, u, b).contiguous(), uy.reshape(p, u, b).contiguous(),
                             out_p.reshape(p)),
            empty=lambda: torch.empty(p, dtype=torch.float32, device=dev),
            kernel=bbox.KERNEL,
            args=(ux.data_ptr(), uy.data_ptr(), out_p.data_ptr(), p, u, b, bb.tile_units, bb.sub,
                  bb.threads)),
        "fused_eval": dict(
            call=lambda: fused_eval.fused_eval(bx, by, s, d, w, uidx),
            op=lambda: fused_eval._op(bx, by, s, d, w, uidx),
            impl=lambda: fused_eval._fused_eval(bx, by, s, d, w, uidx),
            inputs=(bx, by, s, d, w, uidx), floats=(bx, by, w), ints=(s, d, uidx),
            reshape=lambda: (bx.contiguous(), by.contiguous()),
            empty=lambda: torch.empty(p, 2, dtype=torch.float32, device=dev),
            kernel=fused_eval.KERNEL,
            args=(bx.data_ptr(), by.data_ptr(), s.data_ptr(), d.data_ptr(), w.data_ptr(),
                  uidx.data_ptr(), out_fe.data_ptr(), p, g, n, u, b, fe.threads,
                  fe.unit_threads, fe.sub)),
        "domination": dict(
            call=lambda: domination.domination(objs), op=lambda: domination._op(objs),
            impl=lambda: domination._domination(objs), inputs=(objs,), floats=(objs,), ints=(),
            reshape=lambda: objs.contiguous(),
            empty=lambda: torch.empty(q, q, dtype=torch.bool, device=dev),
            kernel=domination.KERNEL,
            args=(objs.data_ptr(), dom.data_ptr(), None, 1, q, 2)),
    }


def host_split(problem, iters: int = 1000):
    """Host µs per call of each placement wrapper at the main path's shape,
    by stage: `time.perf_counter` over `iters` calls with no
    synchronisation, and the profiler's CPU self times of `iters` calls.
    The stages the launch path dropped are timed as they ran before
    ("..._before"): the custom op's dispatcher (now skipped where `direct`
    allows), the views of the inputs and the output, `torch.cuda.device`
    around `torch.cuda.current_stream`, and `library()` + `getattr` per call.
    The counts of the launches made here are not read by any check."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import _build

    def us(fn):
        for _ in range(10):
            fn()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        t = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        return t

    out = {}
    for name, c in placement_cases(problem).items():
        k, dev = c["kernel"], c["inputs"][0].device
        idx, lib = dev.index, _build.library(k.name)
        stream = torch._C._cuda_getCurrentRawStream(idx)
        fn = k.entry("f32")

        def stream_before(dev=dev):
            with torch.cuda.device(dev):
                return torch.cuda.current_stream(dev).cuda_stream

        split = {
            "call": us(c["call"]),
            "custom_op_before": us(c["op"]),
            "implementation": us(c["impl"]),
            "direct": us(lambda c=c: _build.direct(*c["inputs"])),
            "reshapes_before": us(c["reshape"]),
            "checks": us(lambda c=c, name=name: _build.check_inputs(
                name, floats=c["floats"], ints=c["ints"])),
            "empty": us(c["empty"]),
            "device_and_stream_before": us(stream_before),
            "device_and_stream": us(lambda idx=idx: idx == torch.cuda.current_device()
                                    and torch._C._cuda_getCurrentRawStream(idx)),
            "entry_before": us(lambda lib=lib, k=k: getattr(lib, f"{k.name}_f32")),
            "entry": us(lambda k=k: k.entry("f32")),
            "ctypes_call": us(lambda fn=fn, c=c: fn(*c["args"], stream)),
            "launch": us(lambda k=k, c=c, dev=dev: k.launch(torch.float32, dev, *c["args"])),
        }
        split["dispatch_saved"] = split["custom_op_before"] - split["implementation"]
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(iters):
                c["call"]()
        torch.cuda.synchronize()
        top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:6]
        split["profiler_cpu_self_us"] = {e.key: e.self_cpu_time_total / iters for e in top}
        out[name] = split
    return out


def launch_path(problem, iters: int = 1000):
    """Per call of each placement wrapper at the main path's shape, of
    wirelength2, maxbbox and fused_eval at 2048 rows and at the floor, and
    of fused_eval at the baselines' and the transfer's shapes: host
    µs (`time.perf_counter` over `iters` calls, no synchronisation), µs with
    CUDA events back to back, and device µs and ops (fused_eval must issue
    one op per call).  Only the public wrappers are called, so the same
    function times another tree's port (`--launch-path --src DIR`)."""
    import torch

    from repro_torch.core.tables import problem_tensors
    from repro_torch.fpga import device, netlist
    from repro_torch.kernels import bbox, domination, fused_eval, wirelength

    tabs = problem_tensors(problem, "cuda")
    s, d, w, uidx = tabs.net_src, tabs.net_dst, tabs.net_w, tabs.unit_index
    p, g, n, (u, b) = POP, problem.n_blocks, s.shape[0], uidx.shape
    bx, by = (torch.rand(p, g, device="cuda") * 100 for _ in range(2))
    x1, y1, x2, y2 = (a.index_select(1, idx).contiguous() for idx in (s, d) for a in (bx, by))
    ux, uy = bx.reshape(p, u, b), by.reshape(p, u, b)
    objs = torch.rand(2 * p, 2, device="cuda")
    calls = {"wirelength2": lambda: wirelength.wirelength2(x1, y1, x2, y2, w),
             "maxbbox": lambda: bbox.maxbbox(ux, uy),
             "fused_eval": lambda: fused_eval.fused_eval(bx, by, s, d, w, uidx),
             "domination": lambda: domination.domination(objs),
             "domination_counts": lambda: domination.domination_counts(objs)}
    # wirelength2 and maxbbox at 2048 rows and at the floor, 64 rows
    big = [torch.rand(2048, n, device="cuda") for _ in range(4)]
    floor = [torch.rand(p, FLOOR_NETS, device="cuda") for _ in range(5)]
    ubig = [torch.rand(2048, u, b, device="cuda") for _ in range(2)]
    ufloor = [torch.rand(p, *FLOOR_UNITS, device="cuda") for _ in range(2)]
    # fused_eval at 2048 rows of the path's width, at the floor (64 rows),
    # at the baselines' rows and at the transfer's width and rows
    gbig = [torch.rand(2048, g, device="cuda") for _ in range(2)]
    gfloor = [torch.rand(p, FLOOR_EVAL[0], device="cuda") for _ in range(2)]
    ftabs = eval_tables(torch.Generator(device="cuda").manual_seed(SEED), *FLOOR_EVAL,
                        torch.float32)
    for rows in (1, CMAES_POP, GA_POP):
        gx = [torch.rand(rows, g, device="cuda") for _ in range(2)]
        calls[f"fused_eval [{rows}, {g}]"] = lambda gx=gx: fused_eval.fused_eval(*gx, s, d, w, uidx)
    dst_tabs = problem_tensors(netlist.make_problem(device.get_device(TRANSFER_DST)), "cuda")
    t9 = (dst_tabs.net_src, dst_tabs.net_dst, dst_tabs.net_w, dst_tabs.unit_index)
    g9 = [torch.rand(TRANSFER_POP, dst_tabs.unit_index.numel(), device="cuda") for _ in range(2)]
    calls[f"fused_eval [{TRANSFER_POP}, {g9[0].shape[1]}]"] = lambda: fused_eval.fused_eval(*g9, *t9)
    calls.update({
        f"wirelength2 [2048, {n}]": lambda: wirelength.wirelength2(*big, w),
        f"wirelength2 [{p}, {FLOOR_NETS}]": lambda: wirelength.wirelength2(*floor[:4], floor[4][0]),
        f"maxbbox [2048, {u}, {b}]": lambda: bbox.maxbbox(*ubig),
        f"maxbbox [{p}, {FLOOR_UNITS[0]}, {FLOOR_UNITS[1]}]": lambda: bbox.maxbbox(*ufloor),
        f"fused_eval [2048, {g}]": lambda: fused_eval.fused_eval(*gbig, s, d, w, uidx),
        f"fused_eval [{p}, {FLOOR_EVAL[0]}]": lambda: fused_eval.fused_eval(*gfloor, *ftabs)})
    out = {}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t0) / iters * 1e6
        torch.cuda.synchronize()
        dev, ops = device_profile(fn, SYMBOLS[name.split()[0]])
        if name.startswith("fused_eval") and ops != 1.0:
            raise AssertionError(f"{name}: {ops} device ops per call, expected 1 "
                                 "(None: no trace showed the kernel)")
        out[name] = dict(host_us=host, event_us=time_ms(fn) * 1e3,
                         device_us=None if dev is None else dev * 1e3, device_ops=ops)
    return out


def profiled(fn, reps: int):
    """`reps` calls of `fn` under torch.profiler: (host-clock µs, device ops
    per call, the device's busy share -- kernel time over wall time -- and
    the profile)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, busy_us = device_kernels(prof)
    return wall_us, len(kernels) / reps, (busy_us / wall_us if kernels else None), prof


def device_kernels(prof):
    """A profile's device ops -- its CUDA events less the model spans'
    (`SPANS`) own device rows -- and their busy µs: the one rule that
    `profiled`, `device_trace` and `serving_profile` count ops and busy
    time by."""
    from torch.autograd import DeviceType

    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and e.name not in SPANS]
    return kernels, sum(e.time_range.elapsed_us() for e in kernels)


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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels, busy_us = device_kernels(prof)
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


def run_serving(kernels, cfg, prompt_lens=SERVE_PROMPTS, slots=SERVE_SLOTS,
                max_len=SERVE_MAX_LEN, max_new=SERVE_MAX_NEW):
    """Serve prompts of `prompt_lens` tokens through the Engine (weights
    from seed SEED); returns the launches, figures and the model (for the
    logits check)."""
    import numpy as np
    import torch

    from repro_torch.models.transformer import Transformer
    from repro_torch.serve.engine import Engine

    t0 = time.perf_counter()
    model = Transformer(cfg, device="cuda", dtype=torch.float32,
                        generator=torch.Generator(device="cuda").manual_seed(SEED))
    eng = Engine(model, n_slots=slots, max_len=max_len, eos_id=-1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32) for n in prompt_lens]

    # Engine.generate's loop, with each prefill and each step timed (both
    # end in a host read of the sampled tokens, so the clock is synchronised)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    queue, rid_of, results = list(range(len(prompts))), {}, {}
    prefill_s, ttft_s, decode_s, decode_tokens, steps = {}, {}, 0.0, 0, 0
    start = time.perf_counter()
    while queue or eng.active.any():
        while queue:
            t0 = time.perf_counter()
            rid = eng.submit(prompts[queue[0]], max_new)
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
        steps += 1
        for req in done:
            results[rid_of[req.rid]] = req.out
    wall_s = time.perf_counter() - start
    launches = {n: k.launches for n, k in kernels.items()}
    peak = torch.cuda.max_memory_allocated()

    if sorted(results) != list(range(len(prompts))):
        raise AssertionError(f"served {sorted(results)} of {len(prompts)} requests")
    for i, out in results.items():
        if len(out) != max_new or not all(0 <= t < cfg.vocab for t in out):
            raise AssertionError(f"request {i}: {len(out)} tokens, expected "
                                 f"{max_new} in [0, {cfg.vocab})")
    return dict(cfg=cfg, model=model, prompts=prompts, results=results,
                prompt_lens=tuple(prompt_lens), slots=slots, max_len=max_len,
                max_new=max_new, launches=launches, init_s=init_s, wall_s=wall_s,
                peak_bytes=peak, prefill_s=prefill_s, ttft_s=ttft_s, decode_s=decode_s,
                decode_tokens=decode_tokens, steps=steps)


@contextlib.contextmanager
def recorded_routes():
    """Every MoE layer's top-k indices [T, k] in call order while open."""
    from repro_torch.models import moe
    routes, route = [], moe.MoE.route

    def recording(self, xf, *args):
        out = route(self, xf, *args)
        routes.append(out[0])
        return out

    moe.MoE.route = recording
    try:
        yield routes
    finally:
        moe.MoE.route = route


def check_serving_logits(served, lengths, frontend: bool = False):
    """The last-token prefill logits of the prompts of `lengths` tokens
    through the kernel and through the plain attention, on the card; with
    `frontend`, also the shortest prompt behind the config's stub frontend
    embeddings (`stubs.synth_frontend`, seed SEED).  For MoE models, how
    many (token, layer) routes -- sets of top-k experts -- the two runs
    chose differently."""
    import torch

    from repro_torch.models import stubs

    cfg, model, results = served["cfg"], served["model"], served["results"]
    cases = [(n, None) for n in lengths]
    if frontend:
        fe = stubs.synth_frontend(torch.Generator(device="cuda").manual_seed(SEED),
                                  cfg.frontend, 1, cfg.n_frontend_tokens, cfg.d_model,
                                  torch.float32)
        cases.append((min(lengths), fe))
    out = {}
    for n, fe in cases:
        i = served["prompt_lens"].index(n)
        toks = torch.as_tensor(served["prompts"][i], dtype=torch.long, device="cuda")[None]
        max_len = toks.shape[1] + (0 if fe is None else fe.shape[1])
        with recorded_routes() as kern_routes:
            kern = model.prefill(toks, max_len, fe)[0][0]
        with plain_attention(), recorded_routes() as plain_routes:
            plain = model.prefill(toks, max_len, fe)[0][0]
        torch.cuda.synchronize()
        key = n if fe is None else f"{n}+{fe.shape[1]} frontend"
        if not torch.isfinite(kern).all():
            raise AssertionError(f"prompt {key}: non-finite logits")
        flips = sum(int((a.sort(-1).values != b.sort(-1).values).any(-1).sum())
                    for a, b in zip(kern_routes, plain_routes))
        torch.testing.assert_close(kern, plain, **LOGITS_TOL,
                                   msg=lambda m: f"prompt of {key} tokens ({flips} routes "
                                                 f"flipped): {m}")
        if int(kern.argmax()) != int(plain.argmax()) or (
                fe is None and int(kern.argmax()) != results[i][0]):
            raise AssertionError(f"prompt {key}: argmax kernel {int(kern.argmax())}, plain "
                                 f"{int(plain.argmax())}, served {results[i][0]}")
        out[key] = dict(max_abs_diff=float((kern - plain).abs().max()),
                        max_abs_logit=float(plain.abs().max()), argmax=int(kern.argmax()))
        if kern_routes:
            out[key].update(routes=sum(r.shape[0] for r in kern_routes), routes_flipped=flips)
    return out


def check_moe_bodies(served):
    """One MoE layer (the middle one) at its real hidden states from the
    longest prompt's prefill: `dispatch` (the model's body) against `dense`
    (the reference's `_apply_reference`), fed the same routes."""
    import torch

    model = served["model"]
    layers = [i for i, b in enumerate(model.blocks) if b.ffn == "moe"]
    layer = layers[len(layers) // 2]
    block = model.blocks[layer].moe
    seen = []
    hook = block.register_forward_pre_hook(lambda mod, args: seen.append(args[0]))
    toks = torch.as_tensor(served["prompts"][served["prompt_lens"].index(
        max(served["prompt_lens"]))], dtype=torch.long, device="cuda")[None]
    try:
        model.prefill(toks, toks.shape[1])
    finally:
        hook.remove()
    xf = seen[0].reshape(-1, seen[0].shape[-1])
    with torch.no_grad():
        inds, gates, _ = block.route(xf)
        got = block.dispatch(xf, inds, gates)
        want = block.dense(xf, inds, gates)
    torch.testing.assert_close(got, want, **MOE_TOL,
                               msg=lambda m: f"layer {layer} dispatch vs dense: {m}")
    counts = torch.bincount(inds.reshape(-1), minlength=block.args.e_phys)
    return dict(layer=layer, tokens=xf.shape[0], max_abs_diff=float((got - want).abs().max()),
                max_abs_y=float(want.abs().max()), experts_used=int((counts > 0).sum()),
                pairs_per_expert_min_max=(int(counts.min()), int(counts.max())))


SPANS = ("moe", "rwkv.wkv", "mamba.scan")


def serving_profile(served, reps: int = 3, prefill_len=None):
    """Where a serving step's time goes: a pool decode step (all slots
    active) and the longest prefill, each under torch.profiler -- host-clock
    ms per call, the device's busy share, the top kernels by device time
    (ms per call), the host syncs of a decode step (and the host's time
    blocked in them), each model span's (`SPANS`) share of device and host
    time, and flash attention's device µs per launch.  `prefill_len`
    picks another prompt than the longest for the prefill's trace."""
    import torch
    from torch.autograd import DeviceType

    from repro_torch.serve.engine import Engine

    model, prompts, lens = served["model"], served["prompts"], served["prompt_lens"]
    longest = prompts[lens.index(prefill_len or max(lens))]
    eng = Engine(model, n_slots=served["slots"], max_len=served["max_len"], eos_id=-1)
    for i in range(served["slots"]):
        eng.submit(prompts[i], max_new=reps + 3)
    toks = torch.as_tensor(longest, dtype=torch.long, device="cuda")[None]
    out = {}
    for name, fn in (("decode_step", eng.step),
                     ("prefill_%d" % len(longest),
                      lambda: model.prefill(toks, served["max_len"]))):
        wall_us, ops, busy, prof = profiled(fn, reps)
        top = sorted(((e.device_time_total, e.key) for e in prof.key_averages()
                      if e.device_time_total > 0), reverse=True)[:5]
        kernels, busy_us = device_kernels(prof)
        v = dict(ms=wall_us / reps / 1e3, device_ops=ops, device_busy_share=busy,
                 top_kernels_ms={k[:70]: us / reps / 1e3 for us, k in top})
        for span in SPANS:
            ev = [e for e in prof.events() if e.name == span and e.device_type == DeviceType.CPU]
            if ev:
                v[f"{span}_device_share"] = (sum(e.device_time_total for e in ev) / busy_us
                                             if busy_us else None)
                v[f"{span}_host_share"] = sum(e.cpu_time_total for e in ev) / wall_us
        flash = [e for e in kernels if "flash_attention_kernel" in e.name]
        if flash:
            v["flash_kernel_us_per_launch"] = (sum(e.time_range.elapsed_us() for e in flash)
                                               / len(flash))
            v["flash_launches"] = len(flash) / reps
        if name == "decode_step":
            blocked = [e for e in prof.events() if e.device_type == DeviceType.CPU
                       and e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]
            v["host_blocked_ms"] = sum(e.cpu_time_total for e in blocked) / reps / 1e3
            v["host_syncs"] = host_syncs(fn)[1]
        out[name] = v
    return out


def print_profile(profile):
    for name, v in profile.items():
        extra = {k: v[k] for k in v if k not in ("ms", "device_ops", "device_busy_share",
                                                "top_kernels_ms")}
        print(f"  profile {name}: {v['ms']:.3f} ms per call, {v['device_ops']:.0f} device ops, "
              f"device busy {v['device_busy_share']}; top kernels (ms per call) "
              f"{v['top_kernels_ms']}; {json.dumps(extra)}")


def run_family(kernels, arch, reduced, n_layers, prompt_lens, max_new, slots, profile_len):
    """Serve one family's config through the Engine with exact flash
    launches (attention layers x requests), check its logits through the
    kernel against the plain attention (the shortest prompt, and behind the
    stub frontend for llava / musicgen) and, for MoE models, the dispatch
    body against the dense one; print its figures and profile (one traced
    call each, the prefill of `profile_len` tokens).  Returns the launches
    of the counted run."""
    import dataclasses

    from repro_torch.configs import get_arch, get_reduced

    cfg = get_reduced(arch) if reduced else get_arch(arch)
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    served = run_serving(kernels, cfg, prompt_lens, slots, max(prompt_lens) + max_new, max_new)
    model = served["model"]
    n_attn = sum(b.mixer.startswith("attn") for b in model.blocks)
    launches = expect_launches(f"serving {arch}", served["launches"],
                               {"flash_attention": n_attn * len(prompt_lens)})
    n_prompt = sum(prompt_lens)
    kinds = {}
    for b in model.blocks:
        kinds[f"{b.mixer}+{b.ffn}"] = kinds.get(f"{b.mixer}+{b.ffn}", 0) + 1
    print(f"serving {arch} ({'reduced' if reduced else 'full width'}: {cfg.n_layers} layers "
          f"{kinds}, d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads x {cfg.d_head}, "
          f"d_ff {cfg.d_ff}, experts {cfg.n_routed} top-{cfg.top_k} + {cfg.n_shared} shared at "
          f"{cfg.d_expert}, vocab {cfg.vocab}; {cfg.param_count()} params fp32, built in "
          f"{served['init_s']:.3f} s): {len(prompt_lens)} requests {prompt_lens} over {slots} "
          f"slots, max_len {served['max_len']}, max_new {max_new}; wall {served['wall_s']:.3f} s")
    prefill_s = sum(served["prefill_s"].values())
    print(f"  prefill: {n_prompt} tokens in {prefill_s:.4f} s, {n_prompt / prefill_s:.1f} "
          f"tokens/s; by request (ms, TTFT ms): " + ", ".join(
              f"{n}: {served['prefill_s'][i] * 1e3:.2f}, {served['ttft_s'][i] * 1e3:.2f}"
              for i, n in enumerate(prompt_lens)))
    print(f"  decode: {served['decode_tokens']} tokens in {served['decode_s']:.4f} s over "
          f"{served['steps']} pool steps, {served['decode_tokens'] / served['decode_s']:.1f} "
          f"tokens/s; flash_attention launches {launches['flash_attention']} (= {n_attn} x "
          f"{len(prompt_lens)}); torch.cuda.max_memory_allocated {served['peak_bytes']} bytes")
    if any(b.ffn == "moe" for b in model.blocks):
        print(f"  MoE dispatch vs dense body on the same routes (tol {MOE_TOL}): "
              f"{check_moe_bodies(served)}")
    print(f"  last-token prefill logits, kernel vs plain attention (tol {LOGITS_TOL}): "
          f"{check_serving_logits(served, (min(prompt_lens),), frontend=bool(cfg.frontend))}")
    print_profile(serving_profile(served, reps=1, prefill_len=profile_len))
    return launches


# ------------------------------------------------------------ phase 3h

def train_flops(model, batch: int, seq: int) -> float:
    """The FLOPs of one rematerialised training step, counted from shapes,
    not executed: 6 N T for the matmuls' forward and backward (N = the
    blocks' and the head's matmul weights, T = batch x seq tokens), 2 N_b T
    for the blocks' forward run again under remat (N_b = the blocks'
    matmul weights), and per attention layer 16 B H D S(S + 1) / 2 (causal
    QK^T and PV, 4 B H D per visible pair, for the forward, the remat
    forward and the backward's two)."""
    cfg, tokens = model.cfg, batch * seq
    n_blocks = sum(p.numel() for n, p in model.named_parameters()
                   if n.startswith("blocks.") and p.dim() >= 2)
    n = n_blocks + model.head.numel()
    n_attn = sum(b.mixer.startswith("attn") for b in model.blocks)
    pairs = seq * (seq + 1) // 2
    attn = n_attn * 16 * batch * cfg.n_heads * cfg.d_head * pairs
    return 6 * n * tokens + 2 * n_blocks * tokens + attn


def check_grads_against_plain(kernels, model, batch, what):
    """The loss and every parameter's gradient through the kernel against
    plain attention on the same weights and batch (TRAIN_LOSS_RTOL,
    TRAIN_GRAD_TOL of each gradient's own max |g|); returns the figures and
    the kernel run's launches."""
    import torch

    from repro_torch.train.train_step import loss_and_grads

    (kloss, kmet, kgrads), _, launches = counted(kernels, lambda: loss_and_grads(model, batch))
    with plain_attention():
        ploss, pmet, pgrads = loss_and_grads(model, batch)
    torch.testing.assert_close(kloss, ploss, rtol=TRAIN_LOSS_RTOL, atol=0,
                               msg=lambda m: f"{what}: loss, kernel vs plain: {m}")
    worst, worst_name = 0.0, None
    for name, g in kgrads.items():
        scale = float(pgrads[name].abs().max())
        err = float((g - pgrads[name]).abs().max())
        if not math.isfinite(err) or err > TRAIN_GRAD_TOL * max(scale, 1e-30):
            raise AssertionError(f"{what}: gradient of {name}: max abs diff {err} against "
                                 f"{TRAIN_GRAD_TOL} x max |g| {scale}")
        if scale and err / scale >= worst:
            worst, worst_name = err / scale, name
    return dict(loss=float(kloss), plain_loss=float(ploss), xent=float(kmet["xent"]),
                aux=float(kmet["aux"]),
                grads=len(kgrads), worst_grad_rel=worst, worst_grad=worst_name), launches


def run_training_phase(kernels):
    """Training on the card (item 11.4): yi-6b at full width over
    TRAIN_LAYERS layers, TRAIN_STEPS `Trainer` steps (kernel vs plain
    attention on the first batch: the loss and every gradient; flash
    launches 2 per attention layer a step; finite losses and norms; s per
    step, tokens/s, peak memory, the device's busy share, the share of the
    fp32 peak); one bf16 step at TRAIN_BF16_LAYERS; the reduced
    TRAIN_FAMILIES; examples/train_lm at its defaults and with --inject;
    the launcher."""
    import dataclasses
    import io
    import statistics
    import tempfile

    import torch

    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.examples import train_lm
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import batch_to
    from repro_torch.train.trainer import Trainer, TrainerConfig

    out, paths = {}, {}

    def trainer(cfg, steps, batch, seq, dtype=None, lr=3e-4):
        return Trainer(cfg, opt.OptConfig(lr=lr, warmup_steps=2, total_steps=steps),
                       TrainerConfig(steps=steps, ckpt_every=0, log_every=1, param_dtype=dtype),
                       DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch, seed=SEED),
                       seed=SEED, device="cuda")

    def finite(what, hist, steps):
        if len(hist) != steps or not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
                                         for h in hist):
            raise AssertionError(f"{what}: history {hist}")

    # (1) yi-6b at full width, TRAIN_LAYERS layers
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    tr = trainer(cfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    batch = batch_to(tr.pipeline.batch(0), "cuda")
    torch.cuda.reset_peak_memory_stats()
    # the check's launches compare the kernel with its plain version: not a path's
    check, check_launches = check_grads_against_plain(kernels, tr.model, batch, TRAIN_ARCH)
    expect_launches(f"{TRAIN_ARCH} loss and gradients", check_launches,
                    {"flash_attention": 2 * TRAIN_LAYERS})
    check_peak = torch.cuda.max_memory_allocated()
    step_fn, step_s = tr.train_step, []

    def timed(*args):
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = step_fn(*args)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
        return res

    tr.train_step = timed
    torch.cuda.reset_peak_memory_stats()
    hist, dt, launches = counted(kernels, tr.run)
    peak = torch.cuda.max_memory_allocated()
    paths[f"train_{TRAIN_ARCH}"] = expect_launches(
        f"{TRAIN_ARCH} training", launches, {"flash_attention": 2 * TRAIN_LAYERS * TRAIN_STEPS})
    finite(TRAIN_ARCH, hist, TRAIN_STEPS)
    if abs(hist[0]["loss"] - check["loss"]) > TRAIN_LOSS_RTOL * abs(check["loss"]):
        raise AssertionError(f"first step's loss {hist[0]['loss']} against {check['loss']}")

    def one_step():
        tr.opt_state, _ = step_fn(tr.model, tr.opt_state, batch)

    wall_us, ops, busy, prof = profiled(one_step, 1)
    events, busy_us = device_kernels(prof)
    if not busy_us:
        raise AssertionError("no device op in the profiled training step")
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    flash_us = sum(us for n, us in by_name.items() if "flash_attention_kernel" in n)
    gemm_us = sum(us for n, us in by_name.items() if "gemm" in n.lower())
    steady = statistics.mean(step_s[1:])
    flops = train_flops(tr.model, TRAIN_BATCH, TRAIN_SEQ)
    out[TRAIN_ARCH] = dict(
        layers=TRAIN_LAYERS, params=sum(p.numel() for p in tr.model.parameters()),
        init_s=init_s, check=check, check_peak_bytes=check_peak, step_s=step_s,
        steady_step_s=steady, tokens_per_s=TRAIN_BATCH * TRAIN_SEQ / steady, peak_bytes=peak,
        losses=[h["loss"] for h in hist], grad_norms=[h["grad_norm"] for h in hist],
        profiled_step_ms=wall_us / 1e3, device_ops_per_step=ops, busy=busy, flops=flops,
        fp32_peak_share=flops / steady / FP32_OPS_PER_S,
        device_share=dict(gemm=gemm_us / busy_us, flash=flash_us / busy_us,
                          rest=1 - (gemm_us + flash_us) / busy_us),
        flash_us_per_launch=flash_us / (2 * TRAIN_LAYERS),
        top_kernels=[(n[:70], us / busy_us) for n, us in top])
    del tr, batch, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (2) one bf16 step at TRAIN_BF16_LAYERS layers: the wgmma route
    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), n_layers=TRAIN_BF16_LAYERS)
    tr = trainer(cfg, 1, TRAIN_BATCH, TRAIN_SEQ, dtype=torch.bfloat16)
    batch = batch_to(tr.pipeline.batch(0), "cuda")
    with torch.no_grad():
        kern = float(T.loss_fn(tr.model, batch)[0])
        with plain_attention():
            plain_loss = float(T.loss_fn(tr.model, batch)[0])
    if not abs(kern - plain_loss) <= TRAIN_BF16_RTOL * abs(plain_loss):
        raise AssertionError(f"bf16 loss, kernel {kern} vs plain {plain_loss}")
    hist, dt, launches = counted(kernels, tr.run)
    paths[f"train_{TRAIN_ARCH}_bf16"] = expect_launches(
        "bf16 training", launches, {"flash_attention": 2 * TRAIN_BF16_LAYERS})
    finite("bf16", hist, 1)
    out["bf16"] = dict(layers=TRAIN_BF16_LAYERS, loss=kern, plain_loss=plain_loss, step_s=dt,
                       trained_loss=hist[0]["loss"], grad_norm=hist[0]["grad_norm"])
    del tr, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (3) the reduced families
    for name in TRAIN_FAMILIES:
        cfg = get_reduced(name)
        tr = trainer(cfg, TRAIN_FAMILY_STEPS, TRAIN_FAMILY_BATCH, TRAIN_FAMILY_SEQ, lr=1e-3)
        n_attn = sum(b.mixer.startswith("attn") for b in tr.model.blocks)
        row = dict(attention_layers=n_attn)
        if n_attn:
            batch = batch_to(tr.pipeline.batch(0), "cuda")
            with torch.no_grad():
                kern = T.loss_fn(tr.model, batch)[0]
                with plain_attention():
                    plain_loss = T.loss_fn(tr.model, batch)[0]
            torch.testing.assert_close(kern, plain_loss, rtol=TRAIN_LOSS_RTOL, atol=0,
                                       msg=lambda m: f"{name}: loss, kernel vs plain: {m}")
            row.update(loss=float(kern), plain_loss=float(plain_loss))
        hist, dt, launches = counted(kernels, tr.run)
        paths[f"train_{name}"] = expect_launches(
            f"{name} training", launches, {"flash_attention": 2 * n_attn * TRAIN_FAMILY_STEPS})
        finite(name, hist, TRAIN_FAMILY_STEPS)
        if cfg.n_routed and not all(h["aux"] > 0 for h in hist):
            raise AssertionError(f"{name}: MoE aux {[h['aux'] for h in hist]}")
        row.update(seconds=dt, losses=[h["loss"] for h in hist], aux=[h["aux"] for h in hist])
        out[name] = row
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # (4) examples/train_lm at its defaults, then with --inject
    n_layers, steps = train_lm.model_100m().n_layers, 300
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, extra in (("", []), ("_inject", ["--inject", str(TRAIN_LM_INJECT)])):
            text = io.StringIO()

            def run():
                with contextlib.redirect_stdout(text):
                    return train_lm.main(["--ckpt-dir", f"{tmp}/run{tag}"] + extra)

            hist, dt, launches = counted(kernels, run)
            paths[f"example_train_lm{tag}"] = expect_launches(
                f"train_lm{tag}", launches, {"flash_attention": 2 * n_layers * steps})
            if "(OK: learning)" not in text.getvalue():
                raise AssertionError(f"train_lm{tag}: not learning:\n{text.getvalue()}")
            runs[tag] = (hist, dt, text.getvalue().strip().splitlines()[-1])
    full, rec = runs[""][0], runs["_inject"][0]
    if [h["step"] for h in rec] != [h["step"] for h in full]:
        raise AssertionError(f"recovered steps {[h['step'] for h in rec]}")
    rel = max(abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(rec, full))
    if not rel <= TRAIN_LM_RTOL:
        raise AssertionError(f"train_lm --inject: losses {rel} off the uninterrupted run's")
    keys = ("loss", "grad_norm", "lr")
    out["train_lm"] = dict(seconds=runs[""][1], inject_seconds=runs["_inject"][1],
                           last_line=runs[""][2], inject_last_line=runs["_inject"][2],
                           max_loss_rel_diff=rel, first=full[0]["loss"], last=full[-1]["loss"],
                           bitwise=all(a[k] == b[k] for a, b in zip(rec, full) for k in keys),
                           rows=len(full))

    # (5) the launcher
    text = io.StringIO()

    def launch():
        with contextlib.redirect_stdout(text):
            launch_train.main(["--arch", TRAIN_ARCH, "--reduced", "--steps",
                               str(TRAIN_LAUNCH_STEPS)])

    _, dt, launches = counted(kernels, launch)
    lines = text.getvalue().strip().splitlines()
    paths["train_launcher"] = expect_launches("train launcher", launches, {
        "flash_attention": 2 * get_reduced(TRAIN_ARCH).n_layers * TRAIN_LAUNCH_STEPS})
    if not lines or f"'step': {TRAIN_LAUNCH_STEPS}," not in lines[-1]:
        raise AssertionError(f"train launcher output:\n{text.getvalue()}")
    out["launcher"] = dict(seconds=dt, last_line=lines[-1])
    return out, paths


def print_training(out, by_path):
    v = out[TRAIN_ARCH]
    print(f"  {TRAIN_ARCH} at full width, {v['layers']} of 32 layers ({v['params']} params; fp32 "
          f"params, master, m, v, gradients), batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"{TRAIN_STEPS} steps (built in {v['init_s']:.3f} s): loss {v['losses']}, grad norm "
          f"{v['grad_norms']}")
    c = v["check"]
    print(f"    first batch, kernel vs plain attention: loss {c['loss']!r} vs {c['plain_loss']!r} "
          f"(rtol {TRAIN_LOSS_RTOL}), {c['grads']} gradients each within {TRAIN_GRAD_TOL} of its "
          f"max |g| (worst {c['worst_grad_rel']:.3e}, {c['worst_grad']}); peak "
          f"{v['check_peak_bytes']} bytes")
    print(f"    s per step {v['step_s']}, steady (steps 2-{TRAIN_STEPS}) "
          f"{v['steady_step_s']:.4f} s, "
          f"{v['tokens_per_s']:.1f} tokens/s; torch.cuda.max_memory_allocated {v['peak_bytes']} "
          f"bytes; one step under the profiler {v['profiled_step_ms']:.1f} ms, "
          f"{v['device_ops_per_step']:.0f} device ops, device busy {v['busy']}; FLOPs a step "
          f"{v['flops']:.4e} (6 N T + 2 N_blocks T + 16 B H D S(S+1)/2 a layer), "
          f"{v['fp32_peak_share']:.4f} of the fp32 peak (67 TFLOP/s); launches "
          f"{by_path[f'train_{TRAIN_ARCH}']}")
    print(f"    device time of the profiled step: GEMMs {v['device_share']['gemm']:.4f}, flash "
          f"{v['device_share']['flash']:.4f} ({v['flash_us_per_launch']:.1f} µs a launch), the "
          f"rest {v['device_share']['rest']:.4f}; top kernels {v['top_kernels']}")
    v = out["bf16"]
    print(f"  bf16, {v['layers']} layers: loss kernel {v['loss']!r} vs plain {v['plain_loss']!r} "
          f"(rtol {TRAIN_BF16_RTOL}); one step {v['step_s']:.3f} s, loss {v['trained_loss']!r}, "
          f"grad norm {v['grad_norm']!r}; launches {by_path[f'train_{TRAIN_ARCH}_bf16']}")
    for name in TRAIN_FAMILIES:
        v = out[name]
        check = (f"loss kernel {v['loss']!r} vs plain {v['plain_loss']!r}; "
                 if "loss" in v else "no attention; ")
        print(f"  {name} reduced, {TRAIN_FAMILY_STEPS} steps at {TRAIN_FAMILY_BATCH} x "
              f"{TRAIN_FAMILY_SEQ}: {check}losses {v['losses']}, aux {v['aux']}, "
              f"{v['seconds']:.3f} s; launches {by_path[f'train_{name}']}")
    v = out["train_lm"]
    print(f"  example train_lm: {v['seconds']:.3f} s, {v['last_line']}; with --inject "
          f"{TRAIN_LM_INJECT}: {v['inject_seconds']:.3f} s, {v['inject_last_line']}; logged "
          f"losses within {v['max_loss_rel_diff']:.3e} (rtol {TRAIN_LM_RTOL}) of the "
          f"uninterrupted run's, all {v['rows']} rows' loss, grad norm and lr bit for bit: "
          f"{v['bitwise']}; launches {by_path['example_train_lm']}, "
          f"{by_path['example_train_lm_inject']}")
    v = out["launcher"]
    print(f"  launcher --arch {TRAIN_ARCH} --reduced --steps {TRAIN_LAUNCH_STEPS}: "
          f"{v['seconds']:.3f} s; {v['last_line']}; launches {by_path['train_launcher']}")


# ------------------------------------------------------------ phase 3h, sharding

DRYRUN_CHILD = r"""
import json, sys, time
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.configs import get_arch
from repro_torch.configs.base import SHAPES, input_specs
from repro_torch.launch import dryrun
from repro_torch.models import transformer as T
from repro_torch.sharding import commcount
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import make_train_step
out = {"cells": {}}
for arch, shape, multi_pod in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    r = dryrun.run_cell(arch, shape, multi_pod, save_dir=sys.argv[1], verbose=False,
                        device="cuda")
    r["wall_s"] = time.perf_counter() - t0
    out["cells"][f"{arch} {shape} {r['mesh']}"] = r

# yi-6b train_4k unsharded: one data-parallel replica's rows (16 of 256) on
# plain fake tensors, at the cell's microbatches, over the 16 "model" ranks
t0 = time.perf_counter()
cfg, ss = get_arch("yi-6b"), SHAPES["train_4k"]
with FakeTensorMode():
    model = T.Transformer(cfg, device="cuda", dtype=torch.bfloat16)
    params = dict(model.named_parameters())
    state = {k: {n: torch.zeros(p.shape, device="cuda") for n, p in params.items()}
             for k in ("master", "m", "v")}
    state["step"] = torch.zeros((), dtype=torch.int32, device="cuda")
    batch = {k: torch.zeros((ss.global_batch // 16,) + tuple(v.shape[1:]), dtype=v.dtype,
                            device="cuda") for k, v in input_specs(cfg, "train_4k").items()}
    with commcount.counting() as cc:
        make_train_step(cfg, opt.OptConfig(), out["cells"]["yi-6b train_4k pod16x16"]["n_micro"])(
            model, state, batch)
out["unsharded"] = {"yi-6b train_4k": cc.report()["flops"] / 16,
                    "seconds": time.perf_counter() - t0}

# one Shard -> Shard redistribution on a cuda mesh (DTensor's all-to-all op)
# and on a cpu mesh (its all-gather and chunk) of the same fake group
dryrun.init_fake_group(256)
out["alltoall"] = {}
for dev in ("cuda", "cpu"):
    mesh = init_device_mesh(dev, (16, 16), mesh_dim_names=("data", "model"))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 32, device=dev), mesh, [Replicate(), Shard(1)],
                              src_data_rank=None)
        with commcount.counting() as cc:
            x = x.redistribute(mesh, [Replicate(), Shard(0)])
    out["alltoall"][dev] = dict(cc.report(), local=list(x.to_local().shape))

# the yi-6b train cell again, on a cpu mesh
out["cpu_mesh"] = dryrun.run_cell("yi-6b", "train_4k", False, verbose=False, device="cpu")
json.dump(out, open(sys.argv[3], "w"))
"""


def grad_diffs(got, want):
    """{name: (max |got - want|, max |want|, within SHARD_TOL elementwise)}
    of two gradient dicts on the card."""
    import torch
    return {k: ((got[k] - w).abs().max().item(), w.abs().max().item(),
                torch.allclose(got[k], w, **SHARD_TOL)) for k, w in want.items()}


def sharded_lm_rank(port, out_path):
    """Part (a), one process on a world-1 NCCL mesh (1, 1): yi-6b at full
    width over SHARD_LAYERS layers, prefill, decode and one training step
    on the prompt unsharded, then the same weights as DTensors laid out by
    `spec_for(param_axes)` under `activate`; saves both runs' logits and
    loss, times and flash launches, and each gradient's difference."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs import get_arch
    from repro_torch.kernels import flash_attention
    from repro_torch.models import transformer as T
    from repro_torch.sharding import logical
    from repro_torch.train import train_step

    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1, device_id=torch.device("cuda", 0))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        rules = logical.default_rules()
        cfg = dataclasses.replace(get_arch(SERVE_ARCH), n_layers=SHARD_LAYERS)
        model = T.Transformer(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(SEED))
        gen = torch.Generator("cuda").manual_seed(SEED + 1)
        prompt = torch.randint(0, cfg.vocab, (1, SHARD_PROMPT), generator=gen, device="cuda",
                               dtype=torch.int32)
        steps = torch.randint(0, cfg.vocab, (SHARD_DECODE, 1), generator=gen, device="cuda",
                              dtype=torch.int32)

        batch = {"tokens": prompt.long(), "targets": torch.roll(prompt.long(), -1, 1)}

        def full(t):
            return t.full_tensor() if hasattr(t, "full_tensor") else t

        def serve():
            logits, caches, clen = model.prefill(prompt, SHARD_PROMPT + SHARD_DECODE)
            out = [full(logits)]
            for tok in steps:
                logits, caches = model.decode_step(tok, caches, clen)
                clen = clen + 1
                out.append(full(logits))
            return torch.stack(out)

        res = {}
        for name in ("plain", "sharded"):
            if name == "sharded":
                axes = T.param_axes(model)
                for pname, p in list(model.named_parameters()):
                    owner, _, leaf = pname.rpartition(".")
                    mod = model.get_submodule(owner) if owner else model
                    pl = logical.placements(logical.spec_for(axes[pname], p.shape, mesh, rules), mesh)
                    setattr(mod, leaf, torch.nn.Parameter(
                        distribute_tensor(p.detach(), mesh, pl, src_data_rank=None),
                        requires_grad=False))
            ctx = logical.activate(mesh, rules) if name == "sharded" else contextlib.nullcontext()
            with ctx:
                serve()                                  # warm-up
                flash_attention.KERNEL.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = serve()
                torch.cuda.synchronize()
                res[name] = dict(logits=logits.cpu(), seconds=time.perf_counter() - t0,
                                 flash=flash_attention.KERNEL.launches)
                # one training step: the gradient constraint and flash's custom op
                model.requires_grad_(True)
                flash_attention.KERNEL.launches = 0
                t0 = time.perf_counter()
                loss, _, grads = train_step.loss_and_grads(model, batch)
                grads = {k: full(g) for k, g in grads.items()}
                torch.cuda.synchronize()
                res[name].update(loss=float(full(loss)), train_s=time.perf_counter() - t0,
                                 train_flash=flash_attention.KERNEL.launches)
                model.requires_grad_(False)
            if name == "plain":
                want_grads = grads
            else:
                res["grads"] = grad_diffs(grads, want_grads)
            del grads
        res["param_type"] = type(model.head).__name__
        res["placements"] = str(model.head.placements)
        torch.save(res, out_path)
    finally:
        dist.destroy_process_group()


def sharding_inputs():
    """Part (b)'s inputs, drawn alike in every process from SEED on the card."""
    import dataclasses

    import torch

    from repro_torch.configs import get_arch
    g = torch.Generator("cuda").manual_seed(SEED + 2)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device="cuda") * scale

    yi, ds = get_arch(SERVE_ARCH), get_arch("deepseek-moe-16b")
    h, hkv, d = yi.n_heads, yi.n_kv_heads, yi.d_head
    a = ds.moe_args()
    e, dm, de = a.e_phys, a.d_model, a.d_expert
    return dict(
        q1=randn(SPLIT_KV_B, h, d), k1=randn(SPLIT_KV_B, hkv, d), v1=randn(SPLIT_KV_B, hkv, d),
        kc=randn(SPLIT_KV_B, hkv, SPLIT_KV_T, d), vc=randn(SPLIT_KV_B, hkv, SPLIT_KV_T, d),
        clen=torch.tensor(SPLIT_KV_LENS, dtype=torch.int32, device="cuda"),
        q=randn(1, h, SHARD_PROMPT, d), k=randn(1, hkv, SHARD_PROMPT, d),
        v=randn(1, hkv, SHARD_PROMPT, d),
        x=randn(EP_TOKENS, dm), router=randn(dm, e, scale=0.02),
        wg=randn(e, dm, de, scale=dm ** -0.5), wu=randn(e, dm, de, scale=dm ** -0.5),
        wd=randn(e, de, dm, scale=de ** -0.5),
        moe_args={cf: dataclasses.replace(a, capacity_factor=cf) for cf in (EP_FREE_CF, 1.0)})


def ep_cap(a) -> int:
    return int(a.capacity_factor * a.top_k * EP_TOKENS / a.e_phys) + 1


def sharding_rank(rank, store_path, out_path):
    """Part (b), one of ISL_WORLD gloo ranks on the card: its shard of
    split-KV decode, heads-sharded flash prefill, `_apply_ep` and islands
    over a mesh, with launches counted and host ms per call; saves to
    `out_path`."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import islands as TI
    from repro_torch.core import nsga2
    from repro_torch.fpga import device, netlist
    from repro_torch.kernels import bbox, domination, flash_attention, ops, wirelength
    from repro_torch.models import attention, moe

    dist.init_process_group("gloo", store=dist.FileStore(store_path, ISL_WORLD), rank=rank,
                            world_size=ISL_WORLD,
                            timeout=datetime.timedelta(seconds=SHARD_TIMEOUT_S))
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        mesh = init_device_mesh("cpu", (1, ISL_WORLD), mesh_dim_names=("data", "model"))
        inp, out = sharding_inputs(), {}
        tl = SPLIT_KV_T // ISL_WORLD
        kc = inp["kc"][:, :, rank * tl:(rank + 1) * tl].clone()
        vc = inp["vc"][:, :, rank * tl:(rank + 1) * tl].clone()
        for rep in range(2):                          # the first call warms up
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, kc2, vc2 = attention.split_kv_decode_local(
                inp["q1"], inp["k1"], inp["v1"], kc.clone(), vc.clone(), inp["clen"], None,
                mesh, ("model",))
            torch.cuda.synchronize()
            out["split_kv_ms"] = (time.perf_counter() - t0) * 1e3
        out["split_kv"] = (o.cpu(), kc2.cpu(), vc2.cpu())
        hq, hk = inp["q"].shape[1] // ISL_WORLD, inp["k"].shape[1] // ISL_WORLD
        parts = [t[:, r * n:(r + 1) * n].contiguous()
                 for t, n, r in ((inp["q"], hq, rank), (inp["k"], hk, rank), (inp["v"], hk, rank))]
        flash_attention.KERNEL.launches = 0
        out["flash"] = ops.flash_attention(*parts, True, None, None).cpu()
        out["flash_launches"] = flash_attention.KERNEL.launches
        e_loc = inp["wg"].shape[0] // ISL_WORLD
        w = [inp[k][rank * e_loc:(rank + 1) * e_loc] for k in ("wg", "wu", "wd")]
        for cf, a in inp["moe_args"].items():
            y, aux = moe.apply_ep_local(a, inp["x"], inp["router"], *w, ep_cap(a), mesh,
                                        ("model",), ("data",))
            out[f"ep_{cf}"] = (y.cpu(), aux.cpu())
        problem = netlist.make_problem(device.get_device(FPGA_DEVICE))
        isl = init_device_mesh("cpu", (ISL_WORLD,), mesh_dim_names=("islands",))
        cfg, icfg = nsga2.NSGA2Config(pop_size=POP), TI.IslandConfig(ISL_P, ISL_MIGRATE)
        kernels = {"wirelength2": wirelength.KERNEL, "maxbbox": bbox.KERNEL,
                   "domination": domination.KERNEL}
        (got, _, launches) = counted(kernels, lambda: TI.run(
            problem, "nsga2", cfg, torch.Generator("cuda").manual_seed(SEED + 40),
            SHARD_ISL_GENS, islands=icfg, mesh=isl, device="cuda"))
        want = TI.run(problem, "nsga2", cfg, torch.Generator("cuda").manual_seed(SEED + 40),
                      SHARD_ISL_GENS, islands=icfg, device="cuda", group=dist.group.WORLD)
        out["islands_equal"] = all(torch.equal(x, y) for x, y in zip(
            torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)))
        out["islands_launches"] = launches
        torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


DRYRUN_DIR = Path(__file__).resolve().parent / "experiments" / "dryrun"


def run_sharding_phase(kernels, tmp):
    """Sharding and the dry-run, the script's last phase: (c) the dry-run
    cells start in a process of their own (a fake process group; the
    host's CPU, but for ea_round's islands on the card) and trace while
    (a) the global DTensor program runs on a world-1 NCCL mesh and (b) the
    shard-local functions over two gloo ranks on the card; (c) is read
    last.  Every sharded result is held within SHARD_TOL of the same
    computation in one process; returns the figures and the launches by
    path."""
    import os

    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import attention, moe

    out_dir = DRYRUN_DIR
    out, paths = {}, {}
    zero = {n: 0 for n in kernels}
    env = {**os.environ, "PYTHONPATH": str(DRYRUN_DIR.parents[1] / "src")}
    t_dry = time.perf_counter()
    dry = subprocess.Popen([sys.executable, "-c", DRYRUN_CHILD, str(DRYRUN_DIR),
                            json.dumps(DRYRUN_CELLS), str(Path(tmp) / "dryrun.json")], env=env)
    try:
        # (a) the global program on a world-1 NCCL mesh
        lm_path = Path(tmp) / "lm.pt"
        out["lm_wall_s"] = spawn_ranks(sharded_lm_rank, lambda r: (free_port(), str(lm_path)),
                                       1, SHARD_TIMEOUT_S)
        lm = torch.load(lm_path, weights_only=False)
        torch.testing.assert_close(lm["sharded"]["logits"], lm["plain"]["logits"], **SHARD_TOL)
        if lm["param_type"] != "DTensor":
            raise AssertionError(f"sharded run's parameters are {lm['param_type']}")
        diff = (lm["sharded"]["logits"] - lm["plain"]["logits"]).abs().max().item()
        torch.testing.assert_close(torch.tensor(lm["sharded"]["loss"]),
                                   torch.tensor(lm["plain"]["loss"]), **SHARD_TOL)
        out["lm"] = dict(max_abs_diff=diff, exact=diff == 0.0,
                         plain_s=lm["plain"]["seconds"], sharded_s=lm["sharded"]["seconds"],
                         placements=lm["placements"], train=check_grads("(a)", lm["grads"]),
                         loss=(lm["sharded"]["loss"], lm["plain"]["loss"]),
                         train_s=(lm["sharded"]["train_s"], lm["plain"]["train_s"]))
        for name in ("plain", "sharded"):
            paths[f"sharding_lm_{name}"] = expect_launches(
                f"sharding (a) {name}", dict(zero, flash_attention=lm[name]["flash"]),
                {"flash_attention": SHARD_LAYERS})
            paths[f"sharding_lm_train_{name}"] = expect_launches(
                f"sharding (a) {name} training step",
                dict(zero, flash_attention=lm[name]["train_flash"]),
                {"flash_attention": 2 * SHARD_LAYERS})

        # (b) the shard-local functions over two gloo ranks on the card
        outs = [Path(tmp) / f"shard{r}.pt" for r in range(ISL_WORLD)]
        out["ranks_wall_s"] = spawn_ranks(
            sharding_rank, lambda r: (r, str(Path(tmp) / "store"), str(outs[r])),
            ISL_WORLD, SHARD_TIMEOUT_S)
        ranks = [torch.load(o, weights_only=False) for o in outs]
        inp = sharding_inputs()
        o, kc, vc = attention.split_kv_decode_local(
            inp["q1"], inp["k1"], inp["v1"], inp["kc"].clone(), inp["vc"].clone(),
            inp["clen"], None)
        heads = ops.flash_attention(inp["q"], inp["k"], inp["v"], True, None, None).cpu()
        free = inp["moe_args"][EP_FREE_CF]
        inds, gates, loss = moe.route(free, inp["router"], inp["x"])
        want_free = (moe.dense(inp["x"], inds, gates, inp["wg"], inp["wu"], inp["wd"]).cpu(),
                     loss.cpu())
        a1, e_loc = inp["moe_args"][1.0], inp["wg"].shape[0] // ISL_WORLD
        inds, gates, loss = moe.route(a1, inp["router"], inp["x"])
        want_cap = (sum(moe.ep_experts(a1, inp["x"], inds, gates, *(
            inp[k][r * e_loc:(r + 1) * e_loc] for k in ("wg", "wu", "wd")), ep_cap(a1), r * e_loc)
            for r in range(ISL_WORLD)).cpu(), loss.cpu())
        dropped = (want_cap[0] - want_free[0]).abs().max().item()
        if dropped < 1e-3:
            raise AssertionError("capacity_factor 1.0 dropped no routed pair")
        tl, hq = SPLIT_KV_T // ISL_WORLD, inp["q"].shape[1] // ISL_WORLD
        diffs = {"split_kv": 0.0, "flash_heads": 0.0, "ep_free": 0.0, "ep_cap1": 0.0}
        for r, res in enumerate(ranks):
            got_o, got_k, got_v = res["split_kv"]
            torch.testing.assert_close(got_o, o.cpu(), **SHARD_TOL)
            if not (torch.equal(got_k, kc[:, :, r * tl:(r + 1) * tl].cpu())
                    and torch.equal(got_v, vc[:, :, r * tl:(r + 1) * tl].cpu())):
                raise AssertionError(f"split-KV rank {r}: its cache slice differs")
            want_h = heads[:, r * hq:(r + 1) * hq]
            torch.testing.assert_close(res["flash"], want_h, **SHARD_TOL)
            for key, want in (("ep_free", want_free), (f"ep_cap1", want_cap)):
                got = res[f"ep_{EP_FREE_CF if key == 'ep_free' else 1.0}"]
                torch.testing.assert_close(got[0], want[0], **SHARD_TOL)
                torch.testing.assert_close(got[1], want[1], **SHARD_TOL)
                diffs[key] = max(diffs[key], (got[0] - want[0]).abs().max().item())
            diffs["split_kv"] = max(diffs["split_kv"], (got_o - o.cpu()).abs().max().item())
            diffs["flash_heads"] = max(diffs["flash_heads"],
                                       (res["flash"] - want_h).abs().max().item())
            if not res["islands_equal"]:
                raise AssertionError(f"islands over a mesh, rank {r}: not the group= run")
            paths[f"sharding_flash_heads_rank{r}"] = expect_launches(
                f"sharding (b) flash rank {r}", dict(zero, flash_attention=res["flash_launches"]),
                {"flash_attention": 1})
            per = ISL_P // ISL_WORLD
            paths[f"sharding_islands_mesh_rank{r}"] = expect_launches(
                f"sharding (b) islands rank {r}", dict(zero, **res["islands_launches"]),
                {"wirelength2": per + SHARD_ISL_GENS, "maxbbox": per + SHARD_ISL_GENS,
                 "domination": 2 * SHARD_ISL_GENS})
        out["ranks"] = dict(max_abs_diff=diffs, dropped_max=dropped,
                            split_kv_ms=[res["split_kv_ms"] for res in ranks])
    finally:
        t_wait = time.perf_counter()
        try:
            dry.wait(max(t_dry + DRYRUN_TIMEOUT_S - time.perf_counter(), 1))
        except subprocess.TimeoutExpired:
            dry.kill()
            dry.wait()
            raise AssertionError(f"the dry-run took over {DRYRUN_TIMEOUT_S} s")
    if dry.returncode != 0:
        raise AssertionError(f"the dry-run process exited {dry.returncode}")
    traced = json.loads((Path(tmp) / "dryrun.json").read_text())
    cells = traced["cells"]
    out["dryrun_s"] = sum(v["wall_s"] for v in cells.values())
    out["dryrun_waited_s"] = time.perf_counter() - t_wait
    bad = [k for k, v in cells.items() if v["status"] != "ok"]
    if bad:
        raise AssertionError(f"dry-run cells failed: {[(k, cells[k].get('error')) for k in bad]}")
    if any(not (out_dir / f"{v['arch']}__{v['shape']}__{v['mesh']}.json").is_file()
           for v in cells.values()):
        raise AssertionError("a dry-run cell wrote no JSON")
    out["dryrun"] = cells
    out["dryrun_checks"] = check_dryrun(traced)
    return out, paths


def check_grads(what, diffs):
    """Every gradient within SHARD_TOL elementwise, or within SHARD_GRAD_TOL
    of its max |g|; returns (the largest such share, the gradients)."""
    bad = {k: v for k, v in diffs.items() if not v[2] and v[0] > SHARD_GRAD_TOL * v[1]}
    if bad or not diffs:
        raise AssertionError(f"{what}: gradients off (max abs diff, max |g|): {bad or diffs}")
    return max(d / max(m, 1e-30) for d, m, _ in diffs.values()), len(diffs)


def check_dryrun(traced):
    """The (c) gates: train cells' flops per device against the independent
    counts, forward cells' flops against FWD_FLOPS, one Shard -> Shard
    redistribution booked as an all-to-all of its output's bytes, and
    nothing else, on a cuda mesh and on a cpu mesh alike, and yi-6b
    train_4k's flops and collective bytes, kind by kind, the same on
    either mesh."""
    by_cell = {f"{v['arch']} {v['shape']}": v["cost"]["flops_per_device"]
               for v in traced["cells"].values() if v["cost"]}
    counts = {"reference": REF_FLOPS,
              "unsharded": {"yi-6b train_4k": traced["unsharded"]["yi-6b train_4k"]}}
    ratios = {f"{key} / {tag}": by_cell[key] / n
              for tag, c in counts.items() for key, n in c.items()}
    off = {k: r for k, r in ratios.items() if abs(r - 1) > TRAIN_FLOPS_RTOL}
    if off:
        raise AssertionError(f"train cells' flops per device off their counts: {off}")
    moved = {k: (by_cell[k], f) for k, f in FWD_FLOPS.items()
             if abs(by_cell[k] / f - 1) > 1e-4}
    if moved:
        raise AssertionError(f"forward cells' flops moved from FWD_FLOPS: {moved}")
    a2a = traced["alltoall"]
    want = a2a["cuda"]["local"][0] * a2a["cuda"]["local"][1] * 4
    for dev, rep in a2a.items():
        c = rep["collectives"]
        if (c["all-to-all"], c["total"], rep["collective_calls"]) != (want, want,
                                                                       {"all-to-all": 1}):
            raise AssertionError(f"Shard -> Shard on a {dev} mesh booked {c}, "
                                 f"{rep['collective_calls']}; expected {want} bytes of all-to-all")
    cuda, cpu = traced["cells"]["yi-6b train_4k pod16x16"], traced["cpu_mesh"]
    if (cpu["collectives"], cpu["cost"]["flops_per_device"]) != (
            cuda["collectives"], cuda["cost"]["flops_per_device"]):
        raise AssertionError(f"yi-6b train_4k on a cpu mesh: {cpu['collectives']}, "
                             f"{cpu['cost']['flops_per_device']}; on the cuda mesh: "
                             f"{cuda['collectives']}, {cuda['cost']['flops_per_device']}")
    return dict(ratios=ratios, alltoall_bytes=want, unsharded_s=traced["unsharded"]["seconds"],
                cpu_mesh_s=cpu["trace_s"])


def print_sharding(out, card):
    lm, rk = out["lm"], out["ranks"]
    print(f"  (a) and (b) run while the dry-run cells (c) trace in a process of their own: "
          f"their seconds and ms share the host with it")
    print(f"  ({card}) (a) yi-6b full width over {SHARD_LAYERS} layers on a world-1 NCCL mesh "
          f"(1, 1), {SHARD_PROMPT}-token prefill + {SHARD_DECODE} decode steps: DTensor params "
          f"(head {lm['placements']}) vs unsharded: logits max abs diff {lm['max_abs_diff']} "
          f"(bit for bit: {lm['exact']}; tol {SHARD_TOL}); plain {lm['plain_s']:.3f} s, "
          f"sharded {lm['sharded_s']:.3f} s; flash launches {SHARD_LAYERS} each; "
          f"process {out['lm_wall_s']:.1f} s")
    print(f"  ({card}) (b) {ISL_WORLD} gloo ranks on the card (host-staged collectives), max abs "
          f"diff vs one process: split-KV decode (B {SPLIT_KV_B}, T {SPLIT_KV_T}) "
          f"{rk['max_abs_diff']['split_kv']}, {rk['split_kv_ms']} ms a call; heads-sharded "
          f"flash {rk['max_abs_diff']['flash_heads']}; _apply_ep capacity not binding vs dense "
          f"{rk['max_abs_diff']['ep_free']}, capacity_factor 1.0 {rk['max_abs_diff']['ep_cap1']} "
          f"(dropped pairs move y by {rk['dropped_max']:.4f}); islands(mesh=) == group=: True; "
          f"processes {out['ranks_wall_s']:.1f} s")
    tr = lm["train"]
    print(f"  ({card}) (a) one training step on the prompt: loss sharded {lm['loss'][0]!r} vs "
          f"unsharded {lm['loss'][1]!r}; {tr[1]} gradients, the largest max abs diff "
          f"{tr[0]:.3e} of its max |g| (tol {SHARD_TOL} elementwise or {SHARD_GRAD_TOL} of max "
          f"|g|); {lm['train_s'][0]:.3f} s sharded, {lm['train_s'][1]:.3f} s plain; flash "
          f"launches {2 * SHARD_LAYERS} each")
    ck = out["dryrun_checks"]
    print(f"  (c) gates: train cells' flops per device over their counts {ck['ratios']} "
          f"(within {TRAIN_FLOPS_RTOL}); forward cells' flops equal {FWD_FLOPS}; one "
          f"Shard -> Shard booked {ck['alltoall_bytes']} bytes of all-to-all and nothing else "
          f"on a cuda and a cpu mesh; the unsharded trace {ck['unsharded_s']:.1f} s; yi-6b "
          f"train_4k traced again on a cpu mesh ({ck['cpu_mesh_s']} s): the same flops and "
          f"collective bytes, kind by kind")
    print(f"  ({card}) (c) dry-run cells {out['dryrun_s']:.1f} s in their process (started with "
          f"this phase; waited for after (a) and (b): {out['dryrun_waited_s']:.1f} s):")
    for key, v in out["dryrun"].items():
        if v["arch"] == "vu_systolic":
            print(f"    {key}: {v['status']}, {v['trace_s']} s, best_objs {v['best_objs']}")
            continue
        coll = {k: c for k, c in v["collectives"].items() if c}
        print(f"    {key}: {v['status']}, trace {v['trace_s']} s, peak "
              f"{v['memory']['peak_estimate_bytes'] / 2 ** 30:.3f} GiB/device, flops/device "
              f"{v['cost']['flops_per_device']:.4e}, collective bytes {coll}, dominant "
              f"{v['roofline']['dominant']}, n_micro {v['n_micro']}")


def flash_inputs(dtype, gen):
    """q, k, v of yi-6b's heads at the serving path's longest prefill."""
    import torch

    from repro_torch.configs import get_arch
    cfg = get_arch(SERVE_ARCH)
    s = max(SERVE_PROMPTS)
    q = torch.randn(1, cfg.n_heads, s, cfg.d_head, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(1, cfg.n_kv_heads, s, cfg.d_head, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    return q, k, v


def flash_device_ms():
    """Flash's device ms a call in f32 and bf16 at `flash_inputs`, from a
    profiler trace taken in phase 2: taken in phase 4, after the serving
    and training phases' traces, every trace of this call has come back
    without the kernel's events."""
    import torch

    from repro_torch.kernels import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    out = {}
    for dtype, tag in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        q, k, v = flash_inputs(dtype, gen)
        out[f"device_ms{tag}"] = device_ms(
            lambda: flash_attention.flash_attention(q, k, v, True, None),
            "flash_attention_kernel", iters=10)
    return out


def flash_figures(errs, launches, device):
    """Kernel, plain version and SDPA at the serving path's longest prefill;
    `device` holds its device ms from `flash_device_ms`.

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
        q, k, v = flash_inputs(dtype, gen)

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
            f"device_ms{tag}": device[f"device_ms{tag}"],
        })
    return row


def main() -> int:
    args = sys.argv[1:]
    if args and args[0] == "--launch-path":
        if args[1:2] == ["--src"]:          # another tree's port, compared in the same call
            sys.path.insert(0, str(Path(args[2]).resolve()))
        elif args[1:]:
            print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
            return 2
    elif args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    if args:
        import repro_torch
        from repro_torch.fpga import device, netlist
        problem = netlist.make_problem(device.get_device(FPGA_DEVICE))
        print(card_line())
        print(json.dumps({"launch_path": launch_path(problem),
                          "package": str(Path(repro_torch.__file__).parent)}))
        return 0
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
    flash_device = flash_device_ms()
    print(f"kernels vs plain on the card: {n_cases} cases passed, "
          f"max abs err (f32) {errs}")
    t0 = time.perf_counter()
    n_rows = check_batch_invariance()
    print(f"batch invariance: {n_rows} rows of wirelength2, maxbbox and fused_eval alone, in a "
          f"slice and in a batch of {INVARIANCE_ROWS}, directly and under vmap, bit for bit "
          f"({time.perf_counter() - t0:.1f} s)")

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
    print(f"[{time.perf_counter() - start:.1f} s] islands across {ISL_WORLD} processes (gloo, "
          f"host staging) on the one card")
    dist_islands, paths = run_islands_dist_phase(problem, kernels)
    by_path.update(paths)
    for r, v in enumerate(dist_islands["ranks"]):
        print(f"  rank {r}: islands P = {ISL_P} ({ISL_P // ISL_WORLD} here), migrate every "
              f"{ISL_MIGRATE}, pop {POP} x {ISL_GENS} gens: {v['ms_per_gen']:.3f} ms per gen; "
              f"{v['exchanges']} ring exchanges, host {v['exchange_ms_mean']:.3f} ms mean, "
              f"{v['exchange_ms_max']:.3f} max (the peer's wait included); gathered states and "
              f"history vs the single-process run: {v['leaves'] - v['leaves_differ']} of "
              f"{v['leaves']} leaves bit for bit"
              f"{' (the rest: integers exact, floats within tol)' if v['leaves_differ'] else ''}; "
              f"launches "
              f"{by_path[f'islands_{ISL_WORLD}proc_rank{r}']}; run_islands {ISL_DIST_ROUNDS} x "
              f"{ISL_DIST_GENS_PER_ROUND} gens in {v['run_islands_s']:.3f} s, best combined "
              f"{v['run_islands_best']:.4e}, launches "
              f"{by_path[f'run_islands_{ISL_WORLD}proc_rank{r}']}; nvcc builds "
              f"{v['nvcc_builds']}")
    print(f"  one process, the same {ISL_P} islands: {dist_islands['single_ms_per_gen']:.3f} ms "
          f"per gen; the phase {dist_islands['wall_s']:.1f} s from spawn to the last join")
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
    print(f"[{time.perf_counter() - start:.1f} s] paper runners (repro_torch.benchmarks, quick "
          f"budgets; Fig. 8 {FIG8_STEPS} steps a chain) and examples (repro_torch.examples)")
    t0 = time.perf_counter()
    paper, paper_s, paths = run_runners(kernels)
    by_path.update(paths)
    print_runners(paper, paper_s, by_path)
    examples, paths = run_examples(kernels)
    by_path.update(paths)
    for name, (dt, text) in examples.items():
        print(f"  example {name}: {dt:.3f} s; launches {by_path[f'example_{name}']}; "
              f"last line: {text.strip().splitlines()[-1]}")
    print(f"  the phase {time.perf_counter() - t0:.1f} s")
    print(f"[{time.perf_counter() - start:.1f} s] serving")

    # the serving path at full width: every prefill attention layer runs
    # the flash kernel (n_layers per request) and nothing else launches
    from repro_torch.configs import get_arch
    served = run_serving(kernels, get_arch(SERVE_ARCH))
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
    logit_check = check_serving_logits(served, (max(SERVE_PROMPTS), min(SERVE_PROMPTS)))
    print(f"  last-token prefill logits, kernel vs plain attention (tol {LOGITS_TOL}): "
          f"{logit_check}")
    profile = serving_profile(served)
    print_profile(profile)
    flash_in_prefill = profile[f"prefill_{max(SERVE_PROMPTS)}"].get("flash_kernel_us_per_launch")
    del served
    gc.collect()
    torch.cuda.empty_cache()

    # the other families: MoE, hybrid mamba, RWKV, frontends
    for spec in FAMILIES:
        print(f"[{time.perf_counter() - start:.1f} s] serving {spec[0]}")
        by_path[f"serving_{spec[0]}"] = run_family(kernels, *spec)
        gc.collect()
        torch.cuda.empty_cache()

    # training: yi-6b at full width over TRAIN_LAYERS layers, bf16, the
    # reduced families, the example and the launcher
    print(f"[{time.perf_counter() - start:.1f} s] training")
    t0 = time.perf_counter()
    training, paths = run_training_phase(kernels)
    by_path.update(paths)
    print_training(training, by_path)
    print(f"  the phase {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()

    # phase 4: times, bounds, rank peeling
    print(f"[{time.perf_counter() - start:.1f} s] kernel figures")
    row_label = {"domination_counts": "domination+counts"}
    launches = {n: sum(c[row_label.get(n, n)] for c in by_path.values())
                for n in ("fused_eval", "wirelength2", "maxbbox", "domination",
                          "domination_counts", "flash_attention")}
    rows = kernel_figures(problem, runs[True]["coords"], runs[True]["objs"], errs, launches)
    rows.append(flash_figures(errs, launches["flash_attention"], flash_device))
    rows[-1]["device_ms_in_prefill"] = None if flash_in_prefill is None else flash_in_prefill / 1e3
    shapes = slice_figures()
    plans = plan_figures(problem)
    split = host_split(problem)
    for row in rows:
        name = row["name"]
        row["launches_by_path"] = {p: c[row_label.get(name, name)] for p, c in by_path.items()}
        if name in shapes:
            row["shapes"] = shapes[name]
        if name in plans:
            row["rows"] = plans[name]
        if name in split:
            row["host_split_us"] = split[name]
    # one device op per call of the redesigned kernels at every reported shape
    for row in rows:
        if row["name"] in plans:
            ops = [row["device_ops"], row["device_ops_2048"],
                   *(v["device_ops"] for v in row["shapes"].values()),
                   *(v["device_ops"] for v in row["rows"].values())]
            if any(o != 1.0 for o in ops):
                raise AssertionError(f"{row['name']}: device ops per call {ops}, expected 1 "
                                     "(None: no trace showed the kernel)")
            print(f"{row['name']}: 1 device op per call at all {len(ops)} reported shapes")
    for name, per_shape in plans.items():
        for key, v in per_shape.items():
            print(f"{name} at {key}: {v['ms']:.4f} ms per call, device {v['device_ms']} ms in "
                  f"{v['device_ops']} ops, bound {v['bound_ms']:.6f} ms ({v['bound_by']}), "
                  f"plain {v['plain_ms']:.4f} ms")
    for name, v in split.items():
        print(f"{name} host µs per call by stage: {json.dumps(v)}")
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
    # sharding and the dry-run: the sharded paths on the card, the dry-run
    # traced on a fake process group; its launches join the kernel rows
    print(f"[{time.perf_counter() - start:.1f} s] sharding and the dry-run")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as dry_tmp:
        sharding, paths = run_sharding_phase(kernels, dry_tmp)
    print_sharding(sharding, card)
    for row in rows:
        label = row_label.get(row["name"], row["name"])
        row["launches_by_path"].update({p: c[label] for p, c in paths.items()})
        row["launches"] += sum(c[label] for c in paths.values())
    print(f"  the phase {time.perf_counter() - t0:.1f} s")
    print(f"[{time.perf_counter() - start:.1f} s] done")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
