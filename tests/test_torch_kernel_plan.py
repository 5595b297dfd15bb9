"""Launch plans of the wirelength2, maxbbox and fused_eval CUDA kernels,
held on the CPU.

`kernels/wirelength.py::plan`, `kernels/bbox.py::plan` and
`kernels/fused_eval.py::plan` decide how a launch splits its rows; the
kernels themselves run only on the card (`chip_smoke.py` holds them
against their plain versions there).  These tests are pure Python: for
every N, (U, B) and (G, N, U, B) of the card's sweeps and every row count
the paths launch, which thread adds which net of a row depends on the
row's shape only (so a row's sum is formed in the same order in any
batch), the threads' nets, the tiles and the unit lanes cover a row
exactly once, and blocks, shared memory and grids stay within the card's
limits.  All three kernels launch one block per row: no thread-block
clusters.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bbox as tbbox
from repro_torch.kernels import fused_eval as tfe
from repro_torch.kernels import wirelength as twl

# every row count the paths launch (SA 1, SA K = 8, transfer 16, CMA-ES 24,
# Table II 32, GA 48, the main path 64, pools of 4 and 8 slots, the
# prewarmed grow 768, 16 slots 1024) and chip_smoke.py's SWEEP_ROWS
ROWS = (1, 7, 8, 16, 24, 32, 48, 64, 127, 128, 129, 192, 200, 256, 512, 768, 1023,
        1024, 2048, 65536)
# chip_smoke.py's wirelength2 sweep and edges, the paths' N (xcvu11p 1999,
# xcvu3p 3074) and larger rows
NETS = (0, 1, 3, 4, 5, 7, 8, 255, 256, 257, 511, 512, 513, 1999, 2000, 2048, 2049, 3074,
        4096, 4097, 16384, 16385, 20000, 100000)
# chip_smoke.py's maxbbox sweep and edges, the paths' (U, B), the reference
# sweep's (U, B) and large tiles
UNITS = ((1, 1), (6, 28), (80, 28), (123, 28), (130, 5), (128, 32), (33, 3), (3, 28),
         (5, 7), (127, 5), (128, 5), (129, 5), (2, 64), (7, 96), (1000, 28), (2, 4096),
         (4096, 1))
# fused_eval's (G, N, U, B): chip_smoke.py's EVAL_SHAPES (the reference's
# tile-crossing sweep, then xcvu11p, the main path), SLICE_SHAPES' xcvu3p /
# xcvu9p width, FE_EDGE_SHAPES (odd G, B odd, B = 32, units past one pass,
# N below the threads, B / sub past the 7 indices a lane holds) and the floor
FE_PATH, FE_FLOOR = (2240, 1999, 80, 28), (7, 7, 1, 1)
FE_SHAPES = ((37, 11, 5, 7), (96, 511, 3, 28), (96, 512, 3, 28), (96, 513, 3, 28),
             (640, 40, 127, 5), (640, 40, 128, 5), (640, 40, 129, 5), (3640, 999, 130, 28),
             FE_PATH, (3444, 3074, 123, 28), (2239, 1999, 80, 28), (97, 511, 13, 7),
             (1000, 300, 10, 32), (3444, 3074, 200, 28), (2240, 5, 80, 28), (331, 100, 9, 27),
             FE_FLOOR)
MAX_GRID_X = 2 ** 31 - 1
SHARED_BYTES = 48 * 1024       # static + dynamic without an opt-in attribute


@pytest.mark.parametrize("n", NETS)
def test_wirelength_plan_order_depends_on_n_only(n):
    """The threads of a row's block -- which thread adds which net, and in
    what order -- are the same at every row count; one block per row."""
    one = twl.plan(1, n)
    for p in ROWS:
        pl = twl.plan(p, n)
        assert pl.threads == one.threads, (p, pl, one)
        assert pl.grid == p and 1 <= pl.grid <= MAX_GRID_X


@pytest.mark.parametrize("n", NETS)
def test_wirelength_threads_cover_each_net_once(n):
    """Thread t of a row adds nets t, t + threads, ...: every net once, and
    no thread of the block idle where the row has a net for it."""
    pl = twl.plan(64, n)
    seen = torch.zeros(n, dtype=torch.int64)
    for t in range(pl.threads):
        seen[t::pl.threads] += 1
    assert bool((seen == 1).all())
    assert pl.threads % 32 == 0 and 32 <= pl.threads <= twl.MAX_THREADS
    assert pl.threads in (32, twl.MAX_THREADS) or pl.threads - 32 < n


def test_wirelength_plan_at_the_paths_shapes():
    """xcvu11p's 1999 nets and xcvu3p's 3074: 256 threads a row at 1, 64
    and 2048 rows; 7 nets: one warp."""
    for p in (1, 64, 2048):
        assert twl.plan(p, 1999) == twl.plan(p, 3074) == twl.Plan(256, p)
    assert twl.plan(64, 7) == twl.Plan(32, 64)


@pytest.mark.parametrize("u, b", UNITS)
def test_maxbbox_plan_covers_each_unit_once(u, b):
    """Tiles of `tile_units` units cover the row once; a tile fits the
    shared memory a block gets without an opt-in; threads stage a tile in
    one round of UNROLL 16-byte f32 loads each (up to MAX_THREADS)."""
    for p in ROWS:
        pl = tbbox.plan(p, u, b)
        assert pl.tiles == -(-u // pl.tile_units)
        seen = torch.zeros(u, dtype=torch.int64)
        for t in range(pl.tiles):
            lo, hi = t * pl.tile_units, min((t + 1) * pl.tile_units, u)
            assert lo < hi
            seen[lo:hi] += 1
        assert bool((seen == 1).all()), (p, pl)
        assert pl.tile_units * b <= tbbox.MAX_TILE
        room = ((pl.tile_units * b + 3) & ~3) + 4
        assert 2 * room * 4 + 32 * 4 <= SHARED_BYTES
        assert pl.threads % 32 == 0 and 64 <= pl.threads <= tbbox.MAX_THREADS
        assert (pl.threads * tbbox.UNROLL * 4 >= pl.tile_units * b
                or pl.threads == tbbox.MAX_THREADS)
        assert pl.grid == p and 1 <= pl.grid <= MAX_GRID_X
        assert pl[:4] == tbbox.plan(1, u, b)[:4]


@pytest.mark.parametrize("u, b", UNITS)
def test_maxbbox_lanes_of_a_warp_hit_distinct_banks(u, b):
    """`sub` lanes share a unit, lane s reading blocks s, s + sub, ...; the
    32 lanes' first words (unit j at j * b) fall in 32 distinct banks."""
    sub = tbbox.plan(64, u, b).sub
    assert sub & (sub - 1) == 0 and sub <= 32 and b % sub == 0
    banks = {(j * b + s) % 32 for j in range(32 // sub) for s in range(sub)}
    assert len(banks) == 32


def test_maxbbox_plan_at_the_paths_shapes():
    """80 units x 28 blocks: the whole row in one tile, 4 lanes per unit,
    160 threads (2240 values in one round of four 16-byte loads)."""
    for p in (1, 64, 2048):
        assert tbbox.plan(p, 80, 28) == tbbox.Plan(80, 1, 4, 160, p)


def test_maxbbox_refuses_units_past_one_tile():
    x = torch.ones(1, 2, tbbox.MAX_BLOCKS + 1)
    with pytest.raises(ValueError, match="blocks per unit"):
        tbbox.maxbbox(x, x)


@pytest.mark.parametrize("shape", FE_SHAPES)
def test_fused_eval_plan_depends_on_the_row_shape_only(shape):
    """Threads, the units' threads, lanes and shared memory are the same at
    every row count; one block per row."""
    one = tfe.plan(1, *shape)
    for p in ROWS:
        pl = tfe.plan(p, *shape)
        assert pl[:-1] == one[:-1], (p, pl, one)
        assert pl.grid == p and 1 <= pl.grid <= MAX_GRID_X


@pytest.mark.parametrize("shape", FE_SHAPES)
def test_fused_eval_threads_cover_each_net_once(shape):
    """Thread t adds nets t, t + T, t + 2T, ... (T the block's threads):
    every net once, in warps whole, the block within MAX_THREADS and its
    shared memory within the card's."""
    g, n, u, b = shape
    pl = tfe.plan(64, *shape)
    seen = torch.zeros(n, dtype=torch.int64)
    for t in range(pl.threads):
        seen[t::pl.threads] += 1
    assert bool((seen == 1).all())
    assert pl.threads % 32 == 0 and 32 <= pl.threads <= tfe.MAX_THREADS
    assert pl.smem == tfe.shared_bytes(g) <= tfe.MAX_SHARED_BYTES


@pytest.mark.parametrize("shape", FE_SHAPES)
def test_fused_eval_lanes_cover_each_unit_once(shape):
    """`sub` lanes share a unit, lane s reading blocks s, s + sub, ...,
    passes of unit_threads / sub units: every (unit, block) once.  Where
    the unit table is the arange of `core/tables.py`, the lanes of a warp
    read distinct banks in every pass (32 where the warp's units exist)."""
    g, n, u, b = shape
    pl = tfe.plan(64, *shape)
    sub = pl.sub
    assert sub & (sub - 1) == 0 and sub <= 32 and b % sub == 0
    assert sub == 32 or (b // sub) % 2 == 1
    assert pl.unit_threads % 32 == 0 and 32 <= pl.unit_threads <= pl.threads
    per_pass = pl.unit_threads // sub
    uidx = torch.arange(u * b).reshape(u, b)
    seen = torch.zeros(u, b, dtype=torch.int64)
    for j0 in range(0, u, per_pass):
        for w0 in range(0, pl.unit_threads, 32):
            banks = []
            for t in range(w0, w0 + 32):
                j, s = j0 + t // sub, t % sub
                if j < u:
                    seen[j, s::sub] += 1
                    banks.append(int(uidx[j, s]) % 32)
            assert len(set(banks)) == len(banks), (j0, w0, banks)
    assert bool((seen == 1).all())


def test_fused_eval_plan_at_the_paths_shapes():
    """xcvu11p: 80 units x 4 lanes, one pass in 320 threads, which take the
    1999 nets too; xcvu3p: 123 x 4 lanes in 512 threads; the floor one warp."""
    for p in (1, 64, 2048):
        assert tfe.plan(p, *FE_PATH) == tfe.Plan(320, 320, 4, 18352, p)
        assert tfe.plan(p, 3444, 3074, 123, 28) == tfe.Plan(512, 512, 4, 27984, p)
        assert tfe.plan(p, *FE_FLOOR) == tfe.Plan(32, 32, 1, 496, p)


@pytest.mark.parametrize("extra", (0, 1))
def test_fused_eval_refuses_rows_past_the_shared_memory(extra):
    """The largest G the wrapper takes fills the block's shared memory
    (dynamic only: the header and two rooms of common.cuh's room_floats);
    one more is refused before anything is launched."""
    g = tfe.MAX_GIDS + extra
    room = ((g + 3) & ~3) + 4
    assert tfe.shared_bytes(g) == 4 * (tfe.HEADER_FLOATS + 2 * room)
    x = torch.zeros(1, g)
    idx = torch.zeros(3, dtype=torch.int32)
    if extra:
        assert tfe.shared_bytes(g) > tfe.MAX_SHARED_BYTES
        with pytest.raises(ValueError, match="shared memory"):
            tfe.plan(1, g, 3, 1, 1)
        with pytest.raises(ValueError, match="shared memory"):
            tfe._fused_eval(x, x, idx, idx, torch.ones(3), idx[:1].reshape(1, 1))
    else:
        assert tfe.plan(1, g, 3, 1, 1).smem == tfe.shared_bytes(g) <= tfe.MAX_SHARED_BYTES
        with pytest.raises(ValueError, match="expected CUDA tensors"):
            tfe._fused_eval(x, x, idx, idx, torch.ones(3), idx[:1].reshape(1, 1))


def test_direct_sends_cpu_tensors_and_vmap_through_the_custom_op():
    """The dispatcher is skipped only for plain CUDA tensors outside any
    transform: CPU tensors, and any call under vmap, go through the op."""
    x = torch.ones(2, 3)
    assert not _build.direct(x)
    seen = []

    def probe(t):
        seen.append(_build.direct(torch.ones(1)))
        return t
    torch.func.vmap(probe)(x)
    assert seen == [False]
