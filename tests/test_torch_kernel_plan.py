"""Launch plans of the wirelength2 and maxbbox CUDA kernels, held on the CPU.

`kernels/wirelength.py::plan` and `kernels/bbox.py::plan` decide how a
launch splits its rows; the kernels themselves run only on the card
(`chip_smoke.py` holds them against their plain versions there).  These
tests are pure Python: for every N and (U, B) of the card's sweeps and
every row count the paths launch, which thread adds which net of a row
depends on N only (so a row's sum is formed in the same order in any
batch), the threads' nets and the tiles cover a row exactly once, and blocks, shared memory and grids stay within the card's
limits.  Both kernels launch one block per row: no thread-block clusters.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import bbox as tbbox
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
