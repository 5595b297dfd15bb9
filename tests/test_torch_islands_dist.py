"""The port's islands across processes, on the CPU: two `gloo` ranks.

One spawn of 2 ranks for the module (a `FileStore` under `tmp_path`, the
joins bounded by `JOIN_S` in all, so a hung rank fails the tests instead of eating
the suite's time).  Each rank runs:
- `islands.run` over the 2 ranks for NSGA-II, reduced NSGA-II and SA
  (SA takes `adopt`'s point branch), through the default group
  (the reference's `shard="auto"` rule) and through an explicit group;
- `islands.run` with P = 3 over the 2 ranks, which must raise;
- `evolve.run_islands`, one island per rank.

The gathered results must equal, bit for bit, the single-process
`islands.run(P=4)` and a test-local loop that makes `run_islands`'s draws
and adoptions in one process.  The reference's own sharded-equals-vmap
test (`tests/test_islands.py::test_sharded_islands_match_vmap`) ties the
ring to the JAX package; the single-process islands are held against the
reference in `tests/test_torch_islands.py`.
"""
import datetime
import multiprocessing
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.core import annealing as TA
from repro_torch.core import evolve
from repro_torch.core import hyper as TH
from repro_torch.core import islands as TI
from repro_torch.core import nsga2 as TN
from repro_torch.core import objectives as O
from repro_torch.core import portfolio as TP
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet

WORLD, P, MIGRATE, SEED, JOIN_S = 2, 4, 2, 7, 60
CASES = {
    "nsga2": ("nsga2", TN.NSGA2Config(pop_size=8), 6),
    "nsga2_reduced": ("nsga2", TN.NSGA2Config(pop_size=8, reduced=True), 6),
    "sa": ("sa", TA.SAConfig(), 12),
}
ROUNDS, GENS_PER_ROUND = 3, 4


def _problem():
    return tnet.make_problem(tdev.get_device("xcvu_test"))


def _gen(seed=SEED):
    return torch.Generator().manual_seed(seed)


def _rank_main(rank, store_path, out_path):
    """One rank: every distributed run of the module, saved to `out_path`."""
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, WORLD), rank=rank, world_size=WORLD,
            timeout=datetime.timedelta(seconds=JOIN_S))
        problem, icfg, out = _problem(), TI.IslandConfig(P, MIGRATE), {}
        for name, (algo, cfg, n) in CASES.items():
            out[name] = TI.run(problem, algo, cfg, _gen(), n, islands=icfg, device="cpu")
        algo, cfg, n = CASES["nsga2"]
        out["explicit_group"] = TI.run(problem, algo, cfg, _gen(), n, islands=icfg,
                                       device="cpu", group=dist.new_group([0, 1]))
        try:
            TI.run(problem, algo, cfg, _gen(), n, islands=TI.IslandConfig(3, MIGRATE),
                   device="cpu", group=dist.group.WORLD)
            out["p3"] = "ran"
        except ValueError as e:
            out["p3"] = f"ValueError: {e}"
        out["run_islands"] = evolve.run_islands(
            problem, "nsga2", TN.NSGA2Config(pop_size=8), _gen(), ROUNDS, GENS_PER_ROUND,
            group=dist.group.WORLD, device="cpu")
        torch.save(out, out_path)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both ranks' results, from one spawn of 2 processes."""
    tmp = tmp_path_factory.mktemp("islands_dist")
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "store"), str(outs[r])))
             for r in range(WORLD)]
    for proc in procs:
        proc.start()
    deadline = time.monotonic() + JOIN_S
    for proc in procs:
        proc.join(max(deadline - time.monotonic(), 0))
    hung = [p.pid for p in procs if p.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join(5)
    assert not hung, f"ranks {hung} did not finish within {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * WORLD
    return [torch.load(o, weights_only=False) for o in outs]


def _leaves(tree):
    return torch.utils._pytree.tree_leaves(tree)


def _assert_equal(got, want):
    got_l, want_l = _leaves(got), _leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(CASES))
def test_run_over_two_ranks_equals_one_process(ranks, name):
    algo, cfg, n = CASES[name]
    want = TI.run(_problem(), algo, cfg, _gen(), n, islands=TI.IslandConfig(P, MIGRATE),
                  device="cpu")
    assert want[1].shape == (n, P, 2)
    for rank in ranks:
        _assert_equal(rank[name], want)


def test_explicit_group_equals_default_group(ranks):
    for rank in ranks:
        _assert_equal(rank["explicit_group"], rank["nsga2"])


def test_indivisible_islands_raise(ranks):
    for rank in ranks:
        assert rank["p3"].startswith("ValueError") and "divide" in rank["p3"]


def _run_islands_in_one_process():
    """`run_islands`'s draws and adoptions, both islands in this process."""
    problem = _problem()
    cfg_t = TH.tracify(TN.NSGA2Config(pop_size=8), torch.device("cpu"))
    gens = TP.member_generators(WORLD, None, _gen(), torch.device("cpu"))
    states = [TN.init_state(problem, g, cfg_t) for g in gens]
    hist = torch.empty(ROUNDS, WORLD, 2)
    for i in range(ROUNDS):
        for _ in range(GENS_PER_ROUND):
            states = [TN.step_impl(problem, cfg_t, s, g) for s, g in zip(states, gens)]
        champs = [TI.champion(s) for s in states]
        states = [TI.adopt(s, *champs[(r + 1) % WORLD]) for r, s in enumerate(states)]
        hist[i] = torch.stack([evolve.state_best_objs(s) for s in states])
    return TP.stack(states), hist


def test_run_islands_equals_one_process_loop(ranks):
    want = _run_islands_in_one_process()
    for rank in ranks:
        _assert_equal(rank["run_islands"], want)


def test_run_islands_migration_improves(ranks):
    """The reference's check (`tests/test_algorithms.py::
    test_islands_migration_improves`) on the port's two-rank run."""
    _, hist = ranks[0]["run_islands"]
    assert hist.shape == (ROUNDS, WORLD, 2) and torch.isfinite(hist).all()
    c = np.asarray(O.combined_metric(hist))
    assert c[-1].min() <= c[0].min()


def test_run_islands_world_of_one_adopts_its_own_champion():
    """group=None is one island, which adopts its own champion each round."""
    problem, cfg = _problem(), TN.NSGA2Config(pop_size=8)
    states, hist = evolve.run_islands(problem, "nsga2", cfg, _gen(), 2, 3, device="cpu")
    assert hist.shape == (2, 1, 2) and states["objs"].shape == (1, 8, 2)
    with pytest.raises(ValueError, match="population"):
        evolve.run_islands(problem, "sa", TA.SAConfig(), _gen(), 1, 1, device="cpu")
