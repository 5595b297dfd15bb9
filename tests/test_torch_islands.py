"""The port's island model (`repro_torch.core.islands`) on the CPU.

The deterministic pieces (`IslandConfig`, `champion`, `adopt`,
`migrate_ring`) get the same numpy states as the reference, un-jitted, and
must return its result exactly.  The stochastic parts are held by "an
island is a run": islands(P=1) is `evolve.run` bit for bit for all four
algorithms, islands that never migrate are independent runs, and migration
counts global generations (two half rounds are one round; the host-decided
and the tensor `g0` forms agree).  Every vmapped body runs with vmap's
per-slice fallback warning turned into an error.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_portfolio import assert_trees_equal

from repro.core import islands as RI
from repro_torch.core import annealing as TA
from repro_torch.core import cmaes as TC
from repro_torch.core import convert
from repro_torch.core import evolve as tevolve
from repro_torch.core import ga as TGA
from repro_torch.core import hyper as TH
from repro_torch.core import islands as TI
from repro_torch.core import nsga2 as TN
from repro_torch.core import portfolio as TP
from repro_torch.core import warmstart as TW
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet

PORT = tnet.make_problem(tdev.get_device("xcvu_test"))

ALGOS = {
    "nsga2": ("nsga2", TN.NSGA2Config(pop_size=8), 4),
    "nsga2_reduced": ("nsga2", TN.NSGA2Config(pop_size=8, reduced=True), 4),
    "ga": ("ga", TGA.GAConfig(pop_size=8), 4),
    "cmaes": ("cmaes", TC.CMAESConfig(pop_size=6), 4),
    "sa": ("sa", TA.SAConfig(), 12),
}


@pytest.fixture(autouse=True)
def no_batching_fallback():
    """vmap running an op slice by slice (no batching rule) is an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*batching rule")
        yield


# ------------------------------------------------------------ config

@pytest.mark.parametrize("kwargs", [dict(n_islands=0), dict(migrate_every=-1),
                                    dict(n_islands=3, migrate_every=2), dict()])
def test_island_config_validates_as_the_reference(kwargs):
    try:
        want = RI.IslandConfig(**kwargs)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split(",")[0]):
            TI.IslandConfig(**kwargs)
        return
    got = TI.IslandConfig(**kwargs)
    assert vars(got) == vars(want) and got.active == want.active
    assert hash(got) == hash(TI.IslandConfig(**kwargs))


def test_island_generators():
    gen = torch.Generator().manual_seed(1)
    assert TI.island_generators(gen, 1)[0] is gen
    seeds = [g.initial_seed() for g in TI.island_generators(torch.Generator().manual_seed(1), 3)]
    assert seeds == torch.randint(0, 2 ** 62, (3,),
                                  generator=torch.Generator().manual_seed(1)).tolist()


# ------------------------------------------------------------ migration

def _stacked_numpy_state(algo, cfg, p=4, seed=0):
    """An island-stacked state after two generations of the port, as numpy,
    with planted ties: two rows of island 1 share its best combined metric
    and two its worst, so argmin / argmax must take the first; island 2's
    point best is made worse than island 1's, island 3's better than
    island 2's."""
    state, _ = tevolve.run(PORT, algo, cfg, torch.Generator().manual_seed(seed), 2,
                           islands=TI.IslandConfig(p, 0), device="cpu")
    state = convert.state_to_numpy(state)
    if "pop" in state:
        objs = state["objs"]
        c = objs[..., 0] * objs[..., 1]
        lo, hi = np.argmin(c[1]), np.argmax(c[1])
        objs[1, (lo + 1) % objs.shape[1]] = objs[1, lo]
        objs[1, (hi + 2) % objs.shape[1]] = objs[1, hi]
    else:
        state["best_objs"][2] = state["best_objs"][1] * 1.5
        state["best_objs"][3] = state["best_objs"][2] * 0.5
    return state


def _island(state, i):
    return jax.tree.map(lambda a: jnp.asarray(a[i]), state)


def _assert_numpy_equal(got, want):
    got_l, want_l = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got_l) == len(want_l)
    for a, b in zip(got_l, want_l):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("case", ["nsga2", "nsga2_reduced", "cmaes", "sa"])
def test_champion_adopt_and_migrate_ring_match_reference(case):
    algo, cfg, _ = ALGOS[case]
    state = _stacked_numpy_state(algo, cfg)
    port = convert.state_from_numpy(state)
    for i in range(4):
        _assert_numpy_equal(convert.genotype_to_numpy(TI.champion(TP.member(port, i))),
                            RI.champion(_island(state, i)))
    # island 0 adopts island 2's champion
    want = RI.adopt(_island(state, 0), *RI.champion(_island(state, 2)))
    got = TI.adopt(TP.member(port, 0), *TI.champion(TP.member(port, 2)))
    _assert_numpy_equal(convert.state_to_numpy(got), want)
    # the whole ring
    want = RI.migrate_ring(jax.tree.map(jnp.asarray, state))
    got = convert.state_to_numpy(TI.migrate_ring(port))
    _assert_numpy_equal(got, want)
    key = "objs" if "pop" in state else "best_objs"
    assert not np.array_equal(got[key], state[key])     # something migrated


# ------------------------------------------------------------ whole runs

@pytest.mark.parametrize("case", list(ALGOS))
def test_one_island_is_the_single_population_run(case):
    algo, cfg, n = ALGOS[case]
    st, hist = tevolve.run(PORT, algo, cfg, torch.Generator().manual_seed(3), n, device="cpu")
    sti, histi = tevolve.run(PORT, algo, cfg, torch.Generator().manual_seed(3), n,
                             islands=TI.IslandConfig(1, 2), device="cpu")
    assert histi.shape == (n, 1, 2)
    assert torch.equal(histi[:, 0], hist)
    assert_trees_equal(TP.member(sti, 0), st)


@pytest.mark.parametrize("case", ["nsga2", "cmaes", "sa"])
def test_islands_that_never_migrate_are_independent_runs(case):
    algo, cfg, n = ALGOS[case]
    sti, histi = tevolve.run(PORT, algo, cfg, torch.Generator().manual_seed(4), n,
                             islands=TI.IslandConfig(3, 0), device="cpu")
    assert histi.shape == (n, 3, 2)
    for i, g in enumerate(TI.island_generators(torch.Generator().manual_seed(4), 3)):
        st, hist = tevolve.run(PORT, algo, cfg, torch.Generator().manual_seed(g.initial_seed()),
                               n, device="cpu")
        assert_trees_equal(TP.member(sti, i), st)
        assert torch.equal(histi[:, i], hist)


@pytest.mark.parametrize("case", ["nsga2", "ga", "sa"])
def test_migration_counts_global_generations(case):
    algo, cfg, n = ALGOS[case]
    icfg = TI.IslandConfig(3, 2)
    full, hist = tevolve.run(PORT, algo, cfg, torch.Generator().manual_seed(5), n,
                             islands=icfg, device="cpu")
    sk, traced = TH.split_fields(TH.tracify(cfg, "cpu"))
    halves = []
    for g0 in (0, torch.tensor(0, dtype=torch.int32)):
        gens = TI.island_generators(torch.Generator().manual_seed(5), 3)
        st = TI.member_init(PORT, algo, sk, icfg, traced, gens)
        st, _ = TI.member_round(PORT, algo, sk, icfg, 3, traced, st, gens, g0)
        st, best = TI.member_round(PORT, algo, sk, icfg, n - 3, traced, st, gens, g0 + 3)
        halves.append(st)
        assert torch.equal(best, TI.best_over_islands(full))
    assert_trees_equal(halves[0], full)
    assert_trees_equal(halves[1], full)
    # migration did move something: without it the islands differ
    apart, _ = tevolve.run(PORT, algo, cfg, torch.Generator().manual_seed(5), n,
                           islands=TI.IslandConfig(3, 0), device="cpu")
    leaves = zip(torch.utils._pytree.tree_leaves(apart), torch.utils._pytree.tree_leaves(full))
    assert not all(torch.equal(a, b) for a, b in leaves)


@pytest.mark.parametrize("case", ["nsga2", "cmaes"])
def test_warm_seed_lands_on_island_0(case):
    algo, cfg, _ = ALGOS[case]
    src, _ = tevolve.run(PORT, algo, cfg, torch.Generator().manual_seed(6), 2, device="cpu")
    g, objs = TP.best_genotype(PORT, algo, src)
    sk, traced = TH.split_fields(TH.tracify(cfg, "cpu"))
    pop, fresh = TW.canonicalize(PORT, g, TW.seed_rows(algo, sk))
    jitter, shrink = torch.tensor(0.15), torch.tensor(0.5)
    icfg = TI.IslandConfig(3, 1)
    gens = TI.island_generators(torch.Generator().manual_seed(7), 3)
    warm = TI.member_warm_init(PORT, algo, sk, icfg, traced, pop, fresh, jitter, shrink, gens)
    want0 = TW.member_warm_init(PORT, algo, sk, traced, pop, fresh, jitter, shrink,
                                torch.Generator().manual_seed(gens[0].initial_seed()))
    assert_trees_equal(TP.member(warm, 0), want0)
    best = TP.best_objs(warm)
    assert float(best[0, 0] * best[0, 1]) <= float(objs[0] * objs[1])
    for i in (1, 2):      # cold islands
        cold = TP.member_init(PORT, algo, *TH.stack_configs([cfg], "cpu"),
                              [torch.Generator().manual_seed(gens[i].initial_seed())])
        assert_trees_equal(TP.member(warm, i), TP.member(cold, 0))
    _, got_objs = TI.best_genotype(PORT, algo, warm)
    assert torch.equal(got_objs, TI.best_over_islands(warm))


def test_a_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="queue 1 item 8b"):
        TI.run(PORT, "nsga2", TN.NSGA2Config(pop_size=4), torch.Generator(), 1,
               TI.IslandConfig(2, 1), mesh=object(), device="cpu")
    sk, traced = TH.split_fields(TH.tracify(TN.NSGA2Config(pop_size=4), "cpu"))
    with pytest.raises(ValueError, match="1 generators for 2 islands"):
        TI.member_init(PORT, "nsga2", sk, TI.IslandConfig(2, 1), traced, [torch.Generator()])
