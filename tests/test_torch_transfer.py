"""The port's transfer, warm start, pipelining and floorplan against the
reference.

Genotypes are drawn with numpy and handed to both packages.  Pipelining
stages and registers, floorplans and migrated genotypes must equal the
reference's exactly (MHz within 1e-6 relative); warm-start blocks keep the
seed in row 0; CMA-ES and SA states cross between the packages unchanged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _kernel_sweeps import tol
from test_torch_genotype import _genotypes

from repro.core import annealing as RA
from repro.core import cmaes as RC
from repro.core import genotype as RG
from repro.core import objectives as RO
from repro.core import pipelining as RPL
from repro.core import transfer as RT
from repro.core import warmstart as RW
from repro.fpga import device as rdev
from repro.fpga import floorplan as RF
from repro.fpga import netlist as rnet
from repro_torch.core import annealing as TA
from repro_torch.core import cmaes as TC
from repro_torch.core import convert
from repro_torch.core import ga as TGA
from repro_torch.core import genotype as TG
from repro_torch.core import hyper as TH
from repro_torch.core import nsga2 as TN
from repro_torch.core import objectives as TO
from repro_torch.core import pipelining as TPL
from repro_torch.core import transfer as TT
from repro_torch.core import warmstart as TW
from repro_torch.fpga import device as tdev
from repro_torch.fpga import floorplan as TF
from repro_torch.fpga import netlist as tnet

PAIRS = [("xcvu3p", "xcvu5p"), ("xcvu11p", "xcvu13p"), ("xcvu3p", "xcvu11p")]
NAMES = sorted({n for pair in PAIRS for n in pair} | {"xcvu_test", "xcvu_test2"})
PORT = {n: tnet.make_problem(tdev.get_device(n)) for n in NAMES}
REF = {n: rnet.make_problem(rdev.get_device(n)) for n in NAMES}


def _one(problem, seed, scale=0.5):
    """One numpy genotype (1-D leaves)."""
    return jax.tree.map(lambda a: a[0], _genotypes(problem, 1, seed, scale))


def _assert_genotype_equal(got, want):
    for a, b in zip(jax.tree.leaves(convert.genotype_to_numpy(got)),
                    jax.tree.leaves(jax.tree.map(np.asarray, want)), strict=True):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ pipelining

@pytest.mark.parametrize("name,seed", [("xcvu_test", 0), ("xcvu_test", 1), ("xcvu11p", 2)])
def test_pipelining_matches_reference(name, seed):
    g = _one(REF[name], seed)
    tg = convert.genotype_from_numpy(g)
    for target in (400.0, 650.0, 800.0):
        want = RPL.auto_pipeline(REF[name], g, target)
        got = TPL.auto_pipeline(PORT[name], tg, target)
        np.testing.assert_array_equal(got.stages_per_net, want.stages_per_net)
        assert (got.total_registers, got.depth) == (want.total_registers, want.depth)
        np.testing.assert_allclose(got.max_net_rpm, want.max_net_rpm, rtol=1e-6)
        np.testing.assert_allclose(got.freq_mhz, want.freq_mhz, rtol=1e-6)
    want, got = RPL.depth_sweep(REF[name], g, 3), TPL.depth_sweep(PORT[name], tg, 3)
    for d in range(4):
        assert got[d]["registers"] == want[d]["registers"] == TPL.registers_at_depth(PORT[name], d)
        np.testing.assert_allclose(got[d]["freq_mhz"], want[d]["freq_mhz"], rtol=1e-6)
    with pytest.raises(ValueError, match="ceiling"):
        TPL.auto_pipeline(PORT[name], tg, 1000.0)


# ------------------------------------------------------------- floorplan

@pytest.mark.parametrize("name", ["xcvu_test", "xcvu11p"])
def test_floorplan_matches_reference(name):
    g = _one(REF[name], 5)
    tg = convert.genotype_from_numpy(g)
    assert TF.ascii_floorplan(PORT[name]) == RF.ascii_floorplan(REF[name])
    for kw in ({}, {"width": 100, "height": 24, "highlight_unit": 3}):
        assert TF.ascii_floorplan(PORT[name], tg, **kw) == RF.ascii_floorplan(REF[name], g, **kw)


# --------------------------------------------------------------- migrate

@pytest.mark.parametrize("src,dst", PAIRS)
def test_migrate_matches_reference(src, dst):
    g = _one(REF[src], 7)
    want = RT.migrate(REF[src], REF[dst], g)
    got = TT.migrate(PORT[src], PORT[dst], convert.genotype_from_numpy(g))
    _assert_genotype_equal(got, want)
    TO.assert_valid(PORT[dst], got)


def test_auto_migrate_is_identity_on_equal_signatures():
    g = convert.genotype_from_numpy(_one(REF["xcvu_test"], 8))
    assert TT.auto_migrate(PORT["xcvu_test"], PORT["xcvu_test"], g) is g
    src, dst = PORT["xcvu3p"], PORT["xcvu5p"]
    assert src.signature != dst.signature
    g = convert.genotype_from_numpy(_one(REF["xcvu3p"], 8))
    _assert_genotype_equal(TT.auto_migrate(src, dst, g), TT.migrate(src, dst, g))


# ------------------------------------------------------------ warm start

def test_canonicalize_matches_reference():
    prob, tprob = REF["xcvu_test"], PORT["xcvu_test"]
    stacked = _genotypes(prob, 5, 9, 0.5)
    single = jax.tree.map(lambda a: a[0], stacked)
    for init, n_rows in ((single, 4), (stacked, 8), (stacked, 3), (tuple(single["perm"]), 2)):
        want_pop, want_fresh = RW.canonicalize(prob, init, n_rows)
        got_pop, got_fresh = TW.canonicalize(tprob, init, n_rows)
        _assert_genotype_equal(got_pop, want_pop)
        np.testing.assert_array_equal(got_fresh.numpy(), want_fresh)
    with pytest.raises(ValueError, match="rank-1"):
        TW.canonicalize(tprob, {**single, "dist": stacked["dist"]}, 2)
    with pytest.raises(TypeError):
        TW.canonicalize(tprob, {"dist": single["dist"]}, 2)


def test_jitter_body_matches_reference():
    """`_jitter_body` on the draws the reference's `jitter_genotype` derives
    from its keys: permutations exact, real tiers within tol."""
    prob = REF["xcvu_test"]
    pop = _genotypes(prob, 6, 10, 0.5)
    jitter = jnp.float32(0.15)
    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    want = jax.jit(jax.vmap(lambda k, g: RW.jitter_genotype(prob, k, g, jitter)))(keys, pop)

    def draws(k, g):
        kk = jax.random.split(k, 7)
        swap_prob = jnp.clip(jitter * (0.5 / 0.15), 0.0, 1.0)
        perm = []
        for t in range(3):
            n = g["perm"][t].shape[0]

            def swap(ks, n=n):
                ki, kj, kd = jax.random.split(ks, 3)
                return (jax.random.randint(ki, (), 0, n), jax.random.randint(kj, (), 0, n),
                        jax.random.bernoulli(kd, swap_prob))

            perm.append(jax.vmap(swap)(jax.random.split(jax.random.fold_in(kk[6], t), 2)))
        return {"dist": [jax.random.normal(kk[t], g["dist"][t].shape) for t in range(3)],
                "loc": [jax.random.normal(kk[3 + t], g["loc"][t].shape) for t in range(3)],
                "perm": perm}

    d = jax.tree.map(np.asarray, jax.jit(jax.vmap(draws))(keys, pop))
    d["perm"] = [tuple(torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a)
                       for a in p) for p in d["perm"]]
    d["dist"], d["loc"] = ([torch.tensor(a) for a in d[k]] for k in ("dist", "loc"))
    got = convert.genotype_to_numpy(TW._jitter_body(convert.genotype_from_numpy(pop), d,
                                                    torch.tensor(np.float32(0.15))))
    for t in range(3):
        np.testing.assert_array_equal(got["perm"][t], np.asarray(want["perm"][t]))
        for part in ("dist", "loc"):
            np.testing.assert_allclose(got[part][t], np.asarray(want[part][t]), **tol(np.float32))


WARM_CFGS = {"nsga2": ("nsga2", TN.NSGA2Config(pop_size=6)),
             "ga": ("ga", TGA.GAConfig(pop_size=6)),
             "nsga2-reduced": ("nsga2", TN.NSGA2Config(pop_size=6, reduced=True)),
             "cmaes": ("cmaes", TC.CMAESConfig(sigma0=0.2)),
             "sa": ("sa", TA.SAConfig(t0=1.5))}


@pytest.mark.parametrize("case", list(WARM_CFGS))
def test_warm_state_starts_at_seed(case):
    algo, cfg = WARM_CFGS[case]
    prob = PORT["xcvu_test"]
    seed = convert.genotype_from_numpy(_one(REF["xcvu_test"], 12))
    n_rows = TW.seed_rows(algo, TH.split_config(cfg)[0])
    assert n_rows == (6 if algo in TW.POPULATION_ALGOS else 1)
    pop, fresh = TW.canonicalize(prob, seed, n_rows)
    state = TW.warm_state(prob, algo, cfg, pop, fresh, torch.Generator().manual_seed(0),
                          torch.tensor(0.15), torch.tensor(0.5))
    seed_objs = TO.evaluate(prob, seed)
    if algo in TW.POPULATION_ALGOS:
        assert state["objs"].shape == (6, 2)
        row0 = TG.tree_map(lambda a: a[0], state["pop"])
        if getattr(cfg, "reduced", False):
            _assert_genotype_equal(row0, convert.genotype_to_numpy(seed["perm"]))
            return
        _assert_genotype_equal(row0, convert.genotype_to_numpy(seed))
        torch.testing.assert_close(state["objs"][0], seed_objs)
        assert not torch.equal(state["pop"]["dist"][0][1], state["pop"]["dist"][0][0])
        return
    z = TG.to_flat(prob, TG.tree_map(lambda a: a[None], seed))[0]
    assert torch.equal(state["best_z"], z) and torch.equal(state["best_objs"], seed_objs)
    if algo == "cmaes":
        assert torch.equal(state["mean"], z)
        torch.testing.assert_close(state["sigma"], torch.tensor(0.1))
    else:
        assert torch.equal(state["z"], z) and float(state["t_adapt"]) == 1.5


def test_seed_population_and_seed_cmaes_start_at_seed(small_problem):
    prob = PORT["xcvu_test"]
    g = _one(REF["xcvu_test"], 13)
    tg = convert.genotype_from_numpy(g)
    st = TT.seed_population(prob, tg, torch.Generator().manual_seed(1), 8)
    _assert_genotype_equal(TG.tree_map(lambda a: a[0], st["pop"]), g)
    assert st["objs"].shape == (8, 2)
    state, cfg = TT.seed_cmaes(prob, tg, torch.Generator().manual_seed(1))
    assert cfg.sigma0 == 0.08
    want = np.asarray(RG.to_flat(small_problem, jax.tree.map(jnp.asarray, g)))
    np.testing.assert_allclose(state["mean"].numpy(), want, **tol(np.float32))
    back = TG.from_flat(prob, state["mean"][None])
    for t in range(3):
        np.testing.assert_array_equal(back["perm"][t][0].numpy(), g["perm"][t])


def test_warm_start_beats_scratch_early(small_problem):
    """A champion converged on xcvu_test, migrated to xcvu_test2, seeds a
    population whose first generation is at least as good as a scratch
    run's (the property of the reference's test_transfer_beats_scratch_early)."""
    src, dst = PORT["xcvu_test"], PORT["xcvu_test2"]
    champ = TT.converge_champion(src, torch.Generator().manual_seed(2), 8, 15)
    g = TT.migrate(src, dst, champ)
    checks = RO.validate_placement(REF["xcvu_test2"], convert.genotype_to_numpy(g))
    assert all(checks.values()), checks
    cfg = TH.tracify(TN.NSGA2Config(pop_size=8), "cpu")
    gen = torch.Generator().manual_seed(3)
    warm = TN.step_impl(dst, cfg, TT.seed_population(dst, g, gen, 8), gen)
    scratch = TN.step_impl(dst, cfg, TN.init_state(dst, gen, cfg), gen)
    best = [float(TO.combined_metric(s["objs"]).min()) for s in (warm, scratch)]
    assert best[0] <= best[1], best


# ----------------------------------------------------- state conversion

@pytest.mark.parametrize("algo", ["cmaes", "sa"])
def test_point_states_round_trip(small_problem, algo):
    key = jax.random.PRNGKey(14)
    ref = (RC.init_state(small_problem, key, RC.CMAESConfig()) if algo == "cmaes"
           else RA.init_state(small_problem, key, RA.SAConfig()))
    ref = jax.tree.map(np.asarray, ref)
    port = convert.state_from_numpy(ref)
    for k in ("gen",) if algo == "cmaes" else ("k",):
        assert port[k].dtype == torch.int32 and port[k].dim() == 0
    back = convert.state_to_numpy(port)
    assert sorted(back) == sorted(ref)
    for k in ref:
        assert back[k].dtype == ref[k].dtype and back[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(back[k], ref[k])
