"""The port's hyperparameter portfolio (`repro_torch.core.portfolio`) on the CPU.

`stack_configs` / `merge_config` are held against the reference's.  The
stochastic parts are held by "a batched member is the independent run":
every member of `run_portfolio` equals `evolve.run` with its config and
generator bit for bit, for all four algorithms.  Every vmapped body runs
with vmap's per-slice fallback warning turned into an error, and the aten
op count of one batched generation does not grow with K.
"""
import warnings

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import hyper as RH
from repro.core import nsga2 as RN
from repro_torch.core import annealing as TA
from repro_torch.core import cmaes as TC
from repro_torch.core import evolve as tevolve
from repro_torch.core import ga as TGA
from repro_torch.core import hyper as TH
from repro_torch.core import nsga2 as TN
from repro_torch.core import portfolio as TP
from repro_torch.core import warmstart as TW
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet

PORT = tnet.make_problem(tdev.get_device("xcvu_test"))

# (algo, K configs differing in their float fields, generations)
CASES = {
    "nsga2": ("nsga2", [TN.NSGA2Config(pop_size=8, sbx_eta=e, real_mut_prob=p)
                        for e, p in ((10.0, 0.1), (15.0, 0.2), (20.0, 0.3))], 4),
    "nsga2_reduced": ("nsga2", [TN.NSGA2Config(pop_size=8, reduced=True, perm_swap_prob=p)
                                for p in (0.3, 0.6, 0.9)], 4),
    "nsga2_fused": ("nsga2", [TN.NSGA2Config(pop_size=8, fused=True, mut_eta=e)
                              for e in (10.0, 30.0)], 3),
    "ga": ("ga", [TGA.GAConfig(pop_size=8, crossover_prob=c) for c in (0.5, 0.9, 1.0)], 4),
    "cmaes": ("cmaes", [TC.CMAESConfig(pop_size=6, sigma0=s) for s in (0.1, 0.3, 0.6)], 4),
    "sa": ("sa", [TA.SAConfig(t0=t, move_sigma=m) for t, m in ((1.0, 0.3), (2.0, 0.6), (4.0, 0.9))],
           12),
}


@pytest.fixture(autouse=True)
def no_batching_fallback():
    """vmap running an op slice by slice (no batching rule) is an error."""
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*performance drop.*batching rule")
        yield


def gens_of(seeds):
    return [torch.Generator().manual_seed(s) for s in seeds]


def assert_trees_equal(a, b):
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ------------------------------------------------------------------ hyper

def test_stack_configs_matches_reference():
    ref_cfgs = [RN.NSGA2Config(pop_size=8, sbx_eta=e, real_mut_prob=p)
                for e, p in ((10, 0.1), (15.5, 0.2), (20, 1 / 3))]
    port_cfgs = [TN.NSGA2Config(**vars(c)) for c in ref_cfgs]
    (rcls, rstatic), rtraced = RH.stack_configs(ref_cfgs)
    (pcls, pstatic), ptraced = TH.stack_configs(port_cfgs, "cpu")
    assert pcls is TN.NSGA2Config and rcls.__name__ == pcls.__name__
    assert pstatic == rstatic
    assert sorted(ptraced) == sorted(rtraced)
    for n, v in ptraced.items():
        assert v.dtype == torch.float32 and v.shape == (3,)
        np.testing.assert_array_equal(v.numpy(), np.asarray(rtraced[n]))
    for i, c in enumerate(port_cfgs):
        merged = TH.unstack_config((pcls, pstatic), ptraced, i)
        want = TH.tracify(c, "cpu")
        for n, v in vars(want).items():
            got = getattr(merged, n)
            assert torch.equal(got, v) if isinstance(v, torch.Tensor) else got == v
    # merge_config rebuilds the instance from a split, as the reference's does
    sk, tr = TH.split_config(port_cfgs[1])
    assert TH.merge_config(sk, tr) == port_cfgs[1]
    rsk, rtr = RH.split_config(ref_cfgs[1])
    assert vars(RH.merge_config(rsk, rtr)) == vars(TH.merge_config(sk, tr))


@pytest.mark.parametrize("mismatch", ["pop_size", "reduced", "empty"])
def test_stack_configs_refuses_what_the_reference_refuses(mismatch):
    if mismatch == "empty":
        ref_cfgs = port_cfgs = []
        match = "empty portfolio"
    else:
        other = {"pop_size": 16} if mismatch == "pop_size" else {"reduced": True}
        ref_cfgs = [RN.NSGA2Config(pop_size=8), RN.NSGA2Config(**{"pop_size": 8, **other})]
        port_cfgs = [TN.NSGA2Config(**vars(c)) for c in ref_cfgs]
        match = "agree on static fields"
    with pytest.raises(ValueError, match=match):
        RH.stack_configs(ref_cfgs)
    with pytest.raises(ValueError, match=match):
        TH.stack_configs(port_cfgs, "cpu")


# ------------------------------------------------------------- portfolio

@pytest.fixture(scope="module")
def portfolio_runs():
    out = {}
    for name, (algo, cfgs, n) in CASES.items():
        seeds = range(10, 10 + len(cfgs))
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*batching rule")
            res = TP.run_portfolio(PORT, algo, cfgs, gens=gens_of(seeds), n_gens=n,
                                   device="cpu")
        solo = [tevolve.run(PORT, algo, c, torch.Generator().manual_seed(s), n, device="cpu")
                for c, s in zip(cfgs, seeds)]
        out[name] = (res, solo)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_portfolio_members_equal_independent_runs(portfolio_runs, case):
    res, solo = portfolio_runs[case]
    k, n = len(CASES[case][1]), CASES[case][2]
    assert res.history.shape == (k, n, 2)
    for i, (state, hist) in enumerate(solo):
        assert_trees_equal(res.member_state(i), state)
        assert torch.equal(res.history[i], hist)
        assert torch.equal(res.best_objs[i], tevolve.state_best_objs(state))
    metric = res.best_objs[:, 0] * res.best_objs[:, 1]
    assert torch.equal(res.metric, metric) and res.champion == int(torch.argmin(metric))
    assert torch.equal(res.champion_objs, res.best_objs[res.champion])


def test_portfolio_seeds_members_from_one_generator():
    _, cfgs, n = CASES["ga"]
    res = TP.run_portfolio(PORT, "ga", cfgs, gen=torch.Generator().manual_seed(5), n_gens=2,
                           device="cpu")
    seeds = torch.randint(0, 2 ** 62, (len(cfgs),), generator=torch.Generator().manual_seed(5))
    want = TP.run_portfolio(PORT, "ga", cfgs, gens=gens_of(seeds.tolist()), n_gens=2,
                            device="cpu")
    assert_trees_equal(res.states, want.states)
    assert len(set(seeds.tolist())) == len(cfgs)
    with pytest.raises(ValueError, match="gens="):
        TP.run_portfolio(PORT, "ga", cfgs, n_gens=1, device="cpu")
    with pytest.raises(ValueError, match="2 generators for 3 members"):
        TP.run_portfolio(PORT, "ga", cfgs, gens=gens_of([0, 1]), n_gens=1, device="cpu")


# ------------------------------------------------------------------ race

def test_race_quantizes_stops_and_follows_the_portfolio():
    _, cfgs, _ = CASES["nsga2"]
    # rounds quantize up: 5 generations in rounds of 2 run 3 rounds
    res = TP.race(PORT, "nsga2", cfgs, gen=torch.Generator().manual_seed(2), max_gens=5,
                  gens_per_round=2, patience=10, device="cpu")
    assert (res.rounds, res.gens) == (3, 6) and res.history.shape == (3, 3, 2)
    full = TP.run_portfolio(PORT, "nsga2", cfgs, gen=torch.Generator().manual_seed(2),
                            n_gens=6, device="cpu")
    assert_trees_equal(res.states, full.states)
    for r in range(res.rounds):
        assert torch.equal(res.history[r], full.history[:, 2 * r + 1])
    assert res.champion == full.champion and torch.equal(res.metric, full.metric)
    # an rtol no later round meets (a 100x better metric): the first round
    # improves on inf, then `patience` stalled rounds stop the race
    res = TP.race(PORT, "nsga2", cfgs, gen=torch.Generator().manual_seed(2), max_gens=40,
                  gens_per_round=1, patience=2, rtol=0.99, device="cpu")
    assert (res.rounds, res.gens) == (3, 3)
    assert_trees_equal(res.states, TP.run_portfolio(
        PORT, "nsga2", cfgs, gen=torch.Generator().manual_seed(2), n_gens=3,
        device="cpu").states)
    with pytest.raises(ValueError, match="max_gens"):
        TP.race(PORT, "nsga2", cfgs, gen=torch.Generator(), max_gens=0, device="cpu")


# --------------------------------------------------------- batched program

class OpCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["nsga2", "nsga2_reduced", "nsga2_fused", "ga", "cmaes", "sa"])
def test_batched_generation_op_count_does_not_grow_with_k(case):
    algo, cfgs, _ = CASES[case]
    counts = {}
    for k in (1, 4):
        members = [cfgs[i % len(cfgs)] for i in range(k)]
        static_key, traced = TH.stack_configs(members, "cpu")
        gens = gens_of(range(k))
        states = TP.member_init(PORT, algo, static_key, traced, gens)
        member_cfgs = [TH.unstack_config(static_key, traced, i) for i in range(k)]
        draws = TP.member_draws(PORT, algo, member_cfgs, states, gens)
        body = TP.batched_body(PORT, algo, static_key)
        with OpCount() as mode:
            body(traced, states, draws)
        counts[k] = mode.ops
    assert len(counts[1]) == len(counts[4]) and counts[1] == counts[4]


def test_member_warm_init_is_warm_state_of_the_merged_config():
    cfgs = [TC.CMAESConfig(pop_size=6, sigma0=s) for s in (0.2, 0.5)]
    static_key, traced = TH.stack_configs(cfgs, "cpu")
    seed = TP.run_portfolio(PORT, "cmaes", cfgs[:1], gens=gens_of([0]), n_gens=2,
                            device="cpu").member_state(0)
    pop, fresh = TW.canonicalize(PORT, TP.best_genotype(PORT, "cmaes", seed)[0], 1)
    jitter, shrink = torch.tensor(0.15), torch.tensor(0.5)
    got = TW.member_warm_init(PORT, "cmaes", static_key, {n: v[1] for n, v in traced.items()},
                              pop, fresh, jitter, shrink, torch.Generator().manual_seed(3))
    want = TW.warm_state(PORT, "cmaes", TH.tracify(cfgs[1], "cpu"), pop, fresh,
                         torch.Generator().manual_seed(3), jitter, shrink)
    assert_trees_equal(got, want)
    assert float(got["sigma"]) == pytest.approx(0.25)
