"""Whole runs of the port against the reference, on the CPU.

Bitwise trajectories are not a goal (jax's threefry and torch's Philox
never agree).  What must hold: a reference population evaluates to the
same objectives in the port; fused and unfused runs of the port are
identical for one generator; port champions pass the reference's own
`validate_placement`; and for each of the four algorithms the port's
median final metric over three seeds is within a factor of the
reference's at the same budget, from both sides.
"""
import jax
import numpy as np
import pytest
import torch
from _kernel_sweeps import tol
from test_torch_baselines import BUDGETS, port_run

from repro.core import annealing as RA
from repro.core import cmaes as RC
from repro.core import evolve as revolve
from repro.core import ga as RGA
from repro.core import nsga2 as RN
from repro.core import objectives as RO
from repro_torch.core import annealing as TA
from repro_torch.core import cmaes as TC
from repro_torch.core import convert
from repro_torch.core import evolve as tevolve
from repro_torch.core import ga as TGA
from repro_torch.core import genotype as TG
from repro_torch.core import islands as TI
from repro_torch.core import nsga2 as TN
from repro_torch.core import objectives as TO
from repro_torch.core import portfolio as TP
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet
from repro_torch.launch import quickstart

PORT = tnet.make_problem(tdev.get_device("xcvu_test"))
POP, GENS, SEEDS = 16, 30, (0, 1, 2)


@pytest.fixture(scope="module")
def ref_init(small_problem):
    st = RN.init_state(small_problem, jax.random.PRNGKey(7), RN.NSGA2Config(pop_size=POP))
    return jax.tree.map(np.asarray, st)


@pytest.fixture(scope="module")
def ref_final_metrics(small_problem):
    out = []
    for s in SEEDS:
        st, _ = revolve.run(small_problem, "nsga2", RN.NSGA2Config(pop_size=POP),
                            jax.random.PRNGKey(s), GENS)
        out.append(float(np.min(np.asarray(RO.combined_metric(st["objs"])))))
    return out


@pytest.fixture(scope="module")
def port_runs():
    return [tevolve.run(PORT, "nsga2", TN.NSGA2Config(pop_size=POP),
                        torch.Generator().manual_seed(s), GENS, device="cpu")
            for s in SEEDS]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_reference_population_evaluates_the_same(ref_init, fused):
    st = convert.state_from_numpy(ref_init)
    got = TO.evaluate_population(PORT, st["pop"], fused)
    np.testing.assert_allclose(got.numpy(), ref_init["objs"], **tol(np.float32))


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_reference_reduced_population_evaluates_the_same(ref_init, small_problem, fused):
    perms = ref_init["pop"]["perm"]
    want = np.asarray(RN._eval_reduced(small_problem, perms))
    got = TN._eval_reduced(PORT, convert.genotype_from_numpy(perms), fused)
    np.testing.assert_allclose(got.numpy(), want, **tol(np.float32))


def test_state_conversion_round_trips(ref_init):
    for state in (ref_init, {"pop": ref_init["pop"]["perm"], "objs": ref_init["objs"]}):
        back = convert.state_to_numpy(convert.state_from_numpy(state))
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(state), strict=True):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_fused_and_unfused_runs_are_identical_on_cpu():
    runs = [tevolve.run(PORT, "nsga2", TN.NSGA2Config(pop_size=8, fused=f),
                        torch.Generator().manual_seed(3), 8, device="cpu")
            for f in (False, True)]
    (s0, h0), (s1, h1) = runs
    assert torch.equal(h0, h1) and torch.equal(s0["objs"], s1["objs"])
    for a, b in zip(jax.tree.leaves(s0["pop"]), jax.tree.leaves(s1["pop"]), strict=True):
        assert torch.equal(a, b)


def test_reduced_run_yields_legal_champion(small_problem):
    state, hist = tevolve.run(PORT, "nsga2", TN.NSGA2Config(pop_size=8, reduced=True),
                              torch.Generator().manual_seed(1), 5, device="cpu")
    assert isinstance(state["pop"], tuple) and hist.shape == (5, 2)
    full = TG.reduced_to_full(PORT, state["pop"])
    champ = int(torch.argmin(TO.combined_metric(state["objs"])))
    g = convert.genotype_to_numpy(TG.tree_map(lambda a: a[champ], full))
    assert all(RO.validate_placement(small_problem, g).values())


def test_port_champions_pass_reference_validation(port_runs, small_problem):
    for state, hist in port_runs:
        assert hist.shape == (GENS, 2) and torch.isfinite(hist).all()
        champ = int(torch.argmin(TO.combined_metric(state["objs"])))
        g = convert.genotype_to_numpy(TG.tree_map(lambda a: a[champ], state["pop"]))
        checks = RO.validate_placement(small_problem, g)
        assert all(checks.values()), checks
        np.testing.assert_array_equal(hist[-1].numpy(), state["objs"][champ].numpy())


# The port's median final metric over the seeds, over the reference's, must
# lie in QUALITY.  A check of 24 seeds per algorithm at larger budgets found
# 0.84-1.04 (NSGA-II 0.996, GA 0.843, CMA-ES 0.947, SA 1.037).  At the
# baselines' budgets here their finals spread more between seeds (SA
# 1.1e10-3.0e10 over 12 seeds on either side), so that a median of three
# drifts by chance (seeds 0-2: SA 1.91, CMA-ES 1.30; seeds 0-11: 0.91 and
# 0.94): they take BASELINE_SEEDS, NSGA-II its three.
QUALITY = (0.75, 1.25)
BASELINE_SEEDS = range(8)


def _ref_final_metric(problem, algo, seed):
    cfg, n = BUDGETS[algo]
    ref_cfg = {"ga": RGA.GAConfig, "cmaes": RC.CMAESConfig, "sa": RA.SAConfig}[algo](**vars(cfg))
    if algo == "sa":
        st0 = RA.init_state(problem, jax.random.PRNGKey(seed), ref_cfg)
        best = RA.run_chain(problem, ref_cfg, jax.random.PRNGKey(seed + 1), n, st0)[
            "state"]["best_objs"]
    else:
        st, _ = revolve.run(problem, algo, ref_cfg, jax.random.PRNGKey(seed), n)
        best = revolve.state_best_objs(st)
    return float(RO.combined_metric(best))


@pytest.mark.parametrize("algo", ["nsga2", "ga", "cmaes", "sa"])
def test_port_quality_matches_reference(port_runs, ref_final_metrics, small_problem, algo):
    if algo == "nsga2":
        port = [float(TO.combined_metric(st["objs"]).min()) for st, _ in port_runs]
        ref = ref_final_metrics
    else:
        port = [float(TO.combined_metric(tevolve.state_best_objs(port_run(algo, s)[0])))
                for s in BASELINE_SEEDS]
        ref = [_ref_final_metric(small_problem, algo, s) for s in BASELINE_SEEDS]
    ratio = np.median(port) / np.median(ref)
    assert QUALITY[0] <= ratio <= QUALITY[1], (ratio, port, ref)


def test_entry_points_refuse_missing_cuda_and_unported_paths(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        tevolve.run(PORT, "nsga2", TN.NSGA2Config(pop_size=4), gen, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--generations", "1", "--pop", "4"])
    with pytest.raises(ValueError, match="unsupported device"):
        tevolve.run(PORT, "nsga2", TN.NSGA2Config(pop_size=4), gen, 1, device="meta")
    for algo, cfg in (("ga", TGA.GAConfig(pop_size=4)), ("cmaes", TC.CMAESConfig(pop_size=4)),
                      ("sa", TA.SAConfig())):
        assert tevolve.get_algo(algo) is {"ga": TGA, "cmaes": TC, "sa": TA}[algo]
        with pytest.raises(RuntimeError, match="CUDA"):
            tevolve.run(PORT, algo, cfg, gen, 1)
    with pytest.raises(KeyError):
        tevolve.get_algo("pso")
    with pytest.raises(RuntimeError, match="CUDA"):
        tevolve.run(PORT, "nsga2", TN.NSGA2Config(pop_size=4), gen, 1,
                    islands=TI.IslandConfig(2, 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        TP.run_portfolio(PORT, "nsga2", [TN.NSGA2Config(pop_size=4)], gen=gen, n_gens=1)


def test_quickstart_runs_on_cpu(capsys):
    quickstart.main(["--device", "xcvu_test", "--generations", "3", "--pop", "8",
                     "--torch-device", "cpu"])
    out = capsys.readouterr().out
    assert "Pareto front" in out and "validated legal" in out
    assert "[xcvu_test: U=URAM | D=DSP | B=BRAM; .=column site]" in out
    assert "pipelining to 650 MHz" in out
