"""The port's GA, sep-CMA-ES and simulated annealing against the reference.

Each port body is fed the random numbers the reference operator derives
from its jax key, and must return the reference's result: integer leaves
and the selection exactly, floats within `tol(float32)`.  Whole runs of the
port on the CPU, at the reference tests' budgets, must improve and yield
champions that pass the reference's own `validate_placement`.
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
from repro.core import ga as RGA
from repro.core import genotype as RG
from repro.core import hyper as RH
from repro.core import objectives as RO
from repro_torch.core import annealing as TA
from repro_torch.core import cmaes as TC
from repro_torch.core import convert
from repro_torch.core import evolve as tevolve
from repro_torch.core import ga as TGA
from repro_torch.core import hyper as TH
from repro_torch.core import objectives as TO
from repro_torch.core import portfolio as TP
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet

PORT = tnet.make_problem(tdev.get_device("xcvu_test"))
F32 = tol(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_state(got: dict, want: dict, exact=()):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = convert.state_to_numpy({k: got[k]})[k], np.asarray(want[k])
        if k in exact:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, **F32, err_msg=k)


# ------------------------------------------------------------------- GA

def _vary_draws(key, g1, cfg, n_swaps):
    """The draws `nsga2._vary_one` derives from `key` for one child, in the
    layout of the port's `nsga2._vary_draws` (without the population axis)."""
    keys = jax.random.split(key, 12)
    real = []
    for t in range(3):
        for part, ks, km in (("dist", keys[t], keys[3 + t]), ("loc", keys[6 + t], keys[9 + t])):
            shape = g1[part][t].shape
            k1, k2, k3 = jax.random.split(ks, 3)
            m1, m2 = jax.random.split(km)
            real.append((jax.random.uniform(k1, shape), jax.random.bernoulli(k2, 0.5, shape),
                         jax.random.bernoulli(k3, cfg.crossover_prob, shape),
                         jax.random.uniform(m1, shape),
                         jax.random.bernoulli(m2, cfg.real_mut_prob, shape)))
    pkeys = jax.random.split(keys[11], 6)
    perm = []
    for t in range(3):
        n = g1["perm"][t].shape[0]
        cuts = jnp.sort(jax.random.randint(jax.random.split(pkeys[t])[0], (2,), 0, n + 1))

        def swap(k, n=n):
            ki, kj, kd = jax.random.split(k, 3)
            return (jax.random.randint(ki, (), 0, n), jax.random.randint(kj, (), 0, n),
                    jax.random.bernoulli(kd, cfg.perm_swap_prob))

        i, j, do = jax.vmap(swap)(jax.random.split(pkeys[3 + t], n_swaps))
        perm.append((cuts[0], cuts[1], i, j, do))
    return {"real": real, "perm": perm}


def _to_port(tree):
    """numpy draws -> torch, integers as int64 (the port's index dtype)."""
    def one(a):
        a = np.asarray(a)
        return torch.tensor(a.astype(np.int64) if a.dtype.kind in "iu" else a)
    return jax.tree.map(one, tree)


@pytest.fixture(scope="module")
def ga_case(small_problem):
    cfg = RGA.GAConfig(pop_size=16)
    pop = _genotypes(small_problem, cfg.pop_size, seed=3, scale=0.5)
    state = {"pop": pop, "objs": TO.evaluate_population(
        PORT, convert.genotype_from_numpy(pop)).numpy()}
    key = jax.random.PRNGKey(4)
    tcfg = RH.tracify(cfg)
    want = _np(jax.jit(lambda st, k: RGA.step_impl(small_problem, tcfg, st, k))(state, key))
    p = cfg.pop_size
    k1, k2, k3 = jax.random.split(key, 3)
    tour = [jax.random.randint(k, (p,), 0, p) for kk in (k1, k2)
            for k in (kk, jax.random.fold_in(kk, 1))]
    g1 = jax.tree.map(lambda a: a[0], state["pop"])
    vary = jax.jit(jax.vmap(lambda k: _vary_draws(k, g1, tcfg, cfg.perm_swaps)))(
        jax.random.split(k3, p))
    return cfg, state, _np(tour), _np(vary), want


def test_ga_step_body_matches_reference(ga_case):
    cfg, state, tour, vary, want = ga_case
    tcfg = TH.tracify(TGA.GAConfig(pop_size=cfg.pop_size), "cpu")
    got = TGA.step_body(PORT, tcfg, convert.state_from_numpy(state),
                        tuple(_to_port(tour)), _to_port(vary))
    got = convert.state_to_numpy(got)
    for t in range(3):
        np.testing.assert_array_equal(got["pop"]["perm"][t], want["pop"]["perm"][t])
        for part in ("dist", "loc"):
            np.testing.assert_allclose(got["pop"][part][t], want["pop"][part][t], **F32)
    np.testing.assert_allclose(got["objs"], want["objs"], **F32)


# --------------------------------------------------------------- CMA-ES

@pytest.mark.parametrize("n,lam", [(70, 12), (70, 16), (865, 24), (1330, 0)])
def test_cmaes_constants_match_reference(n, lam):
    """fp32 throughout; XLA's log and sum round differently from torch's by
    an ulp, which the normalisation of w and the rates built on mu_eff
    carry on: within 1e-6 relative (~8 ulps)."""
    lam = lam or RC.CMAESConfig().lam(n)
    assert TC.CMAESConfig().lam(n) == RC.CMAESConfig().lam(n)
    want, got = RC._constants(n, lam), TC._constants(n, lam)
    assert got["mu"] == want["mu"] and got["chi_n"] == want["chi_n"]
    for k in ("w", "mu_eff", "c_sigma", "d_sigma", "c_c", "c_1", "c_mu"):
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype == np.float32, k
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0, err_msg=k)


@pytest.fixture(scope="module")
def cmaes_chain(small_problem):
    """The reference's state after 1 and after 10 steps, with each step's z."""
    cfg = RC.CMAESConfig(pop_size=12)
    tcfg = RH.tracify(cfg)
    step = jax.jit(lambda st, k: RC.step_impl(small_problem, tcfg, st, k))
    state = _np(RC.init_state(small_problem, jax.random.PRNGKey(5), tcfg))
    keys = jax.random.split(jax.random.PRNGKey(6), 10)
    zs, states = [], [state]
    for k in keys:
        zs.append(np.asarray(jax.random.normal(k, (12, small_problem.continuous_dim))))
        states.append(_np(step(states[-1], k)))
    return cfg, zs, states


@pytest.mark.parametrize("n_steps", [1, 10])
def test_cmaes_steps_match_reference(cmaes_chain, n_steps):
    cfg, zs, states = cmaes_chain
    tcfg = TH.tracify(TC.CMAESConfig(pop_size=cfg.pop_size), "cpu")
    st = convert.state_from_numpy(states[0])
    for z in zs[:n_steps]:
        st = TC.step_body(PORT, tcfg, st, torch.tensor(z))
    _assert_state(st, states[n_steps], exact=("gen",))
    g, objs = TC.best_genotype(PORT, st)
    np.testing.assert_allclose(TO.evaluate(PORT, g).numpy(), objs.numpy(), **F32)


# ------------------------------------------------------------------- SA

@pytest.mark.parametrize("schedule", RA.SCHEDULES)
def test_sa_temperature_matches_reference(schedule):
    cfg = RA.SAConfig(schedule=schedule, n_steps=3000)
    tcfg = TH.tracify(TA.SAConfig(schedule=schedule, n_steps=3000), "cpu")
    t_adapt = np.float32(0.37)
    for k in (0, 1, 7, 500, 2999, 20000):
        want = RA._temperature(RH.tracify(cfg), jnp.int32(k), jnp.float32(t_adapt))
        got = TA._temperature(tcfg, torch.tensor(k, dtype=torch.int32), torch.tensor(t_adapt))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32, err_msg=str(k))


def _move_draws(problem, key):
    """The draws the reference's `_move` derives from `key`."""
    sl = RG.flat_split(problem)
    kk = jax.random.split(key, 4)
    t = jax.random.randint(kk[1], (), 0, 3)
    lo = jnp.array([sl[6][0], sl[7][0], sl[8][0]])[t]
    hi = jnp.array([sl[6][1], sl[7][1], sl[8][1]])[t]
    ki, kj = jax.random.split(kk[2])
    return dict(kind=jax.random.randint(kk[0], (), 0, 3),
                i_dist=jax.random.randint(kk[1], (), sl[0][0], sl[2][1]),
                i_loc=jax.random.randint(kk[1], (), sl[3][0], sl[5][1]),
                noise=jax.random.normal(kk[2]), t=t,
                i=jax.random.randint(ki, (), 0, hi - lo),
                j=jax.random.randint(kj, (), 0, hi - lo))


def _keys_of_kind(problem, kind: int, n: int = 2):
    out, s = [], 0
    while len(out) < n:
        key = jax.random.PRNGKey(1000 + s)
        if int(_move_draws(problem, key)["kind"]) == kind:
            out.append(key)
        s += 1
    return out


@pytest.mark.parametrize("kind", [0, 1, 2], ids=["distribution", "location", "swap"])
def test_sa_move_body_matches_reference(small_problem, kind):
    """Exact against the reference run op by op: under one `jax.jit` the
    normal draw itself may round differently."""
    z = np.random.default_rng(kind).normal(size=small_problem.continuous_dim).astype(np.float32)
    sigma = np.float32(0.6)
    for key in _keys_of_kind(small_problem, kind, 4):
        want = np.asarray(RA._move(small_problem, key, jnp.asarray(z), jnp.float32(sigma)))
        draws = _to_port(_np(_move_draws(small_problem, key)))
        got = TA._move_body(PORT, torch.tensor(z), torch.tensor(sigma), **draws)
        np.testing.assert_array_equal(got.numpy(), want)
        assert (got.numpy() != z).sum() == (0 if kind == 2 and draws["i"] == draws["j"]
                                            else 1 if kind < 2 else 2)


@pytest.mark.parametrize("schedule", ["hyperbolic", "adaptive"])
def test_sa_step_body_matches_reference(small_problem, schedule):
    cfg = RA.SAConfig(schedule=schedule)
    tcfg = RH.tracify(cfg)
    state = _np(RA.init_state(small_problem, jax.random.PRNGKey(8), cfg))
    st = convert.state_from_numpy(state)
    port_cfg = TH.tracify(TA.SAConfig(schedule=schedule), "cpu")
    for s in range(4):
        key = jax.random.PRNGKey(20 + s)
        k1, k2 = jax.random.split(key)
        draws = _to_port(_np(_move_draws(small_problem, k1)))
        u = torch.tensor(np.asarray(jax.random.uniform(k2)))
        st = TA.step_body(PORT, port_cfg, st, draws, u)
        state = _np(RA.step_impl(small_problem, tcfg, jax.tree.map(jnp.asarray, state),
                                 key))   # op by op
        _assert_state(st, state, exact=("k", "z", "best_z"))


# ------------------------------------------------------------ whole runs

def _improves(hist) -> bool:
    c = TO.combined_metric(hist)
    return bool(c[-1] < c[0])


@pytest.fixture(scope="module")
def port_runs():
    gen = torch.Generator().manual_seed
    out = {algo: tevolve.run(PORT, algo, cfg, gen(0), n, device="cpu")
           for algo, cfg, n in (("ga", TGA.GAConfig(pop_size=16), 25),
                                ("cmaes", TC.CMAESConfig(pop_size=12), 40))}
    cfg = TA.SAConfig(schedule="hyperbolic")
    st0 = TA.init_state(PORT, gen(0), cfg)
    chain = TA.run_chain(PORT, cfg, gen(1), 400, st0)
    out["sa"] = (chain["state"], chain["history"])
    return out


@pytest.mark.parametrize("algo", ["ga", "cmaes", "sa"])
def test_port_runs_improve_with_legal_champions(port_runs, small_problem, algo):
    state, hist = port_runs[algo]
    assert torch.isfinite(hist).all()
    if algo == "sa":
        assert hist.shape == (400, 2)
        assert TO.combined_metric(state["best_objs"]) < TO.combined_metric(hist[0])
    else:
        assert _improves(hist)
        np.testing.assert_array_equal(hist[-1].numpy(), tevolve.state_best_objs(state).numpy())
    g, objs = TP.best_genotype(PORT, algo, state)
    checks = RO.validate_placement(small_problem, convert.genotype_to_numpy(g))
    assert all(checks.values()), checks
    np.testing.assert_allclose(TO.evaluate(PORT, g).numpy(), objs.numpy(), **F32)


def test_sa_schedules_run(small_problem):
    st0 = TA.init_state(PORT, torch.Generator().manual_seed(0), TA.SAConfig())
    for schedule in TA.SCHEDULES:
        out = TA.run_chain(PORT, TA.SAConfig(schedule=schedule),
                           torch.Generator().manual_seed(0), 50, st0)
        assert torch.isfinite(out["state"]["best_objs"]).all()
        assert int(out["state"]["k"]) == 50 and out["state"]["k"].dtype == torch.int32


def test_tracify_takes_every_config():
    for cfg in (TGA.GAConfig(), TC.CMAESConfig(), TA.SAConfig()):
        t = TH.tracify(cfg, "cpu")
        for name, v in vars(cfg).items():
            if isinstance(v, float):
                assert getattr(t, name).dtype == torch.float32 and getattr(t, name).dim() == 0
            else:
                assert getattr(t, name) == v
