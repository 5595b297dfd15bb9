"""The port's NSGA-II machinery against the reference, on shared inputs.

Sorting: `nondominated_rank` and `crowding_distance` on the cases of
`test_nsga2_reference.py` (random, tied, duplicated, one front, a chain of
fronts), unfused and fused.  Operators: each port body is fed the draws
the reference operator derives from its jax key, and must return what the
reference operator returns.  Selection: the (mu+lambda) order on a shared
population.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_nsga2_reference import crowding_reference, rank_reference

from repro.core import nsga2 as RN
from repro_torch.core import convert
from repro_torch.core import nsga2 as TN
from repro_torch.core import objectives as TO
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet

ETA = np.float32(15.0)
PROB = np.float32(0.9)


def _cases():
    out = []
    for seed in range(8):
        for m in (2, 3):
            rng = np.random.default_rng(seed)
            out.append((f"random-{seed}-m{m}", rng.uniform(size=(int(rng.integers(3, 48)), m))))
    for seed in range(6):
        rng = np.random.default_rng(100 + seed)
        p = int(rng.integers(4, 40))
        out.append((f"tied-{seed}", np.round(rng.uniform(size=(p, 2)) * 4.0) / 4.0))
    for seed in range(4):
        rng = np.random.default_rng(200 + seed)
        base = rng.uniform(size=(6, 2))
        out.append((f"dup-{seed}", np.concatenate([base, base[rng.integers(0, 6, size=5)]])))
    t = np.linspace(0.0, 1.0, 9)
    out += [("single-point", np.array([[0.3, 0.7]])),
            ("one-front", np.stack([t, 1.0 - t], axis=1)),
            ("chain", np.stack([np.arange(5.0)] * 2, axis=1))]
    return out


CASES = _cases()
# one compiled program per population size instead of one per eager op
_ref_sort = jax.jit(lambda o: (RN.nondominated_rank(o),
                               RN.crowding_distance(o, RN.nondominated_rank(o))))


@pytest.mark.parametrize("name,objs", CASES, ids=[c[0] for c in CASES])
def test_rank_and_crowding_match_reference(name, objs):
    """Unfused and fused port sorting: ranks equal the reference's and the
    brute-force peel's; crowding equals the reference's bit for bit."""
    objs = objs.astype(np.float32)
    want_rank, want_crowd = (np.asarray(a) for a in _ref_sort(jnp.asarray(objs)))
    np.testing.assert_array_equal(want_rank, rank_reference(objs))
    np.testing.assert_allclose(want_crowd, crowding_reference(objs, want_rank),
                               rtol=1e-4, atol=1e-6)
    for fused in (False, True):
        got_rank = TN.nondominated_rank(torch.tensor(objs), fused)
        np.testing.assert_array_equal(got_rank.numpy(), want_rank)
        got_crowd = TN.crowding_distance(torch.tensor(objs), got_rank)
        np.testing.assert_array_equal(got_crowd.numpy(), want_crowd)


# ------------------------------------------------------------- operators

def _t(a):
    return torch.tensor(np.asarray(a))


@pytest.mark.parametrize("seed", range(3))
def test_sbx_body_matches_reference(seed):
    rng = np.random.default_rng(seed)
    a, b = (rng.normal(size=(6, 20)).astype(np.float32) for _ in range(2))
    keys = jax.random.split(jax.random.PRNGKey(seed), 6)
    want = jax.jit(jax.vmap(lambda k, x, y: RN._sbx(k, x, y, jnp.float32(ETA),
                                                     jnp.float32(PROB))))(keys, a, b)

    def draws(k):
        k1, k2, k3 = jax.random.split(k, 3)
        return (jax.random.uniform(k1, (20,)), jax.random.bernoulli(k2, 0.5, (20,)),
                jax.random.bernoulli(k3, PROB, (20,)))

    u, sign, do = jax.jit(jax.vmap(draws))(keys)
    got = TN._sbx_body(_t(a), _t(b), _t(u), _t(sign), _t(do), torch.tensor(ETA))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("scale", [1.0, 0.25])
def test_poly_mut_body_matches_reference(scale):
    x = np.random.default_rng(4).uniform(size=(6, 30)).astype(np.float32)
    eta, prob = np.float32(20.0), np.float32(0.3)
    keys = jax.random.split(jax.random.PRNGKey(1), 6)
    want = jax.jit(jax.vmap(lambda k, v: RN._poly_mut(
        k, v, jnp.float32(eta), jnp.float32(prob), scale)))(keys, x)

    def draws(k):
        k1, k2 = jax.random.split(k)
        return jax.random.uniform(k1, (30,)), jax.random.bernoulli(k2, prob, (30,))

    u, do = jax.jit(jax.vmap(draws))(keys)
    got = TN._poly_mut_body(_t(x), _t(u), _t(do), torch.tensor(eta), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _perms(rng, p, n):
    return np.argsort(rng.uniform(size=(p, n)), axis=1).astype(np.int32)


@pytest.mark.parametrize("n", [1, 6, 160])
def test_ox_body_matches_reference(n):
    rng = np.random.default_rng(n)
    p1, p2 = _perms(rng, 16, n), _perms(rng, 16, n)
    keys = jax.random.split(jax.random.PRNGKey(n), 16)
    want = jax.jit(jax.vmap(RN._ox))(keys, p1, p2)
    cuts = jax.jit(jax.vmap(lambda k: jnp.sort(jax.random.randint(
        jax.random.split(k)[0], (2,), 0, n + 1))))(keys)
    cuts = np.asarray(cuts)
    got = TN._ox_body(_t(p1).long(), _t(p2).long(), _t(cuts[:, 0]).long(),
                      _t(cuts[:, 1]).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.sort(got.numpy(), axis=1) == np.arange(n)).all()


def test_swap_mut_body_matches_reference():
    n, swaps, prob = 12, 3, np.float32(0.6)
    perm = _perms(np.random.default_rng(9), 16, n)
    keys = jax.random.split(jax.random.PRNGKey(9), 16)
    want = jax.jit(jax.vmap(lambda k, q: RN._swap_mut(k, q, swaps, jnp.float32(prob))))(
        keys, perm)

    def draws(k):
        def one(kk):
            ki, kj, kd = jax.random.split(kk, 3)
            return (jax.random.randint(ki, (), 0, n), jax.random.randint(kj, (), 0, n),
                    jax.random.bernoulli(kd, prob))
        return jax.vmap(one)(jax.random.split(k, swaps))

    i, j, do = jax.jit(jax.vmap(draws))(keys)
    got = TN._swap_mut_body(_t(perm).long(), _t(i).long(), _t(j).long(), _t(do))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_tournament_body_matches_reference():
    objs = (np.round(np.random.default_rng(3).uniform(size=(24, 2)) * 5) / 5).astype(np.float32)
    rank, crowd = _ref_sort(jnp.asarray(objs))
    key = jax.random.PRNGKey(5)
    want = RN._tournament(key, rank, crowd, 24)
    ka, kb = jax.random.split(key)
    ia, ib = (jax.random.randint(k, (24,), 0, 24) for k in (ka, kb))
    got = TN._tournament_body(_t(rank).long(), _t(crowd), _t(ia).long(), _t(ib).long())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- selection

def _shared_population_objs():
    """Objectives of a decoded population on xcvu_test, plus exact copies
    and one-objective ties, so that crowding ties decide the order."""
    problem = tnet.make_problem(tdev.get_device("xcvu_test"))
    rng = np.random.default_rng(21)
    g = {"dist": tuple(rng.normal(size=(24, c.n_cols)).astype(np.float32)
                       for c in problem.geom),
         "loc": tuple(rng.uniform(size=(24, c.n_chains)).astype(np.float32)
                      for c in problem.geom),
         "perm": tuple(_perms(rng, 24, c.n_chains) for c in problem.geom)}
    objs = TO.evaluate_population(problem, convert.genotype_from_numpy(g)).numpy()
    objs[20:] = objs[:4]
    objs[17, 0] = objs[16, 0]
    return objs


@pytest.mark.parametrize("kind", ["population", "quantized"])
def test_mu_plus_lambda_order_matches_reference(kind):
    if kind == "population":
        objs = _shared_population_objs()
    else:
        objs = (np.round(np.random.default_rng(8).uniform(size=(32, 2)) * 6) / 6
                ).astype(np.float32)
    p = objs.shape[0] // 2
    want = RN._lexsort_rank_crowd(*_ref_sort(jnp.asarray(objs)))[:p]
    to = torch.tensor(objs)
    trank = TN.nondominated_rank(to)
    got = TN._lexsort_rank_crowd(trank, TN.crowding_distance(to, trank))[:p]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
