"""The port's batched decoder against the reference's, on the same genotypes.

Genotypes are drawn with numpy and handed to both packages.  Integer
outputs (chain counts) and decoded coordinates must match exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import genotype as RG
from repro.core import objectives as RO
from repro_torch.core import convert
from repro_torch.core import genotype as TG
from repro_torch.core import objectives as TO
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet

# one compiled program per shape instead of one per eager op
_ref_counts = jax.jit(jax.vmap(RG.allocate_counts, in_axes=(0, None, None)),
                      static_argnums=2)
PORT = {name: tnet.make_problem(tdev.get_device(name)) for name in ("xcvu_test", "xcvu11p")}
FIXTURES = {"xcvu_test": "small_problem", "xcvu11p": "vu11p_problem"}


def _genotypes(problem, p: int, seed: int, scale: float):
    """A numpy population: dist ~ N(0, scale), loc uniform with planted
    0 and 1 ends, perms random permutations."""
    rng = np.random.default_rng(seed)
    dist, loc, perm = [], [], []
    for g in problem.geom:
        dist.append((rng.normal(size=(p, g.n_cols)) * scale).astype(np.float32))
        lo = rng.uniform(size=(p, g.n_chains)).astype(np.float32)
        lo[:, :2] = (0.0, 1.0)
        loc.append(lo)
        perm.append(np.argsort(rng.uniform(size=(p, g.n_chains)), axis=1).astype(np.int32))
    return {"dist": tuple(dist), "loc": tuple(loc), "perm": tuple(perm)}


@pytest.mark.parametrize("total", [1, 7, 23, 40])
@pytest.mark.parametrize("scale", [0.5, 3.0])
def test_allocate_counts_matches_reference(total, scale):
    caps = np.asarray([3, 7, 1, 9, 5, 8, 4, 3], np.int32)
    genes = (np.random.default_rng(total).normal(size=(64, 8)) * scale).astype(np.float32)
    want = _ref_counts(genes, jnp.asarray(caps), total)
    got = TG.allocate_counts(torch.tensor(genes), torch.tensor(caps), total)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.sum(-1) == total).all() and (got <= torch.tensor(caps)).all()


@pytest.mark.parametrize("name", ["xcvu_test", "xcvu11p"])
@pytest.mark.parametrize("scale", [0.5, 4.0])
def test_decode_matches_reference_exactly(name, scale, request):
    ref_problem = request.getfixturevalue(FIXTURES[name])
    g = _genotypes(ref_problem, 8, seed=int(scale * 10), scale=scale)
    for t in range(3):
        geom = ref_problem.geom[t]
        want = _ref_counts(g["dist"][t], jnp.asarray(geom.col_cap_chains), geom.n_chains)
        got = TG.allocate_counts(torch.tensor(g["dist"][t]),
                                 torch.tensor(geom.col_cap_chains), geom.n_chains)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rx, ry = jax.vmap(lambda gg: RG.decode(ref_problem, gg))(g)
    tx, ty = TG.decode(PORT[name], convert.genotype_from_numpy(g))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(ry))


@pytest.mark.parametrize("name", ["xcvu_test", "xcvu11p"])
def test_decode_reduced_matches_reference_exactly(name, request):
    ref_problem = request.getfixturevalue(FIXTURES[name])
    perms = _genotypes(ref_problem, 6, seed=3, scale=1.0)["perm"]
    rx, ry = jax.vmap(lambda ps: RG.decode_reduced(ref_problem, ps))(perms)
    tx, ty = TG.decode_reduced(PORT[name], convert.genotype_from_numpy(perms))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(rx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(ry))


def test_flat_encoding_matches_reference(small_problem):
    port = PORT["xcvu_test"]
    assert TG.flat_split(port) == RG.flat_split(small_problem)
    z = (np.random.default_rng(11).normal(size=(5, port.continuous_dim)) * 2
         ).astype(np.float32)
    want = jax.jit(jax.vmap(lambda zz: RG.from_flat(small_problem, zz)))(z)
    got = TG.from_flat(port, torch.tensor(z))
    for t in range(3):
        np.testing.assert_array_equal(got["perm"][t].numpy(), np.asarray(want["perm"][t]))
        np.testing.assert_array_equal(got["dist"][t].numpy(), np.asarray(want["dist"][t]))
        np.testing.assert_allclose(got["loc"][t].numpy(), np.asarray(want["loc"][t]),
                                   rtol=1e-6, atol=1e-7)
    # to_flat of the same structured genotype, then a perm-exact round trip
    g = _genotypes(small_problem, 5, seed=2, scale=1.0)
    want_z = jax.jit(jax.vmap(lambda gg: RG.to_flat(small_problem, gg)))(g)
    got_z = TG.to_flat(port, convert.genotype_from_numpy(g))
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), rtol=1e-5, atol=1e-5)
    back = TG.from_flat(port, got_z)
    for t in range(3):
        np.testing.assert_array_equal(back["perm"][t].numpy(), g["perm"][t])


def test_objective_helpers_match_reference(small_problem):
    """net_lengths, evaluate_flat_population (port unfused and fused
    against the reference, whose two paths agree bitwise on the CPU),
    scalarize, combined_metric."""
    port = PORT["xcvu_test"]
    g = _genotypes(small_problem, 4, seed=5, scale=1.0)
    want = jax.jit(jax.vmap(lambda gg: RO.net_lengths(small_problem, gg)))(g)
    got = TO.net_lengths(port, convert.genotype_from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    z = (np.random.default_rng(6).normal(size=(4, port.continuous_dim))).astype(np.float32)
    want = RO.evaluate_flat_population(small_problem, z)
    for fused in (False, True):
        got = TO.evaluate_flat_population(port, torch.tensor(z), fused)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(TO.scalarize(got).numpy(),
                               np.asarray(RO.scalarize(jnp.asarray(got.numpy()))), rtol=1e-6)
    np.testing.assert_array_equal(TO.combined_metric(got).numpy(),
                                  np.asarray(RO.combined_metric(jnp.asarray(got.numpy()))))


def test_random_genotype_shapes_and_permutations():
    port = PORT["xcvu_test"]
    g = TG.random_genotype(port, 7, torch.Generator().manual_seed(0))
    for t, geom in enumerate(port.geom):
        assert g["dist"][t].shape == (7, geom.n_cols)
        assert g["loc"][t].shape == (7, geom.n_chains)
        assert torch.equal(torch.sort(g["perm"][t], dim=-1).values,
                           torch.arange(geom.n_chains).expand(7, -1))
