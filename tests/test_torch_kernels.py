"""The port's plain kernel versions against the reference's, and dispatch.

Each plain PyTorch version in `repro_torch.kernels.ref` is held against the
reference's jnp oracle and against the reference's Pallas kernel run in
interpret mode, on the same numpy inputs, over a subset of the sweep
shapes in `_kernel_sweeps.py`.  The CUDA kernels themselves run only on the
card (`chip_smoke.py` holds them against these plain versions); here the
tests check that CPU tensors never reach them and CUDA-only wrappers refuse
CPU tensors instead of falling back.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _kernel_sweeps import DOM_SIZES, EVAL_SHAPES, POP_SIZES, tol

from repro.kernels import bbox as rbbox
from repro.kernels import domination as rdom
from repro.kernels import fused_eval as rfe
from repro.kernels import ref as rref
from repro.kernels import wirelength as rwl
from repro_torch.kernels import _build, ops
from repro_torch.kernels import bbox as tbbox
from repro_torch.kernels import domination as tdom
from repro_torch.kernels import fused_eval as tfe
from repro_torch.kernels import ref as tref
from repro_torch.kernels import wirelength as twl

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ALL_KERNELS = (tfe.KERNEL, twl.KERNEL, tbbox.KERNEL, tdom.KERNEL, tdom.KERNEL_COUNTS)


def _both(a: np.ndarray, dt: str):
    """One numpy array as (jnp, torch) of the same dtype and bits."""
    jdt, tdt = DTYPES[dt]
    if np.issubdtype(a.dtype, np.integer):
        return jnp.asarray(a, jnp.int32), torch.tensor(a, dtype=torch.int32)
    return jnp.asarray(a, jnp.float32).astype(jdt), torch.tensor(a, dtype=torch.float32).to(tdt)


def _eval_case(p, g, n, u, b, seed=0):
    rng = np.random.default_rng(seed * 7919 + p * 131 + n)
    return dict(cx=rng.normal(size=(p, g)) * 50, cy=rng.normal(size=(p, g)) * 50,
                src=rng.integers(0, g, n), dst=rng.integers(0, g, n),
                w=np.abs(rng.normal(size=n)) * 0.1, uidx=rng.integers(0, g, (u, b)))


def _dom_case(p, seed=0):
    objs = np.random.default_rng(seed * 31 + p).uniform(size=(p, 2)).astype(np.float32)
    if p >= 2:
        objs[1] = objs[0]                 # full duplicate row
    if p >= 4:
        objs[3, 0] = objs[2, 0]           # tie on one objective only
    return objs


def _close(got_torch, want_jax, dt):
    np.testing.assert_allclose(got_torch.float().numpy(),
                               np.asarray(want_jax, np.float32), **tol(DTYPES[dt][0]))


# -------------------------------------------- plain vs reference oracle + Pallas

# a subset of the reference's sweeps: tiny, one net over a tile, one unit
# over a tile, realistic extents; rows from POP_SIZES
@pytest.mark.parametrize("p,g,n,u,b,dt", [
    (POP_SIZES[2], *EVAL_SHAPES[0], "f32"), (POP_SIZES[0], *EVAL_SHAPES[3], "f32"),
    (POP_SIZES[3], *EVAL_SHAPES[6], "f32"), (POP_SIZES[1], *EVAL_SHAPES[7], "f32"),
    (POP_SIZES[1], *EVAL_SHAPES[7], "bf16")])
def test_fused_eval_ref_matches_reference(p, g, n, u, b, dt):
    c = _eval_case(p, g, n, u, b)
    j, t = zip(*(_both(c[k], dt) for k in ("cx", "cy", "src", "dst", "w", "uidx")))
    got = tref.fused_eval_ref(*t)
    assert got.shape == (p, 2) and got.dtype == torch.float32
    _close(got, rref.fused_eval_ref(*j), dt)
    _close(got, rfe.fused_eval_pallas(*j, interpret=True), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("p,n", [(1, 7), (3, 512), (8, 1999)])
def test_wirelength2_ref_matches_reference(p, n, dt):
    rng = np.random.default_rng(p * 1000 + n)
    arrs = [rng.normal(size=(p, n)) * 50 for _ in range(4)] + [
        np.abs(rng.normal(size=(p, n))) * 5]
    j, t = zip(*(_both(a, dt) for a in arrs))
    got = tref.wirelength2_ref(*t)
    _close(got, rref.wirelength2_ref(*j), dt)
    _close(got, rwl.wirelength2_pallas(*j, interpret=True), dt)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("p,u,b", [(1, 6, 28), (4, 80, 28), (2, 130, 5)])
def test_maxbbox_ref_matches_reference(p, u, b, dt):
    rng = np.random.default_rng(p + u + b)
    (jx, tx), (jy, ty) = (_both(rng.normal(size=(p, u, b)) * 50, dt) for _ in range(2))
    got = tref.maxbbox_ref(tx, ty)
    _close(got, rref.maxbbox_ref(jx, jy), dt)
    _close(got, rbbox.maxbbox_pallas(jx, jy, interpret=True), dt)


@pytest.mark.parametrize("p", [DOM_SIZES[0], DOM_SIZES[4], DOM_SIZES[5]])
def test_domination_ref_matches_reference(p):
    objs = _dom_case(p)
    j, t = _both(objs, "f32")
    want = np.asarray(rref.domination_ref(j))
    dom, cnt = tref.domination_counts_ref(t)
    np.testing.assert_array_equal(tref.domination_ref(t).numpy(), want)
    np.testing.assert_array_equal(dom.numpy(), want)
    assert cnt.dtype == torch.int32
    np.testing.assert_array_equal(cnt.numpy(), want.sum(axis=0))
    np.testing.assert_array_equal(
        dom.numpy(), np.asarray(rdom.domination_pallas(j, interpret=True)).astype(bool))
    pdom, pcnt = rfe.domination_counts_pallas(j, interpret=True)
    np.testing.assert_array_equal(dom.numpy(), np.asarray(pdom).astype(bool))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(pcnt))


def test_net_lengths_ref_matches_reference():
    rng = np.random.default_rng(5)
    arrs = [rng.normal(size=(3, 50)) * 50 for _ in range(4)]
    j, t = zip(*(_both(a, "f32") for a in arrs))
    np.testing.assert_array_equal(tref.net_lengths_ref(*t).numpy(),
                                  np.asarray(rref.net_lengths_ref(*j)))


# ------------------------------------------------ masking (worst-case) tests

@pytest.mark.parametrize("plant,shape", [(1e9, (4, 96, 513, 9, 7)),
                                         (3.0e37, (4, 640, 40, 129, 5))])
def test_unreferenced_extremes_do_not_leak(plant, shape):
    """Ported from the reference's padded-nets / padded-units worst cases.

    The reference pads nets and units with gid 0; the port pads nothing and
    bounds its loops by the real N, U and B instead.  With gid 0 planted at
    an extreme coordinate, the port's plain version must agree with the
    reference's padded Pallas kernel, and rows sliced out of a poisoned
    buffer must not see the poison.
    """
    c = _eval_case(*shape)
    c["cx"][:, 0], c["cy"][:, 0] = plant, -plant
    j, t = zip(*(_both(c[k], "f32") for k in ("cx", "cy", "src", "dst", "w", "uidx")))
    got = tref.fused_eval_ref(*t)
    want = rfe.fused_eval_pallas(*j, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # the same rows, nets and units taken as prefixes of larger buffers
    # whose tails hold extremes: the result must not change
    p, n, u = shape[0], shape[2], shape[3]
    cx = torch.cat([t[0], torch.full_like(t[0], 3.0e37)])[:p]
    src = torch.cat([t[2], torch.zeros_like(t[2])])[:n]
    uidx = torch.cat([t[5], torch.zeros_like(t[5])])[:u]
    assert torch.equal(tref.fused_eval_ref(cx, t[1], src, t[3], t[4], uidx), got)


# ------------------------------------------------------------- dispatch

def test_ops_on_cpu_tensors_use_plain_versions_and_launch_nothing():
    for k in ALL_KERNELS:
        k.launches = 0
    c = _eval_case(6, 96, 200, 37, 11)
    _, t = zip(*(_both(c[k], "f32") for k in ("cx", "cy", "src", "dst", "w", "uidx")))
    cx, cy, src, dst, w, uidx = t
    fused = ops.fused_eval(cx, cy, src, dst, w, uidx)
    s, d = src.long(), dst.long()
    wl = ops.wirelength2(cx[:, s], cy[:, s], cx[:, d], cy[:, d], w)
    bb = ops.maxbbox(cx[:, uidx.long()], cy[:, uidx.long()])
    # fused and unfused dispatch are bitwise equal on the CPU, as in the
    # reference
    assert torch.equal(fused[:, 0], wl) and torch.equal(fused[:, 1], bb)
    objs = torch.tensor(_dom_case(50, seed=3))
    dom, cnt = ops.fused_domination_counts(objs)
    assert torch.equal(dom, ops.domination_matrix(objs))
    assert torch.equal(cnt, dom.sum(0, dtype=torch.int32))
    assert [k.launches for k in ALL_KERNELS] == [0] * len(ALL_KERNELS)


@pytest.mark.parametrize("call", [
    lambda x: tfe.fused_eval(x, x, x.int(), x.int(), x, x.int().reshape(2, 2)),
    lambda x: twl.wirelength2(x, x, x, x, x),
    lambda x: tbbox.maxbbox(x.reshape(1, 2, 2), x.reshape(1, 2, 2)),
    lambda x: tdom.domination(x.reshape(2, 2)),
    lambda x: tdom.domination_counts(x.reshape(2, 2)),
], ids=["fused_eval", "wirelength2", "maxbbox", "domination", "domination_counts"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    """No fallback: a kernel wrapper raises on a CPU tensor before it
    builds or launches anything."""
    x = torch.ones(4)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        call(x)
    assert [k.launches for k in ALL_KERNELS] == [0] * len(ALL_KERNELS)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    # library names are keyed by the sources' hash: stable across calls
    assert _build.library_path("bbox") == _build.library_path("bbox")
    assert len({_build.library_path(n) for n in _build.NAMES}) == len(_build.NAMES)
