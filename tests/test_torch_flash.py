"""The port's attention plain versions and dispatch against the reference.

`repro_torch.kernels.ref.flash_attention_ref` and `decode_attention_ref`
get the same numpy inputs as the reference's jnp oracles, over the grid of
`tests/test_kernels.py` (causal GQA/MQA shapes, sliding windows, the S < T
chunk), and the Pallas kernel in interpret mode at two small shapes.
Gradients of `ops.flash_attention` (backward recomputed through the plain
version) are held against `jax.grad` through the reference's
`ops.flash_attention`.  The CUDA kernel itself runs only on the card
(`chip_smoke.py`); here the tests check that CPU tensors never reach it.

Tolerances are those of `tests/test_kernels.py`: f32 rtol 2e-5 / atol
1e-5 (the two sides sum the logits and the weighted values in different
orders), bf16 2e-2 (one bf16 rounding of the output).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as rfa
from repro.kernels import ops as rops
from repro.kernels import ref as rref
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops, ref

DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
TOL = {"f32": dict(rtol=2e-5, atol=1e-5), "bf16": dict(rtol=2e-2, atol=2e-2)}
GRID = [(1, 2, 2, 128, 64), (2, 4, 2, 200, 64), (1, 8, 1, 384, 128), (1, 2, 2, 96, 64)]


def _qkv(b, h, hkv, s, t, d, seed, scale=0.02):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, s, d)) * scale, rng.normal(size=(b, hkv, t, d)) * scale,
            rng.normal(size=(b, hkv, t, d)) * scale)


def _both(arrays, dt):
    jdt, tdt = DTYPES[dt]
    return ([jnp.asarray(a, jnp.float32).astype(jdt) for a in arrays],
            [torch.tensor(a, dtype=torch.float32).to(tdt) for a in arrays])


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dt])


@pytest.mark.parametrize("b,h,hkv,s,d", GRID)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_ref_causal_matches_reference(b, h, hkv, s, d, dt):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, h, hkv, s, s, d, seed=h * s), dt)
    _close(ref.flash_attention_ref(tq, tk, tv, causal=True),
           rref.flash_attention_ref(jq, jk, jv, causal=True), dt)


@pytest.mark.parametrize("window", [32, 128])
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_flash_ref_window_matches_reference(window, dt):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, 2, 256, 256, 64, seed=window), dt)
    _close(ref.flash_attention_ref(tq, tk, tv, True, window),
           rref.flash_attention_ref(jq, jk, jv, True, window), dt)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_ref_chunk_and_soft_cap_match_reference(causal):
    """S < T (the queries are the last S positions), with a soft cap."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(2, 4, 2, 64, 320, 64, seed=9, scale=1.0), "f32")
    _close(ref.flash_attention_ref(tq, tk, tv, causal),
           rref.flash_attention_ref(jq, jk, jv, causal), "f32")
    _close(ref.flash_attention_ref(tq, tk, tv, causal, 100, logit_soft_cap=5.0),
           rref.flash_attention_ref(jq, jk, jv, causal, 100, logit_soft_cap=5.0), "f32")


@pytest.mark.parametrize("b,h,hkv,s,t,d,window", [
    (1, 4, 2, 40, 40, 64, None),       # GQA, one ragged tile
    (1, 2, 1, 24, 56, 64, 16),         # S < T under a window, MQA
])
def test_flash_ref_matches_pallas_interpret(b, h, hkv, s, t, d, window):
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(b, h, hkv, s, t, d, seed=s + t, scale=1.0), "f32")
    want = rfa.flash_attention_pallas(jq, jk, jv, causal=True, window=window,
                                      interpret=True, block_q=16, block_k=16)
    _close(ref.flash_attention_ref(tq, tk, tv, True, window), want, "f32")


def test_flash_ref_row_without_key_is_nan_as_in_reference():
    """S > T: the first S - T query rows see no key.  Both plain versions
    give NaN there (the CUDA kernel gives 0, checked on the card)."""
    (jq, jk, jv), (tq, tk, tv) = _both(_qkv(1, 2, 2, 24, 16, 64, seed=5, scale=1.0), "f32")
    got = ref.flash_attention_ref(tq, tk, tv).numpy()
    want = np.asarray(rref.flash_attention_ref(jq, jk, jv))
    assert np.isnan(got[:, :, :8]).all() and np.isnan(want[:, :, :8]).all()
    np.testing.assert_allclose(got[:, :, 8:], want[:, :, 8:], **TOL["f32"])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_decode_attention_ref_matches_reference(dt):
    rng = np.random.default_rng(3)
    arrays = [rng.normal(size=(3, 4, 16)), rng.normal(size=(3, 2, 20, 16)),
              rng.normal(size=(3, 2, 20, 16))]
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dt)
    lens = np.array([5, 20, 1], np.int32)
    got = ops.decode_attention(tq, tk, tv, torch.tensor(lens))
    _close(got, rref.decode_attention_ref(jq, jk, jv, jnp.asarray(lens)), dt)


@pytest.mark.parametrize("window", [None, 8])
def test_flash_grad_matches_reference(window):
    """Backward recomputed through the plain version equals jax.grad through
    the reference's custom VJP (which recomputes through its oracle)."""
    q, k, v = _qkv(1, 4, 2, 24, 24, 16, seed=11, scale=0.5)
    g = np.random.default_rng(12).normal(size=q.shape)
    (jq, jk, jv, jg), _ = _both((q, k, v, g), "f32")

    def loss(q_, k_, v_):
        return jnp.sum(rops.flash_attention(q_, k_, v_, True, window) * jg)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.tensor(a, dtype=torch.float32, requires_grad=True) for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, True, window)
    (out * torch.tensor(g, dtype=torch.float32)).sum().backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        _close(got, w, "f32")


def test_flash_dispatch_on_cpu_runs_the_plain_version():
    """A CPU tensor goes to the plain version (soft cap included) and never
    to the kernel; the CUDA-only wrapper refuses CPU tensors."""
    _, (tq, tk, tv) = _both(_qkv(1, 4, 2, 33, 33, 64, seed=1, scale=1.0), "f32")
    before = tfa.KERNEL.launches
    torch.testing.assert_close(ops.flash_attention(tq, tk, tv, True, 16),
                               ref.flash_attention_ref(tq, tk, tv, True, 16), rtol=0, atol=0)
    torch.testing.assert_close(ops.flash_attention(tq, tk, tv, True, None, 30.0),
                               ref.flash_attention_ref(tq, tk, tv, True, None, 30.0),
                               rtol=0, atol=0)
    assert tfa.KERNEL.launches == before
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        tfa.flash_attention(tq, tk, tv)


def test_flash_dispatch_off_cpu_never_falls_back(monkeypatch):
    """Off the CPU a soft cap raises (the kernel has none) instead of
    running the plain version, and every other call reaches the kernel's
    wrapper."""
    _, (tq, tk, tv) = _both(_qkv(1, 2, 2, 8, 8, 64, seed=2), "f32")
    monkeypatch.setattr(ops, "_on_cpu", lambda t: False)
    with pytest.raises(NotImplementedError, match="logit_soft_cap"):
        ops.flash_attention(tq, tk, tv, True, None, 30.0)
    calls = []
    monkeypatch.setattr(tfa, "flash_attention", lambda *a: calls.append(a) or a[0].clone())
    k_strided = torch.cat([tk, tk], dim=-1)[..., ::2]
    assert not k_strided.is_contiguous()
    ops.flash_attention(tq, k_strided, tv, True, 4)
    assert len(calls) == 1 and calls[0][3:] == (True, 4)
    assert all(t.is_contiguous() for t in calls[0][:3])
