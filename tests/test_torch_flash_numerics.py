"""What the flash-attention kernel's tensor-core routes round, emulated on the CPU.

The CUDA kernel runs only on the card, so its arithmetic is held to the
reference here through a plain PyTorch emulation of each route:
- `wgmma` (bf16 inputs): both products accumulate exact bf16 products in
  fp32; P is rounded to bf16 before P V, while the row sum l adds the fp32
  weights.
- `tf32x3` (fp32 inputs): every operand x of both products splits into
  hi = tf32(x), rounded to nearest with ties away from zero as
  `cvt.rna.tf32.f32` does (add half a TF32 ulp, then mask the low 13
  mantissa bits), and lo = x - hi truncated to TF32 (the low 13 bits
  masked: the tensor core reads only the top 19), and the product is
  hi*hi + hi*lo + lo*hi in fp32.
Each emulation must stay within the tolerance `chip_smoke.py` holds the
kernel to (`tol()`: bf16 rtol/atol 2e-2; fp32 rtol 2e-5 / atol 1e-5)
against the reference `repro.kernels.ref.flash_attention_ref`, on numpy
inputs from a seed: a shape of the reference's test grid, a window, the S < T chunk,
and the serving path's prefill shape (S = 2048, D = 128) at reduced heads.
`route` is the plain function that picks the variant from dtype and D.

What this cannot see: each emulated product is an exact fp32 matmul on the
CPU, so nothing here models how the tensor core aligns and truncates each
addend as it adds into its accumulator, nor the order in which the kernel
adds a tile's products.  An accumulation-order fault passes here: carrying
one P V accumulator through every kv tile inside `mma.sync` holds the
tolerance per call yet put 13 of yi-6b's 64,000 last-token logits outside
1e-4 of the plain attention's.  The guard against such faults is
`chip_smoke.py`'s serving logits check, on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import flash_attention as tfa

TOL = {"bf16": dict(rtol=2e-2, atol=2e-2), "f32": dict(rtol=2e-5, atol=1e-5)}
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CASES = [  # (b, h, hkv, s, t, d, window, input scale)
    (1, 8, 1, 384, 384, 128, None, 0.02),
    (1, 4, 2, 300, 300, 64, 100, 1.0), (2, 4, 2, 64, 320, 64, None, 1.0),
    (1, 4, 1, 2048, 2048, 128, None, 1.0),          # serving prefill, 4 of 32 heads
]


def tf32(x: torch.Tensor, half_ulp: int = 0x1000) -> torch.Tensor:
    """fp32 to TF32: to nearest with ties away from zero, or truncated
    with half_ulp=0."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + half_ulp) & -0x2000).view(torch.float32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products, in fp32: the two small ones summed
    apart from hi*hi, as the kernel sums S."""
    a_hi, b_hi = tf32(a), tf32(b)
    a_lo, b_lo = tf32(a - a_hi, 0), tf32(b - b_hi, 0)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def emulate(q, k, v, window, variant):
    """Causal attention as the kernel's `variant` rounds it (fp32 out)."""
    s_len, t_len = q.shape[2], k.shape[2]
    rep = q.shape[1] // k.shape[1]
    q, k, v = q.float(), k.float().repeat_interleave(rep, 1), v.float().repeat_interleave(rep, 1)
    mm = mm_3xtf32 if variant == "tf32x3" else torch.matmul
    logits = mm(q, k.transpose(-1, -2)) * (1.0 / np.sqrt(q.shape[-1]))
    q_pos = torch.arange(s_len)[:, None] + (t_len - s_len)
    k_pos = torch.arange(t_len)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    m = logits.masked_fill(~mask, -1e30).amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(logits - m), torch.zeros(()))
    l = p.sum(-1, keepdim=True)
    if variant == "wgmma":
        out = p.to(torch.bfloat16).float() @ v
    else:
        out = mm(p, v)
    return out / l


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:6])) + f"w{c[6]}")
@pytest.mark.parametrize("dt", ["bf16", "f32"])
def test_route_emulation_within_chip_tolerance(case, dt):
    b, h, hkv, s, t, d, window, scale = case
    rng = np.random.default_rng(s * 7 + t + d)
    arrays = [rng.normal(size=(b, h, s, d)) * scale, rng.normal(size=(b, hkv, t, d)) * scale,
              rng.normal(size=(b, hkv, t, d)) * scale]
    jdt, tdt = DTYPES[dt]
    jq, jk, jv = (jnp.asarray(a, jnp.float32).astype(jdt) for a in arrays)
    tq, tk, tv = (torch.tensor(a, dtype=torch.float32).to(tdt) for a in arrays)
    variant = tfa.route(tdt, d)
    got = emulate(tq, tk, tv, window, variant).to(tdt).float()
    want = np.asarray(rref.flash_attention_ref(jq, jk, jv, True, window), np.float32)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dt])


def test_tf32_rounding_matches_cvt_rna():
    """Half a TF32 ulp rounds away from zero, less rounds down, the low 13
    bits of the result are 0, and hi + truncated lo carries x to 2^-21 of
    |x|; three products are far closer to fp32 than one."""
    one_ulp = 2.0 ** -10
    x = torch.tensor([1 + one_ulp / 2, -(1 + one_ulp / 2), 1 + one_ulp / 2 - 2 ** -23,
                      3.0, 1e-3], dtype=torch.float32)
    got = tf32(x)
    assert got[:3].tolist() == [1 + one_ulp, -(1 + one_ulp), 1.0]
    assert got[3] == 3.0
    assert int((got.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    lo = tf32(x - got, 0)
    assert ((x - got - lo).abs() <= x.abs() * 2.0 ** -21).all()
    a = torch.tensor(np.random.default_rng(0).normal(size=(16, 64)), dtype=torch.float32)
    err_1 = (tf32(a) @ tf32(a).T - a @ a.T).abs().max()
    err_3 = (mm_3xtf32(a, a.T) - a @ a.T).abs().max()
    assert err_3 < err_1 / 100


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 64, "tf32x3"),
    (torch.float32, 128, "tf32x3"), (torch.float32, 256, "fma"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    assert tfa.route(dtype, d) == want


@pytest.mark.parametrize("dtype,d", [
    (torch.float16, 128), (torch.float32, 96), (torch.bfloat16, 32), (torch.float64, 64),
])
def test_route_refuses_what_no_variant_takes(dtype, d):
    with pytest.raises(ValueError, match="no kernel"):
        tfa.route(dtype, d)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 16, 64), (torch.float32, 64, 64), (torch.float32, 96, 128),
    (torch.float32, 200, 256), (torch.bfloat16, 16, 64), (torch.bfloat16, 129, 256),
])
def test_padded_dim_is_the_next_variant(dtype, d, want):
    assert tfa.padded_dim(dtype, d) == want
    tfa.route(dtype, want)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 257), (torch.float16, 16),
                                     (torch.float32, 0)])
def test_padded_dim_refuses_what_no_variant_takes(dtype, d):
    with pytest.raises(ValueError, match="no kernel"):
        tfa.padded_dim(dtype, d)
