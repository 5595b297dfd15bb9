"""The port's LM serving path against the reference, on the CPU.

The reference's `init_params` weights go across with
`core.convert.lm_params_from_numpy`, and the same tokens go through both
packages: the apply-side helpers, `forward`, `prefill` (last-token logits
and KV caches) and `decode_step` on reduced yi-6b with 2 KV heads (GQA;
every `get_reduced` config has as many KV heads as query heads) and on
reduced gemma3-12b at S = 48, past its window of 32 and below the 4 x
window length where the reference switches to its banded route.  Greedy
`Engine.generate` tokens must equal the reference engine's exactly.

Tolerance for fp32 activations and logits: rtol 1e-4 / atol 1e-5.  The
two packages run the same fp32 math through different matmul and
reduction orders (XLA vs ATen on the CPU), and those differences compound
through the layers; token streams are compared exactly.
"""
import ast
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as rget_arch
from repro.configs import get_reduced as rget_reduced
from repro.models import modules as rmod
from repro.models import transformer as RT
from repro.serve.engine import Engine as REngine
from repro_torch.configs import ARCHS, get_arch, get_reduced
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve
from repro_torch.models import modules as tmod
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine

TOL = dict(rtol=1e-4, atol=1e-5)
CASES = {"yi-6b": ({"n_kv_heads": 2}, 12), "gemma3-12b": ({}, 48)}


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **(tol or TOL))


def _configs(name):
    overrides = CASES[name][0]
    return (dataclasses.replace(rget_reduced(name), **overrides),
            dataclasses.replace(get_reduced(name), **overrides))


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    """(name, reference cfg, reference params, port cfg, port model)."""
    name = request.param
    rcfg, tcfg = _configs(name)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0), jnp.float32)
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params)))
    return name, rcfg, params, tcfg, model


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def test_helpers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    gamma = rng.normal(size=16).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0) + np.array([[0], [7]])
    tx, tg = torch.tensor(x), torch.tensor(gamma)
    _close(tmod.rmsnorm(tx, tg), rmod.rmsnorm(jnp.asarray(x), jnp.asarray(gamma)))
    _close(tmod.rope(tx, torch.tensor(pos), 1e4), rmod.rope(jnp.asarray(x), jnp.asarray(pos), 1e4))
    ws = [rng.normal(size=s).astype(np.float32) * 0.2 for s in ((16, 24), (16, 24), (24, 16))]
    _close(tmod.swiglu(tx, *map(torch.tensor, ws)),
           rmod.swiglu(jnp.asarray(x), *map(jnp.asarray, ws)))


def test_forward_matches_reference(pair):
    name, rcfg, params, tcfg, model = pair
    toks = _tokens(rcfg, 2, CASES[name][1])
    want, _ = RT.forward(params, rcfg, jnp.asarray(toks), remat=False)
    with torch.no_grad():
        got = model(torch.tensor(toks, dtype=torch.long))
    _close(got, want)


def test_prefill_and_decode_match_reference(pair):
    name, rcfg, params, tcfg, model = pair
    s, max_len = CASES[name][1], CASES[name][1] + 4
    toks = _tokens(rcfg, 2, s, seed=1)
    r_logits, r_caches, r_len = RT.prefill(params, rcfg, jnp.asarray(toks), max_len)
    t_logits, t_caches, t_len = model.prefill(torch.tensor(toks, dtype=torch.long), max_len)
    _close(t_logits, r_logits)
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(r_len))
    assert len(t_caches) == rcfg.n_layers
    for layer, c in enumerate(t_caches):
        for kv in ("k", "v"):
            _close(c[kv], r_caches[layer % rcfg.period][kv][layer // rcfg.period])

    tok = np.argmax(np.asarray(r_logits), -1).astype(np.int32)
    r2, r_caches2 = RT.decode_step(params, rcfg, jnp.asarray(tok), r_caches, r_len)
    t2, t_caches2 = model.decode_step(torch.tensor(tok, dtype=torch.long), t_caches, t_len)
    _close(t2, r2)
    for layer, c in enumerate(t_caches2):
        for kv in ("k", "v"):
            _close(c[kv], r_caches2[layer % rcfg.period][kv][layer // rcfg.period])


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_matches_forward(name):
    """Prefill + 1 decode == teacher-forced forward at the last position."""
    cfg = _configs(name)[1]
    model = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    toks = torch.tensor(_tokens(cfg, 2, 16), dtype=torch.long)
    logits, caches, clen = model.prefill(toks, 20)
    tok1 = torch.argmax(logits, -1)
    logits2, _ = model.decode_step(tok1, caches, clen)
    with torch.no_grad():
        full = model(torch.cat([toks, tok1[:, None]], 1))
    torch.testing.assert_close(logits2, full[:, -1], rtol=1e-3, atol=2e-4)


def test_engine_greedy_tokens_match_reference():
    rcfg, tcfg = _configs("yi-6b")
    params = RT.init_params(rcfg, jax.random.PRNGKey(1), jnp.float32)
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params)))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rcfg.vocab, rng.integers(4, 10)).astype(np.int32)
               for _ in range(4)]
    want = REngine(rcfg, params, n_slots=2, max_len=24, eos_id=-1).generate(prompts, 8)
    got = Engine(model, n_slots=2, max_len=24, eos_id=-1).generate(prompts, 8)
    assert got == want
    assert tfa.KERNEL.launches == 0


def test_engine_sampling_is_seeded():
    cfg = _configs("yi-6b")[1]
    model = Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    prompts = [np.arange(5, dtype=np.int32), np.arange(3, 9, dtype=np.int32)]
    runs = [Engine(model, 2, 24, eos_id=-1, temperature=1.0, seed=seed).generate(prompts, 6)
            for seed in (7, 7, 8)]
    assert runs[0] == runs[1] != runs[2]
    assert all(len(t) == 6 for t in runs[0].values())


def test_launcher_on_cpu_prints_one_line_per_request():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "yi-6b", "--reduced", "--torch-device", "cpu",
                    "--requests", "3", "--max-new", "4"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["req0", "req1", "req2"]
    assert all(len(ast.literal_eval(ln.split(":", 1)[1].strip())) == 4 for ln in lines)


def test_launcher_guards():
    if torch.cuda.is_available():
        pytest.skip("a card is present, so the default device does not raise")
    for argv in (["--arch", "yi-6b", "--reduced"], ["--placement"], ["--placement", "--frontend"],
                 ["--placement", "--cache", "--autoscale"]):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            serve.main(argv)
    with pytest.raises(NotImplementedError, match="item 11"):
        serve.main(["--arch", "yi-6b", "--dry-run"])


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "deepseek-moe-16b",
                                  "rwkv6-1.6b", "musicgen-large"])
def test_unported_blocks_raise_when_built(name):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 11"):
        Transformer(get_reduced(name), device="cpu")


def test_param_counts_match_reference():
    dense = [a for a in ARCHS if not rget_arch(a).frontend
             and all(rget_arch(a).layer_kind(p) in ({"mixer": "attn", "ffn": "mlp"},
                                                      {"mixer": "attn_local", "ffn": "mlp"})
                     for p in range(rget_arch(a).period))]
    assert {"yi-6b", "gemma3-12b", "granite-8b", "mistral-large-123b"} <= set(dense)
    for name in dense:
        assert get_arch(name).param_count() == rget_arch(name).param_count()
    assert get_arch("yi-6b").param_count() == 6_061_035_520
