"""The port's MoE, mamba, RWKV and frontend models against the reference,
on the CPU.

The reference's `init_params` weights go across with
`core.convert.lm_params_from_numpy` and the same numpy tokens go through
both packages:
- the MoE layer: `route` against `_route` (indices exactly), and the
  dispatch body and the dense body, fed the reference's own routes,
  against `_apply_reference`; reduced deepseek-moe-16b, jamba's 16-expert
  layer and qwen2-moe with 6 of 8 experts real (padded experts masked);
- the whole model (reduced deepseek-moe-16b, jamba-v0.1-52b, rwkv6-1.6b,
  musicgen-large with numpy-made frontend embeddings): `forward`,
  `prefill` and one `decode_step` (logits end to end; each layer's output
  and every cache or state leaf -- KV, mamba conv window and SSM state,
  RWKV state -- with the layer fed the reference's own input), and greedy
  `Engine.generate` tokens equal to the reference engine's; a mamba layer
  over two 256-token chunks.

Tolerance for fp32 activations and logits: rtol 1e-4 / atol 1e-5, as in
`test_torch_lm.py`; indices and token streams are compared exactly.  Each
reference program is jitted once per config.
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

from repro.configs import get_reduced as rget_reduced
from repro.models import attention as rattn
from repro.models import mamba as rmamba
from repro.models import modules as rmod
from repro.models import moe as rmoe
from repro.models import rwkv as rrwkv
from repro.models import transformer as RT
from repro.serve.engine import Engine as REngine
from repro_torch.configs import get_reduced
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import mamba, moe, stubs
from repro_torch.models.transformer import Transformer
from repro_torch.serve.engine import Engine

TOL = dict(rtol=1e-4, atol=1e-5)
MODELS = ("deepseek-moe-16b", "jamba-v0.1-52b", "rwkv6-1.6b", "musicgen-large")
PADDED = dict(n_routed=6, n_padded=8)


def _close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               **TOL)


def _close_tree(got, want):
    assert sorted(got) == sorted(want)
    for name in got:
        _close(got[name], want[name])


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a), dtype=dtype)


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(np.int32)


def _frontend(cfg, b, seed=3):
    if not cfg.frontend:
        return None
    return _normal((b, cfg.n_frontend_tokens, cfg.d_model), seed, 0.05)


def _layer(params, layer, cfg):
    """Layer `layer`'s reference parameters, unstacked."""
    return jax.tree.map(lambda a: a[layer // cfg.period], params["blocks"][layer % cfg.period])


@pytest.fixture(scope="module", params=MODELS)
def pair(request):
    """(reference cfg, params, jitted programs, port model) of one arch."""
    rcfg, tcfg = rget_reduced(request.param), get_reduced(request.param)
    params = jax.tree.map(np.asarray, RT.init_params(rcfg, jax.random.PRNGKey(0), jnp.float32))
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(lm_params_from_numpy(tcfg, params))
    progs = dict(
        forward=jax.jit(lambda p, t, fe: RT.forward(p, rcfg, t, fe, remat=False)[0]),
        prefill=jax.jit(lambda p, t, fe: RT.prefill(p, rcfg, t, 20 + rcfg.n_frontend_tokens,
                                                    fe)),
        prefill_block=jax.jit(lambda kind, p, x, n: _ref_prefill_block(rcfg, kind, p, x, n),
                              static_argnums=(0, 3)),
        decode_block=jax.jit(lambda kind, p, x, c, n: _ref_decode_block(rcfg, kind, p, x, c, n),
                             static_argnums=(0,)))
    return rcfg, params, progs, model


# ------------------------------------------------------------------ MoE

@pytest.fixture(scope="module", params=["deepseek-moe-16b", "jamba-v0.1-52b", "qwen2-padded"])
def moe_pair(request):
    """(reference MoEArgs, params, port MoE, tokens [T, d]) for one layer."""
    name = request.param
    base = "qwen2-moe-a2.7b" if name == "qwen2-padded" else name
    over = PADDED if name == "qwen2-padded" else {}
    rcfg = dataclasses.replace(rget_reduced(base), **over)
    tcfg = dataclasses.replace(get_reduced(base), **over)
    a = rcfg.moe_args()
    params = jax.tree.map(np.asarray, rmod.init_tree(rmoe.specs(a), jax.random.PRNGKey(1)))
    layer = _port_layer(moe.MoE(tcfg.moe_args(), device="cpu"), params)
    return a, params, layer, _normal((24, a.d_model), 2)


def test_moe_route_matches_reference(moe_pair):
    a, params, layer, xf = moe_pair
    r_inds, r_gates, r_aux = rmoe._route(params, a, jnp.asarray(xf))
    inds, gates, aux = layer.route(_t(xf))
    np.testing.assert_array_equal(inds.numpy(), np.asarray(r_inds))
    _close(gates, r_gates)
    _close(aux, r_aux)
    if a.e_phys > a.n_routed:
        assert int(inds.max()) < a.n_routed


@pytest.mark.parametrize("body", ["dispatch", "dense"])
def test_moe_bodies_match_reference(moe_pair, body):
    """Fed the reference's routes, both bodies give `_apply_reference`'s y."""
    a, params, layer, xf = moe_pair
    r_inds, r_gates, _ = rmoe._route(params, a, jnp.asarray(xf))
    want, _ = rmoe._apply_reference(params, a, jnp.asarray(xf))
    with torch.no_grad():
        got = getattr(layer, body)(_t(xf), _t(r_inds, torch.long), _t(r_gates))
    _close(got, want)


def test_moe_layer_matches_reference(moe_pair):
    a, params, layer, xf = moe_pair
    x = xf.reshape(2, 12, a.d_model)
    want, r_aux = rmoe.apply(params, a, jnp.asarray(x))
    with torch.no_grad():
        got, aux = layer(_t(x))
    _close(got, want)
    _close(aux, r_aux)


# ------------------------------------------------------- mamba and RWKV

def _port_layer(layer, ref_params):
    """`layer` with the reference's parameter tree loaded (dotted paths)."""
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = _t(v)

    walk(ref_params, "")
    layer.load_state_dict(flat)
    return layer


def test_mamba_layer_over_two_chunks_matches_reference():
    """Two 256-token chunks: the state carried from one chunk to the next
    (the models' tests run prompts shorter than a chunk)."""
    s = 512
    a = rget_reduced("jamba-v0.1-52b").mamba_args()
    p = jax.tree.map(np.asarray, rmod.init_tree(rmamba.specs(a), jax.random.PRNGKey(4)))
    blk = _port_layer(mamba.Mamba(a, device="cpu"), p)
    x = _normal((2, s, a.d_model), 4)
    with torch.no_grad():
        y, cache = blk.apply_and_cache(_t(x))
        y1, cache1 = blk.decode_step(_t(x[:, :1]), cache)

    @jax.jit
    def ref(p, x):
        c = RT._mamba_tail_state(p, a, x)
        return (rmamba.apply(p, a, x), c, *rmamba.decode_step(p, a, x[:, :1], c))

    r_y, r_cache, r_y1, r_cache1 = ref(p, x)
    _close(y, r_y)
    _close_tree(cache, r_cache)
    _close(y1, r_y1)
    _close_tree(cache1, r_cache1)


# ------------------------------------------------------------ the model

def test_forward_matches_reference(pair):
    rcfg, params, progs, model = pair
    toks, fe = _tokens(rcfg, 2, 12), _frontend(rcfg, 2)
    want = progs["forward"](params, toks, fe)
    with torch.no_grad():
        got = model(_t(toks, torch.long), None if fe is None else _t(fe))[0]
    assert got.shape == (2, 12 + rcfg.n_frontend_tokens, rcfg.vocab)
    _close(got, want)


def _ref_prefill_block(rcfg, kind, p, x, max_len):
    """The reference's prefill of one block of `kind` (`transformer.prefill`'s
    `one_block`): (x out, the block's cache)."""
    kind = dict(kind)
    if kind["mixer"] == "rwkv":
        a = rcfg.rwkv_args()
        return rrwkv.apply(p["rwkv"], a, x, rrwkv.init_state(a, x.shape[0]))
    h = rmod.rmsnorm(x, p["ln1"], rcfg.norm_eps)
    if kind["mixer"] == "mamba":
        x = x + rmamba.apply(p["mamba"], rcfg.mamba_args(), h)
        c = RT._mamba_tail_state(p["mamba"], rcfg.mamba_args(), h)
    else:
        y, kv = rattn.apply_and_cache(p["attn"], rcfg.attn_args(kind["mixer"] == "attn_local"), h)
        x = x + y
        c = {k: RT._pad_cache(v, max_len) for k, v in kv.items()}
    return RT._ffn(rcfg, kind, p, x, rmod.rmsnorm(x, p["ln2"], rcfg.norm_eps)), c


def _ref_decode_block(rcfg, kind, p, x, c, cache_len):
    """The reference's decode of one block of `kind`
    (`transformer.decode_step`'s `one_block`)."""
    kind = dict(kind)
    if kind["mixer"] == "rwkv":
        return rrwkv.apply(p["rwkv"], rcfg.rwkv_args(), x, c)
    h = rmod.rmsnorm(x, p["ln1"], rcfg.norm_eps)
    if kind["mixer"] == "mamba":
        y, c = rmamba.decode_step(p["mamba"], rcfg.mamba_args(), h, c)
    else:
        y, c = rattn.decode_step(p["attn"], rcfg.attn_args(kind["mixer"] == "attn_local"),
                                 h, c, cache_len)
    x = x + y
    return RT._ffn(rcfg, kind, p, x, rmod.rmsnorm(x, p["ln2"], rcfg.norm_eps)), c


def test_prefill_and_decode_match_reference(pair):
    """Last-token logits of `prefill` end to end; every layer's output and
    cache or state leaf, in prefill and in one decode step, with that
    layer fed the reference's own input and state; the decode step's
    logits end to end against the reference's head on its own last
    hidden state (the engine test below runs the reference's whole
    `decode_step`).
    Held end to end instead, the leaves of reduced jamba's deeper layers
    drift past the tolerance: rounding in another operation order
    compounds through its 16 layers, while each layer alone agrees at a
    few ulps."""
    rcfg, params, progs, model = pair
    toks, fe = _tokens(rcfg, 2, 12, seed=1), _frontend(rcfg, 2)
    max_len = 20 + rcfg.n_frontend_tokens
    r_logits, r_caches, r_len = progs["prefill"](params, toks, fe)
    t_logits, t_caches, t_len = model.prefill(_t(toks, torch.long), max_len,
                                              None if fe is None else _t(fe))
    _close(t_logits, r_logits)
    np.testing.assert_array_equal(t_len.numpy(), np.asarray(r_len))
    assert len(t_caches) == rcfg.n_layers
    # layer 0's input is the embedding: its cache end to end, which also
    # holds `_ref_prefill_block` to the reference's own prefill
    _close_tree(t_caches[0], jax.tree.map(lambda a: a[0], r_caches[0]))
    tok = np.argmax(np.asarray(r_logits), -1).astype(np.int32)
    t2, _ = model.decode_step(_t(tok, torch.long), t_caches, t_len)

    x = params["embed"][toks]
    if fe is not None:
        x = np.concatenate([fe, x], 1)
    x1 = params["embed"][tok][:, None]
    for layer, block in enumerate(model.blocks):
        kind = tuple(sorted(rcfg.layer_kind(layer % rcfg.period).items()))
        p = _layer(params, layer, rcfg)
        want_x, want_c = progs["prefill_block"](kind, p, x, max_len)
        with torch.no_grad():
            got_x, got_c = block.prefill(_t(x), max_len)
        _close(got_x, want_x)
        _close_tree(got_c, want_c)
        want_x1, want_c1 = progs["decode_block"](kind, p, x1, want_c, r_len)
        with torch.no_grad():
            got_x1, got_c1 = block.decode_step(
                _t(x1), {k: _t(v) for k, v in want_c.items()}, t_len)
        _close(got_x1, want_x1)
        _close_tree(got_c1, want_c1)
        x, x1 = np.asarray(want_x), np.asarray(want_x1)
    # the decode step's logits: `transformer.decode_step`'s last lines on
    # the reference's own last hidden state
    h = rmod.rmsnorm(jnp.asarray(x1[:, 0]), params["ln_f"], rcfg.norm_eps)
    _close(t2, rmod.dense(h, params["head"]))


def test_engine_greedy_tokens_match_reference(pair):
    """Two prompts of different lengths decoded side by side in a 2-slot
    pool (a reused slot is held in `test_torch_lm.py`)."""
    rcfg, params, _, model = pair
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, rcfg.vocab, n).astype(np.int32) for n in (9, 5)]
    want = REngine(rcfg, params, n_slots=2, max_len=20, eos_id=-1).generate(prompts, 5)
    got = Engine(model, n_slots=2, max_len=20, eos_id=-1).generate(prompts, 5)
    assert got == want


def test_long_jamba_prompt_raises_on_both_sides():
    """A prompt past one 256-token mamba chunk must be a multiple of it."""
    rcfg = rget_reduced("jamba-v0.1-52b")
    toks = _tokens(rcfg, 1, 300)
    shapes = jax.eval_shape(lambda: RT.init_params(rcfg, jax.random.PRNGKey(0)))
    with pytest.raises(AssertionError):
        jax.eval_shape(lambda p: RT.prefill(p, rcfg, jnp.asarray(toks), 304), shapes)
    model = Transformer(get_reduced("jamba-v0.1-52b"), device="cpu",
                        generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="256-token chunk"):
        model.prefill(_t(toks, torch.long), 304)


def test_engine_casts_state_into_the_pool():
    """A bf16 RWKV model prefills bf16 token-shift carries; the pool keeps
    the reference's fp32 state and serves from it."""
    cfg = get_reduced("rwkv6-1.6b")
    model = Transformer(cfg, device="cpu", dtype=torch.bfloat16,
                        generator=torch.Generator().manual_seed(0))
    eng = Engine(model, n_slots=2, max_len=16, eos_id=-1)
    prompt = np.arange(2, 9, dtype=np.int32)
    _, one, _ = model.prefill(torch.as_tensor(prompt, dtype=torch.long)[None], 16)
    assert one[0]["x_tm"].dtype == torch.bfloat16
    eng.submit(prompt, 4)
    for pool, c in zip(eng.caches, one):
        assert all(pool[k].dtype == torch.float32 for k in pool)
        assert torch.equal(pool["x_tm"][0], c["x_tm"][0].float())
    while eng.active.any():
        eng.step()


def test_synth_frontend_is_seeded():
    draw = [stubs.synth_frontend(torch.Generator().manual_seed(s), "audio", 2, 3, 8)
            for s in (0, 0, 1)]
    assert draw[0].dtype == torch.bfloat16 and draw[0].shape == (2, 3, 8)
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    assert stubs.frontend_tokens("vision") == 576 and stubs.frontend_tokens(None) == 0


@pytest.mark.parametrize("name", ["deepseek-moe-16b", "qwen2-moe-a2.7b", "jamba-v0.1-52b",
                                  "rwkv6-1.6b", "llava-next-34b", "musicgen-large"])
def test_launcher_serves_every_family_on_cpu(name):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", name, "--reduced", "--torch-device", "cpu",
                    "--requests", "3", "--max-new", "4"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["req0", "req1", "req2"]
    assert all(len(ast.literal_eval(ln.split(":", 1)[1].strip())) == 4 for ln in lines)
