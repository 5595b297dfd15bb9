"""The port's training path against the reference, on the CPU.

The same numpy inputs go through both packages:
- the data pipeline's batches byte for byte (a shard split, frontend
  embeddings, `resume` onto another split);
- `schedule_lr` for every schedule over steps 0 .. total + 5, `update` on a
  random tree over three steps (with and without int8 compression), and
  the int8 round trip;
- `loss_fn` and every parameter's gradient for reduced yi-6b (GQA, 2 KV
  heads) and deepseek-moe-16b, the reference's `init_params` carried over
  by `core.convert.lm_params_from_numpy` (the reference's gradient tree
  goes across the same way), and one `make_train_step` step;
- then the port alone: remat on and off, 2 microbatches against 1, one
  step of every other family, and the counterparts of the reference's
  system tests (`tests/test_system.py`): loss falls, checkpoint restart and
  failure recovery reproduce the uninterrupted run bit for bit,
  atomicity, async save, clip bound, error feedback.

Tolerances (fp32 on the CPU; XLA and ATen order their reductions and
matmuls differently, and XLA may fuse a multiply-add): the learning rate,
the norm and the master rtol 1e-6 (the learning rate atol 1e-7 near 0), m,
v and the residual within 1e-6 of the leaf's max |x|; the loss rtol 1e-5;
each gradient within GRAD_TOL = 1e-4 of its own max |g| (m and v of a step
within twice that); a step's new parameters rtol 1e-5 / atol 1e-6 where
the gradient is above 1e-3 of the leaf's largest, and within 2 x the
learning rate elsewhere: AdamW's first step divides each gradient by its
own magnitude, so a gradient near 0 (|g| ~ eps = 1e-8) carries the two
packages' rounding into its parameter at up to a fraction of the learning
rate.  Each reference program is jitted once per architecture.
"""
import dataclasses
import os
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as rget_reduced
from repro.data import pipeline as rpipe
from repro.models import transformer as RT
from repro.train import optimizer as ropt
from repro.train.train_step import make_train_step as rmake_train_step
from repro_torch.ckpt import checkpoint
from repro_torch.configs import get_reduced
from repro_torch.core.convert import lm_params_from_numpy
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.transformer import Transformer
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import (batch_to, loss_and_grads, make_eval_step,
                                          make_train_step, params_of)
from repro_torch.train.trainer import Trainer, TrainerConfig

ARCHS = {"yi-6b": {"n_kv_heads": 2}, "deepseek-moe-16b": {}}
GRAD_TOL = 1e-4
SEQ, BATCH = 16, 4


def _np(t):
    return t.detach().float().numpy()


# --------------------------------------------------------------- data

def _rcfg(**kw):
    return rpipe.DataConfig(**kw)


@pytest.mark.parametrize("kw", [dict(vocab=101, seq_len=16, global_batch=8, seed=3),
                                dict(vocab=512, seq_len=9, global_batch=4, seed=0, noise=1),
                                dict(vocab=97, seq_len=5, global_batch=2, seed=5,
                                     frontend_tokens=3, d_model=8)])
def test_pipeline_batches_equal_the_reference(kw):
    for shard, n_shards in ((0, 1), (1, 2), (3, 4)):
        if kw["global_batch"] % n_shards:
            continue
        want_p = rpipe.Pipeline(_rcfg(**kw), shard, n_shards)
        got_p = Pipeline(DataConfig(**kw), shard, n_shards)
        assert (got_p.a, got_p.c) == (want_p.a, want_p.c)
        for step in (0, 5, 999):
            want, got = want_p.batch(step), got_p.batch(step)
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
        assert got_p.state(7) == want_p.state(7)


def test_pipeline_resume_equals_the_reference():
    kw = dict(vocab=101, seq_len=16, global_batch=8, seed=3)
    state = Pipeline(DataConfig(**kw), 1, 2).state(11)
    for split in ((None, None), (3, 4)):
        got = Pipeline.resume(DataConfig(**kw), state, *split).batch(11)
        want = rpipe.Pipeline.resume(_rcfg(**kw), state, *split).batch(11)
        assert got["tokens"].tobytes() == want["tokens"].tobytes()


# ---------------------------------------------------------- optimizer

@pytest.mark.parametrize("schedule", ["const", "cosine", "wsd"])
def test_schedule_lr_matches_reference(schedule):
    cfg = dict(lr=3e-3, warmup_steps=5, total_steps=30, schedule=schedule)
    steps = np.arange(0, 36, dtype=np.int32)
    want = jax.vmap(lambda s: ropt.schedule_lr(ropt.OptConfig(**cfg), s))(jnp.asarray(steps))
    got = opt.schedule_lr(opt.OptConfig(**cfg), torch.tensor(steps))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6, atol=1e-7)


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(7, 5)).astype(np.float32),
            "b": {"c": rng.normal(size=(11,)).astype(np.float32),
                  "d": rng.normal(size=(3, 2, 4)).astype(np.float32)}}


def _tree_close(got, want, scaled=None, **tol):
    """Leaf by leaf; with `scaled`, each leaf within `scaled` x its own max |x|."""
    for (path, a), b in zip(torch.utils._pytree.tree_flatten_with_path(got)[0],
                            jax.tree.leaves(want)):
        b = np.asarray(b)
        if scaled is not None:
            tol = dict(rtol=0, atol=scaled * np.abs(b).max())
        np.testing.assert_allclose(_np(a), b, err_msg=str(path), **tol)


@pytest.mark.parametrize("compress", [False, True])
def test_update_matches_reference(compress):
    cfg = dict(lr=1e-2, warmup_steps=2, total_steps=10, compress_grads=compress,
               clip_norm=2.0)
    params = _random_tree(0)
    r_params = jax.tree.map(jnp.asarray, params)
    t_params = jax.tree.map(torch.tensor, params)
    r_state, t_state = ropt.init(r_params, compress), opt.init(t_params, compress)
    for step in range(3):
        grads = jax.tree.map(lambda a: a * (3.0 if step == 1 else 0.5), _random_tree(step + 1))
        r_params, r_state, r_m = ropt.update(ropt.OptConfig(**cfg), r_params,
                                             jax.tree.map(jnp.asarray, grads), r_state)
        t_params, t_state, t_m = opt.update(opt.OptConfig(**cfg), t_params,
                                            jax.tree.map(torch.tensor, grads), t_state)
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(_np(t_m[k]), np.asarray(r_m[k]), rtol=1e-6)
        assert int(t_state["step"]) == int(r_state["step"])
        _tree_close(t_state["master"], r_state["master"], rtol=1e-6)
        for k in ("m", "v") + (("err",) if compress else ()):
            _tree_close(t_state[k], r_state[k], scaled=1e-6)
        _tree_close(t_params, r_params, rtol=1e-6)


def test_int8_round_trip_matches_reference():
    g = np.random.default_rng(4).normal(size=(257,)).astype(np.float32) * 3
    rq, rs = ropt.quantize_int8(jnp.asarray(g))
    tq, ts = opt.quantize_int8(torch.tensor(g))
    assert tq.dtype == torch.int8 and np.array_equal(tq.numpy(), np.asarray(rq))
    assert float(ts) == float(rs)
    err = np.random.default_rng(5).normal(size=(257,)).astype(np.float32) * 1e-2
    (r_deq, r_res) = (t["g"] for t in ropt.compress_with_feedback(
        {"g": jnp.asarray(g)}, {"g": jnp.asarray(err)}))
    (t_deq, t_res) = (t["g"] for t in opt.compress_with_feedback(
        {"g": torch.tensor(g)}, {"g": torch.tensor(err)}))
    np.testing.assert_array_equal(_np(t_deq), np.asarray(r_deq))
    ulp = np.spacing(np.abs(g + err).astype(np.float32))
    assert np.all(np.abs(_np(t_res) - np.asarray(r_res)) <= ulp)


# ------------------------------------------------------------ the LM

def _configs(name):
    over = ARCHS[name]
    return (dataclasses.replace(rget_reduced(name), **over),
            dataclasses.replace(get_reduced(name), **over))


def _batch(cfg, step=0, seed=1):
    return Pipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=BATCH,
                               seed=seed)).batch(step)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def lm(request):
    """The reference's weights, loss and gradients on one batch (one jitted
    program per architecture), and a port model holding those weights."""
    name = request.param
    rcfg, tcfg = _configs(name)
    params = RT.init_params(rcfg, jax.random.PRNGKey(0), jnp.float32)
    batch = _batch(tcfg)
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: RT.loss_fn(p, rcfg, b), has_aux=True))
    (loss, metrics), grads = grad_fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    state = lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, params))
    model = Transformer(tcfg, device="cpu")
    model.load_state_dict(state)
    return dict(name=name, rcfg=rcfg, tcfg=tcfg, params=params, state=state, batch=batch,
                loss=float(loss), metrics={k: float(v) for k, v in metrics.items()},
                grads=lm_params_from_numpy(tcfg, jax.tree.map(np.asarray, grads)),
                model=model)


def _port_grads(model, batch, remat=True):
    batch = batch_to(batch, "cpu")
    if remat:
        return loss_and_grads(model, batch)
    logits, aux = model(batch["tokens"], remat=False)
    xent = T.M.softmax_xent(logits, batch["targets"])
    names, ps = zip(*model.named_parameters())
    grads = torch.autograd.grad(xent + aux, ps)
    return xent + aux, {"xent": xent, "aux": aux}, dict(zip(names, grads))


def test_loss_and_grads_match_reference(lm):
    loss, metrics, grads = _port_grads(lm["model"], lm["batch"])
    np.testing.assert_allclose(float(loss), lm["loss"], rtol=1e-5)
    for k in ("xent", "aux"):
        np.testing.assert_allclose(float(metrics[k]), lm["metrics"][k], rtol=1e-5)
    if lm["name"] == "deepseek-moe-16b":
        assert float(metrics["aux"]) > 0
    assert sorted(grads) == sorted(lm["grads"])
    for name, g in grads.items():
        want = lm["grads"][name].numpy()
        np.testing.assert_allclose(_np(g), want, rtol=0, atol=GRAD_TOL * np.abs(want).max(),
                                   err_msg=name)


def test_eval_step_is_the_loss_without_gradients(lm):
    got = make_eval_step(lm["tcfg"])(lm["model"], batch_to(lm["batch"], "cpu"))
    assert not got["loss"].requires_grad
    np.testing.assert_allclose(float(got["loss"]), lm["loss"], rtol=1e-5)
    np.testing.assert_allclose(float(got["xent"]), lm["metrics"]["xent"], rtol=1e-5)


def test_remat_leaves_gradients_unchanged(lm):
    a = _port_grads(lm["model"], lm["batch"], remat=True)
    b = _port_grads(lm["model"], lm["batch"], remat=False)
    assert torch.equal(a[0], b[0])
    for name in a[2]:
        assert torch.equal(a[2][name], b[2][name]), name


def _fresh(lm):
    model = Transformer(lm["tcfg"], device="cpu")
    model.load_state_dict(lm["state"])
    return model


def test_microbatches_match_one_batch(lm):
    """2 microbatches: the loss is the mean of the two halves' losses and the
    gradient (m after one step, without clipping, is 0.1 x the gradient)
    the mean of their gradients; for the dense model both equal the whole
    batch's within tol (MoE's aux term is not linear in the batch, in the
    reference too)."""
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4, clip_norm=1e30)
    outs = []
    for n_micro in (1, 2):
        model = _fresh(lm)
        st, metrics = make_train_step(lm["tcfg"], ocfg, n_micro)(
            model, opt.init(params_of(model)), batch_to(lm["batch"], "cpu"))
        outs.append((st["m"], metrics))
    (m1, met1), (m2, met2) = outs
    halves = [_port_grads(_fresh(lm), {k: v[i * BATCH // 2:(i + 1) * BATCH // 2]
                                        for k, v in lm["batch"].items()}) for i in (0, 1)]
    np.testing.assert_allclose(float(met2["loss"]),
                               (float(halves[0][0]) + float(halves[1][0])) / 2, rtol=1e-6)
    for name, m in m2.items():
        want = 0.1 * (halves[0][2][name] + halves[1][2][name]) / 2
        torch.testing.assert_close(m, want, rtol=0, atol=1e-6 * float(want.abs().max()))
    if lm["name"] == "yi-6b":
        np.testing.assert_allclose(float(met2["loss"]), float(met1["loss"]), rtol=1e-5)
        for name in m1:
            torch.testing.assert_close(m2[name], m1[name], rtol=0,
                                       atol=GRAD_TOL * float(m1[name].abs().max()))


def test_train_step_matches_reference(lm):
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=4)
    step = jax.jit(rmake_train_step(lm["rcfg"], ropt.OptConfig(**ocfg)))
    r_params, r_state, r_m = step(lm["params"], ropt.init(lm["params"]),
                                  {k: jnp.asarray(v) for k, v in lm["batch"].items()})
    model = _fresh(lm)
    t_state, t_m = make_train_step(lm["tcfg"], opt.OptConfig(**ocfg))(
        model, opt.init(params_of(model)), batch_to(lm["batch"], "cpu"))
    for k in ("loss", "xent", "grad_norm", "lr"):
        np.testing.assert_allclose(float(t_m[k]), float(r_m[k]), rtol=1e-5, err_msg=k)
    for k in ("m", "v"):
        want = lm_params_from_numpy(lm["tcfg"], jax.tree.map(np.asarray, r_state[k]))
        for name, a in t_state[k].items():
            np.testing.assert_allclose(_np(a), want[name].numpy(), rtol=0,
                                       atol=2 * GRAD_TOL * np.abs(want[name].numpy()).max(),
                                       err_msg=f"{k} {name}")
    want = lm_params_from_numpy(lm["tcfg"], jax.tree.map(np.asarray, r_params))
    r_v = lm_params_from_numpy(lm["tcfg"], jax.tree.map(np.asarray, r_state["v"]))
    for name, p in params_of(model).items():
        g = np.sqrt(r_v[name].numpy() / (1 - ropt.OptConfig().beta2))   # |clipped grad|
        sure = g > 1e-3 * g.max()
        np.testing.assert_allclose(_np(p)[sure], want[name].numpy()[sure], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        assert np.abs(_np(p) - want[name].numpy()).max() <= 2 * ocfg["lr"], name
    assert int(t_state["step"]) == 1


def test_serving_skips_the_moe_aux_term():
    layer = moe.MoE(get_reduced("deepseek-moe-16b").moe_args(), device="cpu",
                    generator=torch.Generator().manual_seed(0))
    xf = torch.randn(24, layer.args.d_model, generator=torch.Generator().manual_seed(1))
    inds, gates, aux = layer.route(xf)
    s_inds, s_gates, s_aux = layer.route(xf, aux=False)
    assert s_aux is None and float(aux) > 0
    assert torch.equal(inds, s_inds) and torch.equal(gates, s_gates)


# ---------------------------------------------------------- the port

@pytest.mark.parametrize("name", ["rwkv6-1.6b", "jamba-v0.1-52b", "qwen2-moe-a2.7b",
                                  "llava-next-34b", "musicgen-large"])
def test_every_family_takes_a_training_step(name):
    cfg = get_reduced(name)
    tr = Trainer(cfg, opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=1),
                 TrainerConfig(steps=1, ckpt_every=0, log_every=1),
                 DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2,
                            frontend_tokens=cfg.n_frontend_tokens, d_model=cfg.d_model),
                 device="cpu")
    (row,) = tr.run()
    assert np.isfinite([row["loss"], row["grad_norm"]]).all()
    assert (row["aux"] > 0) == (cfg.n_routed > 0)


def test_bf16_params_train_on_an_fp32_master():
    cfg = get_reduced("yi-6b")
    tr = Trainer(cfg, opt.OptConfig(lr=1e-3, warmup_steps=1, total_steps=2),
                 TrainerConfig(steps=2, ckpt_every=0, log_every=1, param_dtype=torch.bfloat16),
                 DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=2), device="cpu")
    hist = tr.run()
    assert np.isfinite([h["loss"] for h in hist]).all()
    assert all(p.dtype == torch.bfloat16 for p in tr.params.values())
    for name, m in tr.opt_state["master"].items():
        assert m.dtype == torch.float32 and torch.equal(m.to(torch.bfloat16), tr.params[name])


def _trainer(tmp, steps=6, arch="yi-6b", inject=None, ckpt_every=2, total_steps=None,
             seq_len=32):
    red = get_reduced(arch)
    return Trainer(
        red, opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=total_steps or steps),
        TrainerConfig(steps=steps, ckpt_every=ckpt_every,
                      ckpt_dir=os.path.join(tmp, "ckpt"), log_every=1,
                      inject_failure_at=inject),
        DataConfig(vocab=red.vocab, seq_len=seq_len, global_batch=4), device="cpu")


def test_training_reduces_loss(tmp_path):
    hist = _trainer(str(tmp_path), steps=100).run()
    first = np.mean([h["loss"] for h in hist[:5]])
    last = np.mean([h["loss"] for h in hist[-5:]])
    assert last < first, (first, last)


def _same_rows(a, b):
    keys = ("step", "loss", "xent", "aux", "grad_norm", "lr")
    assert [[r[k] for k in keys] for r in a] == [[r[k] for k in keys] for r in b]


def test_checkpoint_restart_bitwise(tmp_path):
    """Stop at 4, restart, continue to 8 == the uninterrupted run to 8."""
    t1 = _trainer(str(tmp_path / "a"), steps=8, ckpt_every=4)
    h_full = t1.run()
    t2 = _trainer(str(tmp_path / "b"), steps=4, ckpt_every=4, total_steps=8)
    t2.run()
    t3 = _trainer(str(tmp_path / "b"), steps=8, ckpt_every=4)
    assert t3.step == 4          # restored
    h_resumed = t3.run()
    _same_rows(h_resumed, h_full[4:])
    for name, p in t1.params.items():
        assert torch.equal(p, t3.params[name]), name
    for k in ("m", "v", "master"):
        for name, a in t1.opt_state[k].items():
            assert torch.equal(a, t3.opt_state[k][name]), (k, name)


def test_failure_recovery_resumes(tmp_path):
    """At 128 x 4 tokens of width 64 the embedding's gradient has 32768
    terms, where an indexed lookup's backward (index_put) would add them
    with atomics from several threads; the model's lookup sums in order."""
    tr = _trainer(str(tmp_path / "a"), steps=8, inject=5, ckpt_every=2, seq_len=128)
    hist = tr.run_with_recovery()
    assert tr.step == 8 and np.isfinite(hist[-1]["loss"])
    full = _trainer(str(tmp_path / "b"), steps=8, ckpt_every=2, seq_len=128)
    h_full = full.run()
    # the failure fires once 5 steps are done; the restore goes back to the
    # checkpoint of step 4, so step 5 runs again and is logged twice, alike
    assert [h["step"] for h in hist] == [1, 2, 3, 4, 5, 5, 6, 7, 8]
    _same_rows(hist[4:6], [h_full[4]] * 2)
    _same_rows([h for i, h in enumerate(hist) if i != 5], h_full)
    for name, p in full.params.items():
        assert torch.equal(p, tr.params[name]), name


def test_checkpoint_atomicity(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    checkpoint.save(d, 1, tree)
    checkpoint.save(d, 2, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2}})
    assert checkpoint.latest_steps(d) == [1, 2]
    got = checkpoint.restore(d, tree, step=2)
    np.testing.assert_allclose(got["a"].numpy(), np.arange(10.0) * 2)
    assert not any(n.endswith(".tmp") for n in os.listdir(d))
    # keep=1 garbage-collects older steps
    checkpoint.save(d, 3, tree, keep=1)
    assert checkpoint.latest_steps(d) == [3]
    assert checkpoint.manifest(d)["n_arrays"] == 2
    with pytest.raises(ValueError, match="shape"):
        checkpoint.restore(d, {"a": torch.zeros(9), "b": {"c": torch.ones((3, 3))}})


def test_checkpoint_async_and_dtypes(tmp_path):
    d = str(tmp_path / "ck")
    tree = {"x": torch.ones(4), "h": torch.full((3,), 1.5, dtype=torch.bfloat16),
            "step": torch.tensor(7, dtype=torch.int32)}
    fut = checkpoint.save(d, 7, tree, async_=True)
    fut.result(timeout=30)
    assert checkpoint.latest_steps(d) == [7]
    got = checkpoint.restore(d, tree)
    for k, v in tree.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v)


def test_adamw_descends_quadratic():
    p = {"w": torch.ones(8) * 5.0}
    st_ = opt.init(p)
    cfg = opt.OptConfig(lr=0.1, warmup_steps=1, total_steps=100,
                        weight_decay=0.0, schedule="const")
    for _ in range(150):
        g = {"w": 2 * st_["master"]["w"]}
        p, st_, _ = opt.update(cfg, p, g, st_)
    assert float(p["w"].abs().max()) < 0.3


def test_grad_clip_bounds_update():
    p = {"w": torch.ones(4)}
    st_ = opt.init(p)
    cfg = opt.OptConfig(lr=1.0, clip_norm=1e-3, warmup_steps=1,
                        schedule="const", weight_decay=0.0)
    new, _, m = opt.update(cfg, p, {"w": torch.full((4,), 1e6)}, st_)
    assert float(m["grad_norm"]) > 1e5   # raw norm reported
    assert float((new["w"] - p["w"]).abs().max()) <= 1.0 + 1e-6


def test_int8_compression_error_feedback_unbiased():
    g_true = torch.tensor(np.random.default_rng(0).normal(0, 1, (64,)), dtype=torch.float32)
    err, acc = torch.zeros(64), torch.zeros(64)
    for _ in range(200):
        deq, new_err = opt.compress_with_feedback({"g": g_true}, {"g": err})
        err = new_err["g"]
        acc = acc + deq["g"]
    np.testing.assert_allclose((acc / 200).numpy(), g_true.numpy(), atol=0.05)


def test_launcher_dry_run_names_the_sharding_item(monkeypatch):
    """--dry-run runs launch.dryrun's train_4k cell in a fresh interpreter
    (its fake process group is process-global); --multi-pod only with it."""
    calls = []
    monkeypatch.setattr(launch_train.subprocess, "run",
                        lambda cmd, env: calls.append((cmd, env)) or types.SimpleNamespace(
                            returncode=0))
    for extra in ([], ["--multi-pod"]):
        with pytest.raises(SystemExit) as e:
            launch_train.main(["--arch", "yi-6b", "--dry-run", "--torch-device", "cpu", *extra])
        assert e.value.code == 0
    (cmd, env), (cmd_mp, _) = calls
    assert cmd[1:] == ["-m", "repro_torch.launch.dryrun", "--arch", "yi-6b", "--shape",
                       "train_4k", "--out", "experiments/dryrun", "--device", "cpu"]
    assert cmd_mp[1:] == cmd[1:] + ["--multi-pod"]
    assert env["PYTHONPATH"].split(os.pathsep)[0] == str(Path(launch_train.__file__).resolve().parents[2])
    with pytest.raises(SystemExit) as e:
        launch_train.main(["--arch", "yi-6b", "--multi-pod"])
    assert e.value.code == 2


def test_port_files_exist():
    root = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
    for rel in ("train/optimizer.py", "train/train_step.py", "train/trainer.py",
                "ckpt/checkpoint.py", "data/pipeline.py", "runtime/elastic.py",
                "launch/train.py", "examples/train_lm.py"):
        assert (root / rel).is_file(), rel
