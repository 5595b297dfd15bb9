"""The port's sharded paths across processes and its dry-run, on the CPU.

Four groups of processes for the module, started together:
- one spawn of 2 `gloo` ranks (a `FileStore` under tmp_path, joins bounded
  by `JOIN_S`) on a (1, 2) ("data", "model") mesh, each running, on reduced
  configs with weights from a seed:
  - yi-6b's prefill and 3 decode steps with DTensor parameters laid out by
    `spec_for(param_axes)` under `activate` (heads-sharded flash prefill,
    the split-KV decode over the kv_seq-sharded cache), and one training
    loss with every parameter's gradient, against the unsharded port on
    the same weights;
  - reduced deepseek-moe's training loss, aux and every gradient against
    the unsharded port, capacity not binding, expert parallel on (1, 2)
    and data parallel on (2, 1);
  - one deepseek-moe MoE layer's `_apply_ep` (4 of 8 experts a rank) with
    capacity not binding against `MoE.dense`, and at capacity_factor 1.0,
    where pairs are dropped;
  - `islands.run(mesh=)` over a 2-rank "islands" mesh against `group=`, and
    `evolve.run_islands(mesh=)`, bit for bit;
  - `checkpoint.restore(shardings=)` of a tree saved unsharded, and that
    DTensor tree saved again from both ranks;
- one spawn of 4 `gloo` ranks on a (2, 2) ("data", "model") mesh, the
  production layout's shape, with tokens fed as a plain tensor: reduced
  yi-6b's prefill, 3 decode steps, training loss and every gradient, and
  reduced deepseek-moe's prefill logits, against the unsharded port; and
  reduced deepseek-moe's training loss, aux and every gradient, capacity
  not binding, against the reference's own program on a (2, 2) mesh (the
  aux there is the mean of each shard's Switch term, not the unsharded
  model's);
- one reference process with 4 forced XLA host devices, which runs the
  reference's `_apply_ep` (shard_map) on the same MoE layer and input at
  capacity_factor 1.0 on 2 of them (the port's 2-rank result must equal it
  within 1e-5), and reduced deepseek-moe's `loss_fn` and gradients on a
  (2, 2) mesh of all 4;
- one process with a fake process group, which runs the port's dry-run on
  reduced yi-6b at decode_32k on (16, 16), counts an L-layer matmul
  stack's flops and one Shard -> Shard redistribution under `commcount`,
  and then, on a fake (2, 2) mesh, a reduced yi-6b train step's flops per
  device against the same step unsharded.
"""
import copy
import dataclasses
import datetime
import json
import math
import multiprocessing
import os
import subprocess
import sys
import textwrap
import time
import traceback
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import base as tbase
from repro_torch.core import evolve
from repro_torch.core import islands as TI
from repro_torch.core import nsga2 as TN
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.sharding import logical
from repro_torch.train import train_step

ROOT = Path(__file__).resolve().parents[1]
WORLD, JOIN_S, SEED = 2, 300, 3
MESH22 = (2, 2)                    # ("data", "model") on 4 ranks
PROMPT, MAX_LEN, STEPS = (2, 12), 16, 3
MOE_X = (2, 8)                     # [B, S] tokens into the MoE layer
TOL = dict(rtol=1e-5, atol=1e-5)


def _moe_args(capacity_factor):
    return dataclasses.replace(tbase.get_reduced("deepseek-moe-16b").moe_args(),
                               capacity_factor=capacity_factor)


def _moe_inputs():
    """The MoE layer's weights and input, as numpy, from SEED."""
    a = _moe_args(1.0)
    layer = TM.MoE(a, device="cpu", generator=torch.Generator().manual_seed(SEED))
    x = np.random.default_rng(SEED).normal(0, 1, (*MOE_X, a.d_model)).astype(np.float32)
    return {k: v.detach().numpy() for k, v in layer.state_dict().items()}, x


def _distributed(module, mesh):
    """`module` with every parameter a DTensor laid out by its logical axes."""
    from torch.distributed.tensor import distribute_tensor
    axes = TT.param_axes(module)
    rules = logical.default_rules()
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        pl = logical.placements(logical.spec_for(axes[name], p.shape, mesh, rules), mesh)
        setattr(mod, leaf, torch.nn.Parameter(
            distribute_tensor(p.detach(), mesh, pl, src_data_rank=None), requires_grad=False))
    return module


def _full(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _lm(mesh, rules):
    cfg = tbase.get_reduced("yi-6b")
    plain = TT.Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    sharded = _distributed(copy.deepcopy(plain), mesh)
    rng = np.random.default_rng(SEED)
    tokens = torch.tensor(rng.integers(0, cfg.vocab, PROMPT), dtype=torch.int32)
    steps = torch.tensor(rng.integers(0, cfg.vocab, (STEPS, PROMPT[0])), dtype=torch.int32)
    want, caches, clen = plain.prefill(tokens, MAX_LEN)
    wants = [want]
    for tok in steps:
        want, caches = plain.decode_step(tok, caches, clen)
        clen = clen + 1
        wants.append(want)
    with logical.activate(mesh, rules):
        got, caches, clen = sharded.prefill(tokens, MAX_LEN)
        prefilled = caches[0]["k"]
        gots = [_full(got)]
        for tok in steps:
            got, caches = sharded.decode_step(tok, caches, clen)
            clen = clen + 1
            gots.append(_full(got))
    kv = caches[0]["k"]
    # one training loss and its gradients: the vocab-parallel embedding and
    # cross-entropy, the flash backward on local shards, through DTensor
    return dict(want=torch.stack(wants), got=torch.stack(gots),
                train=_train(plain, sharded, tokens, mesh, rules),
                prefill_placements=str(prefilled.placements),
                cache_placements=str(kv.placements), cache_local=tuple(kv.to_local().shape))


def _train(plain, sharded, tokens, mesh, rules):
    """Loss, aux and every parameter's gradient of one batch, unsharded
    (`want`) and under `activate(mesh, rules)` (`got`)."""
    batch = {"tokens": tokens.long(), "targets": torch.roll(tokens.long(), -1, 1)}
    want_loss, want_m, want_g = train_step.loss_and_grads(plain.requires_grad_(True), batch)
    sharded.requires_grad_(True)
    with logical.activate(mesh, rules):
        got_loss, got_m, got_g = train_step.loss_and_grads(sharded, batch)
    return dict(want=[want_loss, want_m["aux"]] + [want_g[k] for k in sorted(want_g)],
                got=[_full(got_loss), _full(got_m["aux"])] + [_full(got_g[k]) for k in sorted(got_g)])


def _deepseek():
    """Reduced deepseek-moe-16b with weights from SEED, capacity not binding,
    and its tokens."""
    cfg = tbase.get_reduced("deepseek-moe-16b")
    plain = TT.Transformer(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    for layer in plain.modules():
        if isinstance(layer, TM.MoE):
            layer.args = dataclasses.replace(layer.args, capacity_factor=100.0)
    tokens = torch.tensor(np.random.default_rng(SEED + 1).integers(0, cfg.vocab, PROMPT),
                          dtype=torch.int32)
    return plain, tokens


def _moe_train(mesh, rules):
    """Reduced deepseek-moe-16b's training loss and gradients on `mesh`,
    capacity not binding: expert parallel on (1, 2), every expert on each
    rank's batch shard on (2, 1), both on (2, 2)."""
    plain, tokens = _deepseek()
    return _train(plain, _distributed(copy.deepcopy(plain), mesh), tokens, mesh, rules)


def _moe_prefill(mesh, rules):
    """Reduced deepseek-moe-16b's last-token prefill logits, unsharded
    (`want`) and on `mesh` (`got`)."""
    plain, tokens = _deepseek()
    sharded = _distributed(copy.deepcopy(plain), mesh)
    want = plain.prefill(tokens, MAX_LEN)[0]
    with logical.activate(mesh, rules):
        got = _full(sharded.prefill(tokens, MAX_LEN)[0])
    return dict(want=want, got=got)


def _moe(mesh, rules, weights, x, capacity_factor):
    layer = TM.MoE(_moe_args(capacity_factor), device="cpu")
    layer.load_state_dict({k: torch.tensor(v) for k, v in weights.items()})
    xt = torch.tensor(x)
    xf = xt.reshape(-1, xt.shape[-1])
    inds, gates, _ = layer.route(xf)
    dense = layer.dense(xf, inds, gates).reshape(xt.shape)
    dense = dense + layer(xt)[0] - layer.dispatch(xf, inds, gates).reshape(xt.shape)
    _distributed(layer, mesh)
    with logical.activate(mesh, rules):
        y, aux = layer(xt)
    return dict(y=_full(y), aux=_full(aux), dense=dense)


def _rank_main(rank, store_path, out_path, ckpt_dir):
    try:
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.ckpt import checkpoint

        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, WORLD), rank=rank, world_size=WORLD,
            timeout=datetime.timedelta(seconds=JOIN_S))
        mesh = init_device_mesh("cpu", (1, WORLD), mesh_dim_names=("data", "model"))
        rules = logical.default_rules()
        out = {"lm": _lm(mesh, rules)}
        weights, x = _moe_inputs()
        out["moe_free"] = _moe(mesh, rules, weights, x, 100.0)
        out["moe_cap1"] = _moe(mesh, rules, weights, x, 1.0)
        out["moe_train"] = {shape: _moe_train(init_device_mesh(
            "cpu", shape, mesh_dim_names=("data", "model")), rules)
            for shape in ((1, WORLD), (WORLD, 1))}

        problem, icfg = tnet.make_problem(tdev.get_device("xcvu_test")), TI.IslandConfig(4, 2)
        cfg = TN.NSGA2Config(pop_size=8)
        isl = init_device_mesh("cpu", (WORLD,), mesh_dim_names=("islands",))
        out["islands_mesh"] = TI.run(problem, "nsga2", cfg, torch.Generator().manual_seed(SEED),
                                     4, islands=icfg, mesh=isl, device="cpu")
        out["islands_group"] = TI.run(problem, "nsga2", cfg, torch.Generator().manual_seed(SEED),
                                      4, islands=icfg, device="cpu", group=dist.group.WORLD)
        out["run_islands_mesh"] = evolve.run_islands(
            problem, "nsga2", cfg, torch.Generator().manual_seed(SEED), 2, 2, mesh=isl,
            axis="islands", device="cpu")
        out["run_islands_group"] = evolve.run_islands(
            problem, "nsga2", cfg, torch.Generator().manual_seed(SEED), 2, 2,
            group=dist.group.WORLD, device="cpu")
        try:
            TI.run(problem, "nsga2", cfg, torch.Generator(), 1, islands=icfg, mesh=mesh,
                   device="cpu")
            out["no_axis"] = "ran"
        except ValueError as e:
            out["no_axis"] = f"ValueError: {e}"

        tree = {"w": torch.arange(48, dtype=torch.float32).reshape(8, 6),
                "b": {"v": torch.arange(4, dtype=torch.float32)}}
        if rank == 0:
            checkpoint.save(ckpt_dir, 7, tree)
        dist.barrier()
        shard = logical.tree_shardings({"w": ("embed", "mlp"), "b": {"v": ("vocab",)}},
                                       {"w": (8, 6), "b": {"v": (4,)}}, mesh, rules)
        got = checkpoint.restore(ckpt_dir, tree, shardings=shard)
        # every rank saves the DTensor tree (a gather); rank 0 writes it whole
        checkpoint.save(ckpt_dir, 8, got)
        dist.barrier()
        resaved = checkpoint.restore(ckpt_dir, tree, step=8)
        out["restore"] = dict(full=[_full(got["w"]), _full(got["b"]["v"])],
                              local=[got["w"].to_local(), got["b"]["v"].to_local()],
                              resaved=[resaved["w"], resaved["b"]["v"]],
                              placements=[str(got["w"].placements),
                                          str(got["b"]["v"].placements)])
        torch.save(out, out_path)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


def _mesh22_main(rank, store_path, out_path):
    try:
        from torch.distributed.device_mesh import init_device_mesh

        world = math.prod(MESH22)
        dist.init_process_group(
            "gloo", store=dist.FileStore(store_path, world), rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=JOIN_S))
        mesh = init_device_mesh("cpu", MESH22, mesh_dim_names=("data", "model"))
        rules = logical.default_rules()
        out = {"lm": _lm(mesh, rules), "moe_prefill": _moe_prefill(mesh, rules),
               "moe_train": _moe_train(mesh, rules)["got"]}
        torch.save(out, out_path)
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.configs import get_reduced
    from repro.models import moe
    from repro.models import transformer as RT
    from repro.runtime.jaxcompat import make_mesh
    from repro.sharding import logical
    d = np.load(sys.argv[1])
    a = dataclasses.replace(get_reduced("deepseek-moe-16b").moe_args(), capacity_factor=1.0)
    p = {k: jnp.asarray(d[k]) for k in ("router", "wg", "wu", "wd")}
    p["shared"] = {k: jnp.asarray(d["shared." + k]) for k in ("wg", "wu", "wd")}
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    with logical.activate(mesh, logical.default_rules()):
        y, aux = jax.jit(lambda p, x: moe.apply(p, a, x))(p, jnp.asarray(d["x"]))
    np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))

    # reduced deepseek-moe's loss and gradients on (2, 2), the port's weights
    # (blocks.<layer>.<path> -> blocks[layer % period][path][layer // period])
    w = np.load(sys.argv[3])
    cfg = get_reduced("deepseek-moe-16b")
    free = RT.ArchConfig.moe_args
    RT.ArchConfig.moe_args = lambda c: dataclasses.replace(free(c), capacity_factor=100.0)

    def layers(pos):
        return range(pos, cfg.n_layers, cfg.period)

    def fill(node, prefix, pos):
        return {k: fill(v, f"{prefix}{k}.", pos) if isinstance(v, dict) else
                jnp.stack([jnp.asarray(w[f"blocks.{l}.{prefix}{k}"]) for l in layers(pos)])
                for k, v in node.items()}

    def flat(node, prefix, pos, out):
        for k, v in node.items():
            if isinstance(v, dict):
                flat(v, f"{prefix}{k}.", pos, out)
            else:
                for l in layers(pos):
                    out[f"blocks.{l}.{prefix}{k}"] = np.asarray(v)[l // cfg.period]
        return out

    like = RT.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    params = {k: jnp.asarray(w[k]) for k in ("embed", "ln_f", "head")}
    params["blocks"] = [fill(b, "", pos) for pos, b in enumerate(like["blocks"])]
    tokens = jnp.asarray(w["tokens"])
    batch = {"tokens": tokens, "targets": jnp.roll(tokens, -1, 1)}
    with logical.activate(make_mesh((2, 2), ("data", "model")), logical.default_rules()):
        (loss, m), g = jax.jit(jax.value_and_grad(lambda p, b: RT.loss_fn(p, cfg, b),
                                                  has_aux=True))(params, batch)
    out = {k: np.asarray(g[k]) for k in ("embed", "ln_f", "head")}
    for pos, b in enumerate(g["blocks"]):
        flat(b, "", pos, out)
    np.savez(sys.argv[4], loss=np.asarray(loss), aux=np.asarray(m["aux"]), **out)
""")

FAKE = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch.launch import dryrun
    from repro_torch.sharding import commcount, logical
    out = dryrun.run_cell("yi-6b", "decode_32k", False, save_dir=sys.argv[1], verbose=False,
                          device="cpu", reduced=True)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(device_type="cpu")
    L, M, K = 3, 512, 256
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(M, K), mesh, logical.placements(("data", None), mesh),
                              src_data_rank=None)
        ws = [distribute_tensor(torch.empty(K, K), mesh, logical.placements((None, None), mesh),
                                src_data_rank=None) for _ in range(L)]
        with commcount.counting() as cc:
            for w in ws:
                x = x @ w
    out["stack_flops"] = cc.report()["flops"]
    out["stack_collectives"] = cc.report()["collectives"]["total"]
    out["stack"] = [L, M, K]
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(64, 32), mesh, logical.placements((None, "model"), mesh),
                              src_data_rank=None)
        with commcount.counting() as cc:
            x = x.redistribute(mesh, logical.placements(("model", None), mesh))
    out["alltoall"] = dict(cc.report(), local=list(x.to_local().shape))

    # a reduced train step on a fake (2, 2) mesh and unsharded, at 256 tokens
    # a row (at 4096 the attention's flops, split either way, hide the rest)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import base as cbase
    from repro_torch.models import transformer as T
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step
    cbase.SHAPES["train_256"] = cbase.ShapeSpec("train_256", 256, 16, "train")
    cfg, rules = cbase.get_reduced("yi-6b"), logical.default_rules()
    dryrun.init_fake_group(4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    with FakeTensorMode(), logical.activate(mesh, rules):
        fn, _, n_micro = dryrun.build_cell(cfg, "train_256", mesh, rules, "cpu")
        with commcount.counting() as cc:
            fn()
    out["train_sharded_flops"] = cc.report()["flops"]
    with FakeTensorMode():
        model = T.Transformer(cfg, device="cpu", dtype=torch.bfloat16)
        params = dict(model.named_parameters())
        state = {k: {n: torch.zeros(p.shape) for n, p in params.items()}
                 for k in ("master", "m", "v")}
        state["step"] = torch.zeros((), dtype=torch.int32)
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in cbase.input_specs(cfg, "train_256").items()}
        with commcount.counting() as cc:
            make_train_step(cfg, opt.OptConfig(), n_micro)(model, state, batch)
    out["train_unsharded_flops"] = cc.report()["flops"]
    json.dump(out, open(sys.argv[2], "w"))
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2 and 4 ranks' results, the reference's `_apply_ep` and (2, 2)
    training, and the fake-group counts, from processes started together.
    A group that fails or hangs fails only the tests that read it."""
    tmp = tmp_path_factory.mktemp("sharding_dist")
    weights, x = _moe_inputs()
    np.savez(tmp / "moe.npz", x=x, **weights)
    plain, tokens = _deepseek()
    np.savez(tmp / "deepseek.npz", tokens=tokens.numpy(),
             **{k: v.detach().numpy() for k, v in plain.named_parameters()})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    subs = {"ref": subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp / "moe.npz"),
                                     str(tmp / "ref.npz"), str(tmp / "deepseek.npz"),
                                     str(tmp / "ref22.npz")], env=env),
            "fake": subprocess.Popen([sys.executable, "-c", FAKE, str(tmp / "dryrun"),
                                      str(tmp / "fake.json")], env=env)}
    ctx = multiprocessing.get_context("spawn")
    outs = [tmp / f"rank{r}.pt" for r in range(WORLD)]
    outs22 = [tmp / f"mesh22_rank{r}.pt" for r in range(math.prod(MESH22))]
    groups = {
        "ranks": [ctx.Process(target=_rank_main, args=(r, str(tmp / "store"), str(outs[r]),
                                                       str(tmp / "ckpt")))
                  for r in range(WORLD)],
        "mesh22": [ctx.Process(target=_mesh22_main, args=(r, str(tmp / "store22"),
                                                          str(outs22[r])))
                   for r in range(len(outs22))]}
    for procs in groups.values():
        for proc in procs:
            proc.start()
    deadline = time.monotonic() + JOIN_S
    failed = {}
    for name, procs in groups.items():
        for proc in procs:
            proc.join(max(deadline - time.monotonic(), 0))
        hung = [p.pid for p in procs if p.is_alive()]
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join(5)
        if hung:
            failed[name] = f"ranks {hung} did not finish within {JOIN_S} s"
        elif any(p.exitcode for p in procs):
            failed[name] = f"exit codes {[p.exitcode for p in procs]}"
    for name, p in subs.items():
        try:
            code = p.wait(max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            p.kill()
            code = "timeout"
        if code != 0:
            failed[name] = f"exit code {code}"
    out = dict(failed=failed)
    if "ranks" not in failed:
        out["ranks"] = [torch.load(o, weights_only=False) for o in outs]
    if "mesh22" not in failed:
        out["mesh22"] = [torch.load(o, weights_only=False) for o in outs22]
    if "ref" not in failed:
        out["ref"] = dict(np.load(tmp / "ref.npz"))
        out["ref22"] = dict(np.load(tmp / "ref22.npz"))
    if "fake" not in failed:
        out["fake"] = json.loads((tmp / "fake.json").read_text())
    return out


def _read(runs, *names):
    """The results of the named process groups; fails if one of them failed."""
    bad = {n: runs["failed"][n] for n in names if n in runs["failed"]}
    assert not bad, f"process groups failed: {bad}"
    return [runs[n] for n in names] if len(names) > 1 else runs[names[0]]


def test_sharded_prefill_and_split_kv_decode_equal_unsharded(runs):
    for rank in _read(runs, "ranks"):
        lm = rank["lm"]
        torch.testing.assert_close(lm["got"], lm["want"], **TOL)
        # prefill leaves the cache on its kv heads (the reference's rule: kv_heads
        # claims "model" first); decode splits it over "model" on its sequence
        assert lm["prefill_placements"] == "(Replicate(), Shard(dim=1))"
        assert lm["cache_placements"] == "(Shard(dim=0), Shard(dim=2))"
        assert lm["cache_local"][2] == MAX_LEN // WORLD


def test_sharded_loss_and_gradients_equal_unsharded(runs):
    for rank in _read(runs, "ranks"):
        t = rank["lm"]["train"]
        assert len(t["got"]) == len(t["want"]) > 20
        for got, want in zip(t["got"], t["want"]):
            torch.testing.assert_close(got, want, **TOL)


def test_apply_ep_without_binding_capacity_equals_dense(runs):
    for rank in _read(runs, "ranks"):
        m = rank["moe_free"]
        torch.testing.assert_close(m["y"], m["dense"], **TOL)
        assert m["aux"].shape == () and torch.isfinite(m["aux"])


@pytest.mark.parametrize("shape", [(1, WORLD), (WORLD, 1)], ids=["experts", "batch"])
def test_moe_loss_and_gradients_equal_unsharded(runs, shape):
    for rank in _read(runs, "ranks"):
        t = rank["moe_train"][shape]
        assert len(t["got"]) == len(t["want"]) > 20 and float(t["want"][1]) > 0
        for got, want in zip(t["got"], t["want"]):
            torch.testing.assert_close(got, want, **TOL)


def test_apply_ep_drops_the_reference_pairs(runs):
    ranks, ref = _read(runs, "ranks", "ref")
    for rank in ranks:
        m = rank["moe_cap1"]
        np.testing.assert_allclose(m["y"].numpy(), ref["y"], **TOL)
        np.testing.assert_allclose(float(m["aux"]), float(ref["aux"]), **TOL)
        # capacity binds: some routed pairs were dropped
        assert (m["y"] - m["dense"]).abs().max() > 1e-3


def _equal(a, b):
    la, lb = torch.utils._pytree.tree_leaves(a), torch.utils._pytree.tree_leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_islands_over_a_mesh_equal_the_group_path(runs):
    for rank in _read(runs, "ranks"):
        assert _equal(rank["islands_mesh"], rank["islands_group"])
        assert _equal(rank["run_islands_mesh"], rank["run_islands_group"])
        assert rank["no_axis"].startswith("ValueError") and "islands" in rank["no_axis"]


def test_restore_onto_a_mesh(runs):
    w = torch.arange(48, dtype=torch.float32).reshape(8, 6)
    for r, rank in enumerate(_read(runs, "ranks")):
        got = rank["restore"]
        assert torch.equal(got["full"][0], w)
        assert torch.equal(got["full"][1], torch.arange(4, dtype=torch.float32))
        assert got["placements"] == ["(Replicate(), Shard(dim=1))", "(Replicate(), Shard(dim=0))"]
        assert torch.equal(got["local"][0], w[:, 3 * r:3 * r + 3])
        assert torch.equal(got["resaved"][0], w) and torch.equal(got["resaved"][1], got["full"][1])


def _closed_form_argument_bytes():
    """Local bytes of reduced yi-6b's decode_32k arguments on (16, 16),
    from `spec_for`: bf16 parameters and caches, int32 token and cache_len."""
    cfg, ss = tbase.get_reduced("yi-6b"), tbase.SHAPES["decode_32k"]
    mesh = types.SimpleNamespace(shape={"data": 16, "model": 16})
    rules = logical.default_rules()

    def local(axes, shape, nbytes):
        spec = logical.spec_for(axes, shape, mesh, rules)
        return nbytes * math.prod(d // logical.axes_size(mesh, s) for d, s in zip(shape, spec))

    model = TT.Transformer(cfg, device="cpu")
    axes = TT.param_axes(model)
    n = sum(local(axes[k], p.shape, 2) for k, p in model.named_parameters())
    kv = (ss.global_batch, cfg.n_kv_heads, ss.seq_len, cfg.d_head)
    n += cfg.n_layers * 2 * local(("batch", None, "kv_seq", None), kv, 2)
    return n + 2 * local(("batch",), (ss.global_batch,), 4)


def test_dry_run_cell_on_a_fake_group(runs):
    out = _read(runs, "fake")
    assert out["status"] == "ok", out.get("error")
    assert out["memory"]["argument_bytes"] == _closed_form_argument_bytes()
    assert out["collectives"]["total"] > 0 and out["collectives"]["all-reduce"] > 0
    assert out["rules"]["kv_seq"] == "model"
    assert out["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert out["cost"]["flops_per_device"] > 0
    L, M, K = out["stack"]
    assert out["stack_flops"] == L * 2 * (M // 16) * K * K
    assert out["stack_collectives"] == 0


def test_mesh22_prefill_decode_and_training_equal_unsharded(runs):
    """yi-6b on (2, 2) with plain tokens: the vocab-sharded embedding's
    masked rows are reduced under the batch split."""
    for rank in _read(runs, "mesh22"):
        lm = rank["lm"]
        torch.testing.assert_close(lm["got"], lm["want"], **TOL)
        assert lm["prefill_placements"] == "(Shard(dim=0), Shard(dim=1))"
        assert lm["cache_placements"] == "(Shard(dim=0), Shard(dim=2))"
        assert lm["cache_local"][0] == PROMPT[0] // MESH22[0]
        assert lm["cache_local"][2] == MAX_LEN // MESH22[1]
        t = lm["train"]
        assert len(t["got"]) == len(t["want"]) > 20
        for got, want in zip(t["got"], t["want"]):
            torch.testing.assert_close(got, want, **TOL)


def test_mesh22_moe_prefill_equals_unsharded(runs):
    for rank in _read(runs, "mesh22"):
        m = rank["moe_prefill"]
        torch.testing.assert_close(m["got"], m["want"], **TOL)


def test_mesh22_moe_training_equals_the_reference_on_2x2(runs):
    """Loss, aux and every gradient against the reference's `loss_fn` on a
    (2, 2) mesh: batch and experts both sharded, so the aux is the mean of
    each batch shard's Switch term, in both packages."""
    mesh22, ref = _read(runs, "mesh22", "ref22")
    plain, _ = _deepseek()
    names = sorted(n for n, _ in plain.named_parameters())
    assert sorted(k for k in ref if k not in ("loss", "aux")) == names
    want = [ref["loss"], ref["aux"]] + [ref[k] for k in names]
    assert float(ref["aux"]) > 0
    for rank in mesh22:
        got = rank["moe_train"]
        assert len(got) == len(want)
        for name, g, w in zip(["loss", "aux"] + names, got, want):
            np.testing.assert_allclose(g.detach().numpy(), w, **TOL, err_msg=name)


def test_shard_to_shard_books_one_all_to_all(runs):
    """On a CPU mesh DTensor gathers and chunks in place of the all-to-all;
    `commcount` books the all-to-all, of the output's bytes, and no gather."""
    a2a = _read(runs, "fake")["alltoall"]
    assert a2a["local"] == [64 // 16, 32]
    want = 64 // 16 * 32 * 4
    assert a2a["collectives"] == {"all-reduce": 0.0, "all-gather": 0.0, "reduce-scatter": 0.0,
                                  "all-to-all": want, "collective-permute": 0.0, "total": want}
    assert a2a["collective_calls"] == {"all-to-all": 1}


def test_train_cell_flops_per_device_are_the_unsharded_share(runs):
    """A gradient laid out as its value is: no rank runs a backward matmul
    at full width, so a device's flops are the unsharded step's / 4."""
    out = _read(runs, "fake")
    share = out["train_unsharded_flops"] / math.prod(MESH22)
    assert out["train_sharded_flops"] == pytest.approx(share, rel=0.02)
