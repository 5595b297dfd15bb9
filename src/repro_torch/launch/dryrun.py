"""Dry-run: trace every (arch x shape) step on the production meshes and
record per-device memory, flops and collective bytes for the roofline.

Port of `repro/launch/dryrun.py`.  The reference lowers and compiles each
cell for 256 or 512 placeholder host devices and reads XLA's memory and
cost analyses.  Here the mesh is a `DeviceMesh` over a *fake* process
group (`torch.testing._internal.distributed.fake_pg.FakeStore`, backend
"fake") of 256 ranks ((16, 16), ("data", "model")) or 512 ((2, 16, 16),
("pod", "data", "model")), of which this process is rank 0.  The
parameters, optimizer state, inputs and caches are DTensors laid out by
`sharding.logical.spec_for` on `param_axes` (with the reference's ZeRO-1
and FSDP rule), their local shards fake tensors (`FakeTensorMode`:
nothing is allocated and no kernel launches; the flash-attention custom
op runs its fake implementation).  The cell's train step, prefill or
decode step then runs eagerly under `sharding.commcount`, which sums
rank 0's local ops: collective bytes by kind, dot flops, a traffic proxy
and the peak of live bytes.  The fake group carries no data, so what
rank 0 counts is what every rank does, the layouts being symmetric.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes] \\
        [--out experiments/dryrun] [--rules JSON] [--device cuda|cpu]

The fake group is process-global: this module initialises it itself, only
when run (never on import), and refuses a process whose default group has
another world size.  Run it in a process of its own.

Per cell it writes <out>/<arch>__<shape>__<mesh>.json with the reference's
keys, except that `lower_s` / `compile_s` are one `trace_s`, and:
  * memory: `argument_bytes` and `output_bytes` are the local shards' bytes
    of the step's inputs and outputs; `temp_bytes` is the peak of live
    bytes allocated while the step ran (outputs included); `alias_bytes`
    is 0 (eager mode donates nothing) and `peak_estimate_bytes` is
    argument + temp bytes (the `memory_note` key says so);
  * the roofline terms use one H100 SXM's data-sheet rates
    (`sharding.costmodel.H100`).
The vu_systolic ea_round cell *executes*: the reference runs one NSGA-II
island per placeholder chip; a fake group moves no data, so here the same
256 (512) islands of pop 16 x 2 generations run as one `islands.run`
batch on the real device and `best_objs` is recorded (`note` says so).
The reference's `REPRO_FSDP_PARAMS` lever (FSDP for serving cells) is left
out.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.configs import base as cbase
from repro_torch.configs.base import SHAPES, input_specs, shape_applicable
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.sharding import commcount, logical
from repro_torch.sharding import costmodel as cm

MEMORY_NOTE = ("argument/output bytes: local shards of the step's inputs/outputs; "
               "temp_bytes: peak of live bytes allocated during the eager trace "
               "(outputs included); peak_estimate_bytes = argument + temp")
_OWN = [False]           # the fake default group was initialised here


def init_fake_group(world: int) -> None:
    """Make the default process group a fake one of `world` ranks (this
    process rank 0).  A fake group this module made is replaced when the
    size differs; any other group of another size raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        if not _OWN[0]:
            raise RuntimeError(f"the dry-run needs a default process group of {world} ranks; "
                               f"this process has one of {dist.get_world_size()}")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    _OWN[0] = True


def _batch_axes(rules: logical.Rules):
    b = rules.get("batch") or ()
    return (b,) if isinstance(b, str) else tuple(b)


def layout(axes, shape, mesh, rules, zero1: bool = False):
    """Placements of a tensor of logical `axes` at `shape`; `zero1`
    additionally shards the first still-replicated dim that divides over
    the free batch dims (ZeRO-1 / FSDP, the reference's rule)."""
    spec = logical.spec_for(axes, shape, mesh, rules)
    if zero1:
        sizes = logical.mesh_shape(mesh)
        parts = list(spec)
        used = {a for p in parts if p for a in ((p,) if isinstance(p, str) else p)}
        free = tuple(a for a in _batch_axes(rules) if a in sizes and a not in used)
        if free:
            size = logical.axes_size(mesh, free)
            for i, p in enumerate(parts):
                if p is None and shape[i] % size == 0 and shape[i] >= size:
                    parts[i] = free if len(free) > 1 else free[0]
                    break
            spec = tuple(parts)
    return logical.placements(spec, mesh)


def _distribute(t: torch.Tensor, mesh, placements):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    n = 0
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            t = t.to_local() if isinstance(t, DTensor) else t
            n += t.numel() * t.element_size()
    return n


def batch_axes_of(batch: Dict[str, torch.Tensor]):
    out = {}
    for k, v in batch.items():
        if k == "frontend_embeds":
            out[k] = ("batch", None, None)
        elif v.dim() == 2:
            out[k] = ("batch", None)
        else:
            out[k] = ("batch",)
    return out


def cache_axes(t: torch.Tensor):
    """Logical axes of one layer's serving state, by rank (the reference's
    `_cache_axes` without its leading periods dim)."""
    return {4: ("batch", None, "kv_seq", None), 3: ("batch", "ssm_inner", None),
            2: ("batch", None)}.get(t.dim(), (None,) * t.dim())


def auto_microbatch(cfg, ss, mesh, rules) -> int:
    """The smallest grad-accumulation factor whose remat activation stack
    fits the HBM budget (the reference's rule and budget)."""
    sizes = logical.mesh_shape(mesh)
    dp = 1
    for a in _batch_axes(rules):
        if a in sizes:
            dp *= sizes[a]
    tp = sizes.get("model", 1)
    tok_loc = ss.global_batch * ss.seq_len / max(dp, 1)
    per_tok = cfg.d_model * 2 * cfg.n_layers               # remat stack, bf16
    per_tok += 3 * 4 * cfg.vocab / max(tp, 1)              # f32 logits + grad
    if cfg.moe_every:                                      # dispatch buffers
        per_tok += cfg.top_k * cfg.d_model * 2 * 4
    if cfg.rwkv or cfg.attn_every:                         # ssm chunk states
        per_tok *= 1.5
    budget = 5.5e9
    need = tok_loc * per_tok
    best = 1
    for n in (1, 2, 4, 8, 16, 32):
        if ss.global_batch % n == 0 and ss.global_batch // n >= dp:
            best = n
            if need / n <= budget:
                return n
    return best


def build_cell(cfg, shape_name: str, mesh, rules, device, dtype=torch.bfloat16):
    """Under an active FakeTensorMode: the model with DTensor parameters
    and the cell's step as (fn, its arguments, n_micro)."""
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import make_train_step

    ss = SHAPES[shape_name]
    train = ss.kind == "train"
    model = T.Transformer(cfg, device=device, dtype=dtype)
    axes = T.param_axes(model)
    tp = logical.mesh_shape(mesh).get("model", 1)
    fsdp = train and cfg.param_count() * 2 / tp > 4e9
    for name, p in list(model.named_parameters()):
        mod_name, _, leaf = name.rpartition(".")
        mod = model.get_submodule(mod_name) if mod_name else model
        d = _distribute(p.detach(), mesh, layout(axes[name], p.shape, mesh, rules, fsdp))
        setattr(mod, leaf, torch.nn.Parameter(d, requires_grad=train))

    def inputs(batch, ax):
        return {k: _distribute(v, mesh, layout(ax[k], v.shape, mesh, rules))
                for k, v in batch.items()}

    if train:
        params = dict(model.named_parameters())
        state = {
            name: {n: _distribute(torch.zeros(p.shape, dtype=torch.float32, device=device),
                                  mesh, layout(axes[n], p.shape, mesh, rules, True))
                   for n, p in params.items()}
            for name in ("master", "m", "v")}
        state["step"] = torch.zeros((), dtype=torch.int32, device=device)
        batch = input_specs(cfg, shape_name, device=device)
        batch = inputs(batch, batch_axes_of(batch))
        n_micro = auto_microbatch(cfg, ss, mesh, rules)
        step = make_train_step(cfg, opt.OptConfig(), n_micro)
        return (lambda: step(model, state, batch)), (params, state, batch), n_micro
    if ss.kind == "prefill":
        batch = input_specs(cfg, shape_name, device=device)
        batch = inputs(batch, batch_axes_of(batch))
        max_len = ss.seq_len + cfg.n_frontend_tokens + 128
        return ((lambda: model.prefill(batch["tokens"], max_len, batch.get("frontend_embeds"))),
                (dict(model.named_parameters()), batch), 1)
    b = ss.global_batch
    caches = [{k: _distribute(v, mesh, layout(cache_axes(v), v.shape, mesh, rules))
               for k, v in c.items()}
              for c in model.init_caches(b, ss.seq_len, dtype)]
    io = inputs(input_specs(cfg, shape_name, device=device),
                {"token": ("batch",), "cache_len": ("batch",)})
    return ((lambda: model.decode_step(io["token"], caches, io["cache_len"])),
            (dict(model.named_parameters()), io, caches), 1)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             rules_override: Optional[Dict[str, Any]] = None,
             save_dir: Optional[str] = None, verbose: bool = True,
             device: str = "cuda", reduced: bool = False) -> Dict[str, Any]:
    """One cell; `reduced` traces the family-preserving reduced config at
    the cell's shapes (a quick check of the machinery)."""
    if arch == "vu_systolic":
        return run_ea_cell(multi_pod, save_dir, verbose, device)
    from torch._subclasses.fake_tensor import FakeTensorMode

    cfg = cbase.get_reduced(arch) if reduced else cbase.get_arch(arch)
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    out: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
                           "params_b": cfg.param_count()}
    if not shape_applicable(cfg, shape_name):
        out["status"] = "skipped"
        out["reason"] = "long_500k requires sub-quadratic attention"
        _save(out, save_dir)
        return out

    chips = 512 if multi_pod else 256
    init_fake_group(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=torch.device(device).type)
    rules = logical.default_rules(multi_pod)
    if shape_name == "long_500k":
        # B=1: the data axis is idle for batch; spend it on KV sequence
        rules = rules.override(kv_seq=("data", "model"), batch=None)
    if rules_override:
        rules = rules.override(**rules_override)
    out["rules"] = {k: v for k, v in rules.table}

    t0 = time.time()
    try:
        with FakeTensorMode(), logical.activate(mesh, rules):
            fn, args, n_micro = build_cell(cfg, shape_name, mesh, rules, device)
            with commcount.counting() as cc:
                result = fn()
            trace_s = time.time() - t0
            arg_b, out_b = _local_bytes(args), _local_bytes(result)
        walk = cc.report()
        ss = SHAPES[shape_name]
        model_fl = cm.model_flops_per_step(cfg, ss)
        flops_dev, bytes_dev = walk["flops"], walk["traffic_bytes"]
        coll_dev = walk["collectives"]["total"]
        hw = cm.H100
        terms = {"compute_s": flops_dev / hw.peak_flops, "memory_s": bytes_dev / hw.hbm_bw,
                 "collective_s": coll_dev / hw.link_bw}
        out.update(
            status="ok", n_micro=n_micro, trace_s=round(trace_s, 2),
            memory={"argument_bytes": arg_b, "output_bytes": out_b,
                    "temp_bytes": walk["peak_live_bytes"], "alias_bytes": 0,
                    "peak_estimate_bytes": arg_b + walk["peak_live_bytes"]},
            memory_note=MEMORY_NOTE,
            cost={"flops_per_device": flops_dev, "bytes_per_device": bytes_dev},
            collectives=walk["collectives"],
            collective_calls=walk["collective_calls"],
            roofline=dict(terms, dominant=max(terms, key=terms.get), model_flops=model_fl,
                          hlo_flops_global=flops_dev * chips,
                          useful_ratio=(model_fl / (flops_dev * chips) if flops_dev else 0.0),
                          hardware=dict(name="H100 SXM (data sheet, 700 W)",
                                        peak_flops=hw.peak_flops, hbm_bw=hw.hbm_bw,
                                        link_bw=hw.link_bw)),
        )
    except Exception as e:  # noqa: BLE001 -- a failing cell is recorded, as the reference does
        out.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    if verbose:
        if out["status"] == "ok":
            r = out["roofline"]
            print(f"[{mesh_tag}] {arch:22s} {shape_name:12s} OK trace={out['trace_s']:.1f}s "
                  f"peak={out['memory']['peak_estimate_bytes'] / 2 ** 30:.2f}GiB "
                  f"dom={r['dominant']:12s} useful={r['useful_ratio']:.2f}", flush=True)
        else:
            print(f"[{mesh_tag}] {arch:22s} {shape_name:12s} {out['status']}: "
                  f"{out.get('reason', out.get('error'))}", flush=True)
    _save(out, save_dir)
    return out


def run_ea_cell(multi_pod: bool, save_dir: Optional[str], verbose: bool = True,
                device: str = "cuda") -> Dict[str, Any]:
    """The paper's own workload at pod scale: 256 (512) NSGA-II islands of
    the xcvu_test placement, pop 16, 2 generations, ring migration, run
    as one `islands.run` batch on `device`."""
    from repro_torch.core import islands, nsga2
    from repro_torch.fpga import device as fdev, netlist

    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    n = 512 if multi_pod else 256
    out: Dict[str, Any] = {"arch": "vu_systolic", "shape": "ea_round",
                           "mesh": mesh_tag, "params_b": 0}
    prob = netlist.make_problem(fdev.get_device("xcvu_test"))
    t0 = time.time()
    try:
        gen = torch.Generator(device=device).manual_seed(0)
        _, hist = islands.run(prob, "nsga2", nsga2.NSGA2Config(pop_size=16), gen, 2,
                              islands.IslandConfig(n, 2), device=device, shard=False)
        best = hist[-1].amin(0).tolist()
        out.update(status="ok", trace_s=round(time.time() - t0, 2), n_micro=1,
                   memory={"argument_bytes": 0, "output_bytes": 0, "temp_bytes": 0,
                           "alias_bytes": 0, "peak_estimate_bytes": 0},
                   cost={}, collectives={"total": 0.0},
                   roofline={"note": f"{n} EA islands execute as one islands.run batch on "
                             f"{device} (a fake group moves no data)", "dominant": "n/a"},
                   best_objs=[float(x) for x in best])
    except Exception as e:  # noqa: BLE001
        out.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2000:])
    if verbose:
        print(f"[{mesh_tag}] vu_systolic            ea_round     {out['status']} "
              f"({out.get('trace_s', 0)}s, {n} islands)", flush=True)
    _save(out, save_dir)
    return out


def _save(out: Dict[str, Any], save_dir: Optional[str]):
    if not save_dir:
        return
    os.makedirs(save_dir, exist_ok=True)
    path = os.path.join(save_dir, f"{out['arch']}__{out['shape']}__{out['mesh']}.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def command(arch: str, shape: str, multi_pod: bool = False, out: str = "experiments/dryrun",
            device: str = "cuda"):
    """(argv, env) that run one cell of this module in a process of its own,
    as the train and serve launchers' `--dry-run` do."""
    import sys
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
           "--out", out, "--device", device]
    if multi_pod:
        cmd.append("--multi-pod")
    path = os.environ.get("PYTHONPATH")
    return cmd, {**os.environ, "PYTHONPATH": src + (os.pathsep + path if path else "")}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--rules", default=None,
                    help="JSON logical-rule overrides, e.g. "
                         "'{\"kv_seq\": [\"data\",\"model\"]}'")
    ap.add_argument("--reduced", action="store_true",
                    help="trace the reduced configs at the cells' shapes")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the device the fake shards claim and the ea_round cell runs on")
    args = ap.parse_args(argv)
    from repro_torch import resolve_device
    resolve_device(args.device)

    overrides = None
    if args.rules:
        overrides = {k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in json.loads(args.rules).items()}
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    if args.all:
        cells = [(arch, shape) for arch in cbase.ARCHS for shape in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    n_bad = 0
    for mp in meshes:
        for arch, shape in cells:
            res = run_cell(arch, shape, mp, overrides, args.out, device=args.device,
                           reduced=args.reduced)
            n_bad += res["status"] == "error"
    if n_bad:
        raise SystemExit(f"{n_bad} dry-run cells failed")


if __name__ == "__main__":
    main()
