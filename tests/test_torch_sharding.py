"""The port's sharding layer against the reference, in pure Python and numpy.

No process group: `spec_for` takes any mesh whose `shape` maps dim names to
sizes, so the 256- and 512-chip meshes are plain objects here.  Held
against `src/repro/`:
- `logical.spec_for` over the reference's own logical signatures (every
  reduced arch's `param_axes`, the activation sites), their shapes, the
  default rules (one pod and two), overrides and every `autoshard`
  genotype's rules, on meshes up to 2 x 16 x 16: equal;
- `costmodel.estimate` for all 10 archs x 4 shapes x several rule dicts on
  both production meshes, with the reference's hardware constants passed
  in: every field within 1e-12 relative;
- `autoshard.search` (pop 8, 3 generations, seed 0, hbm_limit 16e9): the
  reference's best rules, Pareto rule set and evaluation count;
- `transformer.param_axes` of every reduced arch by the port's parameter
  names (`core/convert.py`'s mapping: block l is pattern position l %
  period of the reference's stacked tree): equal leaf for leaf;
- `input_specs` shapes and dtypes, and `ring_perm`.
"""
import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import base as rbase
from repro.core import autoshard as RA
from repro.models import transformer as RT
from repro.runtime import jaxcompat
from repro.sharding import costmodel as RC
from repro.sharding import logical as RL
from repro_torch.configs import base as tbase
from repro_torch.core import autoshard as TA
from repro_torch.models import transformer as TT
from repro_torch.runtime import collectives
from repro_torch.sharding import costmodel as TC
from repro_torch.sharding import logical as TL

MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"model": 8}, {"data": 1, "model": 1})
REF_HW = TC.Hardware(RC.PEAK_FLOPS, RC.HBM_BW, RC.ICI_BW)
GENOTYPES = list(itertools.product(*(range(len(o)) for _, o in RA.SITES)))
ACTIVATIONS = (("batch", "seq", "embed"), ("batch", "seq", "q_flat"), ("batch", "seq", "kv_flat"),
               ("batch", "heads", "seq", "head"), ("batch", "kv_heads", "kv_seq", "head"),
               ("batch", "seq", "vocab"), ("batch", "seq", "ssm_inner"), ("batch", None),
               ("batch",), ("batch", None, "kv_seq", None), ("batch", "ssm_inner", None))
ACT_SHAPES = {3: ((256, 4096, 4096), (32, 32768, 7168), (1, 524288, 2048), (6, 10, 14)),
              4: ((128, 32, 32768, 128), (128, 8, 32768, 128), (1, 2, 524288, 64), (3, 5, 7, 9)),
              2: ((128, 1), (256, 4096)), 1: ((128,), (1,), (24,))}


def _mesh(shape):
    return types.SimpleNamespace(shape=dict(shape))


def _rule_sets():
    out = [("default", RL.default_rules(False), TL.default_rules(False)),
           ("multi_pod", RL.default_rules(True), TL.default_rules(True)),
           ("long_500k", RL.default_rules(False).override(kv_seq=("data", "model"), batch=None),
            TL.default_rules(False).override(kv_seq=("data", "model"), batch=None)),
           ("fsdp", RL.default_rules(True).override(embed=("pod", "data")),
            TL.default_rules(True).override(embed=("pod", "data")))]
    for g in GENOTYPES:
        for mp in (False, True):
            out.append((f"geno{g}{'_mp' if mp else ''}",
                        RA.rules_to_logical(RA.genotype_to_rules(g), mp),
                        TA.rules_to_logical(TA.genotype_to_rules(g), mp)))
    return out


def _signatures():
    """(axes, shape) pairs: every reduced and full arch's parameters, and
    the activation sites at production and odd shapes."""
    sigs = set()
    for name in tbase.ARCHS:
        for cfg in (rbase.get_reduced(name), rbase.get_arch(name)):
            specs = RT.model_specs(cfg)
            for leaf in [specs["embed"], specs["ln_f"], specs["head"]]:
                sigs.add((leaf.axes, leaf.shape))
            for pos in range(cfg.period):
                stack = [specs["blocks"][pos]]
                while stack:
                    node = stack.pop()
                    for v in node.values():
                        if isinstance(v, dict):
                            stack.append(v)
                        else:
                            sigs.add((v.axes, v.shape))
    for axes in ACTIVATIONS:
        for shape in ACT_SHAPES[len(axes)]:
            sigs.add((axes, shape))
    return sorted(sigs, key=repr)


SIGNATURES = _signatures()


@pytest.mark.parametrize("rules_idx", range(0, len(_rule_sets()), 9))
def test_spec_for_matches_reference(rules_idx):
    """Every 9th rule set (default, multi-pod, long_500k, an FSDP override
    and a spread of autoshard genotypes) x every signature x every mesh."""
    _, r_rules, t_rules = _rule_sets()[rules_idx]
    for shape in MESHES:
        mesh = _mesh(shape)
        for axes, dims in SIGNATURES:
            want = tuple(RL.spec_for(axes, dims, mesh, r_rules))
            assert TL.spec_for(axes, dims, mesh, t_rules) == want, (axes, dims, shape)


def test_spec_for_every_genotype_on_the_production_meshes():
    for _, r_rules, t_rules in _rule_sets():
        for shape in MESHES[:2]:
            mesh = _mesh(shape)
            for axes, dims in SIGNATURES[::7]:
                assert TL.spec_for(axes, dims, mesh, t_rules) == \
                    tuple(RL.spec_for(axes, dims, mesh, r_rules))


def test_spec_for_without_context_replicates():
    assert TL.spec_for(("batch", "embed"), (4, 8)) == (None, None)
    assert TL.current() is None and TL.current_mesh() is None


def test_placements_shard_in_mesh_order():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TL.placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert TL.placements((None, None), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="mesh order"):
        TL.placements((("data", "pod"),), mesh)


def test_rules_override_and_dict():
    r, t = RL.default_rules(True), TL.default_rules(True)
    assert t.table == r.table
    assert t.override(kv_seq=None, batch="data").as_dict() == \
        r.override(kv_seq=None, batch="data").as_dict()


ESTIMATE_RULES = ({}, {"batch": ("pod", "data"), "model_dim": "model", "kv_seq": "model"},
                  {"batch": ("data",), "model_dim": None, "kv_seq": ("data", "model"),
                   "fsdp": ("pod", "data")},
                  {"batch": ("pod", "data", "model"), "model_dim": ("data", "model"),
                   "kv_seq": None, "fsdp": ("data",)})


@pytest.mark.parametrize("arch", tbase.ARCHS)
def test_costmodel_matches_reference(arch):
    rcfg, tcfg = rbase.get_arch(arch), tbase.get_arch(arch)
    assert tcfg.param_count() == rcfg.param_count()
    for shape, rules, pods in itertools.product(tbase.SHAPES, ESTIMATE_RULES, (1, 2)):
        want = RC.estimate(rcfg, shape, RC.MeshShape(pods, 16, 16), rules)
        got = TC.estimate(tcfg, shape, TC.MeshShape(pods, 16, 16), rules, REF_HW)
        for f in ("compute_s", "memory_s", "collective_s", "bytes_per_device", "model_flops"):
            a, b = getattr(got, f), getattr(want, f)
            assert a == pytest.approx(b, rel=1e-12, abs=0), (shape, rules, f)
        assert got.dominant == want.dominant


def test_costmodel_h100_default():
    cfg = tbase.get_arch("yi-6b")
    r = TC.estimate(cfg, "train_4k", TC.MeshShape(1, 16, 16))
    assert r.compute_s == pytest.approx(r.model_flops / (256 * 989e12), rel=1e-15)
    assert TC.H100 == TC.Hardware(989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch,shape,pods", [("deepseek-moe-16b", "train_4k", 1),
                                             ("yi-6b", "decode_32k", 2)])
def test_autoshard_search_matches_reference(arch, shape, pods):
    want = RA.search(rbase.get_arch(arch), shape, RC.MeshShape(pods, 16, 16),
                     pop_size=8, n_gens=3, seed=0, hbm_limit=16e9)
    got = TA.search(tbase.get_arch(arch), shape, TC.MeshShape(pods, 16, 16),
                    pop_size=8, n_gens=3, seed=0, hbm_limit=16e9, hw=REF_HW, device="cpu")
    assert got.best_rules == want.best_rules
    assert got.evaluations == want.evaluations
    assert [r for r, _ in got.pareto] == [r for r, _ in want.pareto]
    assert got.best_report.step_s == pytest.approx(want.best_report.step_s, rel=1e-12)


def test_autoshard_genotype_maps():
    for g in GENOTYPES:
        assert TA.genotype_to_rules(g) == RA.genotype_to_rules(g)
    assert TA.SITES == RA.SITES


def _ref_axes(tree, name):
    node = tree
    for part in name.split("."):
        node = node[part]
    return node


@pytest.mark.parametrize("arch", tbase.ARCHS)
def test_param_axes_match_reference(arch):
    cfg = tbase.get_reduced(arch)
    got = TT.param_axes(TT.Transformer(cfg, device="cpu"))
    ref = RT.param_axes(rbase.get_reduced(arch))
    names = []
    for name, axes in got.items():
        if name.startswith("blocks."):
            _, layer, rest = name.split(".", 2)
            want = _ref_axes(ref["blocks"][int(layer) % cfg.period], rest)
            assert want[0] is None
            want = want[1:]
        else:
            want = ref[name]
        assert tuple(axes) == tuple(want), name
        names.append(name)
    assert len(names) == len(dict(TT.Transformer(cfg, device="cpu").named_parameters()))


@pytest.mark.parametrize("shape", sorted(tbase.SHAPES))
def test_input_specs_match_reference(shape):
    for arch in tbase.ARCHS:
        want = rbase.input_specs(rbase.get_arch(arch), shape)
        got = tbase.input_specs(tbase.get_arch(arch), shape)
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == tuple(v.shape), (arch, k)
            assert str(got[k].dtype).split(".")[-1] == str(jnp.dtype(v.dtype)), (arch, k)
            assert got[k].device.type == "meta"
        assert tbase.shape_applicable(tbase.get_arch(arch), shape) == \
            rbase.shape_applicable(rbase.get_arch(arch), shape)
    assert tbase.list_archs() == rbase.list_archs()


def test_ring_perm_matches_reference():
    for n in (1, 2, 3, 8, 256):
        assert collectives.ring_perm(n) == jaxcompat.ring_perm(n)


def test_frontend_spec():
    from repro.models import stubs as rs
    from repro_torch.models import stubs as ts
    assert ts.frontend_spec(None, 2, 3, 4) is None
    t, r = ts.frontend_spec("vision", 2, 576, 64), rs.frontend_spec("vision", 2, 576, 64)
    assert tuple(t.shape) == r.shape and t.dtype == torch.bfloat16 and t.device.type == "meta"


def test_ranks_by_expert_matches_reference():
    """The arrival rank of each (token, k) pair within its expert decides
    which pairs `_apply_ep` drops past capacity."""
    from repro.models import moe as rmoe
    from repro_torch.models import moe as tmoe
    rng = np.random.default_rng(0)
    for n, e in ((1, 1), (48, 8), (600, 64)):
        flat = rng.integers(0, e, n).astype(np.int32)
        want = np.asarray(rmoe._ranks_by_expert(jnp.asarray(flat), e))
        got = tmoe.ranks_by_expert(torch.tensor(flat, dtype=torch.int64), e)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("q_layout,hkv,offered", [
    ((Replicate(), Shard(1)), 4, True),          # heads over "model" (4), 4 kv heads
    ((Shard(1), Shard(1)), 4, False),            # over both dims: 8 shards, 4 kv heads
    ((Shard(1), Shard(1)), 8, True),
    ((Shard(0), Replicate()), 4, False),         # heads not split: batch or replicate
], ids=["model", "both-uneven", "both-even", "batch"])
def test_flash_offers_heads_only_where_kv_heads_divide(q_layout, hkv, offered):
    from repro_torch.kernels import ops
    mesh = types.SimpleNamespace(size=lambda i: (2, 4)[i])
    q = types.SimpleNamespace(mesh=mesh, placements=q_layout, shape=(2, 8, 16, 64))
    k = types.SimpleNamespace(mesh=mesh, placements=q_layout, shape=(2, hkv, 16, 64))
    got = ops._flash_sharding(q, k, k, True, None, None)
    assert ([Shard(1)], [Shard(1)] * 3 + [None] * 3) in got if offered else len(got) == 2
