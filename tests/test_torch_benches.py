"""The port's paper-table runners (`repro_torch.benchmarks`) against the
reference's `benchmarks/`.

`common.plain_wirelength` and `common.summarize` take one numpy genotype
in both packages: wirelength and MHz within `tol`, registers exactly.
`table2_transfer._evals_to_target` is exact on seeded histories; the
paper constants and `genotype.flat_dim` equal the reference's.  Each
runner's `run` goes once on the CPU, its budget cut only through the
module constant that holds the reference's number: the reference's keys,
legal champions, non-increasing histories, evaluations as the reference
counts them.
"""
import io
import json
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from _kernel_sweeps import tol
from test_torch_genotype import _genotypes

from repro.core import genotype as RG
from repro.core import objectives as RO
from repro.core import pipelining as RPL
from repro.fpga import device as rdev
from repro.fpga import netlist as rnet
from repro_torch.benchmarks import (common, fig7_convergence, fig8_cooling,
                                    fig9_pipelining, run, table1,
                                    table2_transfer)
from repro_torch.core import convert
from repro_torch.core import genotype as TG
from repro_torch.core import objectives as TO
from repro_torch.fpga import device as tdev
from repro_torch.fpga import netlist as tnet

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from benchmarks import common as RB  # noqa: E402
from benchmarks import fig8_cooling as RF8  # noqa: E402
from benchmarks import table1 as RT1  # noqa: E402
from benchmarks import table2_transfer as RT2  # noqa: E402

DEV = "xcvu_test"


def _combined(hist) -> np.ndarray:
    h = hist.cpu().numpy() if isinstance(hist, torch.Tensor) else np.asarray(hist)
    return h[:, 0] * h[:, 1]


def _non_increasing(hist) -> bool:
    c = _combined(hist)
    return bool(np.all(c[1:] <= c[:-1]))


def _legal(problem, g) -> bool:
    return all(TO.validate_placement(problem, g).values())


# ------------------------------------------------------------ helpers

@pytest.mark.parametrize("name,seed", [("xcvu_test", 0), ("xcvu11p", 1)])
def test_summarize_matches_reference(name, seed):
    rprob = rnet.make_problem(rdev.get_device(name))
    g = jax.tree.map(lambda a: a[0], _genotypes(rprob, 1, seed, 0.5))
    objs = np.asarray(RO.evaluate(rprob, g))
    want = RB.summarize(rprob, g, objs)
    tprob, tg = common.problem(name), convert.genotype_from_numpy(g)
    got = common.summarize(tprob, tg, torch.tensor(objs))
    assert sorted(got) == sorted(want)
    np.testing.assert_allclose(got["wirelength"], want["wirelength"], **tol(np.float32))
    np.testing.assert_allclose(common.plain_wirelength(tprob, tg), RB.plain_wirelength(rprob, g),
                               **tol(np.float32))
    assert got["pipeline_regs_650"] == want["pipeline_regs_650"]
    for k in ("freq_mhz_unpipelined", "freq_mhz_pipelined", "wl2", "max_bbox"):
        np.testing.assert_allclose(got[k], want[k], **tol(np.float32), err_msg=k)


@pytest.mark.parametrize("seed", range(4))
def test_evals_to_target_matches_reference(seed):
    rng = np.random.default_rng(seed)
    hist = np.sort(rng.uniform(1.0, 3.0, size=(20, 2)), axis=0)[::-1].astype(np.float32)
    comb = hist[:, 0] * hist[:, 1]
    for target in (comb[0] * 2, comb[0], comb[7], comb[-1], comb[-1] * 0.5):
        for per_gen in (1, 32):
            got = table2_transfer._evals_to_target(hist, float(target), per_gen)
            assert got == RT2._evals_to_target(hist, float(target), per_gen)


def test_paper_constants_match_reference():
    assert table1.PAPER == RT1.PAPER
    assert fig8_cooling.PARAM_SETS == RF8.PARAM_SETS


@pytest.mark.parametrize("name", rdev.list_devices())
def test_flat_dim_matches_reference(name):
    want = RG.flat_dim(rnet.make_problem(rdev.get_device(name)))
    got = TG.flat_dim(tnet.make_problem(tdev.get_device(name)))
    assert got == want == TG.flat_split(tnet.make_problem(tdev.get_device(name)))[-1][1]


# ------------------------------------------------------------ runners

@pytest.fixture(scope="module")
def table1_rows():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(table1, "QUICK_SCALE", 0.02)
        return table1.run(dev=DEV, torch_device="cpu")


def test_table1_runner(table1_rows):
    prob = common.problem(DEV)
    assert list(table1_rows) == ["nsga2", "nsga2_reduced", "cmaes", "ga", "sa"]
    assert set(table1_rows) == set(RT1.PAPER)
    gens = {"nsga2": 6, "nsga2_reduced": 6, "cmaes": 12, "ga": 6, "sa": 160}
    pops = {"nsga2": 48, "nsga2_reduced": 48, "cmaes": 24, "ga": 48, "sa": 1}
    for name, row in table1_rows.items():
        assert row["evaluations"] == gens[name] * pops[name], name
        assert row["history"].shape == (gens[name], 2), name
        assert _non_increasing(row["history"]), name
        assert _legal(prob, row["champion"]), name
        assert row["runtime_s"] > 0
        objs = TO.evaluate(prob, row["champion"])
        np.testing.assert_allclose([row["wl2"], row["max_bbox"]], objs.numpy(), **tol(np.float32))
    out = io.StringIO()
    with redirect_stdout(out):
        table1.report(table1_rows)
    text = out.getvalue()
    assert text.startswith("method,runtime_s,evals,wirelength,max_bbox,regs@650,MHz(d0),MHz(piped)\n")
    for line in ("# CMA-ES vs SA runtime:", "# NSGA-II vs SA bbox:", "# NSGA-II regs vs GA:",
                 "# reduced-vs-full NSGA-II runtime:"):
        assert line in text


def test_table1_reduced_takes_member_zero(table1_rows):
    """The reference's choice: population member 0, lifted with
    distribution by capacity and location 0."""
    g = table1_rows["nsga2_reduced"]["champion"]
    prob = common.problem(DEV)
    for t in TG.TYPES:
        caps = np.asarray(prob.geom[t].col_cap_chains, np.float32)
        np.testing.assert_allclose(g["dist"][t].numpy(), np.log(caps + np.float32(1e-3)),
                                   **tol(np.float32))
        assert not g["loc"][t].any()


def test_table2_runner(monkeypatch):
    monkeypatch.setattr(table2_transfer, "POP", 8)
    monkeypatch.setattr(table2_transfer, "QUICK_GENS", 3)
    rows = table2_transfer.run(torch_device="cpu")
    assert list(rows) == ["xcvu5p", "xcvu7p", "xcvu9p"]
    seed_prob = common.problem("xcvu3p")
    for name, r in rows.items():
        prob = common.problem(name)
        assert _legal(seed_prob, r["g_seed"])
        assert _legal(prob, r["g_scratch"]) and _legal(prob, r["g_transfer"]), name
        for k in ("hist_scratch", "hist_transfer"):
            assert r[k].shape == (3, 2) and _non_increasing(r[k]), (name, k)
        for k in ("evals_scratch", "evals_transfer"):
            assert r[k] % 8 == 0 and 8 <= r[k] <= 24, (name, k)
        assert r["speedup"] == r["evals_scratch"] / r["evals_transfer"]
        assert r["units"] == tdev.get_device(name).units_total
    out = io.StringIO()
    with redirect_stdout(out):
        table2_transfer.report(rows)
    assert out.getvalue().splitlines()[0] == ("device,units,evals_scratch,evals_transfer,"
                                              "speedup,mhz_scratch,mhz_transfer,freq_delta_pct")
    assert len(out.getvalue().splitlines()) == 5


def test_fig7_runner(monkeypatch):
    monkeypatch.setattr(fig7_convergence, "QUICK_SCALE", 0.02)
    out = fig7_convergence.run(dev=DEV, torch_device="cpu")
    assert list(out) == ["nsga2", "nsga2_reduced", "cmaes", "ga", "sa"]
    want = {"nsga2": (5, 32), "nsga2_reduced": (5, 32), "cmaes": (10, 24), "ga": (5, 32),
            "sa": (120, 1)}
    for name, (hist, per_gen) in out.items():
        assert (len(hist), per_gen) == want[name], name
        assert np.isfinite(hist).all() and _non_increasing(hist), name
    text = io.StringIO()
    with redirect_stdout(text):
        fig7_convergence.report(out)
    lines = text.getvalue().splitlines()
    assert lines[0] == "method,generation,evaluations,wl2,bbox,combined"
    assert len(lines) == 1 + 5 + 5 + 10 + 5 + 60      # SA sub-sampled by 2


def test_fig8_runner(monkeypatch):
    monkeypatch.setattr(fig8_cooling, "QUICK_STEPS", 12)
    rows = fig8_cooling.run(dev=DEV, torch_device="cpu")
    assert [(r[0], r[1]) for r in rows] == [
        (s, i) for s, ps in RF8.PARAM_SETS.items() for i in range(len(ps))]
    for r in rows:
        assert np.isfinite(r[2:]).all()
        np.testing.assert_allclose(r[4], np.float32(r[2]) * np.float32(r[3]), rtol=1e-6)
    text = io.StringIO()
    with redirect_stdout(text):
        fig8_cooling.report(rows)
    assert text.getvalue().splitlines()[-1].startswith("# best schedule: ")


def test_fig9_runner(monkeypatch):
    monkeypatch.setattr(fig9_pipelining, "QUICK_SCALE", 0.02)
    prob, placements = fig9_pipelining.best_placements(dev=DEV, torch_device="cpu")
    assert list(placements) == ["nsga2", "cmaes", "sa", "random(manual-proxy)"]
    rprob = rnet.make_problem(rdev.get_device(DEV))
    sweeps = fig9_pipelining.sweeps(prob, placements)
    for name, g in placements.items():
        assert _legal(prob, g), name
        want = RPL.depth_sweep(rprob, convert.genotype_to_numpy(g), 4)
        for d in range(5):
            assert sweeps[name][d]["registers"] == want[d]["registers"]
            np.testing.assert_allclose(sweeps[name][d]["freq_mhz"], want[d]["freq_mhz"],
                                       **tol(np.float32))
    text = io.StringIO()
    with redirect_stdout(text):
        fig9_pipelining.report(sweeps)
    assert len(text.getvalue().splitlines()) == 1 + 4 * 5 + 1


@pytest.mark.parametrize("name,item", [("placement_service", "10b"), ("roofline", "11.5")])
def test_run_only_not_ported_raises(name, item, tmp_path, capsys):
    """placement_service still raises naming item 10b; roofline (item 11.5,
    ported) reads the dry-run directory it is given."""
    if name == "placement_service":
        with pytest.raises(NotImplementedError, match=item):
            run.main(["--only", name, "--torch-device", "cpu"])
        return
    cell = {"arch": "yi-6b", "shape": "decode_32k", "mesh": "pod16x16", "status": "ok",
            "memory": {"peak_estimate_bytes": 2 ** 30},
            "roofline": {"compute_s": 1e-3, "memory_s": 4e-3, "collective_s": 2e-3,
                         "dominant": "memory_s", "useful_ratio": 0.5,
                         "model_flops": 256 * 989e12 * 1e-3}}
    (tmp_path / "yi-6b__decode_32k__pod16x16.json").write_text(json.dumps(cell))
    run.main(["--only", name, "--torch-device", "cpu", "--dryrun-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "yi-6b,decode_32k,pod16x16,ok,1.00,0.0010,0.0040,0.0020,memory_s,0.500,0.2500" in out
    assert "#  worst roofline fraction: yi-6b x decode_32k (0.2500)" in out
    assert "roofline," in out.splitlines()[-1]
    from repro_torch.benchmarks import roofline
    with pytest.raises(NotImplementedError, match="10b"):
        roofline.cli(["--kernels"])


def test_run_summary(monkeypatch, capsys):
    monkeypatch.setattr(fig8_cooling, "QUICK_STEPS", 2)
    monkeypatch.setattr(fig8_cooling, "PARAM_SETS",
                        {k: v[:1] for k, v in fig8_cooling.PARAM_SETS.items()})
    run.main(["--only", "fig8_cooling", "--torch-device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert "# best schedule: " in "\n".join(lines)
    assert lines[-2] == "===== summary (name,us_per_call,derived) ====="
    assert lines[-1].startswith("fig8_cooling,") and lines[-1].endswith(",see section above")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("fn", [
    lambda: table1.run(dev=DEV), lambda: table2_transfer.run(),
    lambda: fig7_convergence.run(dev=DEV), lambda: fig8_cooling.run(dev=DEV),
    lambda: fig9_pipelining.best_placements(dev=DEV),
    lambda: run.main(["--only", "fig8_cooling"])])
def test_runners_default_to_cuda(fn):
    with pytest.raises(RuntimeError, match="CUDA"):
        fn()
