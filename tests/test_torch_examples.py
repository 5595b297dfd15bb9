"""The port's examples (`repro_torch.examples`) on the CPU at small sizes.

Each example's `main([...small args..., "--torch-device", "cpu"])` runs
its own asserts and must print the reference example's key lines; without
`--torch-device cpu` each raises on a box with no card.
"""
import re

import pytest
import torch

from repro_torch.examples import (placement_async, placement_cache, placement_fleet,
                                  placement_islands, placement_service, placement_transfer,
                                  serve_lm)

CPU = ["--torch-device", "cpu"]


def _run(main, argv, capsys) -> str:
    main([*argv, *CPU])
    return capsys.readouterr().out


def test_placement_service(capsys):
    out = _run(placement_service.main, ["--jobs", "3", "--slots", "2", "--pop", "8",
                                        "--budget", "4"], capsys)
    assert out.startswith("xcvu_test: 168 hard blocks, 149 nets\n")
    assert "service: 3 jobs over 2 slots" in out and "1 step compile(s)" in out
    assert len(re.findall(r"^  job\d+: metric=", out, re.M)) == 3
    assert re.search(r"portfolio: 6 configs raced \d+ gens \(\d+ rounds\)", out)
    assert "champion placement validated legal" in out


def test_placement_transfer(monkeypatch, capsys):
    monkeypatch.setattr(placement_transfer, "GENS", 8)
    monkeypatch.setattr(placement_transfer, "POP", 8)
    out = _run(placement_transfer.main, [], capsys)
    assert "optimizing seed xcvu3p (123 units)..." in out and "seed champion: wl2=" in out
    for dst in ("xcvu5p", "xcvu7p", "xcvu9p"):
        assert re.search(rf"^{dst}: migrated seed wl2=\S+ \(random init \S+\); after 2 warm "
                         r"gens: wl2=", out, re.M), dst


def test_placement_islands(capsys):
    out = _run(placement_islands.main, ["--pop", "8", "--budget", "12", "--islands", "2",
                                        "--migrate-every", "2"], capsys)
    assert "target metric (single-pop, " in out
    assert re.search(r"^single population : +\d+ gens", out, re.M)
    assert re.search(r"^2 islands/slot    : +\d+ gens", out, re.M)
    assert "(identical to single-population: True)" in out


def test_placement_cache(capsys):
    out = _run(placement_cache.main, ["--pop", "8", "--budget", "8"], capsys)
    assert "1) cold run on xcvu_test (8 gens)..." in out
    assert "0 generations, no slot burned" in out
    assert "warm-started from the migrated xcvu_test champion:" in out
    assert re.search(r"4\) persisted 2 champions -> .*; a fresh store reloads 2", out)


def test_placement_fleet(capsys):
    out = _run(placement_fleet.main, ["--base-gens", "4", "--pop", "4", "--budget", "4"], capsys)
    assert "converging champion on xcvu_test (6 units, 4 gens)..." in out
    assert "fleet: 9 jobs across 9 pools" in out
    assert len(re.findall(r"^  \S+ +(nsga2|cmaes) +4 warm gens", out, re.M)) == 9
    assert "every pool stepped at one slot count" in out


def test_placement_async(capsys):
    out = _run(placement_async.main, ["--clients", "4", "--slots", "2", "--pop", "8",
                                      "--budget", "4", "--max-queue", "2",
                                      "--cancel-every", "3"], capsys)
    assert "4 clients -> max_queue=2, 2 slots" in out
    assert len(re.findall(r"^  client +\d+: ", out, re.M)) == 4
    assert "submit->result latency: p50=" in out
    assert re.search(r"fleet: 1 pool\(s\), sizes/step-compiles \[2\]x1", out)


def test_serve_lm(capsys):
    out = _run(serve_lm.main, ["--requests", "3", "--max-new", "4"], capsys)
    assert out.startswith("arch=yi-6b slots=4 requests=3\n")
    toks = re.findall(r"^  req(\d): prompt\[.*\] -> \[(.*)\]$", out, re.M)
    assert [i for i, _ in toks] == ["0", "1", "2"]
    assert all(len(t.split(", ")) == 4 for _, t in toks)
    assert re.search(r"^12 tokens in ", out, re.M)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("main", [
    placement_service.main, placement_transfer.main, placement_islands.main,
    placement_cache.main, placement_fleet.main, placement_async.main, serve_lm.main])
def test_examples_default_to_cuda(main):
    with pytest.raises(RuntimeError, match="CUDA"):
        main([])
