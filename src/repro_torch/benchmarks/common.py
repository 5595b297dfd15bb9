"""Shared helpers for the paper-table benchmarks.

Port of `benchmarks/common.py`.  Every runner takes a `torch_device`
("cuda" unless the caller asks for "cpu"; no fallback) and draws from
explicit `torch.Generator`s on it, seeded from the run's seed.  `fold`
derives a sub-stream's seed where the reference folds an index into its
key.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.core.tables import problem_tensors
from repro_torch.fpga import device, netlist


def problem(dev_name: str = "xcvu11p"):
    return netlist.make_problem(device.get_device(dev_name))


def fold(seed: int, *path: int) -> int:
    """A 63-bit seed derived from (seed, *path)."""
    return int(np.random.SeedSequence([seed, *path]).generate_state(1, np.uint64)[0] >> 1)


def generator(torch_device, seed: int, *path: int) -> torch.Generator:
    """A generator on `torch_device` (raises for CUDA without a card),
    seeded from `seed`, or from `fold(seed, *path)` given a path."""
    dev = resolve_device(torch_device)
    return torch.Generator(device=dev).manual_seed(fold(seed, *path) if path else seed)


def plain_wirelength(prob, g) -> float:
    """Paper Table I 'Wirelength' = sum of weighted Manhattan lengths,
    decoded on the genotype's device, read once."""
    lens = O.net_lengths(prob, G.tree_map(lambda a: a[None], g))[0]
    return float((lens * problem_tensors(prob, lens.device).net_w).sum())


def _sync(out) -> None:
    leaves = torch.utils._pytree.tree_leaves(out)
    for dev in {t.device for t in leaves if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(dev)


def timed(fn, *args, **kw) -> Tuple[float, object]:
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    _sync(out)
    return time.perf_counter() - t0, out


def summarize(prob, g, objs) -> Dict[str, float]:
    from repro_torch.core import pipelining
    rep = pipelining.auto_pipeline(prob, g, target_mhz=650.0)
    return {
        "wirelength": plain_wirelength(prob, g),
        "wl2": float(objs[0]),
        "max_bbox": float(objs[1]),
        "pipeline_regs_650": rep.total_registers,
        "freq_mhz_unpipelined": pipelining.frequency_at_depth(prob, g, 0),
        "freq_mhz_pipelined": rep.freq_mhz,
    }


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    return f"{name},{us_per_call:.1f},{derived}"


def parse_args(argv=None) -> argparse.Namespace:
    """A runner's command line: the reference's `--full`, and the device."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--torch-device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)
