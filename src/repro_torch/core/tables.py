"""A problem's static tables as device tensors, uploaded once per device.

The reference closes over the numpy tables of a `Problem` inside jitted
code, so XLA embeds them as constants.  The port uploads them on first use
for a (problem, device) pair and keeps them for the problem's lifetime.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Tuple

import torch

from repro_torch.fpga.netlist import BLOCKS_PER_UNIT, Problem


@dataclasses.dataclass(frozen=True)
class TypeTables:
    col_x: torch.Tensor        # [C] f32 RPM x per (sub)column
    caps: torch.Tensor         # [C] int64 chain slots per (sub)column
    parity: torch.Tensor       # [C] int64 row offset of site 0


@dataclasses.dataclass(frozen=True)
class ProblemTensors:
    geom: Tuple[TypeTables, TypeTables, TypeTables]
    blk_flatpos: torch.Tensor  # [G] int64
    net_src: torch.Tensor      # [N] int32
    net_dst: torch.Tensor      # [N] int32
    net_w: torch.Tensor        # [N] f32
    unit_index: torch.Tensor   # [U, B] int32 gid gather table


_CACHE: "weakref.WeakKeyDictionary[Problem, Dict[torch.device, ProblemTensors]]" = \
    weakref.WeakKeyDictionary()


def problem_tensors(problem: Problem, device) -> ProblemTensors:
    device = torch.device(device)
    per_problem = _CACHE.setdefault(problem, {})
    tabs = per_problem.get(device)
    if tabs is None:
        def up(a, dtype):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        geom = tuple(TypeTables(col_x=up(g.col_x, torch.float32),
                                caps=up(g.col_cap_chains, torch.int64),
                                parity=up(g.col_parity, torch.int64))
                     for g in problem.geom)
        n_blocks = problem.n_units * BLOCKS_PER_UNIT
        tabs = ProblemTensors(
            geom=geom,
            blk_flatpos=up(problem.blk_flatpos, torch.int64),
            net_src=up(problem.net_src, torch.int32),
            net_dst=up(problem.net_dst, torch.int32),
            net_w=up(problem.net_w, torch.float32),
            unit_index=torch.arange(n_blocks, dtype=torch.int32, device=device
                                    ).reshape(problem.n_units, BLOCKS_PER_UNIT))
        per_problem[device] = tabs
    return tabs
