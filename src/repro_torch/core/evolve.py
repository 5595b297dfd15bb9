"""Evolution loop: one population, init + n_gens generations.

Port of `repro/core/evolve.py` (`get_algo`, `state_best_objs`, `run`).  The
reference scans the generations inside one XLA program; here a Python loop
issues each generation's device operations and writes the per-generation
best into a history tensor that stays on the device, so the loop never
waits for the card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import hyper
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem

_NOT_PORTED = "is not ported yet (ROADMAP.md, queue 1 item {})"


def get_algo(name: str):
    if name == "nsga2":
        from repro_torch.core import nsga2 as m
        return m
    if name in ("ga", "cmaes", "sa"):
        raise NotImplementedError(f"algorithm {name!r} " + _NOT_PORTED.format(6))
    raise KeyError(name)


def state_best_objs(state: Dict) -> torch.Tensor:
    """Best (wl^2, bbox) of a population state, without a host sync."""
    objs = state["objs"]
    i = torch.argmin(O.combined_metric(objs)).reshape(1)
    return objs.index_select(0, i)[0]


def run(problem: Problem, algo: str, cfg, gen: torch.Generator, n_gens: int,
        islands=None, device="cuda") -> Tuple[Dict, torch.Tensor]:
    """Full optimisation on `device`, drawing from `gen` (on that device).

    Returns (state, history[n_gens, 2]), the history on the device.  Raises
    if `device` is CUDA and no card is present: the CPU runs only when asked.
    """
    if islands is not None:
        raise NotImplementedError("islands " + _NOT_PORTED.format(8))
    dev = resolve_device(device)
    if gen.device.type != dev.type:
        raise ValueError(f"generator is on {gen.device}, run on {dev}")
    m = get_algo(algo)
    cfg = hyper.tracify(cfg, dev)
    state = m.init_state(problem, gen, cfg)
    hist = torch.empty(n_gens, 2, device=dev)
    for i in range(n_gens):
        state = m.step_impl(problem, cfg, state, gen)
        hist[i] = state_best_objs(state)
    return state, hist
