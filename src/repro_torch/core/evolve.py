"""Evolution loop: one population or one point, init + n_gens generations.

Port of `repro/core/evolve.py` (`get_algo`, `state_best_objs`, `run`) for
NSGA-II, the GA, sep-CMA-ES and simulated annealing.  The reference scans
the generations inside one XLA program; here a Python loop issues each
generation's device operations and writes the per-generation best into a
history tensor that stays on the device, so the loop never waits for the
card.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.core import hyper
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem


def get_algo(name: str):
    if name == "nsga2":
        from repro_torch.core import nsga2 as m
    elif name == "cmaes":
        from repro_torch.core import cmaes as m
    elif name == "sa":
        from repro_torch.core import annealing as m
    elif name == "ga":
        from repro_torch.core import ga as m
    else:
        raise KeyError(name)
    return m


def state_best_objs(state: Dict) -> torch.Tensor:
    """Best (wl^2, bbox) of a population or point state, without a host sync."""
    if "objs" in state and state["objs"].dim() == 2:
        objs = state["objs"]
        i = torch.argmin(O.combined_metric(objs)).reshape(1)
        return objs.index_select(0, i)[0]
    if "best_objs" in state:
        return state["best_objs"]
    return state["objs"]


def run(problem: Problem, algo: str, cfg, gen: torch.Generator, n_gens: int,
        islands=None, device="cuda") -> Tuple[Dict, torch.Tensor]:
    """Full optimisation on `device`, drawing from `gen` (on that device).

    Returns (state, history[n_gens, 2]), the history on the device.  Raises
    if `device` is CUDA and no card is present: the CPU runs only when asked.
    """
    if islands is not None:
        raise NotImplementedError("islands are not ported yet (ROADMAP.md, queue 1 item 8)")
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
