"""Objective evaluation for placement populations (paper Eqs. 1-2).

Port of `repro/core/objectives.py`.  `evaluate_population` decodes the
whole population and evaluates it in one batch (`evaluate` is a batch of
one); the hot reductions go through `repro_torch.kernels.ops`
(hand-written kernels on CUDA).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core import genotype as G
from repro_torch.core.tables import problem_tensors
from repro_torch.fpga.netlist import BLOCKS_PER_UNIT, Problem
from repro_torch.kernels import ops, ref


def unit_index(problem: Problem, device) -> torch.Tensor:
    """[U, B] int32 gid gather table of the fused kernel (unit-major decode
    order makes it arange reshaped)."""
    return problem_tensors(problem, device).unit_index


def objectives_from_coords(problem: Problem, bx: torch.Tensor,
                           by: torch.Tensor, fused: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(wirelength^2, max bbox), each [P], from block coordinates [P, G].

    `fused=False` gathers net endpoints and unit blocks and runs the two
    reductions; `fused=True` does all of it in one `ops.fused_eval`.
    """
    tabs = problem_tensors(problem, bx.device)
    if fused:
        res = ops.fused_eval(bx, by, tabs.net_src, tabs.net_dst, tabs.net_w,
                             tabs.unit_index)
        return res[..., 0], res[..., 1]
    s, d = tabs.net_src, tabs.net_dst
    wl2 = ops.wirelength2(bx.index_select(-1, s), by.index_select(-1, s),
                          bx.index_select(-1, d), by.index_select(-1, d),
                          tabs.net_w)
    shape = (*bx.shape[:-1], problem.n_units, BLOCKS_PER_UNIT)
    bb = ops.maxbbox(bx.reshape(shape), by.reshape(shape))
    return wl2, bb


def evaluate(problem: Problem, g: G.Genotype, fused: bool = False) -> torch.Tensor:
    """One genotype (leaves without the population axis) -> objectives [2],
    as a batch of one: one kernel launch fused, two unfused."""
    return evaluate_population(problem, G.tree_map(lambda a: a[None], g), fused)[0]


def evaluate_population(problem: Problem, pop: G.Genotype,
                        fused: bool = False) -> torch.Tensor:
    """Population genotype -> objectives [P, 2] = (wl^2, max bbox)."""
    bx, by = G.decode(problem, pop)
    return torch.stack(objectives_from_coords(problem, bx, by, fused), dim=-1)


def evaluate_flat_population(problem: Problem, z: torch.Tensor,
                             fused: bool = False) -> torch.Tensor:
    """Continuous-encoded population [P, D] -> [P, 2]."""
    return evaluate_population(problem, G.from_flat(problem, z), fused)


def scalarize(objs: torch.Tensor) -> torch.Tensor:
    """Log of the combined metric: scale-balanced single-objective fitness."""
    return torch.log(objs[..., 0] + 1e-9) + torch.log(objs[..., 1] + 1e-9)


def combined_metric(objs: torch.Tensor) -> torch.Tensor:
    """wirelength^2 x max bbox, as plotted in paper Fig. 7a."""
    return objs[..., 0] * objs[..., 1]


def net_lengths(problem: Problem, g: G.Genotype) -> torch.Tensor:
    """Per-net Manhattan lengths [P, N] (post-placement pipelining input)."""
    bx, by = G.decode(problem, g)
    tabs = problem_tensors(problem, bx.device)
    s, d = tabs.net_src, tabs.net_dst
    return ref.net_lengths_ref(bx.index_select(-1, s), by.index_select(-1, s),
                               bx.index_select(-1, d), by.index_select(-1, d))


# ------------------------------------------------------------- validation

def _cpu(a) -> torch.Tensor:
    return torch.as_tensor(a).detach().cpu()


def validate_placement(problem: Problem, g) -> Dict[str, bool]:
    """Independent numpy re-check of every constraint of ONE genotype
    (leaves without the population axis; tensors or numpy arrays).

    Returns named boolean checks; all must be True for a legal placement.
    Re-derives occupancy from the decoded coordinates, not from the
    decoder's internals.
    """
    out: Dict[str, bool] = {}
    tabs = problem_tensors(problem, "cpu")
    for t in G.TYPES:
        geom = problem.geom[t]
        x, y = G._decode_type(geom, tabs.geom[t], _cpu(g["dist"][t])[None],
                              _cpu(g["loc"][t])[None])
        x, y = x[0].numpy(), y[0].numpy()
        # every block must sit on a column of its type; BRAM parity
        # sub-columns share x, so disambiguate via the row parity
        col_x = np.asarray(geom.col_x)
        col_par = np.asarray(geom.col_parity)
        row = np.round(y / geom.row_pitch).astype(np.int64)
        blk_par = row[:, 0] % geom.site_step
        dist = np.abs(x[:, 0, None] - col_x[None, :])
        dist += 1e9 * (col_par[None, :] != blk_par[:, None])
        col_of = np.argmin(dist, axis=-1)
        out[f"on_column_{t}"] = bool(
            np.allclose(x[:, 0], col_x[col_of], atol=1e-4))
        # cascade adjacency (Eq. 5): successive members step by
        # site_step * row_pitch in RPM rows, same column
        dy = np.diff(y, axis=1)
        step = geom.site_step * geom.row_pitch
        out[f"cascade_{t}"] = bool(np.allclose(dy, step, atol=1e-4))
        out[f"same_col_{t}"] = bool(np.all(np.diff(x, axis=1) == 0.0))
        # exclusivity (Eq. 4): no two chains overlap a site
        parity = col_par[col_of]
        site = (row - parity[:, None]) // geom.site_step
        occ = set()
        ok = True
        for c in range(x.shape[0]):
            for s in site[c]:
                key = (int(col_of[c]), int(s))
                if key in occ:
                    ok = False
                occ.add(key)
        out[f"exclusive_{t}"] = ok
        # region (Eq. 3)
        cap = np.asarray(geom.col_cap_chains)[col_of]
        out[f"region_{t}"] = bool(
            np.all(site >= 0)
            and np.all(site < (cap * geom.chain_len)[:, None]))
        # mapping is a permutation
        perm = _cpu(g["perm"][t]).numpy()
        out[f"perm_{t}"] = bool(
            np.array_equal(np.sort(perm), np.arange(geom.n_chains)))
    return out


def assert_valid(problem: Problem, g) -> None:
    checks = validate_placement(problem, g)
    bad = [k for k, v in checks.items() if not v]
    if bad:
        raise AssertionError(f"illegal placement: {bad}")
