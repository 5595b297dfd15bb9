"""ASCII floorplan of the repeating rectangle.

Port of `repro/fpga/floorplan.py`: hard-block columns as '.', and, given a
genotype, each placed block as its type's glyph (or '#' for the blocks of
one highlighted unit), over the port's decoder.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core import genotype as G
from repro_torch.fpga.device import ROWS_PER_CR, TYPE_NAMES
from repro_torch.fpga.netlist import Problem

_GLYPH = {0: "U", 1: "D", 2: "B"}


def ascii_floorplan(problem: Problem, g: Optional[G.Genotype] = None,
                    width: int = 110, height: int = 40,
                    highlight_unit: Optional[int] = None) -> str:
    """Render columns ('.') and the blocks of one genotype (1-D leaves)."""
    xs = np.concatenate([np.asarray(problem.geom[t].col_x) for t in G.TYPES])
    xmax = xs.max() * 1.02
    ymax = 2 * ROWS_PER_CR * 1.02
    grid = np.full((height, width), " ", dtype="<U1")

    for t in G.TYPES:
        for cx in np.asarray(problem.geom[t].col_x):
            cc = min(int(cx / xmax * width), width - 1)
            grid[:, cc] = "."

    if g is not None:
        bx, by = (a[0].cpu().numpy()
                  for a in G.decode(problem, G.tree_map(lambda a: a[None], g)))
        unit = problem.blk_unit
        for i in range(problem.n_blocks):
            r = height - 1 - min(int(by[i] / ymax * height), height - 1)
            c = min(int(bx[i] / xmax * width), width - 1)
            if highlight_unit is not None and unit[i] == highlight_unit:
                grid[r, c] = "#"
            else:
                grid[r, c] = _GLYPH[int(problem.blk_type[i])]

    legend = " | ".join(f"{_GLYPH[t]}={TYPE_NAMES[t]}" for t in G.TYPES)
    body = "\n".join("".join(row) for row in grid)
    return f"{body}\n[{problem.device_name}: {legend}; .=column site]"
