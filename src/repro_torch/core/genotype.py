"""Three-tier genotype (paper Fig. 2) and its population-batched decoder.

Port of `repro/core/genotype.py`.  A population genotype is a dict of
per-type tuples (URAM, DSP, BRAM), each leaf with a leading population
axis P:

  dist  f32  [P, C_t]  chains per (sub)column, softmax share, capped,
  loc   f32  [P, N_t]  relative position of each chain in its column,
  perm  i64  [P, N_t]  logical chain role -> physical chain.

Every function takes the whole population at once where the reference
vmaps one genotype.  Ties and rounding follow the reference: argsorts are
stable, `searchsorted` takes the right side, and the segmented running max
is exact integer arithmetic.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.tables import TypeTables, problem_tensors
from repro_torch.fpga.device import BRAM, DSP, URAM
from repro_torch.fpga.netlist import Problem, TypeGeom

Genotype = Dict[str, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
TYPES = (URAM, DSP, BRAM)


def tree_map(fn, *trees):
    """Map `fn` over matching leaves of dict/tuple/list trees of tensors."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (tuple, list)):
        return type(t0)(tree_map(fn, *leaves) for leaves in zip(*trees))
    return fn(*trees)


# ---------------------------------------------------------------- utilities

def _seg_cummax(vals: torch.Tensor, segs: torch.Tensor) -> torch.Tensor:
    """Running max within segments along the last axis.

    `segs` must be non-decreasing (segments contiguous) and `vals` in
    [0, 2^32).  Shifting each segment above every earlier one turns the
    segmented scan into one plain cummax, exactly, in int64.
    """
    shift = segs.long() << 32
    return torch.cummax(vals.long() + shift, dim=-1).values - shift


def allocate_counts(genes: torch.Tensor, caps: torch.Tensor,
                    total: int) -> torch.Tensor:
    """Exact capacity-respecting proportional allocation, batched.

    genes [..., C], caps [C] -> int64 [..., C]: softmax share -> floor ->
    leftover water-filled by fractional priority.  The softmax is written
    out as the reference writes it (exp of the shifted genes over their
    sum), so the floors land on the same side.
    """
    g = genes.float()
    e = torch.exp(g - torch.amax(g, dim=-1, keepdim=True))
    desired = e / torch.sum(e, dim=-1, keepdim=True) * total
    base = torch.minimum(torch.floor(desired), caps.float()).long()
    rem = total - torch.sum(base, dim=-1, keepdim=True)
    room = caps.long() - base
    prio = torch.where(room > 0, desired - base.float(), -1.0)
    order = torch.argsort(-prio, dim=-1, stable=True)
    room_s = torch.gather(room, -1, order)
    cum_before = torch.cumsum(room_s, dim=-1) - room_s
    give_s = torch.minimum(torch.clamp(rem - cum_before, min=0), room_s)
    return base + torch.zeros_like(base).scatter(-1, order, give_s)


def _decode_type(geom: TypeGeom, tabs: TypeTables, dist: torch.Tensor,
                 loc: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode one hard-block type for a population.

    dist [P, C], loc [P, N] -> (x, y) each [P, N, L] in RPM units.
    """
    N, L, C = geom.n_chains, geom.chain_len, geom.n_cols
    p, dev = dist.shape[0], dist.device
    counts = allocate_counts(dist, tabs.caps, N)

    bounds = torch.cumsum(counts, dim=-1)              # exclusive upper bounds
    chain_idx = torch.arange(N, device=dev).expand(p, N).contiguous()
    col = torch.searchsorted(bounds, chain_idx, right=True).clamp(0, C - 1)

    # within-column order by location gene: one sort on (col, loc)
    locc = torch.clamp(loc.float(), 0.0, 1.0 - 1e-6)
    key = col.float() * 2.0 + locc
    order = torch.argsort(key, dim=-1, stable=True)
    col_s = torch.gather(col, -1, order)
    loc_s = torch.gather(locc, -1, order)
    col_start = torch.gather(bounds - counts, -1, col_s)
    rank_s = torch.arange(N, device=dev) - col_start   # rank within column

    # spread slack slots by location gene, monotone within each column
    slack_sites = torch.gather((tabs.caps - counts) * L, -1, col_s).float()
    off = torch.minimum(torch.floor(loc_s * (slack_sites + 1.0)), slack_sites)
    off = _seg_cummax(off, col_s)                      # keep packing legal
    ystart_s = rank_s * L + off
    ystart = torch.zeros_like(ystart_s).scatter(-1, order, ystart_s)

    site = ystart[..., None] + torch.arange(L, device=dev)
    phys_row = site * geom.site_step + tabs.parity[col][..., None]
    y = phys_row.float() * geom.row_pitch
    x = tabs.col_x[col][..., None].expand(p, N, L)
    return x, y


# ------------------------------------------------------------------ decode

def decode(problem: Problem, g: Genotype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Population genotype -> logical-block coordinates (x, y), each [P, G].

    Logical gid order is unit-major (netlist._ROLE_LAYOUT); the mapping
    permutation routes logical chain roles onto physical chains.
    """
    tabs = problem_tensors(problem, g["dist"][0].device)
    xs, ys = [], []
    for t in TYPES:
        x, y = _decode_type(problem.geom[t], tabs.geom[t], g["dist"][t], g["loc"][t])
        idx = g["perm"][t].long()[..., None].expand(x.shape)
        xs.append(torch.gather(x, 1, idx).flatten(1))
        ys.append(torch.gather(y, 1, idx).flatten(1))
    pos = tabs.blk_flatpos
    return torch.cat(xs, -1)[:, pos], torch.cat(ys, -1)[:, pos]


def reduced_to_full(problem: Problem, perms: Tuple[torch.Tensor, ...]
                    ) -> Genotype:
    """Lift a mapping-only population to the full encoding: distribution
    proportional to column capacity, location packed bottom-up."""
    p, dev = perms[0].shape[0], perms[0].device
    tabs = problem_tensors(problem, dev)
    return {
        "dist": tuple(torch.log(tabs.geom[t].caps.float() + 1e-3).expand(p, -1)
                      for t in TYPES),
        "loc": tuple(torch.zeros(p, problem.geom[t].n_chains, device=dev)
                     for t in TYPES),
        "perm": tuple(perms),
    }


def decode_reduced(problem: Problem, perms: Tuple[torch.Tensor, ...]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper SS IV-B2: mapping-only genotype."""
    return decode(problem, reduced_to_full(problem, perms))


# ----------------------------------------------------- encodings / sampling

def random_genotype(problem: Problem, pop_size: int,
                    gen: torch.Generator) -> Genotype:
    """`pop_size` random genotypes on `gen`'s device."""
    dev = gen.device
    dist, loc, perm = [], [], []
    for t in TYPES:
        geom = problem.geom[t]
        dist.append(torch.randn(pop_size, geom.n_cols, generator=gen, device=dev) * 0.5)
        loc.append(torch.rand(pop_size, geom.n_chains, generator=gen, device=dev))
        keys = torch.rand(pop_size, geom.n_chains, generator=gen, device=dev)
        perm.append(torch.argsort(keys, dim=-1, stable=True))
    return {"dist": tuple(dist), "loc": tuple(loc), "perm": tuple(perm)}


def flat_dim(problem: Problem) -> int:
    return problem.continuous_dim


def flat_split(problem: Problem):
    """Static slices of the flat continuous vector."""
    sizes = []
    for part in ("dist", "loc", "map"):
        for t in TYPES:
            g = problem.geom[t]
            sizes.append(g.n_cols if part == "dist" else g.n_chains)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return [(int(offs[i]), int(offs[i + 1])) for i in range(len(sizes))]


def from_flat(problem: Problem, z: torch.Tensor) -> Genotype:
    """Continuous population [P, D] -> genotype (perm via argsort keys)."""
    sl = flat_split(problem)
    return {
        "dist": tuple(z[:, a:b] for (a, b) in sl[0:3]),
        "loc": tuple(torch.sigmoid(z[:, a:b]) for (a, b) in sl[3:6]),
        "perm": tuple(torch.argsort(z[:, a:b], dim=-1, stable=True)
                      for (a, b) in sl[6:9]),
    }


def to_flat(problem: Problem, g: Genotype) -> torch.Tensor:
    """Genotype -> continuous population [P, D] (inverse up to argsort
    equivalence)."""
    parts = list(g["dist"])
    for t in TYPES:
        x = torch.clamp(g["loc"][t], 1e-4, 1 - 1e-4)
        parts.append(torch.log(x) - torch.log1p(-x))    # logit
    for t in TYPES:
        perm = g["perm"][t].long()
        p, n = perm.shape
        # keys whose argsort reproduces the permutation
        ar = torch.arange(n, dtype=torch.float32, device=perm.device).expand(p, n)
        ranks = torch.zeros(p, n, device=perm.device).scatter(1, perm, ar)
        parts.append(ranks / max(n - 1, 1) * 2.0 - 1.0)
    return torch.cat(parts, dim=-1)
