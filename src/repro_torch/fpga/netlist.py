"""Conv-unit netlist reconstruction (paper Fig. 1) + static placement problem.

Each convolution unit C_k (dual 3x3 kernels, URAM-bandwidth matched) contains

    1 URAM cascade chain  of length 2   (u0 feed, u1 collect)
    2 DSP  cascade chains of length 9   (one per 3x3 kernel, accumulators cascaded)
    2 BRAM cascade chains of length 4   (row-reuse line buffers)

for the paper's 2 URAM + 18 DSP + 8 RAMB18 per unit.  Cascade links are hard
wires (zero routing cost) -- they are *constraints*, not nets.  The routed
nets we reconstruct (weights = modelled connection counts, bits = bus widths
used by the pipelining register model):

    u0 -> bA0 / bB0     w=4  bits=72   URAM feeds both line-buffer chains
    dA8 / dB8 -> u1     w=4  bits=48   accumulator tails write back to URAM
    u0 -> dA0 / dB0     w=2  bits=9    control / address fanout
    bXj -> dX(2j)(+1)   w=2  bits=18   line buffers feed DSP pairs
    bX3 -> dX8          w=2  bits=18   last buffer also feeds the 9th DSP
    u1[k] -> u0[k+1]    w=2  bits=72   inter-unit systolic URAM chain

The exact w_ij of Samajdar et al. [27] are unpublished; these reconstructions
preserve the paper's structure and land the pipelining register model in the
paper's 256K-323K chip-wide range (EXPERIMENTS.md SSPaper-fidelity).

The static `Problem` bundles device geometry + netlist into padded numpy
arrays that the JAX genotype decoder / objective kernels close over.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.fpga.device import (BRAM, CHAIN_LEN, CHAINS_PER_UNIT, DSP,
                                     ROW_PITCH, SITE_STEP, URAM, DeviceModel,
                                     content_hash)

# roles inside one conv unit, in logical-gid order
# (u0,u1 | dA0..dA8 | dB0..dB8 | bA0..bA3 | bB0..bB3)  -> 28 blocks
BLOCKS_PER_UNIT = 28
_ROLE_LAYOUT = (
    (URAM, 0, 2),   # (type, chain_role_within_unit, chain_len)
    (DSP, 0, 9),
    (DSP, 1, 9),
    (BRAM, 0, 4),
    (BRAM, 1, 4),
)


def _unit_gid(unit: int, role_slot: int, offset: int) -> int:
    """Global logical block id for (unit, role slot in _ROLE_LAYOUT, offset)."""
    base = unit * BLOCKS_PER_UNIT
    off = 0
    for slot, (_, _, ln) in enumerate(_ROLE_LAYOUT):
        if slot == role_slot:
            return base + off + offset
        off += ln
    raise ValueError(role_slot)


def build_nets(n_units: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                      np.ndarray]:
    """Return (src_gid, dst_gid, weight, bits) arrays for an n_units design."""
    src: List[int] = []
    dst: List[int] = []
    w: List[float] = []
    bits: List[int] = []

    def add(s: int, d: int, ww: float, bb: int) -> None:
        src.append(s)
        dst.append(d)
        w.append(ww)
        bits.append(bb)

    for k in range(n_units):
        u0 = _unit_gid(k, 0, 0)
        u1 = _unit_gid(k, 0, 1)
        for chain_slot, dsp_slot in ((3, 1), (4, 2)):    # (bram slot, dsp slot)
            b0 = _unit_gid(k, chain_slot, 0)
            add(u0, b0, 4.0, 72)                          # URAM -> line buffers
            d_tail = _unit_gid(k, dsp_slot, 8)
            add(d_tail, u1, 4.0, 48)                      # accum tail -> URAM
            d0 = _unit_gid(k, dsp_slot, 0)
            add(u0, d0, 2.0, 9)                           # control / address
            for j in range(4):
                bj = _unit_gid(k, chain_slot, j)
                add(bj, _unit_gid(k, dsp_slot, 2 * j), 2.0, 18)
                add(bj, _unit_gid(k, dsp_slot, 2 * j + 1), 2.0, 18)
            add(_unit_gid(k, chain_slot, 3), _unit_gid(k, dsp_slot, 8), 2.0, 18)
        if k + 1 < n_units:                               # inter-unit systolic
            add(u1, _unit_gid(k + 1, 0, 0), 2.0, 72)

    return (np.asarray(src, np.int32), np.asarray(dst, np.int32),
            np.asarray(w, np.float32), np.asarray(bits, np.int32))


@dataclasses.dataclass(frozen=True, eq=False)
class TypeGeom:
    """Static per-type geometry, padded for fixed-shape JAX decode."""

    col_x: np.ndarray        # [C] f32 RPM x per (sub)column
    col_cap_chains: np.ndarray  # [C] i32 chain slots per (sub)column
    col_parity: np.ndarray   # [C] i32 row offset of site 0 (BRAM parity)
    chain_len: int
    site_step: int           # rows-in-site-index between chain members
    row_pitch: float         # RPM rows per site index unit
    n_chains: int            # chains the design needs (fixed)

    @property
    def n_cols(self) -> int:
        return int(self.col_x.shape[0])

    @property
    def max_chains_per_col(self) -> int:
        return int(self.col_cap_chains.max())


@dataclasses.dataclass(frozen=True, eq=False)
class Problem:
    """Static placement problem: device geometry x replicated netlist.

    Everything here is numpy (host constants closed over by jitted code);
    only genotypes are traced JAX values.
    """

    device_name: str
    n_units: int
    geom: Tuple[TypeGeom, TypeGeom, TypeGeom]   # indexed by URAM/DSP/BRAM
    # netlist over logical gids
    net_src: np.ndarray
    net_dst: np.ndarray
    net_w: np.ndarray
    net_bits: np.ndarray
    # gid -> (type, logical chain, offset) flattening tables
    blk_type: np.ndarray
    blk_chain: np.ndarray
    blk_off: np.ndarray
    blk_unit: np.ndarray
    # gid -> position in concat-per-type flattened coords (see decoder)
    blk_flatpos: np.ndarray
    n_rects: int            # full-chip replication factor (copy-paste flow)

    @property
    def n_blocks(self) -> int:
        return int(self.blk_type.shape[0])

    @property
    def n_nets(self) -> int:
        return int(self.net_src.shape[0])

    @property
    def signature(self) -> str:
        """Content hash of (geometry x netlist): the exact identity of this
        placement problem.  Equal signatures mean a genotype is directly
        reusable (identity transfer); the champion store's primary key.
        Cached on first use -- problems are frozen.
        """
        sig = self.__dict__.get("_signature")
        if sig is None:
            parts = [self.n_units, self.n_rects]
            for g in self.geom:
                parts += [g.col_x, g.col_cap_chains, g.col_parity,
                          g.chain_len, g.site_step, g.row_pitch, g.n_chains]
            parts += [self.net_src, self.net_dst, self.net_w, self.net_bits]
            sig = content_hash(*parts)
            object.__setattr__(self, "_signature", sig)
        return sig

    @property
    def sibling_key(self) -> str:
        """Content hash of the structural shape only: column counts,
        capacities, parities, chain demands and the netlist -- NOT column x
        positions or the chip replication factor.  Problems sharing a
        sibling key have the same genotype sizes and netlist, so a
        champion projects between them at high fidelity
        (`core.transfer.migrate`) -- how the champion store discovers
        warm-start donors across devices."""
        sig = self.__dict__.get("_sibling_key")
        if sig is None:
            parts = [self.n_units]
            for g in self.geom:
                parts += [g.col_x.shape[0], g.col_cap_chains, g.col_parity,
                          g.chain_len, g.site_step, g.row_pitch, g.n_chains]
            parts += [self.net_src, self.net_dst, self.net_w, self.net_bits]
            sig = content_hash(*parts)
            object.__setattr__(self, "_sibling_key", sig)
        return sig

    def genotype_sizes(self) -> Dict[str, Tuple[int, ...]]:
        g = self.geom
        return {
            "dist": tuple(g[t].n_cols for t in (URAM, DSP, BRAM)),
            "loc": tuple(g[t].n_chains for t in (URAM, DSP, BRAM)),
            "map": tuple(g[t].n_chains for t in (URAM, DSP, BRAM)),
        }

    @property
    def continuous_dim(self) -> int:
        """Dimension of the flat continuous encoding (CMA-ES / SA)."""
        s = self.genotype_sizes()
        return sum(s["dist"]) + sum(s["loc"]) + sum(s["map"])


def make_problem(dev: DeviceModel) -> Problem:
    n_units = dev.units_per_rect
    geoms = []
    for t in (URAM, DSP, BRAM):
        cs = dev.columns[t]
        geoms.append(TypeGeom(
            col_x=cs.x.astype(np.float32),
            col_cap_chains=(cs.cap_sites // CHAIN_LEN[t]).astype(np.int32),
            col_parity=cs.parity.astype(np.int32),
            chain_len=CHAIN_LEN[t],
            site_step=SITE_STEP[t],
            row_pitch=float(ROW_PITCH[t]),
            n_chains=n_units * CHAINS_PER_UNIT[t],
        ))
    src, dst, w, bits = build_nets(n_units)

    # gid flattening tables
    n_blocks = n_units * BLOCKS_PER_UNIT
    blk_type = np.empty(n_blocks, np.int32)
    blk_chain = np.empty(n_blocks, np.int32)
    blk_off = np.empty(n_blocks, np.int32)
    blk_unit = np.empty(n_blocks, np.int32)
    for k in range(n_units):
        gid = k * BLOCKS_PER_UNIT
        for (t, role, ln) in _ROLE_LAYOUT:
            chain = k * CHAINS_PER_UNIT[t] + role
            for off in range(ln):
                blk_type[gid] = t
                blk_chain[gid] = chain
                blk_off[gid] = off
                gid += 1
        blk_unit[k * BLOCKS_PER_UNIT:(k + 1) * BLOCKS_PER_UNIT] = k

    # position of each gid in the per-type concatenated [N_t * L_t] layout
    bases = {}
    acc = 0
    for t in (URAM, DSP, BRAM):
        bases[t] = acc
        acc += geoms[t].n_chains * geoms[t].chain_len
    blk_flatpos = np.array(
        [bases[int(blk_type[g])]
         + int(blk_chain[g]) * geoms[int(blk_type[g])].chain_len
         + int(blk_off[g]) for g in range(n_blocks)], np.int32)

    return Problem(
        device_name=dev.name, n_units=n_units,
        geom=(geoms[0], geoms[1], geoms[2]),
        net_src=src, net_dst=dst, net_w=w, net_bits=bits,
        blk_type=blk_type, blk_chain=blk_chain, blk_off=blk_off,
        blk_unit=blk_unit, blk_flatpos=blk_flatpos,
        n_rects=dev.n_rects,
    )
