"""Xilinx UltraScale+ device models: columnar hard-block geometry.

RapidLayout places DSP48 / RAMB18 / URAM288 *cascade chains* onto the
irregular columnar fabric of UltraScale+ parts (VU3P..VU13P).  We model each
device as:

  * a set of hard-block columns per type, each with an RPM x coordinate and a
    site capacity (sites per column inside the minimum repeating rectangle),
  * a site->RPM-row pitch per type (24 DSP / 24 RAMB18 / 16 URAM per 60-row
    clock region),
  * the SLR / repeating-rectangle replication factors used by the paper's
    copy-paste flow (Fig. 5/6).

RAMB18 columns are modelled as *two parity sub-columns* (RAMB18_0 / RAMB18_1
interleave in one physical column, paper Eq. 5: cascade step Dy=+2).  A BRAM
cascade chain therefore occupies consecutive sites of one parity, and two
chains of opposite parity can interleave in the same physical column --
exactly the freedom the real cascade network provides.

Resource totals are calibrated so that the paper's published numbers fall out
exactly for the VU11P repeating rectangle (80 conv units, 100% URAM / 93.7%
DSP / 95.2% RAMB18 utilisation -- cf. paper SS III-C) and so that design sizes
match Table II (123/246/246/369/480/640 conv units for VU3P..VU13P).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Tuple

import numpy as np

# type indices used everywhere downstream
URAM, DSP, BRAM = 0, 1, 2
TYPE_NAMES = ("URAM", "DSP", "BRAM")

# sites per 60-row clock region (UltraScale+ fabric constants)
SITES_PER_CR = {URAM: 16, DSP: 24, BRAM: 24}  # BRAM counted in RAMB18
ROWS_PER_CR = 60
# RPM row pitch per site (rows between vertically adjacent sites)
ROW_PITCH = {t: ROWS_PER_CR / SITES_PER_CR[t] for t in (URAM, DSP, BRAM)}

# cascade chain shapes of the conv unit (paper Fig. 1): dual 3x3 kernels
CHAIN_LEN = {URAM: 2, DSP: 9, BRAM: 4}
CHAINS_PER_UNIT = {URAM: 1, DSP: 2, BRAM: 2}
# cascade site step inside a chain (Eq. 5): +1 for DSP/URAM, +2 for RAMB18
SITE_STEP = {URAM: 1, DSP: 1, BRAM: 2}


def content_hash(*parts) -> str:
    """Stable short hex digest of a mixed array/scalar content tuple.

    Arrays hash by dtype + shape + raw bytes (C-contiguous), scalars by
    repr; the digest is independent of object identity and process, which
    is what makes it usable as a cross-process cache key (champion store,
    persisted JSON).  16 hex chars = 64 bits -- collision-safe for any
    realistic device/problem population.
    """
    h = hashlib.sha256()
    for p in parts:
        if isinstance(p, np.ndarray):
            a = np.ascontiguousarray(p)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True, eq=False)
class ColumnSet:
    """All columns of one hard-block type inside the repeating rectangle."""

    x: np.ndarray          # [C] RPM x coordinate of each (sub)column
    cap_sites: np.ndarray  # [C] sites per (sub)column (chain-parity space)
    parity: np.ndarray     # [C] 0/1 row offset (BRAM sub-columns only)

    @property
    def n_cols(self) -> int:
        return int(self.x.shape[0])


@dataclasses.dataclass(frozen=True, eq=False)
class DeviceModel:
    """One UltraScale+ part, reduced to what placement needs."""

    name: str
    family: str                 # transfer-learning group: "A" (VU3P..9P) | "B"
    n_slr: int
    rects_per_slr: int
    units_per_rect: int         # conv units the repeating rectangle holds
    rect_rows: int              # rectangle height in RPM rows (2 clock regions)
    columns: Dict[int, ColumnSet]

    @property
    def units_total(self) -> int:
        return self.units_per_rect * self.rects_per_slr * self.n_slr

    @property
    def n_rects(self) -> int:
        return self.rects_per_slr * self.n_slr

    @property
    def signature(self) -> str:
        """Content hash of the full geometry (column x positions included).

        Two devices share a signature iff a placement found on one is a
        placement on the other -- the exact-match key of the champion
        store.  Name-independent: a renamed spec with identical geometry
        hashes the same.  Cached on first use (the model is frozen).
        """
        sig = self.__dict__.get("_signature")
        if sig is None:
            parts = [self.n_slr, self.rects_per_slr, self.units_per_rect,
                     self.rect_rows]
            for t in (URAM, DSP, BRAM):
                c = self.columns[t]
                parts += [c.x, c.cap_sites, c.parity]
            sig = content_hash(*parts)
            object.__setattr__(self, "_signature", sig)
        return sig

    @property
    def sibling_key(self) -> str:
        """Content hash of the *structural* geometry only (column counts,
        capacities, parities, chain demands -- NOT x positions or
        replication factors).  Devices sharing a sibling key present the
        same search space shape, so a champion migrates between them at
        high fidelity (`core.transfer.migrate`) -- the Table II pairs, and
        the sibling-match key of the champion store."""
        sig = self.__dict__.get("_sibling_key")
        if sig is None:
            parts = [self.units_per_rect]
            for t in (URAM, DSP, BRAM):
                c = self.columns[t]
                parts += [c.x.shape[0], c.cap_sites, c.parity]
            sig = content_hash(*parts)
            object.__setattr__(self, "_sibling_key", sig)
        return sig

    def chain_capacity(self, t: int) -> int:
        L = CHAIN_LEN[t]
        return int(np.sum(self.columns[t].cap_sites // L))

    def chains_needed(self, t: int) -> int:
        return self.units_per_rect * CHAINS_PER_UNIT[t]

    def utilization(self) -> Dict[str, float]:
        out = {}
        for t in (URAM, DSP, BRAM):
            used = self.chains_needed(t) * CHAIN_LEN[t]
            total = int(np.sum(self.columns[t].cap_sites))
            out[TYPE_NAMES[t]] = used / total
        return out


def _column_xs(n_uram: int, n_dsp: int, n_bram: int, seed: int,
               width: float = 680.0) -> Dict[int, np.ndarray]:
    """Synthesise an irregular interleave of hard-block columns.

    Real UltraScale+ fabrics interleave DSP/BRAM/URAM columns irregularly
    between CLB columns; the irregularity is what makes naive copy-paste
    placement illegal (paper SS III-C).  We reproduce that character with a
    device-seeded, deterministic layout: column order is a jittered
    round-robin, spacings are non-uniform in [6, 16] RPM x units.
    """
    rng = np.random.default_rng(seed)
    tags: List[int] = [URAM] * n_uram + [DSP] * n_dsp + [BRAM] * n_bram
    # deterministic shuffle -> irregular interleave, but keep it spread:
    # draw a jittered "ideal position" per column and sort.
    idx = np.concatenate([
        (np.arange(n_uram) + 0.5) / n_uram + rng.uniform(-.35, .35, n_uram) / n_uram,
        (np.arange(n_dsp) + 0.5) / n_dsp + rng.uniform(-.35, .35, n_dsp) / n_dsp,
        (np.arange(n_bram) + 0.5) / n_bram + rng.uniform(-.35, .35, n_bram) / n_bram,
    ])
    order = np.argsort(idx, kind="stable")
    gaps = rng.uniform(6.0, 16.0, size=len(tags))
    xs = np.cumsum(gaps)
    xs = xs / xs[-1] * width
    out = {URAM: [], DSP: [], BRAM: []}
    for pos, col in enumerate(order):
        out[tags[col]].append(xs[pos])
    return {t: np.asarray(v, np.float64) for t, v in out.items()}


def _make_device(name: str, family: str, n_slr: int, rects_per_slr: int,
                 units_per_rect: int, n_uram_cols: int, n_dsp_cols: int,
                 n_bram_cols: int, seed: int) -> DeviceModel:
    rect_rows = 2 * ROWS_PER_CR
    sites = {t: SITES_PER_CR[t] * 2 for t in (URAM, DSP, BRAM)}  # 2 CRs high
    xs = _column_xs(n_uram_cols, n_dsp_cols, n_bram_cols, seed)
    cols: Dict[int, ColumnSet] = {}
    for t in (URAM, DSP):
        cols[t] = ColumnSet(
            x=xs[t],
            cap_sites=np.full(len(xs[t]), sites[t], np.int64),
            parity=np.zeros(len(xs[t]), np.int64),
        )
    # BRAM columns split into two parity sub-columns of half the sites each
    bx = np.repeat(xs[BRAM], 2)
    bcap = np.full(len(bx), sites[BRAM] // 2, np.int64)
    bpar = np.tile(np.array([0, 1], np.int64), len(xs[BRAM]))
    cols[BRAM] = ColumnSet(x=bx, cap_sites=bcap, parity=bpar)
    dev = DeviceModel(name=name, family=family, n_slr=n_slr,
                      rects_per_slr=rects_per_slr, units_per_rect=units_per_rect,
                      rect_rows=rect_rows, columns=cols)
    for t in (URAM, DSP, BRAM):
        need, cap = dev.chains_needed(t), dev.chain_capacity(t)
        if need > cap:
            raise ValueError(
                f"{name}: {TYPE_NAMES[t]} chain capacity {cap} < required {need}")
    return dev


# ----------------------------------------------------------------------------
# The UltraScale+ family (design sizes per paper Table II).
#
# Family "A" rect (VU3P..VU9P): 123 conv units / SLR, 1 rect per SLR.
#   URAM: 123 chains (246 sites)  ->  8 cols x 32 sites  (96.1% util)
#   DSP : 246 chains x 9 = 2214   -> 50 cols x 48 sites  (92.3% util)
#   BRAM: 246 chains x 4 =  984   -> 21 cols x 48 sites  (97.6% util)
# Family "B" rect (VU11P/VU13P): 80 conv units, 2 rects per SLR.
#   URAM: 80 chains (160 sites)   ->  5 cols x 32 sites  (100%  util)
#   DSP : 160 chains x 9 = 1440   -> 32 cols x 48 sites  (93.75% util)
#   BRAM: 160 chains x 4 =  640   -> 14 cols x 48 sites  (95.2% util)
# The family-B numbers reproduce the paper's reported rectangle utilisation
# (100% URAM / 93.7% DSP / 95.2% BRAM) exactly, and VU11P totals come out to
# the full-chip 960 URAM / 9216 DSP / 4032 RAMB18.
# ----------------------------------------------------------------------------
_SPECS = {
    "xcvu3p":  dict(family="A", n_slr=1, rects_per_slr=1, units_per_rect=123,
                    n_uram_cols=8, n_dsp_cols=50, n_bram_cols=21, seed=103),
    "xcvu5p":  dict(family="A", n_slr=2, rects_per_slr=1, units_per_rect=123,
                    n_uram_cols=8, n_dsp_cols=50, n_bram_cols=21, seed=105),
    "xcvu7p":  dict(family="A", n_slr=2, rects_per_slr=1, units_per_rect=123,
                    n_uram_cols=8, n_dsp_cols=50, n_bram_cols=21, seed=107),
    "xcvu9p":  dict(family="A", n_slr=3, rects_per_slr=1, units_per_rect=123,
                    n_uram_cols=8, n_dsp_cols=50, n_bram_cols=21, seed=109),
    "xcvu11p": dict(family="B", n_slr=3, rects_per_slr=2, units_per_rect=80,
                    n_uram_cols=5, n_dsp_cols=32, n_bram_cols=14, seed=111),
    "xcvu13p": dict(family="B", n_slr=4, rects_per_slr=2, units_per_rect=80,
                    n_uram_cols=5, n_dsp_cols=32, n_bram_cols=14, seed=113),
}

# small synthetic parts for tests / quickstart: 6 conv units.  The second
# is a geometry *sibling* of the first (same column counts and capacities,
# different seeded column layout) -- the cheap analogue of a VU3P->VU5P
# transfer pair for warm-start tests and the CI bench smoke.
_SPECS["xcvu_test"] = dict(family="T", n_slr=1, rects_per_slr=1,
                           units_per_rect=6, n_uram_cols=2, n_dsp_cols=4,
                           n_bram_cols=2, seed=7)
_SPECS["xcvu_test2"] = dict(family="T", n_slr=1, rects_per_slr=1,
                            units_per_rect=6, n_uram_cols=2, n_dsp_cols=4,
                            n_bram_cols=2, seed=8)


def get_device(name: str) -> DeviceModel:
    if name not in _SPECS:
        raise KeyError(f"unknown device {name!r}; have {sorted(_SPECS)}")
    return _make_device(name=name, **_SPECS[name])


def list_devices() -> Tuple[str, ...]:
    return tuple(sorted(_SPECS))
