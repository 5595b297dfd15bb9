"""Champion store: per-problem-signature cache of best known placements.

The paper's transfer result (SS IV-D, Table II: 11-14x faster placement by
reusing a sibling device's champion) becomes a *serving* asset here: every
harvested job writes its champion back under the problem's content
signature (`fpga.netlist.Problem.signature`), and every new job consults
the store before burning a slot --

  * **exact hit**   -- an entry with the same signature whose metric
    already meets the job's `target` is the answer; the scheduler serves
    it in O(ms) with zero generations,
  * **warm hit**    -- otherwise the best exact-or-sibling entry
    (`Problem.sibling_key`) is projected onto the job's problem by
    `core.transfer.auto_migrate` (identity for exact, `migrate` for
    siblings) and injected as the job's `init_state`,
  * **write-back**  -- `put()` replaces an entry only when the new metric
    strictly improves it, so the store is monotone: serving traffic can
    only sharpen the cache.

Entries carry metric + objectives + provenance (device, algo, seed, gens)
and the store round-trips through JSON (`save`/`load`), so a fleet can
persist its accumulated champions across processes.  The store is pure
host-side numpy: no device program ever depends on it, which is what keeps
cache-disabled behaviour bitwise identical to a store-less scheduler.

Port of `repro/serve/champion_store.py`, with its JSON schema: a store
file written by either package loads in the other.  Genotypes are kept as
numpy in the reference's dtypes (int32 permutations) whatever they arrive
as -- numpy, or tensors on any device -- and `seed_for` hands the port's
`transfer.auto_migrate` CPU tensors and returns numpy again.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import convert, transfer
from repro_torch.fpga.netlist import Problem
from repro_torch.serve import api

# genotype leaf dtypes, by tier (JSON carries nested lists; dtypes restore
# the exact arrays `PlacementService.submit(init_state=...)` expects)
_TIER_DTYPE = {"dist": np.float32, "loc": np.float32, "perm": np.int32}


@dataclasses.dataclass
class ChampionEntry:
    """Best known placement for one problem signature."""

    signature: str
    sibling_key: str
    device_name: str
    metric: float                       # combined metric (lower is better)
    best_objs: np.ndarray               # [2] = (wl^2, max bbox)
    genotype: Dict[str, Tuple[np.ndarray, ...]]
    provenance: Dict[str, Any]          # algo/seed/gens/... of the producer
    updated_unix: float = 0.0

    def to_json(self) -> Dict[str, Any]:
        return {
            "signature": self.signature,
            "sibling_key": self.sibling_key,
            "device_name": self.device_name,
            "metric": self.metric,
            "best_objs": np.asarray(self.best_objs).tolist(),
            "genotype": {tier: [np.asarray(a).tolist() for a in leaves]
                         for tier, leaves in self.genotype.items()},
            "provenance": self.provenance,
            "updated_unix": self.updated_unix,
        }

    @classmethod
    def from_json(cls, d: Dict[str, Any]) -> "ChampionEntry":
        return cls(
            signature=d["signature"],
            sibling_key=d["sibling_key"],
            device_name=d["device_name"],
            metric=float(d["metric"]),
            best_objs=np.asarray(d["best_objs"], np.float32),
            genotype={tier: tuple(np.asarray(a, _TIER_DTYPE[tier])
                                  for a in leaves)
                      for tier, leaves in d["genotype"].items()},
            provenance=dict(d["provenance"]),
            updated_unix=float(d.get("updated_unix", 0.0)),
        )


def _as_host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _as_host_genotype(g) -> Dict[str, Tuple[np.ndarray, ...]]:
    """A genotype of numpy arrays or tensors (any device) as numpy in the
    store's dtypes."""
    return {tier: tuple(_as_host(a, _TIER_DTYPE[tier]) for a in leaves)
            for tier, leaves in g.items()}


@dataclasses.dataclass
class PoolPrediction:
    """One row of the store's signature-traffic distribution: enough to
    rebuild the pool a future job with this signature will route to
    (`serve.prewarm` compiles it before that job arrives)."""

    signature: str
    device_name: str
    algo: str
    pop_size: Optional[int]
    count: int                          # submissions seen for the signature


class ChampionStore:
    """In-process (JSON-persistable) map: problem signature -> champion."""

    def __init__(self, path: Optional[str] = None):
        self._by_sig: Dict[str, ChampionEntry] = {}
        # signature -> {count, device_name, algo, pop_size}: the traffic
        # distribution `predicted_keys` mines for AOT pool prewarming;
        # persisted with the snapshot so predictions survive a restart
        self._traffic: Dict[str, Dict[str, Any]] = {}
        self.path = path
        self.hits_exact = 0
        self.hits_sibling = 0
        self.misses = 0
        self.puts = 0
        self.improvements = 0
        if path is not None:
            try:
                self.load(path)
            except FileNotFoundError:
                pass
            except json.JSONDecodeError as e:
                # a torn/corrupt snapshot must not brick startup: start
                # empty and leave the file for inspection (the next
                # save() rewrites it atomically)
                warnings.warn(f"champion store {path!r} is unreadable "
                              f"({e}); starting empty", stacklevel=2)

    def __len__(self) -> int:
        return len(self._by_sig)

    # ---------------------------------------------------------- write side

    def put(self, problem: Problem, genotype, metric: float, best_objs,
            provenance: Optional[Dict[str, Any]] = None) -> bool:
        """Record a harvested champion; keeps an entry only if it improves.

        Returns True when the entry was created or replaced (strictly
        better metric), False when the existing champion already beats it.
        """
        self.puts += 1
        metric = float(metric)
        cur = self._by_sig.get(problem.signature)
        if cur is not None and cur.metric <= metric:
            return False
        self._by_sig[problem.signature] = ChampionEntry(
            signature=problem.signature,
            sibling_key=problem.sibling_key,
            device_name=problem.device_name,
            metric=metric,
            best_objs=_as_host(best_objs, np.float32).copy(),
            genotype=_as_host_genotype(genotype),
            provenance=dict(provenance or {}),
            updated_unix=time.time(),
        )
        self.improvements += 1
        return True

    # -------------------------------------------------------- traffic side

    def note_traffic(self, problem: Problem, algo: str = "nsga2",
                     pop_size: Optional[int] = None) -> None:
        """Record one submission against the problem's signature (the
        scheduler calls this on every `submit`); feeds `predicted_keys`."""
        row = self._traffic.setdefault(problem.signature, {
            "count": 0, "device_name": problem.device_name,
            "algo": algo, "pop_size": pop_size})
        row["count"] += 1
        # latest spelling wins: traffic can migrate to a new algo/pop
        row["device_name"] = problem.device_name
        row["algo"] = algo
        if pop_size is not None:
            row["pop_size"] = pop_size

    def predicted_keys(self, top_k: Optional[int] = None
                       ) -> List[PoolPrediction]:
        """The signature-traffic distribution, hottest first: the pool
        specs a prewarmer should compile ahead of the next job wave."""
        rows = sorted(self._traffic.items(),
                      key=lambda kv: (-kv[1]["count"], kv[0]))
        if top_k is not None:
            rows = rows[:top_k]
        return [PoolPrediction(signature=sig,
                               device_name=row["device_name"],
                               algo=row["algo"],
                               pop_size=row.get("pop_size"),
                               count=row["count"])
                for sig, row in rows]

    # ----------------------------------------------------------- read side

    def get(self, signature: str) -> Optional[ChampionEntry]:
        return self._by_sig.get(signature)

    def lookup(self, problem: Problem) -> Tuple[Optional[ChampionEntry], str]:
        """Best entry for a problem: ("exact" | "sibling" | "miss").

        Exact = same signature.  Sibling = best (lowest-metric) entry
        sharing the problem's `sibling_key`; its metric was measured on
        *its own* problem, so sibling metrics rank donors but never decide
        an instant serve.
        """
        entry = self._by_sig.get(problem.signature)
        if entry is not None:
            self.hits_exact += 1
            return entry, "exact"
        sibs = [e for e in self._by_sig.values()
                if e.sibling_key == problem.sibling_key]
        if sibs:
            self.hits_sibling += 1
            return min(sibs, key=lambda e: e.metric), "sibling"
        self.misses += 1
        return None, "miss"

    def seed_for(self, problem: Problem, entry: ChampionEntry,
                 problem_of=None) -> Dict[str, Tuple[np.ndarray, ...]]:
        """Project an entry's champion onto `problem` as a warm-start seed.

        Signature-routed (`transfer.auto_migrate`): an exact entry comes
        back untouched, a sibling entry is re-targeted through the
        three-tier migration (on CPU tensors; the result comes back as
        numpy in the store's dtypes).  The donor problem is resolved by
        `problem_of(device_name)` when given (the scheduler passes its own
        memoised resolver so problems are built once per process);
        standalone use falls back to an internal memo.
        """
        if entry.signature == problem.signature:
            return entry.genotype
        src = (problem_of or self._donor_problem)(entry.device_name)
        g = transfer.auto_migrate(src, problem, convert.genotype_from_numpy(entry.genotype))
        return _as_host_genotype(g)

    _donor_cache: Optional[Dict[str, Problem]] = None

    def _donor_problem(self, device_name: str) -> Problem:
        if self._donor_cache is None:
            self._donor_cache = {}
        if device_name not in self._donor_cache:
            from repro_torch.fpga import device, netlist
            self._donor_cache[device_name] = netlist.make_problem(
                device.get_device(device_name))
        return self._donor_cache[device_name]

    # --------------------------------------------------------- persistence

    def save(self, path: Optional[str] = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("no path: pass save(path) or construct "
                             "ChampionStore(path=...)")
        doc = {"champion_store": 1,
               "entries": [e.to_json() for e in self._by_sig.values()],
               # append-only doc key (old readers ignore it; old files
               # load fine without it): traffic survives restarts so a
               # fresh process can prewarm its predicted pools
               "traffic": self._traffic}
        # write-then-rename: a crash mid-dump must never tear an existing
        # snapshot (readers see the old file or the new one, never half)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(doc, f)
            f.write("\n")
        os.replace(tmp, path)
        return path

    def load(self, path: str) -> int:
        """Merge entries from a JSON snapshot (improvement-only, like
        `put`); returns how many entries were absorbed."""
        with open(path) as f:
            doc = json.load(f)
        absorbed = 0
        for d in doc.get("entries", []):
            e = ChampionEntry.from_json(d)
            cur = self._by_sig.get(e.signature)
            if cur is None or e.metric < cur.metric:
                self._by_sig[e.signature] = e
                absorbed += 1
        for sig, row in (doc.get("traffic") or {}).items():
            cur = self._traffic.get(sig)
            if cur is None:
                self._traffic[sig] = dict(row)
            else:                  # merge: counts add, latest metadata wins
                cur["count"] += int(row.get("count", 0))
        return absorbed

    # --------------------------------------------------------------- stats

    def entries(self) -> List[ChampionEntry]:
        return sorted(self._by_sig.values(), key=lambda e: e.signature)

    def stats(self) -> Dict[str, Any]:
        return api.stats_payload(
            n_entries=len(self._by_sig),
            hits_exact=self.hits_exact,
            hits_sibling=self.hits_sibling,
            misses=self.misses,
            puts=self.puts,
            improvements=self.improvements,
        )
