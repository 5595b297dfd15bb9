"""Deterministic, host-shardable, exactly-resumable synthetic LM data.

Every batch is a pure function of (seed, step, shard) -- counter-based RNG,
no iterator state -- so:
  * checkpoint/restore of the pipeline is just the step integer,
  * elastic re-sharding (hosts join/leave) re-partitions batches without
    replaying history,
  * any batch can be re-materialised for bitwise-identical replay/debug.

The stream is a noisy affine 2-gram process, t_{i+1} = (a*t_i + c + e) mod V
with e ~ small uniform noise: enough learnable structure that the example
trainer's loss drops well below ln(V), while staying fully synthetic.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: int = 4                # e in [0, noise)
    frontend_tokens: int = 0      # synth embeddings for vlm/audio archs
    d_model: int = 0


class Pipeline:
    """Stateless batch source; `shard`/`n_shards` split the global batch."""

    def __init__(self, cfg: DataConfig, shard: int = 0, n_shards: int = 1):
        assert cfg.global_batch % n_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.n_shards = n_shards
        self.local_batch = cfg.global_batch // n_shards
        # fixed per-seed affine params (coprime multiplier)
        rng = np.random.default_rng(cfg.seed)
        self.a = int(rng.integers(1, cfg.vocab - 1)) | 1
        self.c = int(rng.integers(0, cfg.vocab))

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.Philox(key=self.cfg.seed,
                             counter=[step, self.shard, 0, 0]))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = self._rng(step)
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        noise = rng.integers(0, max(cfg.noise, 1), (b, s))
        for i in range(s):
            toks[:, i + 1] = (toks[:, i] * self.a + self.c
                              + noise[:, i]) % v
        out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
        if cfg.frontend_tokens:
            out["frontend_embeds"] = rng.normal(
                0, 0.02, (b, cfg.frontend_tokens, cfg.d_model)
            ).astype(np.float32)
        return out

    # ---------------------------------------------------- checkpointing

    def state(self, step: int) -> Dict[str, int]:
        return {"step": step, "seed": self.cfg.seed,
                "shard": self.shard, "n_shards": self.n_shards}

    @staticmethod
    def resume(cfg: DataConfig, state: Dict[str, int],
               shard: Optional[int] = None, n_shards: Optional[int] = None
               ) -> "Pipeline":
        """Resume, possibly onto a different shard split (elastic)."""
        return Pipeline(cfg,
                        shard if shard is not None else state["shard"],
                        n_shards if n_shards is not None else
                        state["n_shards"])
