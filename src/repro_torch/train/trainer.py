"""Training loop with checkpoint/restart, failure recovery, straggler watch.

Port of `repro/train/trainer.py`, the loop behind `examples/train_lm.py` and
`launch/train.py`.  The fault-tolerance contract is the reference's:

  on start     : restore the latest checkpoint if present (params, opt, step)
  every K steps: async atomic checkpoint (params + opt + data state)
  on failure   : (simulated via `inject_failure_at`) restore the last
                 checkpoint -> Pipeline.resume from its manifest -> continue
  every step   : StragglerMonitor.record

The model (`Transformer`) lives on `device` (the card unless the caller
asks for the CPU), its weights drawn from a `torch.Generator` seeded with
`seed` on that device, or given as a state dict (`params=`, e.g. the
reference's weights through `core.convert.lm_params_from_numpy`).  A
restore replaces the model's parameters and the optimizer state and
resumes the pipeline at the checkpoint's step.  Unlike the reference, the
trainer keeps one save in flight: it waits for the pending async save
before the next save and before it restores, so a failure right after a
checkpoint step restores that step, and the final synchronous save of a
step that was just saved asynchronously is the one left on disk when
`run` returns.  The token embedding's backward sums each row's gradients
in a fixed order (`F.embedding`), so on the CPU a recovered run equals the
uninterrupted one bit for bit; on the card it has been seen to as well,
though nothing promises that every CUDA op it runs is deterministic.
"""
from __future__ import annotations

import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.ckpt import checkpoint
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.models.transformer import ArchConfig, Transformer
from repro_torch.runtime.elastic import StragglerMonitor
from repro_torch.train import optimizer as opt
from repro_torch.train.train_step import batch_to, make_train_step, params_of, set_params


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    n_micro: int = 1
    param_dtype: Any = None        # default fp32
    inject_failure_at: Optional[int] = None   # test hook


class SimulatedFailure(RuntimeError):
    pass


class Trainer:
    def __init__(self, cfg: ArchConfig, ocfg: opt.OptConfig,
                 tcfg: TrainerConfig, data_cfg: DataConfig,
                 seed: int = 0, device="cuda",
                 params: Optional[Dict[str, torch.Tensor]] = None):
        self.cfg, self.ocfg, self.tcfg = cfg, ocfg, tcfg
        self.data_cfg = data_cfg
        self.device = resolve_device(device)
        self.pipeline = Pipeline(data_cfg)
        dtype = tcfg.param_dtype or torch.float32
        gen = None if params is not None else \
            torch.Generator(device=self.device).manual_seed(seed)
        self.model = Transformer(cfg, device=self.device, dtype=dtype, generator=gen)
        if params is not None:
            self.model.load_state_dict(params)
        self.opt_state = opt.init(params_of(self.model), ocfg.compress_grads)
        self.step = 0
        self.train_step = make_train_step(cfg, ocfg, tcfg.n_micro)
        self.monitor = StragglerMonitor()
        self.history: List[Dict[str, float]] = []
        self._pending: Optional[Future] = None
        if tcfg.ckpt_dir and checkpoint.latest_steps(tcfg.ckpt_dir):
            self._restore()

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return params_of(self.model)

    # ------------------------------------------------------------ ckpt

    def _save(self, async_: bool = True):
        if not self.tcfg.ckpt_dir:
            return
        self._wait()                 # one save in flight: the last one written wins
        tree = {"params": self.params, "opt": self.opt_state}
        self._pending = checkpoint.save(
            self.tcfg.ckpt_dir, self.step, tree,
            meta={"data": self.pipeline.state(self.step), "arch": self.cfg.name},
            async_=async_)

    def _wait(self):
        if self._pending is not None:
            self._pending.result()
            self._pending = None

    def _restore(self):
        self._wait()
        like = {"params": self.params, "opt": self.opt_state}
        tree = checkpoint.restore(self.tcfg.ckpt_dir, like)
        set_params(self.model, tree["params"])
        self.opt_state = tree["opt"]
        man = checkpoint.manifest(self.tcfg.ckpt_dir)
        self.step = man["step"]
        self.pipeline = Pipeline.resume(self.data_cfg, man["meta"]["data"])

    # ------------------------------------------------------------ loop

    def run(self) -> List[Dict[str, float]]:
        while self.step < self.tcfg.steps:
            if (self.tcfg.inject_failure_at is not None
                    and self.step == self.tcfg.inject_failure_at):
                self.tcfg.inject_failure_at = None
                raise SimulatedFailure(f"injected at step {self.step}")
            t0 = time.monotonic()
            batch = batch_to(self.pipeline.batch(self.step), self.device)
            self.opt_state, metrics = self.train_step(self.model, self.opt_state, batch)
            self.step += 1
            dt = time.monotonic() - t0
            self.monitor.record(dt)
            if self.step % self.tcfg.log_every == 0 or \
                    self.step == self.tcfg.steps:
                row = {k: float(v) for k, v in metrics.items()}
                row.update(step=self.step, sec_per_step=dt,
                           straggler=float(self.monitor.straggling()))
                self.history.append(row)
            if self.tcfg.ckpt_every and \
                    self.step % self.tcfg.ckpt_every == 0:
                self._save()
        self._save(async_=False)
        return self.history

    def run_with_recovery(self) -> List[Dict[str, float]]:
        """Run; on failure, restore from the last checkpoint and continue --
        the single-process analogue of a full job restart."""
        try:
            return self.run()
        except SimulatedFailure:
            if self.tcfg.ckpt_dir and checkpoint.latest_steps(
                    self.tcfg.ckpt_dir):
                self._restore()
            else:                    # no checkpoint yet: restart from 0
                self.step = 0
            return self.run()
