"""The train step: loss, gradients and AdamW, with microbatch accumulation.

Port of `repro/train/train_step.py`.  The reference's step is a pure
function of (params, opt_state, batch) under `jit`; here the parameters
live in the model (`models.transformer.Transformer`), so a step computes
the loss on the model, takes the gradients with `torch.autograd.grad`,
runs `optimizer.update` on the tree of the model's named parameters and
puts the updated tensors in the parameters' place (no copy, no write in
place: an fp32 parameter then shares its master's storage).  With
`n_micro` > 1 the batch is cut into `n_micro` slices along its first axis
and their fp32 gradients are summed and divided once, as the reference's
`lax.scan` accumulation does.  The same step runs on DTensor parameters
and batches (the dry-run): a batch sharded on its first axis is cut
within each rank's shard, so no microbatch moves a row between ranks.
There is no donation.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.models import transformer as T
from repro_torch.models.transformer import ArchConfig, Transformer
from repro_torch.train import optimizer as opt


def params_of(model: Transformer) -> Dict[str, torch.Tensor]:
    """The model's parameters by name, detached: the optimizer's tree."""
    return {n: p.detach() for n, p in model.named_parameters()}


def set_params(model: Transformer, params: Dict[str, torch.Tensor]) -> None:
    """Put `params` in the model's parameters' place (their storage, not a
    copy of their values); shapes and dtypes must agree.  A DTensor laid
    out otherwise than its parameter is redistributed to the parameter's
    layout first."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            new = params[name]
            if isinstance(p, DTensor) and tuple(new.placements) != tuple(p.placements):
                new = new.redistribute(p.device_mesh, p.placements)   # ZeRO-1's gather
            if new.shape != p.shape or new.dtype != p.dtype:
                raise ValueError(f"{name}: {tuple(new.shape)} {new.dtype} for a parameter "
                                 f"{tuple(p.shape)} {p.dtype}")
            p.data = new


def _check(cfg: ArchConfig, model: Transformer) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step is built for {cfg.name}, the model is {model.cfg.name}")


def loss_and_grads(model: Transformer, batch: Dict[str, torch.Tensor]):
    """(loss, {"xent", "aux"}, {name: gradient}) of one batch, detached; a
    parameter the loss does not reach gets a zero gradient."""
    loss, metrics = T.loss_fn(model, batch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, dict(zip(names, grads))


def microbatches(batch: Dict[str, torch.Tensor], n_micro: int):
    """`batch` cut into `n_micro` slices along its first axis; a DTensor
    sharded there is cut within each rank's local shard."""
    def part(v, i):
        if isinstance(v, DTensor) and any(p == Shard(0) for p in v.placements):
            return DTensor.from_local(v.to_local().tensor_split(n_micro)[i], v.device_mesh,
                                      v.placements, run_check=False)
        return v.tensor_split(n_micro)[i]

    return [{k: part(v, i) for k, v in batch.items()} for i in range(n_micro)]


def make_train_step(cfg: ArchConfig, ocfg: opt.OptConfig, n_micro: int = 1) -> Callable:
    """Returns train_step(model, opt_state, batch) -> (opt_state', metrics),
    which replaces the model's parameters by the updated ones."""

    def train_step(model: Transformer, opt_state: Dict[str, Any],
                   batch: Dict[str, torch.Tensor]):
        _check(cfg, model)
        if n_micro == 1:
            loss, metrics, grads = loss_and_grads(model, batch)
        else:
            if any(v.shape[0] % n_micro for v in batch.values()):
                raise ValueError(f"a batch of {next(iter(batch.values())).shape[0]} rows "
                                 f"does not split into {n_micro} microbatches")
            mbs = microbatches(batch, n_micro)
            acc = {n: torch.zeros_like(p, dtype=torch.float32)
                   for n, p in model.named_parameters()}
            losses, metricss = [], []
            for mb in mbs:
                loss, metrics, g = loss_and_grads(model, mb)
                acc = {n: acc[n] + g[n] for n in acc}
                losses.append(loss)
                metricss.append(metrics)
            grads = {n: a / n_micro for n, a in acc.items()}
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in metricss]))
                       for k in metricss[0]}
        new_params, new_opt, onorm = opt.update(ocfg, params_of(model), grads, opt_state)
        set_params(model, new_params)
        return new_opt, dict(metrics, loss=loss, **onorm)

    return train_step


def make_eval_step(cfg: ArchConfig) -> Callable:
    """Returns eval_step(model, batch) -> {"loss", "xent", "aux"}, without
    gradients."""

    def eval_step(model: Transformer, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        _check(cfg, model)
        with torch.no_grad():
            loss, metrics = T.loss_fn(model, batch)
        return dict(metrics, loss=loss)

    return eval_step


def batch_to(batch: Dict[str, Any], device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (numpy) as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
