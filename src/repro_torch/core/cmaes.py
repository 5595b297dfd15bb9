"""sep-CMA-ES: the diagonal CMA-ES of Ros & Hansen (2008) that the paper
uses for placement.

Port of `repro/core/cmaes.py`.  It searches the flat continuous genotype
(distribution genes raw, location genes through a sigmoid, mapping
permutations as argsort keys) on the scalarized objective
log(wl^2) + log(max bbox), with the covariance restricted to its diagonal
and the separable learning-rate speedup c_cov *= (n + 2) / 3.

`step_impl` draws z [lambda, n] and hands it to the pure `step_body`.  The
learning rates are fp32 tensors as in the reference (where they are f32
arrays) and chi_n a Python float, so the state follows the reference's to
fp32 rounding; ranking uses a stable argsort, as `jnp.argsort` does.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import genotype as G
from repro_torch.core import hyper
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem


@dataclasses.dataclass(frozen=True)
class CMAESConfig:
    pop_size: int = 0            # 0 -> 4 + floor(3 ln n)
    sigma0: float = 0.3
    fused: bool = False          # route evaluation through ops.fused_eval

    def lam(self, n: int) -> int:
        return self.pop_size if self.pop_size > 0 else 4 + int(3 * math.log(n))


def _constants(n: int, lam: int) -> Dict:
    """Weights and rates for dimension n and lambda samples, in fp32 on the
    CPU (chi_n a Python float)."""
    mu = lam // 2
    w = (torch.log(torch.tensor(mu + 0.5, dtype=torch.float32))
         - torch.log(torch.arange(1, mu + 1, dtype=torch.float32)))
    w = w / torch.sum(w)
    mu_eff = 1.0 / torch.sum(w ** 2)
    c_sigma = (mu_eff + 2.0) / (n + mu_eff + 5.0)
    d_sigma = (1.0 + 2.0 * torch.clamp(
        torch.sqrt((mu_eff - 1.0) / (n + 1.0)) - 1.0, min=0.0) + c_sigma)
    c_c = (4.0 + mu_eff / n) / (n + 4.0 + 2.0 * mu_eff / n)
    c_1 = 2.0 / ((n + 1.3) ** 2 + mu_eff)
    c_mu = torch.minimum(
        1.0 - c_1,
        2.0 * (mu_eff - 2.0 + 1.0 / mu_eff) / ((n + 2.0) ** 2 + mu_eff))
    # separable speedup (Ros & Hansen 2008): diagonal model learns ~n/3 faster
    sep = (n + 2.0) / 3.0
    c_1 = torch.clamp(c_1 * sep, max=1.0)
    c_mu = torch.minimum(1.0 - c_1, c_mu * sep)
    chi_n = math.sqrt(n) * (1.0 - 1.0 / (4.0 * n) + 1.0 / (21.0 * n * n))
    return dict(mu=mu, w=w, mu_eff=mu_eff, c_sigma=c_sigma, d_sigma=d_sigma,
                c_c=c_c, c_1=c_1, c_mu=c_mu, chi_n=chi_n)


@functools.lru_cache(maxsize=16)
def _constants_on(n: int, lam: int, device: torch.device) -> Dict:
    """`_constants` uploaded once per (n, lambda, device), so that a
    generation copies nothing from the host."""
    return {k: v.to(device) if isinstance(v, torch.Tensor) else v
            for k, v in _constants(n, lam).items()}


def init_state(problem: Problem, gen: torch.Generator, cfg: CMAESConfig,
               mean0: Optional[torch.Tensor] = None) -> Dict:
    """Mean from `mean0` (flat [n]) or N(0, 0.1^2) on `gen`'s device."""
    n = problem.continuous_dim
    if mean0 is not None:
        mean = torch.as_tensor(mean0, dtype=torch.float32)
    else:
        mean = torch.randn(n, generator=gen, device=gen.device) * 0.1
    dev = mean.device
    return {
        "mean": mean,
        "sigma": hyper.as_f32(cfg.sigma0, dev),
        "c_diag": torch.ones(n, device=dev),
        "p_sigma": torch.zeros(n, device=dev),
        "p_c": torch.zeros(n, device=dev),
        "gen": torch.zeros((), dtype=torch.int32, device=dev),
        "best_objs": torch.full((2,), torch.inf, device=dev),
        "best_z": mean,
    }


def step_body(problem: Problem, cfg: CMAESConfig, state: Dict,
              z: torch.Tensor) -> Dict:
    """One generation from its draws z [lambda, n] ~ N(0, I)."""
    n = problem.continuous_dim
    c = _constants_on(n, cfg.lam(n), z.device)
    mu, w = c["mu"], c["w"]

    y = z * torch.sqrt(state["c_diag"])[None, :]
    x = state["mean"][None, :] + state["sigma"] * y

    objs = O.evaluate_flat_population(problem, x, cfg.fused)   # [lam, 2]
    fit = O.scalarize(objs)
    order = torch.argsort(fit, stable=True)
    y_sel = y[order[:mu]]                                  # [mu, n]
    z_sel = z[order[:mu]]

    y_w = torch.sum(w[:, None] * y_sel, dim=0)
    z_w = torch.sum(w[:, None] * z_sel, dim=0)
    mean = state["mean"] + state["sigma"] * y_w

    p_sigma = ((1.0 - c["c_sigma"]) * state["p_sigma"]
               + torch.sqrt(c["c_sigma"] * (2.0 - c["c_sigma"]) * c["mu_eff"])
               * z_w)
    ps_norm = torch.linalg.vector_norm(p_sigma)
    sigma = state["sigma"] * torch.exp(
        (c["c_sigma"] / c["d_sigma"]) * (ps_norm / c["chi_n"] - 1.0))

    gen = state["gen"] + 1
    h_sig = (ps_norm / torch.sqrt(
        1.0 - (1.0 - c["c_sigma"]) ** (2.0 * gen)) / c["chi_n"]
        < 1.4 + 2.0 / (n + 1.0)).to(torch.float32)
    p_c = ((1.0 - c["c_c"]) * state["p_c"]
           + h_sig * torch.sqrt(c["c_c"] * (2.0 - c["c_c"]) * c["mu_eff"])
           * y_w)

    rank_mu = torch.sum(w[:, None] * (y_sel ** 2), dim=0)
    c_diag = ((1.0 - c["c_1"] - c["c_mu"]) * state["c_diag"]
              + c["c_1"] * (p_c ** 2
                            + (1.0 - h_sig) * c["c_c"]
                            * (2.0 - c["c_c"]) * state["c_diag"])
              + c["c_mu"] * rank_mu)
    c_diag = torch.clamp(c_diag, min=1e-12)

    best_i = order[:1]
    best_fit = fit.index_select(0, best_i)[0]
    improved = best_fit < O.scalarize(state["best_objs"])
    best_objs = torch.where(improved, objs.index_select(0, best_i)[0], state["best_objs"])
    best_z = torch.where(improved, x.index_select(0, best_i)[0], state["best_z"])

    return {"mean": mean, "sigma": sigma, "c_diag": c_diag,
            "p_sigma": p_sigma, "p_c": p_c, "gen": gen,
            "best_objs": best_objs, "best_z": best_z}


def step_impl(problem: Problem, cfg: CMAESConfig, state: Dict,
              gen: torch.Generator) -> Dict:
    n = problem.continuous_dim
    z = torch.randn(cfg.lam(n), n, generator=gen, device=gen.device)
    return step_body(problem, cfg, state, z)



def best_genotype(problem: Problem, state: Dict) -> Tuple[G.Genotype, torch.Tensor]:
    """The best sample so far as a genotype (1-D leaves) and its objectives."""
    g = G.from_flat(problem, state["best_z"][None])
    return G.tree_map(lambda a: a[0], g), state["best_objs"]
