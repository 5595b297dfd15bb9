"""Post-placement pipelining and its wire-delay timing model (paper SS III-B,
IV-C).

Port of `repro/core/pipelining.py`.  Once placement is final, per-net
Manhattan lengths are exact, so each net is pipelined to the depth it
needs.  The linear wire-delay model, calibrated to the paper's anchors
(~650 MHz unpipelined and 733 MHz average for an NSGA-II VU11P placement,
891 MHz hard-block ceiling):

    delay(net)  = K_NS_PER_RPM * manhattan_rpm / (stages + 1)
    period      = T_BASE_NS + max_net delay
    f           = min(1/period, F_CEIL)

A stage costs the net's bus width in registers, times the full-chip
replication factor.  The arithmetic is the reference's numpy over the
port's `net_lengths`, copied to the host once per call.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.core import genotype as G
from repro_torch.core import objectives as O
from repro_torch.fpga.netlist import Problem

T_BASE_NS = 1.10       # clk->q + setup + local route floor  (~909 MHz asymptote)
K_NS_PER_RPM = 7.0e-3  # incremental route delay per RPM unit of wirelength
F_CEIL_MHZ = 891.0     # UltraScale+ URAM/DSP hard Fmax


@dataclasses.dataclass(frozen=True)
class PipelineReport:
    freq_mhz: float                # at the chosen pipelining depth
    stages_per_net: np.ndarray     # [N] inserted stages
    total_registers: int           # chip-wide (x n_rects)
    max_net_rpm: float
    depth: int


def _net_lengths(problem: Problem, g: G.Genotype) -> np.ndarray:
    """[N] f32 Manhattan lengths of one genotype (1-D leaves), on the host."""
    return O.net_lengths(problem, G.tree_map(lambda a: a[None], g))[0].cpu().numpy()


def frequency_at_depth(problem: Problem, g: G.Genotype, depth: int) -> float:
    """Uniform-depth pipelining: every net gets `depth` stages (Fig. 9)."""
    lens = _net_lengths(problem, g)
    period = T_BASE_NS + K_NS_PER_RPM * lens.max() / (depth + 1)
    return float(min(1e3 / period, F_CEIL_MHZ))


def registers_at_depth(problem: Problem, depth: int) -> int:
    bits = int(problem.net_bits.sum())
    return bits * depth * problem.n_rects


def auto_pipeline(problem: Problem, g: G.Genotype,
                  target_mhz: float = 650.0) -> PipelineReport:
    """Per-net minimal pipelining to hit `target_mhz` (paper's 650 MHz):
    stages(net) = ceil(K * len / slack) - 1, slack = 1/f_target - T_BASE."""
    lens = _net_lengths(problem, g).astype(np.float64)
    slack_ns = 1e3 / target_mhz - T_BASE_NS
    if slack_ns <= 0:
        raise ValueError(f"target {target_mhz} MHz above model ceiling")
    stages = np.maximum(
        np.ceil(K_NS_PER_RPM * lens / slack_ns) - 1.0, 0.0).astype(np.int64)
    regs = int((stages * problem.net_bits).sum()) * problem.n_rects
    seg = K_NS_PER_RPM * lens / (stages + 1)
    f = min(1e3 / (T_BASE_NS + seg.max()), F_CEIL_MHZ)
    return PipelineReport(freq_mhz=float(f),
                          stages_per_net=stages,
                          total_registers=regs,
                          max_net_rpm=float(lens.max()),
                          depth=int(stages.max()))


def depth_sweep(problem: Problem, g: G.Genotype, max_depth: int = 4
                ) -> Dict[int, Dict[str, float]]:
    """Fig. 9 data: frequency and register cost per uniform pipeline depth."""
    return {d: {"freq_mhz": frequency_at_depth(problem, g, d),
                "registers": registers_at_depth(problem, d)}
            for d in range(max_depth + 1)}
