"""The plain sequential greedy packing (Fenzo's `scheduleOnce` with the
cpu-mem bin packer), and the packing efficiency the program's own quality
monitor measures against it.

Jobs go in DRU order; each takes the feasible host with the highest
fitness, the mean of the host's cpu and mem utilization after the
placement (the lowest host index on a tie).
"""
from __future__ import annotations

import numpy as np

from cookbench.reference.precision import f32


def greedy(demands: np.ndarray, avail: np.ndarray, totals: np.ndarray,
           feasible: np.ndarray, rnd=f32) -> np.ndarray:
    """Host index per job, or -1.  demands [J, 3], avail [N, 3],
    totals [N, 2] (mem, cpus), feasible [J, N]; `rnd` rounds every value
    the comparison reads."""
    demands = rnd(demands)
    avail = rnd(avail).astype(np.float64)
    totals = np.maximum(rnd(totals).astype(np.float64), 1e-30)
    used = totals - avail[:, :2]
    out = np.full(len(demands), -1, np.int64)
    for j, d in enumerate(demands.astype(np.float64)):
        feas = feasible[j] & (avail >= d).all(axis=1)
        if not feas.any():
            continue
        fit = rnd((((used[:, 0] + d[0]) / totals[:, 0]
                    + (used[:, 1] + d[1]) / totals[:, 1]) * 0.5)
                  .astype(np.float32))
        fit[~feas] = -np.inf
        best = int(np.argmax(fit))
        avail[best] -= d
        used[best] += d[:2]
        out[j] = best
    return out


def placed_weight(demands: np.ndarray, placed: np.ndarray) -> float:
    """Placed demand, each resource normalized by the window's mean
    demand so no one resource dominates (the program's
    `QualityMonitor._efficiency` weighting)."""
    if len(demands) == 0:
        return 0.0
    scale = np.maximum(demands.mean(axis=0), 1e-9)
    weights = (demands / scale).sum(axis=-1)
    return float(weights[placed].sum())
