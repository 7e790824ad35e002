"""Rebalancer knobs.

Port of `RebalancerParams` from `cook_tpu/scheduler/rebalancer.py`, the
type of `SchedulerConfig.rebalancer`, with the three knobs of Cook's
rebalancer config.  The rebalance cycle itself (`rebalance_pool`, the
preemption-decision kernels) and its further options (the fast cycle,
residency, gang admission) are a later slice: nothing in this slice reads
these values yet.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class RebalancerParams:
    """Runtime-mutable knobs (reference: Datomic-stored `:rebalancer/config`,
    rebalancer.clj:535-557, docs/rebalancer-config.adoc)."""

    safe_dru_threshold: float = 1.0
    min_dru_diff: float = 0.5
    max_preemption: int = 100
