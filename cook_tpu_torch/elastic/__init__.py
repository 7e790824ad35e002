"""Elastic capacity plane: device-solved pool loaning and cluster
autoscaling.

Port of `cook_tpu/elastic/`: the planner solves on the scheduler's
device (`ops/elastic.py`), the recorder is a copy.  Pools partition the fleet statically; this subsystem loans idle capacity
between them (Aryl's elastic-scheduler design, arXiv:2202.07896) with
durable, failover-safe deltas (cook_tpu_torch/txn), observable decisions
(the recorder ring the reference serves at `GET /debug/elastic`), and
a non-disruptive reclaim path that runs
BEFORE in-pool preemption.  See docs/elastic.md.
"""
from cook_tpu_torch.elastic.planner import CapacityPlanner, ElasticParams
from cook_tpu_torch.elastic.recorder import ElasticRecorder, PlanRecord

__all__ = [
    "CapacityPlanner",
    "ElasticParams",
    "ElasticRecorder",
    "PlanRecord",
]
