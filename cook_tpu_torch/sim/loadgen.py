"""Scenario traces for the simulator.

Port of the two trace builders of `cook_tpu/sim/loadgen.py` that the
rebalance slice replays: `completion_heavy_trace` and
`preemption_heavy_trace`, each returning (jobs, hosts) as the port's
`TraceJob` / `TraceHost` lists, equal to the reference's for the same
arguments.  The HTTP load generator of that module drives a running
service through the reference's client and is not ported.
"""
from __future__ import annotations

import numpy as np

from cook_tpu_torch.sim.simulator import TraceHost, TraceJob


def completion_heavy_trace(
    *,
    jobs: int = 24,
    hosts: int = 4,
    runtime_ms: int = 30_000,
    host_mem: float = 1000.0,
    host_cpus: float = 4.0,
    n_users: int = 1,
    seed: int = 0,
):
    """A deep queue draining in waves, every wave's completions freeing
    the capacity the next wave needs.  Each host fits ONE job (job demand
    == host capacity) and every job runs for exactly `runtime_ms`, so with
    `SimConfig.cycle_ms == runtime_ms` each cycle completes one full wave
    and matches the next.  Returns (jobs, hosts)."""
    rng = np.random.default_rng(seed)
    out_jobs = [
        TraceJob(
            uuid=f"wave-{i:05d}",
            user=f"user{int(rng.integers(n_users))}",
            submit_time_ms=0,
            runtime_ms=runtime_ms,
            mem=host_mem,
            cpus=host_cpus,
        )
        for i in range(jobs)
    ]
    out_hosts = [
        TraceHost(node_id=f"h{i:03d}", hostname=f"h{i:03d}",
                  mem=host_mem, cpus=host_cpus)
        for i in range(hosts)
    ]
    return out_jobs, out_hosts


def preemption_heavy_trace(
    *,
    hog_jobs: int = 8,
    late_jobs: int = 6,
    hosts: int = 4,
    host_mem: float = 1000.0,
    host_cpus: float = 4.0,
    runtime_ms: int = 600_000,
    late_arrival_ms: int = 60_000,
    n_late_users: int = 3,
    seed: int = 0,
):
    """The fairness observatory's acceptance scenario: one over-share
    user floods the pool at t=0 with long-running jobs (each consumes half
    a host), then `n_late_users` under-share users arrive at
    `late_arrival_ms` with nothing free.  With the rebalancer on
    (`SimConfig.rebalance_every` + a share set for the default user so DRU
    is finite) the late arrivals can only start by preempting the hog.
    Returns (jobs, hosts)."""
    rng = np.random.default_rng(seed)
    jobs = [
        TraceJob(
            uuid=f"hog-{i:05d}",
            user="hog",
            submit_time_ms=0,
            runtime_ms=runtime_ms,
            mem=host_mem / 2.0,
            cpus=host_cpus / 2.0,
        )
        for i in range(hog_jobs)
    ] + [
        TraceJob(
            uuid=f"late-{i:05d}",
            user=f"late{int(rng.integers(n_late_users))}",
            submit_time_ms=late_arrival_ms,
            runtime_ms=runtime_ms // 4,
            mem=host_mem / 2.0,
            cpus=host_cpus / 2.0,
        )
        for i in range(late_jobs)
    ]
    out_hosts = [
        TraceHost(node_id=f"h{i:03d}", hostname=f"h{i:03d}",
                  mem=host_mem, cpus=host_cpus)
        for i in range(hosts)
    ]
    return jobs, out_hosts
