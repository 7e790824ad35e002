"""Scenario traces for the simulator.

Port of the four trace generators of `cook_tpu/sim/loadgen.py` that the
port's slices replay: `imbalanced_pool_trace` (the elastic slice's),
`completion_heavy_trace`, `preemption_heavy_trace` and
`gang_topology_trace` (:259), each returning
(jobs, hosts) as the port's `TraceJob` / `TraceHost` lists, equal to the
reference's for the same arguments.  The HTTP load generator of that module drives a running
service through the reference's client and is not ported.
"""
from __future__ import annotations

import numpy as np

from cook_tpu_torch.sim.simulator import TraceHost, TraceJob


def imbalanced_pool_trace(
    *,
    busy_jobs: int = 30,
    busy_hosts: int = 2,
    idle_hosts: int = 4,
    host_mem: float = 64_000.0,
    host_cpus: float = 32.0,
    job_mem: float = 8_000.0,
    job_cpus: float = 8.0,
    runtime_ms: int = 60_000,
    n_users: int = 3,
    seed: int = 0,
):
    """The elastic capacity plane's acceptance scenario: two pools, one
    starving while the other idles — exactly the static-partition
    pathology pool loaning exists to fix.

    Pool "busy" gets a burst of `busy_jobs` at t=0 against only
    `busy_hosts` hosts; pool "idle" holds `idle_hosts` identical hosts
    and no work.  Statically partitioned, busy's queue drains in waves
    bounded by its own capacity while idle's fleet sits unused; with
    the planner on (`SimConfig.elastic_every` / `sim.cli run
    --elastic`), idle's capacity is loaned over and the p50 queued-job
    wait drops (asserted in tests/test_elastic.py, and of the port in
    tests/test_torch_elastic.py).  Returns (jobs,
    hosts) TraceJob/TraceHost lists for sim.simulator.Simulator.
    """
    rng = np.random.default_rng(seed)
    jobs = [
        TraceJob(
            uuid=f"busy-{i:05d}",
            user=f"user{int(rng.integers(n_users))}",
            submit_time_ms=0,
            runtime_ms=runtime_ms,
            mem=job_mem,
            cpus=job_cpus,
            pool="busy",
        )
        for i in range(busy_jobs)
    ]
    hosts = [
        TraceHost(node_id=f"busy-h{i}", hostname=f"busy-h{i}",
                  mem=host_mem, cpus=host_cpus, pool="busy")
        for i in range(busy_hosts)
    ] + [
        TraceHost(node_id=f"idle-h{i}", hostname=f"idle-h{i}",
                  mem=host_mem, cpus=host_cpus, pool="idle")
        for i in range(idle_hosts)
    ]
    return jobs, hosts


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


def gang_topology_trace(
    *,
    n_blocks: int = 2,
    block_hosts: int = 4,
    gang_sizes: tuple = (4, 4, 2),
    host_mem: float = 1000.0,
    host_cpus: float = 4.0,
    cycle_ms: int = 30_000,
    gang_runtime_cycles: int = 2,
    seed: int = 0,
):
    """Gang scheduling's acceptance scenario: a blocky
    fleet fully occupied by staggered scalar churn, with mixed-size
    k-host gangs (`gang_sizes`) queued behind it — capacity frees ONE
    host per cycle, in an order scrambled across topology blocks.

    Naive flat placement trickles gang members onto hosts as they free:
    members start cycles apart, land scattered across blocks, and (with
    member runtime shorter than the trickle) the gang's runs never all
    overlap — assembled never, wasted distributed-job work.  With gang
    scheduling on (`MatchConfig.gang_enabled` +
    `topology_block_hosts=block_hosts`) each gang skips
    `gang-incomplete` until one block holds k free hosts, then places
    whole: assembled at first launch, block_spread == 1.  The A/B
    (tests/test_torch_sim.py): higher assembled share, lower
    `SimResult.gang_stats` wait p50, AND lower mean block spread than the
    same trace with gangs disabled.

    Each job's demand equals one host's capacity (1 job per host).
    Churn job i runs for perm(i)+1 cycles, so frees land one per cycle
    in seeded-shuffled host order.  Returns (jobs, hosts) TraceJob/
    TraceHost lists for sim.simulator.Simulator."""
    rng = np.random.default_rng(seed)
    n_hosts = n_blocks * block_hosts
    perm = rng.permutation(n_hosts)
    jobs = [
        TraceJob(
            uuid=f"churn-{i:03d}",
            user="churn",
            submit_time_ms=0,
            runtime_ms=int(perm[i] + 1) * cycle_ms,
            mem=host_mem,
            cpus=host_cpus,
            priority=90,        # churn places first: gangs queue behind
        )
        for i in range(n_hosts)
    ] + [
        TraceJob(
            uuid=f"gang{g}-m{m}",
            user=f"ganguser{g}",
            submit_time_ms=0,
            runtime_ms=gang_runtime_cycles * cycle_ms,
            mem=host_mem,
            cpus=host_cpus,
            priority=50,
            gang=f"gang-{g}",
        )
        for g, k in enumerate(gang_sizes)
        for m in range(k)
    ]
    hosts = [
        TraceHost(node_id=f"b{b}h{i}", hostname=f"b{b}h{i}",
                  mem=host_mem, cpus=host_cpus)
        for b in range(n_blocks)
        for i in range(block_hosts)
    ]
    return jobs, hosts
