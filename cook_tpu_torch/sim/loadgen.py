"""Deploy-scale workload generator and the simulator's scenario traces.

Port of `cook_tpu/sim/loadgen.py` (Cook's simulator/, simulator/README.md):
distinct from the in-process trace simulator (sim/simulator.py), the load
generator makes a randomized multi-user workload and replays it against a
fully deployed scheduler through the public REST API, measuring what a
user of the deployment measures: submission latency, time-to-first-
schedule, completion.

    python -m cook_tpu_torch.sim.cli loadgen --url http://host:port \
        --jobs 500 --rate 600 --users 10 --seed 7 --out results.json

The arrival process is Poisson at `--rate` jobs/minute (compressed by
`--speedup`), job shapes are drawn from skewed size distributions, and
every job carries a short mock runtime so a mock/k8s-backed deployment
completes it quickly.  `run_load` drives the service through the port's
job client (`client/jobclient.py`, on the standard library).

The scenario traces (`imbalanced_pool_trace`, `completion_heavy_trace`,
`preemption_heavy_trace`, `gang_topology_trace`, `rest_traffic_trace`
with `traffic_trace_jobs`) return the port's `TraceJob` / `TraceHost`
lists, equal to the reference's for the same arguments.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from cook_tpu_torch.client.jobclient import JobClient
from cook_tpu_torch.sim.simulator import TraceHost, TraceJob


@dataclass
class LoadConfig:
    n_jobs: int = 200
    rate_per_minute: float = 600.0
    n_users: int = 8
    seed: int = 0
    speedup: float = 1.0            # >1 compresses inter-arrival gaps
    pool: Optional[str] = None
    runtime_ms_choices: tuple = (500, 1000, 2000)
    mem_choices: tuple = (128, 256, 512, 1024, 4096)
    cpus_choices: tuple = (0.5, 1, 2, 4)
    batch_max: int = 20             # jobs per submit call (burst arrivals)


@dataclass
class LoadReport:
    submitted: int = 0
    completed: int = 0
    failed: int = 0
    wall_s: float = 0.0
    submit_latency_ms: list = field(default_factory=list)
    schedule_latency_ms: dict = field(default_factory=dict)  # uuid -> ms

    def summary(self) -> dict:
        lat = sorted(self.submit_latency_ms)
        sched = sorted(self.schedule_latency_ms.values())

        def pct(values, q):
            if not values:
                return None
            return round(float(np.percentile(values, q)), 1)

        return {
            "submitted": self.submitted,
            "completed": self.completed,
            "failed": self.failed,
            "wall_s": round(self.wall_s, 2),
            "throughput_jobs_per_s": round(
                self.completed / self.wall_s, 2) if self.wall_s else 0,
            "submit_ms_p50": pct(lat, 50),
            "submit_ms_p99": pct(lat, 99),
            "schedule_ms_p50": pct(sched, 50),
            "schedule_ms_p99": pct(sched, 99),
        }


def generate_workload(config: LoadConfig) -> list[tuple[float, dict]]:
    """(arrival_offset_s, job_spec) pairs — Poisson arrivals, skewed
    shapes, round-robin-ish user mix."""
    rng = np.random.default_rng(config.seed)
    gaps = rng.exponential(60.0 / config.rate_per_minute, config.n_jobs)
    offsets = np.cumsum(gaps) / config.speedup
    out = []
    for i in range(config.n_jobs):
        spec = {
            "command": "true",
            "name": f"loadgen-{i}",
            "mem": float(rng.choice(config.mem_choices)),
            "cpus": float(rng.choice(config.cpus_choices)),
            "max_retries": 3,
            "expected_runtime": int(rng.choice(config.runtime_ms_choices)),
            "labels": {"loadgen-user": f"user{int(rng.integers(config.n_users))}"},
            **({"pool": config.pool} if config.pool else {}),
        }
        out.append((float(offsets[i]), spec))
    return out


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


@dataclass(frozen=True)
class TrafficOp:
    """One control-plane request in a rest_traffic_trace schedule."""

    offset_s: float
    kind: str                     # "submit" | "query" | "kill"
    user: str
    spec: Optional[dict] = None   # submit payload
    ref: int = -1                 # trace index of the submit this
    #                               query/kill targets


def rest_traffic_trace(
    *,
    duration_s: float = 10.0,
    rps: float = 50.0,
    mix: tuple = (0.7, 0.2, 0.1),   # submit : query : kill
    n_users: int = 8,
    burst_every_s: float = 2.0,
    burst_len_s: float = 0.4,
    burstiness: float = 4.0,
    seed: int = 0,
    pool: Optional[str] = None,
) -> list[TrafficOp]:
    """Seeded bursty submit/query/kill schedule — the ONE load shape
    shared by the reference's `tools/loadtest.py` (replayed over HTTP
    against a live control plane) and the simulator
    (`traffic_trace_jobs` converts the submit ops to TraceJobs), so
    live runs and offline replays drive the same reproducible traffic;
    equal to the reference's for the same arguments.

    Arrivals are a non-homogeneous Poisson process: every
    `burst_every_s` a `burst_len_s` window runs at `burstiness` x the
    base rate (the base is scaled down so the long-run average stays at
    `rps`) — the thundering-herd pattern that exposes lock and fsync
    contention, which a smooth arrival stream hides.  Query/kill ops
    target a uniformly-drawn earlier submit (before any submit exists
    they degrade to submits), so the trace is self-contained."""
    rng = np.random.default_rng(seed)
    frac = min(burst_len_s / max(burst_every_s, 1e-9), 1.0)
    # solve mean rate == rps: frac*burst_rate + (1-frac)*base == rps
    base = max(rps * (1.0 - burstiness * frac) / max(1.0 - frac, 1e-9),
               rps * 0.05)
    burst_rate = rps * burstiness
    kinds = ("submit", "query", "kill")
    p = np.asarray(mix, dtype=float)
    p = p / p.sum()
    ops: list[TrafficOp] = []
    submit_indices: list[int] = []
    t = 0.0
    i = 0
    while True:
        rate = burst_rate if (t % burst_every_s) < burst_len_s else base
        t += float(rng.exponential(1.0 / max(rate, 1e-9)))
        if t >= duration_s:
            break
        kind = kinds[int(rng.choice(3, p=p))]
        user = f"user{int(rng.integers(n_users))}"
        if kind != "submit" and not submit_indices:
            kind = "submit"
        if kind == "submit":
            spec = {
                "command": "true",
                "name": f"loadtest-{i}",
                "mem": float(rng.choice((128, 256, 512, 1024))),
                "cpus": float(rng.choice((0.5, 1, 2))),
                "max_retries": 1,
                **({"pool": pool} if pool else {}),
            }
            ops.append(TrafficOp(offset_s=t, kind=kind, user=user,
                                 spec=spec))
            submit_indices.append(i)
        else:
            ref = int(submit_indices[int(rng.integers(
                len(submit_indices)))])
            ops.append(TrafficOp(offset_s=t, kind=kind, user=user,
                                 ref=ref))
        i += 1
    return ops


def traffic_trace_jobs(ops: list[TrafficOp], *, runtime_ms: int = 1000,
                       mem=None, cpus=None):
    """The simulator view of a rest_traffic_trace: submit ops become
    TraceJobs at their arrival offsets (kills/queries are REST-side
    concerns the trace simulator's completion model doesn't replay), so
    the same seeded load shape drives both the live harness and
    offline sim runs."""
    jobs = []
    for i, op in enumerate(ops):
        if op.kind != "submit":
            continue
        jobs.append(TraceJob(
            uuid=f"traffic-{i:06d}",
            user=op.user,
            submit_time_ms=int(op.offset_s * 1000),
            runtime_ms=runtime_ms,
            mem=float(mem if mem is not None else op.spec["mem"]),
            cpus=float(cpus if cpus is not None else op.spec["cpus"]),
            pool=op.spec.get("pool", "default"),
        ))
    return jobs


def run_load(url: str, config: LoadConfig, *,
             wait_timeout_s: float = 120.0,
             log=lambda *a: None) -> LoadReport:
    """Replay the workload against a live deployment and wait for every
    job to finish."""
    workload = generate_workload(config)
    clients = [JobClient(url, user=f"user{u}")
               for u in range(config.n_users)]
    report = LoadReport()
    submitted: dict[str, float] = {}  # uuid -> submit wall time
    start = time.time()

    i = 0
    while i < len(workload):
        now = time.time() - start
        due = []
        while i < len(workload) and workload[i][0] <= now \
                and len(due) < config.batch_max:
            due.append(workload[i][1])
            i += 1
        if not due:
            time.sleep(min(workload[i][0] - now, 0.05))
            continue
        client = clients[i % len(clients)]
        t0 = time.time()
        uuids = client.submit(due)
        report.submit_latency_ms.append((time.time() - t0) * 1000)
        for uuid in uuids:
            submitted[uuid] = time.time()
        report.submitted += len(uuids)
        if report.submitted % 100 == 0:
            log(f"submitted {report.submitted}/{config.n_jobs}")

    # wait for completion, recording time-to-first-instance; every poll
    # sweep covers the ENTIRE pending set (batched requests), or jobs
    # beyond the first window would get inflated schedule latencies and
    # a wedged prefix would starve the rest
    deadline = time.time() + wait_timeout_s
    pending = set(submitted)
    poll_client = clients[0]
    while pending and time.time() < deadline:
        snapshot = list(pending)
        for batch_start in range(0, len(snapshot), 256):
            for job in poll_client.query(
                    snapshot[batch_start:batch_start + 256]):
                uuid = job["uuid"]
                if uuid not in report.schedule_latency_ms \
                        and job["instances"]:
                    report.schedule_latency_ms[uuid] = (
                        (time.time() - submitted[uuid]) * 1000)
                if job["status"] == "completed":
                    pending.discard(uuid)
                    if any(i.get("status") == "success"
                           for i in job["instances"]):
                        report.completed += 1
                    else:
                        report.failed += 1
        if pending:
            time.sleep(0.2)
    report.wall_s = time.time() - start
    return report
