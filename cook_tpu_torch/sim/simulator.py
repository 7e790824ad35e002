"""Faster-than-real-time trace simulator: the framework's acceptance rig.

Port of `cook_tpu/sim/simulator.py`: drive the REAL scheduler against the
in-memory mock backend with frozen, manually-advanced virtual time; each
cycle is: flush completions -> submit due jobs -> rank -> match ->
[rebalance, every `rebalance_every` cycles], pool by pool, or with
`SimConfig.batched_match` every pool's rank, then ONE pool-batched match
pass (`Scheduler.match_cycle_all_pools`), then the rebalances.  Inputs
are a job trace + host list (the same JSON both packages read); output is
a run trace (job, task, submit/start/end, host, status) whose CSV is
byte-compatible with the reference's, so `sim.cli compare` works across
the two packages.  Per-phase wall times are recorded beside the decisions,
and the fairness observatory's snapshot (preemption ledger, rollups,
trajectories) at the end of the run.

Gang traces (`TraceJob.gang`) submit each gang as one atomic batch under
a UNIQUE group, the members' submit times aligned to the gang's latest
(the store vetoes a gang split over batches), and `SimResult.gang_stats`
summarizes assembly wait and block spread.

At the scheduler's default configuration a run also dumps the flight
recorder's cycle records (`SimResult.cycle_records`, one per match cycle,
the reference's schema), the device-telemetry health verdict at the end
(`SimResult.health`; evaluated every `SimConfig.health_every` cycles
during the run too, each in-run verdict kept in `health_checks`) and the
data-plane summary (`SimResult.data_plane`: the run's H2D/D2H bytes, per
family as well, and the mean rebuild fraction and padding waste off the
records).  `phase_wall_s["submit"]` is the submit step's wall: the store's
event fan-out, where the columnar index and the encode cache keep up.
`SimConfig.resident` turns device residency on; `SimConfig.speculate`
turns speculative match cycles on with the horizon pinned to one cycle
(`SimResult.speculation_stats`: hit fraction and pre-launch p50, and a
`speculation_commit` wall in `phase_wall_s` when a speculator runs).
`SimConfig.elastic_every` turns the elastic capacity plane on and plans
every that many cycles after the match (and rebalance) step, its wall in
`phase_wall_s["elastic"]`; `SimResult.elastic_plans` holds the planner's
decisions and `capacity_ledger` the final loan ledger.
`SimConfig.fault_schedule` arms a fault schedule (the reference's
`FaultSchedule.from_dict` shape) for the duration of `run()`, restoring
any schedule armed around it; the in-run health verdicts feed the
scheduler's incident recorder (its cooldown zeroed, so every
ok->degraded transition of the virtual run is captured:
`SimResult.incidents`); `SimConfig.history_every` samples an
`obs/tsdb.MetricsHistory` on the virtual clock every that many cycles
(`SimResult.metrics_history`: the raw and 10-minute dumps).
"""
from __future__ import annotations

import csv
import dataclasses
import io
import json
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from cook_tpu_torch import faults
from cook_tpu_torch.cluster.mock import MockCluster, MockHost
from cook_tpu_torch.models.entities import (
    DruMode,
    Group,
    GroupPlacementType,
    HostPlacement,
    Job,
    Pool,
    Resources,
)
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.obs import data_plane as _dp
from cook_tpu_torch.obs.tsdb import HistoryConfig, MetricsHistory
from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
from cook_tpu_torch.scheduler.flight_recorder import FlightRecorder
from cook_tpu_torch.scheduler.prediction import pre_launch_ms
from cook_tpu_torch.utils.tracing import span


@dataclass
class TraceJob:
    """One job in the input trace."""

    uuid: str
    user: str
    submit_time_ms: int
    runtime_ms: int
    mem: float
    cpus: float
    gpus: float = 0.0
    priority: int = 50
    pool: str = "default"
    # gang tag (one member of the named gang): members of a gang of two or
    # more submit together as gang_size=k jobs of one UNIQUE group
    gang: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "TraceJob":
        return cls(
            uuid=str(d["uuid"]),
            user=d["user"],
            submit_time_ms=int(d["submit_time_ms"]),
            runtime_ms=int(d["runtime_ms"]),
            mem=float(d["mem"]),
            cpus=float(d["cpus"]),
            gpus=float(d.get("gpus", 0.0)),
            priority=int(d.get("priority", 50)),
            pool=d.get("pool", "default"),
            gang=str(d.get("gang", "")),
        )


@dataclass
class TraceHost:
    node_id: str
    hostname: str
    mem: float
    cpus: float
    gpus: float = 0.0
    pool: str = "default"
    attributes: tuple = ()

    @classmethod
    def from_dict(cls, d: dict) -> "TraceHost":
        return cls(
            node_id=str(d["node_id"]),
            hostname=d.get("hostname", str(d["node_id"])),
            mem=float(d["mem"]),
            cpus=float(d["cpus"]),
            gpus=float(d.get("gpus", 0.0)),
            pool=d.get("pool", "default"),
            attributes=tuple(sorted(d.get("attributes", {}).items())),
        )


@dataclass
class SimConfig:
    cycle_ms: int = 30_000           # virtual time per cycle
    rebalance_every: int = 0         # cycles between rebalances (0 = off)
    max_cycles: int = 10_000
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    pools: tuple = (("default", "default"),)  # (name, dru_mode)
    batched_match: bool = False      # one device call for all pools
    # cycles between elastic capacity plans (0 = off); setting this
    # enables the scheduler's capacity plane (cook_tpu_torch/elastic/)
    elastic_every: int = 0
    # device-resident match state (scheduler/device_state.py): keep the
    # encode tensors on the device across cycles with O(delta) updates —
    # sets the scheduler's MatchConfig.device_residency knob
    resident: bool = False
    # prediction-assisted speculative cycles (scheduler/prediction.py):
    # enables the scheduler's speculator with the horizon pinned to ONE
    # sim cycle — a running task predicted to finish by the next cycle's
    # clock is assumed complete by the speculative solve
    speculate: bool = False
    # fault-injection schedule (faults.FaultSchedule.from_dict shape:
    # {"seed": .., "rules": [{"point": .., "mode": .., ...}]}), armed for
    # the duration of run()
    fault_schedule: Optional[dict] = None
    # cycles between in-run health evaluations (0 = end-of-run only); each
    # verdict reports to the scheduler's incident recorder
    health_every: int = 4
    # cycles between metrics-history sample ticks on the virtual clock
    # (obs/tsdb.MetricsHistory; 0 = off)
    history_every: int = 0


@dataclass
class SimResult:
    rows: list[dict]                 # run trace
    cycles: int
    virtual_ms: int
    phase_wall_s: dict[str, float]
    cycle_wall_s: list[float]        # per-cycle total scheduling wall time
    # fairness observatory snapshot at end of run (per-pool Jain index,
    # DRU trajectories, preemption ledger + wasted-work rollups), so a
    # trace replay reports the same fairness numbers as the reference
    fairness: dict = field(default_factory=dict)
    # flight-recorder dump: one structured record per match cycle (per-
    # phase durations, per-job reason codes, preemptions), the
    # reference's schema
    cycle_records: list[dict] = field(default_factory=list)
    # device-telemetry health verdict at end of run (the reference's
    # schema): did the run drive the solver into recompile storms /
    # quality drift / latency regression?
    health: dict = field(default_factory=dict)
    # the in-run verdicts (every `health_every` cycles): {"cycle",
    # "status", "reasons"} each; each also reached the incident recorder
    # (`incidents`)
    health_checks: list[dict] = field(default_factory=list)
    # device data-plane summary: H2D/D2H byte deltas this run moved
    # (process-ledger delta) in total and per family, plus the mean
    # rebuild_fraction / padding_waste off the cycle records
    data_plane: dict = field(default_factory=dict)
    # elastic capacity-plane dump: the planner's decisions (the
    # recorder's `records_json` schema) + the final loan ledger
    elastic_plans: list[dict] = field(default_factory=list)
    capacity_ledger: list[dict] = field(default_factory=list)
    # incident bundles captured during the run (full evidence)
    incidents: list[dict] = field(default_factory=list)
    # the metrics history sampled on the virtual clock (history_every >
    # 0): {"raw": query dump, "10m": query dump}
    metrics_history: dict = field(default_factory=dict)

    def queued_wait_ms(self) -> list[int]:
        """Per-started-task queued wait (start - submit): the metric the
        elastic A/B compares (lower p50 with loaning enabled)."""
        return [r["start_ms"] - r["submit_ms"] for r in self.rows
                if r["start_ms"] is not None]

    def speculation_stats(self) -> dict:
        """Speculation A/B summary off the cycle records: the fraction of
        job-considering cycles served from a committed speculative solve
        and the cycle-start-to-first-launch p50 (the latency speculation
        exists to lower; prediction.PRE_LAUNCH_PHASES)."""
        active = [r for r in self.cycle_records if r.get("considered")]
        hits = sum(1 for r in active if r.get("speculation") == "hit")
        latencies = sorted(pre_launch_ms(r) for r in active)
        return {
            "cycles": len(active),
            "hits": hits,
            "hit_fraction": hits / len(active) if active else 0.0,
            "pre_launch_p50_ms": (latencies[len(latencies) // 2]
                                  if latencies else 0.0),
        }

    def cycle_records_json(self) -> str:
        """The flight-recorder dump `sim.cli run --cycles-out` writes:
        {"cycles": [...]}, the GET /debug/cycles schema."""
        return json.dumps({"cycles": self.cycle_records}, indent=1)

    def gang_stats(self, jobs: Sequence["TraceJob"],
                   hosts: Sequence["TraceHost"] = (),
                   *, nodes_per_block: int = 0) -> dict:
        """Gang A/B summary off the run trace:

        - a gang is *assembled* when all k members were RUNNING at the
          same virtual instant (a member still running when the run ends
          counts as running to its end);
        - ``wait_ms`` is assembly time minus submit; unassembled gangs
          score the full simulated span;
        - ``block_spread`` is how many topology blocks the gang's members
          landed on (1 = contiguous).  Blocks are `nodes_per_block`
          chunks of the sorted hostname list, the matcher's
          decomposition."""
        by_gang: dict[str, list] = {}
        for tj in jobs:
            if getattr(tj, "gang", ""):
                by_gang.setdefault(tj.gang, []).append(tj)
        by_gang = {g: ms for g, ms in by_gang.items() if len(ms) >= 2}
        if not by_gang:
            return {"gangs": 0, "assembled": 0, "assembled_share": 0.0,
                    "wait_ms_p50": 0.0, "mean_block_spread": 0.0,
                    "per_gang": []}
        names = sorted(h.hostname for h in hosts)
        npb = nodes_per_block if nodes_per_block > 0 else max(len(names), 1)
        block_of = {h: i // npb for i, h in enumerate(names)}
        runs: dict[str, list[dict]] = {}
        for r in self.rows:
            if r["start_ms"] is not None:
                runs.setdefault(r["job_uuid"], []).append(r)
        per_gang = []
        for g, members in sorted(by_gang.items()):
            submit = min(m.submit_time_ms for m in members)
            last = [max(runs[m.uuid], key=lambda r: r["start_ms"])
                    for m in members if m.uuid in runs]
            spread = len({block_of.get(r["host"], -1) for r in last}) \
                if last else 0
            assembled_at = None
            if len(last) == len(members):
                start = max(r["start_ms"] for r in last)
                # a run still going at the end has end_ms 0 (the
                # instance's unset end time): it runs to the span's end
                # (the reference tests `is not None`, so it never counts a
                # gang still running at the end as assembled)
                end = min(r["end_ms"] or self.virtual_ms for r in last)
                if start < end:
                    assembled_at = start
            per_gang.append({
                "gang": g,
                "size": len(members),
                "placed_members": len(last),
                "block_spread": spread,
                "assembled": assembled_at is not None,
                "wait_ms": (assembled_at - submit)
                if assembled_at is not None else None,
            })
        waits = sorted(
            d["wait_ms"] if d["wait_ms"] is not None else self.virtual_ms
            for d in per_gang
        )
        spreads = [d["block_spread"] for d in per_gang
                   if d["placed_members"]]
        assembled = sum(1 for d in per_gang if d["assembled"])
        return {
            "gangs": len(per_gang),
            "assembled": assembled,
            "assembled_share": assembled / len(per_gang),
            "wait_ms_p50": float(waits[len(waits) // 2]),
            "mean_block_spread": (sum(spreads) / len(spreads)
                                  if spreads else 0.0),
            "per_gang": per_gang,
        }

    def utilization(self, hosts: Sequence[TraceHost]) -> float:
        """Fraction of total cpu-ms capacity actually used by completed
        work over the simulated span."""
        cap = sum(h.cpus for h in hosts) * max(self.virtual_ms, 1)
        used = sum(
            r["cpus"] * max(0, (r["end_ms"] or 0) - (r["start_ms"] or 0))
            for r in self.rows
            if r["start_ms"] is not None
        )
        return used / cap if cap else 0.0

    def to_csv(self) -> str:
        buf = io.StringIO()
        writer = csv.DictWriter(
            buf,
            fieldnames=[
                "job_uuid", "task_id", "user", "mem", "cpus", "gpus",
                "submit_ms", "start_ms", "end_ms", "host", "status",
            ],
        )
        writer.writeheader()
        for r in self.rows:
            writer.writerow({k: r[k] for k in writer.fieldnames})
        return buf.getvalue()


class Simulator:
    def __init__(self, jobs: Sequence[TraceJob], hosts: Sequence[TraceHost],
                 config: Optional[SimConfig] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        # gang members must land in ONE store submit batch (the store's
        # gang validation): align every member to the gang's latest submit
        # time so the due-jobs sweep picks them up together
        self._gang_size: dict[str, int] = {}
        gang_due: dict[str, int] = {}
        for j in jobs:
            if j.gang:
                self._gang_size[j.gang] = self._gang_size.get(j.gang, 0) + 1
                gang_due[j.gang] = max(gang_due.get(j.gang, 0),
                                       j.submit_time_ms)
        if self._gang_size:
            jobs = [
                dataclasses.replace(j, submit_time_ms=gang_due[j.gang])
                if j.gang and self._gang_size[j.gang] >= 2 else j
                for j in jobs
            ]
        self.trace_jobs = sorted(jobs, key=lambda j: (j.submit_time_ms, j.uuid))
        self.trace_hosts = list(hosts)
        self.config = config or SimConfig()
        self.now_ms = 0

        # pools: configured list extended by any pool the trace mentions
        pool_names = {name for name, _ in self.config.pools}
        extra = sorted(
            ({j.pool for j in jobs} | {h.pool for h in hosts}) - pool_names
        )
        self.config.pools = tuple(self.config.pools) + tuple(
            (name, "default") for name in extra
        )
        if self.config.elastic_every > 0 \
                and not self.config.scheduler.elastic.enabled:
            # copies: the caller's configurations stay as they were given
            sched = self.config.scheduler
            self.config = dataclasses.replace(
                self.config, scheduler=dataclasses.replace(
                    sched, elastic=dataclasses.replace(
                        sched.elastic, enabled=True)))
        if self.config.resident:
            # copies: the caller's configurations stay as they were given
            sched = self.config.scheduler
            self.config = dataclasses.replace(
                self.config, scheduler=dataclasses.replace(
                    sched, match=dataclasses.replace(
                        sched.match, device_residency=True)))
        if self.config.speculate:
            # completions flush exactly one cycle_ms ahead: predict to
            # that horizon (a wider one would assume completions the next
            # cycle won't see yet — a guaranteed prediction-miss)
            self.config = dataclasses.replace(
                self.config, scheduler=dataclasses.replace(
                    self.config.scheduler, speculation=True,
                    speculation_horizon_ms=float(self.config.cycle_ms)))
        self.store = JobStore(clock=lambda: self.now_ms)
        for name, mode in self.config.pools:
            self.store.set_pool(Pool(name=name, dru_mode=DruMode(mode)))
        self.cluster = MockCluster(
            "sim",
            [
                MockHost(
                    node_id=h.node_id,
                    hostname=h.hostname,
                    mem=h.mem,
                    cpus=h.cpus,
                    gpus=h.gpus,
                    attributes=h.attributes,
                    pool=h.pool,
                )
                for h in hosts
            ],
            clock=lambda: self.now_ms,
        )
        self.scheduler = Scheduler(
            self.store, [self.cluster], self.config.scheduler, device=device
        )
        # the capture cooldown is a real-time flood guard; a run compresses
        # hours of virtual time into seconds, so the default would drop
        # every incident after the first
        self.scheduler.incidents.cooldown_s = 0.0
        if self.scheduler.recorder is not None:
            # the service default ring (512) would silently truncate the
            # offline dump: size it to hold every cycle of every pool this
            # run can produce
            wanted = min(self.config.max_cycles
                         * max(1, len(self.config.pools)), 1_000_000)
            if wanted > self.scheduler.recorder.capacity:
                self.scheduler.recorder = FlightRecorder(capacity=wanted)

    def run(self) -> SimResult:
        cfg = self.config
        prev = faults.ACTIVE  # restore, don't disarm: a caller may run
        if cfg.fault_schedule:  # the simulator inside faults.injected()
            faults.arm(faults.FaultSchedule.from_dict(cfg.fault_schedule))
        try:
            return self._run()
        finally:
            if cfg.fault_schedule:
                if prev is not None:
                    faults.arm(prev)
                else:
                    faults.disarm()

    def _run(self) -> SimResult:
        cfg = self.config
        history = None
        if cfg.history_every:
            # points stamp in simulated seconds, so the dump lines up with
            # the trace's timeline instead of the host clock
            history = MetricsHistory(
                config=HistoryConfig(sample_s=0),
                clock=lambda: self.now_ms / 1000.0)
        families0 = _dp.LEDGER.family_totals()
        health_checks: list[dict] = []
        submitted = 0
        # submit (the store's event fan-out), rank and match, then
        # match's own split into encode / solve / launch
        # (MatchOutcome.phase_wall_s), a hierarchical solve's split of
        # solve into coarse_solve / fine_solve / refine, and rebalance
        # when it runs
        phase_wall: dict[str, float] = {"submit": 0.0, "rank": 0.0,
                                        "match": 0.0, "encode": 0.0,
                                        "solve": 0.0, "launch": 0.0}
        if cfg.rebalance_every:
            phase_wall["rebalance"] = 0.0
        if cfg.elastic_every:
            phase_wall["elastic"] = 0.0
        cycle_wall: list[float] = []
        pools = [self.store.pools[name] for name, _ in cfg.pools]
        cycle = 0
        while cycle < cfg.max_cycles:
            cycle += 1
            # 1. flush completions at current virtual time
            self.cluster.advance_to(self.now_ms)
            # 2. submit due jobs, one batch per cycle, so gang members
            # (aligned to a shared submit time in __init__) arrive in one
            # atomic store transaction with their UNIQUE group
            due: list[TraceJob] = []
            while (
                submitted < len(self.trace_jobs)
                and self.trace_jobs[submitted].submit_time_ms <= self.now_ms
            ):
                due.append(self.trace_jobs[submitted])
                submitted += 1
            if due:
                groups: dict[str, Group] = {}
                batch = []
                for tj in due:
                    k = self._gang_size.get(tj.gang, 0) if tj.gang else 0
                    if k >= 2 and tj.gang not in self.store.groups \
                            and tj.gang not in groups:
                        groups[tj.gang] = Group(
                            uuid=tj.gang,
                            name=f"gang-{tj.gang}",
                            host_placement=HostPlacement(
                                type=GroupPlacementType.UNIQUE),
                        )
                    batch.append(Job(
                        uuid=tj.uuid,
                        user=tj.user,
                        pool=tj.pool,
                        priority=tj.priority,
                        resources=Resources(mem=tj.mem, cpus=tj.cpus,
                                            gpus=tj.gpus),
                        expected_runtime_ms=tj.runtime_ms,
                        command="sim",
                        max_retries=5,
                        group_uuid=tj.gang if k >= 2 else None,
                        gang_size=k if k >= 2 else 0,
                    ))
                t_submit = time.perf_counter()
                self.store.submit_jobs(batch, list(groups.values()))
                phase_wall["submit"] += time.perf_counter() - t_submit
            # 3. rank -> match (-> rebalance) per pool, or every pool's
            # rank, then one pool-batched match pass, then the rebalances
            t_cycle = time.perf_counter()
            rebalance = (cfg.rebalance_every
                         and cycle % cfg.rebalance_every == 0)
            if cfg.batched_match and len(pools) > 1:
                t0 = time.perf_counter()
                for pool in pools:
                    with span("sim.rank", pool=pool.name):
                        self.scheduler.rank_cycle(pool)
                t1 = time.perf_counter()
                with span("sim.match_batched", pools=len(pools)):
                    outcomes = self.scheduler.match_cycle_all_pools()
                t2 = time.perf_counter()
                phase_wall["rank"] += t1 - t0
                phase_wall["match"] += t2 - t1
                for outcome in outcomes.values():
                    for name, wall in outcome.phase_wall_s.items():
                        phase_wall[name] = phase_wall.get(name, 0.0) + wall
                if rebalance:
                    for pool in pools:
                        with span("sim.rebalance", pool=pool.name):
                            self.scheduler.rebalance_cycle(pool)
                    phase_wall["rebalance"] += time.perf_counter() - t2
            else:
                for pool in pools:
                    t0 = time.perf_counter()
                    with span("sim.rank", pool=pool.name):
                        self.scheduler.rank_cycle(pool)
                    t1 = time.perf_counter()
                    with span("sim.match", pool=pool.name):
                        outcome = self.scheduler.match_cycle(pool)
                    t2 = time.perf_counter()
                    phase_wall["rank"] += t1 - t0
                    phase_wall["match"] += t2 - t1
                    for name, wall in outcome.phase_wall_s.items():
                        phase_wall[name] = phase_wall.get(name, 0.0) + wall
                    if rebalance:
                        t3 = time.perf_counter()
                        with span("sim.rebalance", pool=pool.name):
                            self.scheduler.rebalance_cycle(pool)
                        phase_wall["rebalance"] += time.perf_counter() - t3
            # 3b. elastic capacity plan (after matching, so demand is the
            # genuinely-unmatched queue; loans land in the NEXT cycle's
            # offers — node-provisioning latency, one cycle coarse)
            if (cfg.elastic_every and cycle % cfg.elastic_every == 0
                    and self.scheduler.elastic is not None):
                t3 = time.perf_counter()
                with span("sim.elastic"):
                    self.scheduler.elastic_cycle()
                phase_wall["elastic"] += time.perf_counter() - t3
            cycle_wall.append(time.perf_counter() - t_cycle)
            # 3c. in-run health watch
            if (cfg.health_every and cycle % cfg.health_every == 0
                    and self.scheduler.telemetry is not None):
                verdict = self.scheduler.telemetry.health()
                health_checks.append({"cycle": cycle,
                                      "status": verdict["status"],
                                      "reasons": verdict["reasons"]})
            # 3d. metrics-history tick on the virtual clock
            if history is not None and cycle % cfg.history_every == 0:
                history.sample_once()
            # 4. advance virtual time
            self.now_ms += cfg.cycle_ms
            # stop when all work is done
            if submitted == len(self.trace_jobs):
                all_done = all(
                    self.store.jobs[j.uuid].state.value == "completed"
                    for j in self.trace_jobs
                )
                if all_done:
                    break
        # final flush so trailing completions land in the trace
        self.cluster.advance_to(self.now_ms)
        recorder = self.scheduler.recorder
        records = (recorder.records_json(limit=recorder.capacity)
                   if recorder is not None else [])
        return SimResult(
            rows=self._collect_rows(),
            cycles=cycle,
            virtual_ms=self.now_ms,
            phase_wall_s=phase_wall,
            cycle_wall_s=cycle_wall,
            fairness=self.scheduler.fairness.snapshot(),
            cycle_records=records,
            health=(self.scheduler.telemetry.health()
                    if self.scheduler.telemetry is not None else {}),
            health_checks=health_checks,
            data_plane=_data_plane_summary(families0, records),
            elastic_plans=(
                self.scheduler.elastic.recorder.records_json(limit=10_000)
                if self.scheduler.elastic is not None else []),
            capacity_ledger=self.store.encoded_capacity_ledger(),
            incidents=self.scheduler.incidents.dump(),
            metrics_history=(
                {"raw": history.query("*"),
                 "10m": history.query("*", step="10m")}
                if history is not None else {}),
        )

    def _collect_rows(self) -> list[dict]:
        # a job the run never submitted (max_cycles ended first) has no
        # instances and reports "unscheduled"; the reference raises
        # KeyError there (its sim/simulator.py:597)
        rows = []
        for tj in self.trace_jobs:
            insts = self.store.job_instances(tj.uuid)
            if not insts:
                rows.append(self._row(tj, None))
            for inst in insts:
                rows.append(self._row(tj, inst))
        return rows

    def _row(self, tj: TraceJob, inst) -> dict:
        return {
            "job_uuid": tj.uuid,
            "task_id": inst.task_id if inst else "",
            "user": tj.user,
            "mem": tj.mem,
            "cpus": tj.cpus,
            "gpus": tj.gpus,
            "submit_ms": tj.submit_time_ms,
            "start_ms": inst.start_time_ms if inst else None,
            "end_ms": inst.end_time_ms if inst else None,
            "host": inst.hostname if inst else "",
            "status": inst.status.value if inst else "unscheduled",
        }


def _data_plane_summary(families0: dict, records: list[dict]) -> dict:
    """The run's data-plane numbers: the process ledger's byte deltas
    since `families0` (in total and per family; concurrent simulators in
    one process would overlap) and the mean rebuild fraction / padding
    waste off the cycle records, and the device-residency attribution off
    the same records (how many match cycles rode O(delta) updates vs full
    rebuilds, and the rows scattered): the reference's `data_plane` keys,
    plus `families`."""
    families = {}
    for fam, now in _dp.LEDGER.family_totals().items():
        before = families0.get(fam, {})
        delta = {k: v - before.get(k, 0) for k, v in now.items()}
        if any(delta.values()):
            families[fam] = delta
    rebuilds = [r["rebuild_fraction"] for r in records
                if r.get("rebuild_fraction") is not None]
    wastes = [r["padding_waste"] for r in records
              if r.get("padding_waste") is not None]
    ds_records = [r["device_state"] for r in records
                  if r.get("device_state")]
    return {
        "h2d_bytes": sum(f["h2d_bytes"] for f in families.values()),
        "d2h_bytes": sum(f["d2h_bytes"] for f in families.values()),
        "mean_rebuild_fraction": (sum(rebuilds) / len(rebuilds)
                                  if rebuilds else None),
        "mean_padding_waste": (sum(wastes) / len(wastes)
                               if wastes else None),
        "device_state": {
            "cycles": len(ds_records),
            "rebuilds": sum(1 for d in ds_records if d.get("rebuild")),
            "delta_cycles": sum(1 for d in ds_records
                                if not d.get("rebuild")),
            "delta_rows": sum(d.get("delta_rows", 0) for d in ds_records
                              if not d.get("rebuild")),
            "resident_bytes": (ds_records[-1].get("resident_bytes", 0)
                               if ds_records else 0),
        },
        "families": families,
    }


def load_trace(path: str) -> tuple[list[TraceJob], list[TraceHost]]:
    with open(path) as f:
        data = json.load(f)
    return (
        [TraceJob.from_dict(d) for d in data["jobs"]],
        [TraceHost.from_dict(d) for d in data["hosts"]],
    )


def synth_trace(
    n_jobs: int,
    n_hosts: int,
    *,
    n_users: int = 10,
    seed: int = 0,
    mean_runtime_ms: int = 120_000,
    submit_span_ms: int = 300_000,
    host_mem: float = 64_000.0,
    host_cpus: float = 32.0,
    pool: str = "default",
) -> tuple[list[TraceJob], list[TraceHost]]:
    """Deterministic synthetic workload with a skewed user mix (the shape of
    the reference benchmark's 50k-job generator, benchmark.clj:37-77); the
    same seed gives the same trace as the reference's `synth_trace`."""
    rng = np.random.default_rng(seed)
    user_weights = rng.zipf(1.5, size=n_users).astype(float)
    user_weights /= user_weights.sum()
    jobs = []
    for i in range(n_jobs):
        user = int(rng.choice(n_users, p=user_weights))
        jobs.append(
            TraceJob(
                uuid=f"job-{i:07d}",
                user=f"user{user}",
                submit_time_ms=int(rng.integers(0, submit_span_ms)),
                runtime_ms=int(rng.exponential(mean_runtime_ms)) + 1000,
                mem=float(rng.choice([512, 1024, 2048, 4096, 8192])),
                cpus=float(rng.choice([0.5, 1, 2, 4])),
                priority=int(rng.choice([25, 50, 75])),
                pool=pool,
            )
        )
    hosts = [
        TraceHost(
            node_id=f"node-{i:05d}",
            hostname=f"host-{i:05d}",
            mem=host_mem,
            cpus=host_cpus,
            pool=pool,
        )
        for i in range(n_hosts)
    ]
    return jobs, hosts
