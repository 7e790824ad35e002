"""The benchmark's scheduling cycle, frozen here so the yardstick does not
move when the program does.

It keeps the simulator's cycle order (`cook_tpu_torch/sim/simulator.py`):
advance the virtual clock, flush the completions that are due, submit
the arrivals that are due, rank every pool, match (pool by pool, or one
pool-batched pass), rebalance every pool where the traffic asks for it.
Each step is timed on the host clock and, in a traced run, wrapped in a
profiler span named `bench.<step>`.  What each cycle produced is kept
for the reference, which reads it once the window has closed.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class CycleRecord:
    """One cycle: its virtual time, what arrived, the host-clock walls of
    its steps, and what the program produced (the ranked queues, the
    match outcomes, the preemption decisions)."""

    index: int
    t_ms: int
    arrivals: list = field(default_factory=list)
    walls: dict = field(default_factory=dict)
    queues: dict = field(default_factory=dict)     # pool -> [Job] ranked
    outcomes: dict = field(default_factory=dict)   # pool -> MatchOutcome
    decisions: dict = field(default_factory=dict)  # pool -> [Decision]

    def launched(self) -> dict[str, int]:
        return {pool: len(out.launched_task_ids)
                for pool, out in self.outcomes.items()}


class Loop:
    """Drives the cycles of one run: `deployment` is the program under
    test, `traffic` the generator, `span` a context-manager factory taking
    a step name (a profiler span in a traced run)."""

    def __init__(self, deployment, traffic, *, batched: bool, span=None):
        self.dep = deployment
        self.traffic = traffic
        self.batched = batched and len(deployment.pools) > 1
        self.span = span or (lambda name: contextlib.nullcontext())
        self.cycles: list[CycleRecord] = []

    def cycle(self) -> CycleRecord:
        dep, sched = self.dep, self.dep.scheduler
        span, clock = self.span, time.perf_counter
        prev = self.cycles[-1].launched() if self.cycles else None
        rec = CycleRecord(index=len(self.cycles),
                          t_ms=dep.now_ms + self.traffic.cycle_ms)
        t0 = clock()
        # 1. the virtual clock; 2. completions; 3. arrivals
        dep.now_ms = rec.t_ms
        rec.arrivals = self.traffic.due(dep.now_ms, prev)
        jobs = dep.jobs(rec.arrivals)
        t1 = clock()
        with span("bench.submit"):
            dep.cluster.advance_to(dep.now_ms)
            if jobs:
                dep.store.submit_jobs(jobs)
        t2 = clock()
        # 4. rank every pool
        with span("bench.rank"):
            for pool in dep.pools:
                rec.queues[pool.name] = sched.rank_cycle(pool).jobs
        t3 = clock()
        # 5. match
        with span("bench.match"):
            if self.batched:
                rec.outcomes = sched.match_cycle_all_pools()
            else:
                for pool in dep.pools:
                    rec.outcomes[pool.name] = sched.match_cycle(pool)
        t4 = clock()
        # 6. rebalance
        if self.traffic.rebalance:
            with span("bench.rebalance"):
                for pool in dep.pools:
                    rec.decisions[pool.name] = sched.rebalance_cycle(pool)
        t5 = clock()
        rec.walls = {"generate": t1 - t0, "submit": t2 - t1,
                     "rank": t3 - t2, "match": t4 - t3,
                     "rebalance": t5 - t4, "total": t5 - t0}
        self.cycles.append(rec)
        return rec
