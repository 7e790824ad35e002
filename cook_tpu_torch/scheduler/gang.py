"""Topology-aware gang admission: preempt-less drain vs. contiguous kill.

Copy of `cook_tpu/scheduler/gang.py` (jax-free), its imports the port's.
The port's `Scheduler.predictor` is None until the runtime predictor is
ported, so every busy host's drain ETA is unknown and admissions take the
kill path (`_host_states`).

The matcher's gang chokepoint (matcher.py / ops/gang.py) makes gang
placement all-or-nothing, but it can only SAY no — when every topology
block is fragmented, a waiting gang sits at `gang-incomplete` forever
while scalar jobs keep back-filling the very hosts it needs.  This
planner closes the loop from the rebalancer side.  Per cycle it walks
the waiting gangs in queue order and, for each, evaluates every topology
block (the same contiguous host ranges the hierarchical matcher solves):

  * **free** hosts — spare already fits one member;
  * **draining** hosts — busy, but the runtime predictor
    (`QuantileRuntimePredictor.predict_runtime_ms`) expects every task on
    them to complete within `gang_drain_max_wait_ms`;
  * **kill** hosts — busy, freed only by preempting, costing the victims'
    elapsed runtime as wasted work.

If a block's natural drain beats killing — predicted wait under the knob
AND under `gang_drain_wasted_factor` x the wasted-work the kill option
would destroy — the planner chooses PREEMPT-LESS admission: it reserves
the free+draining hosts for the gang (`host_reservations` with a
`gang:<group>` tag every member can claim) and kills nobody; the block
drains into the reservation and the next match places the gang whole.
Otherwise it picks the victim set with the least wasted work INSIDE ONE
BLOCK (contiguous freed capacity, not scattered singles) and the caller
transacts the kills.  Either way the freed/freeing hosts are reserved so
scalar jobs cannot re-fragment the block before the gang lands.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional, Sequence

from cook_tpu_torch.models.entities import Job, Pool, Resources
from cook_tpu_torch.models.store import JobStore

# host_reservations value prefix: a reservation any member of the gang's
# group may claim (matcher feasibility + core release logic understand it)
GANG_RESERVATION_PREFIX = "gang:"


def gang_reservation_tag(group_uuid: str) -> str:
    return GANG_RESERVATION_PREFIX + group_uuid


@dataclass
class GangAdmission:
    """One gang's admission decision for this rebalance cycle."""

    group_uuid: str
    gang_size: int
    leader_uuid: str                  # first member (queue order)
    mode: str                         # "drain" | "preempt"
    block: int                        # block index in the sorted host list
    hosts: list = field(default_factory=list)    # hosts to reserve
    victims: list = field(default_factory=list)  # task ids (preempt mode)
    predicted_wait_ms: float = 0.0    # drain: predicted block-free time
    victim_wasted_s: float = 0.0      # preempt: runtime the kills destroy
    detail: str = ""

    def to_json(self) -> dict:
        return {
            "group": self.group_uuid,
            "gang_size": self.gang_size,
            "mode": self.mode,
            "block": self.block,
            "hosts": list(self.hosts),
            "victims": list(self.victims),
            "predicted_wait_ms": round(self.predicted_wait_ms, 1),
            "victim_wasted_s": round(self.victim_wasted_s, 3),
            "detail": self.detail,
        }


def waiting_gangs(jobs: Sequence[Job]) -> list[tuple[str, list[Job]]]:
    """Whole gangs in the waiting queue, queue order: (group, members)
    for groups whose full complement of `gang_size` members is present.
    A partial complement is not admissible (members-missing) and is left
    to the submit path / next cycles, not to preemption."""
    members: dict[str, list[Job]] = {}
    order: list[str] = []
    for job in jobs:
        if job.gang_size >= 2 and job.group_uuid:
            if job.group_uuid not in members:
                order.append(job.group_uuid)
            members.setdefault(job.group_uuid, []).append(job)
    out = []
    for group in order:
        jobs_g = members[group]
        need = max(j.gang_size for j in jobs_g)
        if len(jobs_g) >= need:
            out.append((group, jobs_g))
    return out


@dataclass
class _HostState:
    hostname: str
    free: bool
    # drain ETA for busy hosts: max predicted-remaining ms across its
    # tasks (inf when any task has no prediction)
    drain_eta_ms: float = 0.0
    # wasted work a kill would destroy: sum of tasks' elapsed seconds
    wasted_s: float = 0.0
    task_ids: list = field(default_factory=list)


def _fits(spare: Optional[Resources], demand: Resources) -> bool:
    if spare is None:
        return False
    return (spare.mem >= demand.mem and spare.cpus >= demand.cpus
            and spare.gpus >= demand.gpus and spare.disk >= demand.disk)


def _member_demand(jobs_g: Sequence[Job]) -> Resources:
    return Resources(
        mem=max(j.resources.mem for j in jobs_g),
        cpus=max(j.resources.cpus for j in jobs_g),
        gpus=max(j.resources.gpus for j in jobs_g),
        disk=max(j.resources.disk for j in jobs_g),
    )


def _host_states(store: JobStore, pool: Pool,
                 host_spare: dict, demand: Resources,
                 predictor, now_ms: float) -> dict[str, _HostState]:
    """Classify every pool host as free / draining-in-eta / kill-cost."""
    by_host: dict[str, _HostState] = {}
    tasks_by_host: dict[str, list] = {}
    for inst in store.running_instances(pool.name):
        if inst.hostname:
            tasks_by_host.setdefault(inst.hostname, []).append(inst)
    for hostname in set(host_spare) | set(tasks_by_host):
        tasks = tasks_by_host.get(hostname, [])
        free = not tasks and _fits(host_spare.get(hostname), demand)
        hs = _HostState(hostname=hostname, free=free)
        if not free and _fits(host_spare.get(hostname), demand):
            # busy but the member already fits beside the running tasks:
            # as good as free for this gang's purposes
            hs.free = True
        if not hs.free:
            eta = 0.0
            for inst in tasks:
                job = store.jobs.get(inst.job_uuid)
                elapsed_ms = max(0.0, now_ms - inst.start_time_ms)
                hs.wasted_s += elapsed_ms / 1000.0
                hs.task_ids.append(inst.task_id)
                pred = None
                if predictor is not None and job is not None:
                    pred = predictor.predict_runtime_ms(job.user,
                                                        job.command)
                if pred is None:
                    eta = math.inf
                else:
                    eta = max(eta, max(0.0, pred - elapsed_ms))
            if not tasks:
                # no running work yet the member does not fit (e.g. the
                # spare map lags a launch): nothing to drain or kill
                eta = math.inf
            hs.drain_eta_ms = eta
        by_host[hostname] = hs
    return by_host


def plan_gang_admissions(
    store: JobStore,
    pool: Pool,
    queue_jobs: Sequence[Job],
    host_spare: dict,
    *,
    nodes_per_block: int,
    predictor,
    params,
    now_ms: float,
    reserved: Optional[set] = None,
) -> list[GangAdmission]:
    """Admission decisions for this cycle's waiting gangs (queue order,
    at most `params.gang_max_admissions`).  `params` is RebalancerParams
    (gang_* knobs).  Pure planning: the caller transacts kills and writes
    the reservations."""
    admissions: list[GangAdmission] = []
    gangs = waiting_gangs(queue_jobs)
    if not gangs:
        return admissions
    reserved = reserved or set()
    taken: set[str] = set(reserved)  # hosts claimed by earlier decisions
    for group, jobs_g in gangs:
        if len(admissions) >= params.gang_max_admissions:
            break
        k = max(j.gang_size for j in jobs_g)
        demand = _member_demand(jobs_g)
        states = _host_states(store, pool, host_spare, demand, predictor,
                              now_ms)
        hostnames = sorted(states)
        npb = nodes_per_block if nodes_per_block > 0 else max(
            1, len(hostnames))
        # evaluate each block: how would the gang get k distinct hosts?
        best = None  # (deficit, cost, block, plan)
        n_blocks = (len(hostnames) + npb - 1) // npb
        for b in range(n_blocks):
            block_hosts = hostnames[b * npb:(b + 1) * npb]
            if len(block_hosts) < k:
                continue
            free = [h for h in block_hosts
                    if states[h].free and h not in taken]
            busy = [h for h in block_hosts
                    if not states[h].free and h not in taken]
            if len(free) >= k:
                continue  # the matcher can already place here; no action
            deficit = k - len(free)
            if len(busy) < deficit:
                continue
            drain_pick = sorted(
                busy, key=lambda h: (states[h].drain_eta_ms,
                                     states[h].wasted_s, h))[:deficit]
            drain_wait = max(states[h].drain_eta_ms for h in drain_pick)
            kill_pick = sorted(
                busy, key=lambda h: (states[h].wasted_s, h))[:deficit]
            kill_wasted = sum(states[h].wasted_s for h in kill_pick)
            cost = min(drain_wait,
                       kill_wasted * 1000.0 if kill_wasted else 0.0)
            cand = (deficit, cost, b, free, drain_pick, drain_wait,
                    kill_pick, kill_wasted)
            if best is None or cand[:3] < best[:3]:
                best = cand
        if best is None:
            continue
        (deficit, _cost, b, free, drain_pick, drain_wait, kill_pick,
         kill_wasted) = best
        drain_ok = (drain_wait <= params.gang_drain_max_wait_ms
                    and drain_wait <= (params.gang_drain_wasted_factor
                                       * kill_wasted * 1000.0))
        leader = jobs_g[0]
        if drain_ok:
            hosts = sorted(free[:k - deficit] + drain_pick)
            adm = GangAdmission(
                group_uuid=group, gang_size=k, leader_uuid=leader.uuid,
                mode="drain", block=b, hosts=hosts,
                predicted_wait_ms=drain_wait,
                detail=(f"block {b} drains in ~{drain_wait / 1000.0:.1f}s"
                        f" (< killing {kill_wasted:.1f}s of work)"))
        else:
            victims = []
            for h in kill_pick:
                victims.extend(states[h].task_ids)
            hosts = sorted(free[:k - deficit] + kill_pick)
            adm = GangAdmission(
                group_uuid=group, gang_size=k, leader_uuid=leader.uuid,
                mode="preempt", block=b, hosts=hosts, victims=victims,
                victim_wasted_s=kill_wasted,
                detail=(f"freeing {deficit} host(s) in block {b} "
                        f"(drain predicted {drain_wait / 1000.0:.1f}s, "
                        f"over budget)"))
        taken.update(adm.hosts)
        admissions.append(adm)
    return admissions
