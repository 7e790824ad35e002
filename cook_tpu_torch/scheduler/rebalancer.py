"""The rebalancer: periodic DRU-driven preemption.

Port of `cook_tpu/scheduler/rebalancer.py` (reference: Cook's
rebalancer.clj) — per cycle, walk the top pending jobs in fairness order;
for each, find the preemption decision (host + prefix of highest-DRU
tasks) that frees enough room while maximizing the minimum preempted DRU,
guarded by `safe-dru-threshold` and `min-dru-diff`; simulate the launch so
later decisions see the updated fairness picture; then the caller
transacts the preemptions and kills the victims.

The victim search itself is `ops.rebalance.find_preemption_decision` (one
call scans all tasks x hosts on the device).  This module keeps the
incremental state (`next-state`, rebalancer.clj:270-318) with a fixed-row
layout: every task owns a row in device tensors for the whole cycle;
preemptions flip an eligibility bit, simulated launches fill preallocated
slack rows, and only changed users' DRU rows are rescored and written
back in place (dru.clj:128 `next-task->scored-task`) — so the <=
max_preemption decisions per cycle ship O(changed) bytes, not O(tasks).

With `params.resident` the cycle-start victim tensors come from a
caller-owned device-resident row mirror (`device_state.ResidentRows`,
one row per running task keyed by task id): a task that survived since
the last cycle ships zero bytes.  The classic path uploads them whole,
under the same `rebalance-state` data-plane family.  The elastic
`reclaimer` stays a parameter, None here; the scheduler passes its
device `telemetry`.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional, Sequence, Union

import numpy as np
import torch

from cook_tpu_torch.device import resolve
from cook_tpu_torch.models.entities import DruMode, Instance, Job, Pool, Resources
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.ops.common import BIG, bucket_size, fetch_result
from cook_tpu_torch.ops.rebalance import (
    RebalanceState,
    as_scalar,
    decide_from_sorted,
    find_preemption_decision,
    sort_rebalance_state,
)


@dataclass
class RebalancerParams:
    """Runtime-mutable knobs (reference: Datomic-stored `:rebalancer/config`,
    rebalancer.clj:535-557, docs/rebalancer-config.adoc)."""

    safe_dru_threshold: float = 1.0
    min_dru_diff: float = 0.5
    max_preemption: int = 100
    # fast_cycle sorts the task tensors ONCE per cycle and reuses the
    # order for every decision (ops/rebalance.py decide_from_sorted):
    # ~max_preemption x fewer device sorts per cycle.  DRU values stay
    # LIVE (threshold/min-diff/score exact); the approximations are the
    # frozen within-host prefix ORDER and launches consuming spare
    # instead of joining the preemptable rows
    fast_cycle: bool = False
    # serve the cycle-start victim tensors from a device-resident
    # keyed-row mirror (device_state.ResidentRows, owned by the caller so
    # it outlives every cycle)
    resident: bool = False
    # ---- gang admission (scheduler/gang.py) ----
    # topology-aware whole-gang admission from the rebalance cycle
    # (Scheduler._gang_admission_cycle): drain-vs-kill per block,
    # reservations tagged gang:<group>
    gang_enabled: bool = True
    # gangs admitted (drain or preempt) per rebalance cycle
    gang_max_admissions: int = 4
    # preempt-less admission: wait for a block's natural drain only when
    # the predictor expects it free within this budget...
    gang_drain_max_wait_ms: float = 300_000.0
    # ...AND the wait is under factor x the wasted-work seconds the kill
    # alternative would destroy (1.0 = break even: a second of waiting
    # is worth a second of someone else's destroyed runtime)
    gang_drain_wasted_factor: float = 1.0


@dataclass
class Decision:
    job: Job                      # to make room for
    hostname: str
    task_ids: list[str]           # victims (empty = spare-only)
    min_preempted_dru: float
    # per-victim detail for the fairness ledger, captured at decision
    # time (the cycle state mutates as later decisions apply):
    # [{task_id, user, dru, mem, cpus, gpus}]
    victims: list[dict] = field(default_factory=list)


@dataclass
class _UserTasks:
    """One user's running tasks in feature-vector order."""

    keys: list[tuple] = field(default_factory=list)  # sort keys
    ids: list[str] = field(default_factory=list)     # task ids (sim-* = simulated)
    res: list[tuple] = field(default_factory=list)   # (mem, cpus, gpus, disk)
    rows: list[int] = field(default_factory=list)    # fixed tensor rows
    dru: list[float] = field(default_factory=list)


class RebalanceCycle:
    """State for one pool's rebalance cycle (fixed-row tensor layout)."""

    def __init__(
        self,
        store: JobStore,
        pool: Pool,
        host_spare: dict[str, Resources],
        params: RebalancerParams,
        host_info: Optional[dict[str, tuple[dict, str]]] = None,
        *,
        device: Optional[Union[str, torch.device]] = None,
        resident=None,
    ):
        self.store = store
        self.pool = pool
        self.params = params
        self.device = resolve(device)
        self.host_info = host_info or {}  # hostname -> (attrs, location)
        self.gpu_mode = pool.dru_mode == DruMode.GPU

        # hosts
        self.hostnames = sorted(
            set(host_spare)
            | {
                i.hostname
                for i in store.running_instances(pool.name)
                if i.hostname
            }
        )
        self.host_idx = {h: i for i, h in enumerate(self.hostnames)}
        h = len(self.hostnames)
        # bucket the host axis as the reference does, so both packages
        # solve the same padded shapes; padded rows are host_ok=False
        # with zero spare, so the search can never pick them
        h_pad = bucket_size(max(h, 1))
        spare = np.zeros((h_pad, 4), dtype=np.float32)
        for hostname, res in host_spare.items():
            i = self.host_idx[hostname]
            spare[i] = (res.mem, res.cpus, res.gpus, res.disk)

        # per-user ordered running tasks
        self.users: dict[str, _UserTasks] = {}
        self.task_info: dict[str, tuple[str, str]] = {}  # task id -> (user, host)
        for job in store.running_jobs(pool.name):
            for inst in store.job_instances(job.uuid):
                if inst.status.terminal:
                    continue
                ut = self.users.setdefault(job.user, _UserTasks())
                ut.keys.append(self._task_key(job, inst))
                ut.ids.append(inst.task_id)
                ut.res.append(
                    (job.resources.mem, job.resources.cpus,
                     job.resources.gpus, job.resources.disk)
                )
                self.task_info[inst.task_id] = (job.user, inst.hostname)

        # fixed-row flat layout: all tasks + slack rows for simulated
        # launches, bucketed (pad rows: host -1, ineligible — the shape
        # every task on an unknown host already takes)
        n_tasks = sum(len(ut.ids) for ut in self.users.values())
        total = bucket_size(max(n_tasks + params.max_preemption, 1))
        self.row_ids: list[str] = [""] * total
        host_np = np.full(total, -1, np.int32)
        res_np = np.zeros((total, 4), np.float32)
        self._dru_np = np.zeros(total, np.float32)
        self._elig_np = np.zeros(total, bool)
        row = 0
        for user in sorted(self.users):
            ut = self.users[user]
            order = sorted(range(len(ut.keys)), key=lambda i: ut.keys[i])
            ut.keys = [ut.keys[i] for i in order]
            ut.ids = [ut.ids[i] for i in order]
            ut.res = [ut.res[i] for i in order]
            ut.rows = list(range(row, row + len(ut.ids)))
            for k, tid in enumerate(ut.ids):
                self.row_ids[row] = tid
                host = self.task_info[tid][1]
                hidx = self.host_idx.get(host, -1)
                host_np[row] = hidx
                res_np[row] = ut.res[k]
                self._elig_np[row] = hidx >= 0
                row += 1
            self._rescore(user)
        self._next_slack = n_tasks

        # device tensors; per-decision updates are small in-place writes
        if resident is not None and params.resident:
            if resident.device != self.device:
                raise ValueError(
                    f"resident mirror {resident.name} lives on "
                    f"{resident.device}, the cycle on {self.device}")
            # keyed-row mirror: one row per RUNNING task keyed by task
            # id, gathered into this cycle's row order on the device — a
            # task that survived since the last cycle ships zero bytes.
            # Slack rows beyond n_tasks gather the all-zero pad row, so
            # the host encodes host + 1 (the pad's 0 decodes to the -1
            # "unknown host" sentinel the slack rows need)
            cols, _stats = resident.build(
                self.row_ids[:n_tasks],
                {
                    "host1": (host_np[:n_tasks] + 1).astype(np.int32),
                    "res": res_np[:n_tasks],
                    "dru": self._dru_np[:n_tasks],
                    "elig": self._elig_np[:n_tasks],
                },
                out_len=total,
            )
            self._dev_host = cols["host1"] - 1
            self._dev_res = cols["res"]
            self._dev_dru = cols["dru"]
            self._dev_elig = cols["elig"]
            # the decisions write spare in place (_apply): a device copy
            # of the shared resident tensor, no transfer
            self._dev_spare = resident.whole_array("spare", spare).clone()
            self._dev_host_ok = resident.whole_array(
                "host_ok", np.arange(len(spare)) < h)
        else:
            # classic full upload, ledger-accounted under the same family
            # so cold-vs-warm bytes compare honestly
            def put(arr):
                return data_plane.h2d(arr, family=data_plane.FAM_REBALANCE,
                                      device=self.device)

            self._dev_host = put(host_np)
            self._dev_res = put(res_np)
            self._dev_dru = put(self._dru_np)
            self._dev_elig = put(self._elig_np)
            self._dev_spare = put(spare)
            self._dev_host_ok = put(np.arange(len(spare)) < h)
        self._spare_np = spare.copy()
        self.preempted: set[str] = set()
        self._sorted = None
        self._perm_np = None
        if params.fast_cycle:
            # ONE sort for the whole cycle; decisions reuse the order
            self._sorted = sort_rebalance_state(
                self._dev_host, self._dev_dru, self._dev_res,
                self._dev_elig)
            self._perm_np = fetch_result(self._sorted.perm)

    # ------------------------------------------------------------ internals

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """A host array as a fresh tensor on the cycle's device."""
        return torch.as_tensor(np.ascontiguousarray(arr), device=self.device)

    @staticmethod
    def _task_key(job: Job, inst: Optional[Instance]) -> tuple:
        start = inst.start_time_ms if inst is not None else 2**62
        tid = inst.task_id if inst is not None else "￿"
        return (-job.priority, start, tid)

    def _divisors(self, user: str) -> tuple[float, float, float]:
        share = self.store.get_share(user, self.pool.name)
        return (min(share.mem, BIG), min(share.cpus, BIG), min(share.gpus, BIG))

    def _rescore(self, user: str) -> list[int]:
        """Recompute the user's cumulative DRUs into the flat dru column
        (only-changed-users rescore); returns the touched rows."""
        ut = self.users.get(user)
        if ut is None:
            return []
        md, cd, gd = self._divisors(user)
        cum_m = cum_c = cum_g = 0.0
        ut.dru = []
        for k, (mem, cpus, gpus, *_rest) in enumerate(ut.res):
            cum_m += mem
            cum_c += cpus
            cum_g += gpus
            value = (cum_g / gd if self.gpu_mode
                     else max(cum_m / md, cum_c / cd))
            ut.dru.append(value)
            self._dru_np[ut.rows[k]] = value
        return list(ut.rows)

    def _device_state(self) -> RebalanceState:
        return RebalanceState(
            task_host=self._dev_host,
            task_dru=self._dev_dru,
            task_res=self._dev_res,
            task_eligible=self._dev_elig,
            spare=self._dev_spare,
            host_ok=self._dev_host_ok,
        )

    def pending_job_dru(self, job: Job) -> float:
        """compute-pending-default-job-dru / -gpu (rebalancer.clj:157-205):
        the user's nearest running task's dru + the job's own share."""
        md, cd, gd = self._divisors(job.user)
        ut = self.users.get(job.user)
        nearest = 0.0
        if ut is not None and ut.ids:
            key = self._task_key(job, None)
            pos = bisect.bisect_right(ut.keys, key)
            if pos > 0:
                nearest = ut.dru[pos - 1]
        r = job.resources
        if self.gpu_mode:
            return nearest + r.gpus / gd
        return max(nearest + r.mem / md, nearest + r.cpus / cd)

    def user_below_quota(self, job: Job) -> bool:
        """job-below-quota (rebalancer.clj:212-222): would launching exceed
        the user's quota?"""
        quota = self.store.get_quota(job.user, self.pool.name)
        ut = self.users.get(job.user)
        mem = cpus = gpus = 0.0
        count = 0
        if ut is not None:
            for k in range(len(ut.ids)):
                mem += ut.res[k][0]
                cpus += ut.res[k][1]
                gpus += ut.res[k][2]
                count += 1
        r = job.resources
        return (
            mem + r.mem <= quota.resources.mem
            and cpus + r.cpus <= quota.resources.cpus
            and gpus + r.gpus <= quota.resources.gpus
            and count + 1 <= quota.count
        )

    # ----------------------------------------------------------- main loop

    def _host_ok_for(self, job: Job) -> Optional[np.ndarray]:
        """Per-host constraint pass for the pending job (reference:
        make-rebalancer-job-constraints, constraints.clj:504): novel-host,
        user attribute EQUALS, checkpoint locality."""
        failed_hosts = {
            inst.hostname
            for inst in self.store.job_instances(job.uuid)
            if inst.status.terminal and inst.hostname
        }
        need_attrs = {c.attribute: c.pattern for c in job.constraints}
        need_location = (job.checkpoint.location
                         if job.checkpoint is not None else "")
        if not failed_hosts and not need_attrs and not need_location:
            return None
        # padded host rows stay False (matching _dev_host_ok)
        ok = np.zeros(len(self._spare_np), dtype=bool)
        ok[:len(self.hostnames)] = True
        for i, hostname in enumerate(self.hostnames):
            if hostname in failed_hosts:
                ok[i] = False
                continue
            attrs, location = self.host_info.get(hostname, ({}, ""))
            if need_location and location != need_location:
                ok[i] = False
                continue
            for attr, want in need_attrs.items():
                if attrs.get(attr) != want:
                    ok[i] = False
                    break
        return ok

    def _scalars(self, job: Job):
        """(demand [4], pending_dru, safe_dru_threshold, min_dru_diff) as
        float32 tensors on the device, as the reference passes them."""
        r = job.resources
        dev = self.device
        return (torch.tensor([r.mem, r.cpus, r.gpus, r.disk],
                             dtype=torch.float32, device=dev),
                as_scalar(self.pending_job_dru(job), dev),
                as_scalar(self.params.safe_dru_threshold, dev),
                as_scalar(self.params.min_dru_diff, dev))

    def compute_decision(self, job: Job) -> Optional[Decision]:
        if self.params.fast_cycle:
            return self._compute_decision_fast(job)
        state = self._device_state()
        host_ok = self._host_ok_for(job)
        if host_ok is not None:
            state = state._replace(host_ok=self._put(host_ok))
        scalars = self._scalars(job)
        if not self.user_below_quota(job):
            # over-quota users may only preempt their own tasks
            # (rebalancer.clj:339-346)
            ut = self.users.get(job.user)
            own_rows = np.asarray(ut.rows if ut else [], dtype=np.int64)
            allowed = torch.zeros(state.task_eligible.shape[0],
                                  dtype=torch.bool, device=self.device)
            allowed[self._put(own_rows)] = True
            state = state._replace(
                task_eligible=state.task_eligible & allowed
            )
        decision = fetch_result(find_preemption_decision(state, *scalars))
        host = int(decision.host)
        if host < 0:
            return None
        task_ids = [self.row_ids[i] for i in np.where(decision.preempt_mask)[0]]
        return self._decide(job, host, task_ids, decision)

    def _decide(self, job: Job, host: int, task_ids: list[str],
                decision) -> Decision:
        """The Decision for a fetched search result; applies it to the
        cycle state."""
        victims = self._victim_details(task_ids)
        self._apply(job, host, task_ids, decision.freed)
        return Decision(
            job=job,
            hostname=self.hostnames[host],
            task_ids=task_ids,
            min_preempted_dru=float(decision.score),
            victims=victims,
        )

    def _victim_details(self, task_ids: list[str]) -> list[dict]:
        """Per-victim (user, DRU-at-decision, resources) for the fairness
        ledger.  Must run BEFORE _apply: applying the decision deletes
        the victims' entries from the per-user task lists."""
        out = []
        for tid in task_ids:
            user, _ = self.task_info[tid]
            ut = self.users[user]
            k = ut.ids.index(tid)
            mem, cpus, gpus, _disk = ut.res[k]
            out.append({
                "task_id": tid,
                "user": user,
                "dru": round(float(ut.dru[k]), 6),
                "mem": float(mem),
                "cpus": float(cpus),
                "gpus": float(gpus),
            })
        return out

    def _compute_decision_fast(self, job: Job) -> Optional[Decision]:
        """Decision against the cycle-start sort (RebalancerParams
        .fast_cycle): per-decision validity is a host-side [T] mask
        gathered into sorted space — no device sort per decision."""
        host_ok = self._host_ok_for(job)
        host_ok_dev = (self._put(host_ok) if host_ok is not None
                       else self._dev_host_ok)
        demand, pending, safe, diff = self._scalars(job)
        row_ok = self._elig_np
        if not self.user_below_quota(job):
            ut = self.users.get(job.user)
            own = np.zeros(len(self._elig_np), dtype=bool)
            if ut:
                own[np.asarray(ut.rows, dtype=np.int64)] = True
            row_ok = row_ok & own
        decision = fetch_result(decide_from_sorted(
            self._sorted,
            self._put(row_ok[self._perm_np]),
            self._put(self._dru_np[self._perm_np]),
            self._put(self._spare_np),
            host_ok_dev,
            demand, pending, safe, diff,
        ))
        host = int(decision.host)
        if host < 0:
            return None
        rows = self._perm_np[np.where(decision.preempt_mask)[0]]
        task_ids = [self.row_ids[i] for i in rows]
        return self._decide(job, host, task_ids, decision)

    def _apply(self, job: Job, host: int, task_ids: list[str],
               freed: np.ndarray) -> None:
        """next-state (rebalancer.clj:270-318): remove victims, add the
        simulated launch, rescore changed users, update host spare —
        all as small in-place writes into the device tensors."""
        changed = {job.user}
        dead_rows = []
        for tid in task_ids:
            self.preempted.add(tid)
            user, _ = self.task_info[tid]
            ut = self.users[user]
            k = ut.ids.index(tid)
            dead_rows.append(ut.rows[k])
            del ut.keys[k], ut.ids[k], ut.res[k], ut.rows[k]
            changed.add(user)
        # simulated launch of the pending job on the chosen host: it joins
        # the fairness state (and may itself be preempted by later
        # decisions), living in a preallocated slack row
        ut = self.users.setdefault(job.user, _UserTasks())
        key = self._task_key(job, None)
        pos = bisect.bisect_right(ut.keys, key)
        sim_id = f"sim-{job.uuid}"
        sim_row = self._next_slack
        self._next_slack += 1
        res = (job.resources.mem, job.resources.cpus,
               job.resources.gpus, job.resources.disk)
        ut.keys.insert(pos, key)
        ut.ids.insert(pos, sim_id)
        ut.res.insert(pos, res)
        ut.rows.insert(pos, sim_row)
        self.row_ids[sim_row] = sim_id
        self.task_info[sim_id] = (job.user, self.hostnames[host])

        touched = []
        for user in changed:
            touched.extend(self._rescore(user))
        for row in dead_rows:
            self._elig_np[row] = False
        # in fast_cycle the sim row is outside the cycle-start sort (its
        # sorted position sits in the sentinel segment, which the decide
        # step excludes); host-side bookkeeping above still counts it
        # for quota/pending-dru purposes
        self._elig_np[sim_row] = not self.params.fast_cycle

        r = job.resources
        new_spare = np.maximum(
            freed - np.array([r.mem, r.cpus, r.gpus, r.disk]), 0.0
        ).astype(np.float32)
        self._spare_np[host] = new_spare
        if self.params.fast_cycle:
            return
        # device writes: O(changed rows)
        rows = np.asarray(sorted(set(touched + dead_rows + [sim_row])),
                          dtype=np.int64)
        dev_rows = self._put(rows)
        self._dev_dru[dev_rows] = self._put(self._dru_np[rows])
        self._dev_elig[dev_rows] = self._put(self._elig_np[rows])
        self._dev_host[sim_row] = host
        self._dev_res[sim_row] = self._put(np.asarray(res, np.float32))
        self._dev_spare[host] = self._put(new_spare)


def rebalance_pool(
    store: JobStore,
    pool: Pool,
    pending_in_dru_order: Sequence[Job],
    host_spare: dict[str, Resources],
    params: RebalancerParams,
    host_info: Optional[dict] = None,
    telemetry=None,
    reclaimer=None,
    resident=None,
    *,
    device: Optional[Union[str, torch.device]] = None,
) -> list[Decision]:
    """One pool's rebalance cycle: returns the preemption decisions
    (rebalancer.clj:434-479 `rebalance`).  The caller transacts + kills.

    `reclaimer` is the elastic capacity plane's pre-preemption hook: when
    given, it may return a refreshed spare map (loaned capacity
    reclaimed), and the victim search runs against that (a later slice;
    the port's scheduler passes None).  `telemetry` records one solve per
    decision.

    `resident` is an optional `device_state.ResidentRows` mirror owned by
    the caller (it must OUTLIVE the cycle — warm reuse is the whole
    point) on the cycle's device; it serves the cycle-start victim
    tensors when `params.resident` is set."""
    if reclaimer is not None:
        refreshed = reclaimer(pool.name, pending_in_dru_order, host_spare)
        if refreshed is not None:
            host_spare = refreshed
    cycle = RebalanceCycle(store, pool, host_spare, params,
                           host_info=host_info, device=device,
                           resident=resident)
    solve_shape = (int(cycle._dev_host.shape[0]),
                   int(cycle._dev_spare.shape[0]))
    decisions = []
    for job in list(pending_in_dru_order)[: params.max_preemption]:
        if telemetry is not None:
            telemetry.record_solve(
                "rebalance", solve_shape,
                "fast_cycle" if params.fast_cycle else "exact")
        decision = cycle.compute_decision(job)
        if decision is not None and decision.task_ids:
            decisions.append(decision)
    return decisions
