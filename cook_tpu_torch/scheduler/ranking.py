"""The rank cycle: store state -> DRU kernel -> ordered pending queue.

Port of `cook_tpu/scheduler/ranking.py` (`RankedQueue`, `QuotaWalk`,
`offensive_job_filter`, `rank_pool` with its predicted-duration backfill
term).  The DRU tensors are built on the caller's device, each column's
host-to-device bytes noted in the data plane (`dru-columns`), resident
across cycles with a `device_state`; the columnar fast path is
`ranking_columnar.py`.

Reference: `rank-jobs` + `sort-jobs-by-dru-pool`
(Cook's scheduler/scheduler.clj:2057-2296) —
every few seconds, per pool: per-user task lists (running tasks first, then
pending jobs, ordered by (-priority, start-time, id)), quota-capped, DRU
scored, merged into one global fairness order, filtered to pending.

Here the scoring+merge is the `dru_rank` kernel; this module does the
host-side gather/encode and the over-quota capping.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cook_tpu_torch.models.entities import DruMode, Job, Pool
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.ops import dru as dru_ops
from cook_tpu_torch.ops.common import BIG, bucket_size, fetch_result, pad_to


@dataclass
class RankedQueue:
    """Output of one pool's rank cycle."""

    jobs: list[Job]          # pending jobs in fair-share order
    dru: dict[str, float]    # job uuid -> queue dru
    capped: list[str]        # job uuids dropped by quota capping
    quarantined: list[str] = None  # dropped by the offensive-job filter
    # the DRU solve's padded task bucket (compile accounting), or None
    # when no solve ran
    solve_shape: tuple = None

    def __post_init__(self):
        if self.quarantined is None:
            self.quarantined = []


class QuotaWalk:
    """Incremental per-user quota admission over a priority-ordered job
    stream (reference `filter-based-on-user-quota` + `filter-sequential`,
    tools.clj:903/:654).

    Snapshot of running usage is taken at construction; each admit() call
    accumulates the job's demand onto the user's cumulative usage and
    answers whether the user stays within quota on every dimension.
    Take-while semantics per user: since usage only grows along the walk,
    the first over-quota job closes the user's queue (a later smaller job
    must not jump it) — which is exactly the reference's state-threading
    through rejected jobs, monotonicity collapsed into a closed set.

    Used at RANK time to cap the queue and again at MATCH time with a
    fresh snapshot (`pending-jobs->considerable-jobs`, scheduler.clj:729)
    so launches or quota changes between rank ticks cannot push a user
    over quota."""

    def __init__(self, store: JobStore, pool: str):
        self.store = store
        self.pool = pool
        self.usage = store.user_usage(pool)
        self.running_counts: dict[str, int] = {}
        for job in store.running_jobs(pool):
            self.running_counts[job.user] = (
                self.running_counts.get(job.user, 0) + 1)
        # per-user cumulative (mem, cpus, gpus, count) tuples + a quota
        # cache — admit() is called once per pending job per cycle
        self.quotas: dict[str, tuple[float, float, float, int]] = {}
        self.cum: dict[str, tuple[float, float, float, int]] = {}
        self.closed: set[str] = set()

    def admit(self, job: Job) -> bool:
        user = job.user
        if user in self.closed:
            return False
        q = self.quotas.get(user)
        if q is None:
            quota = self.store.get_quota(user, self.pool)
            q = (quota.resources.mem, quota.resources.cpus,
                 quota.resources.gpus, quota.count)
            self.quotas[user] = q
        state = self.cum.get(user)
        if state is None:
            u = self.usage.get(user)
            state = ((u.mem, u.cpus, u.gpus) if u is not None
                     else (0.0, 0.0, 0.0)) + (
                self.running_counts.get(user, 0),)
        r = job.resources
        new_state = (state[0] + r.mem, state[1] + r.cpus,
                     state[2] + r.gpus, state[3] + 1)
        if (new_state[3] <= q[3] and new_state[0] <= q[0]
                and new_state[1] <= q[1] and new_state[2] <= q[2]):
            self.cum[user] = new_state
            return True
        self.closed.add(user)
        return False


def _quota_cap(
    store: JobStore,
    pool: str,
    pending: list[Job],
) -> tuple[list[Job], list[str]]:
    """Drop pending jobs that would exceed their user's quota given running
    usage + earlier pending jobs (reference `limit-over-quota-jobs` +
    `filter-based-on-quota`, scheduler.clj:2057-2157).  `pending` must be in
    per-user priority order."""
    walk = QuotaWalk(store, pool)
    kept, capped = [], []
    for job in pending:
        if walk.admit(job):
            kept.append(job)
        else:
            capped.append(job.uuid)
    return kept, capped


def offensive_job_filter(
    max_mem: float, max_cpus: float, max_gpus: float
):
    """Filter for jobs that can never be matched — demands beyond any host
    in the pool (reference: the offensive-job filter at
    scheduler.clj:2198-2257, which quarantines such jobs out of the queue
    instead of letting them clog the head)."""

    def accept(job: Job) -> bool:
        r = job.resources
        return r.mem <= max_mem and r.cpus <= max_cpus and r.gpus <= max_gpus

    return accept


def rank_pool(
    store: JobStore,
    pool: Pool,
    *,
    device: torch.device,
    offensive_job_filter=None,
    predictor=None,
    backfill_weight: float = 0.0,
    backfill_norm_ms: float = 600_000.0,
    device_state=None,
) -> RankedQueue:
    """Rank one pool's pending jobs by cumulative DRU on `device`.

    With `predictor` (scheduler/prediction.py) and a positive
    `backfill_weight`, each pending task carries a predicted-duration
    column into the DRU solve: fraction = min(predicted_runtime /
    backfill_norm_ms, 1), no-estimate jobs pinned at 1 (never boosted).
    `ops/dru.dru_rank` adds `weight x fraction` to the DRU before the
    global order sort — short-job backfill as a bounded scoring term.
    Weight 0 (the default) reproduces the unadjusted order exactly.

    With `device_state` (scheduler/device_state.py) each DRU column stays
    resident and re-uploads only when its content changed — an unchanged
    queue's rank cycle moves zero DRU bytes."""
    pool_name = pool.name
    pending = store.pending_jobs(pool_name)
    quarantined: list[str] = []
    if offensive_job_filter is not None:
        kept = []
        for j in pending:
            if offensive_job_filter(j):
                kept.append(j)
            else:
                quarantined.append(j.uuid)
        pending = kept

    # order pending per user by (-priority, submit-time, insertion order) —
    # the pending-job part of task->feature-vector (tools.clj:614-641; the
    # reference's final tie-break is the :db/id entity id, i.e. insertion)
    seq = store.job_seq
    pending.sort(key=lambda j: (-j.priority, j.submit_time_ms,
                                seq.get(j.uuid, 0)))
    pending, capped = _quota_cap(store, pool_name, pending)

    running = []
    for job in store.running_jobs(pool_name):
        for inst in store.job_instances(job.uuid):
            if not inst.status.terminal:
                running.append((job, inst))

    t_total = len(running) + len(pending)
    if t_total == 0 or not pending:
        return RankedQueue(jobs=[], dru={}, capped=capped,
                           quarantined=quarantined)

    users = sorted(
        {j.user for j in pending} | {j.user for j, _ in running}
    )
    user_idx = {u: i for i, u in enumerate(users)}

    # Build the flat task tensor: running tasks sort before pending ones for
    # the same user/priority (start-time < infinity), matching the
    # reference's feature vector.
    n = t_total
    user = np.empty(n, dtype=np.int32)
    mem = np.empty(n, dtype=np.float32)
    cpus = np.empty(n, dtype=np.float32)
    gpus = np.empty(n, dtype=np.float32)
    neg_prio = np.empty(n, dtype=np.int64)
    start = np.empty(n, dtype=np.int64)
    is_pending = np.zeros(n, dtype=bool)
    job_refs: list[Job] = []
    for i, (job, inst) in enumerate(running):
        user[i] = user_idx[job.user]
        mem[i], cpus[i], gpus[i] = (job.resources.mem, job.resources.cpus,
                                    job.resources.gpus)
        neg_prio[i] = -job.priority
        start[i] = inst.start_time_ms
        job_refs.append(job)
    for k, job in enumerate(pending):
        i = len(running) + k
        user[i] = user_idx[job.user]
        mem[i], cpus[i], gpus[i] = (job.resources.mem, job.resources.cpus,
                                    job.resources.gpus)
        neg_prio[i] = -job.priority
        start[i] = 2**62  # pending sorts after running at equal priority
        is_pending[i] = True
        job_refs.append(job)

    # per-user order key: global lexicographic position (host-side lexsort;
    # preserves (-priority, start, submit-order) within each user)
    perm = np.lexsort((np.arange(n), start, neg_prio, user))
    order_key = np.empty(n, dtype=np.float32)
    order_key[perm] = np.arange(n, dtype=np.float32)

    divs = np.empty((3, len(users)), dtype=np.float32)
    for u, i in user_idx.items():
        share = store.get_share(u, pool_name)
        divs[:, i] = (min(share.mem, BIG), min(share.cpus, BIG),
                      min(share.gpus, BIG))

    # predicted-duration backfill column: pending tasks with an estimate
    # get fraction = min(est / norm, 1); everything else (running tasks,
    # cold keys) pins at 1.0 — neutral-worst, so an unestimated job is
    # never boosted past an estimated one
    backfill = None
    if predictor is not None and backfill_weight > 0:
        backfill = np.ones(n, dtype=np.float32)
        norm = max(float(backfill_norm_ms), 1.0)
        for k, job in enumerate(pending):
            est = predictor.predict_runtime_ms(job.user, job.command)
            if est is not None:
                backfill[len(running) + k] = min(est / norm, 1.0)

    pad_t = bucket_size(n)
    data_plane.note_padding("dru", (pad_t,), valid_cells=n,
                            padded_cells=pad_t)
    result = solve_dru(
        pad_to(user, pad_t), pad_to(mem, pad_t), pad_to(cpus, pad_t),
        pad_to(gpus, pad_t), pad_to(order_key, pad_t, fill=BIG),
        pad_to(np.ones(n, dtype=bool), pad_t, fill=False), divs,
        gpu_mode=(pool.dru_mode == DruMode.GPU), device=device,
        device_state=device_state, pool_name=pool_name,
        backfill=(pad_to(backfill, pad_t, fill=1.0)
                  if backfill is not None else None),
        backfill_weight=backfill_weight)
    order, dru = result

    ranked_jobs: list[Job] = []
    dru_map: dict[str, float] = {}
    for pos in order:
        if pos >= n or not is_pending[pos]:
            continue
        job = job_refs[pos]
        ranked_jobs.append(job)
        dru_map[job.uuid] = float(dru[pos])
    return RankedQueue(jobs=ranked_jobs, dru=dru_map, capped=capped,
                       quarantined=quarantined, solve_shape=(pad_t,))


def solve_dru(user, mem, cpus, gpus, order_key, valid, divs, *,
              gpu_mode: bool, device: torch.device, device_state=None,
              pool_name: str = "", backfill=None,
              backfill_weight: float = 0.0):
    """The DRU solve both rank paths share: the padded task columns and
    the share divisors ([3, U], one column each) to `device`
    (`dru-columns` bytes), `dru_rank` there, and (order, dru) fetched back
    to the host.  With `device_state` each column is the resident copy
    of `pool_name`'s column when its content is unchanged
    (`DeviceResidentState.resident_array`: zero bytes move).  `backfill`
    (padded [T] fractions, or None) is the backfill term's column."""
    fam = data_plane.FAM_DRU

    if device_state is not None:
        def put(name, arr):
            return device_state.resident_array(pool_name, "dru." + name,
                                               arr, family=fam)
    else:
        def put(name, arr):
            return data_plane.h2d(arr, family=fam, device=device)

    tasks = dru_ops.DruTasks(
        user=put("user", np.asarray(user, dtype=np.int32)),
        mem=put("mem", np.asarray(mem, dtype=np.float32)),
        cpus=put("cpus", np.asarray(cpus, dtype=np.float32)),
        gpus=put("gpus", np.asarray(gpus, dtype=np.float32)),
        order_key=put("order_key", np.asarray(order_key, dtype=np.float32)),
        valid=put("valid", np.asarray(valid, dtype=bool)))
    divs = np.asarray(divs, dtype=np.float32)
    mem_div = put("mem_div", divs[0])
    cpu_div = put("cpu_div", divs[1])
    gpu_div = put("gpu_div", divs[2])
    result = dru_ops.dru_rank(
        tasks, mem_div, cpu_div, gpu_div, gpu_mode=gpu_mode,
        backfill=(put("backfill", np.asarray(backfill, dtype=np.float32))
                  if backfill is not None else None),
        backfill_weight=(backfill_weight if backfill is not None
                         else None))
    with data_plane.family(fam):
        return fetch_result((result.order, result.dru))
