"""Vectorized rank cycle over the columnar job index.

Port of `cook_tpu/scheduler/ranking_columnar.py` (`rank_pool_columnar`,
`_seg_cumsum`): per-user (-priority, start, id) order, take-while quota
capping, the DRU solve (`ops/dru.dru_rank` on the scheduler's device) and
the global fairness order, with all host-side encoding as numpy column
operations over `models/columnar.ColumnarJobIndex` instead of a Python
walk over job objects.

Tie order: user codes are the index's first-seen intern order, which is
the primary key of the per-user `order_key` lexsort.  `ranking.rank_pool`
numbers users alphabetically instead, so the two paths order equal-DRU
jobs of different users differently (both valid); each is ported as it
is.  The pending tie-break is the index row, which follows the store's
`job/created` order, as `store.job_seq` does for `rank_pool`.
"""
from __future__ import annotations

import numpy as np
import torch

from cook_tpu_torch.models.columnar import ColumnarJobIndex
from cook_tpu_torch.models.entities import DruMode, Pool
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.ops.common import BIG, bucket_size, pad_to
from cook_tpu_torch.scheduler.ranking import RankedQueue, solve_dru


def _seg_cumsum(values: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Cumulative sum restarting at each new value of sorted `seg`."""
    total = np.cumsum(values)
    starts = np.empty(len(seg), bool)
    if len(seg):
        starts[0] = True
        starts[1:] = seg[1:] != seg[:-1]
    idx = np.arange(len(seg))
    seg_first = np.maximum.accumulate(np.where(starts, idx, 0))
    base = np.where(seg_first > 0, total[np.maximum(seg_first - 1, 0)], 0.0)
    return total - base


def rank_pool_columnar(
    store: JobStore,
    index: ColumnarJobIndex,
    pool: Pool,
    *,
    device: torch.device,
    capacity_limits=None,  # (max_mem, max_cpus, max_gpus) offensive filter
    device_state=None,     # DRU-column residency (device_state.py)
) -> RankedQueue:
    """Rank one pool's pending jobs by cumulative DRU on `device`, reading
    the columnar index.  With `device_state` each DRU column reuses its
    resident device copy when its content is unchanged
    (`device_state.resident_array` — zero re-upload)."""
    pending, inst_sel = index.pool_view(pool.name)

    quarantined: list[str] = []
    if capacity_limits is not None and len(pending):
        max_mem, max_cpus, max_gpus = capacity_limits
        ok = (
            (index.mem[pending] <= max_mem)
            & (index.cpus[pending] <= max_cpus)
            & (index.gpus[pending] <= max_gpus)
        )
        quarantined = [index.uuids[r] for r in pending[~ok]]
        pending = pending[ok]

    if len(pending) == 0:
        return RankedQueue(jobs=[], dru={}, capped=[],
                           quarantined=quarantined)

    # per-user priority order: (user, -priority, submit, row)
    u = index.user_code[pending]
    order = np.lexsort((pending, index.submit_ms[pending],
                        -index.priority[pending], u))
    p_sorted = pending[order]
    us = index.user_code[p_sorted]

    # running usage per user (live instances of this pool)
    inst_jobs = index.inst_job_row[inst_sel]
    iu = index.user_code[inst_jobs]
    n_users = len(index.users.names)
    usage_mem = np.bincount(iu, weights=index.mem[inst_jobs],
                            minlength=n_users)
    usage_cpu = np.bincount(iu, weights=index.cpus[inst_jobs],
                            minlength=n_users)
    usage_gpu = np.bincount(iu, weights=index.gpus[inst_jobs],
                            minlength=n_users)
    usage_cnt = np.bincount(iu, minlength=n_users).astype(np.float64)

    # quota columns for the users present
    qmem = np.full(n_users, np.inf)
    qcpu = np.full(n_users, np.inf)
    qgpu = np.full(n_users, np.inf)
    qcnt = np.full(n_users, np.inf)
    for code in np.unique(us):
        quota = store.get_quota(index.users.names[code], pool.name)
        qmem[code] = quota.resources.mem
        qcpu[code] = quota.resources.cpus
        qgpu[code] = quota.resources.gpus
        qcnt[code] = quota.count

    # take-while quota cap via segmented cumsums
    cmem = _seg_cumsum(index.mem[p_sorted].astype(np.float64), us) + usage_mem[us]
    ccpu = _seg_cumsum(index.cpus[p_sorted].astype(np.float64), us) + usage_cpu[us]
    cgpu = _seg_cumsum(index.gpus[p_sorted].astype(np.float64), us) + usage_gpu[us]
    ccnt = _seg_cumsum(np.ones(len(p_sorted)), us) + usage_cnt[us]
    fits = ((cmem <= qmem[us]) & (ccpu <= qcpu[us])
            & (cgpu <= qgpu[us]) & (ccnt <= qcnt[us]))
    # prefix-AND within each user segment (first failure closes the user)
    over = _seg_cumsum((~fits).astype(np.float64), us)
    keep = over == 0
    capped = [index.uuids[r] for r in p_sorted[~keep]]
    kept = p_sorted[keep]
    if len(kept) == 0:
        return RankedQueue(jobs=[], dru={}, capped=capped,
                           quarantined=quarantined)

    # DRU kernel input: running instances first, then kept pending
    n_run = len(inst_jobs)
    n = n_run + len(kept)
    user = np.concatenate([index.user_code[inst_jobs],
                           index.user_code[kept]]).astype(np.int32)
    mem = np.concatenate([index.mem[inst_jobs], index.mem[kept]])
    cpus = np.concatenate([index.cpus[inst_jobs], index.cpus[kept]])
    gpus = np.concatenate([index.gpus[inst_jobs], index.gpus[kept]])
    neg_prio = np.concatenate([
        -index.priority[inst_jobs], -index.priority[kept]
    ]).astype(np.int64)
    start = np.concatenate([
        index.inst_start[inst_sel],
        np.full(len(kept), 2**62, np.int64),  # pending after running
    ])
    perm = np.lexsort((np.arange(n), start, neg_prio, user))
    order_key = np.empty(n, np.float32)
    order_key[perm] = np.arange(n, dtype=np.float32)

    divs = np.ones((3, n_users), np.float32)
    for code in np.unique(user):
        share = store.get_share(index.users.names[code], pool.name)
        divs[:, code] = (min(share.mem, BIG), min(share.cpus, BIG),
                         min(share.gpus, BIG))

    pad_t = bucket_size(n)
    data_plane.note_padding("dru", (pad_t,), valid_cells=n,
                            padded_cells=pad_t)
    kernel_order, dru = solve_dru(
        pad_to(user, pad_t), pad_to(mem, pad_t), pad_to(cpus, pad_t),
        pad_to(gpus, pad_t), pad_to(order_key, pad_t, fill=BIG),
        pad_to(np.ones(n, bool), pad_t, fill=False), divs,
        gpu_mode=(pool.dru_mode == DruMode.GPU), device=device,
        device_state=device_state, pool_name=pool.name)

    # pending positions in kernel order -> job objects
    pend_positions = kernel_order[(kernel_order >= n_run)
                                  & (kernel_order < n)]
    rows_in_order = kept[pend_positions - n_run]
    ranked_jobs = [store.jobs[index.uuids[r]] for r in rows_in_order]
    dru_map = {
        job.uuid: float(dru[pos])
        for job, pos in zip(ranked_jobs, pend_positions)
    }
    return RankedQueue(jobs=ranked_jobs, dru=dru_map, capped=capped,
                       quarantined=quarantined, solve_shape=(pad_t,))
