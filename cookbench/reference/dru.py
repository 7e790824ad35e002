"""The plain DRU order of one pool's pending jobs (Cook's dru.clj).

Each user's tasks are ordered by priority (high first), running before
pending, then by submission; a pending job's DRU is the user's
cumulative dominant share through it: max(mem / share_mem, cpus /
share_cpus), or gpus / share_gpus in a GPU pool.  All pending jobs are
then ordered by (DRU, user, -priority, submission), the user ranked by
the first submission that named it.

The cumulative sums are taken in float64, which is exact for the
deployments' sizes (multiples of 512 MB and of half a cpu); the shares
and the quotients are rounded to the precision under test.
"""
from __future__ import annotations

import numpy as np

from cookbench.reference.precision import f32

BIG = 1e30
TINY = 1e-30


def divisors(share, rnd=f32) -> np.ndarray:
    """A share (mem, cpus, gpus) as the divisors the DRU divides by."""
    d = np.clip(np.asarray(share, np.float64), TINY, BIG)
    return rnd(d.astype(np.float32))


def _segment_cumsum(values: np.ndarray, seg: np.ndarray) -> np.ndarray:
    """Cumulative sums of `values` [n, k] restarting at each new `seg`
    (sorted)."""
    out = np.cumsum(values, axis=0)
    if len(seg) == 0:
        return out
    starts = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    offsets = np.zeros((len(starts), values.shape[1]))
    offsets[1:] = out[starts[1:] - 1]
    return out - np.repeat(offsets, np.diff(np.r_[starts, len(seg)]), axis=0)


def dru_order(p_user: np.ndarray, p_prio: np.ndarray, p_seq: np.ndarray,
              p_res: np.ndarray, r_user: np.ndarray, r_prio: np.ndarray,
              r_res: np.ndarray, div: np.ndarray, gpu_mode: bool,
              rnd=f32) -> np.ndarray:
    """Positions of the pending jobs in DRU order.

    p_*: the pending jobs (user code, priority, submission number,
    resources [n, 3] as mem, cpus, gpus); r_*: the running tasks of the
    pool; `div`: [users, 3] divisors; `rnd`: the precision."""
    n = len(p_user)
    if n == 0:
        return np.empty(0, np.int64)
    within = np.lexsort((p_seq, -p_prio, p_user))
    res = p_res[within].astype(np.float64)
    cum = _segment_cumsum(res, p_user[within])
    # running tasks of the same user at a priority as high or higher come
    # first in the user's order
    base = np.zeros((n, 3))
    s_user, s_prio = p_user[within], p_prio[within]
    n_users = len(div)
    for level in np.unique(p_prio):
        at = s_prio == level
        sel = r_prio >= level
        usage = np.zeros((n_users, 3))
        np.add.at(usage, r_user[sel], r_res[sel])
        base[at] = usage[s_user[at]]
    cum = rnd((cum + base).astype(np.float32))
    q = rnd(cum / div[p_user[within]])
    dru_sorted = q[:, 2] if gpu_mode else np.maximum(q[:, 0], q[:, 1])
    dru = np.empty(n, np.float32)
    dru[within] = dru_sorted
    return np.lexsort((p_seq, -p_prio, p_user, dru))
