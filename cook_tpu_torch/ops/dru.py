"""DRU fair-share ranking as a batched tensor solve.

Port of `cook_tpu/ops/dru.py` (`dru_rank`, :53-121): a lexicographic sort
of all tasks by (user, order_key), per-user segmented cumulative dominant
shares, then one global stable sort by (dru, order_key).  Inputs are
fixed-size padded tensors with a `valid` mask, as in the reference.
`dru_rank_pools` is the same rank over a leading pool axis (:123-129).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cook_tpu_torch.ops.common import (
    BIG,
    inverse_permutation,
    lexsort_perm,
    segmented_cumsum,
)

INT32_MAX = 2**31 - 1


class DruTasks(NamedTuple):
    """Padded task tensors for one pool: running tasks AND pending jobs
    (treated as hypothetical tasks), exactly like the rank cycle's input."""

    user: torch.Tensor       # [T] int32 user index
    mem: torch.Tensor        # [T] f32
    cpus: torch.Tensor       # [T] f32
    gpus: torch.Tensor       # [T] f32
    order_key: torch.Tensor  # [T] f32 — per-user task order (smaller first)
    valid: torch.Tensor      # [T] bool


class DruResult(NamedTuple):
    dru: torch.Tensor        # [T] f32 per-task cumulative DRU (BIG on padding)
    rank: torch.Tensor       # [T] int32 global rank position per task
    order: torch.Tensor      # [T] int32 task indices in global DRU order


def from_numpy(user, mem, cpus, gpus, order_key, valid, *,
               device) -> DruTasks:
    """The numpy arrays a reference `DruTasks` is built from, as the port's
    tensors on `device` (int32 users, float32 columns, bool mask — the
    dtypes the reference's arrays take with 64-bit mode off)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    return DruTasks(
        user=torch.as_tensor(np.asarray(user, dtype=np.int32), device=device),
        mem=f32(mem), cpus=f32(cpus), gpus=f32(gpus),
        order_key=f32(order_key),
        valid=torch.as_tensor(np.asarray(valid, dtype=bool), device=device))


def dru_rank(
    tasks: DruTasks,
    mem_div: torch.Tensor,   # [U] per-user mem divisor (share)
    cpu_div: torch.Tensor,   # [U]
    gpu_div: torch.Tensor,   # [U]
    *,
    gpu_mode: bool = False,
    backfill: Optional[torch.Tensor] = None,  # [T] f32 in [0, 1], or None
    backfill_weight: Optional[float] = None,
) -> DruResult:
    """Per-task cumulative DRU and the global fair-share order.

    gpu_mode selects the reference's `:pool.dru-mode/gpu` scoring
    (cumulative gpus/divisor) instead of max(mem, cpus) dominant share.
    `backfill` adds `backfill_weight * clip(backfill, 0, 1)` to each valid
    task's DRU before the order sort (bounded predicted-duration backfill);
    the returned `dru` stays the raw fair-share score."""
    user, valid = tasks.user, tasks.valid

    # padding sorts last in every sort: invalid users key as +inf
    perm = lexsort_perm(torch.where(valid, user, INT32_MAX), tasks.order_key)
    s_user = user[perm]
    s_valid = valid[perm]
    res = torch.stack([tasks.mem[perm], tasks.cpus[perm], tasks.gpus[perm]],
                      dim=-1)
    res = torch.where(s_valid[:, None], res, 0.0)
    cum = segmented_cumsum(res, torch.where(s_valid, s_user, -1))
    # `jnp.take(..., mode="clip")`: padding rows read a clamped user
    ui = s_user.long().clamp(0, mem_div.shape[0] - 1)
    if gpu_mode:
        dru_sorted = cum[:, 2] / gpu_div[ui].clamp_min(1e-30)
    else:
        dru_sorted = torch.maximum(cum[:, 0] / mem_div[ui].clamp_min(1e-30),
                                   cum[:, 1] / cpu_div[ui].clamp_min(1e-30))
    dru_sorted = torch.where(s_valid, dru_sorted, BIG)

    # back to original task order
    dru = dru_sorted[inverse_permutation(perm)]

    # global order: stable sort by dru, tie-broken by the per-user position
    # so a user's later task never schedules before an earlier one
    score = dru
    if backfill is not None:
        w = backfill_weight if backfill_weight is not None else 0.0
        score = torch.where(valid, dru + w * backfill.clamp(0.0, 1.0), BIG)
    order = lexsort_perm(score, tasks.order_key)
    rank = inverse_permutation(order)
    return DruResult(dru=dru, rank=rank.to(torch.int32),
                     order=order.to(torch.int32))


def dru_rank_pools(tasks: DruTasks, mem_div: torch.Tensor,
                   cpu_div: torch.Tensor, gpu_div: torch.Tensor) -> DruResult:
    """`dru_rank` over a leading pool axis (the reference's `jax.vmap` of
    it, `cook_tpu/ops/dru.py:126`): every field of `tasks` is [P, T] and
    the divisors [P, U].  Each pool ranks alone — its sorts and segmented
    sums never cross pools — so the batch is each pool's `dru_rank`,
    stacked.  Returns a DruResult of [P, T] tensors."""
    lanes = [dru_rank(DruTasks(*(t[p] for t in tasks)), mem_div[p],
                      cpu_div[p], gpu_div[p])
             for p in range(tasks.user.shape[0])]
    return DruResult(*(torch.stack(field) for field in zip(*lanes)))
