"""Preemption-victim search as a tensor solve.

Port of `cook_tpu/ops/rebalance.py`, which the reference JIT-compiles
with XLA (it has no Pallas kernel): here the same steps run as PyTorch
tensor code on the caller's device.  Among all (host, prefix-of-highest-
DRU-tasks) candidates that free enough resources for the pending job,
pick the one whose minimum preempted DRU is largest (preempt the least-
deserving work possible); a host whose spare resources alone cover the
demand scores BIG (preempt nothing).

Tensorized as: mask-filter tasks -> sort by (host, -dru) -> per-host
segmented prefix sums seeded with host spare -> first-feasible-prefix per
host (the max-min-DRU prefix for that host) -> global argmax over hosts.

Parity notes:
  * the scalars (`pending_dru`, `safe_dru_threshold`, `min_dru_diff`)
    are float32, as the reference passes them: float64 comparisons would
    move the boundary cases.  `as_scalar` builds them;
  * `torch.argmax` returns the first maximal index, as `jnp.argmax`
    does: spare-only candidates all score BIG, so the first host with
    spare wins;
  * the prefix sums are a global cumsum minus each segment's base
    (`ops/common.segmented_cumsum`), whose rounding depends on the scan
    order: equal to the reference bit for bit only on exact-sum inputs.

Device notes: no step reads a device value on the host (`_at`), and
[T, R] rows are gathered with `index_select`, since on CUDA `x[idx]`
took ~80 us for 131072 rows of 16 bytes, 37% of a decision (an NVIDIA
H100 80GB HBM3, 700.00 W, under chip_smoke.py's rebalance cases).
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from cook_tpu_torch.ops.common import BIG, lexsort_perm, segmented_cumsum

# masked-out rows sort to this host key, after every real host
SENTINEL_HOST = torch.iinfo(torch.int32).max


class RebalanceState(NamedTuple):
    """Padded running-task + host tensors for one pool."""

    task_host: torch.Tensor      # [T] int32 host index
    task_dru: torch.Tensor       # [T] f32
    task_res: torch.Tensor       # [T, R] (mem, cpus, gpus[, disk...])
    # [T] bool (valid & quota/user filters & not preempted)
    task_eligible: torch.Tensor
    spare: torch.Tensor          # [H, R] spare resources per host
    # [H] bool (constraints pass for the pending job)
    host_ok: torch.Tensor


class PreemptionDecision(NamedTuple):
    host: torch.Tensor          # int32 chosen host, -1 if none
    # f32 min-preempted-dru of the decision (BIG = spare-only)
    score: torch.Tensor
    preempt_mask: torch.Tensor  # [T] bool — tasks to preempt
    # [R] resources freed on the chosen host (spare + preempted)
    freed: torch.Tensor


def as_scalar(value: Union[float, torch.Tensor],
              device: torch.device) -> torch.Tensor:
    """A 0-d float32 tensor on `device` (the reference's `jnp.float32`)."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading the index on the host:
    indexing with a 0-d integer tensor converts it to a Python int, which
    waits for the device."""
    return x.index_select(0, i.reshape(1)).squeeze(0)


def _decide_sorted_core(s_host, s_dru, s_res, s_valid, spare, host_ok,
                        demand) -> PreemptionDecision:
    """The decision tail shared by both entry points, over host-sorted
    arrays (s_* sorted by (host asc, dru desc)); returns the preempt mask
    in SORTED space.  `s_valid` is the per-decision validity (eligibility
    + dru thresholds); invalid rows must already contribute zero `s_res`.
    """
    t = s_host.shape[0]
    h = spare.shape[0]
    dev = s_host.device
    host_idx = s_host.clamp(0, h - 1).long()
    # Per-host prefix sums of freed resources, seeded with the host's spare.
    cum = segmented_cumsum(s_res, s_host)
    in_range = (s_host >= 0) & (s_host < h)
    spare_of = torch.where(in_range[:, None],
                           spare.index_select(0, host_idx),
                           torch.zeros((), dtype=spare.dtype, device=dev))
    freed = cum + spare_of
    prefix_feasible = (freed >= demand[None, :]).all(-1) & s_valid

    host_allowed = in_range & host_ok[host_idx]
    # Candidate score: dru of the last task in the prefix (== min in prefix,
    # since sorted desc).  Only the FIRST feasible prefix per host matters —
    # longer ones can only lower the min-dru — and within a host that is the
    # prefix ending at the first position where prefix_feasible flips true.
    feas_cum = segmented_cumsum(prefix_feasible.to(torch.int32), s_host)
    first_feasible = prefix_feasible & (feas_cum == 1)

    neg = torch.full((), -BIG, dtype=s_dru.dtype, device=dev)
    cand_score = torch.where(first_feasible & host_allowed, s_dru, neg)

    # Spare-only candidates: hosts whose spare covers demand preempt nothing
    # and score BIG (reference: Double/MAX_VALUE pseudo-task).
    spare_fits = (spare >= demand[None, :]).all(-1) & host_ok
    spare_score = torch.where(
        spare_fits, torch.full((), BIG, dtype=s_dru.dtype, device=dev), neg)

    best_task_pos = torch.argmax(cand_score)
    best_task_score = _at(cand_score, best_task_pos)
    best_spare_host = torch.argmax(spare_score)
    best_spare_score = _at(spare_score, best_spare_host)
    best_task_host = _at(s_host, best_task_pos)

    use_spare = best_spare_score >= best_task_score
    none_found = (best_task_score <= -BIG) & (best_spare_score <= -BIG)

    chosen_host = torch.where(use_spare, best_spare_host.to(torch.int32),
                              best_task_host)
    chosen_host = torch.where(none_found,
                              torch.full_like(chosen_host, -1), chosen_host)
    score = torch.where(use_spare, best_spare_score, best_task_score)

    # Preempt-mask: tasks in the chosen host's prefix up through best_task_pos.
    same_host = s_host == best_task_host
    in_prefix = (same_host & (torch.arange(t, device=dev) <= best_task_pos)
                 & s_valid)
    take_tasks = ~use_spare & ~none_found
    preempt_sorted = in_prefix & take_tasks

    freed_amount = torch.where(
        none_found,
        torch.zeros_like(demand),
        torch.where(use_spare, _at(spare, best_spare_host),
                    _at(freed, best_task_pos)),
    )
    return PreemptionDecision(
        host=chosen_host,
        score=torch.where(none_found, neg, score),
        preempt_mask=preempt_sorted,
        freed=freed_amount,
    )


def _sort_tasks(task_host, task_dru, task_eligible):
    """(perm, host_key): the order by (host asc, dru desc, index asc) with
    masked-out tasks sunk to the sentinel host, so they never join a real
    segment."""
    host_key = torch.where(
        task_eligible, task_host.to(torch.int32),
        torch.full((), SENTINEL_HOST, dtype=torch.int32,
                   device=task_host.device))
    # lexsort_perm's sorts are stable, so equal (host, dru) rows keep
    # index order: the reference's third key, arange(T), comes for free
    return lexsort_perm(host_key, -task_dru), host_key


def find_preemption_decision(
    state: RebalanceState,
    demand: torch.Tensor,        # [R] pending job resources
    pending_dru: torch.Tensor,   # 0-d float32
    safe_dru_threshold: torch.Tensor,
    min_dru_diff: torch.Tensor,
) -> PreemptionDecision:
    mask = (
        state.task_eligible
        & (state.task_dru >= safe_dru_threshold)
        & ((state.task_dru - pending_dru) > min_dru_diff)
    )
    perm, host_key = _sort_tasks(state.task_host, state.task_dru, mask)
    s_host = host_key[perm]
    s_dru = state.task_dru[perm]
    s_valid = mask[perm]
    s_res = torch.where(s_valid[:, None],
                        state.task_res.index_select(0, perm),
                        torch.zeros((), dtype=state.task_res.dtype,
                                    device=perm.device))

    decision = _decide_sorted_core(s_host, s_dru, s_res, s_valid,
                                   state.spare, state.host_ok, demand)
    # scatter the sorted-space mask back to original task order
    preempt = torch.zeros_like(decision.preempt_mask)
    preempt[perm] = decision.preempt_mask
    return decision._replace(preempt_mask=preempt)


class SortedRebalanceState(NamedTuple):
    """Task tensors pre-sorted by (host asc, dru desc) ONCE per cycle.

    The full find_preemption_decision re-sorts all T tasks every call; at
    the reference's max-preemption=100 decisions per cycle that is 100
    sorts of the same data.  DRU values and task rows are immutable
    within a fast cycle (see decide_from_sorted for the divergences), so
    the sort is amortized: each decision is a per-decision [T] validity
    mask + segmented cumsums + argmax — no sort.
    """

    perm: torch.Tensor    # [T] original row index per sorted position
    s_host: torch.Tensor  # [T] host key (sentinel INT32_MAX for ineligible)
    s_dru: torch.Tensor   # [T]
    s_res: torch.Tensor   # [T, R]


def sort_rebalance_state(
    task_host: torch.Tensor,
    task_dru: torch.Tensor,
    task_res: torch.Tensor,
    task_eligible: torch.Tensor,
) -> SortedRebalanceState:
    """One multi-key sort of the cycle's tasks (see the class docstring)."""
    perm, host_key = _sort_tasks(task_host, task_dru, task_eligible)
    return SortedRebalanceState(
        perm=perm,
        s_host=host_key[perm],
        s_dru=task_dru[perm],
        s_res=task_res.index_select(0, perm),
    )


def decide_from_sorted(
    ss: SortedRebalanceState,
    row_ok_sorted: torch.Tensor,  # [T] per-decision validity, sorted space
    dru_sorted: torch.Tensor,     # [T] LIVE dru values, sorted space
    spare: torch.Tensor,          # [H, R]
    host_ok: torch.Tensor,        # [H] bool
    demand: torch.Tensor,         # [R]
    pending_dru: torch.Tensor,
    safe_dru_threshold: torch.Tensor,
    min_dru_diff: torch.Tensor,
) -> PreemptionDecision:
    """find_preemption_decision against a pre-sorted cycle state.

    Masked rows (preempted earlier this cycle, quota-restricted, below
    threshold for THIS pending job) stay in their host segment with zero
    resource contribution, which yields the same prefix sums over the
    remaining valid rows as a fresh sort would.  `dru_sorted` carries the
    LIVE rescored values (cheap per-decision gather), so the safety
    threshold, min-diff guard, and min-preempted-dru score are exact; the
    residual divergences vs the exact entry point are (a) the within-host
    ORDER is frozen at cycle start — a user whose dru changed mid-cycle
    keeps the stale prefix order — and (b) simulated launches consume
    host spare instead of joining the task rows (they cannot be
    re-preempted within the cycle).

    The returned preempt_mask is in SORTED space; map positions back with
    `ss.perm`."""
    h = spare.shape[0]
    m = (
        row_ok_sorted
        & (dru_sorted >= safe_dru_threshold)
        & ((dru_sorted - pending_dru) > min_dru_diff)
        & (ss.s_host < h)
    )
    res_eff = torch.where(m[:, None], ss.s_res,
                          torch.zeros((), dtype=ss.s_res.dtype,
                                      device=ss.s_res.device))
    return _decide_sorted_core(ss.s_host, dru_sorted, res_eff, m,
                               spare, host_ok, demand)
