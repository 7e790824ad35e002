"""Reference-faithful CPU implementations of the three scheduling solves.

A numpy-only copy of `cook_tpu/ops/cpu_reference.py`, kept in the port so
that nothing here imports the JAX package.

These reproduce, in plain Python, the sequential algorithms of the reference
(Fenzo greedy placement; dru.clj sorted-merge ranking; rebalancer.clj
prefix-scan victim search).  They serve two purposes:

  1. parity oracles for the device solves (tests assert the device solve matches
     or beats these on packing efficiency / exact decisions);
  2. the CPU baseline that BASELINE.md requires us to measure against.

No code is copied from the reference; these are re-implementations of the
documented behavior (see each function's citation).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


# --------------------------------------------------------------------- DRU


def ref_dru_order(
    user: np.ndarray,        # [T] int user index
    mem: np.ndarray,         # [T]
    cpus: np.ndarray,        # [T]
    gpus: np.ndarray,        # [T]
    order_key: np.ndarray,   # [T] per-user order (smaller first)
    mem_div: np.ndarray,     # [U]
    cpu_div: np.ndarray,
    gpu_div: np.ndarray,
    gpu_mode: bool = False,
):
    """Sequential DRU scoring + merge, per dru.clj:50-126.

    Returns (dru[T], order) where order lists task indices by ascending
    (dru, order_key) — the k-way sorted-merge output.
    """
    t = len(user)
    dru = np.zeros(t)
    by_user: dict[int, list[int]] = {}
    for i in np.argsort(order_key, kind="stable"):
        by_user.setdefault(int(user[i]), []).append(int(i))
    for u, idxs in by_user.items():
        cum_mem = cum_cpu = cum_gpu = 0.0
        for i in idxs:
            cum_mem += mem[i]
            cum_cpu += cpus[i]
            cum_gpu += gpus[i]
            if gpu_mode:
                dru[i] = cum_gpu / gpu_div[u]
            else:
                dru[i] = max(cum_mem / mem_div[u], cum_cpu / cpu_div[u])
    order = sorted(range(t), key=lambda i: (dru[i], order_key[i]))
    return dru, np.array(order, dtype=np.int64)


# ------------------------------------------------------------------- match


@dataclass
class RefNode:
    mem: float
    cpus: float
    gpus: float = 0.0
    total_mem: float = 0.0
    total_cpus: float = 0.0

    def __post_init__(self):
        if self.total_mem == 0.0:
            self.total_mem = self.mem
        if self.total_cpus == 0.0:
            self.total_cpus = self.cpus


def cpu_mem_bin_packer_fitness(
    used_cpus: float, used_mem: float, req_cpus: float, req_mem: float,
    total_cpus: float, total_mem: float,
) -> float:
    """Fenzo's default fitness calculator (`cpuMemBinPacker`,
    config.clj:108): mean of post-assignment cpu and mem utilization —
    higher is better (prefers filling already-used nodes)."""
    f_cpu = (used_cpus + req_cpus) / total_cpus if total_cpus > 0 else 0.0
    f_mem = (used_mem + req_mem) / total_mem if total_mem > 0 else 0.0
    return (f_cpu + f_mem) / 2.0


def ref_greedy_match(
    demands: np.ndarray,        # [J, 3] (mem, cpus, gpus), in schedule order
    avail: np.ndarray,          # [N, 3] available resources
    totals: np.ndarray,         # [N, 2] (mem, cpus) capacities for fitness
    feasible_mask: Optional[np.ndarray] = None,  # [J, N] constraint mask
) -> np.ndarray:
    """Sequential greedy placement in the spirit of Fenzo `scheduleOnce`
    (used at scheduler.clj:617-687): jobs in priority order; each takes the
    feasible node with max binpacking fitness (first index on ties).
    Returns assignment [J] of node index or -1."""
    avail = avail.astype(np.float64).copy()
    used = totals.astype(np.float64) - avail[:, :2]
    out = np.full(len(demands), -1, dtype=np.int64)
    n = len(avail)
    for j, d in enumerate(demands):
        best, best_fit = -1, -1.0
        for i in range(n):
            if feasible_mask is not None and not feasible_mask[j, i]:
                continue
            if avail[i, 0] < d[0] or avail[i, 1] < d[1] or avail[i, 2] < d[2]:
                continue
            fit = cpu_mem_bin_packer_fitness(
                used[i, 1], used[i, 0], d[1], d[0], totals[i, 1], totals[i, 0]
            )
            if fit > best_fit:
                best, best_fit = i, fit
        if best >= 0:
            avail[best] -= d
            used[best, 0] += d[0]
            used[best, 1] += d[1]
            out[j] = best
    return out


def np_greedy_match(
    demands: np.ndarray,        # [J, 3]
    avail: np.ndarray,          # [N, 3]
    totals: np.ndarray,         # [N, 2]
    feasible_mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The same sequential greedy as `ref_greedy_match`, with the per-job
    inner loop vectorized over nodes — the strongest honest CPU baseline for
    the latency benchmarks (identical decisions, numpy speed)."""
    avail = avail.astype(np.float64).copy()
    totals = totals.astype(np.float64)
    used = totals - avail[:, :2]
    denom = np.maximum(totals, 1e-30)
    out = np.full(len(demands), -1, dtype=np.int64)
    for j, d in enumerate(demands):
        feas = (avail >= d).all(axis=1)
        if feasible_mask is not None:
            feas &= feasible_mask[j]
        if not feas.any():
            continue
        fit = ((used[:, 0] + d[0]) / denom[:, 0]
               + (used[:, 1] + d[1]) / denom[:, 1]) * 0.5
        fit[~feas] = -np.inf
        best = int(np.argmax(fit))
        avail[best] -= d
        used[best, 0] += d[0]
        used[best, 1] += d[1]
        out[j] = best
    return out


def packing_quality(
    demands: np.ndarray, assignment: np.ndarray
) -> dict:
    """Measures of a matched schedule: number placed + resources placed."""
    placed = assignment >= 0
    return {
        "num_placed": int(placed.sum()),
        "mem_placed": float(demands[placed, 0].sum()),
        "cpus_placed": float(demands[placed, 1].sum()),
    }


# ----------------------------------------------------------------- elastic


def ref_weighted_demand(res: np.ndarray, valid: np.ndarray,
                        half_life: float) -> np.ndarray:
    """Sequential oracle for ops.elastic.weighted_demand: [P, J, R]
    rank-ordered queued resources -> [P, R], queue position i discounted
    by 0.5 ** (i / half_life)."""
    p, j, r = res.shape
    out = np.zeros((p, r), dtype=np.float64)
    for pi in range(p):
        for ji in range(j):
            if not valid[pi, ji]:
                continue
            out[pi] += res[pi, ji] * 0.5 ** (ji / max(half_life, 1.0))
    return out


def ref_capacity_plan(demand: np.ndarray, supply: np.ndarray,
                      outstanding: np.ndarray, pool_valid: np.ndarray,
                      headroom: float):
    """Sequential oracle for ops.elastic.solve_capacity_plan: the same
    reclaim-first + proportional-loan plan, in plain numpy loops.
    Returns (reclaim [P,P,R], loan [P,P,R], unmet_shortage [P,R])."""
    p, r = demand.shape
    demand = np.where(pool_valid[:, None], demand, 0.0).astype(np.float64)
    supply = np.where(pool_valid[:, None], supply, 0.0).astype(np.float64)
    outstanding = np.where(
        (pool_valid[:, None] & pool_valid[None, :])[:, :, None],
        outstanding, 0.0).astype(np.float64)

    def safe_div(num, den):
        return num / den if den > 0 else 0.0

    # phase 1: lenders short on capacity reclaim proportionally across
    # their borrowers, capped by each borrower's free capacity
    reclaim = np.zeros((p, p, r))
    want = np.zeros((p, p, r))
    for lender in range(p):
        shortage = np.maximum(demand[lender] - supply[lender], 0.0)
        out_total = outstanding[lender].sum(axis=0)
        for ri in range(r):
            frac = min(safe_div(shortage[ri], out_total[ri]), 1.0)
            for b in range(p):
                want[lender, b, ri] = outstanding[lender, b, ri] * frac
    for b in range(p):
        asked = want[:, b, :].sum(axis=0)
        for ri in range(r):
            frac = min(safe_div(max(supply[b, ri], 0.0), asked[ri]), 1.0)
            for lender in range(p):
                if lender == b:
                    continue
                reclaim[lender, b, ri] = want[lender, b, ri] * frac
    supply_after = (supply + reclaim.sum(axis=1) - reclaim.sum(axis=0))

    # phase 2: new loans from net lenders (no inbound loans), keeping a
    # headroom fraction home; proportional lender-surplus x
    # borrower-shortage split
    loan = np.zeros((p, p, r))
    shortage2 = np.maximum(demand - supply_after, 0.0)
    holds_borrowed = (outstanding - reclaim).sum(axis=(0, 2)) > 0
    surplus = np.maximum(supply_after - demand, 0.0) * (1.0 - headroom)
    surplus[~(pool_valid & ~holds_borrowed)] = 0.0
    for ri in range(r):
        tot_surplus = surplus[:, ri].sum()
        tot_shortage = shortage2[:, ri].sum()
        move = min(tot_surplus, tot_shortage)
        for lender in range(p):
            for b in range(p):
                if lender == b or not (pool_valid[lender] and pool_valid[b]):
                    continue
                loan[lender, b, ri] = (
                    safe_div(surplus[lender, ri], tot_surplus)
                    * safe_div(shortage2[b, ri], tot_shortage) * move)
    unmet = np.maximum(shortage2 - loan.sum(axis=0), 0.0)
    return reclaim, loan, unmet


# --------------------------------------------------------------- rebalance


def ref_preemption_decision(
    task_host: np.ndarray,    # [T] int host index of each running task
    task_dru: np.ndarray,     # [T]
    task_mem: np.ndarray,     # [T]
    task_cpus: np.ndarray,    # [T]
    task_gpus: np.ndarray,    # [T]
    task_eligible: np.ndarray,  # [T] bool (quota/user filters, not yet preempted)
    spare: np.ndarray,        # [H, 3] (mem, cpus, gpus) spare per host
    host_ok: np.ndarray,      # [H] bool constraint pass
    demand: tuple,            # (mem, cpus, gpus) of pending job
    pending_dru: float,
    safe_dru_threshold: float,
    min_dru_diff: float,
):
    """Sequential victim search per rebalancer.clj:320-407.

    Tasks above the safe threshold whose dru exceeds pending_dru by more than
    min_dru_diff are preemptable.  Per host, walk tasks in descending dru,
    accumulating freed resources on top of spare; every prefix that covers
    the demand is a candidate whose score is the dru of its last (smallest-
    dru) task; spare-only feasibility scores +inf.  Return the candidate
    with max score: (host, [task indices]) or None.
    """
    d_mem, d_cpus, d_gpus = demand
    h = len(spare)
    mask = (
        task_eligible
        & (task_dru >= safe_dru_threshold)
        & ((task_dru - pending_dru) > min_dru_diff)
    )
    best_score, best = -1.0, None
    for host in range(h):
        if not host_ok[host]:
            continue
        cm, cc, cg = spare[host]
        if cm >= d_mem and cc >= d_cpus and cg >= d_gpus:
            if np.inf > best_score:
                best_score, best = np.inf, (host, [])
            continue
        idxs = [i for i in np.where((task_host == host) & mask)[0]]
        # descending dru, stable on index for determinism
        idxs.sort(key=lambda i: (-task_dru[i], i))
        chosen = []
        for i in idxs:
            cm += task_mem[i]
            cc += task_cpus[i]
            cg += task_gpus[i]
            chosen.append(int(i))
            if cm >= d_mem and cc >= d_cpus and cg >= d_gpus:
                score = float(task_dru[i])  # min dru in the prefix
                if score > best_score:
                    best_score, best = score, (host, list(chosen))
                break  # longer prefixes only lower the min-dru score
    return best
