"""Elastic capacity plane: the loan/reclaim assignment as a tensor solve.

Port of `cook_tpu/ops/elastic.py` (two `jax.jit` functions there, plain
tensor code here on an explicit device; no TPU kernel reaches this
module, so no hand kernel replaces one).  Cook's pools partition a fixed
fleet, so one pool starves while another idles (the gap Aryl's capacity
loaning closes, arXiv:2202.07896).  The CapacityPlanner
(`elastic/planner.py`) assembles per-pool demand and supply tensors each
planning interval and solves the loan/reclaim assignment here, as one
bucket-padded batched problem:

  * `weighted_demand` — fold each pool's DRU-ranked pending queue
    ([P, J, R] resource vectors, rank order along J) into a [P, R]
    demand tensor.  Rank position discounts demand exponentially: the
    queue head counts at full weight, the deep tail barely counts.
  * `solve_capacity_plan` — given demand/supply [P, R] and the
    outstanding-loan ledger [P, P, R], produce reclaim and new-loan
    matrices.  Reclaim-first: a lender short on capacity calls its
    outstanding loans home (proportionally across borrowers, capped by
    each borrower's free capacity); the remaining shortage is covered by
    new loans from pools with surplus, split proportionally (a rank-1
    outer product over lender-surplus x borrower-shortage), with a
    headroom fraction of every surplus kept home.

`half_life` and `headroom` are Python floats or 0-d tensors: either way
they ride as operands of the same ops, so a changed value launches the
same work (the reference's traced scalars).  Divisions are guarded as in
the reference's `_safe_div`: the divisor is replaced before dividing, so
no `inf` or `nan` is made and then masked.

Two decisions of the plan are discrete, and the card, the CPU and the
JAX package must take them alike:

  * a full reclaim (the shortage covers the whole loan, the borrower's
    free capacity covers the whole ask) returns `outstanding` bit for
    bit: both fractions are min(a / b, 1) with a >= b, a correctly
    rounded a / b is then >= 1, and x * 1.0 is x;
  * `holds_borrowed` (a pool with a loan still inbound may not lend) is
    `any(outstanding - reclaim > 0)`.  Every residual is >= 0 (each
    fraction is <= 1, and x * f with f <= 1 rounds to at most x), so
    this is the reference's `sum(...) > 0` with no dependence on the
    order of the sum.

CPU parity oracles: `ops.cpu_reference.ref_weighted_demand` /
`ref_capacity_plan`.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

# resource dimensions a capacity plan moves (mem MB, cpus, gpus)
ELASTIC_RESOURCE_DIMS = ("mem", "cpus", "gpus")

Scalar = Union[float, torch.Tensor]


class ElasticProblem(NamedTuple):
    """Padded per-pool tensors for one planning interval."""

    demand: torch.Tensor       # [P, R] rank-weighted queued demand
    supply: torch.Tensor       # [P, R] spare (offerable) capacity
    outstanding: torch.Tensor  # [P, P, R] outstanding[l, b]: loaned l -> b
    pool_valid: torch.Tensor   # [P] bool (padded rows False)


class ElasticPlan(NamedTuple):
    reclaim: torch.Tensor    # [P, P, R] reclaim[l, b]: b returns to l
    loan: torch.Tensor       # [P, P, R] new loans l -> b
    shortage: torch.Tensor   # [P, R] unmet shortage after the plan


def _scalar(value: Scalar, like: torch.Tensor) -> Scalar:
    """A float stays a float (a kernel argument); a tensor moves to the
    problem's device and dtype."""
    if isinstance(value, torch.Tensor):
        return value.to(device=like.device, dtype=like.dtype)
    return float(value)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    ok = den > 0
    return torch.where(ok, num / torch.where(ok, den, 1.0), 0.0)


def weighted_demand(res: torch.Tensor, valid: torch.Tensor,
                    half_life: Scalar) -> torch.Tensor:
    """[P, J, R] rank-ordered queued-job resources -> [P, R] demand.

    Weight of queue position i is 0.5 ** (i / half_life): the head of
    the DRU order counts fully, demand `half_life` positions deep counts
    half."""
    j = res.shape[1]
    half_life = _scalar(half_life, res)
    if isinstance(half_life, torch.Tensor):
        half_life = torch.clamp(half_life, min=1.0)
    else:
        half_life = max(half_life, 1.0)
    pos = torch.arange(j, dtype=res.dtype, device=res.device)
    w = torch.pow(0.5, pos / half_life)
    return torch.sum(res * (valid.to(res.dtype) * w)[:, :, None], dim=1)


def solve_capacity_plan(problem: ElasticProblem,
                        headroom: Scalar) -> ElasticPlan:
    """One device call plans every pool's loans and reclaims at once."""
    valid = problem.pool_valid
    pair_valid = valid[:, None] & valid[None, :]
    demand = torch.where(valid[:, None], problem.demand, 0.0)
    supply = torch.where(valid[:, None], problem.supply, 0.0)
    outstanding = torch.where(pair_valid[:, :, None], problem.outstanding,
                              0.0)
    headroom = _scalar(headroom, demand)

    # ---- phase 1: reclaim-first.  Lenders short on capacity call loans
    # home before anyone considers new loans (or in-pool preemption).
    shortage = torch.clamp(demand - supply, min=0.0)                # [P, R]
    out_total = torch.sum(outstanding, dim=1)                       # [P, R]
    want_frac = torch.clamp(_safe_div(shortage, out_total), max=1.0)
    want = outstanding * want_frac[:, None, :]                      # [P,b,R]
    # borrower b can only return capacity it is not running work on:
    # cap total returns from b at b's free (spare) capacity, scaling
    # every lender's claim proportionally when they compete for it
    asked_of = torch.sum(want, dim=0)                               # [b, R]
    free = torch.clamp(supply, min=0.0)
    return_frac = torch.clamp(_safe_div(free, asked_of), max=1.0)  # [b, R]
    reclaim = want * return_frac[None, :, :]
    # no self-loans can exist, but keep the diagonal structurally zero
    eye = torch.eye(reclaim.shape[0], dtype=torch.bool,
                    device=reclaim.device)
    reclaim = torch.where(eye[:, :, None], 0.0, reclaim)

    supply_after = supply + torch.sum(reclaim, dim=1) \
        - torch.sum(reclaim, dim=0)

    # ---- phase 2: new loans cover what reclaim could not.  Only pools
    # with no inbound loans may lend (no loan chains), and a headroom
    # fraction of every surplus stays home.
    shortage2 = torch.clamp(demand - supply_after, min=0.0)
    can_lend = valid & ~_holds_borrowed(outstanding, reclaim)
    surplus = torch.clamp(supply_after - demand, min=0.0) * (1.0 - headroom)
    surplus = torch.where(can_lend[:, None], surplus, 0.0)
    tot_surplus = torch.sum(surplus, dim=0)                         # [R]
    tot_shortage = torch.sum(shortage2, dim=0)                      # [R]
    move = torch.minimum(tot_surplus, tot_shortage)                 # [R]
    loan = (_safe_div(surplus, tot_surplus)[:, None, :]
            * _safe_div(shortage2, tot_shortage)[None, :, :]
            * move[None, None, :])
    loan = torch.where((eye | ~pair_valid)[:, :, None], 0.0, loan)

    unmet = torch.clamp(shortage2 - torch.sum(loan, dim=0), min=0.0)
    return ElasticPlan(reclaim=reclaim, loan=loan, shortage=unmet)


def _holds_borrowed(outstanding: torch.Tensor,
                    reclaim: torch.Tensor) -> torch.Tensor:
    return torch.any((outstanding - reclaim) > 0, dim=2).any(dim=0)


def holds_borrowed(problem: ElasticProblem,
                   plan: ElasticPlan) -> torch.Tensor:
    """[P] bool: pools still holding borrowed capacity after the plan's
    reclaims (those may not lend in its phase 2)."""
    valid = problem.pool_valid
    pair_valid = valid[:, None] & valid[None, :]
    return _holds_borrowed(
        torch.where(pair_valid[:, :, None], problem.outstanding, 0.0),
        plan.reclaim)
