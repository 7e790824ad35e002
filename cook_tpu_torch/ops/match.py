"""Jobs x nodes bin-packing as a device solve: the Fenzo replacement.

Port of `cook_tpu/ops/match.py` (see its docstring for the scheme):

  * `greedy_match`: the exact sequential greedy (the reference's
    `lax.scan` becomes a Python loop of vectorized [N] steps).
  * `chunked_match`: the fast path — per chunk of K jobs, a candidate pass
    then `rounds` conflict-resolution rounds on [K, kc] candidate tensors.
    The candidate pass is an exact top-kc (`xla`), a class-shared top-kc
    (`bucketed`), or the hand-written Hopper `best_node` kernel (`pallas`,
    the backend name kept from the reference's configs).
  * `greedy_match_pools` / `chunked_match_pools`: the reference's
    `jax.vmap`s of the two over a leading pool axis (`match.py:418-420`),
    written with that axis in every tensor; the one-problem functions are
    the batch of one, so the serial and the pool-batched solves run the
    same code.

The reference's `approx_max_k` / `top_k` pick becomes an exact top-kc that
breaks ties by first index (a stable descending sort): `torch.topk` orders
ties differently from JAX.  Assignments are int32 at the public functions;
index sites convert to int64.  `index_add_` on CUDA adds in atomic order;
the simulator's demands are integers and halves in float32, so its sums
are exact whatever the order.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from cook_tpu_torch.ops.best_node import best_node
from cook_tpu_torch.ops.common import BIG, binpack_fitness


class MatchProblem(NamedTuple):
    """One pool's padded matching problem (field names and layouts of the
    reference's MatchProblem)."""

    demands: torch.Tensor     # [J, R] f32 (mem, cpus, gpus[, disk...])
    job_valid: torch.Tensor   # [J] bool
    avail: torch.Tensor       # [N, R] f32 currently-available resources
    totals: torch.Tensor      # [N, 2] f32 (mem, cpus) capacity
    node_valid: torch.Tensor  # [N] bool
    feasible: Optional[torch.Tensor] = None  # [J, N] bool constraint mask
    # [N] additive score term (topology distance bonus); the pallas
    # candidate backend ignores it, as the reference's does
    node_bonus: Optional[torch.Tensor] = None


class MatchResult(NamedTuple):
    assignment: torch.Tensor  # [J] int32 node index or -1
    new_avail: torch.Tensor   # [N, R] availability after placements


def from_numpy(demands, job_valid, avail, totals, node_valid, feasible=None,
               node_bonus=None, *, device) -> MatchProblem:
    """The numpy arrays a reference `MatchProblem` is built from, as the
    port's tensors on `device` (floats to float32 and masks to bool, the
    dtypes the reference's arrays take with 64-bit mode off)."""
    def f32(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    def b(a):
        return torch.as_tensor(np.asarray(a, dtype=bool), device=device)

    return MatchProblem(
        demands=f32(demands), job_valid=b(job_valid), avail=f32(avail),
        totals=f32(totals), node_valid=b(node_valid),
        feasible=None if feasible is None else b(feasible),
        node_bonus=None if node_bonus is None else f32(node_bonus))


def backend_flags(backend: str) -> dict:
    """Map a candidate-pass backend name to chunked_match flags; the ONE
    place backend strings are interpreted (and rejected)."""
    if backend not in ("xla", "pallas", "bucketed"):
        raise ValueError(f"unknown match backend {backend!r} "
                         "(expected xla | pallas | bucketed)")
    return {"use_pallas": backend == "pallas",
            "bucketed": backend == "bucketed"}


def vmap_safe_backend(backend: str) -> str:
    """Backend of a block- or pool-batched chunked solve: the reference
    coerces pallas -> xla there (its pallas_call batching under jax.vmap
    is not guaranteed), and the port keeps its choice so both packages
    solve the same problem the same way."""
    backend_flags(backend)  # validate the name with the canonical error
    return "xla" if backend == "pallas" else backend


def _as_pools(problem: MatchProblem) -> MatchProblem:
    """One problem as a batch of one pool: a leading axis of 1 on every
    field (views, no copy)."""
    return MatchProblem(*(None if t is None else t[None] for t in problem))


def _lane(result: MatchResult) -> MatchResult:
    """The one pool of a batch-of-one result."""
    return MatchResult(assignment=result.assignment[0],
                       new_avail=result.new_avail[0])


def greedy_match_pools(problem: MatchProblem) -> MatchResult:
    """Pool-batched exact greedy (the reference's `jax.vmap(greedy_match)`):
    every field carries a leading pool axis P (demands [P, J, R], avail
    [P, N, R], ...).  Step i places job row i of every pool at once: the
    scores are [P, N], the argmax runs per pool (first index on a tie),
    and the chosen node's availability is read and written back through
    the flat index p * N + node.  Nothing syncs the host: the chosen
    nodes stay tensors.  Returns assignment [P, J] int32 and new_avail
    [P, N, R]."""
    avail = problem.avail.clone()
    p, n, r = avail.shape
    rows = avail.view(p * n, r)   # shares avail's storage
    totals, node_valid = problem.totals, problem.node_valid
    denom = totals.clamp_min(1e-30)
    base = torch.arange(p, device=avail.device) * n
    j = problem.demands.shape[1]
    assignment = torch.empty((p, j), dtype=torch.int32, device=avail.device)
    for i in range(j):
        demand = problem.demands[:, i]                        # [P, R]
        fits = (avail >= demand[:, None, :]).all(-1)         # [P, N]
        feasible = fits & node_valid & problem.job_valid[:, i, None]
        if problem.feasible is not None:
            feasible = feasible & problem.feasible[:, i]
        used = totals - avail[..., :2]
        fit = binpack_fitness(used[..., 0], used[..., 1], demand[:, 0:1],
                              demand[:, 1:2], denom[..., 0], denom[..., 1])
        if problem.node_bonus is not None:
            fit = fit + problem.node_bonus
        score = torch.where(feasible, fit, torch.full_like(fit, -BIG))
        best = torch.argmax(score, dim=1)                     # [P]
        placed = score.gather(1, best[:, None])[:, 0] > -BIG
        take = torch.where(placed[:, None], demand, torch.zeros_like(demand))
        flat = base + best
        rows.index_copy_(0, flat, rows.index_select(0, flat) - take)
        assignment[:, i] = torch.where(placed, best, -1)
    return MatchResult(assignment=assignment, new_avail=avail)


def greedy_match(problem: MatchProblem) -> MatchResult:
    """Sequential-order greedy matcher (exact Fenzo-order semantics; J
    steps of O(N) vector work each, with no host synchronisation): the
    pool-batched greedy on a batch of one."""
    return _lane(greedy_match_pools(_as_pools(problem)))


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Along the last axis, the index of the first True (0 when none) —
    jnp.argmax over a bool row."""
    return torch.argmax(mask.to(torch.uint8), dim=-1)


def _sorted_segments(keys: torch.Tensor):
    """Per row of keys [B, K]: the stable ascending sort's permutation
    (ties keep index order, the reference's `lexsort_perm(keys, arange)`),
    the sorted keys, and each sorted position's segment start (the first
    position of its run of equal keys)."""
    perm = torch.sort(keys, dim=1, stable=True).indices
    sk = keys.gather(1, perm)
    starts = torch.ones_like(sk, dtype=torch.bool)
    starts[:, 1:] = sk[:, 1:] != sk[:, :-1]
    pos = torch.arange(keys.shape[1], device=keys.device).expand_as(keys)
    seg_first = torch.cummax(torch.where(starts, pos, 0), dim=1).values
    return perm, sk, seg_first, pos


def conflict_round_batched(avail, assignment, cand_val, cand_idx, d, n, *,
                           recheck_mask=None):
    """`conflict_round` for a leading batch axis of independent problems
    (the reference's `jax.vmap(conflict_round)`): avail [B, N, R],
    assignment [B, S], cand_val / cand_idx [B, S, kc], d [B, S, R] and the
    optional recheck_mask [B, S, N].  Every sort, rank and prefix sum runs
    along the slot axis of one row, so each problem gets exactly what the
    one-problem round gives it; the accepted demand scatters through the
    flat index b * N + node.

    Bfloat16 cost tensors (MatchConfig.quantized) are read as float32 and
    the round's sums run in float32: the prefix accept adds up to a
    chunk's demands, far past bfloat16's 8 significant bits, and summed in
    bfloat16 it admits several times a host's capacity.  The availability
    the round returns is rounded back to the cost dtype, as the
    reference's loop carries it."""
    cost = avail.dtype
    avail, d = avail.float(), d.float()
    bsz, k = assignment.shape
    n_res = avail.shape[-1]
    dev = avail.device
    rows = torch.arange(bsz, device=dev)[:, None]
    ci = cand_idx.long()
    cand_ok = cand_val > -BIG                                  # [B, K, kc]
    unplaced = assignment < 0
    feas_cand = ((avail[rows[..., None], ci] >= d[:, :, None, :]).all(-1)
                 & cand_ok & unplaced[..., None])
    if recheck_mask is not None:
        feas_cand &= torch.gather(recheck_mask, 2, ci)
    has = feas_cand.any(dim=-1)
    f0 = _first_true(feas_cand)
    pick0 = torch.where(has, cand_idx.gather(2, f0[..., None])[..., 0], n)
    if cand_idx.shape[-1] == 1:
        pick, take = pick0, has
    else:
        # contention spreading: c-th contender takes its c-th feasible
        # candidate
        perm, _, seg_first, pos = _sorted_segments(pick0)
        c = torch.empty_like(perm).scatter_(1, perm, pos - seg_first)
        cum = torch.cumsum(feas_cand, dim=-1)
        sel = (cum == (c + 1)[..., None]) & feas_cand
        pick = cand_idx.gather(2, _first_true(sel)[..., None])[..., 0]
        take = has & sel.any(dim=-1)
    pick_key = torch.where(take, pick, n)
    # prefix-accept: per-node cumulative demand among this round's picks
    # must fit availability (segmented over sorted picks)
    perm2, sp2, seg_first2, _ = _sorted_segments(pick_key)
    d_sorted = d.gather(1, perm2[..., None].expand(-1, -1, n_res))
    d2 = torch.where((sp2 < n)[..., None], d_sorted, 0.0)
    cums = torch.cumsum(d2, dim=1)
    prev = (seg_first2 - 1).clamp_min(0)[..., None].expand(-1, -1, n_res)
    base = torch.where((seg_first2 > 0)[..., None], cums.gather(1, prev), 0.0)
    segcum = cums - base
    have2 = avail[rows, sp2.clamp(0, n - 1).long()]
    accept2 = (sp2 < n) & (segcum <= have2 + 1e-9).all(-1)
    accept = torch.empty_like(accept2).scatter_(1, perm2, accept2)
    assignment = torch.where(accept, pick, assignment).to(torch.int32)
    flat = (rows * avail.shape[1] + torch.where(accept, pick, n - 1)).long()
    delta = torch.zeros_like(avail).view(-1, n_res).index_add_(
        0, flat.view(-1), torch.where(accept[..., None], d, 0.0)
        .view(-1, n_res)).view(avail.shape)
    return (avail - delta).to(cost), assignment


def conflict_round(avail, assignment, cand_val, cand_idx, d, n, *,
                   recheck_mask=None):
    """One conflict-resolution round over candidate lists — THE shared
    acceptance step of every chunked candidate backend:

      1. each unplaced job takes its first still-feasible candidate;
      2. contenders for the same node spread onto their c-th feasible
         alternates (skipped for single-candidate lists);
      3. a pick is accepted iff the node holds the cumulative demand of
         earlier accepted picks (segmented prefix-sum over sorted picks,
         with the reference's 1e-9 tolerance);
      4. accepted demand is scatter-subtracted from availability.

    avail [N, R], assignment [K], cand_val / cand_idx [K, kc], d [K, R];
    `recheck_mask` ([K, N] bool) re-applies a constraint mask on the
    candidate gather.  Returns (new_avail, assignment).  The batch of one
    of `conflict_round_batched`."""
    new_avail, new_assignment = conflict_round_batched(
        avail[None], assignment[None], cand_val[None], cand_idx[None],
        d[None], n,
        recheck_mask=None if recheck_mask is None else recheck_mask[None])
    return new_avail[0], new_assignment[0]


def _top_kc(score: torch.Tensor, kc: int):
    """Exact top-kc along the last axis, ties to the first index (jax
    `top_k`'s order)."""
    s = torch.sort(score, dim=-1, descending=True, stable=True)
    return s.values[..., :kc], s.indices[..., :kc].to(torch.int32)


def _bucket_ids(d: torch.Tensor, active: torch.Tensor, n_res: int):
    """Demand classes of d [P, K, R] (levels taken per pool over its
    active rows): 8 log-mem levels x 4 log-cpu levels x gpu bit (x disk
    bit when the resource column exists)."""
    def levels(x, n_levels):
        lo = torch.where(active, x, torch.inf).amin(-1, keepdim=True)
        hi = torch.where(active, x, -torch.inf).amax(-1, keepdim=True)
        scale = torch.clamp_min(hi - lo, 1e-6)
        lv = torch.floor((x - lo) / scale * n_levels)
        return torch.clamp(lv, 0, n_levels - 1).to(torch.int32)

    b = levels(torch.log(d[..., 0].clamp_min(1e-3)), 8) * 4
    b = b + levels(torch.log(d[..., 1].clamp_min(1e-3)), 4)
    b = b * 2 + (d[..., 2] > 0).to(torch.int32)
    if n_res > 3:
        b = b * 2 + (d[..., 3] > 0).to(torch.int32)
    return b


def chunked_match_pools(
    problem: MatchProblem,
    *,
    chunk: int = 1024,
    rounds: int = 4,
    kc: int = 128,
    use_approx: bool = True,
    passes: int = 2,
    use_pallas: bool = False,
    bucketed: bool = False,
) -> MatchResult:
    """Pool-batched fast chunked greedy matcher (the reference's
    `jax.vmap(chunked_match)`; see `cook_tpu/ops/match.py`): every field
    carries a leading pool axis P, and each chunk's candidate pass and
    conflict rounds (`conflict_round_batched`) run over all P pools at
    once, each pool's sorts, ranks and prefix sums along its own rows.
    Returns assignment [P, J] int32 and new_avail [P, N, R].

    `use_approx` is kept for the reference's signature; the port's top-kc
    is exact either way (the reference's `approx_max_k` orders ties among
    equal scores differently on some inputs: ROADMAP Queue C port item 3).
    `use_pallas` swaps the candidate pass for the `best_node` kernel, one
    launch per pool, which returns each job's single best node (kc is
    effectively 1, so give it more `passes`); the pool-batched scheduler
    pass never asks for it (`vmap_safe_backend`).  `bucketed` computes one
    candidate list per demand class and needs passes >= 2 (the final pass
    is the exact per-job cleanup)."""
    p, j = problem.demands.shape[:2]
    n = problem.avail.shape[1]
    if j % chunk:
        raise ValueError(f"pad jobs ({j}) to a multiple of chunk ({chunk})")
    if use_pallas and bucketed:
        raise ValueError("pick one candidate backend")
    if bucketed and passes < 2:
        raise ValueError("bucketed candidate mode requires passes >= 2 "
                         "(the final pass is the exact per-job cleanup)")
    kc = min(kc, n)
    n_res = problem.demands.shape[-1]
    totals, node_valid = problem.totals, problem.node_valid
    denom = totals.clamp_min(1e-30)
    n_buckets = 8 * 4 * 2 * (2 if n_res > 3 else 1)
    # best_node: with a mask, node validity rides in the mask (as in the
    # reference's candidate pass)
    valid_arg = (node_valid if problem.feasible is None
                 else torch.ones_like(node_valid))

    def score_topk(avail, demand_matrix, gate):
        """Shared candidate scoring: feasibility x fitness over the rows of
        `demand_matrix` ([P, M, R], jobs or demand classes), gated by
        `gate` ([P, M, N]-broadcastable), -> top-kc per row."""
        fits = (avail[:, None, :, :] >= demand_matrix[:, :, None, :]).all(-1)
        feasible = fits & gate
        used0 = totals[..., 0] - avail[..., 0]
        used1 = totals[..., 1] - avail[..., 1]
        fit = binpack_fitness(used0[:, None, :], used1[:, None, :],
                              demand_matrix[..., 0:1],
                              demand_matrix[..., 1:2],
                              denom[:, None, :, 0], denom[:, None, :, 1])
        if problem.node_bonus is not None:
            fit = fit + problem.node_bonus[:, None, :]
        return _top_kc(torch.where(feasible, fit, -BIG), kc)

    avail = problem.avail
    out = []
    for c0 in range(0, j, chunk):
        d = problem.demands[:, c0:c0 + chunk]
        ok = problem.job_valid[:, c0:c0 + chunk]
        fr = (problem.feasible[:, c0:c0 + chunk]
              if problem.feasible is not None else None)
        mask_arg = (fr & node_valid[:, None, :]
                    if use_pallas and fr is not None else None)

        def candidate_pass(avail, assignment, use_bucket):
            # full fitness pass for still-unplaced jobs vs current avail
            unplaced = assignment < 0
            if use_bucket:
                active = ok & unplaced
                bid = _bucket_ids(d, active, n_res).long()
                bdem = torch.zeros((p, n_buckets, n_res), dtype=d.dtype,
                                   device=d.device).scatter_reduce_(
                    1, bid[..., None].expand(-1, -1, n_res),
                    torch.where(active[..., None], d, 0.0), "amax")
                bval, bidx = score_topk(avail, bdem, node_valid[:, None, :])
                per_job = bid[..., None].expand(-1, -1, bval.shape[-1])
                return (torch.where(active[..., None],
                                    bval.gather(1, per_job), -BIG),
                        bidx.gather(1, per_job))
            if use_pallas:
                # placed/invalid jobs are excluded by an unsatisfiable
                # demand
                d_eff = torch.where((ok & unplaced)[..., None], d, 2 * BIG)
                picks = [best_node(d_eff[q], avail[q], totals[q],
                                   valid_arg[q],
                                   None if mask_arg is None else mask_arg[q])
                         for q in range(p)]
                val = torch.stack([v for v, _ in picks])
                idx = torch.stack([i for _, i in picks])
                return val[..., None], idx.clamp_min(0)[..., None]
            gate = node_valid[:, None, :] & (ok & unplaced)[..., None]
            if fr is not None:
                gate = gate & fr
            return score_topk(avail, d, gate)

        assignment = torch.full((p, d.shape[1]), -1, dtype=torch.int32,
                                device=d.device)
        recheck = fr if bucketed else None
        for pas in range(passes):
            # bucketed mode: class-shared candidates for the early passes,
            # then ONE exact per-job pass for the stragglers
            cand_val, cand_idx = candidate_pass(
                avail, assignment, use_bucket=bucketed and pas < passes - 1)
            for _ in range(rounds):
                avail, assignment = conflict_round_batched(
                    avail, assignment, cand_val, cand_idx, d, n,
                    recheck_mask=recheck)
        out.append(assignment)
    return MatchResult(assignment=torch.cat(out, dim=1), new_avail=avail)


def chunked_match(problem: MatchProblem, **knobs) -> MatchResult:
    """Fast chunked greedy matcher on one problem (see
    `cook_tpu/ops/match.py` and `chunked_match_pools`, whose knobs it
    takes): the pool-batched matcher on a batch of one, so that the
    serial and the pool-batched solves are one code path."""
    return _lane(chunked_match_pools(_as_pools(problem), **knobs))
