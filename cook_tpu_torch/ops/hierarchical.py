"""Hierarchical matcher: one giant pool via block decomposition.

Port of `cook_tpu/ops/hierarchical.py` (see its docstring for the
scheme).  Nodes group into B contiguous topology blocks and the pool
solves in three passes:

  1. **coarse** — jobs x blocks on the block aggregates (summed free
     capacity, summed totals, the per-resource max single node as the
     feasibility gate): the masked chunked matcher (`xla`) or the
     hand-written Hopper `coarse_pass` kernel, every chunk's `best_block`
     scoring and single-candidate conflict rounds in one launch (`pallas`,
     `_coarse_pallas`);
  2. **fine** — jobs scatter to their blocks (host side, schedule order,
     slot-cap overflow spills) and every block's [slots, nodes_per_block]
     problem solves as one batch with blocks as the leading axis: a
     pool-batched chunked solve, blocks as pools (`xla`,
     `ops/match.chunked_match_pools`) or, per pass, the hand-written Hopper
     `best_node_batched` kernel plus batched conflict rounds (`pallas`,
     `_fine_fused`);
  3. **refine** — bounded extra coarse+fine rounds re-offer every leftover
     against the updated availability, at the same shapes.

The block axis pads to a power-of-two bucket with all-invalid lanes
(`parallel/mesh.invalid_match_problem`), as in the reference; on one card
there is no mesh to shard it over.

Gangs (`gang_id` / `gang_need`, reference :519-537, :649-697, :718-757,
:890-915): each gang routes coarse as ONE row, its leader carrying the
gang's summed demand, gated on the member-wise max demand and on the
block holding at least k valid hosts (`block_count`); members inherit the
leader's block.  The coarse backend is then the masked `xla` one, as in
the reference (the `coarse_pass` kernel has no per-row host-count gate).
After every fine pass and refine round `ops/gang.gang_filter` strips any
gang that did not land whole in one block on distinct hosts, and
`release_assignments` returns its demand to the live availability.

Not ported yet: the superblock layer (`superblock_nodes > 0`:
`gather_super`, `_coarse_batched_solve`, `coarse_two_level`), which
raises NotImplementedError.  The reference's data-plane families
(`hier-coarse`, `hier-fine`) label the passes' fetches, and its compile
observatory hears each pass's padded shape.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from cook_tpu_torch.ops.best_node import fits
from cook_tpu_torch.ops.best_node_batched import best_node_batched
from cook_tpu_torch.ops.coarse_pass import check_fits, coarse_pass
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.ops.common import BIG, bucket_size, fetch_result
from cook_tpu_torch.ops.gang import gang_filter, release_assignments
from cook_tpu_torch.ops.match import (
    MatchProblem,
    MatchResult,
    backend_flags,
    chunked_match,
    chunked_match_pools,
    conflict_round_batched,
    vmap_safe_backend,
)
from cook_tpu_torch.parallel.mesh import invalid_match_problem

# tuned buckets for nodes-per-block: power-of-two block widths so the
# (block-bucket, job-slot, node-slot) shape lattice stays bounded
NODE_BLOCK_BUCKETS = (64, 128, 256, 512, 1024)
# aim for at least this many blocks (the reference's mesh lanes)
MIN_BLOCKS = 8


@dataclass
class HierParams:
    """Knobs of the two-level solve (the reference's HierParams; the
    scheduler exposes a subset as MatchConfig.hierarchical_*)."""

    nodes_per_block: int = 0      # 0 = auto from NODE_BLOCK_BUCKETS
    jobs_per_block: int = 0       # 0 = auto (block_slack x J/B, bucketed)
    block_slack: float = 2.0      # per-block job-slot headroom factor
    refine_rounds: int = 2        # bounded re-offer rounds (0 disables)
    # superblock (DCN-domain) layer; not ported yet — > 0 raises
    superblock_nodes: int = 0
    # fine-solve chunked-matcher knobs (MatchConfig equivalents)
    chunk: int = 1024
    rounds: int = 3
    passes: int = 2
    kc: int = 128
    backend: str = "xla"          # fine candidate backend (vmap-safe)
    # fine-solve schedule: "xla" (a chunked solve per block) or "pallas"
    # (the best_node_batched kernel + batched conflict rounds)
    fine_backend: str = "xla"
    # fused-fine pass count: each pass re-picks every unplaced job's ONE
    # best node against the updated availability
    fine_passes: int = 16
    # coarse block-scoring backend: "xla" (masked chunked_match) or
    # "pallas" (the coarse_pass kernel, any block count: past its shared
    # memory it pages the block state to device memory)
    coarse_backend: str = "xla"
    coarse_chunk: int = 4096
    # single-candidate coarse rounds and passes (the reference's rationale:
    # the prefix-accept admits contenders up to a block's aggregate
    # capacity; passes re-pick blocks for jobs whose first choice filled)
    coarse_rounds: int = 2
    coarse_passes: int = 8

    def __post_init__(self):
        if self.coarse_backend not in ("xla", "pallas"):
            raise ValueError(
                f"unknown hierarchical coarse backend "
                f"{self.coarse_backend!r} (expected xla | pallas)")
        if self.fine_backend not in ("xla", "pallas"):
            raise ValueError(
                f"unknown hierarchical fine backend "
                f"{self.fine_backend!r} (expected xla | pallas)")
        backend_flags(self.backend)  # canonical validation + error


def choose_nodes_per_block(n_nodes: int, override: int = 0) -> int:
    """The largest bucket that still yields >= MIN_BLOCKS blocks, else the
    largest yielding >= 2, else the smallest bucket."""
    if override:
        return override
    for npb in reversed(NODE_BLOCK_BUCKETS):
        if n_nodes // npb >= MIN_BLOCKS:
            return npb
    for npb in reversed(NODE_BLOCK_BUCKETS):
        if n_nodes // npb >= 2:
            return npb
    return NODE_BLOCK_BUCKETS[0]


def block_aggregates(avail, totals, node_valid, npb: int):
    """Per-block coarse tensors from node-axis slices: summed free capacity
    [B, R], per-resource max single node [B, R] (-1 where no node is
    valid), summed totals [B, 2], any-valid [B] and the valid-host count
    [B] int32 (the gang gate).  The sums are exact while the values are
    (the simulator's MB and half-cpu amounts are), whatever order the
    device adds in."""
    n, r = avail.shape
    b = n // npb
    nv = node_valid.reshape(b, npb, 1)
    block_sum = torch.where(nv, avail.reshape(b, npb, r), 0.0).sum(1)
    block_max = torch.where(nv, avail.reshape(b, npb, r), -1.0).amax(1)
    block_tot = torch.where(nv, totals.reshape(b, npb, 2), 0.0).sum(1)
    return (block_sum, block_max, block_tot, nv[..., 0].any(1),
            nv[..., 0].sum(1, dtype=torch.int32))


def _coarse_xla(demands, active, block_sum, block_max, block_tot,
                block_valid, block_any, params: HierParams,
                gate_demands=None, need_row=None, block_count=None):
    """Coarse jobs x blocks assignment on the aggregated problem via the
    chunked matcher, gated by the max-node fit and, optionally, by
    `block_any` (the constraint mask has a feasible node in the block).

    Gang rows route with their gang's aggregate demand but gate on what
    the block must hold member-wise: `gate_demands` is the per-row max
    member demand (block_max must fit it) and `need_row` the member count,
    gated against `block_count` (valid hosts per block)."""
    feas = fits(block_max, demands if gate_demands is None
                else gate_demands)
    if need_row is not None and block_count is not None:
        feas = feas & (block_count[None, :] >= need_row[:, None])
    if block_any is not None:
        feas = feas & block_any
    problem = MatchProblem(
        demands=demands, job_valid=active, avail=block_sum,
        totals=block_tot, node_valid=block_valid, feasible=feas)
    # kc=1: single-candidate conflict rounds, exact top-1
    return chunked_match(problem,
                         chunk=_chunk_for(params.coarse_chunk,
                                          demands.shape[0]),
                         rounds=params.coarse_rounds,
                         passes=params.coarse_passes, kc=1,
                         use_approx=False, **backend_flags("xla")).assignment


def _coarse_pallas(demands, active, block_sum, block_max, block_tot,
                   block_valid, *, chunk: int, rounds: int, passes: int):
    """Coarse pass on the `coarse_pass` kernel: per chunk and pass, each
    unplaced job's best block (aggregate fit + max-node gate + fitness +
    argmax, no [J, B] mask), then single-candidate conflict rounds accept
    against the aggregate availability — the whole pass one launch."""
    assignment, _ = coarse_pass(demands, active, block_sum, block_max,
                                block_tot, block_valid, chunk, passes,
                                rounds)
    return assignment


def scatter_to_blocks(coarse: np.ndarray, job_valid: np.ndarray,
                      b: int, slots: int):
    """Host-side scatter: per-block job-slot index matrix [b, slots]
    (-1 padding), filling each block in schedule order so the ranked
    queue's fairness order survives the decomposition.  Jobs beyond a
    block's slot cap spill (True in the returned mask) to the refinement
    round instead of silently dropping."""
    j = coarse.shape[0]
    active = (coarse >= 0) & (coarse < b) & job_valid
    blocks = np.where(active, coarse, b)  # inactive jobs sort last
    order = np.argsort(blocks, kind="stable")
    sb = blocks[order]
    first = np.searchsorted(sb, np.arange(b + 1))
    job_idx = np.full((b, slots), -1, dtype=np.int32)
    spilled = np.zeros(j, dtype=bool)
    for bi in range(b):
        seg = order[first[bi]:first[bi + 1]]
        take = seg[:slots]
        job_idx[bi, :len(take)] = take
        if len(seg) > slots:
            spilled[seg[slots:]] = True
    return job_idx, spilled


def gather_fine(demands, job_valid, feasible, avail, totals, node_valid,
                job_idx, npb: int) -> MatchProblem:
    """The batched per-block fine problems: demands gathered by the
    scatter's slot matrix `job_idx` [B, S], node tensors sliced by
    contiguous blocks, and the constraint mask gathered per (block, slot)
    against the block's OWN node columns — no [B, S, N] blowup."""
    b, s = job_idx.shape
    r = demands.shape[-1]
    safe = job_idx.clamp_min(0).long()
    feas_f = None
    if feasible is not None:
        blocks = torch.arange(b, device=job_idx.device)[:, None]
        feas_f = feasible.reshape(-1, b, npb)[safe, blocks, :]
    return MatchProblem(demands=demands[safe],
                        job_valid=(job_idx >= 0) & job_valid[safe],
                        avail=avail.reshape(b, npb, r),
                        totals=totals.reshape(b, npb, 2),
                        node_valid=node_valid.reshape(b, npb),
                        feasible=feas_f)


def _pad_block_axis(problems: MatchProblem, count: int,
                    n_res: int) -> MatchProblem:
    """Extend the fine batch with `count` all-invalid lanes
    (`invalid_match_problem`) so the block axis reaches its bucket."""
    if count <= 0:
        return problems
    s, npb = problems.demands.shape[1], problems.avail.shape[1]
    pad = invalid_match_problem(
        s, npb, n_res=n_res, with_feasible=problems.feasible is not None,
        dtype=problems.demands.dtype, device=problems.demands.device)
    return MatchProblem(*(
        None if real is None
        else torch.cat([real, dead.expand((count,) + dead.shape)])
        for real, dead in zip(problems, pad)))


def _chunk_for(width: int, axis: int) -> int:
    """Largest power-of-two chunk <= min(width, axis): the padded job
    axes here are powers of two, so a pow2 chunk always divides them."""
    chunk = max(1, min(width, axis))
    return 1 << (chunk.bit_length() - 1)


def _fine_fused(problems: MatchProblem, *, rounds: int,
                passes: int) -> MatchResult:
    """Fused fine batch solve: per pass, ONE `best_node_batched` launch
    picks each unplaced job's best node in its block; the batched conflict
    rounds then accept against the block's availability (single-candidate
    picks, as in the pallas coarse pass).  The availability the rounds
    carry is float32 (a bfloat16 one is cast here, as the reference casts
    it, `cook_tpu/ops/hierarchical.py:400-402`); bfloat16 demands and
    totals are cast where they are read, at the kernel's boundary and in
    the rounds."""
    b, s, _ = problems.demands.shape
    npb = problems.avail.shape[1]
    demands, totals = problems.demands, problems.totals
    avail = problems.avail.float()
    if problems.feasible is not None:
        # node validity rides in the mask, as the reference passes it
        feas_arg = problems.feasible & problems.node_valid[:, None, :]
        valid_arg = torch.ones_like(problems.node_valid)
    else:
        feas_arg = None
        valid_arg = problems.node_valid
    assignment = torch.full((b, s), -1, dtype=torch.int32,
                            device=demands.device)
    for _ in range(passes):
        active = problems.job_valid & (assignment < 0)
        d_eff = torch.where(active[..., None], demands, 2 * BIG)
        val, idx = best_node_batched(d_eff, avail, totals, valid_arg,
                                     feas_arg)
        cand_val, cand_idx = val[..., None], idx.clamp_min(0)[..., None]
        for _ in range(rounds):
            avail, assignment = conflict_round_batched(
                avail, assignment, cand_val, cand_idx, demands, npb)
    return MatchResult(assignment=assignment, new_avail=avail)


def _fine_solve(problems: MatchProblem, params: HierParams) -> MatchResult:
    if params.fine_backend == "pallas":
        return _fine_fused(problems, rounds=params.rounds,
                           passes=max(params.passes, params.fine_passes))
    # the reference's jax.vmap of chunked_match: the block axis is the
    # pool-batched matcher's leading axis
    backend = vmap_safe_backend(params.backend)
    chunk = _chunk_for(params.chunk, problems.demands.shape[1])
    return chunked_match_pools(problems, chunk=chunk, rounds=params.rounds,
                               passes=params.passes, kc=params.kc,
                               **backend_flags(backend))


def hierarchical_match(
    problem: MatchProblem,
    *,
    params: Optional[HierParams] = None,
    gang_id: Optional[np.ndarray] = None,
    gang_need: Optional[np.ndarray] = None,
    observatory=None,
) -> tuple[MatchResult, dict]:
    """Solve one giant pool's match problem coarse-then-fine.

    Returns (MatchResult, stats): the assignment is in the ORIGINAL node
    index space (block * nodes_per_block + local), and `stats` carries the
    reference's keys — phase walls (coarse_s / fine_s / refine_s, each
    ending in the fetch that observes the device's result), block
    geometry, per-block jobs/placed counts and spill/refine accounting.
    `observatory` (obs.CompileObservatory) receives one `match_coarse`
    and one `match_fine` solve per pass, keyed by their padded shapes, as
    in the reference; its `mesh` and `pool` arguments have no counterpart
    here."""
    params = params or HierParams()
    if params.superblock_nodes > 0:
        raise NotImplementedError(
            "the superblock layer (superblock_nodes > 0) is not ported "
            "yet (ROADMAP Queue A item 6)")
    t_start = time.perf_counter()
    dev = problem.demands.device
    orig_j = int(problem.demands.shape[0])
    n = int(problem.avail.shape[0])
    n_res = int(problem.demands.shape[-1])
    # power-of-two job axis so every chunk width divides it
    j = bucket_size(orig_j)
    demands, job_valid, feasible = (problem.demands, problem.job_valid,
                                    problem.feasible)
    if j != orig_j:
        demands = torch.nn.functional.pad(demands, (0, 0, 0, j - orig_j))
        job_valid = torch.nn.functional.pad(job_valid, (0, j - orig_j))
        if feasible is not None:
            feasible = torch.nn.functional.pad(feasible,
                                               (0, 0, 0, j - orig_j))
    npb = choose_nodes_per_block(n, params.nodes_per_block)
    npb = min(npb, bucket_size(n))
    b_real = -(-n // npb)
    n_pad = b_real * npb

    avail, totals, node_valid = problem.avail, problem.totals, \
        problem.node_valid
    if n_pad != n:
        # pad the node axis to a whole number of blocks with dead nodes
        pad_n = n_pad - n
        avail = torch.nn.functional.pad(avail, (0, 0, 0, pad_n))
        totals = torch.nn.functional.pad(totals, (0, 0, 0, pad_n),
                                         value=1.0)
        node_valid = torch.nn.functional.pad(node_valid, (0, pad_n))
        if feasible is not None:
            feasible = torch.nn.functional.pad(feasible, (0, pad_n))

    # block axis pads to a power-of-two bucket: the fine batch shape is
    # keyed by (b_pad, slots, npb), never by the raw block count
    b_pad = bucket_size(b_real, minimum=MIN_BLOCKS)
    coarse_chunk = _chunk_for(params.coarse_chunk, j)
    if params.jobs_per_block:
        # round an override up to a power of two: the chunked fine solve
        # needs its chunk to divide the slot axis
        slots = 1 << (params.jobs_per_block - 1).bit_length()
    else:
        slots = bucket_size(int(np.ceil(params.block_slack * j / b_real)))
    slots = min(slots, bucket_size(j))

    with data_plane.family(data_plane.FAM_HIER_COARSE):
        job_valid_np = fetch_result(job_valid)
    out = np.full(j, -1, dtype=np.int32)
    block_pad_axis = b_pad - b_real
    coarse_backend = params.coarse_backend
    fine_backend_label = ("pallas-fine" if params.fine_backend == "pallas"
                          else vmap_safe_backend(params.backend))
    coarse_s = fine_s = refine_s = 0.0
    refine_placed = 0
    avail_now = avail

    # ---- gangs: the leader row of each gang carries the gang's aggregate
    # coarse demand; members ride the leader's block.  The filter's gang
    # axis is bucketed, as the reference's is.
    has_gangs = False
    if gang_id is not None and gang_need is not None:
        # the matcher passes one row per considerable job, fewer than the
        # padded problem's rows: the padding rows are not gang rows (the
        # reference fills [:orig_j] and raises on such a call, which its
        # device-fallback ladder then solves on the CPU)
        rows = len(gang_id)
        gang_id_np = np.full(j, -1, dtype=np.int32)
        gang_id_np[:rows] = np.asarray(gang_id, dtype=np.int32)
        gang_need_np = np.zeros(j, dtype=np.int32)
        gang_need_np[:rows] = np.asarray(gang_need, dtype=np.int32)
        has_gangs = bool((gang_id_np >= 0).any())
    def put(arr, fam):
        return data_plane.h2d(arr, family=fam, device=dev)

    demands_coarse = demands
    gate_demands = need_row = None
    n_gangs = gang_slots = 0
    gangs_stripped_rows = 0
    if has_gangs:
        gang_rows_np = gang_id_np >= 0
        leader_row_np = np.arange(j, dtype=np.int32)
        is_leader_np = np.zeros(j, dtype=bool)
        for g in np.unique(gang_id_np[gang_rows_np]):
            rows = np.flatnonzero(gang_id_np == g)
            leader_row_np[rows] = rows[0]
            is_leader_np[rows[0]] = True
        members_np = gang_rows_np & ~is_leader_np
        n_gangs = int(is_leader_np.sum())
        gang_slots = bucket_size(n_gangs)
        lr = put(leader_row_np, data_plane.FAM_HIER_COARSE).long()
        gmask = put(gang_rows_np, data_plane.FAM_HIER_COARSE)[:, None]
        gang_id_dev = put(gang_id_np, data_plane.FAM_HIER_FINE)
        gang_need_dev = put(gang_need_np, data_plane.FAM_HIER_FINE)
        contrib = torch.where(gmask, demands, 0.0)
        agg = torch.zeros_like(demands).index_add_(0, lr, contrib)
        # members route as one aggregate row; gates stay member-sized
        demands_coarse = torch.where(gmask, agg, demands)
        gmax = torch.zeros_like(demands).scatter_reduce_(
            0, lr[:, None].expand_as(contrib), contrib, "amax",
            include_self=True)
        gate_demands = torch.where(gmask, gmax, demands)
        need_row = put(
            np.where(gang_rows_np, gang_need_np, 1).astype(np.int32),
            data_plane.FAM_HIER_COARSE)
        # the gang gate needs the masked coarse path (the coarse_pass
        # kernel has no per-row host-count gate)
        coarse_backend = "xla"
    if coarse_backend == "pallas" and dev.type == "cuda":
        check_fits(b_pad, n_res, coarse_chunk)
    block_any = None
    if coarse_backend == "xla" and feasible is not None:
        block_any = torch.nn.functional.pad(
            feasible.reshape(j, b_real, npb).any(-1), (0, block_pad_axis))

    def coarse_step(active_mask: np.ndarray) -> np.ndarray:
        """One coarse jobs x blocks assignment against the CURRENT block
        availabilities (refine rounds re-enter with only the leftover
        jobs active).  Transfers ride the `hier-coarse` family; the
        padded jobs x blocks grid feeds the padding-waste account."""
        data_plane.note_padding(
            "match_coarse", (j, b_pad),
            valid_cells=int(active_mask.sum()) * b_real,
            padded_cells=j * b_pad)
        block_sum, block_max, block_tot, block_valid, block_count = \
            block_aggregates(avail_now, totals, node_valid, npb)
        if block_pad_axis:
            pad = (0, 0, 0, block_pad_axis)
            block_sum = torch.nn.functional.pad(block_sum, pad)
            block_max = torch.nn.functional.pad(block_max, pad, value=-1.0)
            block_tot = torch.nn.functional.pad(block_tot, pad, value=1.0)
            block_valid = torch.nn.functional.pad(block_valid,
                                                  (0, block_pad_axis))
            block_count = torch.nn.functional.pad(block_count,
                                                  (0, block_pad_axis))
        if has_gangs:
            # gang members ride their leader's row through the coarse
            # solve: only the leader (aggregate demand) routes
            active_mask = active_mask & ~members_np
        active = put(active_mask, data_plane.FAM_HIER_COARSE)
        if coarse_backend == "pallas":
            assignment = _coarse_pallas(
                demands, active, block_sum, block_max, block_tot,
                block_valid, chunk=coarse_chunk,
                rounds=params.coarse_rounds, passes=params.coarse_passes)
        else:
            assignment = _coarse_xla(
                demands_coarse, active, block_sum, block_max, block_tot,
                block_valid, block_any, params,
                gate_demands=gate_demands, need_row=need_row,
                block_count=block_count if has_gangs else None)
        if observatory is not None:
            observatory.observe_solve("match_coarse", (j, b_pad),
                                      coarse_backend)
        with data_plane.family(data_plane.FAM_HIER_COARSE):
            res = fetch_result(assignment)
        if has_gangs:
            # members inherit the leader's block (or its miss): the
            # scatter then seats the whole gang in one block's slots
            res = res.copy()
            res[members_np] = res[leader_row_np[members_np]]
        return res

    def fine_pass(job_idx: np.ndarray):
        """Scattered fine batch solve; returns (assignment [b_real, s]
        local node indices, updated flat availability).  Transfers ride
        the `hier-fine` family; the block-fill fraction of the padded
        [b_pad, slots] grid is the padding-waste signal."""
        data_plane.note_padding(
            "match_fine", (b_pad, slots, npb),
            valid_cells=int((job_idx >= 0).sum()) * npb,
            padded_cells=b_pad * slots * npb)
        problems = gather_fine(demands, job_valid, feasible, avail_now,
                               totals, node_valid,
                               put(job_idx, data_plane.FAM_HIER_FINE), npb)
        result = _fine_solve(_pad_block_axis(problems, block_pad_axis,
                                             n_res), params)
        if observatory is not None:
            observatory.observe_solve(
                "match_fine", (b_pad, slots, npb), fine_backend_label)
        with data_plane.family(data_plane.FAM_HIER_FINE):
            assignment = fetch_result(result.assignment)[:b_real]
        return assignment, result.new_avail[:b_real].reshape(n_pad, n_res)

    def merge(job_idx: np.ndarray, fine_assign: np.ndarray) -> int:
        """Fold one fine pass's block-local picks into the global
        assignment; returns the number of jobs placed this pass."""
        sel = (job_idx >= 0) & (fine_assign >= 0)
        local = np.where(sel, fine_assign, 0)
        global_idx = (np.arange(b_real, dtype=np.int64)[:, None] * npb
                      + local)
        out[job_idx[sel]] = global_idx[sel].astype(np.int32)
        return int(sel.sum())

    def enforce_gangs() -> int:
        """The group-sum constraint: `gang_filter` over the merged global
        assignment strips any gang that did not land whole inside one
        block on distinct hosts, and `release_assignments` returns the
        stripped demand to the live availability so refine rounds retry
        the gang whole.  One host read (the stripped mask), and the new
        assignment only when something was stripped.  Returns the rows
        stripped (0 without gangs)."""
        nonlocal avail_now, gangs_stripped_rows
        if not has_gangs:
            return 0
        # a copy (`torch.tensor`), never a view of `out`, which is
        # overwritten below
        asg_dev = torch.tensor(out, device=dev)
        data_plane.note_h2d(out.nbytes, family=data_plane.FAM_HIER_FINE)
        new_asg, stripped = gang_filter(
            asg_dev, gang_id_dev, gang_need_dev, num_gangs=gang_slots,
            num_nodes=n_pad, nodes_per_block=npb)
        with data_plane.family(data_plane.FAM_HIER_FINE):
            count = int(fetch_result(stripped).sum())
            if count:
                avail_now = release_assignments(avail_now, demands, asg_dev,
                                                stripped)
                out[:] = fetch_result(new_asg)
                gangs_stripped_rows += count
        return count

    # ---- round 0: coarse -> scatter -> fine
    t0 = time.perf_counter()
    coarse = coarse_step(job_valid_np)
    coarse_s += time.perf_counter() - t0
    t0 = time.perf_counter()
    job_idx, spilled = scatter_to_blocks(coarse, job_valid_np, b_real, slots)
    fine_assign, avail_now = fine_pass(job_idx)
    fine_s += time.perf_counter() - t0
    merge(job_idx, fine_assign)
    enforce_gangs()
    block_stats = [{"jobs": int((job_idx[bi] >= 0).sum()),
                    "placed": int(((job_idx[bi] >= 0)
                                   & (fine_assign[bi] >= 0)).sum())}
                   for bi in range(b_real)]

    # ---- bounded refinement: re-offer every leftover (coarse-unrouted,
    # slot-spilled, fine-unplaced or gang-stripped) against the UPDATED
    # availabilities, at identical shapes
    rounds_run = 0
    for _ in range(max(0, params.refine_rounds)):
        leftover = job_valid_np & (out < 0)
        if not leftover.any():
            break
        rounds_run += 1
        t0 = time.perf_counter()
        coarse = coarse_step(leftover)
        job_idx, _ = scatter_to_blocks(coarse, leftover, b_real, slots)
        fine_assign, avail_now = fine_pass(job_idx)
        placed = merge(job_idx, fine_assign)
        stripped = enforce_gangs()
        refine_placed += max(0, placed - stripped)
        refine_s += time.perf_counter() - t0
        if placed - stripped <= 0:
            # net-zero progress: a strip returned exactly what the round
            # consumed, so the next round would replay the same solve
            break

    stats = {
        "blocks": b_real,
        "block_pad": b_pad,
        "nodes_per_block": npb,
        "jobs_per_block": slots,
        # the superblock layer is not ported: its keys keep their
        # disengaged values
        "superblocks": 0,
        "superblock_pad": 0,
        "superblock_nodes": 0,
        "superblock_blocks": 0,
        "jobs_per_superblock": 0,
        "superblock_spilled": 0,
        "super_coarse_s": 0.0,
        "coarse_s": coarse_s,
        "fine_s": fine_s,
        "refine_s": refine_s,
        "refine_rounds": rounds_run,
        "refine_placed": refine_placed,
        "spilled": int(spilled.sum()),
        "placed": int((out >= 0).sum()),
        "super_shape": None,
        "coarse_shape": (j, b_pad),
        "fine_shape": (b_pad, slots, npb),
        "backend": fine_backend_label,
        "coarse_backend": coarse_backend,
        "block_stats": block_stats,
        "total_s": time.perf_counter() - t_start,
    }
    if has_gangs:
        stats["gangs"] = {
            "considered": n_gangs,
            "placed": int((is_leader_np & (out >= 0)).sum()),
            "stripped_rows": gangs_stripped_rows,
        }
    return MatchResult(assignment=torch.as_tensor(out[:orig_j], device=dev),
                       new_avail=avail_now[:n]), stats
