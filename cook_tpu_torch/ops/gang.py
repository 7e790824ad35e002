"""Gang placement: all-or-nothing group-sum enforcement on the
topology-block decomposition.

Port of `cook_tpu/ops/gang.py` (see its docstring for the rule).  A gang
(`Job.gang_size=k`, one shared group) keeps its assignments iff every
member row placed, all placed rows fall in one block of `nodes_per_block`
hosts (the whole pool when it is 0), and the members sit on k distinct
hosts; anything else strips the whole gang back to -1.

`gang_filter` (:46), `release_assignments` (:88) and `block_free_hosts`
(:102) are XLA-jitted functions in the reference, not Pallas kernels, so
here they are torch tensor code on the caller's device (no hand kernel).
They read nothing back to the host: the caller fetches what it needs.
The scatter reductions are `index_add_` / `scatter_reduce_`; the
occupancy grid writes only the placed rows (an unplaced row is sent to a
dump cell past the grid, so it can never clear a host another member
set).  `release_assignments` adds demands back with `index_add_`, whose
sums are exact on the simulator's inputs (MB in multiples of 512, cpus in
halves), so the card and the CPU agree bit for bit.

`np_gang_filter` (:119), `np_gang_repair` (:149) and `np_block_free_hosts`
(:226) are the numpy twins the host chokepoint runs
(`scheduler/matcher.finalize_pool_match`).  `np_gang_repair`'s scan of a
block for a member's host is one numpy expression here (the first unused,
feasible host the member fits), where the reference walks the block's
nodes in Python; its answers, member order and block order are the
reference twin's.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

_NO_BLOCK = 2**30  # sentinel block index for unplaced rows


def gang_filter(assignment: torch.Tensor, gang_id: torch.Tensor,
                gang_need: torch.Tensor, *, num_gangs: int, num_nodes: int,
                nodes_per_block: int):
    """Strip partially-placed / block-split / host-sharing gangs from an
    assignment.

    assignment [J] int32 node index in [0, num_nodes) or -1; gang_id [J]
    int32 gang slot in [0, num_gangs) or -1 for non-gang rows; gang_need
    [J] int32 = k on gang rows (0 otherwise).  nodes_per_block=0 treats
    the whole pool as one block.  Returns (new_assignment [J] int32,
    stripped [J] bool), on the inputs' device."""
    dev = assignment.device
    placed = assignment >= 0
    if nodes_per_block > 0:
        blk = torch.where(placed, torch.div(assignment, nodes_per_block,
                                            rounding_mode="floor"),
                          _NO_BLOCK)
    else:
        blk = torch.where(placed, 0, _NO_BLOCK)
    blk = blk.to(torch.int32)
    # non-gang rows accumulate into a sentinel slot that is never checked
    gid = torch.where(gang_id >= 0, gang_id, num_gangs).long()
    slots = num_gangs + 1
    i32 = dict(dtype=torch.int32, device=dev)
    count = torch.zeros(slots, **i32).index_add_(0, gid, placed.to(torch.int32))
    need = torch.zeros(slots, **i32).scatter_reduce_(
        0, gid, gang_need.to(torch.int32), "amax", include_self=True)
    bmin = torch.full((slots,), _NO_BLOCK, **i32).scatter_reduce_(
        0, gid, blk, "amin", include_self=True)
    bmax = torch.full((slots,), -1, **i32).scatter_reduce_(
        0, gid, torch.where(placed, blk, -1), "amax", include_self=True)
    # distinct-host count per gang: occupancy over a [gangs+1, num_nodes]
    # bool grid (gang slots are bucketed, so it stays a few MB), written
    # only where a row placed
    node = torch.clamp(torch.where(placed, assignment, 0), 0,
                       num_nodes - 1).long()
    dump = slots * num_nodes
    cell = torch.where(placed, gid * num_nodes + node, dump)
    occupancy = torch.zeros(dump + 1, dtype=torch.bool, device=dev)
    occupancy.index_fill_(0, cell, True)
    distinct = occupancy[:dump].view(slots, num_nodes).sum(1,
                                                           dtype=torch.int32)
    complete = (count == need) & (bmin == bmax) & (distinct == need)
    keep = (gang_id < 0) | complete.index_select(0, gid)
    new_assignment = torch.where(keep, assignment, -1).to(torch.int32)
    stripped = placed & ~keep
    return new_assignment, stripped


def release_assignments(avail: torch.Tensor, demands: torch.Tensor,
                        assignment: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Return masked rows' demand to availability (the inverse of the
    solve's scatter-subtract): avail [N, R], demands [J, R], assignment
    [J] node indices (only rows with mask True are read), mask [J] bool.
    A new tensor, as the reference's functional update."""
    n = avail.shape[0]
    idx = torch.where(mask, assignment, n - 1).long()
    delta = torch.where(mask[:, None], demands, 0.0)
    return avail.index_add(0, idx, delta)


def block_free_hosts(avail: torch.Tensor, node_valid: torch.Tensor,
                     member_demand: torch.Tensor, *,
                     nodes_per_block: int) -> torch.Tensor:
    """Per-block count of valid hosts that can hold one gang member:
    avail [N, R] (N a multiple of nodes_per_block), member_demand [R]."""
    n = avail.shape[0]
    fits = (avail >= member_demand[None, :]).all(-1) & node_valid
    return fits.reshape(n // nodes_per_block,
                        nodes_per_block).sum(-1, dtype=torch.int32)


# ------------------------------------------------------------ numpy twins


def np_gang_filter(assignment: np.ndarray, gang_id: np.ndarray,
                   gang_need: np.ndarray,
                   nodes_per_block: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side twin of `gang_filter` (same semantics, numpy arrays): the
    enforcement chokepoint of `finalize_pool_match`.  Returns
    (new_assignment, stripped)."""
    assignment = np.asarray(assignment, dtype=np.int32).copy()
    gang_id = np.asarray(gang_id)
    gang_need = np.asarray(gang_need)
    placed = assignment >= 0
    stripped = np.zeros(assignment.shape[0], dtype=bool)
    for g in np.unique(gang_id[gang_id >= 0]):
        rows = gang_id == g
        need = int(gang_need[rows].max(initial=0))
        hit = rows & placed
        blocks = (assignment[hit] // nodes_per_block
                  if nodes_per_block > 0
                  else np.zeros(int(hit.sum()), dtype=np.int64))
        distinct = int(np.unique(assignment[hit]).size)
        complete = (int(hit.sum()) == need and need > 0
                    and distinct == need
                    and (blocks.size == 0 or blocks.min() == blocks.max()))
        if not complete:
            stripped |= hit
            assignment[rows] = -1
    return assignment, stripped


def np_gang_repair(assignment: np.ndarray, gang_id: np.ndarray,
                   gang_need: np.ndarray, demands: np.ndarray,
                   avail: np.ndarray, feasible: Optional[np.ndarray],
                   nodes_per_block: int) -> np.ndarray:
    """Greedy host-side completion pass for gangs the solver left partial,
    co-located, or block-split: free each broken gang's placement, then
    walk the blocks (the whole pool when nodes_per_block <= 0) and take the
    first block where every member, largest total demand first, fits on a
    distinct feasible host under the remaining capacity.  Non-gang rows
    never move; capacity accounting includes everything already placed
    this cycle.  Rows of gangs that still cannot place whole stay/become
    -1 for `np_gang_filter` to finalize."""
    assignment = np.asarray(assignment, dtype=np.int32).copy()
    gang_id = np.asarray(gang_id)
    gang_need = np.asarray(gang_need)
    demands = np.asarray(demands, dtype=np.float64)
    n = avail.shape[0]
    remaining = np.asarray(avail, dtype=np.float64).copy()
    placed = assignment >= 0
    np.subtract.at(remaining, assignment[placed], demands[placed])
    npb = nodes_per_block if nodes_per_block > 0 else n
    for g in np.unique(gang_id[gang_id >= 0]):
        rows = np.flatnonzero(gang_id == g)
        need = int(gang_need[rows].max(initial=0))
        if need <= 0 or len(rows) < need:
            continue
        hit = rows[assignment[rows] >= 0]
        if hit.size == need:
            hosts = assignment[hit]
            blocks = hosts // npb
            if (np.unique(hosts).size == need
                    and blocks.min() == blocks.max()):
                continue  # already whole: one block, distinct hosts
        # free the broken placement, then retry the gang whole
        np.add.at(remaining, assignment[hit], demands[hit])
        assignment[rows] = -1
        order = rows[np.argsort(-demands[rows].sum(axis=1), kind="stable")]
        n_blocks = (n + npb - 1) // npb
        chosen = None
        for b in range(n_blocks):
            lo, hi = b * npb, min((b + 1) * npb, n)
            if hi - lo < need:
                continue
            rem = remaining[lo:hi].copy()
            unused = np.ones(hi - lo, dtype=bool)
            trial: dict = {}
            for ji in order:
                # the first unused, feasible host of the block the member
                # fits on
                ok = unused & np.all(rem >= demands[ji], axis=1)
                if feasible is not None:
                    ok &= feasible[ji, lo:hi]
                local = int(ok.argmax())
                if not ok[local]:
                    break
                unused[local] = False
                rem[local] -= demands[ji]
                trial[int(ji)] = lo + local
            if len(trial) == len(order):
                chosen = trial
                break
        if chosen is not None:
            for ji, node in chosen.items():
                assignment[ji] = node
                remaining[node] -= demands[ji]
    return assignment


def np_block_free_hosts(avail: np.ndarray, node_valid: np.ndarray,
                        member_demand: np.ndarray,
                        nodes_per_block: int) -> np.ndarray:
    """Numpy twin of `block_free_hosts` (ragged tail tolerated: the last
    block may be short when N is not a block multiple host-side)."""
    fits = np.all(avail >= member_demand[None, :], axis=-1) & node_valid
    n = fits.shape[0]
    nb = max(1, (n + nodes_per_block - 1) // nodes_per_block) \
        if nodes_per_block > 0 else 1
    out = np.zeros(nb, dtype=np.int32)
    if nodes_per_block <= 0:
        out[0] = int(fits.sum())
        return out
    for b in range(nb):
        out[b] = int(fits[b * nodes_per_block:(b + 1) * nodes_per_block]
                     .sum())
    return out
