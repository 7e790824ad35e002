"""Device-mesh plumbing on `torch.distributed`: how the scheduling solves
scale across cards and processes.

Port of `cook_tpu/parallel/mesh.py`.  The reference shards two ways over a
`jax.sharding.Mesh` (SURVEY §2.4, BASELINE configuration 5):

  * pool-axis sharding — the per-pool problems of one scheduling cycle are
    independent, so a batch of P pools shards P-ways over the mesh and each
    rank solves its pools with no cross-rank traffic but the one gather of
    the results;

  * node-axis sharding — one huge pool's NODE axis shards over the ranks:
    each greedy step computes every rank's local best (fitness, node) and
    one tiny all-gather of D pairs picks the global winner; only the
    winner's owner updates its slice.  Per-step traffic is O(ranks), not
    O(nodes).

The reference's `shard_map` bodies are SPMD functions with explicit
collectives; here they are the same functions run by every rank of a
process group.  Every rank calls a sharded function with the same full
inputs (host arrays or tensors), puts ONLY its shard on its own device
(sliced on the host, then copied), solves it, and gets the full result
back from the collectives, as reading a `P("pool")`-sharded output gives
in JAX.  This is also the reference's multi-host model
(`jax.distributed.initialize()`: every process runs the same program).

The transport is the process group's backend, chosen by the caller:
`nccl` where each rank has a card of its own, `gloo` otherwise (several
ranks sharing one card, or the CPU).  NCCL refuses two ranks on one
device, so `make_mesh(backend="nccl")` with more ranks than cards raises
rather than switching backends.  Every group carries a timeout, so a lost
rank fails the run instead of hanging it; `run_on_mesh` spawns a local
mesh and raises the traceback of a rank that fails or outlives its
deadline.
"""
from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import sys
import tempfile
import time
import traceback
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from cook_tpu_torch import device as device_mod
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.ops.common import BIG, binpack_fitness
from cook_tpu_torch.ops.dru import (
    DruResult,
    DruTasks,
    dru_rank,
    dru_rank_pools,
)
from cook_tpu_torch.ops.match import (
    MatchProblem,
    MatchResult,
    _top_kc,
    backend_flags,
    chunked_match_pools,
    conflict_round,
    greedy_match_pools,
    vmap_safe_backend,
)

# a group's collectives fail after this long without their peers
DEFAULT_TIMEOUT_S = 120.0


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one process group, this process's rank in it, its size
    and the device this rank solves on."""

    group: Any                 # the torch.distributed process group
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = "pool"

    def lanes(self, total: int) -> slice:
        """This rank's slice of a leading axis of `total` entries."""
        if total % self.size:
            raise ValueError(f"pad the sharded axis ({total}) to a "
                             f"multiple of the mesh size ({self.size})")
        k = total // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


# the mesh make_mesh set up last in this process (hier_mesh reads it)
_ACTIVE: Optional[Mesh] = None


def active_mesh() -> Optional[Mesh]:
    """The mesh `make_mesh` set up in this process, or None."""
    return _ACTIVE


def _rank_device(device, rank: int) -> torch.device:
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and dev.index is None:
        # ranks spread over the host's cards (several per card on gloo)
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return dev


def make_mesh(n_devices: Optional[int] = None, axis: str = "pool", *,
              backend: Optional[str] = None, device=None,
              init_method: Optional[str] = None, rank: Optional[int] = None,
              world_size: Optional[int] = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[Mesh]:
    """Join (or reuse) the default process group and return the mesh of its
    first `n_devices` ranks (all of them by default, as the reference's
    `devices[:n]`); a rank outside those gets None.

    The group is joined from `init_method` (`file://...` or
    `tcp://host:port`, with `rank` and `world_size`) or, by default, from
    the environment `torchrun` sets (`env://`: RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT).  `device` is the card (cuda:LOCAL_RANK
    modulo the cards) unless the caller names the CPU.  `backend` defaults
    to `nccl` on the card and `gloo` on the CPU; ranks sharing a card must
    ask for `gloo`: `nccl` with more ranks than cards raises."""
    global _ACTIVE
    if backend is None:
        backend = (dist.get_backend() if dist.is_initialized() else
                   "nccl" if device_mod.resolve(device).type == "cuda"
                   else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown mesh backend {backend!r} "
                         "(expected nccl | gloo)")
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()}"
                             f", not {backend}")
        rank, world_size = dist.get_rank(), dist.get_world_size()
    else:
        rank = int(os.environ.get("RANK", 0) if rank is None else rank)
        world_size = int(os.environ.get("WORLD_SIZE", 1)
                         if world_size is None else world_size)
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if torch.device(device or "cuda").type != "cuda" \
                or world_size > cards:
            raise ValueError(
                f"nccl needs a card of its own for each rank: {world_size} "
                f"rank(s), {cards} card(s) on {device or 'cuda'}; ranks "
                "sharing a card (or the CPU) take backend='gloo'")
    dev = _rank_device(device, rank)
    timeout = timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        kwargs = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method=init_method or "env://",
                                rank=rank, world_size=world_size,
                                timeout=timeout, **kwargs)
    n = world_size if n_devices is None else int(n_devices)
    if not 1 <= n <= world_size:
        raise ValueError(f"n_devices {n} outside 1..{world_size}")
    group = (dist.group.WORLD if n == world_size
             else dist.new_group(list(range(n)), timeout=timeout))
    if rank >= n:
        return None
    _ACTIVE = Mesh(group=group, rank=rank, size=n, device=dev,
                   backend=backend, axis=axis)
    return _ACTIVE


# ------------------------------------------------------------ run_on_mesh


def _rank_main(rank, n, init_method, backend, device, timeout_s, out_dir,
               fn, args):
    """One spawned rank: join the mesh, run fn, save rank 0's result (or
    this rank's traceback) for the parent."""
    status, payload = 0, None
    # the ranks of a local mesh meet on this host's loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    try:
        mesh = make_mesh(backend=backend, device=device,
                         init_method=init_method, rank=rank, world_size=n,
                         timeout_s=timeout_s)
        result = fn(mesh, *args)
        payload = ("ok", result if rank == 0 else None)
    except Exception:  # noqa: BLE001 — reported to the parent
        status, payload = 1, ("error", traceback.format_exc())
    path = os.path.join(out_dir, f"rank{rank}.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    if dist.is_initialized() and status == 0:
        dist.destroy_process_group()
    sys.stdout.flush()
    sys.stderr.flush()
    # no interpreter teardown: a failed rank's peers may still hold the
    # group's sockets
    os._exit(status)


def _payload(out_dir, rank):
    path = os.path.join(out_dir, f"rank{rank}.pt")
    if not os.path.exists(path):
        return None, None
    return (torch.load(path, map_location="cpu", weights_only=False),
            os.path.getmtime(path))


def run_on_mesh(n: int, fn, *args, backend: str = "gloo", device=None,
                timeout_s: float = DEFAULT_TIMEOUT_S):
    """Run `fn(mesh, *args)` on a local mesh of `n` ranks, each a spawned
    process joined through a file rendezvous in a temporary directory, and
    return rank 0's result (loaded onto the CPU).  `fn` and `args` must
    pickle (a module-level function, host data).  If a rank fails, every
    rank is killed and a RuntimeError carries the first failing rank's
    traceback; if the ranks outlive `timeout_s` (spawn and import
    included), every rank is killed and a TimeoutError names the ones
    still running."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="cook-mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, name=f"mesh-rank-{r}",
                             args=(r, n, init, backend, device, timeout_s,
                                   tmp, fn, args))
                 for r in range(n)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.start()
            while True:
                codes = [p.exitcode for p in procs]
                if any(c not in (None, 0) for c in codes):
                    # let the ranks the failure broke report too, then
                    # blame the earliest traceback written
                    grace = time.monotonic() + 2.0
                    while (any(p.exitcode is None for p in procs)
                           and time.monotonic() < grace):
                        time.sleep(0.05)
                    errors = []
                    for r, p in enumerate(procs):
                        payload, at = _payload(tmp, r)
                        if payload is not None and payload[0] == "error":
                            errors.append((at, r, payload[1]))
                    if not errors:
                        bad = [r for r, c in enumerate(codes)
                               if c not in (None, 0)]
                        raise RuntimeError(f"mesh rank(s) {bad} died with "
                                           f"exit codes {codes}")
                    _, r, tb = min(errors)
                    raise RuntimeError(f"mesh rank {r} of {n} failed:\n{tb}")
                if all(c == 0 for c in codes):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    alive = [r for r, c in enumerate(codes) if c is None]
                    raise TimeoutError(f"mesh rank(s) {alive} of {n} still "
                                       f"running after {timeout_s:.0f} s")
                multiprocessing.connection.wait(
                    [p.sentinel for p in procs if p.exitcode is None],
                    timeout=min(left, 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        payload, _ = _payload(tmp, 0)
        return payload[1]


# ------------------------------------------------------------- collectives


def all_gather(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's `tensor` (same shape and dtype on every rank) stacked
    on a new leading axis [D, ...], on this rank's device: the mesh's one
    collective.  Gloo takes the card's tensors as NCCL does.  Called even
    on a mesh of one, so that a one-card NCCL mesh runs the deployment's
    transport."""
    t = tensor.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts)


def _gather_lanes(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """Each rank's lanes of a leading axis, concatenated in rank order."""
    return all_gather(mesh, tensor).flatten(0, 1)


def _tree_map(fn, tree):
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    return fn(tree)


def _put(mesh: Mesh, leaf, rows: Optional[slice] = None,
         family: str = data_plane.FAM_MESH):
    """`leaf[rows]` (all of it when rows is None) on the mesh's device,
    its logical bytes counted under `family`: a host leaf is sliced on
    the host, then copied; a device leaf is sliced in place."""
    if not isinstance(leaf, torch.Tensor):
        leaf = torch.as_tensor(np.asarray(leaf))
    part = leaf if rows is None else leaf[rows]
    if part.device == mesh.device:
        data_plane.note_h2d(int(part.nbytes), family=family)
        return part
    return data_plane.h2d(part.cpu(), family=family, device=mesh.device)


class PoolShard(NamedTuple):
    """This rank's lanes of a pool-batched tree (on the mesh's device) and
    the batch's lane count across the mesh."""

    tree: Any
    total: int


def shard_pools(mesh: Mesh, tree, axis: str = "pool", *,
                total: Optional[int] = None) -> PoolShard:
    """This rank's slice of the leading (pool) axis of every leaf of
    `tree`, put on its device, the logical bytes counted under the
    `mesh-shard` family.  With `total`, `tree` already holds only this
    rank's lanes of a `total`-lane batch (the batched matcher stacks only
    its own lanes, so no rank builds the whole [P, J, N] mask) and is put
    as it is."""
    if isinstance(tree, PoolShard):
        return tree
    if total is None:
        leaves = []
        _tree_map(leaves.append, tree)
        total = int(leaves[0].shape[0])
        rows = mesh.lanes(total)
    else:
        mesh.lanes(total)
        rows = None
    return PoolShard(_tree_map(lambda leaf: _put(mesh, leaf, rows), tree),
                     total)


def _gather_result(mesh: Mesh, local: MatchResult) -> MatchResult:
    return MatchResult(assignment=_gather_lanes(mesh, local.assignment),
                       new_avail=_gather_lanes(mesh, local.new_avail))


def invalid_match_problem(j: int, n: int, n_res: int = 4,
                          with_feasible: bool = True,
                          dtype=torch.float32, *,
                          device) -> MatchProblem:
    """An all-invalid padded problem used to fill the pool axis up to a
    mesh multiple (matcher.match_pools_batched) and the BLOCK axis of the
    hierarchical fine batch (ops/hierarchical.py): job_valid and
    node_valid are all False, so the kernels place nothing on it;
    `totals` is ones so the binpack fitness stays finite on the dead
    lanes.  `with_feasible=False` for batches whose real problems carry no
    constraint mask; `dtype` is the real problems' cost dtype."""
    return MatchProblem(
        demands=torch.zeros((j, n_res), dtype=dtype, device=device),
        job_valid=torch.zeros((j,), dtype=torch.bool, device=device),
        avail=torch.zeros((n, n_res), dtype=dtype, device=device),
        totals=torch.ones((n, 2), dtype=dtype, device=device),
        node_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        feasible=(torch.zeros((j, n), dtype=torch.bool, device=device)
                  if with_feasible else None),
    )


# -------------------------------------------------------- pool-axis solves


def pool_sharded_match(mesh: Mesh, problems, *, chunk: int = 0,
                       rounds: int = 4, passes: int = 2, kc: int = 128,
                       backend: str = "xla") -> MatchResult:
    """Solve P pools' match problems, one shard of P/D pools per rank.
    `problems` is a pool-batched MatchProblem (leading axis P, a multiple
    of the mesh size) or `shard_pools`' shard of one.  chunk=0 selects
    the exact sequential greedy (`greedy_match_pools`); otherwise
    `chunked_match_pools` with the candidate pass of `backend` as a
    batched solve takes it (`vmap_safe_backend`: pallas runs as xla).  A
    mask-less batch (feasible None) and a topology `node_bonus` ride
    through as the pool-batched solves take them.  One gather of
    assignment [P/D, J] and new_avail [P/D, N, R] returns the whole batch
    to every rank."""
    local = shard_pools(mesh, problems).tree
    if chunk:
        result = chunked_match_pools(
            local, chunk=chunk, rounds=rounds, passes=passes, kc=kc,
            **backend_flags(vmap_safe_backend(backend)))
    else:
        result = greedy_match_pools(local)
    return _gather_result(mesh, result)


def pool_sharded_coarse(mesh: Mesh, problems, *, chunk: int = 4096,
                        rounds: int = 2, passes: int = 8) -> MatchResult:
    """Batched coarse routing for the hierarchical SUPERBLOCK layer: each
    lane is one superblock's jobs x blocks problem (blocks in the node
    role), sharded on the same pool axis as `pool_sharded_match`.  The
    solve is pinned to the flat coarse pass's exact semantics (kc 1
    single-candidate conflict rounds, exact top-1 on xla), so two-level
    routing matches the one-level pass block for block."""
    local = shard_pools(mesh, problems).tree
    result = chunked_match_pools(local, chunk=chunk, rounds=rounds,
                                 passes=passes, kc=1, use_approx=False,
                                 **backend_flags("xla"))
    return _gather_result(mesh, result)


def pool_sharded_dru(mesh: Mesh, tasks: DruTasks, mem_div, cpu_div,
                     gpu_div) -> DruResult:
    """Batched DRU ranking over pools, the pool axis sharded: each rank
    ranks its P/D pools (`dru_rank_pools`), and every field of the
    DruResult is gathered back to [P, T]."""
    local_tasks, md, cd, gd = shard_pools(
        mesh, (tasks, mem_div, cpu_div, gpu_div)).tree
    local = dru_rank_pools(local_tasks, md, cd, gd)
    return DruResult(*(_gather_lanes(mesh, field) for field in local))


def task_sharded_dru(mesh: Mesh, tasks: DruTasks, mem_div, cpu_div, gpu_div,
                     *, gpu_mode: bool = False) -> DruResult:
    """DRU ranking with the TASK axis sharded: each rank puts T/D tasks on
    its device (the `dru-columns` family) and the divisors whole.

    The ranking is two sorts along the WHOLE task axis (by user and order
    key, then by DRU) with a segmented sum between, so no rank can rank its
    shard alone: the shards' columns are gathered and every rank runs the
    sorts on the gathered keys.  (The reference leaves the same exchange
    to XLA's sharded sorts.)  The result equals `dru_rank` on the whole
    input, on every rank."""
    rows = mesh.lanes(int(tasks.user.shape[0]))
    local = _tree_map(lambda leaf: _put(mesh, leaf, rows,
                                        data_plane.FAM_DRU), tasks)
    divs = [_put(mesh, d, None, data_plane.FAM_DRU)
            for d in (mem_div, cpu_div, gpu_div)]
    whole = DruTasks(*(_gather_lanes(mesh, leaf) for leaf in local))
    return dru_rank(whole, *divs, gpu_mode=gpu_mode)


# -------------------------------------------------------- node-axis solves


def _node_rows(mesh: Mesh, n: int) -> slice:
    if n % mesh.size:
        raise ValueError(f"pad nodes ({n}) to a multiple of the mesh size "
                         f"({mesh.size})")
    return mesh.lanes(n)


def node_sharded_greedy_match(mesh: Mesh,
                              problem: MatchProblem) -> MatchResult:
    """Sequential greedy match with the NODE axis sharded across the mesh.

    Each job step: every rank scores its N/D nodes and takes its local best
    (score, index), the first index on a tie; one all-gather of the D
    pairs picks the global winner, the first rank on a tie of scores (so
    the order is `greedy_match`'s first-index rule over the whole axis);
    only the winner's owner takes the demand off its slice.  The steps'
    order is the job order: nothing batches placements.  On gloo each
    step is a host round trip of D pairs.  Returns `greedy_match`'s
    result, on every rank (new_avail gathered)."""
    n = int(problem.avail.shape[0])
    rows = _node_rows(mesh, n)
    demands, job_valid = (_put(mesh, problem.demands),
                          _put(mesh, problem.job_valid))
    avail = _put(mesh, problem.avail, rows).clone()
    totals = _put(mesh, problem.totals, rows)
    node_valid = _put(mesh, problem.node_valid, rows)
    feasible = (None if problem.feasible is None
                else _put(mesh, problem.feasible[:, rows]))
    used_denom = totals.clamp_min(1e-30)
    j = int(demands.shape[0])
    dev = avail.device
    me = torch.tensor(mesh.rank, device=dev)
    nloc = int(avail.shape[0])
    assignment = torch.empty(j, dtype=torch.int32, device=dev)
    for i in range(j):
        demand = demands[i]
        fits = (avail >= demand).all(-1)
        ok = fits & node_valid & job_valid[i]
        if feasible is not None:
            ok = ok & feasible[i]
        used = totals - avail[:, :2]
        fit = binpack_fitness(used[:, 0], used[:, 1], demand[0], demand[1],
                              used_denom[:, 0], used_denom[:, 1])
        score = torch.where(ok, fit, torch.full_like(fit, -BIG))
        best = torch.argmax(score)
        # the D candidate pairs: f32 scores and int indices are exact in
        # float64, so one tensor carries both
        pairs = all_gather(mesh, torch.stack([score[best].double(),
                                              best.double()]))
        winner = torch.argmax(pairs[:, 0])
        placed = pairs[winner, 0] > -BIG
        local = pairs[winner, 1].long()
        take = torch.where(placed & (winner == me), demand,
                           torch.zeros_like(demand))
        avail.index_copy_(0, local[None], avail[local][None] - take)
        assignment[i] = torch.where(placed, winner * nloc + local,
                                    -1).to(torch.int32)
    return MatchResult(assignment=assignment,
                       new_avail=_gather_lanes(mesh, avail))


def node_sharded_chunked_match(mesh: Mesh, problem: MatchProblem, *,
                               chunk: int = 1024, rounds: int = 3,
                               kc: int = 128,
                               passes: int = 2) -> MatchResult:
    """The chunked matcher with its candidate pass sharded over the NODE
    axis: the scalable single-huge-pool path.

    The availability [N, R] stays REPLICATED (the conflict rounds update
    arbitrary global nodes); what scales is the [K, N] scoring, so each
    rank scores only its N/D node columns against its slice of the
    constraint mask (no rank holds the whole [J, N] mask), takes a local
    top-kc, and one all-gather of [D, K, kc_local] values and indices
    merges them into a global top-kc.  The merge keeps JAX `top_k`'s tie
    order (a stable descending sort: lower rank, then lower index, on a
    tie).  `conflict_round` then runs replicated and deterministic on
    every rank.  The result is the reference's at the same mesh size; a
    one-rank mesh gives `chunked_match` (xla) exactly.  Like the
    reference, it ignores a `node_bonus`."""
    j, n = int(problem.demands.shape[0]), int(problem.avail.shape[0])
    if j % chunk:
        raise ValueError(f"pad jobs ({j}) to a multiple of chunk ({chunk})")
    rows = _node_rows(mesh, n)
    nloc = n // mesh.size
    kc_local = min(kc, nloc)   # a rank's top-k is bounded by its shard
    kc = min(kc, n)            # the MERGED list keeps the requested width
    width = min(kc, mesh.size * kc_local)
    demands, job_valid = (_put(mesh, problem.demands),
                          _put(mesh, problem.job_valid))
    avail = _put(mesh, problem.avail).clone()
    totals_l = _put(mesh, problem.totals, rows)
    nv_l = _put(mesh, problem.node_valid, rows)
    feas_l = (None if problem.feasible is None
              else _put(mesh, problem.feasible[:, rows]))
    denom_l = totals_l.clamp_min(1e-30)
    col0 = rows.start
    out = []
    for c0 in range(0, j, chunk):
        d = demands[c0:c0 + chunk]
        ok = job_valid[c0:c0 + chunk]
        fr_l = None if feas_l is None else feas_l[c0:c0 + chunk]
        assignment = torch.full((d.shape[0],), -1, dtype=torch.int32,
                                device=d.device)
        for _ in range(passes):
            avail_l = avail[rows]
            unplaced = assignment < 0
            feasible = ((avail_l[None, :, :] >= d[:, None, :]).all(-1)
                        & nv_l[None, :] & (ok & unplaced)[:, None])
            if fr_l is not None:
                feasible = feasible & fr_l
            used0 = totals_l[:, 0] - avail_l[:, 0]
            used1 = totals_l[:, 1] - avail_l[:, 1]
            fit = binpack_fitness(used0[None, :], used1[None, :],
                                  d[:, 0:1], d[:, 1:2], denom_l[None, :, 0],
                                  denom_l[None, :, 1])
            lval, lidx = _top_kc(torch.where(feasible, fit, -BIG), kc_local)
            # [D, K, kc_l] -> [K, D * kc_l] -> the global top-kc
            all_val = all_gather(mesh, lval).permute(1, 0, 2).flatten(1)
            all_idx = all_gather(mesh, lidx + col0).permute(1, 0, 2) \
                .flatten(1)
            cand_val, pos = _top_kc(all_val, width)
            cand_idx = all_idx.gather(1, pos.long())
            for _ in range(rounds):
                avail, assignment = conflict_round(
                    avail, assignment, cand_val, cand_idx, d, n)
        out.append(assignment)
    return MatchResult(assignment=torch.cat(out), new_avail=avail)
