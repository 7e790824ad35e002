"""The match cycle: ranked queue + offers -> device solve -> launches.

Port of `cook_tpu/scheduler/matcher.py`: considerable-job selection
(`select_considerable`), the problem encoding (`encode_problem_arrays`,
`padded_job_axis`, `build_match_problem`), the solve dispatch
(`dispatch_pool_solve`: the flat chunked or exact solve, or the
hierarchical two-level solve behind `HierarchicalPending` for pools at or
over `hierarchical_threshold`), and `prepare_pool_problem` /
`finalize_pool_match` / `match_pool`, with the rebalancer's host
reservations honoured by the feasibility mask, and `topology_block_width`
(the block a host belongs to, stamped on the fairness ledger).

Left for later slices: the gang, encode-cache, device-residency,
predictor, quality-audit and flight-recorder branches.  The
reference's device-fallback ladder (re-solving a failed device solve on
the CPU) has no counterpart: here a solve error propagates, so a fault of
the card or the kernel is never hidden.

Reference: `handle-fenzo-pool` / `handle-resource-offers!` / `launch-
matched-tasks!` (Cook's scheduler.clj:617-1651) with the Fenzo solve
replaced by the `ops.match` kernels, plus head-of-queue fairness backoff
(scheduler.clj:1613-1651) and launch transactions under the cluster's
kill-lock read side (scheduler.clj:962-1048).
"""
from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cook_tpu_torch.cluster.base import (
    ComputeCluster,
    Offer,
    TaskSpec,
    safe_pool_offers,
)
from cook_tpu_torch.models.entities import (
    GroupPlacementType,
    InstanceStatus,
    Job,
    JobState,
    Pool,
)
from cook_tpu_torch.models.store import JobStore, TransactionVetoed
from cook_tpu_torch.ops.common import PendingResult, bucket_size, pad_to
from cook_tpu_torch.ops.match import (
    MatchProblem,
    backend_flags,
    chunked_match,
    greedy_match,
    vmap_safe_backend,
)
from cook_tpu_torch.scheduler.constraints import (
    MISSING_ATTR,
    EncodedNodes,
    balanced_group_topup,
    encode_nodes,
    feasibility_mask,
    validate_group_assignments,
)
from cook_tpu_torch.scheduler.ranking import QuotaWalk, RankedQueue

log = logging.getLogger(__name__)

# operator-facing placement-failure texts, as the reference's flight
# recorder words them (flight_recorder.REASON_TEXT; the recorder itself is
# a later slice)
NO_OFFERS = "no offers"
CONSTRAINTS_FILTERED = "all nodes filtered by constraints"
INSUFFICIENT_RESOURCES = "insufficient resources on feasible nodes"
LAUNCH_CAP = "cluster launch rate/cap reached this cycle"
PORTS_EXHAUSTED = "insufficient free ports on the matched node"


@dataclass
class MatchConfig:
    """Fenzo-knob equivalents (reference config.clj:108-116), the flat-path
    subset of the reference's MatchConfig."""

    max_jobs_considered: int = 1000
    scaleback: float = 0.95
    floor_iterations_before_reset: int = 1000000
    chunk: int = 0           # 0 = exact sequential greedy kernel
    chunk_rounds: int = 3
    chunk_passes: int = 2    # candidate recomputes per chunk
    chunk_kc: int = 128      # candidate-list width per job
    # "xla" (exact top-kc candidate lists), "pallas" (the best_node
    # kernel), or "bucketed" (class-shared candidate lists + exact
    # cleanup pass) — the reference's backend names
    backend: str = "xla"
    # extra memory a checkpointing job consumes for its tooling, applied
    # at MATCH time (demands + TaskSpec) so placement and the launched
    # pod agree (calculate-effective-resources, api.clj:1152)
    checkpoint_memory_overhead_mb: float = 0.0
    # hierarchical two-level matcher (ops/hierarchical.py): a pool whose
    # padded jobs x nodes product reaches this threshold solves coarse
    # jobs x blocks, then every block's fine problem batched over the
    # block axis, plus bounded refinement.  0 disables.
    hierarchical_threshold: int = 0
    # block geometry overrides; 0 = auto from the tuned buckets
    # (ops/hierarchical.NODE_BLOCK_BUCKETS / block_slack)
    hierarchical_nodes_per_block: int = 0
    hierarchical_jobs_per_block: int = 0
    hierarchical_refine_rounds: int = 2
    # superblock (DCN-domain) layer: not ported yet, > 0 raises at solve
    # time (config key `hier_superblock_nodes`)
    hierarchical_superblock_nodes: int = 0
    # coarse block-scoring backend: "xla" (masked chunked matcher) or
    # "pallas" (the coarse_pass kernel)
    hierarchical_coarse_backend: str = "xla"
    # the reference shards the fine batch over its device mesh; one card
    # has no mesh, so nothing in the port reads it: the field exists only
    # so that a configuration loads here as it loads in the reference.  It
    # goes (or gains a meaning) when the port's mesh is built (ROADMAP
    # Queue A item 9)
    hierarchical_use_mesh: bool = True
    # fine-solve backend: "xla" (a chunked solve per block) or "pallas"
    # (the best_node_batched kernel)
    hierarchical_fine_backend: str = "xla"

    def __post_init__(self):
        backend_flags(self.backend)  # raises on unknown names
        if self.hierarchical_coarse_backend not in ("xla", "pallas"):
            raise ValueError(
                f"unknown hierarchical coarse backend "
                f"{self.hierarchical_coarse_backend!r} "
                "(expected xla | pallas)")
        if self.hierarchical_fine_backend not in ("xla", "pallas"):
            raise ValueError(
                f"unknown hierarchical fine backend "
                f"{self.hierarchical_fine_backend!r} "
                "(expected xla | pallas)")
        if self.backend == "bucketed" and 0 < self.chunk and \
                self.chunk_passes < 2:
            raise ValueError(
                "backend 'bucketed' requires chunk_passes >= 2 (the final "
                "pass is the exact per-job cleanup)")


@dataclass
class PoolMatchState:
    """Mutable per-pool matcher state (head-of-queue backoff)."""

    num_considerable: int
    iterations_at_floor: int = 0


@dataclass
class MatchOutcome:
    matched: list[tuple[Job, Offer]] = field(default_factory=list)
    launched_task_ids: list[str] = field(default_factory=list)
    unmatched: list[Job] = field(default_factory=list)
    offers_total: int = 0
    head_matched: bool = True
    # host-clock seconds of match_pool's phases: encode
    # (prepare_pool_problem), solve (dispatch through the fetch that
    # observes completion) and launch (finalize_pool_match)
    phase_wall_s: dict[str, float] = field(default_factory=dict)


def select_considerable(
    store: JobStore,
    pool: Pool,
    queue: RankedQueue,
    limit: int,
    *,
    launch_filter: Optional[Callable[[Job], bool]] = None,
) -> list[Job]:
    """Head of the ranked queue, re-filtered against LIVE per-user quota
    and usage, then launch-filtered, capped at `limit` (scheduler.clj:729
    `pending-jobs->considerable-jobs` + tools.clj:961).  Quota admission
    consumes the user's budget even for jobs a later filter rejects, as in
    the reference."""
    walk = QuotaWalk(store, pool.name)
    out = []
    for job in queue.jobs:
        # stale-queue liveness: a job killed/launched since the rank tick
        # must neither be matched nor consume the user's quota budget
        live = store.jobs.get(job.uuid)
        if live is None or live.state is not JobState.WAITING:
            continue
        if not walk.admit(job):
            continue
        if launch_filter is not None and not launch_filter(job):
            continue
        out.append(job)
        if len(out) >= limit:
            break
    return out


def job_mem_with_overhead(job: Job, config: MatchConfig) -> float:
    """Effective memory demand: checkpointing jobs carry the tooling
    overhead from match time onward."""
    mem = job.resources.mem
    if job.checkpoint is not None and job.checkpoint.mode:
        mem += config.checkpoint_memory_overhead_mb
    return mem


def encode_problem_arrays(
    jobs: Sequence[Job],
    offers: Sequence,
    config: Optional[MatchConfig] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(demands[j,4], avail[n,4], totals[n,2]) float32 rows — the one
    resource encoding of the problem build."""
    demands = np.zeros((len(jobs), 4), dtype=np.float32)
    for i, job in enumerate(jobs):
        r = job.resources
        mem = (job_mem_with_overhead(job, config)
               if config is not None else r.mem)
        demands[i] = (mem, r.cpus, r.gpus, r.disk)
    avail = np.zeros((len(offers), 4), dtype=np.float32)
    totals = np.zeros((len(offers), 2), dtype=np.float32)
    for i, o in enumerate(offers):
        avail[i] = (o.mem, o.cpus, o.gpus, o.disk)
        totals[i] = (o.total_mem or o.mem, o.total_cpus or o.cpus)
    return demands, avail, totals


def padded_job_axis(j: int, chunk: int = 0) -> int:
    """Padded job-axis size of a match problem: the power-of-two bucket,
    rounded up to a chunk multiple when the chunked matcher is in use."""
    pad_j = bucket_size(max(j, 1))
    if chunk:
        pad_j = max(pad_j, chunk)
        pad_j += (-pad_j) % chunk
    return pad_j


def build_match_problem(
    jobs: Sequence[Job],
    nodes: EncodedNodes,
    feasible: np.ndarray,
    *,
    device: torch.device,
    chunk: int = 0,
    config: Optional[MatchConfig] = None,
) -> MatchProblem:
    """The padded problem tensors on `device`: jobs to `padded_job_axis`,
    nodes to their power-of-two bucket, padding invalid."""
    j, n = len(jobs), nodes.n
    pad_j = padded_job_axis(j, chunk)
    pad_n = bucket_size(max(n, 1))
    demands, avail, totals = encode_problem_arrays(jobs, nodes.offers,
                                                   config)
    feas = np.zeros((pad_j, pad_n), dtype=bool)
    feas[:j, :n] = feasible

    def put(arr):
        return torch.as_tensor(arr, device=device)

    return MatchProblem(
        demands=put(pad_to(demands, pad_j)),
        job_valid=put(pad_to(np.ones(j, dtype=bool), pad_j, fill=False)),
        avail=put(pad_to(avail, pad_n)),
        totals=put(pad_to(totals, pad_n)),
        node_valid=put(pad_to(np.ones(n, dtype=bool), pad_n, fill=False)),
        feasible=put(feas),
    )


def problem_shape(problem: MatchProblem) -> tuple[int, int]:
    """(padded jobs, padded nodes) of the solve."""
    return (int(problem.demands.shape[0]), int(problem.avail.shape[0]))


def hierarchical_enabled(config: MatchConfig,
                         problem: MatchProblem) -> bool:
    """Automatic two-level path: padded jobs x nodes at/over the
    configured threshold (0 = never)."""
    if config.hierarchical_threshold <= 0:
        return False
    j, n = problem_shape(problem)
    return j * n >= config.hierarchical_threshold


def topology_block_width(n_nodes: int) -> int:
    """Block width (hosts) of the topology: the hierarchical
    decomposition's tuned bucket, so that "one block" means the same to
    the fairness ledger and to the two-level matcher.  The reference's
    `MatchConfig.topology_block_hosts` override, read there by the
    topology bonus and gang blocks, comes with the gang slice."""
    from cook_tpu_torch.ops.hierarchical import choose_nodes_per_block

    return choose_nodes_per_block(max(n_nodes, 1))


def hier_params_from_config(config: MatchConfig):
    """MatchConfig -> ops/hierarchical.HierParams (the chunked-matcher
    knobs carry over so the fine solve uses the pool's tuned config)."""
    from cook_tpu_torch.ops.hierarchical import HierParams

    return HierParams(
        nodes_per_block=config.hierarchical_nodes_per_block,
        jobs_per_block=config.hierarchical_jobs_per_block,
        refine_rounds=config.hierarchical_refine_rounds,
        superblock_nodes=config.hierarchical_superblock_nodes,
        chunk=config.chunk or 1024,
        rounds=config.chunk_rounds,
        passes=config.chunk_passes,
        kc=config.chunk_kc,
        backend=vmap_safe_backend(config.backend),
        coarse_backend=config.hierarchical_coarse_backend,
        fine_backend=config.hierarchical_fine_backend,
    )


class HierarchicalPending:
    """PendingResult stand-in for a pool solved by the two-level matcher:
    the coarse/scatter/fine/refine pipeline needs host round-trips, so the
    whole solve runs at `fetch()`.  Its stats land on
    `prepared.hier_stats`."""

    __slots__ = ("prepared", "config")

    def __init__(self, prepared: "PreparedPool", config: MatchConfig):
        self.prepared = prepared
        self.config = config

    def fetch(self) -> np.ndarray:
        from cook_tpu_torch.ops.hierarchical import hierarchical_match

        result, stats = hierarchical_match(
            self.prepared.problem,
            params=hier_params_from_config(self.config))
        self.prepared.hier_stats = stats
        return result.assignment[: len(self.prepared.considerable)] \
            .cpu().numpy()


def dispatch_pool_solve(prepared: "PreparedPool", config: MatchConfig):
    """Dispatch the pool's match kernels WITHOUT observing completion; the
    returned PendingResult's `fetch()` is the one completion observation.
    Pools at/over `hierarchical_threshold` route to the two-level matcher
    behind the same interface; otherwise `chunk` > 0 runs
    `chunked_match`, else the exact `greedy_match`."""
    if hierarchical_enabled(config, prepared.problem):
        return HierarchicalPending(prepared, config)
    if config.chunk:
        result = chunked_match(prepared.problem, chunk=config.chunk,
                               rounds=config.chunk_rounds,
                               passes=config.chunk_passes,
                               kc=config.chunk_kc,
                               **backend_flags(config.backend))
    else:
        result = greedy_match(prepared.problem)
    return PendingResult(result.assignment[: len(prepared.considerable)])


def gather_group_context(
    store: JobStore,
    jobs: Sequence[Job],
    host_attrs: Optional[dict[str, dict]] = None,
):
    """Hostnames/attr-values pinned by running group members.

    `host_attrs` maps hostname -> attribute dict for every host the
    scheduler has ever seen an offer from — running members may sit on
    hosts absent from this cycle's offers (full hosts emit no offer), and
    the reference's balanced-host constraint counts ALL running members
    (constraints.clj:600), not just those on currently-offered hosts."""
    group_used_hosts: dict[str, set[str]] = {}
    group_attr_value: dict[str, tuple[str, str]] = {}
    group_balance_counts: dict[str, dict[str, int]] = {}
    groups = {}
    for job in jobs:
        if not job.group_uuid or job.group_uuid in groups:
            continue
        group = store.groups.get(job.group_uuid)
        if group is None:
            continue
        groups[group.uuid] = group
        ptype = group.host_placement.type
        count_attr = (group.host_placement.attribute
                      if host_attrs and ptype in (
                          GroupPlacementType.BALANCED,
                          GroupPlacementType.ATTRIBUTE_EQUALS)
                      else None)
        hosts: set[str] = set()
        # counts are per running TASK, not per distinct host — the
        # reference takes frequencies over cohost attr maps, one per cotask
        # (constraints.clj:600), and a balanced group may co-locate members
        counts: dict[str, int] = {}
        for member_uuid in group.job_uuids:
            for inst in store.job_instances(member_uuid):
                if inst.status.terminal or not inst.hostname:
                    continue
                hosts.add(inst.hostname)
                if count_attr is not None:
                    value = host_attrs.get(inst.hostname, {}).get(count_attr)
                    if value is None and ptype == GroupPlacementType.BALANCED:
                        value = MISSING_ATTR  # nil counts as a value
                    if value is not None:
                        counts[value] = counts.get(value, 0) + 1
        group_used_hosts[group.uuid] = hosts
        if counts:
            if ptype == GroupPlacementType.BALANCED:
                group_balance_counts[group.uuid] = counts
            elif group.uuid not in group_attr_value:
                # running members pin the attribute value for the group
                group_attr_value[group.uuid] = (
                    count_attr, max(counts, key=counts.get))
    return groups, group_used_hosts, group_attr_value, group_balance_counts


def assign_ports(offer, used: set, count: int) -> Optional[tuple]:
    """Pick `count` concrete ports from the offer's free ranges, skipping
    ports already taken this cycle (mesos/task.clj port assignment)."""
    if count <= 0:
        return ()
    picked = []
    for begin, end in offer.ports:
        for port in range(begin, end + 1):
            if port in used:
                continue
            picked.append(port)
            if len(picked) == count:
                return tuple(picked)
    return None


def previous_failed_hosts(store: JobStore,
                          jobs: Sequence[Job]) -> dict[str, set[str]]:
    """novel-host constraint input: hosts each job already failed on."""
    out: dict[str, set[str]] = {}
    for job in jobs:
        hosts = {
            inst.hostname
            for inst in store.job_instances(job.uuid)
            if inst.status.terminal and inst.hostname
        }
        if hosts:
            out[job.uuid] = hosts
    return out


@dataclass
class PreparedPool:
    """Host-side encoding of one pool's match problem, ready to solve."""

    pool: Pool
    outcome: MatchOutcome
    considerable: list = field(default_factory=list)
    cluster_offers: list = field(default_factory=list)
    nodes: Optional[EncodedNodes] = None
    groups: dict = field(default_factory=dict)
    group_used_hosts: dict = field(default_factory=dict)
    group_attr_value: dict = field(default_factory=dict)
    group_balance_counts: dict = field(default_factory=dict)
    balanced_pre_rows: dict = field(default_factory=dict)
    feasible: Optional[np.ndarray] = None
    problem: Optional[MatchProblem] = None
    # two-level solve accounting (ops/hierarchical.py stats), set by
    # HierarchicalPending.fetch
    hier_stats: Optional[dict] = None

    @property
    def solvable(self) -> bool:
        return self.problem is not None


def prepare_pool_problem(
    store: JobStore,
    pool: Pool,
    queue: RankedQueue,
    clusters: Sequence[ComputeCluster],
    config: MatchConfig,
    state: PoolMatchState,
    *,
    device: torch.device,
    launch_filter: Optional[Callable[[Job], bool]] = None,
    host_reservations: Optional[dict[str, str]] = None,
    host_attrs: Optional[dict[str, dict]] = None,
) -> PreparedPool:
    """Gather offers + considerable jobs and encode the tensor problem.
    `host_reservations` (hostname -> reserving job uuid, set by the
    rebalancer) closes each reserved host to every other job."""
    prepared = PreparedPool(pool=pool, outcome=MatchOutcome())

    # offers from every running cluster (scheduler.clj:1574-1585); an
    # offer RPC raising skips that cluster for this scan
    for cluster in clusters:
        if not cluster.accepts_work:
            continue
        offers = safe_pool_offers(cluster, pool.name)
        if offers is None:
            continue
        for offer in offers:
            prepared.cluster_offers.append((cluster, offer))
    prepared.outcome.offers_total = len(prepared.cluster_offers)

    prepared.considerable = select_considerable(
        store, pool, queue, state.num_considerable,
        launch_filter=launch_filter)
    considerable = prepared.considerable
    if not considerable or not prepared.cluster_offers:
        return prepared

    nodes = encode_nodes([o for _, o in prepared.cluster_offers])
    prepared.nodes = nodes
    # every host in this cycle's offers contributes attrs, written back
    # into the caller's accumulated cache HERE (pre-match) — a host whose
    # first offer is fully consumed this cycle would otherwise never be
    # cached and its running group members would count as attribute-less
    if host_attrs is not None:
        for o in nodes.offers:
            host_attrs[o.hostname] = dict(o.attributes)
        merged_attrs: dict = host_attrs
    else:
        merged_attrs = {o.hostname: dict(o.attributes) for o in nodes.offers}
    (prepared.groups, prepared.group_used_hosts,
     prepared.group_attr_value,
     prepared.group_balance_counts) = gather_group_context(
        store, considerable, host_attrs=merged_attrs)
    feasible = feasibility_mask(
        considerable,
        nodes,
        previous_hosts=previous_failed_hosts(store, considerable),
        group_used_hosts=prepared.group_used_hosts,
        group_attr_value=prepared.group_attr_value,
        group_balance_counts=prepared.group_balance_counts,
        groups=prepared.groups,
        offer_locations=[c.location for c, _ in prepared.cluster_offers],
        balanced_pre_rows=prepared.balanced_pre_rows,
    )
    if host_reservations:
        # rebalancer reservations (constraints.clj:242 + reserve-hosts!,
        # rebalancer.clj:419): a reserved host only accepts its reserving
        # job.  The gang:<group> tags of gang admission come with the gang
        # slice
        reserved_for = np.array(
            [host_reservations.get(o.hostname, "") for o in nodes.offers]
        )
        has_reservation = reserved_for != ""
        for ji, job in enumerate(considerable):
            allowed = ~has_reservation | (reserved_for == job.uuid)
            feasible[ji] &= allowed
            # the saved pre-closure rows must honor reservations too, or
            # the balanced top-up could steal a reserved host
            if ji in prepared.balanced_pre_rows:
                prepared.balanced_pre_rows[ji] &= allowed
    prepared.feasible = feasible
    prepared.problem = build_match_problem(considerable, nodes, feasible,
                                           device=device,
                                           chunk=config.chunk, config=config)
    return prepared


def finalize_pool_match(
    store: JobStore,
    prepared: PreparedPool,
    assignment: np.ndarray,
    config: MatchConfig,
    state: PoolMatchState,
    clusters: Sequence[ComputeCluster],
    *,
    make_task_id: Callable[[Job], str],
    record_placement_failure: Optional[Callable[[Job, str], None]] = None,
) -> MatchOutcome:
    """Apply a solved assignment: group validation, launch transactions,
    backend launches, autoscaling, head-of-queue backoff."""
    outcome = prepared.outcome
    considerable = prepared.considerable
    pool = prepared.pool
    if not prepared.solvable:
        outcome.unmatched = considerable
        outcome.head_matched = not considerable
        _apply_backoff(config, state, outcome.head_matched)
        return outcome
    nodes = prepared.nodes
    cluster_offers = prepared.cluster_offers
    feasible = prepared.feasible
    live_balance_counts: dict = {}
    assignment = validate_group_assignments(
        considerable, assignment, nodes, prepared.groups,
        prepared.group_used_hosts, prepared.group_attr_value,
        prepared.group_balance_counts,
        out_balance_counts=live_balance_counts,
    )
    if any(assignment[ji] < 0 for ji in prepared.balanced_pre_rows):
        # retry balanced-group jobs the stale pre-mask closed out, against
        # post-cycle counts (intra-cycle leveling re-opens values)
        demands, remaining, totals = encode_problem_arrays(
            considerable, nodes.offers, config)
        placed_mask = assignment >= 0
        np.subtract.at(remaining, assignment[placed_mask],
                       demands[placed_mask])
        assignment = balanced_group_topup(
            considerable, assignment, nodes, prepared.groups,
            live_balance_counts, prepared.balanced_pre_rows,
            remaining, demands, totals=totals)

    # transact + launch (scheduler.clj:790-1048)
    launches_per_cluster: dict[str, list[TaskSpec]] = {}
    cluster_by_name = {}
    # per-cluster launch budgets this cycle (max-launchable,
    # scheduler.clj:887)
    cluster_budget: dict[str, int] = {}
    # ports handed out this cycle, per node (the mask guaranteed counts
    # against the offer; concrete picks must not collide intra-cycle)
    ports_used: dict[int, set] = {}

    def fail(job: Job, text: str) -> None:
        outcome.unmatched.append(job)
        if record_placement_failure is not None:
            record_placement_failure(job, text)

    for ji, job in enumerate(considerable):
        node_idx = int(assignment[ji])
        if node_idx < 0:
            fail(job, _failure_reason(nodes, feasible[ji]))
            continue
        cluster, offer = cluster_offers[node_idx]
        budget = cluster_budget.get(cluster.name)
        if budget is None:
            budget = cluster.max_launchable()
            # per-cluster launch rate limiter (rate_limit.clj:44): this
            # cycle may launch at most the bucket's current balance here
            limiter = getattr(cluster, "launch_rate_limiter", None)
            tokens_available = getattr(limiter, "tokens_available", None)
            if tokens_available is not None:
                tokens = tokens_available(cluster.name)
                if math.isfinite(tokens):
                    budget = min(budget, int(tokens))
        if budget <= 0:
            # over the cluster's launch cap: reject BEFORE assigning ports;
            # cache the zero so a bucket refilling mid-cycle cannot admit
            # lower-ranked jobs after higher-ranked ones were rejected
            cluster_budget[cluster.name] = 0
            fail(job, LAUNCH_CAP)
            continue
        task_ports = assign_ports(offer,
                                  ports_used.setdefault(node_idx, set()),
                                  job.resources.ports)
        if task_ports is None:
            fail(job, PORTS_EXHAUSTED)
            continue
        ports_used[node_idx].update(task_ports)
        cluster_budget[cluster.name] = budget - 1
        task_id = make_task_id(job)
        try:
            store.create_instance(
                job.uuid,
                task_id,
                hostname=offer.hostname,
                node_id=offer.node_id,
                compute_cluster=cluster.name,
            )
        except TransactionVetoed:
            # job completed/launched concurrently; drop the match
            continue
        checkpoint_env: tuple = ()
        if job.checkpoint is not None and job.checkpoint.mode:
            checkpoint_env = (
                ("COOK_CHECKPOINT_MODE", job.checkpoint.mode),
                ("COOK_CHECKPOINT_PERIOD_SEC",
                 str(job.checkpoint.periodic_sec)),
            )
            if job.checkpoint.preserve_paths:
                checkpoint_env += (
                    ("COOK_CHECKPOINT_PRESERVE_PATHS",
                     ":".join(job.checkpoint.preserve_paths)),
                )
        spec = TaskSpec(
            task_id=task_id,
            job_uuid=job.uuid,
            user=job.user,
            command=job.command,
            mem=job_mem_with_overhead(job, config),
            cpus=job.resources.cpus,
            gpus=job.resources.gpus,
            node_id=offer.node_id,
            hostname=offer.hostname,
            disk=job.resources.disk,
            env=job.user_provided_env + checkpoint_env + tuple(
                (f"PORT{i}", str(p)) for i, p in enumerate(task_ports)),
            container_image=(job.container.image if job.container else ""),
            expected_runtime_ms=job.expected_runtime_ms,
            ports=task_ports,
            checkpoint_mode=(job.checkpoint.mode if job.checkpoint else ""),
            checkpoint_periodic_sec=(job.checkpoint.periodic_sec
                                     if job.checkpoint else 0),
            checkpoint_preserve_paths=(tuple(job.checkpoint.preserve_paths)
                                       if job.checkpoint else ()),
        )
        cluster_by_name[cluster.name] = cluster
        launches_per_cluster.setdefault(cluster.name, []).append(spec)
        outcome.matched.append((job, offer))
        outcome.launched_task_ids.append(task_id)

    for cname, specs in launches_per_cluster.items():
        cluster = cluster_by_name[cname]
        limiter = getattr(cluster, "launch_rate_limiter", None)
        if limiter is not None:
            # spend-through: charge the work that is about to happen
            limiter.spend(cname, float(len(specs)))
        try:
            # read side of the kill-lock: kills can't interleave mid-launch
            with cluster.kill_lock.read():
                cluster.run_launch(pool.name, specs)
        except Exception as exc:  # noqa: BLE001 — one cluster's RPC
            # failure must not abort the remaining clusters' launches
            log.exception("launch_tasks failed (cluster %s, pool %s, "
                          "%d specs); failing its specs and continuing",
                          cname, pool.name, len(specs))
            fail_launched_specs(store, specs, exc)

    # autoscaling: surface unmatched demand to autoscaling clusters
    # (trigger-autoscaling!, scheduler.clj:1178,1509)
    if outcome.unmatched:
        demand = [
            TaskSpec(
                task_id=f"pending-{job.uuid}",
                job_uuid=job.uuid,
                user=job.user,
                command=job.command,
                mem=job.resources.mem,
                cpus=job.resources.cpus,
                gpus=job.resources.gpus,
                node_id="",
                hostname="",
                disk=job.resources.disk,
            )
            for job in outcome.unmatched
        ]
        for cluster in clusters:
            if cluster.accepts_work and cluster.autoscaling(pool.name):
                cluster.autoscale(pool.name, demand)

    # head-of-queue backoff
    head = considerable[0]
    outcome.head_matched = any(j.uuid == head.uuid for j, _ in outcome.matched)
    _apply_backoff(config, state, outcome.head_matched)
    return outcome


def fail_launched_specs(store: JobStore, specs: Sequence[TaskSpec],
                        exc: BaseException) -> None:
    """Launch-failure flow-back: each spec's already-transacted instance
    transitions to failed with the mea-culpa `launch-failed` reason (the
    job re-queues without consuming its retry budget)."""
    for spec in specs:
        try:
            store.update_instance_state(spec.task_id, InstanceStatus.FAILED,
                                        "launch-failed")
        except Exception:  # noqa: BLE001 — one bad transition must not
            # strand the rest of the batch in limbo
            log.exception("launch-failed transition for %s did not apply "
                          "(%s)", spec.task_id, exc)


def match_pool(
    store: JobStore,
    pool: Pool,
    queue: RankedQueue,
    clusters: Sequence[ComputeCluster],
    config: MatchConfig,
    state: PoolMatchState,
    *,
    device: torch.device,
    make_task_id: Callable[[Job], str],
    launch_filter: Optional[Callable[[Job], bool]] = None,
    record_placement_failure: Optional[Callable[[Job, str], None]] = None,
    host_reservations: Optional[dict[str, str]] = None,
    host_attrs: Optional[dict[str, dict]] = None,
) -> MatchOutcome:
    """One pool's match cycle end to end (prepare -> solve -> finalize).
    A solve error propagates: there is no CPU re-solve behind the card."""
    t0 = time.perf_counter()
    prepared = prepare_pool_problem(
        store, pool, queue, clusters, config, state, device=device,
        launch_filter=launch_filter, host_reservations=host_reservations,
        host_attrs=host_attrs)
    t1 = time.perf_counter()
    assignment = np.empty(0, dtype=np.int32)
    if prepared.solvable:
        assignment = dispatch_pool_solve(prepared, config).fetch()
    t2 = time.perf_counter()
    outcome = finalize_pool_match(
        store, prepared, assignment, config, state, clusters,
        make_task_id=make_task_id,
        record_placement_failure=record_placement_failure)
    outcome.phase_wall_s = {"encode": t1 - t0, "solve": t2 - t1,
                            "launch": time.perf_counter() - t2}
    hier = prepared.hier_stats
    if hier is not None:
        # the two-level solve's split of `solve`, under the names of the
        # reference's CycleRecord.hier_phases
        outcome.phase_wall_s.update(coarse_solve=hier["coarse_s"],
                                    fine_solve=hier["fine_s"],
                                    refine=hier["refine_s"])
    return outcome


def _apply_backoff(config: MatchConfig, state: PoolMatchState,
                   head_matched: bool) -> None:
    if head_matched:
        state.num_considerable = config.max_jobs_considered
        state.iterations_at_floor = 0
    else:
        shrunk = max(1, int(state.num_considerable * config.scaleback))
        if shrunk == state.num_considerable:
            state.iterations_at_floor += 1
            if state.iterations_at_floor >= config.floor_iterations_before_reset:
                state.num_considerable = config.max_jobs_considered
                state.iterations_at_floor = 0
                return
        state.num_considerable = shrunk


def _failure_reason(nodes: EncodedNodes, feas_row: np.ndarray) -> str:
    """Operator-facing reason for an unmatched job."""
    if nodes.n == 0:
        return NO_OFFERS
    if not feas_row.any():
        return CONSTRAINTS_FILTERED
    return INSUFFICIENT_RESOURCES
