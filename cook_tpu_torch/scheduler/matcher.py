"""The match cycle: ranked queue + offers -> device solve -> launches.

Port of `cook_tpu/scheduler/matcher.py`: considerable-job selection
(`select_considerable`), the problem encoding (`encode_problem_arrays`,
`padded_job_axis`, `build_match_problem`), the solve dispatch
(`dispatch_pool_solve`: the flat chunked or exact solve, or the
hierarchical two-level solve behind `HierarchicalPending` for pools at or
over `hierarchical_threshold`), and `prepare_pool_problem` /
`finalize_pool_match` / `match_pool`, with the rebalancer's host
reservations (and gang admission's `gang:<group>` tags) honoured by the
feasibility mask, `topology_block_width` (the block a host belongs to)
and `topology_bonus` (the topology distance term).

Gangs: `gang_context` gives the considerable window's gang rows; the
hierarchical solve routes and filters them by block; the chokepoint of
`finalize_pool_match` repairs and filters every path's assignment on the
host (`ops/gang.np_gang_repair`, `np_gang_filter`), tops the freed hosts
up with scalar jobs, and transacts each gang atomically (a member that
fails to transact rolls its siblings back), as the reference's
(`cook_tpu/scheduler/matcher.py:1260-1560`).

The reference's default configuration rides along: `prepare_pool_problem`
takes the host-encode cache (`encode_cache.EncodeCache`: node encoding
keyed by the offer-set fingerprint, feasibility rows per job), every
transfer is noted in the cycle's data-plane scope, and `match_pool`
writes the flight recorder's cycle record (`flight=`: phases, counts,
skips with reason codes, matches, the solve's identity, the hierarchical
and gang accounting) and reports the solve to the device telemetry
(`telemetry=`: compile accounting, latency baseline, sampled CPU shadow
solves) through `record_solve_outcome`.

Many pools in one cycle: `match_pools_batched` (the pool-batched pass:
flat pools stacked by `stack_pool_problems` and solved in one call of
`chunked_match_pools` or `greedy_match_pools`, pools at or over the
threshold on the two-level path alone) and, in `scheduler/pipeline.py`,
the pipelined pass, which finalizes with `async_launch` (each cluster's
launches on its launch worker, failures through `launch_failure_cb`).

Device-resident match state (`MatchConfig.device_residency`,
scheduler/device_state.py): `prepare_pool_problem` serves the problem
from the pool's resident mirror when an encode cache and a
`device_state` are given and the cycle has no host reservations; with
`quantized` the cost tensors are bfloat16 on either build path.

The estimated-completion constraint (`MatchConfig.completion_multiplier`,
`host_lifetime_mins`, `agent_start_grace_mins`; `estimated_end_times`,
the runtime predictor filling in undeclared runtimes) closes hosts that
die before a job's estimated end; `prepare_pool_problem` bypasses the
encode cache (and the resident mirror) while it is active.

The exact-kernel quality audit (`MatchConfig.quality_audit_every`,
`start_quality_audit`, `audit_match_quality`): every Nth chunked flat
solve of a pool is replayed through the plain exact `greedy_match` on CPU
copies of its tensors, on a daemon thread, single-flight, and the packing
ratio set on the `match.quality_audit` gauge.  It only observes: nothing
reads the gauge back into a decision.

The `device.solve` fault point (`faults.DEVICE_SOLVE`) sits in front of
every solve: `dispatch_pool_solve` (the serial and pipelined passes) and
both branches of `match_pools_batched`.  The reference's device-fallback
ladder (re-solving a failed device solve on the CPU) has no counterpart:
here a solve error, injected or real, propagates out of the serial and
batched passes (the pipelined pass skips the pool's jobs with
`solve-failed`), so a fault of the card or the kernel is never hidden.
Each failed solve notes the pool on the telemetry first
(`note_solve_failed`): health reads `device-degraded` with the pool's
evidence, and the incident recorder captures its bundle on that edge,
until the pool's next solve on the card succeeds (`note_solve_ok`).
Left out: the roofline probe (XLA's cost analysis has no torch
counterpart).  The pool-batched pass takes the reference's mesh branch
(`parallel/mesh.py`: each rank of a `torch.distributed` mesh solves its
lanes of the batch), and the two-level path shards its fine and
superblock coarse batches over `hier_mesh()`.

Reference: `handle-fenzo-pool` / `handle-resource-offers!` / `launch-
matched-tasks!` (Cook's scheduler.clj:617-1651) with the Fenzo solve
replaced by the `ops.match` kernels, plus head-of-queue fairness backoff
(scheduler.clj:1613-1651) and launch transactions under the cluster's
kill-lock read side (scheduler.clj:962-1048).
"""
from __future__ import annotations

import contextlib
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cook_tpu_torch import faults
from cook_tpu_torch.cluster.base import (
    ClusterState,
    ComputeCluster,
    Offer,
    TaskSpec,
    safe_pool_offers,
)
from cook_tpu_torch.faults.breaker import BreakerState
from cook_tpu_torch.models.entities import (
    GroupPlacementType,
    InstanceStatus,
    Job,
    JobState,
    Pool,
)
from cook_tpu_torch.models.reasons import REASONS_BY_NAME
from cook_tpu_torch.models.store import JobStore, TransactionVetoed
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.obs.compile_observatory import shape_signature
from cook_tpu_torch.ops.common import (
    PendingResult,
    bucket_size,
    fetch_result,
    host_cast,
    pad_to,
)
from cook_tpu_torch.ops.gang import (
    np_block_free_hosts,
    np_gang_filter,
    np_gang_repair,
)
from cook_tpu_torch.ops.match import (
    MatchProblem,
    backend_flags,
    chunked_match,
    chunked_match_pools,
    greedy_match,
    greedy_match_pools,
    vmap_safe_backend,
)
from cook_tpu_torch.parallel.mesh import (
    active_mesh,
    invalid_match_problem,
    pool_sharded_match,
    shard_pools,
)
from cook_tpu_torch.scheduler.constraints import (
    MISSING_ATTR,
    EncodedNodes,
    balanced_group_topup,
    encode_nodes,
    feasibility_mask,
    validate_group_assignments,
)
from cook_tpu_torch.scheduler.device_state import QUANTIZATION_PARITY_FLOOR
from cook_tpu_torch.scheduler import flight_recorder as flight_codes
from cook_tpu_torch.scheduler.flight_recorder import NULL_CYCLE
from cook_tpu_torch.scheduler.ranking import QuotaWalk, RankedQueue
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)


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
    # every Nth chunked solve of a pool is replayed through the exact
    # greedy on the host and the packing ratio gauged
    # (match.quality_audit): the runtime guard that an approximate config
    # keeps packing parity on the live workload.  0 disables; irrelevant
    # at chunk=0 (the exact kernel is in use)
    quality_audit_every: int = 50
    # estimated-completion constraint (constraints.clj:385 +
    # estimated-completion-config): 0 multiplier or lifetime = disabled
    completion_multiplier: float = 0.0
    host_lifetime_mins: float = 0.0
    agent_start_grace_mins: float = 10.0
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
    # superblock (DCN-domain) layer: nodes per superblock (config key
    # `hier_superblock_nodes`); 0 = the classic two-level path
    hierarchical_superblock_nodes: int = 0
    # coarse block-scoring backend: "xla" (masked chunked matcher) or
    # "pallas" (the coarse_pass kernel)
    hierarchical_coarse_backend: str = "xla"
    # shard the two-level solve's fine batch (and the superblock coarse
    # batch) over `hier_mesh()`, the mesh `parallel.mesh.make_mesh` set up
    # in this process, when it spans more than one rank
    hierarchical_use_mesh: bool = True
    # fine-solve backend: "xla" (a chunked solve per block) or "pallas"
    # (the best_node_batched kernel)
    hierarchical_fine_backend: str = "xla"
    # device-resident match state (scheduler/device_state.py): per-pool
    # demand/feasibility tensors stay on the device across cycles;
    # unchanged rows move ZERO bytes, deltas apply as in-place scatters.
    # Off by default, as in the reference
    device_residency: bool = False
    # quantized cost tensors: demands/avail/totals cross (and stay
    # resident) as bfloat16 — half the bytes; feasibility is already
    # bool.  Guarded by the QualityMonitor parity floor below: a pool
    # whose packing efficiency drifts under it demotes to f32
    quantized: bool = False
    quantization_parity_floor: float = QUANTIZATION_PARITY_FLOOR
    # gang scheduling (ops/gang.py + scheduler/gang.py): jobs submitted
    # with gang_size=k place all-or-nothing — k distinct hosts inside ONE
    # topology block on the hierarchical path, whole-pool all-or-nothing
    # on the flat paths unless topology_block_hosts declares the blocks
    # (np_gang_filter in finalize_pool_match is the chokepoint either
    # way).  Disabling treats gang members as independent jobs.
    gang_enabled: bool = True
    # topology distance term: additive per-node score bonus
    # (MatchProblem.node_bonus) of topology_weight x the node's block
    # memory utilization, so placements pack into warm blocks and whole
    # blocks stay free for gangs.  0 disables
    topology_weight: float = 0.0
    # block width (hosts) of the topology: 0 = the hierarchical
    # decomposition's tuned bucket (ops/hierarchical.NODE_BLOCK_BUCKETS)
    topology_block_hosts: int = 0

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
    """Mutable per-pool matcher state (head-of-queue backoff, the quality
    audit's solve count)."""

    num_considerable: int
    iterations_at_floor: int = 0
    chunked_solves: int = 0  # drives the periodic quality audit


@dataclass
class MatchOutcome:
    matched: list[tuple[Job, Offer]] = field(default_factory=list)
    launched_task_ids: list[str] = field(default_factory=list)
    unmatched: list[Job] = field(default_factory=list)
    offers_total: int = 0
    head_matched: bool = True
    # host-clock seconds of match_pool's phases: encode
    # (prepare_pool_problem), solve (dispatch through the fetch that
    # observes completion) and launch (finalize_pool_match), and, in a
    # cycle with gangs, the gang chokepoint's share of launch (`gang`:
    # repair, filter, details and the scalar top-up)
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


def padded_shape(n_jobs: int, n_nodes: int, chunk: int) -> tuple[int, int]:
    """(padded jobs, padded nodes) of a match problem's tensors."""
    return padded_job_axis(n_jobs, chunk), bucket_size(max(n_nodes, 1))


def build_match_problem(
    jobs: Sequence[Job],
    nodes: EncodedNodes,
    feasible: np.ndarray,
    *,
    device: torch.device,
    chunk: int = 0,
    config: Optional[MatchConfig] = None,
    padded_feasible: Optional[np.ndarray] = None,
    quantized: bool = False,
) -> MatchProblem:
    """The padded problem tensors on `device`: jobs to `padded_job_axis`,
    nodes to their power-of-two bucket, padding invalid.
    `padded_feasible`, when given, is the mask already padded to
    `padded_shape` (the encode cache builds it so).  `quantized` builds
    the cost tensors (demands, avail, totals) as bfloat16, cast on the
    host so the transfer moves 2 bytes an element
    (`MatchConfig.quantized`; parity guarded by the QualityMonitor
    demotion ladder)."""
    from cook_tpu_torch.scheduler.device_state import quantized_dtype

    dtype = quantized_dtype() if quantized else torch.float32
    j, n = len(jobs), nodes.n
    pad_j, pad_n = padded_shape(j, n, chunk)
    demands, avail, totals = encode_problem_arrays(jobs, nodes.offers,
                                                   config)
    if padded_feasible is not None:
        feas = padded_feasible
    else:
        feas = np.zeros((pad_j, pad_n), dtype=bool)
        feas[:j, :n] = feasible
    # data-plane accounting: the padded host arrays are what cross to the
    # device, split by tensor family; the padded-vs-valid cell ratio is
    # the bucket waste
    data_plane.note_padding("match", (pad_j, pad_n), valid_cells=j * n,
                            padded_cells=pad_j * pad_n)

    def put(arr, fam=data_plane.FAM_NODE_ENCODE):
        return data_plane.h2d(arr, family=fam, device=device)

    return MatchProblem(
        demands=put(host_cast(pad_to(demands, pad_j), dtype)),
        job_valid=put(pad_to(np.ones(j, dtype=bool), pad_j, fill=False)),
        avail=put(host_cast(pad_to(avail, pad_n), dtype)),
        totals=put(host_cast(pad_to(totals, pad_n), dtype)),
        node_valid=put(pad_to(np.ones(n, dtype=bool), pad_n, fill=False)),
        feasible=put(feas, data_plane.FAM_FEASIBILITY),
    )


def problem_shape(problem: MatchProblem) -> tuple[int, int]:
    """(padded jobs, padded nodes) of the solve."""
    return (int(problem.demands.shape[0]), int(problem.avail.shape[0]))


def solve_backend(config: MatchConfig) -> str:
    """The backend label telemetry and records report for a solve under
    this config: the candidate-pass backend for the chunked matcher,
    "exact" for the chunk=0 sequential greedy."""
    return config.backend if config.chunk else "exact"


def hierarchical_enabled(config: MatchConfig,
                         problem: MatchProblem) -> bool:
    """Automatic two-level path: padded jobs x nodes at/over the
    configured threshold (0 = never)."""
    if config.hierarchical_threshold <= 0:
        return False
    j, n = problem_shape(problem)
    return j * n >= config.hierarchical_threshold


def gang_context(
    considerable: Sequence[Job], config: MatchConfig,
) -> tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """(gang_id [J] int32, gang_need [J] int32) for this cycle's
    considerable window, or (None, None) when no gang rows are present.
    gang_id is a dense per-cycle index over the distinct gang groups, in
    the order they first appear in the window; members outside the window
    do not appear, so an under-represented gang strips at the chokepoint
    (members-missing) instead of partially placing."""
    if not config.gang_enabled:
        return None, None
    ids: dict[str, int] = {}
    gang_id = np.full(len(considerable), -1, dtype=np.int32)
    gang_need = np.zeros(len(considerable), dtype=np.int32)
    for ji, job in enumerate(considerable):
        if job.gang_size >= 2 and job.group_uuid:
            gang_id[ji] = ids.setdefault(job.group_uuid, len(ids))
            gang_need[ji] = job.gang_size
    if not ids:
        return None, None
    return gang_id, gang_need


def topology_block_width(config: MatchConfig, n_nodes: int) -> int:
    """Block width (hosts) of the topology: the explicit override, else
    the hierarchical decomposition's tuned bucket, so that "one block"
    means the same to the distance term, the gang block rule, the fairness
    ledger and gang admission."""
    if config.topology_block_hosts:
        return config.topology_block_hosts
    from cook_tpu_torch.ops.hierarchical import choose_nodes_per_block

    return choose_nodes_per_block(max(n_nodes, 1))


def topology_bonus(nodes: EncodedNodes,
                   config: MatchConfig) -> Optional[np.ndarray]:
    """Per-node additive score bonus [N] float32 (None when disabled):
    topology_weight x the node's block memory utilization, so warmer
    blocks attract placements and whole blocks stay free for gangs."""
    if config.topology_weight <= 0 or nodes.n == 0:
        return None
    npb = topology_block_width(config, nodes.n)
    avail_mem = np.array([o.mem for o in nodes.offers], dtype=np.float32)
    total_mem = np.array([max(o.total_mem or o.mem, 1e-9)
                          for o in nodes.offers], dtype=np.float32)
    util = np.clip(1.0 - avail_mem / total_mem, 0.0, 1.0)
    bonus = np.empty(nodes.n, dtype=np.float32)
    for start in range(0, nodes.n, npb):
        seg = slice(start, min(start + npb, nodes.n))
        bonus[seg] = util[seg].mean()
    return (config.topology_weight * bonus).astype(np.float32)


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


def hier_mesh():
    """The mesh `parallel.mesh.make_mesh` set up in this process when it
    spans more than one rank, else None: on one rank the plain batched
    solve is the schedule (the reference's `len(jax.devices()) > 1`)."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.size > 1 else None


class HierarchicalPending:
    """PendingResult stand-in for a pool solved by the two-level matcher:
    the coarse/scatter/fine/refine pipeline needs host round-trips, so the
    whole solve runs at `fetch()`.  Its stats land on
    `prepared.hier_stats`."""

    __slots__ = ("prepared", "config", "telemetry")

    def __init__(self, prepared: "PreparedPool", config: MatchConfig,
                 telemetry=None):
        self.prepared = prepared
        self.config = config
        self.telemetry = telemetry

    def fetch(self) -> np.ndarray:
        from cook_tpu_torch.ops.hierarchical import hierarchical_match

        observatory = (self.telemetry.observatory
                       if self.telemetry is not None else None)
        mesh = hier_mesh() if self.config.hierarchical_use_mesh else None
        result, stats = hierarchical_match(
            self.prepared.problem,
            params=hier_params_from_config(self.config), mesh=mesh,
            gang_id=self.prepared.gang_id,
            gang_need=self.prepared.gang_need,
            observatory=observatory,
            pool=self.prepared.pool.name)
        self.prepared.hier_stats = stats
        # the two-level solve assembled this assignment on the host (its
        # passes' fetches are accounted inside it): no device fetch here
        return result.assignment[: len(self.prepared.considerable)] \
            .cpu().numpy()


def dispatch_pool_solve(prepared: "PreparedPool", config: MatchConfig,
                        telemetry=None):
    """Dispatch the pool's match kernels WITHOUT observing completion; the
    returned PendingResult's `fetch()` is the one completion observation.
    Pools at/over `hierarchical_threshold` route to the two-level matcher
    behind the same interface; otherwise `chunk` > 0 runs
    `chunked_match`, else the exact `greedy_match`.  The `device.solve`
    fault point sits first: an injected error raises here, as a kernel
    raising at dispatch would."""
    fault_schedule = faults.ACTIVE  # snapshot: a concurrent disarm must
    if fault_schedule is not None:  # not None out the global mid-site
        fault_schedule.hit(faults.DEVICE_SOLVE, pool=prepared.pool.name)
    if hierarchical_enabled(config, prepared.problem):
        return HierarchicalPending(prepared, config, telemetry)
    if config.chunk:
        result = chunked_match(prepared.problem, chunk=config.chunk,
                               rounds=config.chunk_rounds,
                               passes=config.chunk_passes,
                               kc=config.chunk_kc,
                               **backend_flags(config.backend))
    else:
        result = greedy_match(prepared.problem)
    return PendingResult(result.assignment[: len(prepared.considerable)])


# the cause a failed solve notes on the `device-degraded` verdict (the
# reference's cause when a solve raises: matcher.enter_device_fallback)
SOLVE_ERROR = "solve-error"


def note_solve_failed(telemetry, pool_name: str) -> None:
    """A device solve of the pool raised: health reads `device-degraded`
    with the pool's evidence until `note_solve_ok`.  Nothing is re-solved
    on the CPU; the caller re-raises (serial and batched passes) or skips
    the pool's jobs (the pipelined pass)."""
    if telemetry is not None:
        telemetry.note_device_fallback(pool_name, SOLVE_ERROR)


@contextlib.contextmanager
def noting_solve_failures(telemetry, pool_names):
    """The block solves these pools on the card: if it raises, each pool's
    failure is noted (`note_solve_failed`) and the error propagates."""
    try:
        yield
    except Exception:
        for name in pool_names:
            note_solve_failed(telemetry, name)
        raise


def note_solve_ok(telemetry, pool_name: str) -> None:
    """A device solve of the pool succeeded: clear its `device-degraded`
    verdict, if a failed solve set one."""
    if telemetry is not None and pool_name in telemetry.device_fallbacks():
        telemetry.clear_device_fallback(pool_name)


def record_solve_outcome(prepared: "PreparedPool", assignment: np.ndarray,
                         config: MatchConfig, state: PoolMatchState,
                         pool_name: str, solve_s: float, flight, telemetry,
                         *, overlapped: bool = False) -> None:
    """The post-solve protocol shared by the serial, pool-batched
    (hierarchical lanes) and pipelined paths (reference
    `record_solve_outcome`, all but its roofline probe): compile and
    latency telemetry, quality sampling, the cycle record's solve identity
    and hierarchical accounting, and the periodic exact-kernel quality
    audit of a chunked flat solve (`note_chunked_solve`).  `solve_s` ends
    in the device-to-host copy of the assignment.  `overlapped=True` for
    walls measured under overlap (the pipelined pass: they span neighbour
    pools' host work and must not feed any latency surface — see
    DeviceTelemetry.record_match_solve)."""
    shape = problem_shape(prepared.problem)
    backend = solve_backend(config)
    hier = prepared.hier_stats
    if hier is not None:
        # two-level solve: the record's backend names the decomposition
        backend = f"hier-{hier['backend']}"
    compiled = False
    if telemetry is not None:
        compiled = telemetry.record_match_solve(pool_name, shape, backend,
                                                solve_s,
                                                overlapped=overlapped)
        telemetry.quality.observe_cycle(prepared, assignment, pool_name)
    flight.note_solve(shape_signature(shape), backend, compiled)
    if hier is not None:
        flight.note_hierarchical(hier)
        # no audit of a two-level solve: it would replay the FULL flat
        # problem through the exact greedy, the solve the decomposition
        # exists to avoid (the reference skips it too)
        return
    note_chunked_solve(prepared, assignment, config, state, pool_name)


def note_chunked_solve(prepared: "PreparedPool", assignment: np.ndarray,
                       config: MatchConfig, state: PoolMatchState,
                       pool_name: str) -> None:
    """Count a pool's chunked flat solve and start the quality audit on
    every `quality_audit_every`-th."""
    if not config.chunk:
        return
    state.chunked_solves += 1
    if (config.quality_audit_every
            and state.chunked_solves % config.quality_audit_every == 0):
        start_quality_audit(prepared, assignment, pool_name)


_audit_lock = threading.Lock()
last_audit_thread: Optional[threading.Thread] = None  # tests join this


def start_quality_audit(prepared: "PreparedPool", assignment: np.ndarray,
                        pool_name: str) -> None:
    """Run `audit_match_quality` on a daemon thread.

    The exact replay is a Python loop of one step per considered job, so
    it must not stall the cycle's launches.  Single-flight: while one
    audit runs, due samples are skipped rather than queued.  The problem's
    tensors are cloned on their device first, in stream order: a resident
    mirror may rewrite its buffers in place next cycle, while the thread
    still reads them."""
    global last_audit_thread
    if not _audit_lock.acquire(blocking=False):
        return
    try:
        problem = prepared.problem
        if problem.demands.device.type != "cpu":
            problem = MatchProblem(*(None if t is None else t.clone()
                                     for t in problem))
        n_consider = len(prepared.considerable)

        def run():
            try:
                audit_match_quality(problem, n_consider, assignment,
                                    pool_name)
            except Exception:  # noqa: BLE001 — an audit failure must
                # never take the scheduler down; it only observes
                log.exception("match quality audit failed (pool %s)",
                              pool_name)
            finally:
                _audit_lock.release()

        t = threading.Thread(target=run, name=f"match-audit-{pool_name}",
                             daemon=True)
        last_audit_thread = t
        t.start()
    except Exception:  # noqa: BLE001 — the thread never started, so its
        # finally cannot release the lock: release it here
        _audit_lock.release()
        raise


def audit_match_quality(problem: MatchProblem, n_consider: int,
                        assignment: np.ndarray, pool_name: str) -> float:
    """Replay a chunked solve's problem through the plain exact greedy on
    CPU copies of its tensors and gauge the packing ratio (placed demand
    weight, approximate / exact) on `match.quality_audit`.  Its transfers
    are counted under the `fallback` family as the reference counts its
    audit: the put of the whole problem onto the host, and the fetches of
    the exact assignment and the demands.  Returns the ratio (1.0, and
    the gauge left alone, when the exact greedy places nothing: a
    degenerate problem is no evidence of parity)."""
    host = MatchProblem(*(None if t is None else t.to("cpu")
                          for t in problem))
    data_plane.note_h2d(sum(t.numel() * t.element_size() for t in problem
                            if t is not None),
                        family=data_plane.FAM_FALLBACK)
    exact = greedy_match(host).assignment[:n_consider].numpy()
    data_plane.note_d2h(exact.nbytes, family=data_plane.FAM_FALLBACK)
    demands = host.demands[:n_consider].float().numpy()
    data_plane.note_d2h(demands.nbytes, family=data_plane.FAM_FALLBACK)
    # weight = mem + cpus + gpus, each normalized by the problem's mean
    # demand so no resource dominates
    scale = np.maximum(demands.mean(axis=0), 1e-9)
    weights = (demands[:, :3] / scale[:3]).sum(axis=-1)
    approx_w = float(weights[assignment >= 0].sum())
    exact_w = float(weights[exact >= 0].sum())
    if exact_w <= 0:
        log.info("match quality audit: pool %s exact kernel placed zero "
                 "weight; skipping gauge update", pool_name)
        return 1.0
    ratio = approx_w / exact_w
    global_registry.gauge(
        "match.quality_audit",
        "packing parity of the chunked solve vs the exact kernel",
    ).set(ratio, labels={"pool": pool_name})
    if ratio < 0.99:
        log.warning(
            "match quality audit: pool %s chunked solve placed %.4f of "
            "the exact kernel's demand weight (< 0.99): the matcher "
            "config underperforms on this workload", pool_name, ratio)
    return ratio


def record_considered(flight, queue, considerable, offers_count: int) -> None:
    """Cycle-record bookkeeping for a selected considerable window: the
    counts, the rank context (attached by reference: rank_cycle replaces,
    never mutates) and the not-considered index, skipped entirely when no
    recorder is attached (it is O(queue) work on the match path)."""
    flight.set_counts(offers=offers_count, queue_len=len(queue.jobs),
                      considered=len(considerable))
    flight.set_rank_context(queue.jobs, queue.dru)
    if flight is not NULL_CYCLE and len(considerable) < len(queue.jobs):
        # jobs in the ranked queue but outside this cycle's considerable
        # window (cap, quota, launch filter, dead-in-queue)
        selected = {j.uuid for j in considerable}
        for job in queue.jobs:
            if job.uuid not in selected:
                flight.note_not_considered(job.uuid)


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


# reasons of an instance that died with its host (agent-removed analogs):
# their runtimes feed the estimated-completion constraint
AGENT_REMOVED_CODES = frozenset(
    REASONS_BY_NAME[name].code
    for name in ("node-removed", "could-not-reconstruct-state")
    if name in REASONS_BY_NAME
)


def estimated_end_times(store: JobStore, jobs: Sequence[Job],
                        config: MatchConfig,
                        predictor=None) -> Optional[np.ndarray]:
    """Per-job estimated completion time in epoch ms, -1 = no estimate
    (build-estimated-completion-constraint, constraints.clj:410-432):
    max of scaled expected runtime and the runtimes of instances that
    died with the host, capped at host-lifetime - grace so a
    full-lifetime job can still start on a fresh host.  `predictor`
    (scheduler/prediction.py) supplies an observed-runtime estimate for
    jobs that declared no expected_runtime_ms.  None while the
    constraint is off."""
    if not (config.completion_multiplier > 0
            and config.host_lifetime_mins > 0):
        return None
    now_ms = store.clock()
    cap_ms = (config.host_lifetime_mins
              - config.agent_start_grace_mins) * 60_000.0
    out = np.full(len(jobs), -1.0)
    for ji, job in enumerate(jobs):
        runtime = job.expected_runtime_ms
        if not runtime and predictor is not None:
            runtime = predictor.predict_runtime_ms(job.user,
                                                   job.command) or 0.0
        expected = (runtime * config.completion_multiplier
                    if runtime else 0.0)
        for inst in store.job_instances(job.uuid):
            if (inst.status.terminal
                    and inst.reason_code in AGENT_REMOVED_CODES
                    and inst.end_time_ms > inst.start_time_ms):
                expected = max(expected,
                               inst.end_time_ms - inst.start_time_ms)
        if expected > 0:
            out[ji] = now_ms + min(expected, cap_ms)
    return out


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
    # gang rows of the considerable window (gang_context), None when the
    # cycle has no gangs: the hierarchical solve routes by them, and the
    # finalize chokepoint enforces all-or-nothing on every path with them
    gang_id: Optional[np.ndarray] = None
    gang_need: Optional[np.ndarray] = None
    # clusters withheld from this cycle because their circuit breaker is
    # open (faults/breaker.py): offer-less pools report
    # `cluster-circuit-open` instead of a misleading `no-offers`
    circuit_open: list = field(default_factory=list)

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
    flight=NULL_CYCLE,
    encode_cache=None,
    predictor=None,
    device_state=None,
) -> PreparedPool:
    """Gather offers + considerable jobs and encode the tensor problem.
    `host_reservations` (hostname -> reserving job uuid, set by the
    rebalancer) closes each reserved host to every other job.  With the
    estimated-completion constraint on (`MatchConfig.completion_multiplier`
    and `host_lifetime_mins`), each job's estimated end
    (`estimated_end_times`, the `predictor` filling in jobs that declared
    no runtime) closes the hosts that die before it.

    With `encode_cache` (scheduler/encode_cache.py) the node encoding and
    per-job feasibility rows are incremental: an unchanged pool re-encodes
    O(delta) rows instead of O(J x N).  The cache serves a fresh mask, so
    the reservation closure below narrows this cycle's rows only.  The
    cache is bypassed while the estimated-completion constraint is active
    (rows become clock-dependent).

    With `device_state` (scheduler/device_state.py) AND
    `config.device_residency`, the problem comes from the pool's resident
    mirror: unchanged rows move zero bytes.  The mirror needs the cache's
    per-row serve report, so it is bypassed without a cache (or with the
    cache bypassed), and on a cycle with host reservations (they narrow
    rows for this cycle only).
    Either build takes the mask the cache padded (for the mirror, with
    one more row: the mirror's buffer layout), so no second padded copy
    is made.  `device_state` also carries the quantization
    guard: `quantized_for` decides the cost tensors' dtype on either
    path."""
    prepared = PreparedPool(pool=pool, outcome=MatchOutcome())

    # offers from every running cluster (scheduler.clj:1574-1585); an
    # offer RPC raising skips that cluster for this scan
    for cluster in clusters:
        if not cluster.accepts_work:
            # classify by the non-mutating state read: a second
            # allows_work() here could consume the open->half-open
            # transition (and the probe slot) outside any launch flow
            if cluster.state == ClusterState.RUNNING \
                    and cluster.breaker.state is not BreakerState.CLOSED:
                prepared.circuit_open.append(cluster.name)
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
    record_considered(flight, queue, considerable,
                      len(prepared.cluster_offers))
    prepared.gang_id, prepared.gang_need = gang_context(considerable,
                                                        config)
    if not considerable or not prepared.cluster_offers:
        return prepared

    est_end_ms = estimated_end_times(store, considerable, config,
                                     predictor=predictor)
    use_cache = encode_cache is not None and est_end_ms is None
    if use_cache:
        nodes, nodes_fp = encode_cache.encoded_nodes(
            pool.name, prepared.cluster_offers)
    else:
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
    offer_locations = [c.location for c, _ in prepared.cluster_offers]
    use_mirror = (use_cache and device_state is not None
                  and config.device_residency and not host_reservations)
    served: Optional[dict] = {} if use_mirror else None

    def compute_rows(subset, pre_rows, est_end=None):
        return feasibility_mask(
            subset,
            nodes,
            previous_hosts=previous_failed_hosts(store, subset),
            group_used_hosts=prepared.group_used_hosts,
            group_attr_value=prepared.group_attr_value,
            group_balance_counts=prepared.group_balance_counts,
            groups=prepared.groups,
            offer_locations=offer_locations,
            job_est_end_ms=est_end,
            host_lifetime_mins=config.host_lifetime_mins,
            balanced_pre_rows=pre_rows,
        )

    padded = None
    if use_cache:
        pad_shape = padded_shape(len(considerable), nodes.n, config.chunk)
        if use_mirror:
            # the mirror's row layout: one more row, its all-zero pad row
            pad_shape = (pad_shape[0] + 1, pad_shape[1])
        padded = encode_cache.feasibility(
            pool.name, considerable, nodes.n, nodes_fp, compute_rows,
            balanced_pre_rows=prepared.balanced_pre_rows,
            pad_shape=pad_shape, served=served)
        feasible = padded[:len(considerable), :nodes.n]
    else:
        feasible = compute_rows(considerable, prepared.balanced_pre_rows,
                                est_end_ms)
        # cache off or bypassed (the estimated-completion constraint made
        # rows clock-dependent): every encode row was freshly computed, so
        # the residency ledger reports a full rebuild (the cache path's
        # notes come from EncodeCache itself)
        data_plane.note_residency(len(considerable) * nodes.n, 0)
        data_plane.note_residency(data_plane.NODE_ROW_BYTES * nodes.n, 0,
                                  kind="nodes")
    if host_reservations:
        # rebalancer reservations (constraints.clj:242 + reserve-hosts!,
        # rebalancer.clj:419): a reserved host only accepts its reserving
        # job
        reserved_for = np.array(
            [host_reservations.get(o.hostname, "") for o in nodes.offers]
        )
        has_reservation = reserved_for != ""
        for ji, job in enumerate(considerable):
            allowed = ~has_reservation | (reserved_for == job.uuid)
            if job.group_uuid:
                # gang admission reserves hosts under a group-wide tag any
                # member may claim (scheduler/gang.py)
                allowed |= reserved_for == ("gang:" + job.group_uuid)
            feasible[ji] &= allowed
            # the saved pre-closure rows must honor reservations too, or
            # the balanced top-up could steal a reserved host
            if ji in prepared.balanced_pre_rows:
                prepared.balanced_pre_rows[ji] &= allowed
    prepared.feasible = feasible
    if use_mirror:
        # device-resident path: unchanged rows move zero bytes; the
        # mirror's problem is shape- and content-identical to the classic
        # build below (padded_job_axis is shared)
        prepared.problem = device_state.build_problem(
            pool.name, considerable, nodes, feasible, nodes_fp, served,
            config, flight=flight, padded_feasible=padded)
    else:
        quantized = (device_state.quantized_for(config, pool.name)
                     if device_state is not None else config.quantized)
        prepared.problem = build_match_problem(
            considerable, nodes, feasible, device=device,
            chunk=config.chunk, config=config, padded_feasible=padded,
            quantized=quantized)
    bonus = topology_bonus(nodes, config)
    if bonus is not None:
        # the topology distance term rides every build path (classic,
        # quantized, device-resident) as a post-assembly field: [N]
        # floats are negligible next to the [J, N] mask, so residency
        # doesn't mirror them; padded to the node axis
        pad_n = int(prepared.problem.avail.shape[0])
        prepared.problem = prepared.problem._replace(
            node_bonus=data_plane.h2d(pad_to(bonus, pad_n),
                                      family=data_plane.FAM_NODE_ENCODE,
                                      device=device))
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
    flight=NULL_CYCLE,
    async_launch: bool = False,
    launch_failure_cb: Optional[Callable] = None,
) -> MatchOutcome:
    """Apply a solved assignment: group validation, launch transactions,
    backend launches, autoscaling, head-of-queue backoff; every job's
    outcome lands in the cycle record (`flight`) with its reason code.

    `async_launch` moves each cluster's backend launch onto that
    cluster's bounded launch executor (ComputeCluster.launch_tasks_async)
    so RPC latency leaves the cycle's critical path; failures flow
    through `launch_failure_cb(specs, exc)` (default: the same
    fail_launched_specs flow-back the synchronous path uses)."""
    outcome = prepared.outcome
    considerable = prepared.considerable
    pool = prepared.pool
    if not prepared.solvable:
        outcome.unmatched = considerable
        outcome.head_matched = not considerable
        if not prepared.cluster_offers:
            # "no capacity" and "capacity behind an open breaker" are
            # different stories for an operator
            code = (flight_codes.CLUSTER_CIRCUIT_OPEN
                    if prepared.circuit_open else flight_codes.NO_OFFERS)
        else:
            code = flight_codes.CONSTRAINTS_FILTERED
        for job in considerable:
            flight.note_skip(job.uuid, code)
        if prepared.gang_id is not None:
            n_gangs = int(np.unique(
                prepared.gang_id[prepared.gang_id >= 0]).size)
            flight.note_gang(considered=n_gangs, placed=0, blocked=n_gangs,
                             reasons={code: n_gangs})
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
        # post-cycle counts (intra-cycle leveling re-opens values); the
        # rows are the problem's values (bfloat16-rounded under
        # MatchConfig.quantized, as the reference reads them back from the
        # device tensors) in float32
        demands, remaining, totals = (
            _problem_values(a, prepared.problem.demands.dtype)
            for a in encode_problem_arrays(considerable, nodes.offers,
                                           config))
        placed_mask = assignment >= 0
        np.subtract.at(remaining, assignment[placed_mask],
                       demands[placed_mask])
        assignment = balanced_group_topup(
            considerable, assignment, nodes, prepared.groups,
            live_balance_counts, prepared.balanced_pre_rows,
            remaining, demands, totals=totals)

    gang_details: dict[int, str] = {}
    gang_note = None
    if prepared.gang_id is not None:
        t_gang = time.perf_counter()
        assignment, gang_details, gang_note = _gang_chokepoint(
            prepared, assignment, config)
        outcome.phase_wall_s["gang"] = time.perf_counter() - t_gang

    # transact + launch (scheduler.clj:790-1048)
    launches_per_cluster: dict[str, list[TaskSpec]] = {}
    cluster_by_name = {}
    # per-cluster launch budgets this cycle (max-launchable,
    # scheduler.clj:887)
    cluster_budget: dict[str, int] = {}
    # ports handed out this cycle, per node (the mask guaranteed counts
    # against the offer; concrete picks must not collide intra-cycle)
    ports_used: dict[int, set] = {}

    def fail(job: Job, code: str, detail: str = "",
             text_detail: bool = True) -> None:
        """An unplaced job: unmatched, its skip in the cycle record, and
        the operator-facing text (with the detail unless the reference
        words it bare)."""
        outcome.unmatched.append(job)
        flight.note_skip(job.uuid, code, detail)
        if record_placement_failure is not None:
            text = flight_codes.REASON_TEXT[code]
            if detail and text_detail:
                text += f" ({detail})"
            record_placement_failure(job, text)

    # gang-atomic transact: a gang's specs and launch bookkeeping defer
    # into gang_txn until its LAST member transacts; a member failing any
    # transact step (launch cap, ports, veto) rolls the siblings already
    # transacted back (mea-culpa launch-failed, budget and ports refunded),
    # so the all-or-nothing property survives the launch pipeline too
    gang_txn: dict[int, dict] = {}
    failed_gangs: set[int] = set()

    def gang_of(ji: int) -> int:
        return (int(prepared.gang_id[ji])
                if prepared.gang_id is not None else -1)

    def abort_gang(g: int, cause: str) -> None:
        failed_gangs.add(g)
        txn = gang_txn.pop(g, None)
        if txn is None:
            return
        for task_id in txn["task_ids"]:
            try:
                store.update_instance_state(
                    task_id, InstanceStatus.FAILED, "launch-failed")
            except Exception:  # noqa: BLE001 — one stuck rollback must
                # not strand the rest of the gang's members
                log.exception("gang rollback transition for %s did not "
                              "apply", task_id)
        for cname, cnt in txn["budget"].items():
            if cname in cluster_budget:
                cluster_budget[cname] += cnt
        for node_i, tports in txn["ports"]:
            ports_used.get(node_i, set()).difference_update(tports)
        detail = f"gang member failed to transact ({cause})"
        for member in txn["jobs"]:
            fail(member, flight_codes.GANG_INCOMPLETE, detail)

    for ji, job in enumerate(considerable):
        node_idx = int(assignment[ji])
        g = gang_of(ji)
        if g >= 0 and g in failed_gangs:
            # a sibling already failed this cycle's transact: hold this
            # member back too (all-or-nothing)
            fail(job, flight_codes.GANG_INCOMPLETE, gang_details.get(g, ""),
                 text_detail=False)
            continue
        if node_idx < 0:
            if g >= 0:
                fail(job, flight_codes.GANG_INCOMPLETE,
                     gang_details.get(g, ""))
                continue
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
            fail(job, flight_codes.LAUNCH_CAP)
            if g >= 0:
                abort_gang(g, flight_codes.LAUNCH_CAP)
            continue
        task_ports = assign_ports(offer,
                                  ports_used.setdefault(node_idx, set()),
                                  job.resources.ports)
        if task_ports is None:
            fail(job, flight_codes.PORTS_EXHAUSTED)
            if g >= 0:
                abort_gang(g, flight_codes.PORTS_EXHAUSTED)
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
            flight.note_skip(job.uuid, flight_codes.LAUNCH_VETOED)
            if g >= 0:
                abort_gang(g, flight_codes.LAUNCH_VETOED)
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
        if g >= 0:
            # defer the member: its spec joins the launch batch only once
            # every sibling has transacted too
            txn = gang_txn.setdefault(
                g, {"specs": [], "jobs": [], "offers": [], "task_ids": [],
                    "budget": {}, "ports": []})
            txn["specs"].append((cluster.name, spec))
            txn["jobs"].append(job)
            txn["offers"].append(offer)
            txn["task_ids"].append(task_id)
            txn["budget"][cluster.name] = (
                txn["budget"].get(cluster.name, 0) + 1)
            txn["ports"].append((node_idx, set(task_ports)))
            continue
        launches_per_cluster.setdefault(cluster.name, []).append(spec)
        outcome.matched.append((job, offer))
        outcome.launched_task_ids.append(task_id)
        flight.note_match(job.uuid, offer.hostname, task_id)

    # flush gangs whose every member transacted: their specs join the
    # launch batches only now, so a late member's transact failure cannot
    # have left siblings half-launched.  (Launch-RPC failures after this
    # point re-queue mea-culpa through fail_launched_specs like any job.)
    for g in sorted(gang_txn):
        txn = gang_txn[g]
        for (cname, spec), job, offer, task_id in zip(
                txn["specs"], txn["jobs"], txn["offers"], txn["task_ids"]):
            launches_per_cluster.setdefault(cname, []).append(spec)
            outcome.matched.append((job, offer))
            outcome.launched_task_ids.append(task_id)
            flight.note_match(job.uuid, offer.hostname, task_id)

    if gang_note is not None:
        considered_n, placed_gangs, block_reasons = gang_note
        if failed_gangs:
            placed_gangs -= len(failed_gangs)
            block_reasons["transact-failed"] = len(failed_gangs)
        flight.note_gang(considered=considered_n, placed=placed_gangs,
                         blocked=considered_n - placed_gangs,
                         reasons=block_reasons)
        _note_gang_metrics(pool.name, considered_n, placed_gangs,
                           block_reasons)

    if launch_failure_cb is None:
        # the synchronous default may write the builder (same thread); an
        # async default must not — the callback runs on the cluster's
        # launch-worker thread, and CycleBuilder is single-threaded by
        # construction (the pipelined pass supplies a recorder-locked
        # callback instead)
        sync_note = (None if async_launch
                     else lambda uuid, detail: flight.note_skip(
                         uuid, flight_codes.LAUNCH_FAILED, detail))

        def launch_failure_cb(specs, exc):
            fail_launched_specs(store, specs, exc, note_reason=sync_note)

    for cname, specs in launches_per_cluster.items():
        cluster = cluster_by_name[cname]
        limiter = getattr(cluster, "launch_rate_limiter", None)
        if limiter is not None:
            # spend-through: charge the work that is about to happen
            limiter.spend(cname, float(len(specs)))
        if async_launch:
            # the worker holds the kill-lock read side itself; failures
            # arrive on the worker thread via the callback
            cluster.launch_tasks_async(
                pool.name, specs,
                done_cb=lambda sp, exc, _cb=launch_failure_cb:
                    _cb(sp, exc) if exc is not None else None)
            continue
        try:
            # read side of the kill-lock: kills can't interleave mid-launch
            with cluster.kill_lock.read():
                cluster.run_launch(pool.name, specs)
        except Exception as exc:  # noqa: BLE001 — one cluster's RPC
            # failure must not abort the remaining clusters' launches
            log.exception("launch_tasks failed (cluster %s, pool %s, "
                          "%d specs); failing its specs and continuing",
                          cname, pool.name, len(specs))
            launch_failure_cb(specs, exc)

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


def _problem_values(arr: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """float32 host rows as the solve saw them: rounded through `dtype`
    (bfloat16 under MatchConfig.quantized) and back to float32."""
    if dtype == torch.float32:
        return arr
    return host_cast(arr, dtype).float().numpy()


def _gang_chokepoint(prepared: PreparedPool, assignment: np.ndarray,
                     config: MatchConfig):
    """The gang all-or-nothing chokepoint every solve path funnels
    through (reference `finalize_pool_match`, matcher.py:1260-1336):
    repair each broken gang once (whole, on distinct feasible hosts of one
    block), strip what is still partial, then hand the hosts a stripped
    gang freed to waiting ungrouped rows (greedy first-fit in schedule
    order).  Flat solves carry no block structure: they enforce
    whole-pool all-or-nothing and distinct hosts unless
    `topology_block_hosts` declares the blocks.  Returns (assignment,
    {gang: detail} of the gangs held back, (considered, placed,
    {blocking reason: gangs}))."""
    considerable = prepared.considerable
    nodes = prepared.nodes
    feasible = prepared.feasible
    gid, gneed = prepared.gang_id, prepared.gang_need
    npb_eff = int((prepared.hier_stats or {}).get("nodes_per_block", 0))
    if npb_eff == 0 and config.topology_block_hosts:
        # flat solve but the operator declared the topology: the explicit
        # block width binds the one-block rule here too
        npb_eff = int(config.topology_block_hosts)
    demands_np, avail_np, _ = encode_problem_arrays(
        considerable, nodes.offers, config)
    # repair before judging: the flat kernels best-fit gang members onto
    # one host (UNIQUE validation just stripped the duplicates)
    assignment = np_gang_repair(assignment, gid, gneed, demands_np,
                                avail_np, feasible, npb_eff)
    assignment, _ = np_gang_filter(assignment, gid, gneed, npb_eff)
    # capacity left after the strip: what the repair saw, so the details
    # report the real blocker, and the scalar top-up reuses freed hosts
    remaining_np = avail_np.copy()
    placed_rows = np.flatnonzero(assignment >= 0)
    np.subtract.at(remaining_np, assignment[placed_rows],
                   demands_np[placed_rows])
    details: dict[int, str] = {}
    block_reasons: dict[str, int] = {}
    placed_gangs = 0
    gang_ids = np.unique(gid[gid >= 0])
    for g in gang_ids:
        rows = np.flatnonzero(gid == g)
        if bool((assignment[rows] >= 0).all()):
            placed_gangs += 1
            continue
        k = int(gneed[rows].max())
        if len(rows) < k:
            details[int(g)] = (f"only {len(rows)}/{k} members in this "
                               "cycle's considerable window")
            reason = "members-missing"
        else:
            member_demand = demands_np[rows].max(axis=0)
            free = np_block_free_hosts(
                remaining_np, feasible[rows].all(axis=0), member_demand,
                npb_eff if npb_eff > 0 else nodes.n)
            best = int(free.max(initial=0))
            details[int(g)] = f"best block had {min(best, k)}/{k} hosts free"
            reason = "no-block-capacity"
        block_reasons[reason] = block_reasons.get(reason, 0) + 1
    # scalar top-up: grouped jobs sit out, their placement rules already
    # ran upstream
    for ji in np.flatnonzero(assignment < 0):
        ji = int(ji)
        if gid[ji] >= 0 or considerable[ji].group_uuid:
            continue
        fits = feasible[ji] & (remaining_np >= demands_np[ji]).all(axis=1)
        cands = np.flatnonzero(fits)
        if cands.size:
            node = int(cands[0])
            assignment[ji] = node
            remaining_np[node] -= demands_np[ji]
    return assignment, details, (int(gang_ids.size), placed_gangs,
                                 block_reasons)


_gang_metrics = None


def _note_gang_metrics(pool_name: str, considered: int, placed: int,
                       reasons: dict) -> None:
    """Per-cycle gang placement counters (the `gang.*` metric family):
    considered/placed per pool, blocked per pool and reason
    (members-missing, no-block-capacity, transact-failed)."""
    global _gang_metrics
    if _gang_metrics is None:
        _gang_metrics = {
            "considered": global_registry.counter(
                "gang.considered",
                "gangs seen by a pool's match cycle, per pool"),
            "placed": global_registry.counter(
                "gang.placed",
                "gangs whose every member placed and transacted whole "
                "(one topology block, distinct hosts), per pool"),
            "blocked": global_registry.counter(
                "gang.blocked",
                "gangs held back whole (gang-incomplete), per pool and "
                "blocking reason"),
        }
    if considered:
        _gang_metrics["considered"].inc(considered, {"pool": pool_name})
    if placed:
        _gang_metrics["placed"].inc(placed, {"pool": pool_name})
    for reason, n in (reasons or {}).items():
        if n:
            _gang_metrics["blocked"].inc(n, {"pool": pool_name,
                                             "reason": reason})


def fail_launched_specs(store: JobStore, specs: Sequence[TaskSpec],
                        exc: BaseException,
                        note_reason: Optional[Callable[[str, str], None]]
                        = None) -> None:
    """Launch-failure flow-back: each spec's already-transacted instance
    transitions to failed with the mea-culpa `launch-failed` reason (the
    job re-queues without consuming its retry budget).
    `note_reason(job_uuid, detail)` threads the outcome into the cycle
    record."""
    detail = f"{type(exc).__name__}: {exc}"
    for spec in specs:
        try:
            store.update_instance_state(spec.task_id, InstanceStatus.FAILED,
                                        "launch-failed")
        except Exception:  # noqa: BLE001 — one bad transition must not
            # strand the rest of the batch in limbo
            log.exception("launch-failed transition for %s did not apply "
                          "(%s)", spec.task_id, exc)
        if note_reason is not None:
            note_reason(spec.job_uuid, detail)


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
    flight=NULL_CYCLE,
    telemetry=None,
    encode_cache=None,
    predictor=None,
    device_state=None,
) -> MatchOutcome:
    """One pool's match cycle end to end (prepare -> solve -> finalize).
    A solve error propagates: there is no CPU re-solve behind the card.

    Each section runs in the cycle's data-plane scope and is a phase of
    the cycle record: `tensor_build`, `solve` (a device phase: its block
    ends in the device-to-host copy of the assignment, which waits for the
    card) and `launch`.  `outcome.phase_wall_s` carries the same walls
    under the simulator's names (encode / solve / launch)."""
    t0 = time.perf_counter()
    with data_plane.activate(flight.dp), flight.phase("tensor_build"):
        prepared = prepare_pool_problem(
            store, pool, queue, clusters, config, state, device=device,
            launch_filter=launch_filter, host_reservations=host_reservations,
            host_attrs=host_attrs, flight=flight, encode_cache=encode_cache,
            predictor=predictor, device_state=device_state)
    t1 = time.perf_counter()
    solve_s = 0.0
    assignment = np.empty(0, dtype=np.int32)
    if prepared.solvable:
        with noting_solve_failures(telemetry, [pool.name]), \
                data_plane.activate(flight.dp), \
                data_plane.family(data_plane.FAM_SOLVE), \
                flight.phase("solve", device=True):
            assignment = dispatch_pool_solve(prepared, config,
                                             telemetry).fetch()
        solve_s = time.perf_counter() - t1
        record_solve_outcome(prepared, assignment, config, state,
                             pool.name, solve_s, flight, telemetry)
        note_solve_ok(telemetry, pool.name)
    t2 = time.perf_counter()
    with data_plane.activate(flight.dp), flight.phase("launch"):
        outcome = finalize_pool_match(
            store, prepared, assignment, config, state, clusters,
            make_task_id=make_task_id,
            record_placement_failure=record_placement_failure,
            flight=flight)
    # (finalize may have noted its gang chokepoint's wall, inside launch)
    outcome.phase_wall_s.update(encode=t1 - t0, solve=solve_s,
                                launch=time.perf_counter() - t2)
    hier = prepared.hier_stats
    if hier is not None:
        # the two-level solve's split of `solve`, under the names of the
        # reference's CycleRecord.hier_phases
        outcome.phase_wall_s.update(coarse_solve=hier["coarse_s"],
                                    fine_solve=hier["fine_s"],
                                    refine=hier["refine_s"])
    return outcome


def stack_pool_problems(problems: Sequence[MatchProblem],
                        lanes: Optional[slice] = None) -> MatchProblem:
    """Every pool's problem padded to shared (J, N) buckets and stacked
    on a leading pool axis: the [P, J, N] tensors are allocated once and
    each pool is copied into its corner (padding then stacking would hold
    two copies of the mask).  Padded lanes have job_valid and node_valid
    False, zero demand and zero capacity, so the solves place nothing
    there.  If any pool carries a topology node_bonus, every lane gets
    one (zeros = no preference, decision-identical to absent).  `lanes`
    stacks only those problems (a mesh rank's share), padded to the
    buckets and dtypes of them all, so that every rank's lanes agree."""
    first = problems[0]
    p = len(problems[lanes or slice(None)])
    max_j = max(q.demands.shape[0] for q in problems)
    max_n = max(q.avail.shape[0] for q in problems)
    n_res = first.demands.shape[-1]
    # the cost tensors' dtype: bfloat16 when every pool is quantized, else
    # float32 (the reference's stack promotes a mixed batch the same way)
    cost = first.demands.dtype
    for q in problems[1:]:
        cost = torch.promote_types(cost, q.demands.dtype)

    def zeros(*shape, dtype=cost):
        return torch.zeros(shape, dtype=dtype, device=first.demands.device)

    out = MatchProblem(
        demands=zeros(p, max_j, n_res),
        job_valid=zeros(p, max_j, dtype=torch.bool),
        avail=zeros(p, max_n, n_res),
        totals=zeros(p, max_n, 2),
        node_valid=zeros(p, max_n, dtype=torch.bool),
        feasible=zeros(p, max_j, max_n, dtype=torch.bool),
        node_bonus=(zeros(p, max_n, dtype=torch.float32)
                    if any(q.node_bonus is not None for q in problems)
                    else None))
    for i, q in enumerate(problems[lanes or slice(None)]):
        j, n = q.demands.shape[0], q.avail.shape[0]
        out.demands[i, :j] = q.demands
        out.job_valid[i, :j] = q.job_valid
        out.avail[i, :n] = q.avail
        out.totals[i, :n] = q.totals
        out.node_valid[i, :n] = q.node_valid
        out.feasible[i, :j, :n] = q.feasible
        if q.node_bonus is not None:
            out.node_bonus[i, :n] = q.node_bonus
    return out


def match_pools_batched(
    store: JobStore,
    pools: Sequence[Pool],
    queues: dict[str, RankedQueue],
    clusters: Sequence[ComputeCluster],
    config: MatchConfig,
    states: dict[str, PoolMatchState],
    *,
    device: torch.device,
    make_task_id: Callable[[Job], str],
    launch_filter: Optional[Callable[[Job], bool]] = None,
    record_placement_failure: Optional[Callable[[Job, str], None]] = None,
    host_reservations: Optional[dict[str, str]] = None,
    host_attrs: Optional[dict[str, dict]] = None,
    flights: Optional[dict] = None,
    telemetry=None,
    encode_cache=None,
    predictor=None,
    device_state=None,
    mesh=None,
) -> dict[str, MatchOutcome]:
    """Solve EVERY pool's match problem in one batched device call (the
    reference's `match_pools_batched`, BASELINE configuration 5: pools
    as the leading batch axis of one solve, where Cook round-robins pools
    on one thread, scheduler.clj:2508-2517).

    Every pool is prepared under its own data-plane scope and cycle
    record.  A pool at or over `hierarchical_threshold` solves alone
    through the two-level path (`HierarchicalPending`), as the serial
    path would; the flat pools are stacked (`stack_pool_problems`, its
    wall credited to each flat pool's `tensor_build`) and solved by
    `chunked_match_pools` (the backend through `vmap_safe_backend`: the
    reference's `pallas` becomes `xla` here) or, at `chunk=0`,
    `greedy_match_pools`; the shared solve runs with no data-plane scope
    (its fetch lands in the ledger totals once, never per pool).  Each
    pool then finalizes (transactions and launches) in pool order, as in
    the per-pool path.  The `device.solve` fault point is hit once per
    two-level pool before its solve and once per flat pool before the
    shared solve (one injected error fails the whole batch, as a sick
    card would), and each flat lane's chunked solve counts toward its
    pool's quality audit.  The reference's CPU-fallback tier is not
    ported: a solve error, injected or real, propagates.

    With a `mesh` (parallel/mesh.py; every rank runs this pass on the
    same store), the flat pools pad to a multiple of the mesh size with
    all-invalid lanes (`invalid_match_problem`: the solves place nothing
    there), each rank stacks only its own lanes and solves them
    (`pool_sharded_match`), and the gathered assignments reach every
    rank, which finalizes every pool as above.

    `outcome.phase_wall_s` per pool: its own encode and launch (and, for a
    two-level pool, its own solve and its split); the shared stack and
    solve are credited once, to the first flat lane's outcome, so that a
    sum over the pools counts them once."""
    flights = flights or {}
    for f in flights.values():
        if f.record is not None:
            f.record.batched = True

    def pool_flight(pool_name: str):
        return flights.get(pool_name, NULL_CYCLE)

    prepared_list = []
    walls: dict[str, dict[str, float]] = {}
    for pool in pools:
        flight = pool_flight(pool.name)
        t0 = time.perf_counter()
        # per-pool scope around the build: each pool's H2D attributes to
        # its own record
        with data_plane.activate(flight.dp), flight.phase("tensor_build"):
            prepared_list.append(prepare_pool_problem(
                store, pool, queues[pool.name], clusters, config,
                states[pool.name], device=device,
                launch_filter=launch_filter,
                host_reservations=host_reservations, host_attrs=host_attrs,
                flight=flight, encode_cache=encode_cache,
                predictor=predictor, device_state=device_state))
        walls[pool.name] = {"encode": time.perf_counter() - t0}
    solvable = [p for p in prepared_list if p.solvable]
    # a pool at/over the hierarchical threshold must not ride the flat
    # batched solve (the [J, N] wall the decomposition exists to avoid)
    hier_pools = [p for p in solvable if hierarchical_enabled(config,
                                                              p.problem)]
    flat = [p for p in solvable if p not in hier_pools]
    assignments: dict[str, np.ndarray] = {}
    fault_schedule = faults.ACTIVE  # snapshot (see dispatch_pool_solve)
    for p in hier_pools:
        name = p.pool.name
        flight = pool_flight(name)
        t_solve = time.perf_counter()
        with noting_solve_failures(telemetry, [name]):
            if fault_schedule is not None:
                fault_schedule.hit(faults.DEVICE_SOLVE, pool=name)
            with data_plane.activate(flight.dp), \
                    flight.phase("solve", device=True):
                assignments[name] = HierarchicalPending(p, config,
                                                        telemetry).fetch()
        solve_s = time.perf_counter() - t_solve
        record_solve_outcome(p, assignments[name], config, states[name],
                             name, solve_s, flight, telemetry)
        note_solve_ok(telemetry, name)
        hier = p.hier_stats
        walls[name].update(solve=solve_s, coarse_solve=hier["coarse_s"],
                           fine_solve=hier["fine_s"],
                           refine=hier["refine_s"])
    if flat:
        # one shared solve: its failure is every flat pool's
        flat_names = [p.pool.name for p in flat]
        if fault_schedule is not None:
            # rules match per participating pool; one injected error
            # fails the SHARED solve
            with noting_solve_failures(telemetry, flat_names):
                for name in flat_names:
                    fault_schedule.hit(faults.DEVICE_SOLVE, pool=name)
        t_stack = time.perf_counter()
        problems = [p.problem for p in flat]
        lanes = None
        if mesh is not None:
            # pool-axis padding, so the sharded solve engages for ANY pool
            # count: the stack pads the dead lanes to the batch's buckets
            first = problems[0]
            problems += [invalid_match_problem(
                1, 1, n_res=int(first.demands.shape[-1]),
                dtype=first.demands.dtype, device=first.demands.device)] \
                * ((-len(problems)) % mesh.size)
            lanes = mesh.lanes(len(problems))
        stacked = stack_pool_problems(problems, lanes)
        # the shared pad/stack is host work, not solve time: credit it as
        # tensor_build so device_s stays an honest accelerator figure
        stack_s = time.perf_counter() - t_stack
        for p in flat:
            pool_flight(p.pool.name).add_phase("tensor_build", stack_s)
        t_solve = time.perf_counter()
        with noting_solve_failures(telemetry, flat_names):
            if mesh is not None:
                result = pool_sharded_match(
                    mesh, shard_pools(mesh, stacked, total=len(problems)),
                    chunk=config.chunk or 0, rounds=config.chunk_rounds,
                    passes=config.chunk_passes, kc=config.chunk_kc,
                    backend=config.backend)
            elif config.chunk:
                result = chunked_match_pools(
                    stacked, chunk=config.chunk, rounds=config.chunk_rounds,
                    passes=config.chunk_passes, kc=config.chunk_kc,
                    **backend_flags(vmap_safe_backend(config.backend)))
            else:
                result = greedy_match_pools(stacked)
            with data_plane.family(data_plane.FAM_SOLVE):
                stacked_assignment = fetch_result(result.assignment)
        # one shared device call solved every flat pool: each one's record
        # carries the full solve wall (no pool's cycle can finish sooner
        # than the batch).  The recorded shape is the padded batch, the
        # device truth the compile observatory keys programs by
        solve_s = time.perf_counter() - t_solve
        batch_shape = (len(problems),) + tuple(stacked.feasible.shape[1:])
        backend = (vmap_safe_backend(config.backend) if config.chunk
                   else "exact")
        compiled = False
        if telemetry is not None:
            compiled = telemetry.record_batched_match_solve(
                [p.pool.name for p in flat], batch_shape, backend, solve_s)
        for i, p in enumerate(flat):
            name = p.pool.name
            flight = pool_flight(name)
            flight.add_phase("solve", solve_s, device=True)
            flight.note_solve(shape_signature(batch_shape), backend,
                              compiled)
            assignments[name] = stacked_assignment[i][: len(p.considerable)]
            if telemetry is not None:
                telemetry.quality.observe_cycle(p, assignments[name], name)
            note_chunked_solve(p, assignments[name], config, states[name],
                               name)
            note_solve_ok(telemetry, name)
        first = walls[flat[0].pool.name]
        first.update(encode=first["encode"] + stack_s, solve=solve_s)

    outcomes: dict[str, MatchOutcome] = {}
    for prepared in prepared_list:
        name = prepared.pool.name
        flight = pool_flight(name)
        t_launch = time.perf_counter()
        with data_plane.activate(flight.dp), flight.phase("launch"):
            outcome = finalize_pool_match(
                store, prepared,
                assignments.get(name, np.empty(0, dtype=np.int32)), config,
                states[name], clusters, make_task_id=make_task_id,
                record_placement_failure=record_placement_failure,
                flight=flight)
        outcome.phase_wall_s.update(walls[name],
                                    launch=time.perf_counter() - t_launch)
        outcomes[name] = outcome
    return outcomes


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
    """Reason code for an unmatched job; the operator-facing text is
    flight_recorder.REASON_TEXT[code]."""
    if nodes.n == 0:
        return flight_codes.NO_OFFERS
    if not feas_row.any():
        return flight_codes.CONSTRAINTS_FILTERED
    return flight_codes.INSUFFICIENT_RESOURCES
