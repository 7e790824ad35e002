"""Pipelined match cycle: overlap host encode/launch with the device solve.

Port of `cook_tpu/scheduler/pipeline.py`. The serial cycle
(matcher.match_pool) runs tensor_build -> blocking fetch -> launch
strictly in sequence: the card idles while the host builds tensors and
fans out launches, and the host idles while the card solves. This module
runs the multi-pool match pass as a pipeline:

    pool k:    prepare ----> dispatch . . . . [card solves] . . fetch -> finalize
    pool k+1:               prepare -> dispatch . . [card] . . . . fetch -> ...
                 ^ host                  ^ overlaps pool k's solve

  * `dispatch_pool_solve` queues pool k's kernels without waiting for
    them, then the host runs pool k+1's `prepare_pool_problem` and pool
    k-1's `finalize_pool_match` while the card executes;
  * on the card each stage runs on its own CUDA stream: its puts are
    staged through pinned memory and copied with `non_blocking=True`
    (`obs/data_plane.h2d`), its solve is queued behind them on the same
    stream, and its assignment is copied back into pinned memory behind a
    recorded event (`PendingResult.copy_to_host_async`), so pool k+1's
    transfers never wait for pool k's kernels (on the default stream a
    pageable copy would, and the pass would run serially with every
    decision still right).  Each stage's stream first waits for the
    driving thread's stream, and the driving stream waits for the stage's
    stream once it finishes.  On the CPU the plain code runs;
  * with device residency (scheduler/device_state.py) a pool's resident
    buffers are written in place on one stage's stream and read on a
    later stage's: the stream waits above order those uses, and each use
    is recorded on its stream for the allocator
    (`ops/device_update.mark_use`);
  * a depth-bounded stage queue bounds in-flight solves (depth 2 by
    default: one solving, one just dispatched), so device memory holds at
    most `depth` pools' problems;
  * the ORDERING RULE: store transactions commit in pool order — stages
    drain FIFO, so pool k's `finalize_pool_match` (where create_instance
    transacts) always completes before pool k+1's begins;
  * the per-cluster launch fan-out runs on each cluster's bounded launch
    executor (ComputeCluster.launch_tasks_async) with the kill-lock read
    side held by the worker; launch failures flow back into the store's
    state machine (task -> failed, `launch-failed`) and the cycle record
    through the recorder lock.  Only the driving thread touches the card:
    the launch workers touch the store and the cluster;
  * a solve raising for pool k surfaces at ITS fetch: the pool's jobs are
    skipped with `solve-failed` and pools k±1 proceed untouched.  There
    is no CPU re-solve behind the card (the reference's fallback tier is
    not ported), so a fault of the card or a kernel is never hidden; the
    failure is noted on the telemetry (health `device-degraded` for the
    pool until its next solve on the card succeeds);
  * a pool at or over `hierarchical_threshold` solves through
    `HierarchicalPending`, whose two-level solve runs at `fetch()` on the
    host's schedule: it overlaps nothing, in the reference too;
  * a pool whose speculation committed (`speculative`, scheduler/
    prediction.py) enters pre-solved: no prepare, no dispatch, no slot in
    the stage queue — it finalizes as soon as it reaches the queue head,
    so pool-order commits still hold.

Overlap accounting: each participating CycleRecord keeps per-phase times
with the serial path's semantics (solve = dispatch-end -> fetch-complete
interval), plus the shared pass wall and the device/host overlap fraction
(summed phase time beyond the wall).
"""
from __future__ import annotations

import collections
import contextlib
import logging
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from cook_tpu_torch.cluster.base import ComputeCluster, wait_all_launches
from cook_tpu_torch.models.entities import Job, Pool
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.ops.common import PendingResult
from cook_tpu_torch.scheduler import flight_recorder as flight_codes
from cook_tpu_torch.scheduler.flight_recorder import NULL_CYCLE
from cook_tpu_torch.scheduler.matcher import (
    MatchConfig,
    MatchOutcome,
    PoolMatchState,
    _apply_backoff,
    dispatch_pool_solve,
    fail_launched_specs,
    finalize_pool_match,
    note_solve_failed,
    note_solve_ok,
    prepare_pool_problem,
    record_solve_outcome,
)
from cook_tpu_torch.scheduler.ranking import RankedQueue

log = logging.getLogger(__name__)

# the phases whose summed time the overlap accounting compares against
# the pass wall (rank runs outside the pipelined pass).  The walls are
# DISJOINT per pool: the solve interval starts where the dispatch phase
# ends, so nothing is double-counted and a pass that degenerated to
# serial genuinely reports overlap 0.  speculation_commit is the
# validation wall of a pool served from a committed speculative solve —
# such pools have no tensor_build / dispatch / solve phases this cycle
# (that work ran during the PREVIOUS cycle's drain)
PIPELINE_PHASES = ("tensor_build", "dispatch", "solve", "launch",
                   "speculation_commit")


@dataclass
class PipelineParams:
    """Knobs of the pipelined pass."""

    # max in-flight solves (double-buffered by default: one pool solving
    # while the next is being prepared/dispatched)
    depth: int = 2
    # fan launches out via each cluster's launch executor instead of
    # blocking the cycle on backend RPCs
    async_launch: bool = True


# the pass waits (at most this long) for every async launch batch before
# it returns: the per-pool overlap is already banked, and draining at the
# END keeps the cycle's externally visible semantics identical to the
# serial path (callers observe launched tasks in the store).  (The
# reference makes the drain and its timeout knobs; no caller changes
# them.)
DRAIN_TIMEOUT_S = 30.0


@dataclass
class _Stage:
    pool: Pool
    prepared: object
    state: PoolMatchState
    flight: object
    stream: Optional[torch.cuda.Stream] = None  # None on the CPU
    pending: object = None          # PendingResult / HierarchicalPending
    t_dispatch: float = 0.0
    t_build: float = 0.0
    t_dispatch_s: float = 0.0
    # committed speculative assignment (scheduler/prediction.py): the
    # solve already ran during the previous cycle's drain — this stage
    # skips dispatch/fetch and finalizes at the queue head without
    # holding a slot
    speculative_assignment: object = None

    def on_stream(self):
        """The stage's CUDA stream as the current one (nothing on the
        CPU)."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)


def match_pools_pipelined(
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
    recorder=None,
    params: Optional[PipelineParams] = None,
    predictor=None,
    speculative: Optional[dict] = None,
    device_state=None,
) -> dict[str, MatchOutcome]:
    """Run every pool's match cycle through the pipelined engine.

    Same decision semantics as looping `matcher.match_pool` over the
    pools (the parity tests pin this); only the schedule differs.
    `speculative` maps pool name -> a COMMITTED prediction.CommitResult
    (validated by the caller against the speculation commit rule): such
    pools skip prepare + dispatch and finalize its assignment.
    `outcome.phase_wall_s` per pool: encode (tensor_build), dispatch,
    solve (dispatch-end -> fetch-complete, so it spans the host work
    interleaved meanwhile) and launch."""
    params = params or PipelineParams()
    flights = flights or {}
    speculative = speculative or {}
    outcomes: dict[str, MatchOutcome] = {}
    device = torch.device(device)
    main_stream = (torch.cuda.current_stream(device)
                   if device.type == "cuda" else None)

    def pool_flight(pool_name: str):
        return flights.get(pool_name, NULL_CYCLE)

    for f in flights.values():
        if f.record is not None:
            f.record.pipelined = True

    def launch_failure_cb_for(flight):
        # the callback runs on a cluster launch-worker thread and can land
        # before OR after the cycle record commits — record + index writes
        # go through the recorder lock, never the builder
        record = flight.record

        def cb(specs, exc):
            def note(job_uuid, detail):
                if recorder is not None:
                    recorder.note_async_launch_failure(
                        record, job_uuid, flight_codes.LAUNCH_FAILED,
                        detail)
            fail_launched_specs(store, specs, exc, note_reason=note)
        return cb

    def finish(stage: _Stage) -> None:
        """Fetch + finalize one pool.  Called strictly in pool order."""
        flight = stage.flight
        assignment = np.empty(0, dtype=np.int32)
        walls = {"encode": stage.t_build, "dispatch": stage.t_dispatch_s}
        if stage.speculative_assignment is not None:
            # served from a committed speculation: its solve's telemetry
            # ran when the speculation was validated — straight to launch
            assignment = stage.speculative_assignment
        elif stage.pending is not None:
            solve_failed = False
            t_fetch = time.perf_counter()
            try:
                # re-activate THIS pool's data-plane scope (and stream) for
                # the fetch: under overlap the driving thread interleaves
                # pool k's fetch with pool k±1's prepare/finalize, and each
                # stage must credit its own cycle's byte counts
                with stage.on_stream(), data_plane.activate(flight.dp), \
                        data_plane.family(data_plane.FAM_SOLVE):
                    assignment = stage.pending.fetch()
            except Exception:  # noqa: BLE001 — pool k's kernel raising
                # (a deferred device error surfaces at fetch) must not
                # wedge pools k±1: its jobs wait a cycle
                log.exception("pipelined solve failed (pool %s)",
                              stage.pool.name)
                solve_failed = True
            if stage.stream is not None:
                main_stream.wait_stream(stage.stream)
            t_end = time.perf_counter()
            # solve phase wall = dispatch-end -> fetch-complete; under
            # overlap it also spans the host work interleaved between
            # dispatch and fetch, which is what the overlap fraction
            # quantifies.  Only the blocking fetch WAIT is device-
            # attributed: the overlapped span is not accelerator time
            wait_s = t_end - t_fetch
            solve_s = t_end - stage.t_dispatch
            flight.add_phase("solve", wait_s, device=True)
            if solve_s > wait_s:
                flight.add_phase("solve", solve_s - wait_s, device=False)
            walls["solve"] = solve_s
            if solve_failed:
                note_solve_failed(telemetry, stage.pool.name)
                outcome = stage.prepared.outcome
                outcome.unmatched = list(stage.prepared.considerable)
                outcome.head_matched = False
                for job in stage.prepared.considerable:
                    flight.note_skip(job.uuid, flight_codes.SOLVE_FAILED)
                    if record_placement_failure is not None:
                        record_placement_failure(
                            job, flight_codes.REASON_TEXT[
                                flight_codes.SOLVE_FAILED])
                _apply_backoff(config, stage.state, False)
                outcome.phase_wall_s.update(walls)
                outcomes[stage.pool.name] = outcome
                return
            record_solve_outcome(stage.prepared, assignment, config,
                                 stage.state, stage.pool.name, solve_s,
                                 flight, telemetry, overlapped=True)
            note_solve_ok(telemetry, stage.pool.name)
            hier = stage.prepared.hier_stats
            if hier is not None:
                walls.update(coarse_solve=hier["coarse_s"],
                             fine_solve=hier["fine_s"],
                             refine=hier["refine_s"])
        t_launch = time.perf_counter()
        with data_plane.activate(flight.dp), flight.phase("launch"):
            outcome = finalize_pool_match(
                store, stage.prepared, assignment, config, stage.state,
                clusters,
                make_task_id=make_task_id,
                record_placement_failure=record_placement_failure,
                flight=flight,
                async_launch=params.async_launch,
                launch_failure_cb=(launch_failure_cb_for(flight)
                                   if params.async_launch else None),
            )
        outcome.phase_wall_s.update(walls,
                                    launch=time.perf_counter() - t_launch)
        outcomes[stage.pool.name] = outcome

    t_pass = time.perf_counter()
    inflight: collections.deque[_Stage] = collections.deque()
    depth = max(1, params.depth)
    for pool in pools:
        flight = pool_flight(pool.name)
        hit = speculative.get(pool.name)
        if hit is not None:
            # pre-solved pool: no prepare, no dispatch, no slot — pending
            # stays None, so the drain below finalizes it as soon as it
            # reaches the queue head
            inflight.append(_Stage(
                pool=pool, prepared=hit.prepared, state=states[pool.name],
                flight=flight, speculative_assignment=hit.assignment))
            while inflight and (
                    inflight[0].pending is None
                    or sum(1 for s in inflight if s.pending is not None)
                    >= depth):
                finish(inflight.popleft())
            continue
        stage = _Stage(pool=pool, prepared=None, state=states[pool.name],
                       flight=flight)
        if main_stream is not None:
            # a stream of its own (the pool of CUDA streams hands out
            # distinct ones), ordered after everything the driving thread
            # queued so far
            stage.stream = torch.cuda.Stream(device=device)
            stage.stream.wait_stream(main_stream)
        t0 = time.perf_counter()
        with stage.on_stream(), data_plane.activate(flight.dp), \
                flight.phase("tensor_build"):
            stage.prepared = prepare_pool_problem(
                store, pool, queues[pool.name], clusters, config,
                stage.state, device=device, launch_filter=launch_filter,
                host_reservations=host_reservations,
                host_attrs=host_attrs, flight=flight,
                encode_cache=encode_cache, predictor=predictor,
                device_state=device_state)
        t1 = time.perf_counter()
        stage.t_build = t1 - t0
        if stage.prepared.solvable:
            with stage.on_stream(), data_plane.activate(flight.dp), \
                    flight.phase("dispatch"):
                try:
                    stage.pending = dispatch_pool_solve(
                        stage.prepared, config, telemetry=telemetry)
                    if stage.stream is not None and \
                            isinstance(stage.pending, PendingResult):
                        stage.pending.copy_to_host_async(stage.stream)
                except Exception:  # noqa: BLE001 — a dispatch-time raise
                    # is this pool's solve failing eagerly; mark it
                    # failed at finish() like a deferred device error
                    log.exception("pipelined dispatch failed (pool %s)",
                                  pool.name)
                    stage.pending = _FailedDispatch()
            # the solve interval starts where the dispatch phase ends —
            # disjoint walls, so phase sums never double-count
            stage.t_dispatch = time.perf_counter()
            stage.t_dispatch_s = stage.t_dispatch - t1
        inflight.append(stage)
        # the stage queue: once `depth` solves are in flight, the oldest
        # pool's fetch+finalize runs NOW — its device wait overlaps the
        # pool just prepared/dispatched, and the FIFO drain keeps
        # transactions committing in pool order.  Unsolvable pools
        # (nothing dispatched) finalize as soon as they reach the head;
        # they never hold a slot
        while inflight and (
                inflight[0].pending is None
                or sum(1 for s in inflight if s.pending is not None)
                >= depth):
            finish(inflight.popleft())
    while inflight:
        finish(inflight.popleft())

    if params.async_launch:
        for cluster in wait_all_launches(clusters, timeout=DRAIN_TIMEOUT_S):
            log.warning("pipelined pass: cluster %s still has launches "
                        "in flight after %.0fs drain timeout",
                        cluster.name, DRAIN_TIMEOUT_S)

    # ------------------------------------------------ overlap accounting
    wall_s = time.perf_counter() - t_pass
    summed = 0.0
    for pool in pools:
        record = pool_flight(pool.name).record
        if record is None:
            continue
        summed += sum(record.phases.get(name, 0.0)
                      for name in PIPELINE_PHASES)
    overlap_s = max(0.0, summed - wall_s)
    overlap_fraction = overlap_s / summed if summed > 0 else 0.0
    for pool in pools:
        record = pool_flight(pool.name).record
        if record is None:
            continue
        record.pipeline_wall_s = wall_s
        record.overlap_s = overlap_s
        record.overlap_fraction = overlap_fraction
    return outcomes


class _FailedDispatch:
    """Stand-in pending result for a solve that raised at dispatch time:
    fetch() re-raises so finish() takes the one solve-failed path."""

    def fetch(self):
        raise RuntimeError("solve dispatch failed (see log)")
