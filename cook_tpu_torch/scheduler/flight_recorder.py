"""Scheduler flight recorder: per-cycle structured decision records.

The reference scheduler is operable because every match cycle leaves a
trail — ~200 named metrics, `with-duration` around every hot section,
and per-job "why is this unscheduled" attribution (unscheduled.clj).
This module is the rebuild's equivalent of that trail condensed into one
artifact: every match cycle emits a `CycleRecord` holding

  * per-phase wall durations (rank, tensor_build, solve, launch,
    preemption_search), split into device vs host time — the solve runs
    on the accelerator, everything else is host matchmaking;
  * the jobs considered, matched (with host + task id), and skipped,
    each skip carrying a machine-readable reason code;
  * preemption victims with the DRU score that sentenced them;
  * offer/node/queue counts.

Records sit in a bounded ring served at `GET /debug/cycles` (rest/api.py)
and are dumped by the simulator for offline analysis.  The recorder also
keeps a bounded per-job index of the LAST cycle decision so
`/unscheduled_jobs` can answer with the real reason code instead of a
static guess.

A copy of `cook_tpu/scheduler/flight_recorder.py` (the same record schema
and reason codes) without the writers of the layer the port has not got,
speculation (its record fields stay, at their defaults).  A `device=True` phase is
timed by the caller's block, and the match path's solve block ends in the
device-to-host copy of the assignment (`ops/common.fetch_result`), which
waits for the card: a device phase never ends at an asynchronous launch.
"""
from __future__ import annotations

import collections
import itertools
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.utils.metrics import global_registry

# ---------------------------------------------------------------- reason codes
# Machine-readable per-job outcomes of one match cycle.  These are the
# matcher's decisions, distinct from instance failure reasons
# (models/reasons.py) which describe how a RUNNING attempt died.

MATCHED = "matched"
NO_OFFERS = "no-offers"
CONSTRAINTS_FILTERED = "all-nodes-filtered-by-constraints"
INSUFFICIENT_RESOURCES = "insufficient-resources"
LAUNCH_CAP = "cluster-launch-cap"
PORTS_EXHAUSTED = "ports-exhausted"
LAUNCH_VETOED = "launch-vetoed"
LAUNCH_FAILED = "launch-failed"
SOLVE_FAILED = "solve-failed"
NOT_CONSIDERED = "not-considered"
EXCEEDS_POOL_CAPACITY = "exceeds-pool-capacity"
CLUSTER_CIRCUIT_OPEN = "cluster-circuit-open"
GANG_INCOMPLETE = "gang-incomplete"

REASON_TEXT = {
    NO_OFFERS: "no offers",
    CONSTRAINTS_FILTERED: "all nodes filtered by constraints",
    INSUFFICIENT_RESOURCES: "insufficient resources on feasible nodes",
    LAUNCH_CAP: "cluster launch rate/cap reached this cycle",
    PORTS_EXHAUSTED: "insufficient free ports on the matched node",
    LAUNCH_VETOED: "launch transaction vetoed (job changed state mid-cycle)",
    LAUNCH_FAILED: "backend launch RPC failed after the match transacted",
    SOLVE_FAILED: "the pool's device solve raised; jobs wait a cycle",
    NOT_CONSIDERED: "not in this cycle's considerable window",
    EXCEEDS_POOL_CAPACITY:
        "the job's resource demands exceed every host in the pool",
    CLUSTER_CIRCUIT_OPEN:
        "the pool's clusters are circuit-open (launch/kill RPCs failing);"
        " jobs wait for the breaker's half-open probe instead of burning"
        " mea-culpa retries",
    GANG_INCOMPLETE:
        "the job's gang could not place whole (all members on distinct"
        " hosts inside one topology block); the matcher's all-or-nothing"
        " rule holds the whole gang back",
}


@dataclass
class PreemptionRecord:
    """One rebalancer decision: who was killed, for whom, and why."""

    job_uuid: str                 # the beneficiary the room was made for
    hostname: str
    task_ids: list[str]           # victims
    min_preempted_dru: float      # the DRU score that justified the kill
    preemptor_user: str = ""      # the beneficiary's user
    # per-victim fairness detail: [{task_id, user, dru, wasted_s, ...}]
    victims: list[dict] = field(default_factory=list)
    wasted_s: float = 0.0         # victim runtime destroyed, seconds

    def to_json(self) -> dict:
        return {
            "job": self.job_uuid,
            "hostname": self.hostname,
            "task_ids": list(self.task_ids),
            "dru": self.min_preempted_dru,
            "preemptor_user": self.preemptor_user,
            "victims": [dict(v) for v in self.victims],
            "wasted_s": self.wasted_s,
        }


@dataclass
class CycleRecord:
    """One match cycle's full decision record."""

    cycle_id: int
    pool: str
    t_ms: int                     # store clock at cycle start (virtual ms)
    wall_time: float              # epoch seconds at cycle start
    batched: bool = False         # solved via the pool-batched device call
    # pipelined-cycle overlap accounting (scheduler/pipeline.py): the
    # pass dispatches pool k's solve asynchronously and runs pool k±1's
    # host phases while the device executes, so the summed per-pool phase
    # time exceeds the pass's wall time.  pipeline_wall_s is the WHOLE
    # pipelined pass's wall (shared by every participating record);
    # overlap_s / overlap_fraction quantify how much host+device time ran
    # concurrently (0 on the serial paths).
    pipelined: bool = False
    pipeline_wall_s: float = 0.0
    overlap_s: float = 0.0
    overlap_fraction: float = 0.0
    # prediction-assisted speculation (scheduler/prediction.py): was this
    # cycle served from a speculative solve dispatched while the PREVIOUS
    # cycle drained?  `speculation` is the commit attempt's outcome
    # ("hit" | "dropped" | "none"; "" on schedulers without a speculator)
    # and `speculation_drop` the drop/skip reason (epoch-stale /
    # prediction-miss / offers-changed / queue-shifted / predictor-cold /
    # disabled / solve-error)
    speculative: bool = False
    speculation: str = ""
    speculation_drop: str = ""
    phases: dict[str, float] = field(default_factory=dict)   # name -> seconds
    device_s: float = 0.0
    host_s: float = 0.0
    total_s: float = 0.0
    # device truth for the cycle's solve (obs/ telemetry): the padded
    # problem shape the kernel actually compiled for ("jobs x nodes"),
    # the candidate-pass backend, and whether THIS solve paid a JIT
    # compile (first-seen shape) — so a slow cycle is attributable to
    # compilation vs execution from the record alone
    solve_shape: str = ""
    backend: str = ""
    compiled: bool = False
    # hierarchical two-level solve accounting (ops/hierarchical.py):
    # set when the cycle's solve decomposed into topology blocks.  The
    # coarse/fine/refine walls live OUTSIDE `phases` on purpose — they
    # are sub-spans of the cycle's one `solve` phase, and folding them
    # into `phases` would double-count device_s/host_s and the pipelined
    # overlap accounting.  block_stats carries per-block {jobs, placed}
    # for the round-0 scatter (bounded: one entry per topology block).
    hierarchical: bool = False
    hier_blocks: int = 0
    # superblock (DCN-domain) count when the mega-scale layer engaged
    # (0 = off/degenerate); the per-level wall split rides in
    # hier_phases ("super_coarse_solve" joins the three classic keys)
    hier_superblocks: int = 0
    hier_phases: dict = field(default_factory=dict)
    hier_spilled: int = 0
    hier_refine_placed: int = 0
    block_stats: list[dict] = field(default_factory=list)
    # gang scheduling (scheduler/gang.py + ops/gang.py): per-cycle gang
    # accounting — gangs in the considerable window, gangs fully placed,
    # gangs blocked, and the blocking-reason split ({reason: count},
    # e.g. "no-block-capacity" / "members-missing") — so /debug/cycles
    # answers "why did the gang wait" without replaying the solve
    gangs_considered: int = 0
    gangs_placed: int = 0
    gangs_blocked: int = 0
    gang_block_reasons: dict = field(default_factory=dict)
    # per-pool capacity snapshot at cycle start ({hosts, mem, cpus,
    # spare_*}) + the elastic plan id in force — so a capacity delta
    # (cook_tpu/elastic/) correlates with match outcomes record-to-record
    pool_capacity: dict = field(default_factory=dict)
    elastic_plan: int = 0
    # data-plane accounting (obs/data_plane.py): logical host<->device
    # bytes this cycle moved, the fraction of encode-row bytes freshly
    # recomputed (1 - this = re-transferred unchanged — the waste a
    # device-resident encode cache removes), the padded-bucket waste of
    # the tensors built, and the per-tensor-family breakdown.  None =
    # the cycle built/encoded nothing (idle pool, speculative hit)
    h2d_bytes: int = 0
    d2h_bytes: int = 0
    rebuild_fraction: Optional[float] = None
    padding_waste: Optional[float] = None
    data_plane: dict = field(default_factory=dict)
    # device-resident match state (scheduler/device_state.py): set when
    # the cycle's tensors came from the resident mirror — resident
    # buffer bytes, delta rows scattered vs full rebuild (+ reason),
    # the update-kernel wall, and whether the cost tensors were bf16
    device_state: dict = field(default_factory=dict)
    offers: int = 0
    queue_len: int = 0
    considered: int = 0
    # queued jobs outside this cycle's considerable window (count only —
    # their uuids go to the per-job reason index, not the record, which
    # would otherwise bloat by O(queue) every cycle)
    not_considered: int = 0
    head_matched: bool = True
    # [{job, host, task_id}] / [{job, code, detail}]
    matched: list[dict] = field(default_factory=list)
    skipped: list[dict] = field(default_factory=list)
    preemptions: list[PreemptionRecord] = field(default_factory=list)
    # fairness rollup for the cycle's rebalance pass (obs/fairness.py):
    # {preemptions, tasks_preempted, wasted_s, jain_index}
    fairness: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "cycle": self.cycle_id,
            "pool": self.pool,
            "t_ms": self.t_ms,
            "wall_time": self.wall_time,
            "batched": self.batched,
            "pipelined": self.pipelined,
            "pipeline_wall_s": self.pipeline_wall_s,
            "overlap_s": self.overlap_s,
            "overlap_fraction": self.overlap_fraction,
            "speculative": self.speculative,
            "speculation": self.speculation,
            "speculation_drop": self.speculation_drop,
            "phases": dict(self.phases),
            "device_s": self.device_s,
            "host_s": self.host_s,
            "total_s": self.total_s,
            "solve_shape": self.solve_shape,
            "backend": self.backend,
            "compiled": self.compiled,
            "hierarchical": self.hierarchical,
            "hier_blocks": self.hier_blocks,
            "hier_superblocks": self.hier_superblocks,
            "hier_phases": dict(self.hier_phases),
            "hier_spilled": self.hier_spilled,
            "hier_refine_placed": self.hier_refine_placed,
            "block_stats": list(self.block_stats),
            "gangs_considered": self.gangs_considered,
            "gangs_placed": self.gangs_placed,
            "gangs_blocked": self.gangs_blocked,
            "gang_block_reasons": dict(self.gang_block_reasons),
            "pool_capacity": dict(self.pool_capacity),
            "elastic_plan": self.elastic_plan,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "rebuild_fraction": self.rebuild_fraction,
            "padding_waste": self.padding_waste,
            "data_plane": dict(self.data_plane),
            "device_state": dict(self.device_state),
            "offers": self.offers,
            "queue_len": self.queue_len,
            "considered": self.considered,
            "not_considered": self.not_considered,
            "matched_count": len(self.matched),
            "skipped_count": len(self.skipped),
            "head_matched": self.head_matched,
            "matched": list(self.matched),
            "skipped": list(self.skipped),
            "preemptions": [p.to_json() for p in self.preemptions],
            "fairness": dict(self.fairness),
        }


class CycleBuilder:
    """Mutable collector one match cycle writes into.

    Single-threaded by construction: one builder per (pool, cycle), used
    only on the cycle's driving thread.  `FlightRecorder.commit` freezes
    it into a CycleRecord."""

    def __init__(self, cycle_id: int, pool: str, t_ms: int):
        self.record = CycleRecord(cycle_id=cycle_id, pool=pool, t_ms=t_ms,
                                  wall_time=time.time())
        # uuids queued but outside the considerable window; indexed at
        # commit, never stored on the record (O(queue) per cycle)
        self.not_considered: list[str] = []
        # rank context for the per-job history (set by the matcher's
        # prepare step): REFERENCES to the cycle's ranked queue — stable
        # for the cycle's lifetime (rank_cycle replaces, never mutates)
        self.rank_jobs: Optional[list] = None
        self.rank_dru: Optional[dict] = None
        # per-cycle data-plane scope: the match paths activate it around
        # their prepare/solve/launch sections (data_plane.activate) so
        # transfer/residency/padding notes attribute to THIS cycle even
        # under pipelined overlap; finish() folds it into the record
        self.dp = data_plane.CycleDataPlane(pool, cycle_id)
        self._t0 = time.perf_counter()

    @contextmanager
    def phase(self, name: str, device: bool = False):
        """Time one phase; device=True attributes it to accelerator time."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add_phase(name, time.perf_counter() - t0, device=device)

    def add_phase(self, name: str, seconds: float,
                  device: bool = False) -> None:
        """Credit an externally-timed duration to a phase (the batched
        multi-pool solve is one shared device call; its wall time is
        attributed to every participating pool's record)."""
        rec = self.record
        rec.phases[name] = rec.phases.get(name, 0.0) + seconds
        if device:
            rec.device_s += seconds
        else:
            rec.host_s += seconds

    def set_counts(self, *, offers: Optional[int] = None,
                   queue_len: Optional[int] = None,
                   considered: Optional[int] = None) -> None:
        if offers is not None:
            self.record.offers = offers
        if queue_len is not None:
            self.record.queue_len = queue_len
        if considered is not None:
            self.record.considered = considered

    def note_solve(self, shape_sig: str, backend: str,
                   compiled: bool) -> None:
        """Record the cycle's device-solve identity (padded shape,
        backend, compile-paid flag) from the obs/ telemetry layer."""
        self.record.solve_shape = shape_sig
        self.record.backend = backend
        self.record.compiled = compiled

    def set_rank_context(self, jobs, dru) -> None:
        """Attach the cycle's ranked queue (jobs list + uuid->DRU map) so
        commit can stamp each job's history entry with its rank position
        and DRU score — the timeline's placement attribution."""
        self.rank_jobs = jobs
        self.rank_dru = dru

    def note_hierarchical(self, stats: dict) -> None:
        """Fold a two-level solve's accounting (ops/hierarchical.py
        stats) into the record: block geometry, coarse/fine/refine walls,
        spill/refine counts, per-block jobs/placed."""
        rec = self.record
        rec.hierarchical = True
        rec.hier_blocks = int(stats.get("blocks", 0))
        rec.hier_superblocks = int(stats.get("superblocks", 0))
        rec.hier_phases = {
            "coarse_solve": stats.get("coarse_s", 0.0),
            "fine_solve": stats.get("fine_s", 0.0),
            "refine": stats.get("refine_s", 0.0),
        }
        if rec.hier_superblocks >= 2:
            # the super-coarse wall only exists when the DCN-domain layer
            # engaged; classic two-level records keep their shape
            rec.hier_phases["super_coarse_solve"] = \
                stats.get("super_coarse_s", 0.0)
        rec.hier_spilled = int(stats.get("spilled", 0))
        rec.hier_refine_placed = int(stats.get("refine_placed", 0))
        rec.block_stats = list(stats.get("block_stats", []))

    def note_device_state(self, stats: dict) -> None:
        """Record the cycle's device-resident state outcome
        (scheduler/device_state.py build stats: resident bytes, delta
        rows vs rebuild, update wall)."""
        self.record.device_state = {
            k: v for k, v in stats.items() if not k.startswith("_")}

    def note_gang(self, *, considered: int, placed: int, blocked: int,
                  reasons: Optional[dict] = None) -> None:
        """Record the cycle's gang outcome (matcher finalize chokepoint):
        gangs considered/fully-placed/blocked plus the blocking-reason
        split ({reason: count})."""
        rec = self.record
        rec.gangs_considered = considered
        rec.gangs_placed = placed
        rec.gangs_blocked = blocked
        rec.gang_block_reasons = dict(reasons or {})

    def note_match(self, job_uuid: str, hostname: str, task_id: str) -> None:
        self.record.matched.append(
            {"job": job_uuid, "host": hostname, "task_id": task_id})

    def note_skip(self, job_uuid: str, code: str, detail: str = "") -> None:
        self.record.skipped.append(
            {"job": job_uuid, "code": code,
             "detail": detail or REASON_TEXT.get(code, "")})

    def note_not_considered(self, job_uuid: str) -> None:
        self.not_considered.append(job_uuid)

    def note_preemption(self, preemption: PreemptionRecord) -> None:
        self.record.preemptions.append(preemption)

    def finish(self) -> CycleRecord:
        rec = self.record
        rec.h2d_bytes = self.dp.h2d_bytes
        rec.d2h_bytes = self.dp.d2h_bytes
        rec.rebuild_fraction = self.dp.rebuild_fraction
        rec.padding_waste = self.dp.padding_waste
        rec.data_plane = self.dp.families_json()
        if self.record.batched or self.record.pipelined:
            # the pool-batched and pipelined paths start every pool's
            # builder before any pool's work begins, so builder-lifetime
            # elapsed would report the whole PASS's wall time for each
            # pool; the sum of this pool's attributed phases (shared or
            # overlapped solve included) is the honest per-pool figure
            # (the pass wall lives in record.pipeline_wall_s)
            self.record.total_s = self.record.device_s + self.record.host_s
            return self.record
        # rank may have been credited via add_phase from BEFORE the
        # builder existed (a separately-triggered rank cycle): total must
        # still cover every attributed phase
        elapsed = time.perf_counter() - self._t0
        self.record.total_s = max(elapsed,
                                  self.record.device_s + self.record.host_s)
        return self.record


class NullCycle:
    """No-op builder so instrumented code never branches on None.
    `record` is None so call sites can uniformly test `flight.record is
    not None` instead of hasattr (`dp` likewise — data_plane.activate
    treats None as a no-op scope)."""

    record = None
    dp = None

    @contextmanager
    def phase(self, name: str, device: bool = False):
        yield

    def add_phase(self, name: str, seconds: float, device: bool = False) -> None:
        pass

    def set_counts(self, **kw) -> None:
        pass

    def note_solve(self, *a) -> None:
        pass

    def note_match(self, *a) -> None:
        pass

    def note_skip(self, *a, **kw) -> None:
        pass

    def note_not_considered(self, *a) -> None:
        pass

    def note_preemption(self, *a) -> None:
        pass

    def set_rank_context(self, *a) -> None:
        pass

    def note_hierarchical(self, *a) -> None:
        pass

    def note_gang(self, *a, **kw) -> None:
        pass

    def note_device_state(self, *a) -> None:
        pass


NULL_CYCLE = NullCycle()


class FlightRecorder:
    """Bounded ring of CycleRecords + per-job last-decision index +
    per-job bounded cycle history (the timeline's substrate)."""

    def __init__(self, capacity: int = 512, job_reason_capacity: int = 100_000,
                 history_per_job: int = 64):
        self._ring: collections.deque[CycleRecord] = collections.deque(
            maxlen=capacity)
        self._by_id: collections.OrderedDict[int, CycleRecord] = \
            collections.OrderedDict()
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        # job uuid -> (cycle_id, code, detail); LRU-bounded (job uuids are
        # minted forever on a long-lived leader)
        self._job_reasons: collections.OrderedDict[str, tuple[int, str, str]] \
            = collections.OrderedDict()
        self._job_reason_capacity = job_reason_capacity
        # job uuid -> deque of per-cycle decision entries ({cycle, t_ms,
        # pool, code, detail, rank?, dru?, host?}), newest last.  Bounded
        # twice: per-job deque maxlen AND LRU over jobs (same budget as
        # the last-decision index) — `GET /jobs/{uuid}/timeline` walks it
        self._history_per_job = history_per_job
        self._job_history: collections.OrderedDict[str, collections.deque] \
            = collections.OrderedDict()

    @property
    def capacity(self) -> int:
        return self._ring.maxlen

    def begin(self, pool: str, t_ms: int) -> CycleBuilder:
        with self._lock:
            cycle_id = next(self._ids)
        return CycleBuilder(cycle_id, pool, t_ms)

    def commit(self, builder: CycleBuilder) -> CycleRecord:
        record = builder.finish()
        # fold the cycle's data-plane scope into the process ledger
        # (per-pool residency surface + /debug/device cycle ring)
        data_plane.LEDGER.finish_cycle(builder.dp)
        record.not_considered = len(builder.not_considered)
        # rank position + DRU score per uuid for the history entries —
        # O(queue), same order as the not_considered indexing below
        positions: dict[str, int] = {}
        dru = builder.rank_dru or {}
        if builder.rank_jobs is not None:
            positions = {job.uuid: i
                         for i, job in enumerate(builder.rank_jobs)}
        with self._lock:
            self._ring.append(record)
            self._by_id[record.cycle_id] = record
            while len(self._by_id) > self._ring.maxlen:
                self._by_id.popitem(last=False)
            for m in record.matched:
                self._note_reason(m["job"], record.cycle_id, MATCHED,
                                  f"matched to {m['host']}",
                                  record=record, host=m["host"],
                                  rank=positions.get(m["job"]),
                                  dru=dru.get(m["job"]))
            for s in record.skipped:
                self._note_reason(s["job"], record.cycle_id, s["code"],
                                  s.get("detail", ""),
                                  record=record,
                                  rank=positions.get(s["job"]),
                                  dru=dru.get(s["job"]))
            for uuid in builder.not_considered:
                self._note_reason(uuid, record.cycle_id, NOT_CONSIDERED, "",
                                  record=record,
                                  rank=positions.get(uuid),
                                  dru=dru.get(uuid))
        global_registry.histogram(
            "cycle.duration", "total wall seconds per match cycle").observe(
            record.total_s, {"pool": record.pool})
        global_registry.gauge(
            "cycle.device_seconds",
            "accelerator time of the last match cycle").set(
            record.device_s, {"pool": record.pool})
        global_registry.gauge(
            "cycle.host_seconds",
            "host matchmaking time of the last match cycle").set(
            record.host_s, {"pool": record.pool})
        if record.pipelined:
            global_registry.gauge(
                "cycle.overlap_fraction",
                "fraction of the last pipelined pass's summed phase time "
                "that ran concurrently (host/device overlap)").set(
                record.overlap_fraction, {"pool": record.pool})
        return record

    def note_async_launch_failure(self, record: Optional[CycleRecord],
                                  job_uuid: str, code: str,
                                  detail: str = "") -> None:
        """Record an async launch-fan-out failure: appends the skip to
        the cycle record AND updates the per-job index, both under the
        recorder lock.  The callback runs on a cluster launch-worker
        thread and may land before OR after the record committed, so it
        must not touch the CycleBuilder directly (single-threaded by
        construction) — this is the same locked mutate-committed-record
        pattern annotate_preemptions uses, serialized against
        records_json renders and commit."""
        detail = detail or REASON_TEXT.get(code, "")
        with self._lock:
            cycle_id = 0
            if record is not None:
                cycle_id = record.cycle_id
                record.skipped.append(
                    {"job": job_uuid, "code": code, "detail": detail})
            self._note_reason(job_uuid, cycle_id, code, detail,
                              record=record)

    def _note_reason(self, job_uuid: str, cycle_id: int, code: str,
                     detail: str, *, record: Optional[CycleRecord] = None,
                     rank: Optional[int] = None,
                     dru: Optional[float] = None,
                     host: Optional[str] = None) -> None:
        self._job_reasons[job_uuid] = (cycle_id, code, detail)
        self._job_reasons.move_to_end(job_uuid)
        while len(self._job_reasons) > self._job_reason_capacity:
            self._job_reasons.popitem(last=False)
        entry: dict = {"cycle": cycle_id,
                       "t_ms": record.t_ms if record is not None else 0,
                       "pool": record.pool if record is not None else "",
                       "code": code, "detail": detail}
        if rank is not None:
            entry["rank"] = rank
        if dru is not None:
            entry["dru"] = dru
        if host is not None:
            entry["host"] = host
        history = self._job_history.get(job_uuid)
        if history is None:
            history = collections.deque(maxlen=self._history_per_job)
            self._job_history[job_uuid] = history
        history.append(entry)
        self._job_history.move_to_end(job_uuid)
        while len(self._job_history) > self._job_reason_capacity:
            self._job_history.popitem(last=False)

    def annotate_preemptions(self, pool: str,
                             preemptions: list[PreemptionRecord],
                             duration_s: float,
                             fairness: Optional[dict] = None) -> None:
        """Attach a rebalance pass to the pool's most recent cycle record
        (the preemption search runs as a phase of the same scheduling
        cycle); falls back to a standalone record when no match cycle has
        run yet for the pool."""
        with self._lock:
            target = None
            for record in reversed(self._ring):
                if record.pool == pool:
                    target = record
                    break
            if target is None:
                builder = CycleBuilder(next(self._ids), pool, 0)
                target = builder.record
                self._ring.append(target)
                self._by_id[target.cycle_id] = target
            target.phases["preemption_search"] = (
                target.phases.get("preemption_search", 0.0) + duration_s)
            target.host_s += duration_s
            target.total_s += duration_s
            target.preemptions.extend(preemptions)
            if fairness:
                target.fairness.update(fairness)

    # ------------------------------------------------------------------ reads

    def records(self, limit: int = 50,
                pool: Optional[str] = None) -> list[CycleRecord]:
        """Live record references — same-thread (scheduler) use only;
        concurrent readers must use records_json/get_json, which
        serialize under the lock (annotate_preemptions mutates records
        in place)."""
        with self._lock:
            out = [r for r in self._ring if pool is None or r.pool == pool]
        return out[-limit:]

    def get(self, cycle_id: int) -> Optional[CycleRecord]:
        with self._lock:
            return self._by_id.get(cycle_id)

    def records_json(self, limit: int = 50,
                     pool: Optional[str] = None,
                     since: int = 0) -> list[dict]:
        """Snapshot for cross-thread consumers (REST, simulator dump):
        serialized under the lock so a concurrent rebalance annotation
        can't tear a record mid-render.  `since` keeps only records with
        cycle_id > since (cheap incremental slicing for pollers,
        timelines, and incident bundles)."""
        with self._lock:
            out = [r for r in self._ring
                   if (pool is None or r.pool == pool)
                   and r.cycle_id > since]
            return [r.to_json() for r in out[-limit:]]

    def get_json(self, cycle_id: int) -> Optional[dict]:
        with self._lock:
            record = self._by_id.get(cycle_id)
            return None if record is None else record.to_json()

    def job_reason(self, job_uuid: str) -> Optional[tuple[int, str, str]]:
        """(cycle_id, code, detail) of the job's last cycle decision."""
        with self._lock:
            return self._job_reasons.get(job_uuid)

    def job_history(self, job_uuid: str) -> list[dict]:
        """Chronological per-cycle decision entries for one job (bounded
        to the newest `history_per_job`); copied under the lock so the
        timeline render can't race a concurrent commit's append."""
        with self._lock:
            history = self._job_history.get(job_uuid)
            return [dict(e) for e in history] if history is not None else []
