"""Runtime prediction and speculative match cycles.

Port of `cook_tpu/scheduler/prediction.py`, with its imports rewritten to
the port's modules and the speculative solve placed on the scheduler's
device:

  * `QuantileRuntimePredictor` — per-(user, command-fingerprint) rolling
    quantile estimators over observed instance runtimes, fed from the
    store's instance-completion events (`attach`).  Anything with
    `predict_runtime_ms(user, command)` / `observe(...)` can stand in;

  * `CycleSpeculator` — at the end of cycle N (launches committed, the
    backend drain and inter-cycle idle ahead), rank + encode + DISPATCH
    cycle N+1's solve against the *predicted* offer set: running tasks
    the predictor expects to finish inside the horizon are assumed
    complete, their capacity folded back into their hosts' offers and
    their rows removed from the predicted DRU rank.  The solve's kernels
    are queued on the card while the host idles between cycles.

THE COMMIT RULE: a speculation is stamped at dispatch with (a) the
encode-cache epoch (and the resident state's epoch), (b) a
`SpeculationGuard` token registering the EXACT store events its
predicted state implies (each assumed completion's `instance/status:
success` + `job/state: completed`), and (c) the structural offer-set
fingerprint.  At cycle N+1 start it commits only if

  1. every registered event landed (the predictions came true),
  2. NO other store mutation landed (the guard marks the token stale on
     the first unexpected event),
  3. the epochs and the offer-set structure are unchanged,
  4. a fresh `select_considerable` over the real, just-ranked queue is
     identical (uuid-for-uuid, in order) to the speculative window.

Under 1-4 the speculative solve's inputs equal a fresh solve's inputs, so
the committed placements are the placements cycle N+1 would have computed.
Anything else DROPS the speculation (counted, reason-coded) and the cycle
solves fresh, on the same device and kernels: a stale speculation is
never repaired.  A speculative solve that raises (at dispatch, or at the
fetch where a deferred device error surfaces) is dropped as `solve-error`
with its traceback logged.

The predicted rank always runs `ranking.rank_pool`, as the reference's
does, also when the real rank cycle runs the columnar path: the two break
equal-DRU ties across users in different orders, so with several users
the commit's window check drops most speculations as `queue-shifted`
(the reference's behaviour, reproduced).

Group-member completions are never assumed, and a pool's speculation is
skipped while the predictor is cold for its running work.
"""
from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from cook_tpu_torch.cluster.base import safe_pool_offers
from cook_tpu_torch.models.entities import Resources
from cook_tpu_torch.models.store import Event, JobStore
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.scheduler.encode_cache import offers_fingerprint
from cook_tpu_torch.scheduler.flight_recorder import NULL_CYCLE
from cook_tpu_torch.scheduler.matcher import (
    dispatch_pool_solve,
    job_mem_with_overhead,
    prepare_pool_problem,
    select_considerable,
)
from cook_tpu_torch.scheduler.ranking import rank_pool
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)

# drop reasons (CycleRecord.speculation_drop and the speculation.dropped
# metric's reason label)
DROP_EPOCH_STALE = "epoch-stale"          # an unexpected store mutation
DROP_PREDICTION_MISS = "prediction-miss"  # an assumed completion never landed
DROP_OFFERS_CHANGED = "offers-changed"    # offer structure shifted (no event)
DROP_QUEUE_SHIFTED = "queue-shifted"      # fresh considerable window differs
DROP_PREDICTOR_COLD = "predictor-cold"    # no estimate for the running work
DROP_DISABLED = "disabled"                # runtime kill-switch off
DROP_SOLVE_ERROR = "solve-error"          # the speculative solve raised

# the phases whose sum is a cycle's start-to-first-launch latency (the
# metric speculation exists to lower).  `rank` is excluded: it runs
# identically whether or not the cycle was served speculatively.
PRE_LAUNCH_PHASES = ("tensor_build", "dispatch", "solve",
                     "speculation_commit")


def pre_launch_ms(record: dict) -> float:
    """Cycle-start-to-first-launch latency of one CycleRecord JSON dict
    in milliseconds."""
    phases = record.get("phases", {})
    return sum(phases.get(name, 0.0) for name in PRE_LAUNCH_PHASES) * 1000.0


def command_fingerprint(command: str) -> str:
    """Stable, bounded key for a job command: the leading token (the
    program) plus a short digest of the full line, so `train.py --lr=3e-4`
    and `train.py --lr=1e-3` share history while arbitrary commands can't
    grow unbounded key material."""
    tokens = (command or "").split(None, 1)
    head = tokens[0][:48] if tokens else ""  # whitespace-only commands
    digest = hashlib.sha1((command or "").encode()).hexdigest()[:8]
    return f"{head}#{digest}"


class QuantileRuntimePredictor:
    """Per-(user, command-fingerprint) rolling-quantile runtime estimator.

    Rolling window of the newest `window` observed runtimes per key; the
    estimate is the `quantile`-th percentile (default p75: over-predicting
    a completion's lateness costs a dropped speculation, under-predicting
    costs nothing, so lean late).  Cold start: no estimate until
    `min_samples` observations.  LRU-bounded at `max_keys`.  Thread-safe:
    observations arrive on store-watcher threads while the scheduler
    thread reads estimates.
    """

    def __init__(self, *, quantile: float = 0.75, window: int = 64,
                 min_samples: int = 3, max_keys: int = 50_000):
        if not 0.0 < quantile <= 1.0:
            raise ValueError(f"bad predictor quantile {quantile}")
        self.quantile = quantile
        self.window = window
        self.min_samples = max(1, min_samples)
        self.max_keys = max_keys
        self._lock = threading.Lock()
        self._samples: collections.OrderedDict[tuple, collections.deque] = \
            collections.OrderedDict()
        self._observations = 0
        self._store: Optional[JobStore] = None
        self._obs_counter = global_registry.counter(
            "prediction.observations",
            "instance runtimes observed into the runtime predictor")
        self._est_counter = global_registry.counter(
            "prediction.estimates",
            "runtime-estimate lookups, by result (hit = enough samples, "
            "cold = below min_samples)")
        self._keys_gauge = global_registry.gauge(
            "prediction.keys",
            "distinct (user, command-fingerprint) keys the runtime "
            "predictor currently tracks")

    # ------------------------------------------------------------- feeding

    def attach(self, store: JobStore) -> "QuantileRuntimePredictor":
        """Subscribe to the store's event feed: every successful terminal
        instance feeds its observed runtime."""
        self._store = store
        store.add_watcher(self._on_event)
        return self

    def _on_event(self, event: Event) -> None:
        if event.kind != "instance/status" \
                or event.data.get("status") != "success":
            return
        store = self._store
        if store is None:
            return
        inst = (event.entities or {}).get("instance") \
            or store.instances.get(event.data.get("task_id"))
        if inst is None or inst.end_time_ms <= inst.start_time_ms:
            return
        job = store.jobs.get(inst.job_uuid)
        if job is None:
            return
        self.observe(job.user, job.command,
                     inst.end_time_ms - inst.start_time_ms)

    def observe(self, user: str, command: str, runtime_ms: float) -> None:
        if runtime_ms <= 0:
            return
        key = (user, command_fingerprint(command))
        with self._lock:
            samples = self._samples.get(key)
            if samples is None:
                samples = collections.deque(maxlen=self.window)
                self._samples[key] = samples
            samples.append(float(runtime_ms))
            self._samples.move_to_end(key)
            while len(self._samples) > self.max_keys:
                self._samples.popitem(last=False)
            self._observations += 1
            n_keys = len(self._samples)
        self._obs_counter.inc(1)
        self._keys_gauge.set(n_keys)

    # ------------------------------------------------------------ estimates

    def predict_runtime_ms(self, user: str, command: str,
                           *, quantile: Optional[float] = None
                           ) -> Optional[float]:
        """The key's rolling `quantile` runtime estimate, or None while
        cold (fewer than `min_samples` observations)."""
        key = (user, command_fingerprint(command))
        with self._lock:
            samples = self._samples.get(key)
            if samples is None or len(samples) < self.min_samples:
                self._est_counter.inc(1, {"result": "cold"})
                return None
            values = list(samples)
        self._est_counter.inc(1, {"result": "hit"})
        return float(np.quantile(np.asarray(values),
                                 quantile if quantile is not None
                                 else self.quantile))

    def stats_json(self) -> dict:
        with self._lock:
            return {
                "kind": "quantile",
                "quantile": self.quantile,
                "window": self.window,
                "min_samples": self.min_samples,
                "keys": len(self._samples),
                "observations": self._observations,
            }


# --------------------------------------------------------------- the guard


@dataclass
class _GuardToken:
    pool: str = ""
    expected: dict = field(default_factory=dict)  # key -> confirmed bool
    stale: bool = False
    stale_kind: str = ""


def _event_key(event: Event) -> tuple:
    """The guard's event algebra: (kind, id, qualifier) — precise enough
    that a predicted completion's success is distinguishable from the
    same task failing."""
    kind = event.kind
    if kind == "instance/status":
        return (kind, event.data.get("task_id"), event.data.get("status"))
    if kind == "job/state":
        return (kind, event.data.get("uuid"), event.data.get("state"))
    return (kind, event.data.get("uuid") or event.data.get("task_id"), "")


class SpeculationGuard:
    """Store-event epoch for speculative solves.

    `begin(pool)` opens a token BEFORE the speculative dispatch reads any
    store state; every event from then on either matches one of the
    token's registered expected keys (confirming a prediction) or marks
    the token stale.  `expect()` registers the keys once the dispatch has
    decided its assumptions — events landing between begin and expect
    count as stale.  `finish()` answers (committable, drop_reason) and
    retires the token.  Each event costs one dict lookup per open token
    (at most one a pool), so a wave of completions stays O(1) an event.

    POOL SCOPING: every match input is pool-local, so a job/instance event
    attributable to ANOTHER pool is ignored rather than vetoing.  Only the
    four job-lifecycle kinds whose pool is derivable are scoped
    (instance/status, instance/created, job/state, job/created);
    everything with cross-pool reach (quota / share / config / pool
    mutations, pool moves, group events) stays global and vetoes every
    in-flight token.
    """

    def __init__(self, store: Optional[JobStore] = None):
        self._lock = threading.Lock()
        self._store = store
        self._tokens: dict[int, _GuardToken] = {}
        self._ids = itertools.count(1)
        if store is not None:
            store.add_watcher(self._on_event)

    def begin(self, pool: str = "") -> int:
        with self._lock:
            token = next(self._ids)
            self._tokens[token] = _GuardToken(pool=pool)
            return token

    def _event_pool(self, event: Event) -> Optional[str]:
        """The pool an event is attributable to, or None (= global: the
        event vetoes every token)."""
        kind = event.kind
        if kind == "job/created":
            return event.data.get("pool") or None
        if kind in ("instance/status", "instance/created"):
            job_uuid = event.data.get("job")
        elif kind == "job/state":
            job_uuid = event.data.get("uuid")
        else:
            return None
        job = (event.entities or {}).get("job")
        if job is None and self._store is not None and job_uuid:
            # watchers run on the mutating thread under the store's
            # reentrant lock, so this read is safe
            job = self._store.jobs.get(job_uuid)
        return getattr(job, "pool", None)

    def expect(self, token: int, keys: Sequence[tuple]) -> None:
        with self._lock:
            state = self._tokens.get(token)
            if state is not None:
                for key in keys:
                    state.expected.setdefault(key, False)

    def cancel(self, token: int) -> None:
        with self._lock:
            self._tokens.pop(token, None)

    def finish(self, token: int) -> tuple[bool, str]:
        """(committable, drop_reason); retires the token.  Committable
        means: no unexpected mutation landed AND every expected event was
        observed — the store state now equals the state the speculation
        assumed."""
        with self._lock:
            state = self._tokens.pop(token, None)
        if state is None:
            return False, DROP_EPOCH_STALE
        if state.stale:
            return False, DROP_EPOCH_STALE
        if not all(state.expected.values()):
            return False, DROP_PREDICTION_MISS
        return True, ""

    def _on_event(self, event: Event) -> None:
        key = _event_key(event)
        event_pool = self._event_pool(event)
        with self._lock:
            for state in self._tokens.values():
                if key in state.expected:
                    state.expected[key] = True
                elif event_pool is not None and state.pool \
                        and event_pool != state.pool:
                    continue  # another pool's lifecycle event: pool-local
                    # inputs are untouched, the token stays committable
                elif not state.stale:
                    state.stale = True
                    state.stale_kind = event.kind


# ------------------------------------------------- predicted state facades


@dataclass(frozen=True)
class PredictedCompletion:
    """One running instance the predictor expects to finish inside the
    speculation horizon."""

    task_id: str
    job_uuid: str
    hostname: str
    cluster: str
    freed: tuple            # (mem, cpus, gpus, disk) returning to the host
    predicted_end_ms: float


class PredictedStoreView:
    """Read-only store facade with the assumed-complete instances (and
    their then-finished jobs) removed — the state the pool will be in if
    the predictions land.  Only the read surfaces the rank / considerable
    selection touch are overridden; everything else delegates."""

    def __init__(self, store: JobStore,
                 assumed: Sequence[PredictedCompletion]):
        self._store = store
        self._tasks = {a.task_id for a in assumed}
        self._done_jobs = {a.job_uuid for a in assumed}

    def __getattr__(self, name):
        return getattr(self._store, name)

    def running_jobs(self, pool: str):
        return [j for j in self._store.running_jobs(pool)
                if j.uuid not in self._done_jobs]

    def running_instances(self, pool: str):
        return [i for i in self._store.running_instances(pool)
                if i.task_id not in self._tasks]

    def job_instances(self, job_uuid: str):
        return [i for i in self._store.job_instances(job_uuid)
                if i.task_id not in self._tasks]

    def user_usage(self, pool: str):
        usage: dict[str, Resources] = {}
        for job in self.running_jobs(pool):
            usage[job.user] = usage.get(job.user, Resources()) + job.resources
        return usage


class _PredictedCluster:
    """Cluster facade whose offers fold assumed-freed capacity back into
    the freeing host's row.  Everything except the offer scan delegates to
    the real cluster."""

    def __init__(self, cluster, freed_by_host: dict):
        self._cluster = cluster
        self._freed = freed_by_host  # hostname -> [mem, cpus, gpus, disk]

    def __getattr__(self, name):
        return getattr(self._cluster, name)

    def pending_offers(self, pool: str):
        offers = self._cluster.pending_offers(pool)
        if not self._freed:
            return offers
        out = []
        for offer in offers:
            freed = self._freed.get(offer.hostname)
            if freed is None:
                out.append(offer)
            else:
                out.append(dataclasses.replace(
                    offer,
                    mem=offer.mem + freed[0],
                    cpus=offer.cpus + freed[1],
                    gpus=offer.gpus + freed[2],
                    disk=offer.disk + freed[3],
                ))
        return out


# ------------------------------------------------------------ the speculator


@dataclass
class SpeculativeSolve:
    """One in-flight speculation: the predicted prepare + dispatched solve
    and everything the commit rule validates against."""

    pool: str
    prepared: object                   # matcher.PreparedPool
    pending: object                    # PendingResult / HierarchicalPending
    token: int
    assumed: list
    encode_epoch: int
    offers_fp: int
    considerable_uuids: list[str]
    t_dispatch: float = 0.0
    # device-resident state generation at dispatch (device_state.py): a
    # bump between dispatch and commit means the speculative problem was
    # built from dropped resident tensors — the commit must not trust it
    resident_epoch: int = 0


@dataclass
class CommitResult:
    """Outcome of one cycle's commit attempt."""

    status: str                        # "hit" | "dropped" | "none"
    reason: str = ""                   # drop/skip reason ("" when hit/none)
    prepared: object = None
    assignment: Optional[np.ndarray] = None

    @property
    def ok(self) -> bool:
        return self.status == "hit"


class CycleSpeculator:
    """Owns the per-pool speculative pipeline: dispatch at cycle N's end,
    commit-or-drop at cycle N+1's start (see the module docstring for the
    commit rule).  Speculative problems are built and solved on `device`
    (the scheduler's), on its current stream: later cycles' work queues
    behind the solve, so the commit's fetch reads finished buffers."""

    def __init__(self, store: JobStore, clusters, predictor, *,
                 device: torch.device, horizon_ms: float = 30_000.0,
                 encode_cache=None, device_state=None):
        self.store = store
        self.clusters = clusters      # live reference
        self.predictor = predictor
        self.device = device
        self.horizon_ms = float(horizon_ms)
        self.encode_cache = encode_cache
        self.device_state = device_state
        self.enabled = True           # runtime kill-switch
        self._match_config = None     # last dispatch's MatchConfig
        self.guard = SpeculationGuard(store)
        self._lock = threading.Lock()
        self._inflight: dict[str, SpeculativeSolve] = {}
        # why the NEXT commit attempt will find nothing in flight
        # (predictor-cold etc.), keyed by pool
        self._skip_reason: dict[str, str] = {}
        self._hits = 0
        self._dropped = 0
        self._dispatched = 0
        self._drop_reasons: collections.Counter = collections.Counter()
        self._dispatch_counter = global_registry.counter(
            "speculation.dispatched",
            "speculative next-cycle solves dispatched while the previous "
            "cycle drained, per pool")
        self._hit_counter = global_registry.counter(
            "speculation.hits",
            "match cycles served from a committed speculative solve, "
            "per pool")
        self._drop_counter = global_registry.counter(
            "speculation.dropped",
            "speculative solves dropped instead of committed, per "
            "pool/reason (epoch-stale = a store mutation invalidated the "
            "stamped state; never repaired)")

    # ------------------------------------------------------------- dispatch

    def predicted_completions(self, pool_name: str,
                              now_ms: int) -> tuple[list, bool]:
        """(assumed completions inside the horizon, saw_cold).  Group
        members are never assumed — their completion changes sibling
        feasibility context outside the guard's event algebra."""
        assumed: list[PredictedCompletion] = []
        saw_cold = False
        for inst in self.store.running_instances(pool_name):
            job = self.store.jobs.get(inst.job_uuid)
            if job is None or job.group_uuid:
                continue
            estimate = self.predictor.predict_runtime_ms(job.user,
                                                         job.command)
            if estimate is None:
                saw_cold = True
                continue
            eta = inst.start_time_ms + estimate
            if eta <= now_ms + self.horizon_ms:
                r = job.resources
                assumed.append(PredictedCompletion(
                    task_id=inst.task_id,
                    job_uuid=inst.job_uuid,
                    hostname=inst.hostname,
                    cluster=inst.compute_cluster,
                    freed=(job_mem_with_overhead(job, self._match_config),
                           r.cpus, r.gpus, r.disk),
                    predicted_end_ms=eta,
                ))
        return assumed, saw_cold

    def dispatch(self, pool, config, state, *,
                 launch_filter=None, host_reservations=None,
                 host_attrs=None, offensive_job_filter=None,
                 predictor_for_rank=None, backfill_weight: float = 0.0,
                 backfill_norm_ms: float = 600_000.0) -> bool:
        """Speculatively prepare + dispatch `pool`'s NEXT match solve
        against the predicted offer set.  Called at the end of cycle N,
        after its launches (and their store events) have landed.  Returns
        True when a speculation is now in flight."""
        name = pool.name
        self._cancel_inflight(name)
        if not self.enabled:
            self._skip_reason[name] = DROP_DISABLED
            return False
        if config.completion_multiplier > 0 and config.host_lifetime_mins > 0:
            # the estimated-completion constraint makes feasibility rows
            # clock- and predictor-state-dependent: a fresh solve at cycle
            # N+1 would encode them against a LATER now_ms, so the commit
            # rule's exact-parity claim cannot hold — never speculate
            # while the constraint is active
            self._skip_reason[name] = ""
            return False
        self._match_config = config
        now_ms = self.store.clock()
        # the guard token opens BEFORE any store read below: a mutation
        # racing the dispatch marks it stale (conservatively dropped)
        token = self.guard.begin(name)
        try:
            assumed, saw_cold = self.predicted_completions(name, now_ms)
            if not assumed:
                self.guard.cancel(token)
                self._skip_reason[name] = (DROP_PREDICTOR_COLD if saw_cold
                                           else "")
                return False
            expected = []
            for a in assumed:
                expected.append(("instance/status", a.task_id, "success"))
                expected.append(("job/state", a.job_uuid, "completed"))
            self.guard.expect(token, expected)
            view = PredictedStoreView(self.store, assumed)
            freed_by_cluster: dict[str, dict] = {}
            for a in assumed:
                hosts = freed_by_cluster.setdefault(a.cluster, {})
                slot = hosts.setdefault(a.hostname, [0.0, 0.0, 0.0, 0.0])
                for i in range(4):
                    slot[i] += a.freed[i]
            pclusters = [
                _PredictedCluster(c, freed_by_cluster.get(c.name, {}))
                for c in self.clusters
            ]
            # the predicted rank must mirror the real rank cycle's scoring
            # (same backfill term, same filter) or the commit-time window
            # check can never pass; it runs rank_pool as the reference's
            # does (see the module docstring on the columnar tie order)
            queue = rank_pool(view, pool, device=self.device,
                              offensive_job_filter=offensive_job_filter,
                              predictor=predictor_for_rank,
                              backfill_weight=backfill_weight,
                              backfill_norm_ms=backfill_norm_ms)
            if not queue.jobs:
                self.guard.cancel(token)
                self._skip_reason[name] = ""
                return False
            prepared = prepare_pool_problem(
                view, pool, queue, pclusters, config, state,
                device=self.device,
                launch_filter=launch_filter,
                host_reservations=host_reservations,
                host_attrs=host_attrs, flight=NULL_CYCLE,
                encode_cache=self.encode_cache,
                predictor=self.predictor,
                device_state=self.device_state,
            )
            if not prepared.solvable:
                self.guard.cancel(token)
                self._skip_reason[name] = ""
                return False
            pending = dispatch_pool_solve(prepared, config, telemetry=None)
        except Exception:  # noqa: BLE001 — speculation must never take
            # the real cycle down; the next cycle solves fresh on the same
            # device
            log.exception("speculative dispatch failed (pool %s)", name)
            self.guard.cancel(token)
            self._skip_reason[name] = DROP_SOLVE_ERROR
            return False
        spec = SpeculativeSolve(
            pool=name, prepared=prepared, pending=pending, token=token,
            assumed=assumed,
            encode_epoch=(self.encode_cache.epoch
                          if self.encode_cache is not None else 0),
            offers_fp=offers_fingerprint(prepared.cluster_offers),
            considerable_uuids=[j.uuid for j in prepared.considerable],
            t_dispatch=time.perf_counter(),
            resident_epoch=(self.device_state.epoch
                            if self.device_state is not None else 0),
        )
        with self._lock:
            self._inflight[name] = spec
            self._skip_reason.pop(name, None)
            self._dispatched += 1
        self._dispatch_counter.inc(1, {"pool": name})
        return True

    def _cancel_inflight(self, pool_name: str) -> None:
        with self._lock:
            stale = self._inflight.pop(pool_name, None)
        if stale is not None:
            self.guard.cancel(stale.token)

    # --------------------------------------------------------------- commit

    def try_commit(self, pool, queue, state, config,
                   *, launch_filter=None) -> CommitResult:
        """Commit-or-drop the pool's in-flight speculation at cycle N+1
        start.  `queue` is the REAL just-ranked queue; `state` the pool's
        match state.  On "hit" the caller finalizes `prepared` +
        `assignment` directly — tensor_build and the solve already
        happened during cycle N's drain."""
        name = pool.name
        with self._lock:
            spec = self._inflight.pop(name, None)
            skip = self._skip_reason.pop(name, "")
        if spec is None:
            return CommitResult(status="none", reason=skip)
        if not self.enabled:
            self.guard.cancel(spec.token)
            return self._drop(name, DROP_DISABLED)
        committable, reason = self.guard.finish(spec.token)
        if not committable:
            return self._drop(name, reason)
        if self.encode_cache is not None \
                and self.encode_cache.epoch != spec.encode_epoch:
            return self._drop(name, DROP_EPOCH_STALE)
        if self.device_state is not None \
                and self.device_state.epoch != spec.resident_epoch:
            # the resident mirror was invalidated while this solve was
            # in flight: its tensors were built from dropped state
            return self._drop(name, DROP_EPOCH_STALE)
        # offer STRUCTURE must be unchanged (hosts come and go without
        # store events; spare amounts are covered by the guard — only
        # confirmed completions may have moved them)
        current_offers = []
        for cluster in self.clusters:
            if not cluster.accepts_work:
                continue
            offers = safe_pool_offers(cluster, name)
            for offer in offers or ():
                current_offers.append((cluster, offer))
        if offers_fingerprint(current_offers) != spec.offers_fp:
            return self._drop(name, DROP_OFFERS_CHANGED)
        # the fresh considerable window (real queue, live quota budgets)
        # must be the speculative one exactly
        fresh = select_considerable(self.store, pool, queue,
                                    state.num_considerable,
                                    launch_filter=launch_filter)
        if [j.uuid for j in fresh] != spec.considerable_uuids:
            return self._drop(name, DROP_QUEUE_SHIFTED)
        try:
            # a hit's ONLY transfer this cycle: the pre-solved
            # assignment's fetch (on the hierarchical route the two-level
            # solve itself runs here, at fetch, as in the reference)
            with data_plane.family(data_plane.FAM_SOLVE):
                assignment = np.asarray(spec.pending.fetch())
        except Exception:  # noqa: BLE001 — a deferred device error
            # surfaces at the speculative fetch; the cycle solves fresh
            log.exception("speculative solve failed at fetch (pool %s)",
                          name)
            return self._drop(name, DROP_SOLVE_ERROR)
        with self._lock:
            self._hits += 1
        self._hit_counter.inc(1, {"pool": name})
        return CommitResult(status="hit", prepared=spec.prepared,
                            assignment=assignment)

    def _drop(self, pool_name: str, reason: str) -> CommitResult:
        with self._lock:
            self._dropped += 1
            self._drop_reasons[reason] += 1
        self._drop_counter.inc(1, {"pool": pool_name, "reason": reason})
        return CommitResult(status="dropped", reason=reason)

    # ---------------------------------------------------------------- stats

    def stats_json(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled,
                "horizon_ms": self.horizon_ms,
                "inflight": sorted(self._inflight),
                "dispatched": self._dispatched,
                "hits": self._hits,
                "dropped": self._dropped,
                "drop_reasons": dict(self._drop_reasons),
            }
