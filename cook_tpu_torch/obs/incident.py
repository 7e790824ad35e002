"""Incident observatory: evidence capture at the moment health degrades.

A copy of `cook_tpu/obs/incident.py` (jax-free), its imports the port's;
the `trace` collector reads the port's `utils/tracing` span ring and the
`faults` one its armed schedule.  The REST routes that serve the bundles
and timelines (`/debug/incidents`, `/jobs/{uuid}/timeline`) wait for the
port's service surface.

The flight recorder, device telemetry and contention burn rates are the
*detection* layers, and breakers and shedding the *reaction*
ones.  This module is the *diagnosis* layer: when the
health verdict transitions ok → degraded, the evidence an operator needs
— the verdict itself, the contention snapshot, the last cycle records,
the span ring, the armed fault schedule, optionally a device profile —
is volatile ring state that will have rolled over by the time a human
looks.  `IncidentRecorder` snapshots it all into one bounded-retention
bundle at the transition, served at `GET /debug/incidents[/{id}]` and
optionally persisted under an `incidents/` directory.

Also here: `job_timeline`, the per-job lifecycle reconstruction behind
`GET /jobs/{uuid}/timeline` — txn/cycle/launch/preemption history
stitched into one causally-ordered story with waiting-time attribution
("12 cycles skipped: insufficient-resources").  Per-job lifecycle
histories are exactly what prediction-assisted scheduling needs as
training input (arXiv:2501.05563), and per-cycle wait/placement
attribution is the Aryl-style (arXiv:2202.07896) operability story.

Import discipline: stdlib + utils + models only — the REST layer and the
control-plane nodes import this module.
"""
from __future__ import annotations

import collections
import itertools
import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)


class IncidentRecorder:
    """Bounded ring of incident bundles, captured on ok → degraded
    health transitions (plus manual captures).

    `observe(verdict)` is the single entry point: every producer of a
    health verdict (the REST /debug/health handler, the health-watch
    trigger loop, `DeviceTelemetry.health()`) reports through it; the
    recorder tracks the previous status and captures exactly at the
    ok → degraded edge, cooldown-rate-limited so a flapping verdict
    cannot flood the retention window.  Recovery (degraded → ok) stamps
    the newest bundle's `recovered_time`, closing the incident.

    Evidence comes from named collectors (`add_collector`) so the
    recorder stays decoupled from its sources: the scheduler contributes
    cycle records + span ring + armed faults, the REST layer contributes
    the contention snapshot, and a collector raising degrades to an
    error note inside the bundle rather than losing the capture.
    """

    def __init__(self, *, capacity: int = 32, cooldown_s: float = 30.0,
                 dir: Optional[str] = None, profiler=None,
                 auto_profile: bool = False,
                 clock: Callable[[], float] = time.time):
        self.capacity = capacity
        self.cooldown_s = cooldown_s
        self.dir = dir or None
        self.profiler = profiler
        self.auto_profile = auto_profile
        self.clock = clock
        self._lock = threading.Lock()
        # resume numbering after any bundles already on disk: ids restart
        # at 1 on every boot otherwise, and the next incident's persist
        # would os.replace a crashed run's bundle of the same id — the
        # exact evidence the directory exists to preserve
        start = 1
        if self.dir:
            try:
                start = 1 + max(
                    (int(name[4:-5]) for name in os.listdir(self.dir)
                     if name.startswith("inc-") and name.endswith(".json")),
                    default=0)
            except (OSError, ValueError):
                pass
        self._ids = itertools.count(start)
        self._bundles: collections.deque = collections.deque(maxlen=capacity)
        self._prev_healthy = True
        self._last_capture = float("-inf")
        # an ok->degraded edge landed inside the cooldown: capture at the
        # first observation after it clears (a sustained incident must
        # not end up with no bundle just because it STARTED too soon
        # after the previous one)
        self._pending_capture = False
        self._collectors: dict[str, Callable[[], object]] = {}
        self._captured = global_registry.counter(
            "incident.captured", "incident bundles captured, per trigger")
        self._suppressed = global_registry.counter(
            "incident.suppressed",
            "ok->degraded transitions whose capture was suppressed by the "
            "cooldown")
        self._open_gauge = global_registry.gauge(
            "incident.open",
            "1 while the last observed health verdict is degraded")
        self._count_gauge = global_registry.gauge(
            "incident.bundles", "incident bundles currently retained")

    def add_collector(self, name: str, fn: Callable[[], object]) -> None:
        self._collectors[name] = fn

    # ------------------------------------------------------------- observe

    def observe(self, verdict: dict) -> Optional[dict]:
        """Report one health verdict; captures and returns a bundle when
        this verdict is the ok → degraded edge (and the cooldown allows),
        else returns None."""
        healthy = bool(verdict.get("healthy", True))
        now = time.monotonic()
        suppressed = False
        recovered = None
        with self._lock:
            was_healthy = self._prev_healthy
            self._prev_healthy = healthy
            capture = False
            if healthy:
                self._pending_capture = False
                if not was_healthy:
                    # stamp recovery INSIDE the transition lock: resolved
                    # outside it, a concurrent degraded-edge observer
                    # could append a fresh open bundle first and this
                    # recovery would stamp the LIVE incident as over
                    for bundle in reversed(self._bundles):
                        if bundle.get("recovered_time") is None:
                            bundle["recovered_time"] = self.clock()
                            recovered = bundle
                            break
            elif now - self._last_capture >= self.cooldown_s:
                if was_healthy or self._pending_capture:
                    self._last_capture = now
                    self._pending_capture = False
                    capture = True
            elif was_healthy:
                # edge inside the cooldown: defer, don't drop
                self._pending_capture = True
                suppressed = True
        self._open_gauge.set(0.0 if healthy else 1.0)
        if healthy:
            if recovered is not None:
                self._persist(recovered)
            return None
        if suppressed:
            self._suppressed.inc()
        if not capture:
            return None
        return self.capture(verdict, trigger="health-transition")

    # ------------------------------------------------------------- capture

    def capture(self, verdict: dict, *, trigger: str = "manual") -> dict:
        """Snapshot a bundle NOW from the current verdict + collectors.
        Collector failures are recorded inside the bundle, not raised —
        a broken evidence source must not lose the incident."""
        with self._lock:
            incident_id = f"inc-{next(self._ids):06d}"
        bundle: dict = {
            "id": incident_id,
            "wall_time": self.clock(),
            "trigger": trigger,
            "reasons": list(verdict.get("reasons", [])),
            "verdict": verdict,
            "recovered_time": None,
        }
        for name, fn in self._collectors.items():
            try:
                bundle[name] = fn()
            except Exception as e:  # noqa: BLE001 — evidence best-effort
                bundle[name] = {"error": f"{type(e).__name__}: {e}"}
        if self.profiler is not None and self.auto_profile \
                and trigger == "health-transition":
            bundle["profile"] = self.profiler.maybe_capture_auto(
                bundle["reasons"])
        with self._lock:
            self._bundles.append(bundle)
            count = len(self._bundles)
        self._captured.inc(1, {"trigger": trigger})
        self._count_gauge.set(count)
        self._persist(bundle)
        return bundle

    # ----------------------------------------------------------- retention

    def _persist(self, bundle: dict) -> None:
        if not self.dir:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            path = os.path.join(self.dir, f"{bundle['id']}.json")
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(bundle, f, indent=1, default=str)
            os.replace(tmp, path)
            retained = sorted(
                n for n in os.listdir(self.dir)
                if n.startswith("inc-") and n.endswith(".json"))
            for name in retained[:-self.capacity]:
                os.unlink(os.path.join(self.dir, name))
        except OSError as e:
            # disk trouble while capturing an incident is itself likely
            # part of the incident: keep the in-memory bundle, say so
            log.warning("incident bundle %s not persisted to %s: %s",
                        bundle.get("id"), self.dir, e)

    # --------------------------------------------------------------- reads

    def bundles(self) -> list[dict]:
        """Newest-last summaries for GET /debug/incidents."""
        with self._lock:
            return [{
                "id": b["id"],
                "wall_time": b["wall_time"],
                "trigger": b["trigger"],
                "reasons": list(b["reasons"]),
                "recovered_time": b.get("recovered_time"),
            } for b in self._bundles]

    def get(self, incident_id: str) -> Optional[dict]:
        with self._lock:
            for bundle in self._bundles:
                if bundle["id"] == incident_id:
                    return bundle
        return None

    def dump(self) -> list[dict]:
        """Every retained bundle, full evidence included (the simulator's
        --incidents-out export)."""
        with self._lock:
            return list(self._bundles)


def add_default_collectors(recorder: IncidentRecorder, *,
                           trace_limit: int = 1024) -> IncidentRecorder:
    """Evidence every node can contribute regardless of role — the
    span-ring chrome trace and the armed fault schedule.  One registration
    site for both the scheduler-owned recorder (scheduler/core.py) and the
    control-plane-only one (rest/api.py), so the bundle schema cannot
    silently diverge between node roles."""
    from cook_tpu_torch.utils import tracing

    recorder.add_collector(
        "trace", lambda: tracing.chrome_trace(limit=trace_limit))

    def _armed_faults():
        from cook_tpu_torch import faults

        active = faults.ACTIVE
        return active.to_dict() if active is not None else None

    recorder.add_collector("faults", _armed_faults)
    return recorder


# ------------------------------------------------------------ job timeline

# flight-recorder codes that read as "still waiting" — runs of these are
# compressed into one waiting event with a cycle count (the attribution
# the timeline exists for)
_MATCHED = "matched"


def job_timeline(store, recorder, job, fairness=None) -> dict:
    """One job's causally-ordered lifecycle: submit, per-cycle rank/skip
    decisions (consecutive same-reason cycles compressed into one event
    with a count), launches, instance terminations (preemptions called
    out), re-queues — plus waiting-time attribution and phase latencies.

    `store` is the JobStore, `recorder` the FlightRecorder (None
    tolerated: the timeline then carries only store-derived events).
    `fairness` is the FairnessObservatory (None tolerated): when its
    preemption ledger knows a killed instance, the bare `preempted`
    event gains the ledger's detail — preemptor user/job, the victim's
    DRU at decision time, and the runtime destroyed.
    Times are store-clock milliseconds throughout (virtual in the
    simulator), the same clock `submit_time_ms` uses."""
    from cook_tpu_torch.models.reasons import REASONS_BY_CODE

    events: list[dict] = [{
        "t_ms": job.submit_time_ms,
        "kind": "submitted",
        "pool": job.pool,
        "user": job.user,
        "priority": job.priority,
    }]

    history = recorder.job_history(job.uuid) if recorder is not None else []
    cycles_by_reason: collections.Counter = collections.Counter()
    run: list[dict] = []

    def flush_run() -> None:
        if not run:
            return
        first, last = run[0], run[-1]
        # the most recent cycle's detail is the live picture (a gang's
        # best-block shortfall shrinks as churn drains)
        detail = last.get("detail") or first.get("detail", "")
        summary = (f"{len(run)} cycle"
                   f"{'s' if len(run) != 1 else ''} skipped: "
                   f"{first['code']}")
        if first["code"] == "gang-incomplete" and detail:
            # surface WHY the gang is holding: "7 cycles skipped:
            # gang-incomplete, best block had 3/8 hosts free"
            summary += f", {detail}"
        event = {
            "t_ms": first.get("t_ms", 0),
            "kind": "waiting",
            "code": first["code"],
            "detail": detail,
            "cycles": len(run),
            "first_cycle": first["cycle"],
            "last_cycle": last["cycle"],
            "summary": summary,
        }
        for key in ("rank", "dru"):
            if last.get(key) is not None:
                event[f"last_{key}"] = last[key]
        events.append(event)
        run.clear()

    for entry in history:
        code = entry.get("code", "")
        # a history entry with no cycle timestamp (async launch-failure
        # noted after its record rolled out) must not sort before the
        # job existed
        if not entry.get("t_ms"):
            entry = {**entry, "t_ms": job.submit_time_ms}
        if code == _MATCHED:
            flush_run()
            event = {
                "t_ms": entry.get("t_ms", 0),
                "kind": "matched",
                "cycle": entry["cycle"],
                "detail": entry.get("detail", ""),
            }
            for key in ("rank", "dru", "host"):
                if entry.get(key) is not None:
                    event[key] = entry[key]
            events.append(event)
            continue
        cycles_by_reason[code] += 1
        if run and run[-1]["code"] != code:
            flush_run()
        run.append(entry)
    flush_run()

    instances = store.job_instances(job.uuid)
    run_ms_total = 0
    first_match_ms: Optional[int] = None
    for index, inst in enumerate(instances):
        if first_match_ms is None or inst.start_time_ms < first_match_ms:
            first_match_ms = inst.start_time_ms
        events.append({
            "t_ms": inst.start_time_ms,
            "kind": "launched",
            "task_id": inst.task_id,
            "host": inst.hostname,
            "cluster": inst.compute_cluster,
        })
        if not inst.status.terminal:
            continue
        run_ms_total += max(0, inst.end_time_ms - inst.start_time_ms)
        reason = REASONS_BY_CODE.get(inst.reason_code) \
            if inst.reason_code is not None else None
        preempted = inst.preempted or (
            reason is not None and "preempted" in reason.name)
        terminal = {
            "t_ms": inst.end_time_ms,
            "kind": ("completed" if inst.status.value == "success"
                     else "preempted" if preempted else "instance-failed"),
            "task_id": inst.task_id,
            "host": inst.hostname,
            "status": inst.status.value,
        }
        if reason is not None:
            terminal["reason"] = reason.name
            terminal["mea_culpa"] = reason.mea_culpa
        if preempted and fairness is not None:
            detail = fairness.victim_detail(inst.task_id)
            if detail is not None:
                terminal["preemption"] = detail
        events.append(terminal)
        # the job re-queued after this attempt died — true for every
        # failed non-final attempt (a later attempt exists), and for a
        # failed final attempt only while the job actually waits (a job
        # whose retries were exhausted, or that was killed, did not).
        # Timestamped at THIS attempt's end: last_waiting_start_time_ms
        # is re-stamped on every re-queue, so using it would time-shift
        # earlier attempts' re-queues onto the newest one.
        requeued = inst.status.value == "failed" and (
            index < len(instances) - 1 or job.state.value == "waiting")
        if requeued:
            events.append({
                "t_ms": inst.end_time_ms,
                "kind": "re-queued",
                "after_task": inst.task_id,
            })

    # stable causal order: same-timestamp ties resolve by event kind —
    # "submitted" first; a termination precedes its re-queue, which
    # precedes the skip cycles it caused; skip cycles precede the match
    # that ended them, which precedes its launch
    kind_order = {"submitted": 0, "completed": 1, "preempted": 1,
                  "instance-failed": 1, "re-queued": 2, "waiting": 3,
                  "matched": 4, "launched": 5}
    indexed = list(enumerate(events))
    indexed.sort(key=lambda pair: (pair[1]["t_ms"],
                                   kind_order.get(pair[1]["kind"], 9),
                                   pair[0]))
    events = [e for _, e in indexed]

    now_ms = store.clock()
    phases: dict = {"run_ms_total": run_ms_total}
    if first_match_ms is not None:
        phases["submit_to_first_match_ms"] = max(
            0, first_match_ms - job.submit_time_ms)
    if job.state.value == "waiting":
        start = job.last_waiting_start_time_ms or job.submit_time_ms
        phases["waiting_ms_current"] = max(0, now_ms - start)
    return {
        "uuid": job.uuid,
        "user": job.user,
        "pool": job.pool,
        "state": job.state.value,
        "priority": job.priority,
        "submit_time_ms": job.submit_time_ms,
        "events": events,
        "waiting": {
            "cycles_by_reason": dict(cycles_by_reason),
            "total_cycles": int(sum(cycles_by_reason.values())),
        },
        "phases": phases,
        "instances": len(instances),
        "wall_time": time.time(),
    }
