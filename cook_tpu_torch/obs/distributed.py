"""Cross-process request-flow observability for the mp runtime.

Port of `cook_tpu/obs/distributed.py`.  Span rings, chrome-trace export,
incident bundles and fleet polls are process-local.  The mp runtime
(`mp/`) spreads one request across a front end, a coordinator
decision write, and N shard-group workers; this module is the glue
that makes that flow readable as ONE artifact:

  * the **header contract** — the front end stamps every forward and
    every `/rpc/*` call with `X-Cook-Txn-Id` (correlation, already the
    idempotency key) plus `X-Cook-Parent-Span` (the causal parent's
    span name), and workers answer with `X-Cook-Hop-Walls` carrying
    their server-side phase walls (`server`, `apply`, `fsync`,
    `replication_ack` seconds);
  * **merged traces** — `merge_process_traces` dedupes the per-process
    ring slices (workers answer `GET /debug/trace?txn_id=`) and
    `merged_chrome_trace` renders them with one pid track per process:
    front end = pid 0, the coordinator's 2PC decision lane = pid 1,
    worker group g = pid g + 2 — so Perfetto shows the true
    cross-process critical path;
  * **per-hop attribution** — `HopAttribution` folds the forward
    round-trip into front-end queue / RPC transport / worker apply /
    fsync / replication-ack reservoirs per group, exported as
    `mp.hop_seconds{hop,group}` and the `/debug/frontend` hop rows;
  * **federated incidents** — `add_mp_collectors` teaches the front
    end's IncidentRecorder to embed the 2PC decision-log tail, breaker
    states, and the route map, so a failover bundle answers "which
    hop, which group, which decision" from one artifact.

Spans carry a ring-only `process` tag (tracing._RING_ONLY_TAGS)
identifying the recording fleet member — in the in-process harness
(MpRuntime(inprocess=True)) every "process" shares one module-global
ring, so the tag, not the ring identity, is what routes a span to its
pid track.  That makes the merge identical for real multi-process and
in-process runs.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Callable, Optional

from cook_tpu_torch.utils.metrics import global_registry

# ------------------------------------------------------- header contract

TXN_HEADER = "X-Cook-Txn-Id"
PARENT_SPAN_HEADER = "X-Cook-Parent-Span"
HOP_WALLS_HEADER = "X-Cook-Hop-Walls"

# process labels -> merged-trace pid tracks
PROCESS_FRONTEND = "frontend"
PROCESS_COORDINATOR = "coordinator"
PID_FRONTEND = 0
PID_COORDINATOR = 1
_PID_WORKER_BASE = 2


def worker_process_label(group: int) -> str:
    return f"worker-g{group}"


def pid_for_process(label: Optional[str]) -> Optional[int]:
    """front end = 0, coordinator decision lane = 1, worker group g =
    g + 2; None for labels the merge must assign dynamically."""
    if label == PROCESS_FRONTEND:
        return PID_FRONTEND
    if label == PROCESS_COORDINATOR:
        return PID_COORDINATOR
    if label and label.startswith("worker-g"):
        try:
            return int(label[len("worker-g"):]) + _PID_WORKER_BASE
        except ValueError:
            return None
    return None


def encode_hop_walls(walls: dict) -> str:
    """`{"apply": 0.0012, ...}` -> `apply=0.001200;...` — one flat
    header value (floats in seconds, 6 decimals keeps microseconds)."""
    return ";".join(f"{k}={float(v):.6f}" for k, v in sorted(walls.items()))


def parse_hop_walls(value: Optional[str]) -> dict[str, float]:
    """Tolerant inverse of `encode_hop_walls` — an unparseable pair is
    dropped, not raised: a malformed header must not fail a forward."""
    walls: dict[str, float] = {}
    for pair in (value or "").split(";"):
        name, sep, raw = pair.partition("=")
        if not sep:
            continue
        try:
            walls[name.strip()] = float(raw)
        except ValueError:
            continue
    return walls


# --------------------------------------------------- per-hop attribution

# the forward hops, in causal order; queue and transport are measured by
# the front end, the rest arrive in the worker's X-Cook-Hop-Walls header
HOPS = ("queue", "transport", "apply", "fsync", "replication_ack")

# sub-ms transport on loopback up to seconds under fsync stalls
_HOP_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, float("inf"))

_RESERVOIR_CAP = 2048


class _HopReservoir:
    """Bounded sample ring with quantile reads (the front end's
    per-group latency reservoir pattern, kept local to avoid an
    obs -> mp import cycle)."""

    def __init__(self, cap: int = _RESERVOIR_CAP):
        self._samples: list[float] = []
        self._cap = cap
        self._next = 0
        self.count = 0

    def add(self, value: float) -> None:
        if len(self._samples) < self._cap:
            self._samples.append(value)
        else:
            self._samples[self._next] = value
            self._next = (self._next + 1) % self._cap
        self.count += 1

    def quantile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        ordered = sorted(self._samples)
        idx = min(len(ordered) - 1, int(q * len(ordered)))
        return ordered[idx]


class HopAttribution:
    """Folds forward round-trips into per-(group, hop) reservoirs and
    the `mp.hop_seconds{hop,group}` histogram feeding tsdb history."""

    def __init__(self):
        self._lock = threading.Lock()
        self._reservoirs: dict[tuple[int, str], _HopReservoir] = {}
        self._hop_seconds = global_registry.histogram(
            "mp.hop_seconds",
            "per-hop split of front-end forward time (front-end queue, "
            "RPC transport, worker apply, fsync, replication-ack), "
            "labeled hop + shard group", buckets=_HOP_BUCKETS)

    def observe(self, group: int, hop: str, seconds: float) -> None:
        seconds = max(0.0, float(seconds))
        with self._lock:
            res = self._reservoirs.get((group, hop))
            if res is None:
                res = self._reservoirs[(group, hop)] = _HopReservoir()
            res.add(seconds)
        self._hop_seconds.observe(
            seconds, {"hop": hop, "group": str(group)})

    def attribute(self, group: int, *, total_s: float, queue_s: float,
                  walls: dict[str, float]) -> None:
        """One forward's split: `total_s` is the front end's round-trip
        wall, `queue_s` the arrival-to-forward-start wait, `walls` the
        worker's decoded X-Cook-Hop-Walls.  transport = round-trip
        minus the worker's total server wall (clamped at 0 — clock
        reads race by design, attribution must never go negative)."""
        self.observe(group, "queue", queue_s)
        server = walls.get("server")
        if server is not None:
            self.observe(group, "transport", max(0.0, total_s - server))
        for hop in ("apply", "fsync", "replication_ack"):
            if hop in walls:
                self.observe(group, hop, walls[hop])

    def snapshot(self, group: int) -> dict:
        """{hop: {p50_ms, p99_ms, count}} for one group's
        /debug/frontend row (only hops that have samples)."""
        with self._lock:
            pairs = [(hop, res) for (g, hop), res
                     in self._reservoirs.items() if g == group]
        return {hop: {"p50_ms": res.quantile(0.5) * 1000.0,
                      "p99_ms": res.quantile(0.99) * 1000.0,
                      "count": res.count}
                for hop, res in pairs}


# ------------------------------------------------------------ trace merge

_collections = global_registry.counter(
    "trace.federated_collections",
    "federated GET /debug/trace?txn_id= merges at the front end, per "
    "outcome (merged = every live group answered, partial = some "
    "group's slice was unreachable, empty = no spans matched)")


def merge_process_traces(sources: list[dict]) -> list[dict]:
    """Merge per-process ring slices into one span list.

    `sources` is `[{"process": label, "spans": [ring entries]}, ...]`.
    Each span's own ring-only `process` tag wins over the source label
    (the in-process harness shares ONE ring across every "process", so
    identical slices come back from every worker and only the tag says
    who recorded what); spans are deduped on (name, t, tid, duration)
    and returned oldest-first with a resolved top-level "process"."""
    seen: set[tuple] = set()
    merged: list[dict] = []
    for source in sources:
        label = source.get("process")
        for entry in source.get("spans") or []:
            tags = entry.get("tags") or {}
            key = (entry.get("name"), entry.get("t"), entry.get("tid"),
                   entry.get("duration_s"))
            if key in seen:
                continue
            seen.add(key)
            resolved = dict(entry)
            resolved["process"] = tags.get("process") or label or "?"
            merged.append(resolved)
    merged.sort(key=lambda e: (e.get("t", 0.0) - e.get("duration_s", 0.0)))
    return merged


def merged_chrome_trace(spans: list[dict]) -> dict:
    """Chrome Trace Event Format over merged spans: one pid per process
    (`pid_for_process`; labels the contract doesn't name get the next
    free pid), one tid lane per source thread inside each process."""
    events: list[dict] = []
    pids: dict[str, int] = {}
    used: set[int] = set()
    track_tids: dict[tuple, int] = {}

    def pid_of(label: str) -> int:
        pid = pids.get(label)
        if pid is None:
            pid = pid_for_process(label)
            if pid is None or pid in used:
                pid = max(used, default=_PID_WORKER_BASE) + 1
            pids[label] = pid
            used.add(pid)
            events.append({"name": "process_name", "ph": "M", "pid": pid,
                           "tid": 0, "args": {"name": label}})
        return pid

    def track(pid: int, name: str) -> int:
        key = (pid, name)
        tid = track_tids.get(key)
        if tid is None:
            tid = sum(1 for (p, _n) in track_tids if p == pid) + 1
            track_tids[key] = tid
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        return tid

    for entry in spans:
        label = entry.get("process") or "?"
        pid = pid_of(label)
        tags = entry.get("tags") or {}
        args = {k: v for k, v in tags.items() if k != "process"}
        if entry.get("parent"):
            args["parent"] = entry["parent"]
        duration_us = entry.get("duration_s", 0.0) * 1e6
        start_us = entry.get("t", 0.0) * 1e6 - duration_us
        thread = entry.get("thread") or f"thread-{entry.get('tid', 0)}"
        base = {"name": entry.get("name", "?"), "cat": "span",
                "ts": start_us, "args": args, "pid": pid,
                "tid": track(pid, thread)}
        if duration_us > 0:
            base.update({"ph": "X", "dur": duration_us})
        else:
            base.update({"ph": "i", "s": "t"})
        events.append(base)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def note_collection(outcome: str) -> None:
    _collections.inc(1, {"outcome": outcome})


# -------------------------------------------------- federated mp incidents

def decision_log_tail(path: Optional[str], limit: int = 64) -> dict:
    """The newest `limit` 2PC decision records plus which txns are
    committed-but-not-done — the slice a federated incident bundle
    embeds so an abort storm or a mid-commit failover is legible
    without shelling into the coordinator's data dir."""
    records: list[dict] = []
    open_txns: dict[str, float] = {}
    if path and os.path.exists(path):
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    break  # torn tail — same rule as DecisionLog
                records.append(record)
                txn_id = record.get("txn_id")
                if record.get("decision") == "commit":
                    open_txns[txn_id] = record.get("t", 0.0)
                elif record.get("decision") == "done":
                    open_txns.pop(txn_id, None)
    return {"path": path, "records": records[-limit:],
            "outstanding": sorted(open_txns)}


def add_mp_collectors(recorder, *, decision_log_path: Optional[str],
                      breakers_fn: Callable[[], dict],
                      route_map_fn: Callable[[], dict]):
    """Register the mp-runtime evidence sources on an IncidentRecorder:
    the decision-log tail, breaker states, and the route map at capture
    time.  One registration site (the front end, `mp/router.py`) so the
    federated bundle schema cannot drift."""
    recorder.add_collector(
        "decision_log", lambda: decision_log_tail(decision_log_path))
    recorder.add_collector("breakers", breakers_fn)
    recorder.add_collector("route_map", route_map_fn)
    return recorder


# -------------------------------------------------------- timeline stitch

def stitch_twopc_events(timeline: dict, record: dict,
                        done_t: Optional[float]) -> dict:
    """Fold a 2PC commit decision into a worker-rendered job timeline:
    the cross-group hop the owning worker cannot see.  Events are
    re-sorted by t_ms (stable — the worker's causal tie-breaks
    survive); the raw decision summary also lands under "twopc"."""
    groups = sorted(int(g) for g in (record.get("groups") or {}))
    txn_id = record.get("txn_id")
    decided_t = record.get("t")
    events = list(timeline.get("events") or [])
    prepare_s = record.get("prepare_s") or {}
    if decided_t is not None:
        events.append({
            "t_ms": int(decided_t * 1000),
            "kind": "2pc-commit-decision", "txn_id": txn_id,
            "groups": groups,
            "prepare_ms": {g: round(float(s) * 1000.0, 3)
                           for g, s in prepare_s.items()}})
    if done_t is not None:
        events.append({"t_ms": int(done_t * 1000), "kind": "2pc-done",
                       "txn_id": txn_id, "groups": groups})
    events.sort(key=lambda e: e.get("t_ms", 0))
    stitched = dict(timeline)
    stitched["events"] = events
    stitched["twopc"] = {
        "txn_id": txn_id, "groups": groups, "op": record.get("op"),
        "decided_t": decided_t, "done_t": done_t,
        "prepare_s": prepare_s}
    return stitched


__all__ = [
    "TXN_HEADER", "PARENT_SPAN_HEADER", "HOP_WALLS_HEADER",
    "PROCESS_FRONTEND", "PROCESS_COORDINATOR", "PID_FRONTEND",
    "PID_COORDINATOR", "worker_process_label", "pid_for_process",
    "encode_hop_walls", "parse_hop_walls", "HOPS", "HopAttribution",
    "merge_process_traces", "merged_chrome_trace", "note_collection",
    "decision_log_tail", "add_mp_collectors", "stitch_twopc_events",
]
