"""Lightweight tracing spans around cycle phases.

A copy of `cook_tpu/utils/tracing.py`, its imports the port's, with
`device_trace` on `torch.profiler` instead of `jax.profiler`.

Reference: opentracing spans around every match-cycle phase
(cook/scheduler/scheduler.clj:626-671 uses
`tracing/with-span`).  Spans record wall durations into the metrics
registry (histogram per span name) and an optional in-memory trace ring for
debugging; `torch.profiler` can be layered on for device-side traces.

Correlation: a thread-local correlation id (the transaction id from the
commit pipeline, i.e. the client's `X-Cook-Txn-Id`) tags every span opened
while it is set, so the span ring links a mutation's spans — REST commit,
txn apply, store ops — back to the transaction.  The correlation tag is
ring-only: it is excluded from metric labels (an unbounded-cardinality
label would explode the registry).
"""
from __future__ import annotations

import collections
import threading
import time
from contextlib import contextmanager
from typing import Optional

from cook_tpu_torch.utils.metrics import global_registry

_trace_ring: collections.deque = collections.deque(maxlen=4096)
_lock = threading.Lock()
_active: dict[int, list[str]] = {}
_correlation = threading.local()

# tags that carry per-request identity: kept in the trace ring, stripped
# from metric labels (label cardinality must stay bounded).  "process" is
# the cross-process track tag (obs/distributed.py): it identifies which
# fleet member recorded the span, which the merged-trace export needs but
# a metric label does not (the registry is already per-process).
_RING_ONLY_TAGS = ("txn_id", "error", "process")


def set_correlation(txn_id: Optional[str]) -> Optional[str]:
    """Set the current thread's correlation id; returns the previous one
    so nested scopes can restore it."""
    prev = getattr(_correlation, "txn_id", None)
    _correlation.txn_id = txn_id
    return prev


def current_correlation() -> Optional[str]:
    return getattr(_correlation, "txn_id", None)


@contextmanager
def correlate(txn_id: Optional[str]):
    """Scope a correlation id: every span opened inside carries it."""
    prev = set_correlation(txn_id)
    try:
        yield
    finally:
        set_correlation(prev)


@contextmanager
def span(name: str, parent: Optional[str] = None, **tags):
    """with span("match_cycle", pool="default"): ...

    `parent` overrides the thread-local stack-derived parent — the
    cross-process case, where the causal parent arrived in an
    `X-Cook-Parent-Span` header rather than on this thread's stack."""
    tid = threading.get_ident()
    with _lock:
        stack = _active.setdefault(tid, [])
        if parent is None:
            parent = stack[-1] if stack else None
        stack.append(name)
    corr = current_correlation()
    if corr is not None and "txn_id" not in tags:
        tags["txn_id"] = corr
    error = False
    t0 = time.perf_counter()
    try:
        yield
    except BaseException:
        error = True
        raise
    finally:
        duration = time.perf_counter() - t0
        if error:
            tags["error"] = True
        thread_name = threading.current_thread().name
        with _lock:
            stack = _active.get(tid)
            if stack:
                stack.pop()
                if not stack:
                    # drop the empty entry: a pool of short-lived threads
                    # would otherwise leak one dict slot per thread forever
                    del _active[tid]
            _trace_ring.append({
                "name": name,
                "parent": parent,
                "duration_s": duration,
                "tags": tags,
                "t": time.time(),
                # thread identity for the chrome-trace export's tracks
                "tid": tid,
                "thread": thread_name,
            })
        metric_tags = {k: v for k, v in tags.items()
                       if k not in _RING_ONLY_TAGS}
        global_registry.histogram(
            f"span.{name}", "wall seconds of the traced section").observe(
            duration, labels=metric_tags or None
        )


def record_span(name: str, duration_s: float, *,
                parent: Optional[str] = None,
                t: Optional[float] = None, **tags) -> None:
    """Append an already-completed span to the ring and observe its
    histogram, WITHOUT touching the per-thread `_active` stack.

    This is the async-safe recorder: the front end's aiohttp handlers
    interleave many requests on one event-loop thread, so the LIFO
    stack discipline `span()` relies on would mis-pair parents there.
    Callers measure the wall themselves and record the finished span
    with an explicit parent."""
    corr = current_correlation()
    if corr is not None and "txn_id" not in tags:
        tags["txn_id"] = corr
    with _lock:
        _trace_ring.append({
            "name": name,
            "parent": parent,
            "duration_s": duration_s,
            "tags": tags,
            "t": t if t is not None else time.time(),
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
        })
    metric_tags = {k: v for k, v in tags.items()
                   if k not in _RING_ONLY_TAGS}
    global_registry.histogram(
        f"span.{name}", "wall seconds of the traced section").observe(
        duration_s, labels=metric_tags or None
    )


def spans_for_txn(txn_id: str, limit: Optional[int] = None) -> list[dict]:
    """Slice the ring by correlation id (the `txn_id` tag) — the
    per-process half of the federated `GET /debug/trace?txn_id=`."""
    with _lock:
        entries = [e for e in _trace_ring
                   if (e.get("tags") or {}).get("txn_id") == txn_id]
    return entries[-limit:] if limit else entries


def record_event(name: str, **tags) -> None:
    """Append a zero-duration marker to the trace ring WITHOUT touching
    the metrics registry — for correlation points (e.g. a replication
    ack) where a duration histogram would be meaningless noise."""
    corr = current_correlation()
    if corr is not None and "txn_id" not in tags:
        tags["txn_id"] = corr
    with _lock:
        _trace_ring.append({
            "name": name,
            "parent": None,
            "duration_s": 0.0,
            "tags": tags,
            "t": time.time(),
            "tid": threading.get_ident(),
            "thread": threading.current_thread().name,
        })


def ring_capacity() -> int:
    return _trace_ring.maxlen


def recent_spans(limit: int = 100) -> list[dict]:
    with _lock:
        return list(_trace_ring)[-limit:]


def active_thread_count() -> int:
    """Threads currently holding an open span (observability for the
    leak regression test)."""
    with _lock:
        return len(_active)


# ------------------------------------------------------- chrome-trace export
# Perfetto/chrome://tracing-compatible rendering of the span ring
# (GET /debug/trace?format=chrome, sim run --trace-out, incident bundles).
# Tracks: every span lands on its host thread's track (pid 1, one tid per
# thread); spans tagged with a pool additionally land on that pool's
# track (pid 2) so per-pool cycle phases read as one lane regardless of
# which scheduler/launcher thread executed them.  txn_id and every other
# ring tag ride in `args`, so a mutation's spans stay correlatable after
# export.

_THREAD_PID = 1
_POOL_PID = 2


def chrome_trace(spans: Optional[list] = None,
                 limit: Optional[int] = None) -> dict:
    """Render ring entries (newest `limit`, default the whole ring) as a
    Chrome Trace Event Format object: {"traceEvents": [...]}.  Complete
    spans become "X" (duration) events, zero-duration markers
    (record_event) become "i" (instant) events."""
    if spans is None:
        spans = recent_spans(limit or ring_capacity())
    events: list[dict] = []
    track_tids: dict[tuple, int] = {}

    def track(pid: int, name: str) -> int:
        key = (pid, name)
        tid = track_tids.get(key)
        if tid is None:
            tid = len(track_tids) + 1
            track_tids[key] = tid
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        return tid

    for pid, pname in ((_THREAD_PID, "host threads"), (_POOL_PID, "pools")):
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": pname}})
    for entry in spans:
        tags = entry.get("tags") or {}
        args = dict(tags)
        if entry.get("parent"):
            args["parent"] = entry["parent"]
        duration_us = entry.get("duration_s", 0.0) * 1e6
        start_us = entry.get("t", 0.0) * 1e6 - duration_us
        base = {"name": entry.get("name", "?"), "cat": "span",
                "ts": start_us, "args": args}
        if duration_us > 0:
            base.update({"ph": "X", "dur": duration_us})
        else:
            base.update({"ph": "i", "s": "t"})
        thread = entry.get("thread") or f"thread-{entry.get('tid', 0)}"
        events.append({**base, "pid": _THREAD_PID,
                       "tid": track(_THREAD_PID, thread)})
        pool = tags.get("pool")
        if pool:
            events.append({**base, "pid": _POOL_PID,
                           "tid": track(_POOL_PID, f"pool:{pool}")})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


@contextmanager
def device_trace(log_dir: str):
    """Capture a device-side profile of the wrapped section with
    `torch.profiler` (host and CUDA activities; the CUDA one only where a
    card is present) and write it to `log_dir` as a chrome trace
    (`device_trace.json`, Perfetto-loadable).  Layered over `span` for
    end-to-end cycle investigations on real hardware."""
    import os

    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "device_trace.json"))
