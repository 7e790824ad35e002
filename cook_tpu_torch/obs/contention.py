"""Control-plane contention observatory: where the write path's time goes.

A copy of `cook_tpu/obs/contention.py` (jax-free), its imports the
port's: the store's profiled lock and the journal writer's telemetry
feed it.

ROADMAP item 2 (sharded control plane) starts from a measurement gap:
every mutation serializes through one store lock, one journal fsync
pipeline, one replication stream, and one REST process — but nothing
measured which of those saturates first, so the sharding refactor would
fly blind.  This module instruments every serialization point and
serves it live:

  * `ProfiledRLock` / `LockProfiler` — per-call-site wait and hold
    histograms for the store lock, current-holder + longest-waiter
    gauges, and a windowed contention ratio (`models/store.py` wraps
    its RLock in one; every `with store._lock:` site in the tree gets
    labeled by its calling function automatically).
  * `JournalTelemetry` — append volume/bytes, pending-fsync depth,
    group-fsync batch sizes, and the fsync stall histogram
    (`models/persistence.JournalWriter` reports into the module
    singleton).
  * `EndpointTelemetry` — per-route REST latency / RPS / in-flight /
    error-rate (fed by `rest/api.py`'s outermost middleware).
  * `SloBurnTracker` — fast/slow-window SLO burn-rate evaluation over
    the commit-ack latency stream (`scheduler/monitor.observe_commit_ack`
    feeds the module singleton alongside the lifecycle histogram).
  * `ContentionObservatory` — the aggregator: the `GET /debug/contention`
    snapshot, plus the control-plane health degradations folded into
    `GET /debug/health`: `store-lock-saturation`, `fsync-stall`,
    `replication-lag`, `commit-ack-slo-burn`, `job-starvation`.

Import discipline: this module imports ONLY `utils.metrics` — the store
and the journal writer import it at module level, and those must stay
cheap and jax-free (`cook_tpu/obs/__init__` is lazy for the same
reason).
"""
from __future__ import annotations

import collections
import os
import statistics
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from cook_tpu_torch.utils.metrics import global_registry

# ------------------------------------------------------- degradation reasons

STORE_LOCK_SATURATION = "store-lock-saturation"
FSYNC_STALL = "fsync-stall"
REPLICATION_LAG = "replication-lag"
COMMIT_ACK_SLO_BURN = "commit-ack-slo-burn"
JOB_STARVATION = "job-starvation"
# the journal's degrade-to-async fsync policy is in effect: an fsync
# FAILED (not merely stalled) and commits are proceeding without the
# disk barrier (models/persistence.JournalWriter, docs/resilience.md)
JOURNAL_FSYNC_DEGRADED = "journal-fsync-degraded"

CONTENTION_REASONS = (STORE_LOCK_SATURATION, FSYNC_STALL, REPLICATION_LAG,
                      COMMIT_ACK_SLO_BURN, JOB_STARVATION,
                      JOURNAL_FSYNC_DEGRADED)

# lock waits/holds live in the microsecond-to-millisecond range; the
# default request-scale buckets would collapse everything into the
# first bucket
LOCK_BUCKETS = (1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01,
                0.05, 0.1, 0.5, 1.0, 5.0, float("inf"))
FSYNC_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0, 5.0, float("inf"))
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 1024, float("inf"))


def _site_of(code) -> str:
    module = os.path.basename(code.co_filename)
    if module.endswith(".py"):
        module = module[:-3]
    return f"{module}.{code.co_name}"


# code object -> "module.function": call sites are code, not workload,
# so this is bounded; caching skips the per-acquisition path/string work
_SITE_CACHE: dict = {}


def _caller_site(depth: int) -> str:
    """`module.function` of the frame `depth` levels up — the per-call-
    site label for lock profiling."""
    try:
        code = sys._getframe(depth).f_code
    except ValueError:
        return "unknown"
    site = _SITE_CACHE.get(code)
    if site is None:
        site = _SITE_CACHE[code] = _site_of(code)
    return site


# ------------------------------------------------------------ lock profiling


class LockProfiler:
    """Aggregation target for one named lock: per-site wait/hold stats,
    the current holder, the longest live waiter, and a count-windowed
    contention ratio (fraction of the last `window` outermost
    acquisitions that found the lock held)."""

    def __init__(self, name: str = "store", window: int = 512):
        self.name = name
        self.window = window
        self._lock = threading.Lock()
        self._sites: dict[str, dict] = {}
        # recent outermost acquisitions: True where the acquirer waited
        self._recent: collections.deque[bool] = collections.deque(
            maxlen=window)
        self._holder: Optional[dict] = None
        self._waiters: dict[int, dict] = {}
        self.acquisitions = 0
        self.contended = 0
        self.wait_seconds_total = 0.0
        self.hold_seconds_total = 0.0
        labels = {"lock": name}
        self._labels = labels
        # per-site label-bound metric handles: the store lock is hot
        # enough (tens of thousands of acquisitions per match cycle)
        # that re-sorting a label dict per observation is real probe
        # overhead; bound once per call site instead
        self._instruments: dict[str, tuple] = {}
        self._wait_hist = global_registry.histogram(
            "store.lock.wait_seconds",
            "seconds spent waiting for the store lock per call site",
            buckets=LOCK_BUCKETS)
        self._hold_hist = global_registry.histogram(
            "store.lock.hold_seconds",
            "seconds the store lock was held per call site",
            buckets=LOCK_BUCKETS)
        self._acq_counter = global_registry.counter(
            "store.lock.acquisitions",
            "outermost store-lock acquisitions per call site")
        self._contended_counter = global_registry.counter(
            "store.lock.contended",
            "outermost store-lock acquisitions that found the lock held")
        self._waiters_gauge = global_registry.gauge(
            "store.lock.waiters", "threads currently waiting for the lock")
        self._ratio_gauge = global_registry.gauge(
            "store.lock.contention_ratio",
            "contended fraction of recent outermost lock acquisitions")
        self._longest_gauge = global_registry.gauge(
            "store.lock.longest_wait_seconds",
            "age of the longest currently-parked lock waiter")
        self._bound_waiters = self._waiters_gauge.bind(labels)

    def _site_instruments(self, site: str) -> tuple:
        """(wait_hist, hold_hist, acq_counter, contended_counter) bound
        to this site's labels; caller holds self._lock."""
        inst = self._instruments.get(site)
        if inst is None:
            labels = {"lock": self.name, "site": site}
            inst = self._instruments[site] = (
                self._wait_hist.bind(labels), self._hold_hist.bind(labels),
                self._acq_counter.bind(labels),
                self._contended_counter.bind(labels))
        return inst

    # --- called from ProfiledRLock (hot path: keep it lean)

    def note_waiting(self, site: str, t0: float) -> None:
        with self._lock:
            self._waiters[threading.get_ident()] = {"site": site, "t0": t0}
            self._bound_waiters.set(len(self._waiters))

    def unnote_waiting(self) -> None:
        with self._lock:
            self._waiters.pop(threading.get_ident(), None)
            self._bound_waiters.set(len(self._waiters))

    def note_acquired(self, site: str, wait_s: float, waited: bool) -> None:
        with self._lock:
            self.acquisitions += 1
            self.wait_seconds_total += wait_s
            self.contended += waited
            self._recent.append(waited)
            entry = self._sites.get(site)
            if entry is None:
                entry = self._sites[site] = {
                    "acquisitions": 0, "contended": 0, "wait_s": 0.0,
                    "hold_s": 0.0, "max_wait_s": 0.0, "max_hold_s": 0.0}
            entry["acquisitions"] += 1
            entry["contended"] += waited
            entry["wait_s"] += wait_s
            entry["max_wait_s"] = max(entry["max_wait_s"], wait_s)
            self._holder = {"site": site, "since": time.monotonic(),
                            "thread": threading.get_ident()}
            wait_h, _, acq_c, cont_c = self._site_instruments(site)
        wait_h.observe(wait_s)
        acq_c.inc()
        if waited:
            cont_c.inc()

    def note_released(self, site: str, hold_s: float) -> None:
        with self._lock:
            self.hold_seconds_total += hold_s
            entry = self._sites.get(site)
            if entry is not None:
                entry["hold_s"] += hold_s
                entry["max_hold_s"] = max(entry["max_hold_s"], hold_s)
            if self._holder is not None and \
                    self._holder["thread"] == threading.get_ident():
                self._holder = None
            hold_h = self._site_instruments(site)[1]
        hold_h.observe(hold_s)

    # --- reads

    def contention_ratio(self) -> float:
        with self._lock:
            if not self._recent:
                return 0.0
            return sum(self._recent) / len(self._recent)

    def recent_samples(self) -> int:
        with self._lock:
            return len(self._recent)

    def snapshot(self, top: int = 20) -> dict:
        now = time.monotonic()
        with self._lock:
            holder = None
            if self._holder is not None:
                holder = {"site": self._holder["site"],
                          "held_s": now - self._holder["since"]}
            longest = None
            for waiter in self._waiters.values():
                waited_s = now - waiter["t0"]
                if longest is None or waited_s > longest["waited_s"]:
                    longest = {"site": waiter["site"], "waited_s": waited_s}
            sites = sorted(self._sites.items(),
                           key=lambda kv: kv[1]["wait_s"], reverse=True)
            ratio = (sum(self._recent) / len(self._recent)
                     if self._recent else 0.0)
            body = {
                "lock": self.name,
                "acquisitions": self.acquisitions,
                "contended": self.contended,
                "contention_ratio": ratio,
                "recent_window": len(self._recent),
                "wait_seconds_total": self.wait_seconds_total,
                "hold_seconds_total": self.hold_seconds_total,
                "holder": holder,
                "longest_waiter": longest,
                "waiters": len(self._waiters),
                "sites": {site: dict(entry) for site, entry in sites[:top]},
            }
        self._ratio_gauge.set(ratio, self._labels)
        self._longest_gauge.set(longest["waited_s"] if longest else 0.0,
                                self._labels)
        return body


class ProfiledRLock:
    """Drop-in RLock that reports outermost acquisitions to a
    LockProfiler.  Re-entrant acquisitions (the store's query helpers
    called under a held write transaction) are passed straight through —
    their wait is zero by construction and their hold belongs to the
    outermost owner."""

    def __init__(self, profiler: LockProfiler):
        self._lock = threading.RLock()
        self.profiler = profiler
        self._local = threading.local()

    def acquire(self, blocking: bool = True, timeout: float = -1,
                *, _site: Optional[str] = None) -> bool:
        depth = getattr(self._local, "depth", 0)
        if depth:
            ok = self._lock.acquire(blocking, timeout)
            if ok:
                self._local.depth = depth + 1
            return ok
        site = _site if _site is not None else _caller_site(2)
        t0 = time.perf_counter()
        waited = False
        if not self._lock.acquire(False):
            waited = True
            self.profiler.note_waiting(site, time.monotonic())
            try:
                if not self._lock.acquire(blocking, timeout):
                    return False
            finally:
                self.profiler.unnote_waiting()
        wait_s = time.perf_counter() - t0
        self._local.depth = 1
        self._local.site = site
        self._local.acquired = time.perf_counter()
        self.profiler.note_acquired(site, wait_s, waited)
        return True

    def release(self) -> None:
        depth = getattr(self._local, "depth", 0)
        if depth == 1:
            hold_s = time.perf_counter() - self._local.acquired
            self.profiler.note_released(self._local.site, hold_s)
        self._local.depth = max(depth - 1, 0)
        self._lock.release()

    def __enter__(self) -> "ProfiledRLock":
        self.acquire(_site=_caller_site(2))
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def profiled_store_lock(name: str = "store") -> ProfiledRLock:
    """The store's lock constructor (models/store.py).  One profiler per
    STORE (not per process): a production node runs one store, and in
    tests a fresh store must not inherit another suite's contention
    window — the Prometheus metrics underneath are process-global
    regardless (same names, shared registry)."""
    return ProfiledRLock(LockProfiler(name))


# --------------------------------------------------------- journal pipeline


class JournalTelemetry:
    """The txn journal's write-path telemetry: append volume and bytes,
    pending-fsync depth (events flushed to the OS but not yet on disk —
    the append "queue" a crash-consistency bound cares about), group-
    fsync batch sizes, and the fsync stall histogram.  One instance per
    JournalWriter (`writer.telemetry`) — the observatory reads ITS
    store's journal, so another process-resident journal's disk stalls
    (tests spin up many) can't flip this node's verdict.  The Prometheus
    metrics underneath are process-global regardless."""

    def __init__(self, recent_fsyncs: int = 64):
        self._lock = threading.Lock()
        self._recent_fsyncs: collections.deque[float] = collections.deque(
            maxlen=recent_fsyncs)
        self.appends = 0
        self.bytes_written = 0
        self.fsyncs = 0
        self.fsync_errors = 0
        self.degraded = False
        self.fsync_seconds_total = 0.0
        self.max_fsync_s = 0.0
        self.last_batch = 0
        self._append_counter = global_registry.counter(
            "journal.appends", "journal lines appended")
        self._bytes_counter = global_registry.counter(
            "journal.bytes_written", "journal bytes appended")
        self._pending_gauge = global_registry.gauge(
            "journal.pending_fsync",
            "events flushed to the OS but not yet fsynced")
        self._fsync_hist = global_registry.histogram(
            "journal.fsync_seconds", "journal fsync stall seconds",
            buckets=FSYNC_BUCKETS)
        self._batch_hist = global_registry.histogram(
            "journal.fsync_batch_events",
            "events covered by one group fsync", buckets=BATCH_BUCKETS)
        self._error_counter = global_registry.counter(
            "journal.fsync_errors", "journal fsyncs that FAILED (raised)")
        self._degraded_gauge = global_registry.gauge(
            "journal.degraded",
            "1 while the journal runs in degraded async mode (fsync "
            "failed under the degrade-to-async policy)")

    def note_append(self, n_bytes: int, pending: int) -> None:
        with self._lock:
            self.appends += 1
            self.bytes_written += n_bytes
        self._append_counter.inc()
        self._bytes_counter.inc(n_bytes)
        self._pending_gauge.set(pending)

    def note_fsync(self, batch_events: int, seconds: float) -> None:
        with self._lock:
            self.fsyncs += 1
            self.fsync_seconds_total += seconds
            self.max_fsync_s = max(self.max_fsync_s, seconds)
            self.last_batch = batch_events
            self._recent_fsyncs.append(seconds)
        self._fsync_hist.observe(seconds)
        self._batch_hist.observe(float(batch_events))
        self._pending_gauge.set(0)

    def note_fsync_error(self) -> None:
        with self._lock:
            self.fsync_errors += 1
        self._error_counter.inc()

    def set_degraded(self, degraded: bool) -> None:
        with self._lock:
            self.degraded = degraded
        self._degraded_gauge.set(1.0 if degraded else 0.0)

    def is_degraded(self) -> bool:
        with self._lock:
            return self.degraded

    def note_rotate(self) -> None:
        """Journal rotation dropped the unfsynced tail with the old
        file — nothing is pending against the fresh one."""
        self._pending_gauge.set(0)

    def recent_fsync_max(self) -> float:
        with self._lock:
            return max(self._recent_fsyncs, default=0.0)

    def snapshot(self) -> dict:
        with self._lock:
            recent = list(self._recent_fsyncs)
            return {
                "appends": self.appends,
                "bytes_written": self.bytes_written,
                "fsyncs": self.fsyncs,
                "fsync_errors": self.fsync_errors,
                "degraded": self.degraded,
                "fsync_seconds_total": self.fsync_seconds_total,
                "fsync_max_s": self.max_fsync_s,
                "recent_fsync_max_s": max(recent, default=0.0),
                "recent_fsync_p50_ms": (
                    statistics.median(recent) * 1000 if recent else 0.0),
                "last_batch_events": self.last_batch,
                "mean_batch_events": (self.appends / self.fsyncs
                                      if self.fsyncs else 0.0),
            }


# ------------------------------------------------------------ REST endpoints


class EndpointTelemetry:
    """Per-route REST telemetry: latency histogram + request counter at
    /metrics, and an in-object sliding sample window per (route, method)
    for the live RPS / p50 / p99 / error-rate table /debug/contention
    serves.  Route labels are matched route templates (bounded by the
    route table, not the workload)."""

    def __init__(self, samples_per_route: int = 512):
        self._lock = threading.Lock()
        self._routes: dict[tuple[str, str], dict] = {}
        self._samples = samples_per_route
        self._hist = global_registry.histogram(
            "rest.request_seconds",
            "REST request wall seconds per route/method")
        self._counter = global_registry.counter(
            "rest.requests", "REST requests per route/method/status class")
        self._in_flight_gauge = global_registry.gauge(
            "rest.in_flight", "REST requests currently being served")

    def _entry(self, route: str, method: str) -> dict:
        key = (route, method)
        entry = self._routes.get(key)
        if entry is None:
            entry = self._routes[key] = {
                "count": 0, "errors": 0, "in_flight": 0,
                "recent": collections.deque(maxlen=self._samples),
            }
        return entry

    def begin(self, route: str, method: str) -> None:
        with self._lock:
            entry = self._entry(route, method)
            entry["in_flight"] += 1
            total = sum(e["in_flight"] for e in self._routes.values())
        self._in_flight_gauge.set(total)

    def done(self, route: str, method: str, status: int,
             seconds: float) -> None:
        error = status >= 500
        with self._lock:
            entry = self._entry(route, method)
            entry["in_flight"] = max(entry["in_flight"] - 1, 0)
            entry["count"] += 1
            entry["errors"] += error
            entry["recent"].append((time.monotonic(), seconds, error))
            total = sum(e["in_flight"] for e in self._routes.values())
        self._in_flight_gauge.set(total)
        labels = {"route": route, "method": method,
                  "status": f"{status // 100}xx"}
        self._counter.inc(1, labels)
        self._hist.observe(seconds, {"route": route, "method": method})

    def snapshot(self, window_s: float = 60.0) -> dict:
        now = time.monotonic()
        out = {}
        with self._lock:
            items = [(key, dict(entry), list(entry["recent"]))
                     for key, entry in self._routes.items()]
        for (route, method), entry, recent in items:
            in_window = [(t, s, e) for t, s, e in recent
                         if now - t <= window_s]
            durations = sorted(s for _, s, _ in in_window)
            # a full deque may retain less than window_s of history (a
            # busy route evicts old samples); dividing by the nominal
            # window would cap reported RPS at maxlen/window_s
            effective_s = window_s
            if recent and len(recent) == self._samples:
                effective_s = min(window_s, max(now - recent[0][0], 1e-9))
            row = {
                "count": entry["count"],
                "errors": entry["errors"],
                "in_flight": entry["in_flight"],
                "window_s": effective_s,
                "rps": len(in_window) / effective_s,
                "error_rate": (sum(e for _, _, e in in_window)
                               / len(in_window)) if in_window else 0.0,
            }
            if durations:
                row["p50_ms"] = _percentile(durations, 50) * 1000
                row["p99_ms"] = _percentile(durations, 99) * 1000
            out[f"{method} {route}"] = row
        return out


def _percentile(sorted_values: list[float], q: float) -> float:
    if not sorted_values:
        return 0.0
    idx = min(len(sorted_values) - 1,
              max(0, round(q / 100 * (len(sorted_values) - 1))))
    return sorted_values[idx]


# ------------------------------------------------------------- SLO burn rate


# latency bin bounds for burn-rate bucketing: evaluation is EXACT when
# the SLO threshold is one of these (a sample counts as violating iff
# its bin lies strictly above the threshold's bin); an off-grid
# threshold effectively rounds up to its bin's upper bound
_SLO_BOUNDS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
               10.0, 30.0, float("inf"))


class SloBurnTracker:
    """Fast/slow-window SLO burn-rate evaluation (the multi-window SRE
    pattern: page only when BOTH a fast and a slow window burn error
    budget faster than allowed — a blip trips neither, a sustained burn
    trips both).

    Window counts come from time-bucketed latency histograms
    (`bucket_s`-wide buckets retained `retention_s` back), so the slow
    window stays honest at ANY commit rate — a count-bounded ring would
    silently shrink the hour window to seconds at high RPS, collapsing
    both windows onto the same samples and paging on exactly the blip
    this pattern exists to suppress.  A bounded sample ring rides along
    for the reported percentiles only."""

    def __init__(self, capacity: int = 4096, bucket_s: float = 10.0,
                 retention_s: float = 3660.0 * 2):
        self._lock = threading.Lock()
        # recent raw samples: percentile estimates, not burn counts
        self._ring: collections.deque[tuple[float, float]] = \
            collections.deque(maxlen=capacity)
        self._bucket_s = bucket_s
        self._retention_s = retention_s
        # bucket start -> per-latency-bin counts (_SLO_BOUNDS)
        self._buckets: dict[float, list[int]] = {}
        self._newest_t = 0.0

    def observe(self, seconds: float, t: Optional[float] = None) -> None:
        import bisect

        t = time.time() if t is None else t
        start = t - (t % self._bucket_s)
        bin_i = bisect.bisect_left(_SLO_BOUNDS, seconds)
        with self._lock:
            self._ring.append((t, seconds))
            counts = self._buckets.get(start)
            if counts is None:
                counts = self._buckets[start] = [0] * len(_SLO_BOUNDS)
                self._newest_t = max(self._newest_t, t)
                cutoff = self._newest_t - self._retention_s
                for old in [s for s in self._buckets if s < cutoff]:
                    del self._buckets[old]
            counts[bin_i] += 1

    def stats(self, *, threshold_s: float, budget: float, fast_s: float,
              slow_s: float, now: Optional[float] = None) -> dict:
        """Burn rate per window = (violating fraction) / (error budget).
        >1.0 means the window is consuming budget faster than allowed."""
        import bisect

        now = time.time() if now is None else now
        with self._lock:
            buckets = [(s, list(c)) for s, c in self._buckets.items()]
            ring = list(self._ring)
        thr_bin = bisect.bisect_left(_SLO_BOUNDS, threshold_s)

        def window(window_s: float) -> tuple[float, int, int]:
            total = over = 0
            for start, counts in buckets:
                # whole-bucket granularity: a bucket counts if any of
                # it overlaps [now - window_s, now]
                if start + self._bucket_s > now - window_s and start <= now:
                    total += sum(counts)
                    over += sum(counts[thr_bin + 1:])
            if not total:
                return 0.0, 0, 0
            return (over / total) / max(budget, 1e-9), over, total

        fast_burn, fast_over, fast_n = window(fast_s)
        slow_burn, slow_over, slow_n = window(slow_s)
        durations = sorted(s for t, s in ring if now - t <= slow_s)
        return {
            "threshold_s": threshold_s,
            "budget": budget,
            "fast_window_s": fast_s,
            "slow_window_s": slow_s,
            "fast_burn": fast_burn,
            "slow_burn": slow_burn,
            "fast_samples": fast_n,
            "fast_over": fast_over,
            "slow_samples": slow_n,
            "slow_over": slow_over,
            "p50_ms": _percentile(durations, 50) * 1000,
            "p99_ms": _percentile(durations, 99) * 1000,
        }


# --------------------------------------------------------------- aggregator


@dataclass
class ContentionParams:
    """Thresholds for the control-plane degradation checks."""

    # store-lock-saturation: contended fraction of the recent
    # acquisition window, with a floor on how many samples judge it
    lock_contention_ratio: float = 0.5
    lock_min_acquisitions: int = 64
    # fsync-stall: any fsync in the recent window slower than this
    fsync_stall_s: float = 0.25
    # replication-lag: a follower this many events behind, or behind at
    # all and silent this long
    replication_lag_events: int = 1000
    replication_ack_age_s: float = 15.0
    # commit-ack SLO: latency bound, violating budget, burn windows
    commit_ack_slo_s: float = 1.0
    commit_ack_budget: float = 0.01
    burn_fast_s: float = 300.0
    burn_slow_s: float = 3600.0
    burn_threshold: float = 1.0
    # job-starvation: oldest queued job older than this
    starvation_age_s: float = 1800.0


class ContentionObservatory:
    """Aggregates every write-path instrument into one live surface.

    `snapshot()` is the GET /debug/contention body; `evaluate()` returns
    (degradations, checks) that rest/api.py folds into the
    GET /debug/health verdict next to the device-telemetry checks."""

    def __init__(self, store, *, params: Optional[ContentionParams] = None,
                 endpoints: Optional[EndpointTelemetry] = None,
                 journal_fn: Optional[
                     Callable[[], Optional[JournalTelemetry]]] = None,
                 commit_ack: Optional[SloBurnTracker] = None,
                 replication_meta_fn: Optional[Callable[[], dict]] = None,
                 starvation_fn: Optional[Callable[[], dict]] = None,
                 shards_fn: Optional[Callable[[], list]] = None):
        self.store = store
        self.params = params or ContentionParams()
        self.endpoints = endpoints
        # resolves to THIS node's journal writer telemetry (rest/api.py
        # passes the transaction log's journal); the empty fallback
        # renders zeros on journal-less deployments
        self.journal_fn = journal_fn
        self._journal_fallback = JournalTelemetry()
        # per-observatory: burn-rate windows must not inherit another
        # api instance's samples (the owning CookApi feeds this from its
        # commit path, next to the lifecycle histogram)
        self.commit_ack = commit_ack or SloBurnTracker()
        # leader view: follower -> {seq, durable, time(monotonic), ...}
        # (rest/api.py replication_ack_meta)
        self.replication_meta_fn = replication_meta_fn or (lambda: {})
        # pool -> starvation stats (scheduler/monitor.starvation_stats)
        self.starvation_fn = starvation_fn or (lambda: {})
        # sharded control plane (cook_tpu/shard/): per-shard rows — each
        # shard's lock profiler, journal-segment telemetry, and commit
        # service-time window (ShardedTransactionLog.shard_view); None on
        # single-shard deployments.  rest/api.py wires this after
        # construction (the txn log is built before the observatory).
        self.shards_fn = shards_fn
        self._lag_gauge = global_registry.gauge(
            "replication.follower_lag_events",
            "events the follower's last ack trails the leader by")
        self._ack_age_gauge = global_registry.gauge(
            "replication.follower_ack_age_seconds",
            "seconds since the follower's last replication ack")
        self._reason_gauge = global_registry.gauge(
            "obs.health.reason_active",
            "1 while the labeled degradation reason is active")

    # ------------------------------------------------------------- views

    def _lock_profiler(self) -> Optional[LockProfiler]:
        lock = getattr(self.store, "_lock", None)
        return getattr(lock, "profiler", None)

    def _journal(self) -> JournalTelemetry:
        journal = self.journal_fn() if self.journal_fn is not None else None
        return journal if journal is not None else self._journal_fallback

    def replication_view(self) -> list[dict]:
        """Per-follower ack lag, computed leader-side: event delta vs
        the store head, seconds since the last ack, durable split.  On a
        sharded store each ack names its shard and lags against THAT
        shard's head (sequence numbers are per-shard)."""
        shards = getattr(self.store, "shards", None)
        last_seq = self.store.last_seq()
        now = time.monotonic()
        out = []
        for follower, meta in sorted(self.replication_meta_fn().items()):
            shard = int(meta.get("shard", 0))
            if shards is not None and 0 <= shard < len(shards):
                head = shards[shard].last_seq()
            else:
                head = last_seq
            lag_events = max(0, head - int(meta.get("seq", 0)))
            ack_age_s = now - meta.get("time", now)
            out.append({
                "follower": follower,
                "shard": shard,
                "acked_seq": int(meta.get("seq", 0)),
                "leader_seq": head,
                "lag_events": lag_events,
                "ack_age_s": ack_age_s,
                "durable": bool(meta.get("durable", False)),
                "last_txn_id": meta.get("last_txn_id", ""),
            })
            self._lag_gauge.set(lag_events, {"follower": follower})
            self._ack_age_gauge.set(ack_age_s, {"follower": follower})
        return out

    def commit_ack_stats(self) -> dict:
        p = self.params
        return self.commit_ack.stats(
            threshold_s=p.commit_ack_slo_s, budget=p.commit_ack_budget,
            fast_s=p.burn_fast_s, slow_s=p.burn_slow_s)

    def snapshot(self) -> dict:
        profiler = self._lock_profiler()
        body = {
            "store_lock": (profiler.snapshot() if profiler is not None
                           else {"profiled": False}),
            "journal": self._journal().snapshot(),
            "replication": self.replication_view(),
            "endpoints": (self.endpoints.snapshot()
                          if self.endpoints is not None else {}),
            "commit_ack": self.commit_ack_stats(),
            "starvation": self.starvation_fn(),
            "wall_time": time.time(),
        }
        if self.shards_fn is not None:
            # per-shard attribution (cook_tpu/shard/): each shard's lock,
            # journal segment, and commit service-time window — the
            # hottest-shard answer tools/loadtest.py scrapes
            body["shards"] = self.shards_fn()
        return body

    # ------------------------------------------------------------- health

    def evaluate(self) -> tuple[list[dict], dict]:
        """(degradations, checks) for the /debug/health merge.  Every
        check contributes evidence even when green; each reason has an
        inducing test in tests/test_contention.py."""
        p = self.params
        degradations: list[dict] = []
        checks: dict = {}

        profiler = self._lock_profiler()
        if profiler is not None:
            ratio = profiler.contention_ratio()
            samples = profiler.recent_samples()
            checks["store_lock"] = {
                "contention_ratio": ratio, "recent_window": samples,
                "threshold": p.lock_contention_ratio}
            if samples >= p.lock_min_acquisitions and \
                    ratio >= p.lock_contention_ratio:
                degradations.append({
                    "reason": STORE_LOCK_SATURATION,
                    "detail": (
                        f"{ratio:.0%} of the last {samples} store-lock "
                        f"acquisitions waited (threshold "
                        f"{p.lock_contention_ratio:.0%}) — the single "
                        f"store lock is the bottleneck; see "
                        f"/debug/contention for the per-site split"),
                    "contention_ratio": ratio,
                    "recent_window": samples,
                })

        journal = self._journal()
        stall = journal.recent_fsync_max()
        checks["journal"] = {"recent_fsync_max_s": stall,
                             "threshold_s": p.fsync_stall_s,
                             "degraded": journal.is_degraded(),
                             "fsync_errors": journal.fsync_errors}
        if journal.is_degraded():
            degradations.append({
                "reason": JOURNAL_FSYNC_DEGRADED,
                "detail": (
                    "journal fsync FAILED and the degrade-to-async "
                    "policy is in effect: commits proceed without the "
                    "disk barrier (an OS crash may lose the unfsynced "
                    "tail) until a disk probe succeeds — check the "
                    "volume; see docs/resilience.md"),
                "fsync_errors": journal.fsync_errors,
            })
        if stall >= p.fsync_stall_s:
            degradations.append({
                "reason": FSYNC_STALL,
                "detail": (
                    f"journal fsync stalled {stall * 1000:.0f} ms in the "
                    f"recent window (threshold "
                    f"{p.fsync_stall_s * 1000:.0f} ms) — every commit ack "
                    f"waits on this disk barrier"),
                "recent_fsync_max_s": stall,
            })

        if self.shards_fn is not None:
            # per-shard fsync health: a wedged SEGMENT degrades with its
            # shard id attached, so the chaos wedged-shard drill (and an
            # operator) can see exactly which shard's keys are affected
            shard_checks = {}
            for row in self.shards_fn():
                shard = row.get("shard")
                jstats = row.get("journal") or {}
                stall_s = float(jstats.get("recent_fsync_max_s", 0.0))
                shard_checks[str(shard)] = {
                    "recent_fsync_max_s": stall_s,
                    "degraded": bool(jstats.get("degraded")),
                    "commit_p99_ms": (row.get("commit_ack") or {}).get(
                        "p99_ms", 0.0),
                }
                if jstats.get("degraded"):
                    degradations.append({
                        "reason": JOURNAL_FSYNC_DEGRADED,
                        "shard": shard,
                        "detail": (
                            f"shard {shard}'s journal segment is running "
                            f"degraded-async after an fsync FAILURE — "
                            f"only this shard's keys ride the page cache; "
                            f"see docs/operations.md (diagnosing a hot "
                            f"shard)"),
                        "fsync_errors": jstats.get("fsync_errors", 0),
                    })
                if stall_s >= p.fsync_stall_s:
                    degradations.append({
                        "reason": FSYNC_STALL,
                        "shard": shard,
                        "detail": (
                            f"shard {shard}'s journal segment fsync "
                            f"stalled {stall_s * 1000:.0f} ms (threshold "
                            f"{p.fsync_stall_s * 1000:.0f} ms) — commits "
                            f"ROUTED TO THIS SHARD wait on it; other "
                            f"shards' segments are unaffected"),
                        "recent_fsync_max_s": stall_s,
                    })
            checks["shards"] = shard_checks

        followers = self.replication_view()
        checks["replication"] = {"followers": followers}
        for f in followers:
            behind = f["lag_events"] >= p.replication_lag_events
            silent = (f["lag_events"] > 0
                      and f["ack_age_s"] >= p.replication_ack_age_s)
            if behind or silent:
                degradations.append({
                    "reason": REPLICATION_LAG,
                    "follower": f["follower"],
                    "detail": (
                        f"follower {f['follower']} is {f['lag_events']} "
                        f"events behind (last ack "
                        f"{f['ack_age_s']:.1f} s ago, durable="
                        f"{f['durable']}) — sync-ack commits are waiting "
                        f"on it"),
                    **{k: f[k] for k in ("lag_events", "ack_age_s",
                                         "durable")},
                })

        ack = self.commit_ack_stats()
        checks["commit_ack"] = ack
        if ack["fast_burn"] > p.burn_threshold \
                and ack["slow_burn"] > p.burn_threshold:
            degradations.append({
                "reason": COMMIT_ACK_SLO_BURN,
                "detail": (
                    f"commit-ack latency is burning its "
                    f"{p.commit_ack_slo_s:.1f} s SLO budget at "
                    f"{ack['fast_burn']:.1f}x (fast window) / "
                    f"{ack['slow_burn']:.1f}x (slow window) the allowed "
                    f"rate — correlate with store-lock / fsync / "
                    f"replication attribution at /debug/contention"),
                "fast_burn": ack["fast_burn"],
                "slow_burn": ack["slow_burn"],
            })

        starvation = self.starvation_fn()
        checks["starvation"] = {"pools": starvation,
                                "threshold_s": p.starvation_age_s}
        for pool, stats in sorted(starvation.items()):
            if stats.get("oldest_age_s", 0.0) >= p.starvation_age_s:
                degradations.append({
                    "reason": JOB_STARVATION,
                    "pool": pool,
                    "detail": (
                        f"pool {pool}'s oldest queued job has waited "
                        f"{stats['oldest_age_s']:.0f} s (threshold "
                        f"{p.starvation_age_s:.0f} s); worst user "
                        f"{stats.get('worst_user', '?')} at "
                        f"{stats.get('worst_user_wait_s', 0.0):.0f} s"),
                    **{k: stats[k] for k in ("oldest_age_s", "oldest_job",
                                             "worst_user",
                                             "worst_user_wait_s")
                       if k in stats},
                })

        active = {d["reason"] for d in degradations}
        for reason in CONTENTION_REASONS:
            self._reason_gauge.set(1.0 if reason in active else 0.0,
                                   {"reason": reason})
        return degradations, checks
