"""Durable multi-resolution metrics history: the "what did this gauge
look like before it broke" layer.

A copy of `cook_tpu/obs/tsdb.py` (jax-free), its imports the port's.
The simulator samples it on the virtual clock (`SimConfig.
history_every`); `GET /debug/history` and the bundle collector the REST
layer registers wait for the port's service surface.

Every observability surface before this one (/debug/health,
/debug/contention, /metrics) is a snapshot-in-time view: by the time an
operator looks, the pre-incident shape of a gauge has been overwritten
by its current value.  Online scheduling and capacity decisions are
driven by exactly this kind of time-windowed telemetry
(prediction-assisted scheduling, arXiv:2501.05563; Aryl,
arXiv:2202.07896), and a two-speed streaming scheduler cannot be
tuned without retained submit-to-launch latency history.

`MetricsHistory` closes the gap:

  * a background sampler polls `utils/metrics.global_registry` every
    `sample_s` seconds and turns the registry into per-series POINTS —
    gauges sample their value, counters sample their per-second RATE
    over the tick, histograms sample windowed p50/p99 (bucket-edge
    estimate over the observations that landed in the tick);
  * points land in multi-resolution rings: the raw ring plus 1m and 10m
    rollup rings whose buckets carry min/max/mean/last/count — a week of
    10m buckets costs ~1000 points per series while the raw ring keeps
    the last hours at full resolution;
  * with a `dir`, every sample tick is appended to a bounded JSONL
    segment under `data_dir/metrics/` (rotated by line count, retention-
    capped by segment count, torn tails tolerated on recovery) and the
    rings are rebuilt from the segments on restart — history survives
    the process;
  * `query(metric, since, step)` serves `GET /debug/history`
    (rest/api.py) and the `cs history` sparkline renderer;
  * `incident_slice()` is registered as an incident-bundle collector
    (rest/api.py) so every bundle embeds the pre-incident window of the
    configured key series — a bundle answers "what changed before it
    broke" without a live node.

Import discipline: stdlib + utils.metrics only — the REST layer and
control-plane-only nodes import this module (same rule as
obs/contention.py).
"""
from __future__ import annotations

import collections
import json
import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from cook_tpu_torch.utils.metrics import (Counter, Gauge, Histogram, Registry,
                                    global_registry)

log = logging.getLogger(__name__)

# rollup resolutions: (step name, bucket width seconds).  "raw" is the
# unbucketed sample stream; queries name one of these.
ROLLUPS = (("1m", 60.0), ("10m", 600.0))
STEPS = ("raw",) + tuple(name for name, _ in ROLLUPS)

# pre-incident series embedded in every incident bundle (prefix match —
# a `family.` entry covers the family).  Chosen to answer "what changed
# before it broke" for both halves of the health verdict: the verdict
# itself, the write path, replication, and the match plane.
DEFAULT_KEY_SERIES = (
    "obs.health.degraded",
    "obs.health.reason_active",
    "incident.open",
    "rest.in_flight",
    "store.lock.contention_ratio",
    "replication.follower_lag_events",
    "job.latency.submit_commit_ack.",
    "match.matched",
    "rank.queue_len",
    "fairness.",
)


@dataclass
class HistoryConfig:
    """Knobs for the sampler + retention (Settings.history_sample_s /
    Settings.history_retention; docs/configuration.md)."""

    sample_s: float = 10.0
    # per-series ring caps: points retained in memory per resolution
    raw_points: int = 4096
    rollup_points: int = 2048
    # on-disk segments: ticks per segment before rotation, and how many
    # rotated segments retention keeps
    segment_lines: int = 512
    max_segments: int = 64
    # incident-bundle slice: series prefixes + window
    key_series: tuple = DEFAULT_KEY_SERIES
    incident_window_s: float = 600.0
    # a series with no new point for this long is dropped outright
    # (rings + rollups + index row).  Churned label sets — per-user
    # monitor gauges, per-peer fleet gauges — are REMOVED from the
    # registry when their subject goes away; without an age-out their
    # history series would accumulate ring buffers forever on a
    # long-lived leader.  <= 0 disables.
    series_ttl_s: float = 86_400.0

    @classmethod
    def from_retention(cls, sample_s: float,
                       retention: Optional[dict] = None) -> "HistoryConfig":
        """Settings-shaped constructor: `history_retention` keys override
        the matching caps ({"raw_points": .., "rollup_points": ..,
        "segment_lines": .., "max_segments": .., "key_series": [..],
        "incident_window_s": ..})."""
        retention = dict(retention or {})
        kw = {"sample_s": sample_s}
        for key in ("raw_points", "rollup_points", "segment_lines",
                    "max_segments"):
            if key in retention:
                kw[key] = int(retention[key])
        if "incident_window_s" in retention:
            kw["incident_window_s"] = float(retention["incident_window_s"])
        if "series_ttl_s" in retention:
            kw["series_ttl_s"] = float(retention["series_ttl_s"])
        if "key_series" in retention:
            kw["key_series"] = tuple(retention["key_series"])
        return cls(**kw)


def _series_key(name: str, labels_key: tuple, suffix: str = "") -> str:
    base = name + suffix
    if not labels_key:
        return base
    inner = ",".join(f"{k}={v}" for k, v in labels_key)
    return f"{base}{{{inner}}}"


def series_base(key: str) -> str:
    """The series name with the label set stripped:
    `rank.queue_len{pool=default}` -> `rank.queue_len`."""
    brace = key.find("{")
    return key if brace < 0 else key[:brace]


def _histogram_quantile(buckets: tuple, counts: list[int],
                        q: float) -> Optional[float]:
    """Bucket-edge quantile estimate over one tick's observation deltas
    (the exposition-histogram estimate: the value is the upper edge of
    the bucket the target rank lands in; +Inf collapses to the last
    finite edge)."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0
    for edge, count in zip(buckets, counts):
        cum += count
        if cum >= rank:
            if edge == math.inf:
                finite = [e for e in buckets if e != math.inf]
                return finite[-1] if finite else None
            return edge
    return None


class _Rollup:
    """One series' rollup at one resolution: the finalized-bucket ring
    plus the open bucket raw points fold into."""

    __slots__ = ("width", "ring", "open")

    def __init__(self, width: float, cap: int):
        self.width = width
        self.ring: collections.deque = collections.deque(maxlen=cap)
        self.open: Optional[dict] = None

    def add(self, t: float, v: float) -> None:
        start = math.floor(t / self.width) * self.width
        bucket = self.open
        if bucket is not None and bucket["t"] != start:
            self.ring.append(bucket)
            bucket = None
        if bucket is None:
            self.open = {"t": start, "min": v, "max": v, "sum": v,
                         "count": 1, "last": v}
            return
        bucket["min"] = min(bucket["min"], v)
        bucket["max"] = max(bucket["max"], v)
        bucket["sum"] += v
        bucket["count"] += 1
        bucket["last"] = v

    def points(self, since: float) -> list[dict]:
        out = []
        for bucket in self.ring:
            if bucket["t"] + self.width <= since:
                continue
            out.append(self._render(bucket))
        if self.open is not None and self.open["t"] + self.width > since:
            out.append(self._render(self.open))
        return out

    @staticmethod
    def _render(bucket: dict) -> dict:
        return {"t": bucket["t"], "min": bucket["min"],
                "max": bucket["max"],
                "mean": bucket["sum"] / bucket["count"],
                "last": bucket["last"], "count": bucket["count"]}


class MetricsHistory:
    """Multi-resolution, optionally durable history over a metrics
    registry.  Thread-safe: the sampler thread writes, REST handlers and
    incident collectors read."""

    def __init__(self, registry: Optional[Registry] = None, *,
                 dir: Optional[str] = None,
                 config: Optional[HistoryConfig] = None,
                 clock: Callable[[], float] = time.time):
        self.registry = registry or global_registry
        self.dir = dir or None
        self.config = config or HistoryConfig()
        self.clock = clock
        self._lock = threading.Lock()
        self._raw: dict[str, collections.deque] = {}
        self._rollups: dict[str, dict[str, _Rollup]] = {}
        # previous cumulative values, for counter rates and histogram
        # window deltas — live state only, never recovered from disk
        # (the first tick after restart just emits no rate points)
        self._prev_counts: dict[str, float] = {}
        self._prev_hist: dict[str, list[int]] = {}
        self._prev_t: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # on-disk segment state
        self._segment_index = 0
        self._segment_lines = 0
        self._segment_file = None
        self._samples = global_registry.counter(
            "history.samples", "metrics-history sample ticks taken")
        self._points = global_registry.counter(
            "history.points", "metrics-history points recorded, all series")
        self._series_gauge = global_registry.gauge(
            "history.series", "series the metrics history is tracking")
        self._segments_gauge = global_registry.gauge(
            "history.segments", "on-disk metrics-history segments retained")
        self._recovered = global_registry.counter(
            "history.recovered_points",
            "points rebuilt from on-disk segments at startup")
        if self.dir:
            self._recover()

    # ------------------------------------------------------------ sampling

    def sample_once(self, now: Optional[float] = None) -> int:
        """Take one sample tick: registry -> points -> rings (+ the
        on-disk segment).  Returns the number of points recorded."""
        now = self.clock() if now is None else now
        points = self._collect(now)
        with self._lock:
            for key, value in points.items():
                self._append_locked(key, now, value)
            self._expire_series_locked(now)
            self._series_gauge.set(len(self._raw))
        if points:
            self._persist_tick(now, points)
        self._samples.inc()
        self._points.inc(len(points))
        return len(points)

    def _expire_series_locked(self, now: float) -> None:
        """Drop series that stopped producing points TTL ago — the
        subject behind a removed label set (a departed user, a
        decommissioned peer) must eventually leave the index too."""
        ttl = self.config.series_ttl_s
        if ttl <= 0:
            return
        for key in [k for k, ring in self._raw.items()
                    if ring and now - ring[-1][0] > ttl]:
            del self._raw[key]
            del self._rollups[key]

    def _collect(self, now: float) -> dict[str, float]:
        """One tick's points from the registry snapshot.  Counters and
        histograms need a previous tick to difference against, so their
        first observation primes state and emits nothing."""
        with self.registry._lock:
            metrics = list(self.registry._metrics.items())
        prev_t = self._prev_t
        self._prev_t = now
        dt = (now - prev_t) if prev_t is not None else None
        points: dict[str, float] = {}
        # prev-state keys still backed by a live registry label set; the
        # maps are pruned to this after the pass — a removed label set
        # (departed user, decommissioned peer) must not leave its
        # cumulative state behind forever
        seen_counts: set[str] = set()
        seen_hist: set[str] = set()
        for name, metric in metrics:
            if isinstance(metric, Gauge):
                with metric._lock:
                    values = list(metric._values.items())
                for labels_key, value in values:
                    points[_series_key(name, labels_key)] = float(value)
            elif isinstance(metric, Counter):
                with metric._lock:
                    values = list(metric._values.items())
                for labels_key, value in values:
                    key = _series_key(name, labels_key, ".rate")
                    seen_counts.add(key)
                    prev = self._prev_counts.get(key)
                    self._prev_counts[key] = value
                    if prev is None or dt is None or dt <= 0:
                        continue
                    # a counter can only move forward; a drop means the
                    # process restarted mid-window — treat as a fresh base
                    points[key] = max(0.0, value - prev) / dt
            elif isinstance(metric, Histogram):
                with metric._lock:
                    counts = [(k, list(c)) for k, c in
                              metric._counts.items()]
                for labels_key, cum in counts:
                    state_key = _series_key(name, labels_key)
                    seen_hist.add(state_key)
                    prev = self._prev_hist.get(state_key)
                    self._prev_hist[state_key] = cum
                    if prev is None or len(prev) != len(cum):
                        continue
                    delta = [max(0, c - p) for c, p in zip(cum, prev)]
                    for q, suffix in ((0.5, ".p50"), (0.99, ".p99")):
                        est = _histogram_quantile(metric.buckets, delta, q)
                        if est is not None:
                            points[_series_key(name, labels_key,
                                               suffix)] = est
        for gone in set(self._prev_counts) - seen_counts:
            del self._prev_counts[gone]
        for gone in set(self._prev_hist) - seen_hist:
            del self._prev_hist[gone]
        return points

    def _append_locked(self, key: str, t: float, v: float) -> None:
        raw = self._raw.get(key)
        if raw is None:
            raw = self._raw[key] = collections.deque(
                maxlen=self.config.raw_points)
            self._rollups[key] = {
                step: _Rollup(width, self.config.rollup_points)
                for step, width in ROLLUPS}
        raw.append((t, v))
        for rollup in self._rollups[key].values():
            rollup.add(t, v)

    # ---------------------------------------------------------- durability

    def _segment_path(self, index: int) -> str:
        return os.path.join(self.dir, f"segment-{index:06d}.jsonl")

    def _persist_tick(self, t: float, points: dict[str, float]) -> None:
        if not self.dir:
            return
        try:
            os.makedirs(self.dir, exist_ok=True)
            if self._segment_file is None:
                self._segment_file = open(
                    self._segment_path(self._segment_index), "a")
                self._segment_lines = 0
                # prune on OPEN, not just rotation: the retained set
                # (open segment included) never exceeds the cap, and
                # recovery reads exactly what retention kept
                self._prune_segments()
            line = json.dumps({"t": t, "p": points})
            self._segment_file.write(line + "\n")
            self._segment_file.flush()
            self._segment_lines += 1
            if self._segment_lines >= self.config.segment_lines:
                self._rotate_segment()
        except OSError as e:
            # disk trouble must not take the sampler down: the in-memory
            # rings keep serving, and the next tick retries the disk
            log.warning("metrics history tick not persisted to %s: %s",
                        self.dir, e)
            self._close_segment()

    def _rotate_segment(self) -> None:
        """Close the full segment and start the next numbered one (the
        open happens lazily on the next tick, which also prunes);
        retention drops the OLDEST segments beyond the cap — a point
        newer than the cap is never the one pruned."""
        self._close_segment()
        self._segment_index += 1

    def _close_segment(self) -> None:
        if self._segment_file is not None:
            try:
                self._segment_file.close()
            except OSError:
                pass
            self._segment_file = None

    def _prune_segments(self) -> None:
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("segment-")
                           and n.endswith(".jsonl"))
            for name in names[:-self.config.max_segments]:
                os.unlink(os.path.join(self.dir, name))
            self._segments_gauge.set(
                min(len(names), self.config.max_segments))
        except OSError:
            pass

    def _recover(self) -> None:
        """Rebuild the rings from the retained segments (newest
        `max_segments`, oldest first so rollup buckets re-fold in
        arrival order); numbering continues after the newest segment.
        A torn trailing line (crash mid-append) is skipped, not fatal."""
        try:
            names = sorted(n for n in os.listdir(self.dir)
                           if n.startswith("segment-")
                           and n.endswith(".jsonl"))
        except OSError:
            return
        recovered = 0
        for name in names[-self.config.max_segments:]:
            try:
                with open(os.path.join(self.dir, name)) as f:
                    for line in f:
                        try:
                            tick = json.loads(line)
                        except ValueError:
                            continue  # torn tail
                        t = float(tick.get("t", 0.0))
                        for key, value in (tick.get("p") or {}).items():
                            self._append_locked(key, t, float(value))
                            recovered += 1
            except OSError:
                continue
        if names:
            last = names[-1]
            self._segment_index = int(last[len("segment-"):-len(".jsonl")])
            # resume appending to the newest segment only while it has
            # line budget left; otherwise start the next one
            try:
                with open(os.path.join(self.dir, last)) as f:
                    lines = sum(1 for _ in f)
            except OSError:
                lines = self.config.segment_lines
            if lines >= self.config.segment_lines:
                self._segment_index += 1
            else:
                self._segment_lines = lines
                try:
                    self._segment_file = open(
                        os.path.join(self.dir, last), "a")
                except OSError:
                    self._segment_file = None
        self._series_gauge.set(len(self._raw))
        self._segments_gauge.set(len(names))
        if recovered:
            self._recovered.inc(recovered)
            log.info("metrics history recovered %d points / %d series "
                     "from %s", recovered, len(self._raw), self.dir)

    # -------------------------------------------------------------- reads

    def series_index(self) -> dict[str, dict]:
        """{series: {points, newest_t}} — the discovery surface
        `GET /debug/history` serves when no metric is named."""
        with self._lock:
            return {key: {"points": len(ring),
                          "newest_t": ring[-1][0] if ring else None}
                    for key, ring in sorted(self._raw.items())}

    def _match_keys(self, metric: str) -> list[str]:
        """Series selected by a query: the exact series key, every
        labeled series of a base name, or a trailing-`*` prefix."""
        if metric.endswith("*"):
            prefix = metric[:-1]
            return [k for k in self._raw if k.startswith(prefix)]
        return [k for k in self._raw
                if k == metric or series_base(k) == metric]

    def query(self, metric: str, since: float = 0.0,
              step: str = "raw") -> dict:
        """Points for every series `metric` selects, at one resolution.
        `since` <= 0 is relative to now (-600 = the last ten minutes);
        raw points render as [t, value] pairs, rollup points as
        {t, min, max, mean, last, count} buckets."""
        if step not in STEPS:
            raise ValueError(f"unknown step {step!r} "
                             f"(one of {', '.join(STEPS)})")
        if since <= 0.0:
            since = (self.clock() + since) if since < 0.0 else 0.0
        with self._lock:
            keys = sorted(self._match_keys(metric))
            series: dict[str, list] = {}
            for key in keys:
                if step == "raw":
                    series[key] = [[t, v] for t, v in self._raw[key]
                                   if t > since]
                else:
                    series[key] = self._rollups[key][step].points(since)
        return {"metric": metric, "step": step, "since": since,
                "series": series}

    def incident_slice(self) -> dict:
        """The pre-incident raw window of the configured key series —
        registered as an incident-bundle collector so a bundle carries
        "what changed before it broke" without a live node."""
        window = self.config.incident_window_s
        since = self.clock() - window
        with self._lock:
            series = {}
            for key in sorted(self._raw):
                base = series_base(key)
                if not any(base == p or base.startswith(p)
                           for p in self.config.key_series):
                    continue
                points = [[t, v] for t, v in self._raw[key] if t > since]
                if points:
                    series[key] = points
        return {"window_s": window, "series": series,
                "key_series": list(self.config.key_series)}

    # ------------------------------------------------------------ running

    def start(self) -> "MetricsHistory":
        """Start the background sampler (no-op when sample_s <= 0)."""
        if self.config.sample_s <= 0 or self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(self.config.sample_s):
                try:
                    self.sample_once()
                except Exception:  # noqa: BLE001 — the sampler must
                    # survive any registry/disk hiccup
                    log.exception("metrics history sample failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="metrics-history")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.config.sample_s + 5)
            self._thread = None
        with self._lock:
            self._close_segment()
