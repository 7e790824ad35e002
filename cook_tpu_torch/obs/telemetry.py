"""DeviceTelemetry: the facade the scheduler owns.

A copy of `cook_tpu/obs/telemetry.py` (its incident hook,
`health_observer`, the scheduler points at `obs/incident.
IncidentRecorder.observe`).  The solve seconds it is given end in the device-
to-host copy of the result (`ops/common.fetch_result`), never at an
asynchronous launch, and the memory-gauge refresh reads host-side
allocator counters (`obs/device_monitor.py`), so it adds no device sync.

One instance per Scheduler.  Every device solve — match (per-pool and
pool-batched), rank, rebalance — reports through `record_solve`, which
feeds the compile observatory, the per-pool solve-latency baselines, the
device-memory gauges, and the per-pool "last solve" snapshot that
`/unscheduled_jobs` and `/debug/cycles` surface so operators can
correlate reason codes with compile behavior."""
from __future__ import annotations

import threading
import time
from typing import Optional

from cook_tpu_torch.obs.baseline import RollingBaseline
from cook_tpu_torch.obs.compile_observatory import (CompileObservatory,
                                                    shape_signature)
from cook_tpu_torch.obs.device_monitor import update_device_memory_gauges
from cook_tpu_torch.obs.health import HealthMonitor
from cook_tpu_torch.obs.quality_monitor import QualityMonitor
from cook_tpu_torch.utils.metrics import global_registry

# wide buckets: a first launch that builds the kernels can cost tens of
# seconds while a warm smoke-size solve is sub-millisecond
SOLVE_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
                 float("inf"))


class DeviceTelemetry:
    def __init__(self, *, storm_window: int = 32, storm_threshold: int = 4,
                 storm_warmup: Optional[int] = None,
                 quality_sample_every: int = 25,
                 latency_window: int = 64, latency_recent: int = 8,
                 latency_min_samples: int = 12,
                 latency_rel_floor: Optional[float] = None,
                 memory_stats_fn=None,
                 update_memory_gauges: bool = True):
        self.observatory = CompileObservatory(window=storm_window,
                                              storm_threshold=storm_threshold,
                                              warmup_solves=storm_warmup)
        self.quality = QualityMonitor(sample_every=quality_sample_every)
        self.health_monitor = HealthMonitor(self,
                                            memory_stats_fn=memory_stats_fn)
        self._latency_args = dict(window=latency_window,
                                  recent=latency_recent,
                                  min_samples=latency_min_samples)
        if latency_rel_floor is not None:
            # widen the anomaly band's relative floor (tests / noisy
            # hosts: a short `recent` window on millisecond solves can
            # trip on scheduler jitter alone)
            self._latency_args["rel_floor"] = latency_rel_floor
        self._latency: dict[str, RollingBaseline] = {}
        self._last_solve: dict[str, dict] = {}
        # pools currently degraded to the CPU reference solver
        # (scheduler/matcher device fallback): pool -> evidence for the
        # `device-degraded` health reason
        self._fallbacks: dict[str, dict] = {}
        self._lock = threading.Lock()
        # incident hook (obs/incident.IncidentRecorder.observe): every
        # health() verdict reports through it so ok->degraded transitions
        # capture evidence bundles even when no REST probe is watching
        self.health_observer = None
        self._update_memory_gauges = update_memory_gauges
        self._fallback_gauge = global_registry.gauge(
            "obs.device_fallback_active",
            "1 while the pool's match solve is degraded to the CPU "
            "reference solver")
        self._memory_stats_fn = memory_stats_fn
        self._solve_hist = global_registry.histogram(
            "obs.solve.seconds",
            "device solve wall seconds (dispatch + execute + D2H fetch) "
            "per op/backend", buckets=SOLVE_BUCKETS)

    # ------------------------------------------------------------- recording

    def record_solve(self, op: str, shape, backend: str,
                     seconds: Optional[float] = None,
                     pool: Optional[str] = None) -> bool:
        """Report one device solve; returns True when it paid a compile
        (first-seen (op, shape, backend) key).  `seconds` feeds the
        latency histogram; match solves additionally feed the per-pool
        regression baseline via `record_match_solve`."""
        compiled = self.observatory.observe_solve(op, shape, backend)
        if seconds is not None:
            self._solve_hist.observe(seconds, {"op": op, "backend": backend})
        if pool is not None:
            sig = shape if isinstance(shape, str) else shape_signature(shape)
            with self._lock:
                self._last_solve[pool] = {
                    "op": op, "shape": sig, "backend": backend,
                    "compiled": compiled,
                    **({"seconds": seconds} if seconds is not None else {}),
                }
        return compiled

    def record_match_solve(self, pool: str, shape, backend: str,
                           seconds: float,
                           overlapped: bool = False) -> bool:
        """The per-pool match path's entry point: compile accounting +
        per-pool latency baseline + device-memory gauge refresh.
        `overlapped=True` (the pipelined cycle) keeps the wall out of
        EVERY latency surface — regression baseline, solve histogram,
        and the per-pool last-solve snapshot: the pipelined solve wall
        (dispatch -> fetch) deliberately spans neighbor pools' host
        work, so there is no honest device-latency scalar to export —
        publishing the inflated one would fire phantom regressions the
        moment the pipeline is enabled.  Compile accounting still runs
        (it is shape-keyed, not time-keyed)."""
        compiled = self.record_solve(
            "match", shape, backend,
            None if overlapped else seconds, pool=pool)
        if not overlapped:
            self._observe_latency(pool, seconds, compiled)
        self._refresh_memory_gauges()
        return compiled

    def record_batched_match_solve(self, pools: list, shape, backend: str,
                                   seconds: float) -> bool:
        """The pool-batched path: ONE stacked solve served every pool, so
        the observatory sees one solve (op `match_batched`), while each
        participating pool's latency baseline observes the shared batch
        wall time (no pool's cycle can finish sooner than the batch)."""
        compiled = self.observatory.observe_solve("match_batched", shape,
                                                  backend)
        self._solve_hist.observe(seconds,
                                 {"op": "match_batched", "backend": backend})
        sig = shape if isinstance(shape, str) else shape_signature(shape)
        for pool in pools:
            with self._lock:
                self._last_solve[pool] = {
                    "op": "match_batched", "shape": sig, "backend": backend,
                    "compiled": compiled, "seconds": seconds,
                }
            self._observe_latency(pool, seconds, compiled)
        self._refresh_memory_gauges()
        return compiled

    def _observe_latency(self, pool: str, seconds: float,
                         compiled: bool) -> None:
        with self._lock:
            baseline = self._latency.get(pool)
            if baseline is None:
                baseline = RollingBaseline(**self._latency_args)
                self._latency[pool] = baseline
            # a first-seen shape is not a latency sample: the first run
            # of a new padded shape (on the card, the first launch pays
            # the kernel build too) would poison the baseline (or mask a
            # real regression behind a giant MAD band)
            if not compiled:
                baseline.add(seconds)

    def _refresh_memory_gauges(self) -> None:
        if not self._update_memory_gauges:
            return
        if self._memory_stats_fn is not None:
            update_device_memory_gauges(self._memory_stats_fn)
        else:
            update_device_memory_gauges()

    # ------------------------------------------------------ device fallback

    def note_device_fallback(self, pool: str, reason: str, *,
                             cycles_left: int = 0) -> None:
        """The matcher solved this pool on the CPU reference this cycle
        (the reference's scheduler/matcher.record_fallback_outcome; the
        port has no device-fallback ladder, so nothing calls this yet)."""
        with self._lock:
            entry = self._fallbacks.get(pool)
            if entry is None:
                # key is "cause", NOT "reason": the dict is spread into
                # the health degradation entry, whose "reason" key is the
                # verdict constant (device-degraded)
                entry = self._fallbacks[pool] = {
                    "cause": reason, "since": time.time(), "cycles": 0}
            entry["cause"] = reason
            entry["cycles"] += 1
            entry["cycles_left"] = cycles_left
        self._fallback_gauge.set(1.0, {"pool": pool})

    def clear_device_fallback(self, pool: str) -> None:
        """The device probe succeeded; the pool is healthy again."""
        with self._lock:
            self._fallbacks.pop(pool, None)
        self._fallback_gauge.set(0.0, {"pool": pool})

    def device_fallbacks(self) -> dict[str, dict]:
        with self._lock:
            return {pool: dict(e) for pool, e in self._fallbacks.items()}

    # ---------------------------------------------------------------- reads

    def solve_info(self, pool: str) -> Optional[dict]:
        """The pool's last device solve: padded shape, backend, whether
        it compiled — the `/unscheduled_jobs` correlation fields."""
        with self._lock:
            info = self._last_solve.get(pool)
            return dict(info) if info is not None else None

    def latency_regressions(self) -> dict[str, dict]:
        # snapshot under the owning lock: the REST thread reads while
        # the scheduler thread appends, and iterating a deque mid-append
        # raises RuntimeError
        with self._lock:
            out = {}
            for pool, baseline in self._latency.items():
                anomaly = baseline.anomaly_high()
                if anomaly is not None:
                    out[pool] = anomaly
            return out

    def latency_stats(self) -> dict:
        with self._lock:
            return {pool: (b.snapshot() or {"n": len(b)})
                    for pool, b in self._latency.items()}

    def health(self, observe: bool = True) -> dict:
        """The device-side verdict (obs/health.HealthMonitor), reported to
        `health_observer` (the incident recorder) when one is set.
        `observe=False` is for callers that MERGE this verdict with other
        degradation sources before reporting (rest/api.health_verdict) —
        observing both the partial and the merged verdict would read a
        contention-only degradation as an ok->degraded flap on every
        probe."""
        verdict = self.health_monitor.verdict()
        if observe and self.health_observer is not None:
            self.health_observer(verdict)
        return verdict
