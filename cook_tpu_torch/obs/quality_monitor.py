"""Online solution-quality monitor: sampled CPU shadow solves + drift.

A copy of `cook_tpu/obs/quality_monitor.py`: the shadow solve is the
port's `ops/cpu_reference.np_greedy_match`, and its fetches of the
problem tensors are detached from the cycle's data-plane scope and tagged
`fallback`, as in the reference.  Sample listeners (`add_listener`) see
every recorded sample: the quantization parity guard
(scheduler/device_state.py) rides them.

The reference's periodic exact-kernel audit (not ported) guards one
cycle's parity; this monitor guards the TREND.  Every
`sample_every`-th solvable cycle per pool it shadow-solves the SAME
problem with the reference-faithful numpy greedy
(`ops/cpu_reference.np_greedy_match` — identical decision semantics to
Fenzo's sequential scheduleOnce) and records the packing-efficiency
ratio (device-placed demand weight / reference-placed demand weight)
into a rolling baseline.  A recent-median drop out of the median/MAD
band — or below the absolute parity floor — is **quality drift**, one of
the four `/debug/health` degradation reasons.

Shadow solves run host-side on the unpadded problem (<= the pool's
considerable cap, ~1000 jobs by default), bounded by `max_shadow_jobs`
so a misconfigured pool can't stall a match cycle on an O(J·N) replay.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np

from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.obs.baseline import RollingBaseline
from cook_tpu_torch.ops import cpu_reference as ref
from cook_tpu_torch.ops.common import fetch_result
from cook_tpu_torch.utils.callbacks import notify_all
from cook_tpu_torch.utils.metrics import global_registry


# the parity floor: a sampled efficiency below it is quality drift
PARITY_FLOOR = 0.97
# the per-pool efficiency baseline's window (obs/baseline.RollingBaseline)
BASELINE_ARGS = dict(window=32, recent=4, min_samples=8, rel_floor=0.02)


class QualityMonitor:
    def __init__(self, sample_every: int = 25, max_shadow_jobs: int = 4096):
        self.sample_every = sample_every  # <= 0 disables shadow sampling
        self.floor = PARITY_FLOOR
        self.max_shadow_jobs = max_shadow_jobs
        self._cycles: dict[str, int] = {}
        self._baselines: dict[str, RollingBaseline] = {}
        self._last: dict[str, float] = {}
        self._in_drift: dict[str, bool] = {}
        # sample listeners (fn(pool, ratio)): the quantization parity
        # guard (scheduler/device_state.py) rides every shadow-solve
        # sample this way — ONE wiring site covers the serial, batched
        # and pipelined paths
        self._listeners: list = []
        self._lock = threading.Lock()
        self._gauge = global_registry.gauge(
            "obs.quality.efficiency",
            "sampled packing efficiency: device solve vs CPU reference "
            "greedy (placed demand weight ratio)")
        self._drift_counter = global_registry.counter(
            "obs.quality.drift_events",
            "quality-drift onsets per pool (edge-triggered: one sustained "
            "episode counts once)")
        self._shadow_counter = global_registry.counter(
            "obs.quality.shadow_solves", "CPU shadow solves run per pool")

    def due(self, pool: str) -> bool:
        """Count one solvable cycle; True on the sampled ones."""
        if self.sample_every <= 0:
            return False
        with self._lock:
            n = self._cycles.get(pool, 0) + 1
            self._cycles[pool] = n
        return n % self.sample_every == 0

    def observe_cycle(self, prepared, assignment, pool: str,
                      ) -> Optional[float]:
        """Shadow-solve when due; returns the efficiency ratio when a
        shadow ran, else None.  `prepared` is the matcher's PreparedPool
        (problem + considerable); `assignment` the device decision for
        the unpadded jobs."""
        if prepared is None or getattr(prepared, "problem", None) is None:
            return None
        if not self.due(pool):
            return None
        n_jobs = len(prepared.considerable)
        if n_jobs == 0 or n_jobs > self.max_shadow_jobs:
            return None
        return self.shadow_solve(prepared, np.asarray(assignment), pool)

    def shadow_solve(self, prepared, assignment: np.ndarray,
                     pool: str) -> float:
        n_jobs = len(prepared.considerable)
        problem = prepared.problem
        # the padded tensors were built for the kernel; fetch the unpadded
        # rows back (D2H via the one shared completion-observing fetch).
        # Detached + fallback-bucketed: these fetches are reference-
        # sampling overhead — they must neither inflate device-family
        # transfer numbers nor land on the driving cycle's record (a
        # speculation hit's only data-plane transfer stays the
        # assignment fetch)
        with data_plane.detached(), \
                data_plane.family(data_plane.FAM_FALLBACK):
            # f32 casts: quantized pools carry bf16 cost tensors, and
            # the reference solve + weight math must run at full width
            # (the ratio then measures exactly quantized-vs-f32 parity)
            demands = fetch_result(
                problem.demands)[:n_jobs].astype(np.float32)
            n_nodes = (prepared.nodes.n if prepared.nodes is not None
                       else fetch_result(problem.avail).shape[0])
            avail = fetch_result(
                problem.avail)[:n_nodes].astype(np.float32)
            totals = fetch_result(
                problem.totals)[:n_nodes].astype(np.float32)
        feasible = prepared.feasible
        # np_greedy_match is resource-count generic: pass every column
        # (mem, cpus, gpus, disk...) so feasibility matches the kernel's
        ref_assign = ref.np_greedy_match(
            demands, avail, totals,
            feasible_mask=(np.asarray(feasible)[:n_jobs, :n_nodes]
                           if feasible is not None else None))
        ratio = self._efficiency(demands, assignment[:n_jobs], ref_assign)
        self.record_sample(pool, ratio)
        self._shadow_counter.inc(labels={"pool": pool})
        return ratio

    @staticmethod
    def _efficiency(demands: np.ndarray, device_assign: np.ndarray,
                    ref_assign: np.ndarray) -> float:
        """Placed-demand-weight ratio, each resource normalized by the
        problem's mean demand so no single resource dominates (same
        weighting as the matcher's exact-kernel audit)."""
        scale = np.maximum(demands.mean(axis=0), 1e-9)
        weights = (demands[:, :3] / scale[:3]).sum(axis=-1)
        ref_w = float(weights[ref_assign >= 0].sum())
        dev_w = float(weights[device_assign >= 0].sum())
        if ref_w <= 0:
            # reference placed nothing: degenerate problem, not evidence
            return 1.0
        return dev_w / ref_w

    def add_listener(self, fn) -> None:
        """Register fn(pool, ratio), called on every recorded sample
        (outside the monitor lock; must not call back into the
        monitor)."""
        with self._lock:
            self._listeners.append(fn)

    def record_sample(self, pool: str, ratio: float) -> None:
        """Feed one efficiency sample (the shadow path calls this; tests
        and offline replays can inject samples directly).  Listener
        failures are logged, never propagated — a guard must not cost
        the monitor its sample."""
        notify_all(self._listeners, f"quality-sample pool={pool}",
                   pool, ratio)
        with self._lock:
            baseline = self._baselines.get(pool)
            if baseline is None:
                baseline = RollingBaseline(**BASELINE_ARGS)
                self._baselines[pool] = baseline
            baseline.add(ratio)
            self._last[pool] = ratio
        self._gauge.set(ratio, {"pool": pool})
        # edge-trigger (like the observatory's storm onsets): a pool
        # sitting in drift for an hour is ONE event, not one per sample —
        # a rate() on this counter must read episodes, not sample cadence
        drifting = self._drift_detail(pool) is not None
        with self._lock:
            onset = drifting and not self._in_drift.get(pool, False)
            self._in_drift[pool] = drifting
        if onset:
            self._drift_counter.inc(labels={"pool": pool})

    def _drift_detail(self, pool: str) -> Optional[dict]:
        # the anomaly read iterates the baseline deque: it must happen
        # under the lock or a concurrent record_sample append (scheduler
        # thread vs REST health probe) raises RuntimeError
        with self._lock:
            baseline = self._baselines.get(pool)
            last = self._last.get(pool)
            if baseline is None or last is None:
                return None
            if last < self.floor:
                return {"pool": pool, "efficiency": last,
                        "floor": self.floor, "kind": "parity-floor"}
            anomaly = baseline.anomaly_low()
        if anomaly is not None:
            return {"pool": pool, "efficiency": last,
                    "kind": "rolling-baseline", **anomaly}
        return None

    def drifting_pools(self) -> dict[str, dict]:
        """Pools currently in quality drift, with evidence — the health
        verdict's quality-drift input."""
        with self._lock:
            pools = list(self._baselines)
        out = {}
        for pool in pools:
            detail = self._drift_detail(pool)
            if detail is not None:
                out[pool] = detail
        return out

    def stats(self) -> dict:
        with self._lock:
            return {
                pool: {"last": self._last.get(pool),
                       "samples": len(b),
                       **({"snapshot": b.snapshot()} if b.snapshot() else {})}
                for pool, b in self._baselines.items()
            }
