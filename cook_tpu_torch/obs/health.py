"""Health verdict: fold device telemetry into one machine-readable answer.

A copy of `cook_tpu/obs/health.py`: the same reasons, thresholds and
verdict keys.

`GET /debug/health` serves this verdict.  Four degradation reasons, each
backed by its own detector:

  * `recompile-storm`        — CompileObservatory sliding-window flag
                               (padding-bucket churn: new padded shapes
                               reach the card faster than they repeat).
  * `quality-drift`          — QualityMonitor rolling-baseline anomaly or
                               parity-floor breach on sampled CPU shadow
                               solves.
  * `solve-latency-regression` — per-pool match-solve seconds risen out of
                               the rolling median/MAD band.
  * `device-oom-risk`        — device allocator utilization above the
                               risk threshold (unobservable on CPU; the
                               verdict says so instead of guessing).

The verdict is advisory — the scheduler keeps scheduling — but it is the
machine-readable hook for operators and autoscalers: production DL-cluster
schedulers treat exactly this telemetry as load-bearing for capacity and
preemption decisions (Aryl, arXiv:2202.07896; topology-aware preemptive
scheduling, arXiv:2411.11560)."""
from __future__ import annotations

import time
from typing import Callable, Optional

from cook_tpu_torch.obs.device_monitor import device_memory_stats
from cook_tpu_torch.utils.metrics import global_registry

RECOMPILE_STORM = "recompile-storm"
QUALITY_DRIFT = "quality-drift"
SOLVE_LATENCY_REGRESSION = "solve-latency-regression"
DEVICE_OOM_RISK = "device-oom-risk"
# a device solve of the pool failed (scheduler/matcher.note_solve_failed;
# the port re-solves nothing on the CPU); clears at the pool's next
# successful solve on the card
DEVICE_DEGRADED = "device-degraded"

DEGRADATION_REASONS = (RECOMPILE_STORM, QUALITY_DRIFT,
                       SOLVE_LATENCY_REGRESSION, DEVICE_OOM_RISK,
                       DEVICE_DEGRADED)


# device-oom-risk fires at or above this allocator fill fraction
OOM_THRESHOLD = 0.9


class HealthMonitor:
    """Stateless folder over the telemetry components (they own the
    rolling state); one instance per DeviceTelemetry."""

    def __init__(self, telemetry,
                 memory_stats_fn: Optional[Callable] = None):
        self.telemetry = telemetry
        self.oom_threshold = OOM_THRESHOLD
        self.memory_stats_fn = memory_stats_fn or device_memory_stats
        self._degraded_gauge = global_registry.gauge(
            "obs.health.degraded",
            "1 while /debug/health reports any degradation reason")
        self._reason_gauge = global_registry.gauge(
            "obs.health.reason_active",
            "1 while the labeled degradation reason is active")

    def verdict(self) -> dict:
        degradations: list[dict] = []

        storms = self.telemetry.observatory.storming_ops()
        for op, evidence in sorted(storms.items()):
            degradations.append({
                "reason": RECOMPILE_STORM, "op": op,
                "detail": (
                    f"{evidence['compiles_in_window']} new padded shapes in "
                    f"the last {evidence['window']} {op} solves "
                    f"(threshold {evidence['threshold']}) — padded-shape "
                    f"churn; check bucket sizing"),
                **evidence,
            })

        drifting = self.telemetry.quality.drifting_pools()
        for pool, evidence in sorted(drifting.items()):
            degradations.append({
                "reason": QUALITY_DRIFT, "pool": pool,
                "detail": (
                    f"pool {pool} packing efficiency "
                    f"{evidence['efficiency']:.4f} vs CPU reference "
                    f"({evidence['kind']}) — lower chunk or raise "
                    f"chunk_kc"),
                **evidence,
            })

        latency = self.telemetry.latency_regressions()
        for pool, evidence in sorted(latency.items()):
            degradations.append({
                "reason": SOLVE_LATENCY_REGRESSION, "pool": pool,
                "detail": (
                    f"pool {pool} match-solve recent median "
                    f"{evidence['recent'] * 1000:.1f} ms vs baseline "
                    f"{evidence['baseline'] * 1000:.1f} ms"),
                **evidence,
            })

        fallbacks = getattr(self.telemetry, "device_fallbacks",
                            lambda: {})()
        for pool, evidence in sorted(fallbacks.items()):
            degradations.append({
                "reason": DEVICE_DEGRADED, "pool": pool,
                "detail": (
                    f"pool {pool} device solve failed "
                    f"({evidence.get('cause', '?')}, "
                    f"{evidence.get('cycles', 0)} cycles so far) — its "
                    f"jobs wait until a solve on the card succeeds; "
                    f"investigate the device"),
                **evidence,
            })

        memory = self.memory_stats_fn()
        if memory is not None and memory["utilization"] >= self.oom_threshold:
            degradations.append({
                "reason": DEVICE_OOM_RISK,
                "detail": (
                    f"device memory {memory['utilization']:.0%} of "
                    f"{memory['bytes_limit'] / 2**30:.1f} GiB "
                    f"(threshold {self.oom_threshold:.0%})"),
                **memory,
            })

        healthy = not degradations
        self._degraded_gauge.set(0.0 if healthy else 1.0)
        active = {d["reason"] for d in degradations}
        for reason in DEGRADATION_REASONS:
            self._reason_gauge.set(1.0 if reason in active else 0.0,
                                   {"reason": reason})
        return {
            "healthy": healthy,
            "status": "ok" if healthy else "degraded",
            "degradations": degradations,
            "reasons": sorted(active),
            "checks": {
                "compile": self.telemetry.observatory.stats(),
                "quality": self.telemetry.quality.stats(),
                "solve_latency": self.telemetry.latency_stats(),
                "device_fallback": fallbacks,
                "device_memory": (memory if memory is not None
                                  else {"observable": False}),
            },
            "wall_time": time.time(),
        }
