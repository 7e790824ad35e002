"""Rolling-baseline anomaly detection: median/MAD over a bounded window.

One detector serves both drift directions: the quality monitor flags a
packing-efficiency DROP, the latency tracker flags a solve-time RISE.
The baseline is the median of the window's older samples; the recent
median is compared against a band of `k_mad` median-absolute-deviations
(floored at `rel_floor` of the baseline, so a perfectly flat baseline —
MAD 0 — doesn't flag measurement noise).

A copy of `cook_tpu/obs/baseline.py`: the fairness observatory's Jain-index
drift baseline."""
from __future__ import annotations

import collections
import statistics
from typing import Optional


class RollingBaseline:
    """Bounded sample window with median/MAD deviation scoring.

    Not thread-safe by itself; owners serialize (DeviceTelemetry holds
    one per pool and feeds it from the cycle's driving thread)."""

    def __init__(self, window: int = 64, recent: int = 8,
                 min_samples: int = 12, k_mad: float = 6.0,
                 rel_floor: float = 0.05):
        assert recent < window, "recent span must leave baseline samples"
        self.window = window
        self.recent = recent
        self.min_samples = min_samples
        self.k_mad = k_mad
        self.rel_floor = rel_floor
        self._samples: collections.deque[float] = collections.deque(
            maxlen=window)

    def add(self, value: float) -> None:
        self._samples.append(float(value))

    def __len__(self) -> int:
        return len(self._samples)

    def snapshot(self) -> Optional[dict]:
        """{baseline, recent, mad, band, deviation, n} or None while the
        window is too small to judge.  `deviation` is the recent median's
        signed relative excursion past the anomaly band: 0 inside the
        band, positive above it, negative below it."""
        samples = list(self._samples)
        if len(samples) < self.min_samples:
            return None
        base = samples[:-self.recent]
        recent = samples[-self.recent:]
        baseline = statistics.median(base)
        recent_median = statistics.median(recent)
        mad = statistics.median(abs(s - baseline) for s in base)
        band = max(self.k_mad * mad, self.rel_floor * abs(baseline))
        excess = 0.0
        if recent_median > baseline + band:
            excess = recent_median - (baseline + band)
        elif recent_median < baseline - band:
            excess = recent_median - (baseline - band)
        scale = abs(baseline) if baseline else 1.0
        return {
            "baseline": baseline,
            "recent": recent_median,
            "mad": mad,
            "band": band,
            "deviation": excess / scale,
            "n": len(samples),
        }

    def anomaly_high(self) -> Optional[dict]:
        """Snapshot when the recent median sits ABOVE the band (latency
        regression direction); None otherwise."""
        snap = self.snapshot()
        return snap if snap is not None and snap["deviation"] > 0 else None

    def anomaly_low(self) -> Optional[dict]:
        """Snapshot when the recent median sits BELOW the band (quality
        drift direction); None otherwise."""
        snap = self.snapshot()
        return snap if snap is not None and snap["deviation"] < 0 else None
