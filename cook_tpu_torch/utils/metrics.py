"""Metrics registry: counters, gauges, histograms with Prometheus text
rendering.

A copy of `cook_tpu/utils/metrics.py` (the port's own registry: the
rebalance counters and the fairness observatory's gauges land here).

Reference: cook.prometheus-metrics (/root/reference/scheduler/src/cook/
prometheus_metrics.clj — ~200 named metrics + `with-duration` wrappers
around every hot section) and the codahale stack (reporter.clj).  One
process-global registry; the REST /metrics endpoint renders it.
"""
from __future__ import annotations

import math
import threading
import time
from contextlib import contextmanager
from typing import Iterable, Optional


def _labels_key(labels: Optional[dict]) -> tuple:
    return tuple(sorted((labels or {}).items()))


def prometheus_name(name: str) -> str:
    """The exposition-time mapping from registry names to Prometheus
    identifiers — THE definition; every consumer that needs to match
    rendered names against registry names (obs/fleet.parse_headline,
    tools/lint_metrics standalone copy) must agree with it."""
    return "cook_" + name.replace(".", "_").replace("-", "_")


class BoundCounter:
    """A counter pre-bound to one label set (the prometheus-client
    `labels()` child pattern): `inc()` skips the per-call label-dict
    sort, for call sites hot enough that microseconds add up (the
    store-lock profiler)."""

    __slots__ = ("_parent", "_key")

    def __init__(self, parent: "Counter", key: tuple):
        self._parent = parent
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        parent = self._parent
        with parent._lock:
            parent._values[self._key] = \
                parent._values.get(self._key, 0.0) + amount


class Counter:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, labels: Optional[dict] = None) -> None:
        key = _labels_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def bind(self, labels: Optional[dict] = None) -> BoundCounter:
        return BoundCounter(self, _labels_key(labels))

    def value(self, labels: Optional[dict] = None) -> float:
        return self._values.get(_labels_key(labels), 0.0)


class Gauge:
    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._values: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, labels: Optional[dict] = None) -> None:
        with self._lock:
            self._values[_labels_key(labels)] = value

    def bind(self, labels: Optional[dict] = None) -> "BoundGauge":
        return BoundGauge(self, _labels_key(labels))

    def remove(self, labels: Optional[dict] = None) -> None:
        """Drop one label set entirely (a per-user/per-entity gauge
        whose subject went away must stop being exported, not freeze at
        its last value)."""
        with self._lock:
            self._values.pop(_labels_key(labels), None)

    def value(self, labels: Optional[dict] = None) -> float:
        return self._values.get(_labels_key(labels), 0.0)


class BoundGauge:
    """See BoundCounter."""

    __slots__ = ("_parent", "_key")

    def __init__(self, parent: Gauge, key: tuple):
        self._parent = parent
        self._key = key

    def set(self, value: float) -> None:
        parent = self._parent
        with parent._lock:
            parent._values[self._key] = value


_DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                    0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, math.inf)


class Histogram:
    def __init__(self, name: str, help_: str = "",
                 buckets: Iterable[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.buckets = tuple(buckets)
        if not self.buckets or self.buckets[-1] != math.inf:
            # every observation must land in a bucket or _count undercounts
            self.buckets += (math.inf,)
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = {}
        self._lock = threading.Lock()

    def observe(self, value: float, labels: Optional[dict] = None) -> None:
        self._observe_key(_labels_key(labels), value)

    def _observe_key(self, key: tuple, value: float) -> None:
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    break
            self._sums[key] = self._sums.get(key, 0.0) + value

    def bind(self, labels: Optional[dict] = None) -> "BoundHistogram":
        return BoundHistogram(self, _labels_key(labels))

    def count(self, labels: Optional[dict] = None) -> int:
        return sum(self._counts.get(_labels_key(labels), []))

    def sum(self, labels: Optional[dict] = None) -> float:
        return self._sums.get(_labels_key(labels), 0.0)

    @contextmanager
    def time(self, labels: Optional[dict] = None):
        """The `with-duration` analog."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(time.perf_counter() - t0, labels)


class BoundHistogram:
    """See BoundCounter."""

    __slots__ = ("_parent", "_key")

    def __init__(self, parent: Histogram, key: tuple):
        self._parent = parent
        self._key = key

    def observe(self, value: float) -> None:
        self._parent._observe_key(self._key, value)


class Registry:
    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(name, lambda: Counter(name, help_), Counter)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(name, lambda: Gauge(name, help_), Gauge)

    def histogram(self, name: str, help_: str = "",
                  buckets: Optional[Iterable[float]] = None) -> Histogram:
        return self._get(
            name,
            lambda: Histogram(name, help_, buckets or _DEFAULT_BUCKETS),
            Histogram)

    def _get(self, name, factory, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = factory()
                self._metrics[name] = m
            if not isinstance(m, cls):
                raise TypeError(f"metric {name} is {type(m)}, wanted {cls}")
            return m

    def render_prometheus(self) -> str:
        # snapshot the metric set under the registry lock, then each
        # metric's values under ITS lock: a writer mutating a dict (or a
        # histogram's counts/sums pair) mid-render would corrupt (or
        # tear) the exposition otherwise
        with self._lock:
            metrics = sorted(self._metrics.items())
        lines = []
        for name, metric in metrics:
            pname = prometheus_name(name)
            if metric.help:
                lines.append(f"# HELP {pname} {_escape_help(metric.help)}")
            if isinstance(metric, Counter):
                lines.append(f"# TYPE {pname} counter")
                with metric._lock:
                    values = sorted(metric._values.items())
                for key, v in values:
                    lines.append(f"{pname}{_fmt_labels(key)} {v}")
            elif isinstance(metric, Gauge):
                lines.append(f"# TYPE {pname} gauge")
                with metric._lock:
                    values = sorted(metric._values.items())
                for key, v in values:
                    lines.append(f"{pname}{_fmt_labels(key)} {v}")
            elif isinstance(metric, Histogram):
                lines.append(f"# TYPE {pname} histogram")
                with metric._lock:
                    all_counts = sorted(
                        (key, list(counts), metric._sums.get(key, 0.0))
                        for key, counts in metric._counts.items())
                for key, counts, total in all_counts:
                    cum = 0
                    for b, c in zip(metric.buckets, counts):
                        cum += c
                        le = "+Inf" if b == math.inf else repr(b)
                        lines.append(
                            f"{pname}_bucket{_fmt_labels(key + (('le', le),))} {cum}"
                        )
                    lines.append(f"{pname}_count{_fmt_labels(key)} {cum}")
                    lines.append(f"{pname}_sum{_fmt_labels(key)} {total}")
        return "\n".join(lines) + "\n"


def _escape_label_value(value) -> str:
    """Prometheus exposition label-value escaping: backslash, double
    quote, and newline would otherwise corrupt the output line."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(key: tuple) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in key)
    return "{" + inner + "}"


global_registry = Registry()
