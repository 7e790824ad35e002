"""The traced run's device timeline, read from `torch.profiler`'s Chrome
trace: device intervals (kernels, copies, sets), the benchmark's own
spans (`bench.window` around the window, `bench.<step>` around each
step of a cycle) and which kernels each span launched (by the runtime
call's correlation id)."""
from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
STEP_SPANS = ("bench.submit", "bench.rank", "bench.match",
              "bench.rebalance")


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def merged(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Timeline:
    """The parsed trace.  Times are microseconds on the trace's clock."""

    def __init__(self, events: list):
        self.window = None
        self.spans = defaultdict(list)        # name -> [(start, end)]
        self.device = []                      # (start, end, name, cat, corr)
        launches = []                         # (ts, correlation)
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            name = ev.get("name", "")
            ts = float(ev.get("ts", 0.0))
            end = ts + float(ev.get("dur", 0.0))
            if cat in DEVICE_CATS:
                corr = (ev.get("args") or {}).get("correlation")
                self.device.append((ts, end, name, cat, corr))
            elif cat == "user_annotation" and name.startswith("bench."):
                if name == "bench.window":
                    self.window = (ts, end)
                else:
                    self.spans[name].append((ts, end))
            elif cat in ("cuda_runtime", "cuda_driver"):
                corr = (ev.get("args") or {}).get("correlation")
                if corr is not None:
                    launches.append((ts, corr))
        self.launch_ts = dict((c, t) for t, c in launches)
        if self.window is None:
            raise RuntimeError("the trace holds no bench.window span")
        w0, w1 = self.window
        self.device = [d for d in self.device if d[1] > w0 and d[0] < w1]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list:
        w0, w1 = self.window
        return [(max(s, w0), min(e, w1)) for s, e, *_ in self.device]

    def busy_s(self) -> float:
        return union_seconds(self.busy_intervals()) / 1e6

    def launched_in(self, span: str) -> list:
        """Device intervals whose runtime call ran inside a `span`."""
        spans = sorted(self.spans.get(span, []))
        if not spans:
            return []
        starts = np.array([s for s, _ in spans])
        ends = np.array([e for _, e in spans])
        out = []
        for d in self.device:
            t = self.launch_ts.get(d[4])
            if t is None:
                continue
            i = int(np.searchsorted(starts, t, side="right")) - 1
            if i >= 0 and t <= ends[i]:
                out.append(d)
        return out

    def device_ops(self, top: int = 10) -> list:
        by_name = defaultdict(float)
        for s, e, name, *_ in self.device:
            by_name[name] += (e - s) / 1e6
        return sorted(([n, v] for n, v in by_name.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time in the window, split by the benchmark span
        open at each moment of it (`bench.loop` between steps)."""
        w0, w1 = self.window
        busy = merged(self.busy_intervals())
        gaps, prev = [], w0
        for s, e in busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if prev < w1:
            gaps.append((prev, w1))
        spans = sorted((s, e, name) for name in STEP_SPANS
                       for s, e in self.spans.get(name, []))
        by_label = defaultdict(float)
        i = 0
        for g0, g1 in gaps:
            while i < len(spans) and spans[i][1] <= g0:
                i += 1
            covered = 0.0
            k = i
            while k < len(spans) and spans[k][0] < g1:
                s, e, name = spans[k]
                part = min(e, g1) - max(s, g0)
                if part > 0:
                    by_label[name] += part / 1e6
                    covered += part
                k += 1
            by_label["bench.loop"] += ((g1 - g0) - covered) / 1e6
        return sorted(([n, v] for n, v in by_label.items() if v > 0),
                      key=lambda x: -x[1])[:top]


class Profiler:
    """`torch.profiler` over the window, CPU and CUDA activities; the
    trace goes to a file under the run's TMPDIR and is removed once
    read."""

    def __init__(self):
        import torch

        self.torch = torch
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)

    def span(self, name: str):
        return self.torch.profiler.record_function(name)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.torch.cuda.synchronize()
        return self.prof.__exit__(*exc)

    def timeline(self) -> Timeline:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        return Timeline(events)
