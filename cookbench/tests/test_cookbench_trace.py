"""The trace arithmetic on hand-made inputs: the union of busy intervals,
the idle gaps, the kernels a span launched, and the roofline's bytes."""
from __future__ import annotations

import pytest

from cookbench.metrics import work
from cookbench.trace import Timeline, union_seconds


def ev(name, cat, ts, dur, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def timeline():
    return Timeline([
        ev("bench.window", "user_annotation", 0, 1000),
        ev("bench.rank", "user_annotation", 0, 300),
        ev("bench.match", "user_annotation", 300, 500),
        ev("cudaLaunchKernel", "cuda_runtime", 50, 5, corr=1),
        ev("cudaLaunchKernel", "cuda_runtime", 400, 5, corr=2),
        ev("cudaLaunchKernel", "cuda_runtime", 410, 5, corr=3),
        ev("k_rank", "kernel", 100, 100, corr=1),
        # two overlapping kernels on two streams: the union counts once
        ev("k_match", "kernel", 450, 100, corr=2),
        ev("k_match", "kernel", 500, 100, corr=3),
        ev("Memcpy DtoH", "gpu_memcpy", 900, 50, corr=4),
        # outside the window
        ev("k_late", "kernel", 2000, 100, corr=5),
    ])


def test_union_is_not_the_sum():
    assert union_seconds([(0, 10), (5, 15), (20, 30)]) == 25
    assert union_seconds([]) == 0


def test_busy_and_idle():
    t = timeline()
    assert t.window_s == pytest.approx(1000e-6)
    # 100 (rank) + 150 (two match kernels, overlapped) + 50 (copy)
    assert t.busy_s() == pytest.approx(300e-6)


def test_kernels_of_a_span():
    got = sorted((s, e) for s, e, *_ in timeline().launched_in("bench.match"))
    assert got == [(450, 550), (500, 600)]


def test_idle_gaps_by_span():
    gaps = dict(timeline().idle_gaps())
    # idle: 0-100 and 200-300 (rank), 300-450 (match), 600-800 in match
    # until 800, 800-900 and 950-1000 outside any step span
    assert gaps["bench.rank"] == pytest.approx(200e-6)
    assert gaps["bench.match"] == pytest.approx(350e-6)
    assert gaps["bench.loop"] == pytest.approx(150e-6)


def test_device_ops_sum_by_name():
    ops = dict(timeline().device_ops())
    assert ops["k_match"] == pytest.approx(200e-6)
    assert "k_late" not in ops


def test_match_bytes():
    # 16,384 jobs x 10,000 hosts: demands 12 J, avail 12 N, totals 8 N,
    # one bit a pair, the assignment 4 J
    j, n = 16384, 10000
    assert work.match_bytes(j, n) == 12 * j + 20 * n + j * n // 8 + 4 * j
    assert work.match_bytes(3, 3) == 36 + 60 + 2 + 12
    assert work.match_bytes(0, 10) == 0
