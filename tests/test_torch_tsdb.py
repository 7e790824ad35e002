"""`cook_tpu_torch.obs.tsdb` against `cook_tpu.obs.tsdb` on the CPU: the
cases of tests/test_tsdb.py on the port's copy — sampling semantics
(gauge value / counter rate / histogram quantiles), rollup correctness vs
direct aggregation, retention bounds, segment recovery across restart,
queries and the incident slice — plus the same ticks through both
packages' histories, whose queries and segments must be equal, and a
segment directory written by either package recovered by the other.
The two REST cases (`/debug/history`, the API's bundle collector) wait
for the port's service surface; the bundle's history slice is held here
through the port's `IncidentRecorder`."""
import json
import math
import os

import pytest

from cook_tpu.obs import tsdb as ref_tsdb
from cook_tpu.utils import metrics as ref_metrics
from cook_tpu_torch.obs import tsdb as port_tsdb
from cook_tpu_torch.obs.incident import IncidentRecorder
from cook_tpu_torch.obs.tsdb import (HistoryConfig, MetricsHistory, _Rollup,
                                     series_base)
from cook_tpu_torch.utils import metrics as port_metrics
from cook_tpu_torch.utils.metrics import Registry


def make_history(tmp_path=None, **cfg_kw):
    reg = Registry()
    t = {"now": 1_000_000.0}
    cfg = HistoryConfig(**{"sample_s": 1.0, **cfg_kw})
    history = MetricsHistory(
        reg, dir=(str(tmp_path) if tmp_path is not None else None),
        config=cfg, clock=lambda: t["now"])
    return reg, history, t


def tick(history, t, advance_s=10.0):
    history.sample_once()
    t["now"] += advance_s


# ------------------------------------------------------------- sampling


def test_gauge_samples_value_per_label_set():
    reg, history, t = make_history()
    g = reg.gauge("x.g", "h")
    g.set(1.0, {"pool": "a"})
    g.set(2.0, {"pool": "b"})
    tick(history, t)
    q = history.query("x.g")
    assert q["series"]["x.g{pool=a}"] == [[1_000_000.0, 1.0]]
    assert q["series"]["x.g{pool=b}"] == [[1_000_000.0, 2.0]]


def test_counter_samples_rate_not_value():
    reg, history, t = make_history()
    c = reg.counter("x.c", "h")
    c.inc(5)
    tick(history, t)                 # primes; no rate point yet
    assert history.query("x.c.rate")["series"].get("x.c.rate", []) == []
    c.inc(30)
    tick(history, t)                 # 30 over 10s -> 3/s
    points = history.query("x.c.rate")["series"]["x.c.rate"]
    assert points == [[1_000_010.0, 3.0]]


def test_counter_reset_reads_as_zero_rate_not_negative():
    reg, history, t = make_history()
    c = reg.counter("x.c", "h")
    c.inc(100)
    tick(history, t)
    with c._lock:
        c._values[()] = 10.0  # simulated process restart / reset
    tick(history, t)
    points = history.query("x.c.rate")["series"]["x.c.rate"]
    assert points[-1][1] == 0.0


def test_histogram_samples_windowed_p50_p99():
    reg, history, t = make_history()
    h = reg.histogram("x.h", "h", buckets=(0.1, 1.0, 10.0))
    for _ in range(99):
        h.observe(0.05)
    h.observe(5.0)
    tick(history, t)                 # primes
    for _ in range(99):
        h.observe(0.5)
    h.observe(5.0)
    tick(history, t)
    # the second tick's WINDOW is 99x0.5 + 1x5.0: p50 lands in the 1.0
    # bucket, p99 still under 1.0 (99/100 <= rank), p99 edge is 1.0
    p50 = history.query("x.h.p50")["series"]["x.h.p50"]
    p99 = history.query("x.h.p99")["series"]["x.h.p99"]
    assert p50[-1][1] == 1.0
    assert p99[-1][1] == 1.0
    # no observations in the window -> no point (the series goes quiet,
    # it does not repeat stale quantiles)
    tick(history, t)
    assert len(history.query("x.h.p50")["series"]["x.h.p50"]) == 1


# ------------------------------------------------------ rollup correctness


def test_rollup_equals_direct_aggregation_of_raw():
    """The property the satellite pins: every 1m bucket's
    min/max/mean/last/count equals aggregating the raw points that fall
    in its window."""
    reg, history, t = make_history()
    g = reg.gauge("x.g", "h")
    values = [(i * 7 + 3) % 13 - 6 for i in range(181)]
    for v in values:
        g.set(float(v))
        tick(history, t)
    raw = history.query("x.g")["series"]["x.g"]
    assert len(raw) == len(values)
    for step, width in (("1m", 60.0), ("10m", 600.0)):
        buckets = history.query("x.g", step=step)["series"]["x.g"]
        # direct aggregation of the raw stream
        expected: dict[float, list] = {}
        for pt_t, pt_v in raw:
            start = math.floor(pt_t / width) * width
            expected.setdefault(start, []).append(pt_v)
        assert [b["t"] for b in buckets] == sorted(expected)
        for bucket in buckets:
            window = expected[bucket["t"]]
            assert bucket["min"] == min(window)
            assert bucket["max"] == max(window)
            assert bucket["last"] == window[-1]
            assert bucket["count"] == len(window)
            assert bucket["mean"] == pytest.approx(
                sum(window) / len(window))


def test_open_bucket_is_served_before_it_finalizes():
    rollup = _Rollup(60.0, cap=8)
    rollup.add(30.0, 5.0)
    points = rollup.points(since=0.0)
    assert len(points) == 1 and points[0]["count"] == 1


# ------------------------------------------------------------- retention


def test_raw_ring_cap_drops_oldest_never_newest():
    reg, history, t = make_history(raw_points=50)
    g = reg.gauge("x.g", "h")
    for i in range(120):
        g.set(float(i))
        tick(history, t, advance_s=1.0)
    points = history.query("x.g")["series"]["x.g"]
    assert len(points) == 50
    # the newest 50 survived; everything dropped is strictly older
    assert points[-1][1] == 119.0
    assert points[0][1] == 70.0


def test_rollup_retention_never_drops_a_bucket_newer_than_the_cap():
    reg, history, t = make_history(rollup_points=5)
    g = reg.gauge("x.g", "h")
    n_minutes = 12
    for i in range(n_minutes * 6):   # one point per 10s
        g.set(float(i))
        tick(history, t)
    buckets = history.query("x.g", step="1m")["series"]["x.g"]
    # ring cap 5 finalized + the open bucket; strictly the NEWEST ones
    assert len(buckets) == 6
    starts = [b["t"] for b in buckets]
    assert starts == sorted(starts)
    newest_expected = math.floor((t["now"] - 10.0) / 60.0) * 60.0
    assert starts[-1] == newest_expected
    assert starts[-1] - starts[0] == 5 * 60.0


def test_removed_label_set_series_ages_out():
    """A churned label set (per-user gauge removed, per-peer gauge
    cleared) must not keep its series — rings, index row, and the
    counter/histogram prev-state — forever."""
    reg, history, t = make_history(series_ttl_s=100.0)
    g = reg.gauge("x.g", "h")
    c = reg.counter("x.c", "h")
    g.set(1.0, {"user": "bob"})
    c.inc(3, {"user": "bob"})
    tick(history, t)
    tick(history, t)
    assert "x.g{user=bob}" in history.series_index()
    assert history._prev_counts
    g.remove({"user": "bob"})
    with c._lock:
        c._values.clear()
    # the series stops producing; past the TTL it leaves the index,
    # and the prev-state pruned immediately (the label set is gone)
    for _ in range(12):
        tick(history, t)            # 10s ticks; TTL 100s
    assert "x.g{user=bob}" not in history.series_index()
    assert "x.c.rate{user=bob}" not in history._prev_counts


def test_series_ttl_zero_disables_aging():
    reg, history, t = make_history(series_ttl_s=0.0)
    g = reg.gauge("x.g", "h")
    g.set(1.0, {"user": "bob"})
    tick(history, t)
    g.remove({"user": "bob"})
    reg.gauge("x.other", "h").set(1.0)
    for _ in range(30):
        tick(history, t, advance_s=1000.0)
    assert "x.g{user=bob}" in history.series_index()


# ------------------------------------------------------------ durability


def test_segments_rotate_and_retention_prunes_oldest(tmp_path):
    reg, history, t = make_history(tmp_path, segment_lines=10,
                                   max_segments=3)
    g = reg.gauge("x.g", "h")
    for i in range(55):
        g.set(float(i))
        tick(history, t, advance_s=1.0)
    history.stop()
    names = sorted(os.listdir(tmp_path))
    assert len(names) == 3
    assert names[-1] == "segment-000005.jsonl"


def test_recovery_serves_pre_restart_samples(tmp_path):
    reg, history, t = make_history(tmp_path, segment_lines=10,
                                   max_segments=8)
    g = reg.gauge("x.g", "h")
    for i in range(25):
        g.set(float(i))
        tick(history, t, advance_s=1.0)
    history.stop()
    # a new process: fresh history over the same dir
    reg2 = Registry()
    recovered = MetricsHistory(reg2, dir=str(tmp_path),
                               config=HistoryConfig(sample_s=1.0),
                               clock=lambda: t["now"])
    points = recovered.query("x.g")["series"]["x.g"]
    assert len(points) == 25
    assert points[0][1] == 0.0 and points[-1][1] == 24.0
    # rollups rebuilt too, not just raw
    buckets = recovered.query("x.g", step="1m")["series"]["x.g"]
    assert sum(b["count"] for b in buckets) == 25
    # new samples append after the recovered ones, and segment
    # numbering continues instead of clobbering retained files
    g2 = reg2.gauge("x.g", "h")
    g2.set(99.0)
    recovered.sample_once()
    assert recovered.query("x.g")["series"]["x.g"][-1][1] == 99.0
    recovered.stop()


def test_recovery_skips_torn_trailing_line(tmp_path):
    reg, history, t = make_history(tmp_path)
    g = reg.gauge("x.g", "h")
    for i in range(3):
        g.set(float(i))
        tick(history, t)
    history.stop()
    seg = sorted(tmp_path.iterdir())[0]
    with open(seg, "a") as f:
        f.write('{"t": 123, "p": {"x.g":')  # crash mid-append
    recovered = MetricsHistory(Registry(), dir=str(tmp_path),
                               config=HistoryConfig(),
                               clock=lambda: t["now"])
    assert len(recovered.query("x.g")["series"]["x.g"]) == 3
    recovered.stop()


# ------------------------------------------------------------ query shape


def test_query_matches_exact_base_and_prefix():
    reg, history, t = make_history()
    g = reg.gauge("a.one", "h")
    g2 = reg.gauge("a.two", "h")
    g.set(1.0, {"pool": "p"})
    g2.set(2.0)
    tick(history, t)
    assert list(history.query("a.one")["series"]) == ["a.one{pool=p}"]
    assert list(history.query("a.one{pool=p}")["series"]) \
        == ["a.one{pool=p}"]
    assert list(history.query("a.*")["series"]) \
        == ["a.one{pool=p}", "a.two"]
    assert history.query("a.nope")["series"] == {}


def test_query_since_relative_and_bad_step():
    reg, history, t = make_history()
    g = reg.gauge("x.g", "h")
    for i in range(10):
        g.set(float(i))
        tick(history, t)
    recent = history.query("x.g", since=-25.0)["series"]["x.g"]
    assert [v for _, v in recent] == [8.0, 9.0]
    with pytest.raises(ValueError):
        history.query("x.g", step="5m")


def test_series_base_strips_labels():
    assert series_base("a.b{pool=p}") == "a.b"
    assert series_base("a.b") == "a.b"


def test_incident_slice_keeps_only_key_series_window():
    reg, history, t = make_history(key_series=("x.keep",),
                                   incident_window_s=30.0)
    keep = reg.gauge("x.keep", "h")
    drop = reg.gauge("x.drop", "h")
    for i in range(10):
        keep.set(float(i), {"pool": "p"})
        drop.set(float(i))
        tick(history, t, advance_s=10.0)
    bundle_slice = history.incident_slice()
    assert list(bundle_slice["series"]) == ["x.keep{pool=p}"]
    # only the configured window, not the whole ring
    assert len(bundle_slice["series"]["x.keep{pool=p}"]) == 2


# ------------------------------------------- both packages, same ticks


def _drive(tsdb, metrics, tmp_path):
    """The same registry traffic and ticks through one package's history:
    gauges, a counter (with a reset), a histogram, a removed label set."""
    reg = metrics.Registry()
    t = {"now": 2_000_000.0}
    history = tsdb.MetricsHistory(
        reg, dir=str(tmp_path), clock=lambda: t["now"],
        config=tsdb.HistoryConfig(sample_s=1.0, segment_lines=7,
                                  max_segments=3, series_ttl_s=45.0,
                                  key_series=("q.len",),
                                  incident_window_s=40.0))
    gauge = reg.gauge("q.len", "h")
    counter = reg.counter("jobs.done", "h")
    hist = reg.histogram("lat.s", "h", buckets=(0.01, 0.1, 1.0,
                                                 float("inf")))
    for i in range(30):
        gauge.set(float(i % 7), {"pool": "a"})
        if i < 12:
            gauge.set(float(i), {"pool": "gone"})
        counter.inc(i % 5, {"pool": "a"})
        if i == 20:
            counter._values.clear()  # a process restart's counter reset
        for k in range(i % 4 + 1):
            hist.observe(0.005 * (k + 1) * (i % 3 + 1), {"op": "m"})
        history.sample_once()
        t["now"] += 10.0
    return history, t


def test_history_queries_equal_the_reference(tmp_path):
    """The same traffic and ticks: every query (raw, 1m, 10m, a base
    name, a prefix, `since`) and the incident slice equal."""
    got, _ = _drive(port_tsdb, port_metrics, tmp_path / "port")
    want, _ = _drive(ref_tsdb, ref_metrics, tmp_path / "ref")
    for metric, kw in (("*", {}), ("*", {"step": "1m"}),
                       ("*", {"step": "10m"}), ("q.len", {}),
                       ("jobs.done.rate", {}), ("lat", {}),
                       ("*", {"since": -100.0})):
        assert got.query(metric, **kw) == want.query(metric, **kw), \
            (metric, kw)
    assert got.incident_slice() == want.incident_slice()
    assert got.query("*")["series"]


def test_segments_recover_across_packages(tmp_path):
    """A segment directory written by either package rebuilds the other's
    rings: the recovered raw series equal the writer's."""
    for writer, reader in ((port_tsdb, ref_tsdb), (ref_tsdb, port_tsdb)):
        metrics = port_metrics if writer is port_tsdb else ref_metrics
        path = tmp_path / writer.__name__.split(".")[0]
        written, t = _drive(writer, metrics, path)
        reread = reader.MetricsHistory(
            (ref_metrics if reader is ref_tsdb else port_metrics)
            .Registry(), dir=str(path), clock=lambda: t["now"],
            config=reader.HistoryConfig(sample_s=1.0, segment_lines=7,
                                        max_segments=3))
        got = reread.query("*")["series"]
        want = written.query("*")["series"]
        assert got and set(got) <= set(want)
        for key, points in got.items():
            assert points == want[key][-len(points):], key


def test_incident_bundles_embed_history_slice():
    """tests/test_tsdb.py:352 without the REST layer: a history's
    `incident_slice` registered as a bundle collector of the port's
    recorder puts the key series' window in every bundle, and the bundle
    round-trips through JSON."""
    reg, history, t = make_history(key_series=("obs.health.degraded",))
    reg.gauge("obs.health.degraded", "h").set(0.0)
    tick(history, t)
    tick(history, t)
    recorder = IncidentRecorder(cooldown_s=0.0)
    recorder.add_collector("history", history.incident_slice)
    bundle = recorder.capture({"healthy": False, "reasons": ["test"]},
                              trigger="manual")
    assert bundle["history"]["series"].get("obs.health.degraded")
    json.dumps(bundle, default=str)
