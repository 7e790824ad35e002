"""Device telemetry of `cook_tpu_torch` against `cook_tpu` on the CPU.

- the compile observatory: first-seen flags, storm windows, storm onsets
  and per-op stats equal the reference's on the same scripted
  `(op, shape, backend)` sequence (warmup, a storm, its clearing);
- the quality monitor: the shadow solve's packing-efficiency ratio equals
  the reference's on the same prepared problem (both are the numpy greedy
  on the same float32 arrays: exact), its sampling cadence and size cap
  likewise, and its fetches are detached from the cycle's data-plane
  scope and tagged `fallback`;
- the health verdict: reasons, status, evidence and checks equal the
  reference's on scripted solve latencies, quality samples, compile
  storms, device fallbacks and memory stats;
- `device_memory_stats` reports nothing on the CPU.

Every latency is a scripted number: no test here reads the clock."""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.obs import compile_observatory as ref_co
from cook_tpu.obs import data_plane as ref_dp
from cook_tpu.obs import quality_monitor as ref_qm
from cook_tpu.obs import telemetry as ref_tel
from cook_tpu.ops import match as ref_match
from cook_tpu.utils import metrics as ref_metrics
from cook_tpu_torch.obs import compile_observatory as port_co
from cook_tpu_torch.obs import data_plane as port_dp
from cook_tpu_torch.obs import device_monitor as port_dm
from cook_tpu_torch.obs import health as port_health
from cook_tpu_torch.obs import quality_monitor as port_qm
from cook_tpu_torch.obs import telemetry as port_tel
from cook_tpu_torch.ops import match as port_match
from cook_tpu_torch.utils import metrics as port_metrics

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(co=ref_co, qm=ref_qm, tel=ref_tel, dp=ref_dp,
                      metrics=ref_metrics)
PORT = SimpleNamespace(co=port_co, qm=port_qm, tel=port_tel, dp=port_dp,
                       metrics=port_metrics)


def _script(seed=0, n=120):
    """(op, shape, backend) solves: a few steady shapes, then a burst of
    fresh ones (a storm), then steady again (the storm clears)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        op = ("match", "rank")[int(rng.integers(0, 2))]
        if 50 <= i < 62 and op == "match":
            shape = (64 * (i + 1), 128)             # fresh padded shapes
        else:
            shape = (int(rng.choice([64, 128])), 128)
        out.append((op, shape, ("exact", "pallas")[i % 2]))
    return out


def _observe(P, script, **kw):
    obs = P.co.CompileObservatory(**kw)
    storms = P.metrics.global_registry.counter("obs.compile.storms")
    before = {op: storms.value({"op": op}) for op in ("match", "rank")}
    trail = []
    for op, shape, backend in script:
        first = obs.observe_solve(op, shape, backend)
        trail.append((first, sorted(obs.storming_ops().items())))
    onsets = {op: storms.value({"op": op}) - before[op]
              for op in ("match", "rank")}
    return trail, obs.stats(), onsets


@pytest.mark.parametrize("kw", [
    {}, dict(window=8, storm_threshold=3, warmup_solves=4),
    dict(window=16, storm_threshold=2, warmup_solves=0)],
    ids=["defaults", "window-8", "no-warmup"])
def test_compile_observatory_equals_reference(kw):
    script = _script()
    got = _observe(PORT, script, **kw)
    want = _observe(REF, script, **kw)
    assert got == want
    assert port_co.shape_signature((131072, 16384)) == "131072x16384"
    if kw.get("warmup_solves") == 0:
        assert got[2]["match"] >= 1          # the burst stormed


def _problem(rng, j=24, n=10, masked=True):
    """Exact-sum arrays (MB in multiples of 512, cpus in halves)."""
    demands = np.stack([rng.choice([512, 1024, 2048], j),
                        rng.choice([0.5, 1.0, 2.0], j),
                        np.zeros(j), np.zeros(j)], axis=1).astype(np.float32)
    avail = np.stack([rng.choice([4096, 8192], n), rng.choice([4.0, 8.0], n),
                      np.zeros(n), np.zeros(n)], axis=1).astype(np.float32)
    totals = np.stack([np.full(n, 8192.0), np.full(n, 8.0)],
                      axis=1).astype(np.float32)
    feasible = (rng.random((j, n)) < 0.8) if masked else None
    assignment = np.where(rng.random(j) < 0.7,
                          rng.integers(0, n, j), -1).astype(np.int32)
    return demands, avail, totals, feasible, assignment


def _prepared(mod, put, demands, avail, totals, feasible, pad=64):
    j, n = len(demands), len(avail)

    def padded(a, size):
        out = np.zeros((size,) + a.shape[1:], a.dtype)
        out[:len(a)] = a
        return out

    problem = mod.MatchProblem(
        demands=put(padded(demands, pad)),
        job_valid=put(np.arange(pad) < j),
        avail=put(padded(avail, pad)),
        totals=put(padded(totals, pad)),
        node_valid=put(np.arange(pad) < n))
    return SimpleNamespace(problem=problem, considerable=[None] * j,
                           nodes=SimpleNamespace(n=n), feasible=feasible)


PUTS = {"ref": (ref_match, jnp.asarray), "port": (port_match, torch.as_tensor)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("masked", [True, False])
def test_quality_ratio_equals_reference(seed, masked):
    arrays = _problem(np.random.default_rng(seed), masked=masked)
    ratios = {}
    for label, P in (("ref", REF), ("port", PORT)):
        mod, put = PUTS[label]
        monitor = P.qm.QualityMonitor(sample_every=1)
        prepared = _prepared(mod, put, *arrays[:4])
        ratios[label] = monitor.observe_cycle(prepared, arrays[4], "p")
        assert monitor.stats()["p"]["last"] == ratios[label]
    assert ratios["port"] == ratios["ref"] is not None
    assert 0.0 < ratios["port"] <= 2.0


def test_quality_sampling_cadence_and_size_cap_equal_reference():
    arrays = _problem(np.random.default_rng(5))
    for label, P in (("ref", REF), ("port", PORT)):
        mod, put = PUTS[label]
        prepared = _prepared(mod, put, *arrays[:4])
        monitor = P.qm.QualityMonitor(sample_every=3)
        sampled = [monitor.observe_cycle(prepared, arrays[4], "p")
                   is not None for _ in range(7)]
        assert sampled == [False, False, True, False, False, True, False]
        capped = P.qm.QualityMonitor(sample_every=1, max_shadow_jobs=8)
        assert capped.observe_cycle(prepared, arrays[4], "p") is None
        off = P.qm.QualityMonitor(sample_every=0)
        assert off.observe_cycle(prepared, arrays[4], "p") is None


def test_shadow_fetches_are_detached_and_tagged_fallback():
    arrays = _problem(np.random.default_rng(6))
    prepared = _prepared(port_match, torch.as_tensor, *arrays[:4])
    scope = port_dp.CycleDataPlane("p", 1)
    before = port_dp.LEDGER.family_totals().get(
        port_dp.FAM_FALLBACK, {}).get("d2h_bytes", 0)
    with port_dp.activate(scope):
        port_qm.QualityMonitor(sample_every=1).observe_cycle(
            prepared, arrays[4], "p")
    after = port_dp.LEDGER.family_totals()[port_dp.FAM_FALLBACK]["d2h_bytes"]
    assert scope.d2h_bytes == 0 and scope.h2d_bytes == 0
    # the unpadded demands and the padded avail and totals came back
    assert after - before == (64 * 4 + 64 * 4 + 64 * 2) * 4


def _memory(utilization):
    return {"bytes_in_use": utilization * 2**34, "bytes_limit": 2.0**34,
            "peak_bytes_in_use": utilization * 2**34,
            "utilization": utilization}


SCENARIOS = {
    "healthy": dict(latencies=[0.010] * 30, memory=0.2),
    "latency-regression": dict(latencies=[0.010] * 24 + [0.050] * 8,
                               memory=0.2),
    "oom-risk": dict(latencies=[0.010] * 30, memory=0.95),
    "unobservable-memory": dict(latencies=[0.010] * 30, memory=None),
    "quality-drift": dict(latencies=[0.010] * 30, memory=0.2,
                          quality=[1.0] * 12 + [0.9] * 4),
    "recompile-storm": dict(latencies=[0.010] * 30, memory=0.2,
                            storm=True),
    "device-degraded": dict(latencies=[0.010] * 30, memory=0.2,
                            fallback=True),
}


def _verdict(P, scenario):
    s = SCENARIOS[scenario]
    memory = None if s["memory"] is None else _memory(s["memory"])
    tel = P.tel.DeviceTelemetry(storm_window=8, storm_threshold=3,
                                storm_warmup=2,
                                memory_stats_fn=lambda: memory)
    for i, seconds in enumerate(s["latencies"]):
        tel.record_match_solve("p", (1024, 256), "pallas", seconds)
        tel.record_solve("rank", (2048,), "xla")
    if s.get("storm"):
        for i in range(6):
            tel.record_solve("rank", (4096 << i,), "xla")
    for ratio in s.get("quality", ()):
        tel.quality.record_sample("p", ratio)
    if s.get("fallback"):
        tel.note_device_fallback("p", "solve-error", cycles_left=3)
    return tel.health()


def _strip(verdict):
    """The verdict without its clock reads (`wall_time`, the fallback's
    `since`) and without the free-text detail, whose remedy the port
    words for its own tools."""
    out = {k: v for k, v in verdict.items() if k != "wall_time"}
    out["degradations"] = [
        {k: v for k, v in d.items() if k not in ("detail", "since")}
        for d in verdict["degradations"]]
    out["checks"] = dict(verdict["checks"])
    out["checks"]["device_fallback"] = {
        pool: {k: v for k, v in e.items() if k != "since"}
        for pool, e in verdict["checks"]["device_fallback"].items()}
    return out


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_health_verdict_equals_reference(scenario):
    got = _verdict(PORT, scenario)
    want = _verdict(REF, scenario)
    assert _strip(got) == _strip(want)
    reasons = {"healthy": [], "unobservable-memory": [],
               "latency-regression": [port_health.SOLVE_LATENCY_REGRESSION],
               "oom-risk": [port_health.DEVICE_OOM_RISK],
               "quality-drift": [port_health.QUALITY_DRIFT],
               "recompile-storm": [port_health.RECOMPILE_STORM],
               "device-degraded": [port_health.DEVICE_DEGRADED]}[scenario]
    assert got["reasons"] == reasons
    assert got["status"] == ("ok" if not reasons else "degraded")


def test_health_constants_equal_reference():
    from cook_tpu.obs import health as ref_health

    assert port_health.DEGRADATION_REASONS == ref_health.DEGRADATION_REASONS


def test_device_memory_stats_on_the_cpu_report_nothing():
    assert port_dm.device_memory_stats("cpu") is None
    assert port_dm.device_memory_stats(torch.device("cpu")) is None
    assert port_dm.update_device_memory_gauges(lambda: None) is None
    stats = port_dm.update_device_memory_gauges(lambda: _memory(0.5))
    gauge = port_metrics.global_registry.gauge("obs.device.mem_utilization")
    assert stats["utilization"] == gauge.value() == 0.5
