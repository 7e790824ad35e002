"""`python -m cook_tpu_torch.tools.loadtest` against the reference's
`tools/loadtest.py`: from one seed, the same operations in the same order
(kind, user, pool, job spec, target and arrival offset), and a report of
the same shape, on the in-process plane, the 2-shard plane and a 2-worker
mp fleet; the report's two reducers equal the reference's on the same
input."""
import json
import pathlib
import sys

import pytest
import torch

from cook_tpu_torch.tools import loadtest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "tools"))

import loadtest as ref_loadtest  # noqa: E402

torch.set_num_threads(1)

KNOBS = dict(rps=40.0, duration_s=1.0, mode="open", workers=8, seed=3)


def _recorded(module, monkeypatch):
    """Every operation the run issues, as (index, kind, user, pool, spec,
    ref, offset), recorded as its worker picks it up."""
    seen = []
    original = module._execute_op

    def execute(session_factory, url, op, uuids, recorder):
        seen.append((op.index, op.kind, op.user, op.pool,
                     json.dumps(op.spec, sort_keys=True), op.ref,
                     op.offset_s))
        return original(session_factory, url, op, uuids, recorder)

    monkeypatch.setattr(module, "_execute_op", execute)
    return seen


FORMS = {
    "inprocess": lambda m: m.run_inprocess(**KNOBS),
    "shards-2": lambda m: m.run_inprocess(shards=2, **KNOBS),
    "mp-2": lambda m: m.run_mp(groups=2, standbys=0, inprocess=True,
                               **KNOBS),
}


def _shape(report):
    """The report's keys and, for each dict section the reference always
    writes, its keys; the history trend (present only when the server
    sampled inside the run's window) is held by the reducer test."""
    out = {k: None for k in report if k != "commit_ack_trend"}
    for key in ("commit_ack", "per_shard"):
        if key in report:
            out[key] = sorted(report[key])
    if "mp" in report:
        out["mp"] = (sorted(report["mp"]),
                     {g: sorted(row)
                      for g, row in report["mp"]["per_worker"].items()})
    if "per_shard" in report:
        out["per_shard_rows"] = {s: sorted(row) for s, row in
                                 report["per_shard"]["shards"].items()}
    return out


@pytest.mark.parametrize("form", list(FORMS))
def test_same_operations_and_report_shape_as_the_reference(form,
                                                           monkeypatch):
    ref_ops = _recorded(ref_loadtest, monkeypatch)
    want = FORMS[form](ref_loadtest)
    ops = _recorded(loadtest, monkeypatch)
    got = FORMS[form](loadtest)
    assert sorted(ops) == sorted(ref_ops)
    assert len(ops) > 20
    assert got["errors"] == 0
    assert got["commit_ack"]["count"] > 0
    assert got["commit_ack"]["p99_ms"] >= got["commit_ack"]["p50_ms"] > 0
    assert _shape(got) == _shape(want)
    assert set(got["ops"]) == set(want["ops"])
    if form == "shards-2":
        assert sorted(got["per_shard"]["shards"]) == ["0", "1"]
    if form == "mp-2":
        assert got["mp"]["groups"] == 2
        assert sorted(got["mp"]["per_worker"]) == ["0", "1"]


HISTORY = {"series": {
    "job.latency.submit_commit_ack.p99": [
        [100.0, 0.010], [100.5, 0.012], [101.0, 0.030], [101.5, 0.008],
        [102.0, 0.020], [95.0, 0.5]],
    "other": [[101.2, 0.004]]}}

CONTENTION = {"shards": [
    {"shard": 0, "commit_ack": {"p50_ms": 1.5, "p99_ms": 9.0,
                                "slow_samples": 12},
     "lock": {"contention_ratio": 0.1}, "jobs": 7},
    {"shard": 1, "commit_ack": {"p50_ms": 2.5, "p99_ms": 31.0,
                                "slow_samples": 20},
     "lock": {}, "jobs": 9},
    {"shard": 2, "commit_ack": {}, "lock": {"contention_ratio": 0.0}}]}


@pytest.mark.parametrize("duration_s", [0.5, 2.0, 10.0])
def test_commit_ack_trend_equals_the_reference(duration_s):
    got = loadtest.commit_ack_trend(json.loads(json.dumps(HISTORY)),
                                    duration_s)
    want = ref_loadtest.commit_ack_trend(json.loads(json.dumps(HISTORY)),
                                         duration_s)
    assert got == want and got is not None
    assert loadtest.commit_ack_trend({"series": {}}, 1.0) is None


def test_per_shard_summary_equals_the_reference():
    got = loadtest.per_shard_summary(CONTENTION)
    assert got == ref_loadtest.per_shard_summary(CONTENTION)
    assert got["hottest_shard"] == 1
    assert loadtest.per_shard_summary({"journal": {}}) is None
    assert loadtest.per_shard_summary(None) is None


def test_cli_smoke_prints_the_reference_summary_keys(capsys):
    assert loadtest.main(["--smoke", "--duration", "1"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert {"mode", "target_rps", "achieved_rps", "duration_s",
            "commit_ack", "errors"} <= set(summary)
    assert summary["target_rps"] == 40.0 and summary["errors"] == 0
