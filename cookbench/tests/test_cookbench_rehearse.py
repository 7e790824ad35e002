"""Whole runs of every cell at its tiny size on the CPU (`--rehearse`):
the last line has the contract's keys and the run is correct; the
control (the reference in bfloat16 in the program's place) is not; and
the program, broken underneath in each way a cell can break, is not.
Cells left out for a fault of the program (`pending.json` `blocked`) are
rehearsed to their last line, which is not held to `correct`.

The harness's look for a card is the one step these runs skip.  The
fault "the exchange between chips left out" has no place here: every
cell runs on one card.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest

from cook_tpu_torch.scheduler import core, matcher
from cookbench import run

HERE = os.path.dirname(os.path.abspath(__file__))
with open(os.path.join(os.path.dirname(os.path.dirname(HERE)),
                       "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
# cells left out of BENCHMARK.json, rehearsed here all the same
BLOCKED: dict = {}
_PENDING = os.path.join(HERE, "pending.json")
if os.path.exists(_PENDING):
    with open(_PENDING) as _f:
        for _key, _entries in json.load(_f).items():
            if isinstance(_entries, list):
                BENCH[_key] = BENCH[_key] + _entries
            elif _key == "blocked":
                BLOCKED = _entries
ALL_CELLS = [w["name"] for w in BENCH["workloads"]]
CELLS = [c for c in ALL_CELLS if c not in BLOCKED]
KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def rehearse(capsys, workload, *extra, seed=2**31 + 99, trace=0):
    rc = run.main(["--workload", workload, "--seed", str(seed),
                   "--seconds", "1", "--trace", str(trace), "--rehearse",
                   *extra], bench=BENCH)
    out = capsys.readouterr()
    assert rc == 0, out.err[-2000:]
    last = json.loads(out.out.strip().splitlines()[-1])
    return last, out.err


@pytest.mark.parametrize("workload", CELLS)
def test_rehearsal_is_correct(capsys, workload):
    last, err = rehearse(capsys, workload)
    assert KEYS <= set(last)
    assert list(last)[-1] == "checks"
    assert last["correct"], err[-2000:]
    assert last["attempted"] > 0 and last["failed"] == 0
    # on the CPU there is no device trace: set-up is the one end-to-end
    # metric a rehearsal reads
    assert set(last["metrics"]) == {"setup_s"}
    assert last["device"]["platform"] == "cpu"
    # the numbers compared close standard error, each beside its limit
    tail = [line for line in err.strip().splitlines()][-len(last["checks"]):]
    assert all(line.startswith("check ") and "limit" in line
               for line in tail)


@pytest.mark.parametrize("workload", sorted(BLOCKED))
def test_blocked_rehearsal_reaches_its_line(capsys, workload):
    """A cell out for a fault of the program still runs to the contract's
    last line, its numbers each beside its limit."""
    last, _ = rehearse(capsys, workload)
    assert KEYS <= set(last)
    assert list(last)[-1] == "checks"
    assert {"rank_errors", "placement_errors",
            "packing_shortfall"} <= set(last["checks"])


@pytest.mark.parametrize("workload", ALL_CELLS)
def test_traced_rehearsal_reads_its_per_layer_metrics(capsys, workload):
    """With `--trace 1` the line carries the cell's per-layer metrics that
    a CPU run can read (none of the device's), and is as correct."""
    last, _ = rehearse(capsys, workload, trace=1)
    assert last["correct"] or workload in BLOCKED
    per_layer = {m["name"]: m for m in BENCH["per_layer"]}
    got = set(last["metrics"])
    assert got <= set(per_layer)
    assert {"host.cycle_ms", "host.placements_per_s", "store.submit_ms",
            "rank_ms", "match.encode_ms",
            "match.solve_ms", "match.launch_ms", "match.h2d_mb",
            "match.packing_pct"} <= got
    assert not got & {"device.idle_pct", "match.solve_roofline"}
    assert ("rebalance_ms" in got) == (workload == "one-pool.preempt")
    assert "busy_s" not in last["device"]


# cells whose DRU values are exact in bfloat16 at their tiny size (half-
# host jobs over a share of a tenth of a host: multiples of 5), so only
# their size on the card shows the bfloat16 control (PERF.md section 2)
BF16_EXACT_WHEN_TINY = {"one-pool.preempt"}


@pytest.mark.parametrize("workload", CELLS)
def test_controls_are_not_correct(capsys, workload):
    """The reference in bfloat16 fails the rank; the reference with half
    of each solve's placements left out fails the packing."""
    last, err = rehearse(capsys, workload, "--control")
    assert last["correct"], "the program's own result is unchanged"
    controls = {}
    for line in err.splitlines():
        if line.startswith("control "):
            head, body = line.split(": ", 1)
            controls[head.split()[1]] = json.loads(body)
    assert set(controls) == {"bfloat16", "half_placements"}
    assert not controls["half_placements"]["packing_shortfall"]["ok"]
    if workload not in BF16_EXACT_WHEN_TINY:
        assert controls["bfloat16"]["rank_errors"]["value"] > 0


def stale_rank(monkeypatch):
    """A step that returns its state unchanged: each pool's first ranked
    queue, served again every cycle."""
    orig = core.Scheduler.rank_cycle
    first = {}

    def rank_cycle(self, pool):
        if pool.name not in first:
            first[pool.name] = orig(self, pool)
        self.pool_queues[pool.name] = first[pool.name]
        return first[pool.name]

    monkeypatch.setattr(core.Scheduler, "rank_cycle", rank_cycle)


def half_rank(monkeypatch):
    """Half of the batch left out: the rank orders only the first half of
    each pool's pending jobs."""
    orig = core.rank_pool_columnar

    def rank(*a, **kw):
        queue = orig(*a, **kw)
        queue.jobs = queue.jobs[: len(queue.jobs) // 2]
        return queue

    monkeypatch.setattr(core, "rank_pool_columnar", rank)


def altered_rank(monkeypatch):
    """An answer altered where it is produced: two neighbours of each
    ranked queue swapped."""
    orig = core.rank_pool_columnar

    def rank(*a, **kw):
        queue = orig(*a, **kw)
        if len(queue.jobs) > 2:
            queue.jobs[1], queue.jobs[2] = queue.jobs[2], queue.jobs[1]
        return queue

    monkeypatch.setattr(core, "rank_pool_columnar", rank)


def altered_placement(monkeypatch):
    """An answer altered where it is produced: every placement of a solve
    sent to the first placed job's host."""
    orig = matcher.finalize_pool_match

    def finalize(store, prepared, assignment, *a, **kw):
        a2 = np.array(assignment, copy=True)
        placed = a2 >= 0
        if placed.sum() > 1:
            a2[placed] = a2[placed][0]
        return orig(store, prepared, a2, *a, **kw)

    monkeypatch.setattr(matcher, "finalize_pool_match", finalize)


def half_placements(monkeypatch):
    """Half of the batch left out: every second placement of each solve
    dropped before launch."""
    orig = matcher.finalize_pool_match

    def finalize(store, prepared, assignment, *a, **kw):
        a2 = np.array(assignment, copy=True)
        placed = np.flatnonzero(a2 >= 0)
        a2[placed[1::2]] = -1
        return orig(store, prepared, a2, *a, **kw)

    monkeypatch.setattr(matcher, "finalize_pool_match", finalize)


def altered_victims(monkeypatch):
    """An answer altered where it is produced: each preemption decision
    takes the next decision's victims."""
    orig = core.rebalance_pool

    def rebalance(*a, **kw):
        out = orig(*a, **kw)
        if len(out) > 1:
            ids = [d.task_ids for d in out]
            for d, v in zip(out, ids[1:] + ids[:1]):
                d.task_ids = v
        return out

    monkeypatch.setattr(core, "rebalance_pool", rebalance)


FAULTS = [
    ("one-pool.backlog", stale_rank, "rank_errors"),
    ("one-pool.backlog", half_rank, "rank_errors"),
    ("eight-pool.backlog", half_rank, "rank_errors"),
    ("one-pool.backlog", altered_rank, "rank_errors"),
    ("one-pool.backlog", altered_placement, "placement_errors"),
    ("eight-pool.backlog", altered_placement, "placement_errors"),
    ("one-pool.backlog", half_placements, "packing_shortfall"),
    ("one-pool.preempt", half_placements, "packing_shortfall"),
    ("one-pool.preempt", altered_victims, "victim_errors"),
]


@pytest.mark.parametrize("workload,fault,number", FAULTS,
                         ids=[f"{w}-{f.__name__}" for w, f, _ in FAULTS])
def test_broken_program_is_not_correct(capsys, monkeypatch, workload,
                                       fault, number):
    fault(monkeypatch)
    last, _ = rehearse(capsys, workload)
    assert not last["correct"]
    assert not last["checks"][number]["ok"]


def test_harness_alone_does_not_run(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark, a run
    exits with another code than 0 and prints no result."""
    import shutil
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(HERE))
    shutil.copy(os.path.join(root, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(root, "cookbench"), tmp_path / "cookbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "cookbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0", "--rehearse"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
