"""`python -m cook_tpu_torch.tools.match_sweep` (the reference's
`tools/tpu_sweep.py`, renamed): the reference's grids and problem, records
that `tools/pick_tuned.py` reads unchanged, and at the same knobs on the
`pallas` backend the reference's packing efficiency (its chunked matcher
with the Pallas kernel in interpret mode, against the same exact greedy).
On `xla` the chunked matchers break candidate ties in other orders
(ROADMAP.md, Queue C divergence 3), so parity is held on `pallas`."""
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu_torch.tools import match_sweep

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from cook_tpu.ops import cpu_reference as ref_cpu  # noqa: E402
from cook_tpu.ops.match import MatchProblem as RefProblem  # noqa: E402
from cook_tpu.ops.match import backend_flags as ref_flags  # noqa: E402
from cook_tpu.ops.match import chunked_match as ref_chunked  # noqa: E402

torch.set_num_threads(1)

JOBS, HOSTS = 1000, 100
# (chunk, passes, rounds, kc): the pallas grid's passes, rounds and kc at
# chunks that divide the small problem's padded 1,024 jobs
CONFIGS = [(256, 4, 1, 1), (512, 8, 2, 1), (1024, 4, 3, 1)]
RECORD_KEYS = {"platform", "backend", "chunk", "passes", "rounds", "kc",
               "p50_ms", "compile_ms", "placed", "packing_eff", "cpu_ms"}


def reference_eff(chunk, passes, rounds, kc):
    """tools/tpu_sweep.py's record for one configuration, on the small
    problem: placed jobs and packing efficiency."""
    J, N = match_sweep.padded(JOBS), match_sweep.padded(HOSTS)
    demands, avail, totals = bench.make_problem(J, N, seed=2)
    job_valid = np.zeros(J, bool)
    job_valid[:JOBS] = True
    node_valid = np.zeros(N, bool)
    node_valid[:HOSTS] = True
    problem = RefProblem(
        demands=jnp.asarray(demands), job_valid=jnp.asarray(job_valid),
        avail=jnp.asarray(avail), totals=jnp.asarray(totals),
        node_valid=jnp.asarray(node_valid), feasible=None)
    cpu = ref_cpu.np_greedy_match(demands[:JOBS], avail[:HOSTS],
                                  totals[:HOSTS])
    q_cpu = ref_cpu.packing_quality(demands[:JOBS], cpu)
    a = np.asarray(ref_chunked(problem, chunk=chunk, rounds=rounds, kc=kc,
                               passes=passes,
                               **ref_flags("pallas")).assignment)
    q = ref_cpu.packing_quality(demands[:JOBS], a[:JOBS])
    return q["num_placed"], round(q["cpus_placed"] / q_cpu["cpus_placed"],
                                  4)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep") / "sweep.jsonl"
    recs = match_sweep.sweep(str(out), "pallas", jobs=JOBS, hosts=HOSTS,
                             repeats=1, device="cpu", configs=CONFIGS)
    return out, recs


def test_the_grids_and_problem_are_the_references():
    assert match_sweep.grid("pallas")[:2] == [(4096, 4, 1, 1),
                                             (4096, 4, 2, 1)]
    assert len(match_sweep.grid("pallas")) == 60
    assert len(match_sweep.grid("bucketed")) == 48
    assert len(match_sweep.grid("xla")) == 108
    assert (match_sweep.padded(100_000), match_sweep.padded(10_000)) == \
        (131_072, 16_384)
    for got, want in zip(match_sweep.make_problem(300, 40, seed=2),
                         bench.make_problem(300, 40, seed=2)):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("config", CONFIGS, ids=str)
def test_packing_eff_equals_the_reference_on_pallas(records, config):
    _, recs = records
    (rec,) = [r for r in recs
              if (r["chunk"], r["passes"], r["rounds"], r["kc"]) == config]
    assert RECORD_KEYS <= set(rec), rec
    assert rec["platform"] == "cpu" and rec["device"] == "cpu"
    assert (rec["placed"], rec["packing_eff"]) == reference_eff(*config)


def _pick(tmp_path, sweep):
    """pick_tuned with no efficiency bar: the chunked routes pack far below
    the exact greedy on this tie-heavy problem (ROADMAP.md, Queue C
    reference item 8), in the reference too, and the bar is not what this
    test holds."""
    out = tmp_path / "tuned.json"
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "pick_tuned.py"), "--sweep",
         str(sweep), "--out", str(out), "--min-eff", "0"],
        capture_output=True, text=True, timeout=60)
    return proc, (json.loads(out.read_text()) if out.exists() else None)


def test_pick_tuned_reads_the_records_unchanged(records, tmp_path):
    sweep, recs = records
    # a CPU run's records never become a pick
    proc, tuned = _pick(tmp_path, sweep)
    assert proc.returncode == 1 and tuned is None
    # stamped as the card's run stamps them, the fastest one is picked
    card = tmp_path / "card.jsonl"
    card.write_text("".join(
        json.dumps({**json.loads(line), "platform": "cuda"}) + "\n"
        if "p50_ms" in line else line for line in sweep.open()))
    proc, tuned = _pick(tmp_path, card)
    assert proc.returncode == 0, proc.stderr
    best = min(recs, key=lambda r: r["p50_ms"])
    assert tuned == {
        "backend": "pallas", "chunk": best["chunk"],
        "rounds": best["rounds"], "passes": best["passes"],
        "kc": best["kc"], "measured_p50_ms": best["p50_ms"],
        "measured_packing_eff": best["packing_eff"], "source": str(card)}


def test_resume_and_limit(records, tmp_path):
    sweep, _ = records
    # every configuration already recorded: nothing runs again
    again = match_sweep.sweep(str(sweep), "pallas", jobs=JOBS, hosts=HOSTS,
                              repeats=1, device="cpu", configs=CONFIGS)
    assert again == []
    fresh = tmp_path / "limit.jsonl"
    recs = match_sweep.sweep(str(fresh), "pallas", jobs=JOBS, hosts=HOSTS,
                             repeats=1, device="cpu", configs=CONFIGS,
                             limit=1)
    assert [(r["chunk"], r["passes"], r["rounds"], r["kc"])
            for r in recs] == CONFIGS[:1]
    lines = [json.loads(line) for line in fresh.open()]
    assert lines[0] == {"backend": "pallas", "chunk": 256, "passes": 4,
                        "rounds": 1, "kc": 1, "started": True}
