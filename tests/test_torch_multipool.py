"""The multi-pool slice of `cook_tpu_torch` against `cook_tpu` on the CPU.

- `ops/match.greedy_match_pools` against the reference's
  `jax.vmap(greedy_match)` on seeded [P, J, N] problems: assignments
  identical, `new_avail` within rtol 1e-6;
- `chunked_match_pools` on `xla` (and `bucketed`) against the reference's
  vmapped `chunked_match`, on inputs whose hosts have distinct totals so
  that `approx_max_k`'s tie order cannot matter: identical; and lane by
  lane against the port's own one-problem `chunked_match`: identical;
- `ops/dru.dru_rank_pools` against the reference's: identical order and
  rank;
- the pool-batched scheduler pass (`Scheduler.match_cycle_all_pools`,
  `matcher.match_pools_batched`): the ports of tests/test_multipool.py:41,
  :55, :88 (GPU DRU mode) and :260 (the Simulator, batched vs per-pool),
  each run on both packages and held to the reference's placements; a
  pool over the hierarchical threshold beside flat ones, with the
  topology bonus; the cycle records and the `match_batched` telemetry;
  chip_smoke.py's multipool phases at a CPU test's size.

The scheduler-level inputs are exact in float32 (whole MB, whole or half
cpus), so no tolerance applies there."""
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.ops import dru as ref_dru
from cook_tpu.ops import match as ref_match
from cook_tpu.ops.common import BIG, pad_to
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.sim import simulator as ref_sim
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.ops import dru as port_dru
from cook_tpu_torch.ops import match as port_match
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.sim import cli as port_cli
from cook_tpu_torch.sim import simulator as port_sim
from tests.conftest import FakeClock
from tests.test_ops_parity import random_dru_problem, random_match_problem

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

P = 3


# ------------------------------------------------------- the batched ops


def _stacked_problems(seed, j=48, n=24, p=P):
    """p seeded problems of tests/test_ops_parity.py's draw (distinct host
    totals), stacked; lane 1 has its last 8 jobs and 4 hosts invalid, as
    the batched pass pads a smaller pool."""
    rng = np.random.default_rng(seed)
    lanes = [random_match_problem(rng, j=j, n=n) for _ in range(p)]
    demands, avail, totals, feasible = (
        np.stack([lane[k] for lane in lanes]).astype(
            bool if k == 3 else np.float32) for k in range(4))
    job_valid = np.ones((p, j), bool)
    node_valid = np.ones((p, n), bool)
    job_valid[1, -8:] = False
    node_valid[1, -4:] = False
    return demands, job_valid, avail, totals, node_valid, feasible


def _ref_problem(arrays):
    return ref_match.MatchProblem(*(None if a is None else jnp.asarray(a)
                                    for a in arrays))


def _port_problem(arrays):
    return port_match.from_numpy(*arrays, device="cpu")


@pytest.mark.parametrize("masked", [False, True], ids=["free", "masked"])
@pytest.mark.parametrize("seed", range(3))
def test_greedy_match_pools_matches_reference(seed, masked):
    arrays = list(_stacked_problems(seed))
    if not masked:
        arrays[5] = None
    want = jax.vmap(ref_match.greedy_match)(_ref_problem(arrays))
    got = port_match.greedy_match_pools(_port_problem(arrays))
    assert got.assignment.dtype == torch.int32
    assert tuple(got.assignment.shape) == (P, 48)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_allclose(got.new_avail.numpy(),
                               np.asarray(want.new_avail), rtol=1e-6)
    # the batch of one is the serial greedy
    for p in range(P):
        lane = port_match.greedy_match(port_match.MatchProblem(
            *(None if t is None else t[p] for t in _port_problem(arrays))))
        assert torch.equal(lane.assignment, got.assignment[p])
        assert torch.equal(lane.new_avail, got.new_avail[p])


CHUNKED = {
    "xla": dict(chunk=16, rounds=3, passes=2, kc=8),
    "bucketed": dict(chunk=16, rounds=3, passes=3, kc=8, bucketed=True),
}


@pytest.mark.parametrize("backend", sorted(CHUNKED))
@pytest.mark.parametrize("seed", range(3))
def test_chunked_match_pools_matches_reference(seed, backend):
    arrays = _stacked_problems(10 + seed)
    knobs = CHUNKED[backend]
    want = jax.vmap(functools.partial(ref_match.chunked_match, **knobs))(
        _ref_problem(arrays))
    got = port_match.chunked_match_pools(_port_problem(arrays), **knobs)
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.new_avail.numpy(),
                                  np.asarray(want.new_avail))
    # lane by lane, the port's one-problem chunked_match gives the same
    for p in range(P):
        lane = port_match.chunked_match(port_match.MatchProblem(
            *(None if t is None else t[p] for t in _port_problem(arrays))),
            **knobs)
        assert torch.equal(lane.assignment, got.assignment[p])
        assert torch.equal(lane.new_avail, got.new_avail[p])


def test_chunked_match_pools_runs_best_node_once_per_pool(monkeypatch):
    """The `pallas` candidate pass on a batch: one best_node call per pool
    and pass (the batched scheduler pass never asks for it, but the one-
    problem chunked_match is its batch of one), the result identical to
    each lane's chunked_match."""
    calls = []
    real = port_match.best_node

    def counted(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(port_match, "best_node", counted)
    arrays = _stacked_problems(21)
    knobs = dict(chunk=16, rounds=2, passes=4, use_pallas=True)
    got = port_match.chunked_match_pools(_port_problem(arrays), **knobs)
    assert len(calls) == P * 3 * 4   # pools x chunks x passes
    for p in range(P):
        lane = port_match.chunked_match(port_match.MatchProblem(
            *(None if t is None else t[p] for t in _port_problem(arrays))),
            **knobs)
        assert torch.equal(lane.assignment, got.assignment[p])


@pytest.mark.parametrize("seed", range(3))
def test_dru_rank_pools_matches_reference(seed):
    rng = np.random.default_rng(seed)
    lanes = []
    for _ in range(P):
        user, mem, cpus, gpus, order_key, mdiv, cdiv, gdiv = \
            random_dru_problem(rng)
        t = len(user)
        lanes.append((pad_to(user.astype(np.int32), 256),
                      pad_to(np.round(mem), 256),
                      pad_to(np.round(cpus * 8) / 8, 256),
                      pad_to(gpus, 256), pad_to(order_key, 256, fill=BIG),
                      pad_to(np.ones(t, bool), 256, fill=False),
                      mdiv, cdiv, gdiv))
    n_users = max(len(lane[6]) for lane in lanes)

    def stack(k, dtype):
        if k >= 6:   # divisors: pad every lane to the most users
            return np.stack([pad_to(np.asarray(lane[k], np.float32),
                                    n_users, fill=1.0) for lane in lanes])
        return np.stack([np.asarray(lane[k]) for lane in lanes]).astype(dtype)

    tasks = [stack(0, np.int32), stack(1, np.float32), stack(2, np.float32),
             stack(3, np.float32), stack(4, np.float32), stack(5, bool)]
    divs = [stack(6, np.float32), stack(7, np.float32), stack(8, np.float32)]
    want = ref_dru.dru_rank_pools(ref_dru.DruTasks(*map(jnp.asarray, tasks)),
                                  *map(jnp.asarray, divs))
    got = port_dru.dru_rank_pools(
        port_dru.from_numpy(*tasks, device="cpu"),
        *map(torch.as_tensor, divs))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(want.rank))
    np.testing.assert_allclose(got.dru.numpy(), np.asarray(want.dru),
                               rtol=1e-6)


def test_stacked_problem_pads_lanes_invalid():
    """`stack_pool_problems`: each pool in its corner of one [P, J, N]
    allocation, padded lanes invalid with zero demand and capacity, and a
    bonus for every lane when one pool has one."""
    def problem(j, n, bonus):
        return port_match.from_numpy(
            np.full((j, 4), 2.0), np.ones(j, bool), np.full((n, 4), 8.0),
            np.full((n, 2), 8.0), np.ones(n, bool), np.ones((j, n), bool),
            None if bonus is None else np.full(n, bonus), device="cpu")

    out = port_matcher.stack_pool_problems([problem(4, 2, None),
                                            problem(8, 6, 0.5)])
    assert tuple(out.feasible.shape) == (2, 8, 6)
    assert out.job_valid[0].tolist() == [True] * 4 + [False] * 4
    assert out.node_valid[0].tolist() == [True] * 2 + [False] * 4
    assert float(out.demands[0, 4:].abs().sum()) == 0.0
    assert float(out.avail[0, 2:].abs().sum()) == 0.0
    assert float(out.totals[0, 2:].abs().sum()) == 0.0
    assert not out.feasible[0, 4:].any() and not out.feasible[0, :, 2:].any()
    assert out.node_bonus[0].tolist() == [0.0] * 6
    assert out.node_bonus[1].tolist() == [0.5] * 6


# ------------------------------------------- the pool-batched scheduler


def _pkg(ent, store, mock, core, matcher, **extra):
    return SimpleNamespace(ent=ent, JobStore=store.JobStore, mock=mock,
                           core=core, matcher=matcher, extra=extra)


REF = _pkg(ref_ent, ref_store, ref_mock, ref_core, ref_matcher)
PORT = _pkg(port_ent, port_store, port_mock, port_core, port_matcher,
            device="cpu")


def _job(P_, uuid, user, pool, mem, cpus=1.0, gpus=0.0):
    e = P_.ent
    return e.Job(uuid=uuid, user=user, pool=pool, priority=50,
                 max_retries=1, command="true",
                 resources=e.Resources(mem=mem, cpus=cpus, gpus=gpus))


def setup_multi(P_, n_pools=4, hosts_per_pool=3, **match_kw):
    """tests/test_multipool.py's rig: pools pool0..pool{n-1}, each with its
    own 8 cpu hosts, 4000 MB on the exact greedy; the chunked matchers get
    hosts of distinct memory (4000 MB + 100 x host + 10 x pool), so that
    no two hosts tie: the reference's `approx_max_k` lists equal scores in
    another order than the port's exact top-kc (ROADMAP Queue C port item
    3), which is not a fault of the contract."""
    clock = FakeClock()
    store = P_.JobStore(clock=clock)
    hosts = []
    distinct = bool(match_kw.get("chunk"))
    for p in range(n_pools):
        store.set_pool(P_.ent.Pool(name=f"pool{p}"))
        for i in range(hosts_per_pool):
            hosts.append(P_.mock.MockHost(
                node_id=f"p{p}h{i}", hostname=f"p{p}h{i}",
                mem=4000 + (100 * i + 10 * p if distinct else 0),
                cpus=8, pool=f"pool{p}"))
    cluster = P_.mock.MockCluster("mock", hosts, clock=clock)
    scheduler = P_.core.Scheduler(
        store, [cluster],
        P_.core.SchedulerConfig(match=P_.matcher.MatchConfig(**match_kw)),
        **P_.extra)
    return clock, store, cluster, scheduler


def _placements(outcomes):
    return {name: sorted((j.uuid, o.hostname) for j, o in out.matched)
            for name, out in outcomes.items()}


def _batched_run(P_, **match_kw):
    """tests/test_multipool.py:41: 4 pools x 5 jobs of 500 MB / 1 cpu, one
    batched cycle: every job runs, on a host of its own pool."""
    _, store, _, scheduler = setup_multi(P_, **match_kw)
    jobs = [_job(P_, f"job-{p}-{i}", f"u{i % 3}", f"pool{p}", 500.0)
            for p in range(4) for i in range(5)]
    store.submit_jobs(jobs)
    outcomes = scheduler.match_cycle_all_pools()
    assert set(outcomes) == {f"pool{p}" for p in range(4)}
    assert sum(len(o.matched) for o in outcomes.values()) == len(jobs)
    for job in jobs:
        assert store.jobs[job.uuid].state == P_.ent.JobState.RUNNING
        [inst] = store.job_instances(job.uuid)
        assert inst.hostname.startswith(f"p{job.pool[-1]}")
    return _placements(outcomes), scheduler


@pytest.mark.parametrize("chunk", [0, 4], ids=["exact", "chunked"])
def test_batched_matches_all_pools_like_the_reference(chunk):
    got, sched = _batched_run(PORT, chunk=chunk)
    want, ref_sched = _batched_run(REF, chunk=chunk)
    assert got == want
    # one shared solve: every record is batched and names the padded
    # batch shape, and the telemetry saw one `match_batched` solve
    records = sched.recorder.records_json(limit=4)
    ref_records = ref_sched.recorder.records_json(limit=4)
    assert [r["batched"] for r in records] == [True] * 4
    assert [(r["pool"], r["solve_shape"], r["backend"]) for r in records] \
        == [(r["pool"], r["solve_shape"], r["backend"])
            for r in ref_records]
    stats = sched.telemetry.observatory.stats()["match_batched"]
    assert stats["solves_in_window"] == stats["programs"] == 1
    assert stats == ref_sched.telemetry.observatory.stats()["match_batched"]


def _batched_vs_per_pool(P_, **match_kw):
    """tests/test_multipool.py:55: 4 pools x 6 jobs of 100-600 MB; the
    batched cycle on one rig, per-pool match cycles on a second."""
    def submit(store):
        store.submit_jobs([
            _job(P_, f"job-{p}-{i}", f"u{i % 2}", f"pool{p}",
                 100.0 * (i + 1)) for p in range(4) for i in range(6)])

    _, s1, _, sched1 = setup_multi(P_, **match_kw)
    _, s2, _, sched2 = setup_multi(P_, **match_kw)
    submit(s1)
    submit(s2)
    batched = _placements(sched1.match_cycle_all_pools())
    per_pool = _placements({p.name: sched2.match_cycle(p)
                            for p in s2.pools.values()})
    assert batched == per_pool
    return batched


@pytest.mark.parametrize("knobs", [
    dict(chunk=0), dict(chunk=4),
    dict(chunk=4, backend="bucketed", chunk_passes=2)],
    ids=["exact", "xla", "bucketed"])
def test_batched_equals_per_pool_decisions_like_the_reference(knobs):
    assert _batched_vs_per_pool(PORT, **knobs) == \
        _batched_vs_per_pool(REF, **knobs)


def test_batched_pass_turns_pallas_into_xla_like_the_reference():
    """With backend `pallas` the batched pass solves its flat lanes on
    `xla` (`vmap_safe_backend`), in both packages: the same placements as
    the reference and as an `xla` batched pass, and no best_node call."""
    got, sched = _batched_run(PORT, chunk=4, backend="pallas")
    assert got == _batched_run(REF, chunk=4, backend="pallas")[0]
    assert got == _batched_run(PORT, chunk=4)[0]
    assert {r["backend"] for r in sched.recorder.records_json(limit=4)} \
        == {"xla"}


def _gpu_pool(P_):
    """tests/test_multipool.py:88: a DruMode.GPU pool of two 4-gpu hosts;
    a's three and b's one 2-gpu jobs; rank, then match."""
    clock = FakeClock()
    store = P_.JobStore(clock=clock)
    store.set_pool(P_.ent.Pool(name="gpu", dru_mode=P_.ent.DruMode.GPU))
    hosts = [P_.mock.MockHost(node_id=f"g{i}", hostname=f"g{i}", mem=8000,
                              cpus=16, gpus=4.0, pool="gpu")
             for i in range(2)]
    cluster = P_.mock.MockCluster("mock", hosts, clock=clock)
    scheduler = P_.core.Scheduler(store, [cluster], None, **P_.extra)
    jobs = [_job(P_, f"a{i}", "a", "gpu", 100.0, gpus=2.0) for i in range(3)]
    jobs += [_job(P_, "b0", "b", "gpu", 100.0, gpus=2.0)]
    store.submit_jobs(jobs)
    pool = store.pools["gpu"]
    queue = scheduler.rank_cycle(pool)
    order = [j.uuid for j in queue.jobs]
    # gpu dru mode: b's first job ranks before a's second and third
    assert "b0" in order[:2]
    outcome = scheduler.match_cycle(pool)
    assert len(outcome.matched) == 4
    assert all(o.gpus == 0 for o in cluster.pending_offers("gpu"))
    return order, sorted((j.uuid, o.hostname) for j, o in outcome.matched)


def test_gpu_pool_dru_mode_end_to_end_like_the_reference():
    assert _gpu_pool(PORT) == _gpu_pool(REF)


def _multipool_trace(S, seeds=(20, 21), jobs=60, hosts=6, gpu=False):
    """tests/test_multipool.py:260's trace: one synth_trace per pool with
    its own seed, uuids and node ids made unique across pools; with
    `gpu`, every tenth job asks for 1-3 gpus and every fifth host
    carries 8."""
    all_jobs, all_hosts = [], []
    for p, seed in enumerate(seeds):
        pjobs, phosts = S.synth_trace(
            jobs, hosts, n_users=4, seed=seed, mean_runtime_ms=60_000,
            submit_span_ms=120_000, pool=f"pool{p}")
        for k, j in enumerate(pjobs):
            j.uuid = f"p{p}-{j.uuid}"
            if gpu and k % 10 == 0:
                j.gpus = float(1 + k % 3)
        for k, h in enumerate(phosts):
            h.node_id = f"p{p}-{h.node_id}"
            h.hostname = h.node_id
            if gpu and k % 5 == 0:
                h.gpus = 8.0
        all_jobs += pjobs
        all_hosts += phosts
    return all_jobs, all_hosts


def _sig(result):
    return sorted((r["job_uuid"], r["start_ms"], r["host"])
                  for r in result.rows)


@pytest.mark.parametrize("gpu", [False, True], ids=["cpu-mem", "gpu"])
def test_simulator_multipool_batched_like_the_reference(gpu):
    """tests/test_multipool.py:260 on both packages: batched equals
    per-pool in each, and the port's batched run equals the reference's
    (the `gpu` case adds a gpu column and puts pool1 in DruMode.GPU)."""
    pools = (("pool0", "default"), ("pool1", "gpu" if gpu else "default"))
    runs = {}
    for name, S, extra in (("ref", ref_sim, {}),
                           ("port", port_sim, {"device": "cpu"})):
        jobs, hosts = _multipool_trace(S, gpu=gpu)
        for batched in (True, False):
            runs[name, batched] = S.Simulator(
                jobs, hosts, S.SimConfig(cycle_ms=15_000, pools=pools,
                                         batched_match=batched),
                **extra).run()
    assert _sig(runs["port", True]) == _sig(runs["port", False])
    assert _sig(runs["port", True]) == _sig(runs["ref", True])
    assert runs["port", True].to_csv() == runs["ref", True].to_csv()
    assert all(row["status"] == "success" for row in runs["port", True].rows)
    # the batched run reports the pass's phase walls
    walls = runs["port", True].phase_wall_s
    assert {"rank", "match", "encode", "solve", "launch"} <= set(walls)


def _mixed_pools(P_):
    """One pool over the hierarchical threshold (100 hosts, padded to
    128, x 64 padded jobs) beside two flat ones (4 hosts: 64 x 64), the
    flat pools solved in one batch, the big one through the two-level
    path; a topology bonus on every pool.  Returns the placements and the
    records' backends."""
    clock = FakeClock()
    store = P_.JobStore(clock=clock)
    hosts = []
    sizes = {"big": 100, "pool1": 4, "pool2": 4}
    for name, n in sizes.items():
        store.set_pool(P_.ent.Pool(name=name))
        for i in range(n):
            hosts.append(P_.mock.MockHost(
                node_id=f"{name}-h{i:02d}", hostname=f"{name}-h{i:02d}",
                mem=4000 + 10 * i, cpus=8, pool=name))
    cluster = P_.mock.MockCluster("mock", hosts, clock=clock)
    match = dict(chunk=16, chunk_rounds=2, chunk_passes=12,
                 backend="pallas", hierarchical_threshold=128 * 64,
                 hierarchical_nodes_per_block=16,
                 hierarchical_coarse_backend="pallas",
                 hierarchical_fine_backend="pallas", topology_weight=0.5,
                 topology_block_hosts=2)
    if P_ is REF:
        match["hierarchical_use_mesh"] = False
    scheduler = P_.core.Scheduler(
        store, [cluster],
        P_.core.SchedulerConfig(match=P_.matcher.MatchConfig(**match)),
        **P_.extra)
    rng = np.random.default_rng(4)
    jobs = []
    for name in sizes:
        for i in range(40 if name == "big" else 12):
            jobs.append(_job(P_, f"{name}-j{i:02d}", f"u{i % 3}", name,
                             float(rng.choice([500, 1000, 1500])),
                             float(rng.choice([0.5, 1, 2]))))
    store.submit_jobs(jobs)
    outcomes = scheduler.match_cycle_all_pools()
    records = {r["pool"]: r["backend"]
               for r in scheduler.recorder.records_json(limit=3)}
    return _placements(outcomes), records


def test_batched_pass_with_a_hierarchical_pool_like_the_reference():
    got, got_backends = _mixed_pools(PORT)
    want, want_backends = _mixed_pools(REF)
    assert got == want
    assert got_backends == want_backends
    assert got_backends["big"].startswith("hier-")
    assert got_backends["pool1"] == got_backends["pool2"] == "xla"


def test_sim_cli_runs_batched_on_the_cpu(tmp_path, capsys):
    """`sim.cli run --batched --device cpu` on a two-pool trace file
    writes the same run trace as the per-pool replay."""
    jobs, hosts = _multipool_trace(port_sim, jobs=30, hosts=4)
    trace = tmp_path / "t.json"
    port_cli.write_trace(str(trace), jobs, hosts)
    out = {}
    for flag in ("--batched", None):
        path = tmp_path / f"{flag}.csv"
        argv = ["run", "--trace", str(trace), "--out", str(path),
                "--device", "cpu", "--chunk", "4"]
        assert port_cli.main(argv + ([flag] if flag else [])) == 0
        out[flag] = port_cli.load_rows(str(path))
    ok, diffs = port_cli.traces_equivalent(out["--batched"], out[None])
    assert ok, diffs


# the multi-pool slice's shape at a CPU test's size: alpha 3x the others,
# the last pool in DruMode.GPU; alpha's padded 1024 x 128 problem is over
# the threshold, the others' 1024 x 64 under it
SMALL_POOLS = (("alpha", 300, 100, "default"),) + tuple(
    (f"pool{k}", 100, 20, "gpu" if k == 3 else "default")
    for k in range(1, 4))
SMALL_MATCH = dict(hierarchical_threshold=100_000,
                   hierarchical_nodes_per_block=32)


def test_chip_smoke_multipool_phases_on_cpu(capsys):
    """chip_smoke.py's multipool phases on the CPU at 4 pools (alpha 300
    jobs x 100 hosts, three of 100 x 20): the three routes (capacity after
    every match, pipelined = serial, every batched lane = its per-pool xla
    solve, alpha two-level, no solve-failed), the exact batched-vs-serial
    cycle and the agreement replay."""
    import chip_smoke

    # 3 cycles, as the card ran them before the script's depth went to 2
    launches, calls, trace = chip_smoke.multipool_phase(
        device="cpu", pools=SMALL_POOLS, match_overrides=SMALL_MATCH,
        cycles=3)
    # the wrappers count launches on the card only; every call is kept
    assert launches == {"best_node": 0, "coarse_pass": 0,
                        "best_node_batched": 0}
    assert all(calls[name] for name in ("best_node", "coarse_pass",
                                        "best_node_batched"))
    walls = chip_smoke.multipool_exact_phase(*trace, device="cpu")
    assert walls["batched"]["solve_s"] > 0
    chip_smoke.multipool_agreement_phase(devices=("cpu",),
                                         cycles=3)
    out = capsys.readouterr().out
    assert "pipelined run trace identical to the serial one" in out
    assert "overlap_fraction" in out
    for route in ("serial", "batched", "pipelined"):
        assert f"multipool {route} cycle 3" in out
