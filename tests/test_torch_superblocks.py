"""The superblock layer of `cook_tpu_torch.ops.hierarchical` against
`cook_tpu`'s on the CPU: every case of tests/test_superblocks.py run on
the port (packing parity across widths 320/384/448 at the reference's
HIER_EFF_TOLERANCE, one shape per level across superblock counts through
the port's CompileObservatory, the stand-down below two superblocks, a
gang in one fine block, the `match_cycle` record and the
`hierarchical.superblocks` gauge), assignment identity with the
reference's `hierarchical_match` at SB_PARAMS on the `pallas` fine
backend (the reference's kernel in interpret mode), and `gather_super`
and the batched coarse solve each alone, identical.

Identity needs exact-sum inputs (tests/test_torch_hierarchical.py's
`exact_problem`: whole multiples of 512 MB and 0.5 cpu): the block and
superblock aggregates are float32 sums that XLA and torch add in other
orders.  The `xla` fine backend's candidate lists break ties in another
order than the reference's (ROADMAP Queue C port item 3), so on the
reference's own `dense_problem` the port is held to its packing floor."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops import cpu_reference as ref_cpu
from cook_tpu.ops import hierarchical as ref
from cook_tpu_torch.obs.compile_observatory import CompileObservatory
from cook_tpu_torch.ops import hierarchical as port
from cook_tpu_torch.ops.match import from_numpy
from cook_tpu_torch.utils.metrics import global_registry
from tests.test_hierarchical import (
    HIER_EFF_TOLERANCE,
    assert_valid,
    dense_problem,
    efficiency,
)
from tests.test_superblocks import SB_PARAMS
from tests.test_torch_hierarchical import exact_problem, solve_both

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

# fewer unrolled passes than the defaults keep the reference's compile
# short; the scheme is the same
SB_FAST = dict(SB_PARAMS, coarse_passes=4, fine_passes=6)


def port_problem(demands, avail, totals, feasible=None):
    j, n = demands.shape[0], avail.shape[0]
    return from_numpy(demands, np.ones(j, bool), avail, totals,
                      np.ones(n, bool), feasible, device="cpu")


def port_solve(demands, avail, totals, **kw):
    params = kw.pop("params")
    result, stats = port.hierarchical_match(
        port_problem(demands, avail, totals), params=params, **kw)
    return result.assignment.numpy(), stats


# ------------------------------------------------ tests/test_superblocks.py


@pytest.mark.parametrize("n", [320, 384, 448])
def test_superblock_parity_across_widths(n):
    """test_superblocks.py:30 on the port: packing within
    HIER_EFF_TOLERANCE of the flat reference greedy with the layer
    engaged, and the reference's geometry."""
    demands, avail, totals = dense_problem(512, n, seed=n)
    a, stats = port_solve(demands, avail, totals,
                          params=port.HierParams(**SB_PARAMS))
    assert_valid(demands, avail[:, :3], a)
    flat = ref_cpu.np_greedy_match(demands, avail[:, :3], totals)
    eff = efficiency(demands, a, flat)
    assert eff >= HIER_EFF_TOLERANCE, (n, eff)
    assert stats["superblocks"] == n // 64
    assert stats["superblock_blocks"] == 2
    assert stats["superblock_nodes"] == 64
    assert stats["coarse_backend"] == "xla"  # forced on the batched path


def test_one_program_per_level_across_superblock_counts():
    """test_superblocks.py:52 on the port: superblock counts 5, 6, 7 pad
    onto the same (super-coarse, coarse, fine) shapes, so the port's
    CompileObservatory sees one shape per level (no mesh here: the
    buckets alone do it)."""
    observatory = CompileObservatory()
    for n in (320, 384, 448):
        demands, avail, totals = dense_problem(512, n, seed=n)
        a, stats = port_solve(demands, avail, totals,
                              params=port.HierParams(**SB_PARAMS),
                              observatory=observatory)
        assert stats["superblocks"] == n // 64
        assert stats["super_shape"] == (512, 8)
        assert stats["coarse_shape"] == (8, 256, 2)
        assert stats["fine_shape"] == (16, 128, 32)
        assert_valid(demands, avail[:, :3], a)
        assert (a[a >= 0] < n).all()  # every placement on a REAL node
        assert (a >= 0).sum() > 0
    obs_stats = observatory.stats()
    assert obs_stats["match_super_coarse"]["programs"] == 1
    assert obs_stats["match_coarse"]["programs"] == 1
    assert obs_stats["match_fine"]["programs"] == 1


def test_superblock_layer_stands_down_below_two():
    """test_superblocks.py:81: a pool within one superblock is the classic
    two-level problem, and the port solves it exactly as the reference."""
    demands, avail, totals, _ = exact_problem(256, 128, seed=1)
    params = dict(nodes_per_block=32, superblock_nodes=256, chunk=64,
                  kc=32, fine_backend="pallas", coarse_passes=4,
                  fine_passes=6)
    stats = solve_both(demands, avail, totals, **params)
    assert stats["superblocks"] == 0
    assert stats["super_shape"] is None
    assert stats["super_coarse_s"] == 0.0
    assert len(stats["coarse_shape"]) == 2  # flat jobs x blocks


def test_gang_lands_in_one_fine_block_on_superblock_path():
    """test_superblocks.py:99 on the port: every placed gang's nodes share
    one nodes_per_block-aligned block, and no gang partly places."""
    j, n, npb = 128, 256, 32
    demands, avail, totals = dense_problem(j, n, seed=11)
    gang_id = np.full(j, -1, dtype=np.int32)
    gang_need = np.zeros(j, dtype=np.int32)
    for g in range(8):  # 8 gangs of 4 on the first 32 rows
        gang_id[g * 4:g * 4 + 4] = g
        gang_need[g * 4:g * 4 + 4] = 4
    a, stats = port_solve(
        demands, avail, totals,
        params=port.HierParams(nodes_per_block=npb, superblock_nodes=64,
                               chunk=64, kc=32),
        gang_id=gang_id, gang_need=gang_need)
    assert stats["superblocks"] == n // 64
    assert_valid(demands, avail[:, :3], a)
    for g in range(8):
        placed = a[gang_id == g]
        if (placed < 0).any():
            assert (placed < 0).all(), (g, placed)
            continue
        assert len(set(placed.tolist())) == 4
        assert len({int(p) // npb for p in placed}) == 1, (g, placed)
    assert stats["gangs"]["considered"] == 8
    assert stats["gangs"]["placed"] >= 1


def test_superblocks_gauge_tracks_last_solve():
    """test_superblocks.py:164: the port's `hierarchical.superblocks`
    gauge holds the pool's last solve's superblock count (0 when off)."""
    demands, avail, totals = dense_problem(256, 320, seed=2)
    port_solve(demands, avail, totals, params=port.HierParams(**SB_PARAMS),
               pool="sb-pool")
    gauge = global_registry.gauge("hierarchical.superblocks")
    assert gauge.value(labels={"pool": "sb-pool"}) == 5
    port_solve(demands, avail, totals, params=port.HierParams(
        nodes_per_block=32, chunk=64, kc=32), pool="sb-pool")
    assert gauge.value(labels={"pool": "sb-pool"}) == 0
    solves = global_registry.counter("hierarchical.solves")
    assert solves.value(labels={"pool": "sb-pool", "backend": "xla"}) >= 2


# ------------------------------------------------- identity with the JAX


@pytest.mark.parametrize("masked", [False, True], ids=["free", "masked"])
@pytest.mark.parametrize("n", [320, 384, 448])
def test_superblock_solve_matches_reference(n, masked):
    """SB_PARAMS with the `pallas` fine backend: assignment, new_avail and
    every stat (superblock geometry and spill included) identical to the
    reference's `hierarchical_match`."""
    demands, avail, totals, feasible = exact_problem(512, n, seed=n,
                                                     masked=masked)
    stats = solve_both(demands, avail, totals, feasible,
                       fine_backend="pallas", **SB_FAST)
    assert stats["superblocks"] == n // 64
    assert stats["placed"] > 0


def test_superblock_gangs_match_reference(ref_release_synced):
    """A gang rig on the superblock path: the leader routes at both coarse
    levels, gated on the block's host count; identical to the reference."""
    from tests.test_torch_hierarchical import gang_rows

    demands, avail, totals, _ = exact_problem(256, 256, seed=5)
    stats = solve_both(demands, avail, totals, gangs=gang_rows(256, seed=5),
                       fine_backend="pallas", **SB_FAST)
    assert stats["superblocks"] == 4
    assert stats["gangs"]["considered"] == 24


@pytest.fixture
def ref_release_synced(monkeypatch):
    """tests/test_torch_hierarchical.py's fixture: wait for the
    reference's `release_assignments` (ROADMAP Queue C reference item 4)."""
    import jax

    release = ref.release_assignments
    monkeypatch.setattr(ref, "release_assignments",
                        lambda *a: jax.block_until_ready(release(*a)))


def _super_inputs(seed, with_gangs):
    """Block aggregates of an exact-sum fleet (6 superblocks of 4 blocks
    of 16 nodes), a random super-coarse routing scattered into 64-slot
    lanes, and (optionally) gang gates."""
    rng = np.random.default_rng(seed)
    j, s, sb_blocks, npb = 256, 6, 4, 16
    demands, avail, totals, _ = exact_problem(j, s * sb_blocks * npb,
                                              seed=seed)
    node_valid = np.arange(avail.shape[0]) % 13 != 0
    aggs = ref.block_aggregates(jnp.asarray(avail), jnp.asarray(totals),
                                jnp.asarray(node_valid), npb)
    # the constraint mask reduced to "some node of the block is feasible"
    block_any = rng.uniform(size=(j, s * sb_blocks)) < 0.6
    active = rng.uniform(size=j) < 0.9
    sup = rng.integers(-1, s, j).astype(np.int32)
    job_idx, _ = ref.scatter_to_blocks(sup, active, s, 64)
    gate = need = None
    if with_gangs:
        gate = demands * rng.choice([1.0, 2.0], (j, 1)).astype(np.float32)
        need = rng.choice([1, 2, 4, 8], j).astype(np.int32)
    return (demands, active, gate, need, *map(np.asarray, aggs),
            block_any, job_idx, sb_blocks)


@pytest.mark.parametrize("with_gangs", [False, True],
                         ids=["scalar", "gangs"])
def test_gather_super_matches_reference(with_gangs):
    args = _super_inputs(3, with_gangs)
    want = ref.gather_super(*(None if a is None else jnp.asarray(a)
                              for a in args[:-1]), sb_blocks=args[-1])
    got = port.gather_super(*(None if a is None else torch.tensor(a)
                              for a in args[:-1]), args[-1])
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.feasible.any() and not got.feasible.all()


@pytest.mark.parametrize("with_gangs", [False, True],
                         ids=["scalar", "gangs"])
def test_batched_coarse_solve_matches_reference(with_gangs):
    """The batched coarse routing alone, its lanes padded to the bucket
    with dead lanes as the solve pads them: identical assignment and
    block availability."""
    args = _super_inputs(7, with_gangs)
    knobs = dict(coarse_chunk=32, coarse_rounds=2, coarse_passes=4)
    want_p = ref._pad_block_axis(ref.gather_super(
        *(None if a is None else jnp.asarray(a) for a in args[:-1]),
        sb_blocks=args[-1]), 2, 4)
    got_p = port._pad_block_axis(port.gather_super(
        *(None if a is None else torch.tensor(a) for a in args[:-1]),
        args[-1]), 2, 4)
    want = ref._coarse_batched_solve(want_p, ref.HierParams(**knobs), None)
    got = port._coarse_batched_solve(got_p, port.HierParams(**knobs))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.new_avail.numpy(),
                                  np.asarray(want.new_avail))
    assert (got.assignment.numpy() >= 0).sum() > 0


# ------------------------------------------------------ scheduler wiring


def _scenario(pkg, match_config):
    """tests/test_hierarchical.py:249 (`_scenario`) on either package."""
    if pkg == "ref":
        from cook_tpu.cluster.mock import MockCluster, MockHost
        from cook_tpu.models.entities import Job, Pool, Resources
        from cook_tpu.models.store import JobStore
        from cook_tpu.scheduler.core import Scheduler, SchedulerConfig
        kw = {}
    else:
        from cook_tpu_torch.cluster.mock import MockCluster, MockHost
        from cook_tpu_torch.models.entities import Job, Pool, Resources
        from cook_tpu_torch.models.store import JobStore
        from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
        kw = {"device": "cpu"}
    from tests.conftest import FakeClock

    clock = FakeClock()
    store = JobStore(clock=clock)
    store.set_pool(Pool(name="default"))
    hosts = [MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=32768.0,
                      cpus=16.0, pool="default") for i in range(64)]
    cluster = MockCluster("mock", hosts, clock=clock)
    scheduler = Scheduler(store, [cluster],
                          SchedulerConfig(match=match_config), **kw)
    rng = np.random.default_rng(5)
    store.submit_jobs([
        Job(uuid=f"j{i:04d}", user=f"u{i % 4}", pool="default", priority=50,
            resources=Resources(mem=float(rng.choice([512, 1024, 2048])),
                                cpus=float(rng.choice([1, 2]))),
            command="true")
        for i in range(300)])
    return store, scheduler


def _sb_config(pkg, **kw):
    if pkg == "ref":
        from cook_tpu.scheduler.matcher import MatchConfig
    else:
        from cook_tpu_torch.scheduler.matcher import MatchConfig
    # 64 hosts / 16 per block = 4 blocks; superblocks of 16 nodes round up
    # to 2 blocks (32 nodes) -> 2 superblocks
    return MatchConfig(chunk=64, chunk_kc=32, quality_audit_every=0,
                       hierarchical_threshold=1,
                       hierarchical_nodes_per_block=16,
                       hierarchical_superblock_nodes=16, **kw)


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_match_cycle_superblock_record(pkg):
    """test_superblocks.py:143 on both packages: the record carries the
    superblock count and the super_coarse_solve wall beside the three
    classic hier_phases keys, and round-trips to JSON."""
    store, scheduler = _scenario(pkg, _sb_config(pkg))
    outcome = scheduler.match_cycle(store.pools["default"])
    assert len(outcome.matched) > 250
    record = scheduler.recorder.records(limit=1)[0]
    assert record.hierarchical
    assert record.hier_blocks == 4
    assert record.hier_superblocks == 2
    assert set(record.hier_phases) == {"super_coarse_solve",
                                       "coarse_solve", "fine_solve",
                                       "refine"}
    assert record.hier_phases["super_coarse_solve"] > 0
    assert record.to_json()["hier_superblocks"] == 2


def test_match_cycle_superblock_placements_match_reference():
    """The same superblock cycle on the `pallas` fine backend: the port
    launches exactly the reference's (job, host) pairs and its record's
    hierarchical accounting is the reference's."""
    runs = {}
    for pkg in ("ref", "port"):
        store, scheduler = _scenario(pkg, _sb_config(
            pkg, hierarchical_fine_backend="pallas"))
        outcome = scheduler.match_cycle(store.pools["default"])
        record = scheduler.recorder.records(limit=1)[0].to_json()
        runs[pkg] = ({(j.uuid, o.hostname) for j, o in outcome.matched},
                     {k: record[k] for k in (
                         "hier_blocks", "hier_superblocks", "hier_spilled",
                         "hier_refine_placed", "block_stats", "backend")})
    assert runs["port"] == runs["ref"]
    assert len(runs["port"][0]) > 250
