"""The mesh in the port's scheduler against the reference's, on the CPU:
`Scheduler.match_cycle_all_pools(mesh)` (`matcher.match_pools_batched`'s
mesh branch), `hierarchical_match(mesh=)` (the fine batch sharded; the
superblock coarse batch in tests/test_torch_mesh_superblocks.py), and
`hier_mesh()` with `MatchConfig.hierarchical_use_mesh`.

The reference runs in this process on `make_mesh(n_devices=D)` of the 8
virtual devices tests/conftest.py provides; the port on D gloo ranks
spawned by `run_on_mesh` (bodies in tests/test_torch_mesh_ranks.py), each
rank driving the same scheduler (SPMD).  The cases are the scheduler-level
mesh cases of the reference's suite:

- tests/test_multipool.py:79 (`test_batched_with_mesh_sharding`);
- tests/test_pipeline.py:482 (`test_batched_mesh_pads_any_pool_count`);
- the mesh case of tests/test_hierarchical.py:193
  (`test_one_fine_program_across_block_counts`).

The port's placements equal the reference's at the same D and equal the
port's own run without a mesh.  The reference pins one XLA program per
level; the port compiles none, so its compile observatory's count of
padded shapes per level (one) stands in for it beside the placements."""
import numpy as np
import pytest
import torch

import jax

from cook_tpu.cluster.mock import MockCluster, MockHost
from cook_tpu.models.entities import Job, Pool, Resources
from cook_tpu.models.store import JobStore
from cook_tpu.obs.compile_observatory import CompileObservatory
from cook_tpu.ops.hierarchical import HierParams, hierarchical_match
from cook_tpu.parallel.mesh import make_mesh
from cook_tpu.scheduler.core import Scheduler, SchedulerConfig
from cook_tpu.scheduler.matcher import MatchConfig
from cook_tpu_torch.parallel import mesh as port_mesh
from tests import test_torch_mesh_ranks as ranks
from tests.test_hierarchical import as_problem, assert_valid, dense_problem

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

MESH_SIZES = (2, 4)
GROUP_TIMEOUT_S = 240.0
MULTIPOOL = ((8, 3),)                   # tests/test_multipool.py:79
PADS = ((3, 4), (5, 4), (8, 4))         # tests/test_pipeline.py:482
# tests/test_hierarchical.py:193: 3, 5 and 8 blocks of 32 nodes
HIER = [(dict(j=256, n=blocks * 32, seed=blocks),
         dict(nodes_per_block=32, jobs_per_block=128, chunk=64, kc=32))
        for blocks in (3, 5, 8)]


def ref_rig(n_pools, jobs_per_pool, users):
    """tests/test_multipool.py's `setup_multi` + `submit_work` with the
    uuids the port's rig gives (tests/test_torch_mesh_ranks.py)."""
    store = JobStore(clock=lambda: 1_000_000)
    hosts = []
    for p in range(n_pools):
        store.set_pool(Pool(name=f"pool{p}"))
        for i in range(3):
            hosts.append(MockHost(node_id=f"p{p}h{i}", hostname=f"p{p}h{i}",
                                  mem=4000, cpus=8, pool=f"pool{p}"))
    cluster = MockCluster("mock", hosts, clock=lambda: 1_000_000)
    scheduler = Scheduler(store, [cluster],
                          SchedulerConfig(match=MatchConfig()))
    store.submit_jobs([
        Job(uuid=f"job-{p}-{i}", user=f"u{i % users}", pool=f"pool{p}",
            priority=50, max_retries=1, command="true",
            resources=Resources(mem=500, cpus=1))
        for p in range(n_pools) for i in range(jobs_per_pool)])
    return scheduler


def ref_hier(cases, mesh):
    observatory = CompileObservatory()
    out = []
    for shape, params in cases:
        demands, avail, totals = dense_problem(**shape)
        result, stats = hierarchical_match(
            as_problem(demands, avail, totals), params=HierParams(**params),
            mesh=mesh, observatory=observatory)
        out.append((np.asarray(result.assignment),
                    {k: stats.get(k) for k in ranks.HIER_STATS}))
    stats = observatory.stats()
    return out, {name: stats[name]["programs"] for name in stats}


def hier_inputs(cases):
    return [(dict(zip(("demands", "avail", "totals"),
                      dense_problem(**shape))), params)
            for shape, params in cases]


@pytest.fixture(scope="module", params=MESH_SIZES,
                ids=[f"D{d}" for d in MESH_SIZES])
def runs(request):
    """(D, the reference's results, the port's rank 0 results)."""
    d = request.param
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    def reference():
        mesh = make_mesh(n_devices=d)
        ref = {}
        for key, shapes in (("multipool", MULTIPOOL), ("pads", PADS)):
            users = 2 if key == "pads" else 3
            ref[key] = [ranks.placements(ref_rig(n, per, users)
                                         .match_cycle_all_pools(mesh=mesh))
                        for n, per in shapes]
        ref["hier"], ref["hier_programs"] = ref_hier(HIER, mesh)
        return ref

    port, ref = ranks.alongside(
        lambda: port_mesh.run_on_mesh(
            d, ranks.scheduler_cases,
            dict(batched=True, hier=hier_inputs(HIER)), backend="gloo",
            device="cpu", timeout_s=GROUP_TIMEOUT_S),
        reference)
    return d, ref, port


@pytest.mark.parametrize("key,shapes", [("multipool", MULTIPOOL),
                                        ("pads", PADS)],
                         ids=["multipool-8-pools", "pads-3-5-8-pools"])
def test_batched_mesh_places_like_the_reference(runs, key, shapes):
    _, ref, port = runs
    for (n_pools, per_pool), want, (n, with_mesh, without) in zip(
            shapes, ref[key], port[key]):
        assert n == n_pools
        assert len(with_mesh) == n_pools * per_pool   # every job placed
        assert with_mesh == want
        assert with_mesh == without
        for uuid, host in with_mesh:
            assert host.startswith(f"p{uuid.split('-')[1]}h")


def check_hierarchical(ref, port, key, cases):
    for (shape, _), (want_a, want_stats), ((a, stats), (plain_a, _)) in zip(
            cases, ref[key], port[key]):
        np.testing.assert_array_equal(a, want_a)
        np.testing.assert_array_equal(a, plain_a)
        assert stats == want_stats
        demands, avail, _ = dense_problem(**shape)
        assert_valid(demands, avail[:, :3], a)
        # no phantom match: every placement indexes a real node
        assert (a[a >= 0] < shape["n"]).all() and (a >= 0).sum() > 0
    # one padded shape per level across the block / superblock counts
    assert port[key + "_programs"] == ref[key + "_programs"]
    assert set(port[key + "_programs"].values()) == {1}


def test_hierarchical_fine_mesh_solves_like_the_reference(runs):
    _, ref, port = runs
    check_hierarchical(ref, port, "hier", HIER)
    assert [s["block_pad"] for _, s in ref["hier"]] == [8, 8, 8]


def test_hier_mesh_is_the_process_mesh_gated_by_the_config(runs):
    d, _, port = runs
    from cook_tpu_torch.scheduler import matcher

    # on a rank, the accessor returns the rank's mesh; the config's
    # default lets the two-level path use it
    assert port["hier_mesh"] == (True, True)
    # in this process no mesh was made: the plain batched solve
    assert matcher.hier_mesh() is None
