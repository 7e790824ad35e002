"""The device mesh of `cook_tpu_torch.parallel.mesh` (torch.distributed)
against `cook_tpu.parallel.mesh` (a `jax.sharding.Mesh`) on the CPU.

The reference runs in this process on the first D of the 8 virtual
devices tests/conftest.py provides (`make_mesh(n_devices=D)`); the port
runs on D gloo ranks spawned by `run_on_mesh`, whose bodies live in the
jax-free tests/test_torch_mesh_ranks.py.  The inputs are numpy arrays made
here from seeds (tests/test_parallel.py's), and each rank group runs every
case at once, so a D costs one spawn.

- The cases of tests/test_parallel.py, and `pool_sharded_coarse`, at D = 2
  and 4: assignments identical to the reference's at the same D and knobs
  (the node-sharded chunked solve included), `new_avail` within the
  reference test's rtol 1e-5 / atol 1e-4, DRU orders and ranks identical
  and DRU values within rtol 1e-6 (tests/test_torch_dru.py's bound: the
  DRU inputs are tests/test_parallel.py's, rounded to whole MB and half
  cpus so that their sums are exact in float32 in XLA's blocked order
  and the port's sequential one); the sharded solves and ranks equal the
  port's single-process ones exactly; padded lanes place nothing.
- `node_sharded_chunked_match` on a mesh of one equals `chunked_match`.
- `make_mesh(backend="nccl")` refuses more ranks than cards; `run_on_mesh`
  raises a failing rank's traceback and a hung rank's deadline (that a
  spawned rank loads no JAX is tests/test_torch_imports.py's).
- chip_smoke.py's mesh phases (11g, 11h) at a CPU size.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cook_tpu.ops import cpu_reference as ref_cpu
from cook_tpu.ops.dru import DruTasks
from cook_tpu.ops.match import MatchProblem
from cook_tpu.parallel import mesh as ref_mesh
from cook_tpu_torch.parallel import mesh as port_mesh
from tests import test_torch_mesh_ranks as ranks
from tests.test_ops_parity import random_dru_problem, random_match_problem

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

MESH_SIZES = (2, 4)
# a rank group's deadline: spawn, import and every case
GROUP_TIMEOUT_S = 240.0
# DRU values across the packages on exact-sum inputs (tests/test_torch_dru.py)
DRU_RTOL = 1e-6
FIELDS = ("demands", "job_valid", "avail", "totals", "node_valid",
          "feasible")


def pool_batch(n_pools=8, j=64, n=16, seed=0, masked=True):
    """tests/test_parallel.py's `make_pool_batch` as numpy arrays."""
    probs = [random_match_problem(np.random.default_rng(seed + p), j=j, n=n)
             for p in range(n_pools)]
    stack = lambda i: np.stack([p[i] for p in probs])  # noqa: E731
    return dict(demands=stack(0), job_valid=np.ones((n_pools, j), bool),
                avail=stack(1), totals=stack(2),
                node_valid=np.ones((n_pools, n), bool),
                feasible=stack(3) if masked else None)


def one_problem(seed, j, n):
    demands, avail, totals, feasible = random_match_problem(
        np.random.default_rng(seed), j=j, n=n)
    return dict(demands=demands, job_valid=np.ones(j, bool), avail=avail,
                totals=totals, node_valid=np.ones(n, bool),
                feasible=feasible)


def dru_tasks(problems):
    """random_dru_problem tuples stacked (or one) as DruTasks arrays and
    the three divisors, memory rounded to whole MB and cpus to halves so
    that every partial sum is exact in float32 whatever the order."""
    cols = [np.stack([p[i] for p in problems]) for i in range(8)]
    user, mem, cpus, gpus, order_key, md, cd, gd = cols
    mem, cpus = np.round(mem), np.round(cpus * 2) / 2
    tasks = dict(user=user.astype(np.int32), mem=mem.astype(np.float32),
                 cpus=cpus.astype(np.float32), gpus=gpus.astype(np.float32),
                 order_key=order_key.astype(np.float32),
                 valid=np.ones(user.shape, bool))
    return dict(tasks=tasks, md=md.astype(np.float32),
                cd=cd.astype(np.float32), gd=gd.astype(np.float32))


def padded_batch():
    """3 real pools and 5 all-invalid lanes (`invalid_match_problem`)."""
    real = pool_batch(n_pools=3, j=64, n=16, seed=21)
    pad = dict(demands=np.zeros((64, 3)), job_valid=np.zeros(64, bool),
               avail=np.zeros((16, 3)), totals=np.ones((16, 2)),
               node_valid=np.zeros(16, bool),
               feasible=np.zeros((64, 16), bool))
    return real, {k: np.concatenate([real[k],
                                     np.broadcast_to(pad[k], (5,)
                                                     + pad[k].shape)])
                  for k in FIELDS}


def parallel_inputs():
    real, padded = padded_batch()
    task = dru_tasks([random_dru_problem(np.random.default_rng(77), t=1024,
                                         u=16)])
    task = dict(tasks={k: v[0] for k, v in task["tasks"].items()},
                **{k: task[k][0] for k in ("md", "cd", "gd")})
    return dict(
        pool_batch=pool_batch(),
        pool_dru=dru_tasks([random_dru_problem(np.random.default_rng(40 + p),
                                               t=128, u=8)
                            for p in range(8)]),
        node_greedy=one_problem(7, 96, 64),
        node_chunked=one_problem(17, 256, 64),
        task_dru=task,
        padded=padded, padded_real=real,
        unmasked=pool_batch(seed=33, masked=False),
        coarse=pool_batch(seed=50))


def ref_problem(arrays):
    return MatchProblem(*(None if arrays.get(k) is None
                          else jnp.asarray(arrays[k]) for k in FIELDS))


def ref_tasks(arrays):
    return (DruTasks(**{k: jnp.asarray(v)
                        for k, v in arrays["tasks"].items()}),
            *(jnp.asarray(arrays[k]) for k in ("md", "cd", "gd")))


def _np(result):
    return tuple(np.asarray(t) for t in result)


def reference_cases(mesh, inputs):
    """tests/test_parallel.py's calls on the reference's mesh."""
    shard = lambda arrays: ref_mesh.shard_pools(  # noqa: E731
        mesh, ref_problem(arrays))
    return dict(
        pool_match=_np(ref_mesh.pool_sharded_match(
            mesh, shard(inputs["pool_batch"]))),
        pool_knobs=_np(ref_mesh.pool_sharded_match(
            mesh, shard(inputs["pool_batch"]), chunk=64, rounds=3, passes=3,
            backend="bucketed")),
        pool_dru=_np(ref_mesh.pool_sharded_dru(
            mesh, *ref_tasks(inputs["pool_dru"]))),
        node_greedy=_np(ref_mesh.node_sharded_greedy_match(
            mesh, ref_problem(inputs["node_greedy"]))),
        node_chunked=_np(ref_mesh.node_sharded_chunked_match(
            mesh, ref_problem(inputs["node_chunked"]), chunk=64, rounds=3,
            kc=16, passes=3)),
        task_dru=_np(ref_mesh.task_sharded_dru(
            mesh, *ref_tasks(inputs["task_dru"]))),
        padded=_np(ref_mesh.pool_sharded_match(mesh,
                                               shard(inputs["padded"]))),
        unmasked=_np(ref_mesh.pool_sharded_match(
            mesh, shard(inputs["unmasked"]), chunk=64, rounds=3, passes=2,
            kc=8)),
        coarse=_np(ref_mesh.pool_sharded_coarse(
            mesh, shard(inputs["coarse"]), chunk=64, rounds=2, passes=4)))


@pytest.fixture(scope="module", params=MESH_SIZES,
                ids=[f"D{d}" for d in MESH_SIZES])
def runs(request):
    """(D, inputs, the reference's results, the port's rank 0 results)."""
    d = request.param
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    inputs = parallel_inputs()
    port, ref = ranks.alongside(
        lambda: port_mesh.run_on_mesh(d, ranks.parallel_cases, inputs,
                                      backend="gloo", device="cpu",
                                      timeout_s=GROUP_TIMEOUT_S),
        lambda: reference_cases(ref_mesh.make_mesh(n_devices=d), inputs))
    return d, inputs, ref, port


def close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_ranks_form_a_gloo_mesh_on_the_cpu(runs):
    d, _, _, port = runs
    assert port["mesh"] == (0, d, "gloo", "cpu")


def test_pool_sharded_match_parity(runs):
    _, _, ref, port = runs
    (a, avail), (single_a, single_avail) = port["pool_match"]
    np.testing.assert_array_equal(a, ref["pool_match"][0])
    close(avail, ref["pool_match"][1])
    np.testing.assert_array_equal(a, single_a)
    np.testing.assert_array_equal(avail, single_avail)


def test_pool_sharded_match_backend_knobs(runs):
    _, inputs, ref, port = runs
    a, avail = port["pool_knobs"]
    np.testing.assert_array_equal(a, ref["pool_knobs"][0])
    close(avail, ref["pool_knobs"][1])
    feas = inputs["pool_batch"]["feasible"]
    for p in range(a.shape[0]):
        placed = a[p] >= 0
        assert placed.sum() > 0
        assert feas[p][np.where(placed)[0], a[p][placed]].all()


def test_pool_sharded_dru_parity(runs):
    _, _, ref, port = runs
    (dru, rank, order), (s_dru, s_rank, s_order) = port["pool_dru"]
    np.testing.assert_array_equal(order, ref["pool_dru"][2])
    np.testing.assert_array_equal(rank, ref["pool_dru"][1])
    np.testing.assert_allclose(dru, ref["pool_dru"][0], rtol=DRU_RTOL)
    for got, want in ((dru, s_dru), (rank, s_rank), (order, s_order)):
        np.testing.assert_array_equal(got, want)


def test_node_sharded_greedy_match_parity(runs):
    _, _, ref, port = runs
    (a, avail), (single_a, single_avail) = port["node_greedy"]
    np.testing.assert_array_equal(a, ref["node_greedy"][0])
    close(avail, ref["node_greedy"][1])
    np.testing.assert_array_equal(a, single_a)
    close(avail, single_avail)


def test_node_sharded_chunked_match_parity(runs):
    _, inputs, ref, port = runs
    a, avail = port["node_chunked"]
    np.testing.assert_array_equal(a, ref["node_chunked"][0])
    close(avail, ref["node_chunked"][1])
    arrays = inputs["node_chunked"]
    exact = ref_cpu.ref_greedy_match(arrays["demands"], arrays["avail"],
                                     arrays["totals"], arrays["feasible"])
    qe = ref_cpu.packing_quality(arrays["demands"], exact)
    q = ref_cpu.packing_quality(arrays["demands"], a)
    assert np.all(avail >= -1e-3)
    assert q["num_placed"] >= 0.99 * qe["num_placed"]
    assert q["cpus_placed"] >= 0.99 * qe["cpus_placed"]
    placed = a >= 0
    assert arrays["feasible"][np.where(placed)[0], a[placed]].all()


def test_task_sharded_dru_parity(runs):
    _, _, ref, port = runs
    (dru, rank, order), (s_dru, s_rank, s_order) = port["task_dru"]
    np.testing.assert_array_equal(order, ref["task_dru"][2])
    np.testing.assert_array_equal(rank, ref["task_dru"][1])
    np.testing.assert_allclose(dru, ref["task_dru"][0], rtol=DRU_RTOL)
    np.testing.assert_array_equal(order, s_order)
    np.testing.assert_array_equal(dru, s_dru)


def test_invalid_pool_padding_no_phantom_output(runs):
    _, _, ref, port = runs
    (a, avail), (real_a, _) = port["padded"]
    assert (a[3:] == -1).all(), "padded lanes produced phantom matches"
    np.testing.assert_array_equal(avail[3:], 0.0)
    np.testing.assert_array_equal(a[:3], real_a)
    np.testing.assert_array_equal(a, ref["padded"][0])
    close(avail, ref["padded"][1])


def test_pool_sharded_match_without_constraint_mask(runs):
    _, _, ref, port = runs
    a, avail = port["unmasked"]
    assert (a >= 0).sum() > 0
    assert np.all(avail >= -1e-3)
    np.testing.assert_array_equal(a, ref["unmasked"][0])
    close(avail, ref["unmasked"][1])


def test_pool_sharded_coarse_parity(runs):
    _, _, ref, port = runs
    (a, avail), (single_a, single_avail) = port["coarse"]
    np.testing.assert_array_equal(a, ref["coarse"][0])
    close(avail, ref["coarse"][1])
    np.testing.assert_array_equal(a, single_a)
    np.testing.assert_array_equal(avail, single_avail)


def test_node_sharded_chunked_on_one_rank_is_chunked_match():
    knobs = dict(chunk=64, rounds=3, kc=16, passes=3)
    (a, avail), (want_a, want_avail) = port_mesh.run_on_mesh(
        1, ranks.chunked_one_rank, one_problem(17, 256, 64), knobs,
        backend="gloo", device="cpu", timeout_s=GROUP_TIMEOUT_S)
    np.testing.assert_array_equal(a, want_a)
    np.testing.assert_array_equal(avail, want_avail)
    assert (a >= 0).sum() > 0


def test_make_mesh_refuses_nccl_with_more_ranks_than_cards(tmp_path):
    init = "file://" + str(tmp_path / "rendezvous")
    for device in ("cpu", None):
        with pytest.raises(ValueError, match="card of its own"):
            port_mesh.make_mesh(backend="nccl", device=device,
                                init_method=init, rank=0, world_size=2)
    assert not torch.distributed.is_initialized()


def test_run_on_mesh_raises_the_failing_ranks_traceback():
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed") as err:
        port_mesh.run_on_mesh(2, ranks.fail_on_rank, 1, backend="gloo",
                              device="cpu", timeout_s=GROUP_TIMEOUT_S)
    assert "ValueError: rank 1 gives up" in str(err.value)


def test_run_on_mesh_raises_when_a_rank_outlives_its_deadline():
    with pytest.raises(TimeoutError, match=r"rank\(s\) \[(0, )?1\] of 2"):
        port_mesh.run_on_mesh(2, ranks.hang_on_rank, 1, backend="gloo",
                              device="cpu", timeout_s=10.0)


def test_chip_smoke_mesh_phases_on_cpu(capsys, tmp_path):
    """chip_smoke.py's mesh phases on the CPU: 11a's slice at 4 pools
    (alpha 300 jobs x 100 hosts, three of 100 x 20) on its batched route,
    then 11g ((a) on one gloo rank, (b) at D = 2 and 4) and 11h (the node
    axis on one rank, then at D = 2 on 256 x 64 (greedy) and 1,000 x 512
    (chunked))."""
    import chip_smoke
    from tests.test_torch_multipool import SMALL_MATCH, SMALL_POOLS

    batched = {}
    chip_smoke.multipool_phase(device="cpu", pools=SMALL_POOLS,
                               match_overrides=SMALL_MATCH, cycles=2,
                               batched=batched)
    launches = chip_smoke.mesh_phase(
        batched, str(tmp_path), device="cpu", pools=SMALL_POOLS, cycles=2,
        match_overrides=SMALL_MATCH, timeout_s=GROUP_TIMEOUT_S)
    # the wrappers count launches on the card only
    assert launches == {"best_node": 0, "best_node_batched": 0,
                        "coarse_pass": 0}
    chip_smoke.mesh_node_phase(
        str(tmp_path), device="cpu", greedy=dict(j=256, n=64, seed=11),
        chunked=dict(j=1024, n=512, j_real=1000, seed=12),
        knobs=dict(chunk=64, rounds=3, kc=16, passes=2),
        timeout_s=GROUP_TIMEOUT_S)
    out = capsys.readouterr().out
    assert "mesh gloo x1 on cpu" in out
    for d in (2, 4):
        assert f"mesh gloo x{d}: " in out
    assert out.count("placed, every rank's run trace identical") == 2
    assert "node_sharded_chunked_match identical to chunked_match" in out
    assert "node_sharded_greedy_match identical to greedy_match" in out
    assert os.path.exists(tmp_path / "mesh-chunked" / "feasible.npy")
