"""Rank bodies of tests/test_torch_mesh.py: what each spawned gloo rank of
`cook_tpu_torch.parallel.mesh.run_on_mesh` runs on the CPU.  No test lives
here.  A spawned rank imports this module, so it imports neither JAX, the
`cook_tpu` reference nor the test configuration: its inputs are numpy
arrays made in the test process and carried across as arguments, and it
returns numpy arrays and plain Python values."""
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from cook_tpu_torch.cluster.mock import MockCluster, MockHost
from cook_tpu_torch.models.entities import Job, Pool, Resources
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.obs.compile_observatory import CompileObservatory
from cook_tpu_torch.ops import dru as port_dru
from cook_tpu_torch.ops import match as port_match
from cook_tpu_torch.ops.hierarchical import HierParams, hierarchical_match
from cook_tpu_torch.parallel import mesh as port_mesh
from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
from cook_tpu_torch.scheduler.matcher import MatchConfig


def alongside(run_port, run_ref):
    """`run_port()` on a thread (it waits on its spawned ranks) while
    `run_ref()` runs on this one; returns (port's result, ref's)."""
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(run_port)
        ref = run_ref()
        return port.result(), ref


def _np(result):
    return tuple(np.asarray(t.cpu()) for t in result)


def _problem(arrays):
    return port_match.from_numpy(**arrays, device="cpu")


def _tasks(arrays):
    return port_dru.from_numpy(**arrays, device="cpu")


def _divisors(arrays):
    return [torch.as_tensor(np.asarray(arrays[k], dtype=np.float32))
            for k in ("md", "cd", "gd")]


def parallel_cases(mesh, inputs):
    """The cases of tests/test_parallel.py (and `pool_sharded_coarse`) on
    this rank's shard; each value is the port's result as numpy, beside
    the single-process solve where the case compares with one."""
    torch.set_num_threads(1)
    out = {}
    batch = _problem(inputs["pool_batch"])
    out["pool_match"] = (_np(port_mesh.pool_sharded_match(
        mesh, port_mesh.shard_pools(mesh, batch))),
        _np(port_match.greedy_match_pools(batch)))
    out["pool_knobs"] = _np(port_mesh.pool_sharded_match(
        mesh, port_mesh.shard_pools(mesh, batch), chunk=64, rounds=3,
        passes=3, backend="bucketed"))
    dru = inputs["pool_dru"]
    out["pool_dru"] = (
        _np(port_mesh.pool_sharded_dru(mesh, _tasks(dru["tasks"]),
                                       *_divisors(dru))),
        _np(port_dru.dru_rank_pools(_tasks(dru["tasks"]),
                                    *_divisors(dru))))
    node = _problem(inputs["node_greedy"])
    out["node_greedy"] = (_np(port_mesh.node_sharded_greedy_match(mesh,
                                                                  node)),
                          _np(port_match.greedy_match(node)))
    chunked = _problem(inputs["node_chunked"])
    out["node_chunked"] = _np(port_mesh.node_sharded_chunked_match(
        mesh, chunked, chunk=64, rounds=3, kc=16, passes=3))
    task = inputs["task_dru"]
    out["task_dru"] = (
        _np(port_mesh.task_sharded_dru(mesh, _tasks(task["tasks"]),
                                       *_divisors(task))),
        _np(port_dru.dru_rank(_tasks(task["tasks"]), *_divisors(task))))
    padded = _problem(inputs["padded"])
    out["padded"] = (_np(port_mesh.pool_sharded_match(
        mesh, port_mesh.shard_pools(mesh, padded))),
        _np(port_match.greedy_match_pools(_problem(inputs["padded_real"]))))
    unmasked = _problem(inputs["unmasked"])
    out["unmasked"] = _np(port_mesh.pool_sharded_match(
        mesh, port_mesh.shard_pools(mesh, unmasked), chunk=64, rounds=3,
        passes=2, kc=8))
    coarse = _problem(inputs["coarse"])
    out["coarse"] = (_np(port_mesh.pool_sharded_coarse(
        mesh, port_mesh.shard_pools(mesh, coarse), chunk=64, rounds=2,
        passes=4)),
        _np(port_match.chunked_match_pools(coarse, chunk=64, rounds=2,
                                           passes=4, kc=1,
                                           use_approx=False)))
    # the chunked node-axis solve on a one-rank slice of the same problem
    # equals chunked_match: checked in the D = 1 case of the test
    out["mesh"] = (mesh.rank, mesh.size, mesh.backend, str(mesh.device))
    return out


def chunked_one_rank(mesh, arrays, knobs):
    """`node_sharded_chunked_match` on a mesh of one beside `chunked_match`
    at the same knobs."""
    torch.set_num_threads(1)
    problem = _problem(arrays)
    return (_np(port_mesh.node_sharded_chunked_match(mesh, problem,
                                                     **knobs)),
            _np(port_match.chunked_match(problem, **knobs)))


# ---------------------------------------------------- scheduler wiring


def multipool_rig(n_pools, jobs_per_pool, users=3, hosts_per_pool=3,
                  match=None):
    """tests/test_multipool.py's `setup_multi` + `submit_work` on the port,
    with the uuids fixed so that both packages' placements compare."""
    store = JobStore(clock=lambda: 1_000_000)
    hosts = []
    for p in range(n_pools):
        store.set_pool(Pool(name=f"pool{p}"))
        for i in range(hosts_per_pool):
            hosts.append(MockHost(node_id=f"p{p}h{i}", hostname=f"p{p}h{i}",
                                  mem=4000, cpus=8, pool=f"pool{p}"))
    cluster = MockCluster("mock", hosts, clock=lambda: 1_000_000)
    scheduler = Scheduler(store, [cluster],
                          SchedulerConfig(match=match or MatchConfig()),
                          device="cpu")
    store.submit_jobs([
        Job(uuid=f"job-{p}-{i}", user=f"u{i % users}", pool=f"pool{p}",
            priority=50, max_retries=1, command="true",
            resources=Resources(mem=500, cpus=1))
        for p in range(n_pools) for i in range(jobs_per_pool)])
    return scheduler


def placements(outcomes):
    return sorted((job.uuid, offer.hostname)
                  for outcome in outcomes.values()
                  for job, offer in outcome.matched)


def _hier_problem(arrays):
    demands, avail, totals = (arrays[k] for k in ("demands", "avail",
                                                  "totals"))
    return port_match.from_numpy(demands, np.ones(len(demands), bool),
                                 avail, totals, np.ones(len(avail), bool),
                                 device="cpu")


HIER_STATS = ("blocks", "block_pad", "superblocks", "super_shape",
              "coarse_shape", "fine_shape", "placed")


def _hier_run(arrays, params, mesh, observatory):
    result, stats = hierarchical_match(_hier_problem(arrays),
                                       params=HierParams(**params),
                                       mesh=mesh, observatory=observatory)
    return (np.asarray(result.assignment),
            {k: stats.get(k) for k in HIER_STATS})


def scheduler_cases(mesh, inputs):
    """The scheduler-level mesh cases in `inputs`, each beside the port's
    own run without a mesh: with `batched`, tests/test_multipool.py:79 (8
    pools) and tests/test_pipeline.py:482 (3, 5 and 8 pools); with
    `hier`, the mesh case of tests/test_hierarchical.py:193 (3, 5 and 8
    blocks); with `superblocks`, tests/test_superblocks.py:52 (5, 6 and 7
    superblocks)."""
    torch.set_num_threads(1)
    out = {"hier_mesh": _hier_mesh_reads(mesh)}
    if inputs.get("batched"):
        for key, shapes in (("multipool", ((8, 3),)),
                            ("pads", ((3, 4), (5, 4), (8, 4)))):
            out[key] = []
            for n_pools, per_pool in shapes:
                users = 2 if key == "pads" else 3
                runs = [placements(multipool_rig(n_pools, per_pool, users)
                                   .match_cycle_all_pools(mesh=m))
                        for m in (mesh, None)]
                out[key].append((n_pools, *runs))
    for key in ("hier", "superblocks"):
        if key not in inputs:
            continue
        observatory = CompileObservatory()
        out[key] = [(_hier_run(arrays, params, mesh, observatory),
                     _hier_run(arrays, params, None, None))
                    for arrays, params in inputs[key]]
        stats = observatory.stats()
        out[key + "_programs"] = {name: stats[name]["programs"]
                                  for name in stats}
    return out


def _hier_mesh_reads(mesh):
    """What the scheduler's accessor returns on this rank, with
    `hierarchical_use_mesh` gating it."""
    from cook_tpu_torch.scheduler import matcher

    got = matcher.hier_mesh()
    return (got is mesh, MatchConfig().hierarchical_use_mesh)


# ------------------------------------------------- failures and imports


def fail_on_rank(mesh, bad_rank):
    """Rank `bad_rank` raises before the mesh's first collective."""
    if mesh.rank == bad_rank:
        raise ValueError(f"rank {mesh.rank} gives up")
    return port_mesh.all_gather(mesh, torch.ones(1)).tolist()


def hang_on_rank(mesh, bad_rank):
    """Rank `bad_rank` never returns; the others do."""
    if mesh.rank == bad_rank:
        time.sleep(3600)
    return mesh.rank


def loaded_modules(mesh):
    """The modules this rank has loaded that the port must never load."""
    port_mesh.all_gather(mesh, torch.ones(1))
    return sorted(m for m in sys.modules
                  if m.split(".")[0].startswith("jax")
                  or m.split(".")[0] in ("cook_tpu", "conftest"))
