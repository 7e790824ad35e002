"""`python -m cook_tpu_torch.examples.multihost_dryrun`: two processes on
`torch.distributed` (gloo, the CPU), one global mesh, the pool-sharded
solve across it.  Its assignments equal those of the reference recipe
(`examples/multihost_dryrun.py`, run by `tests/test_multihost.py`): the
reference's `pool_sharded_match` on the same 8 seeded pools over an
8-device mesh (conftest's virtual CPU devices)."""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from cook_tpu.ops.match import MatchProblem as RefProblem
from cook_tpu.parallel import mesh as ref_mesh
from cook_tpu_torch.examples import multihost_dryrun as dryrun

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reference_recipe(n_pools=8):
    demands, avail, totals = dryrun.make_problems(n_pools)
    j, n = demands.shape[1], avail.shape[1]
    problems = RefProblem(
        demands=jnp.asarray(demands),
        job_valid=jnp.ones((n_pools, j), bool),
        avail=jnp.asarray(avail), totals=jnp.asarray(totals),
        node_valid=jnp.ones((n_pools, n), bool),
        feasible=jnp.ones((n_pools, j, n), bool))
    mesh = ref_mesh.make_mesh(n_pools)
    return np.asarray(ref_mesh.pool_sharded_match(mesh, problems)
                      .assignment)


def test_two_gloo_processes_solve_the_reference_recipe(tmp_path):
    out = tmp_path / "assignment.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run(
        [sys.executable, "-m", "cook_tpu_torch.examples.multihost_dryrun",
         "--workers", "2", "--device", "cpu", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "multihost dryrun OK" in proc.stdout
    # both processes saw the 2-rank mesh and placed their shards
    assert proc.stdout.count(
        "mesh 2 devices across 2 processes (gloo on cpu)") == 2
    got = json.loads(out.read_text())
    want = reference_recipe()
    assert np.array_equal(np.asarray(got["assignment"]), want)
    assert got["placed"] == int((want >= 0).sum()) > 0
    assert got["backend"] == "gloo"


def test_the_recipe_is_the_references():
    """The seeded problem is the reference worker's, pool for pool."""
    rng = np.random.default_rng(0)
    demands = rng.uniform(1, 100, (8, 32, 3)).astype(np.float32)
    demands[:, :, 2] = 0.0
    totals = rng.uniform(500, 1000, (8, 16, 2)).astype(np.float32)
    got = dryrun.make_problems(8)
    assert np.array_equal(got[0], demands)
    assert np.array_equal(got[2], totals)
    assert np.array_equal(got[1][..., :2], totals)
    assert not got[1][..., 2].any()
    assert dryrun.POOLS_PER_PROCESS * 2 == 8
