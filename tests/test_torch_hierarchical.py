"""`cook_tpu_torch.ops.hierarchical` against `cook_tpu.ops.hierarchical`
(mesh=None) on the CPU: identical assignments, `new_avail` and solve
stats under every coarse x fine backend pair, with and without a
constraint mask, and with heavy slot spill.  The reference's Pallas
kernels run in interpret mode (tests/test_torch_hierarchical_parts.py
holds the pieces).

Inputs are exact-sum: demands as in tests/test_device_state.py:598, free
capacity in whole multiples of 512 MB and of 0.5 cpu.  The block
aggregates are float32 sums, which XLA and torch add in different orders;
with these values every partial sum is exact, so the decisions can be
compared for identity (the uniform fractions of test_hierarchical.py's
`dense_problem` would make them inexact)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops import hierarchical as ref
from cook_tpu.ops.match import MatchProblem as RefProblem
from cook_tpu_torch.ops import hierarchical as port
from cook_tpu_torch.ops.match import from_numpy

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

STATS = ("blocks", "block_pad", "nodes_per_block", "jobs_per_block",
         "spilled", "placed", "refine_rounds", "refine_placed",
         "fine_shape", "coarse_shape", "backend", "coarse_backend")


def exact_problem(j, n, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    demands = np.stack([rng.choice([512, 1024, 2048], j),
                        rng.choice([1, 2, 4], j),
                        np.zeros(j), np.zeros(j)], axis=-1).astype(np.float32)
    totals = np.stack([np.full(n, 65536.0), np.full(n, 32.0)],
                      axis=-1).astype(np.float32)
    free = np.stack([rng.integers(8, 129, n) * 512.0,
                     rng.integers(4, 65, n) * 0.5], axis=-1)
    avail = np.concatenate([free, np.zeros((n, 2))], axis=-1) \
        .astype(np.float32)
    feasible = rng.uniform(size=(j, n)) < 0.7 if masked else None
    return demands, avail, totals, feasible


def solve_both(demands, avail, totals, feasible=None, job_valid=None,
               **params):
    j, n = demands.shape[0], avail.shape[0]
    job_valid = np.ones(j, bool) if job_valid is None else job_valid
    want, want_stats = ref.hierarchical_match(RefProblem(
        demands=jnp.asarray(demands), job_valid=jnp.asarray(job_valid),
        avail=jnp.asarray(avail), totals=jnp.asarray(totals),
        node_valid=jnp.ones(n, bool),
        feasible=None if feasible is None else jnp.asarray(feasible)),
        params=ref.HierParams(**params), mesh=None)
    got, got_stats = port.hierarchical_match(from_numpy(
        demands, job_valid, avail, totals, np.ones(n, bool), feasible,
        device="cpu"), params=port.HierParams(**params))
    assert got.assignment.dtype == torch.int32
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.new_avail.numpy(),
                                  np.asarray(want.new_avail))
    for key in STATS:
        assert got_stats[key] == want_stats[key], key
    assert got_stats["block_stats"] == want_stats["block_stats"]
    assert set(got_stats) == set(want_stats)
    return got_stats


# fewer unrolled passes than the defaults keep the reference's compile
# short; the scheme is the same
FAST = dict(nodes_per_block=32, chunk=64, kc=16, coarse_passes=4,
            fine_passes=6)


@pytest.mark.parametrize("masked", [False, True], ids=["free", "masked"])
@pytest.mark.parametrize("fine", ["xla", "pallas"])
@pytest.mark.parametrize("coarse", ["xla", "pallas"])
def test_hierarchical_match_matches_reference(coarse, fine, masked):
    """200 jobs (padded to 256) x 150 nodes: 5 real blocks of 32 padded
    to the 8-block bucket, the node axis to 160."""
    demands, avail, totals, feasible = exact_problem(200, 150, seed=1,
                                                     masked=masked)
    stats = solve_both(demands, avail, totals, feasible,
                       coarse_backend=coarse, fine_backend=fine, **FAST)
    assert stats["blocks"] == 5 and stats["block_pad"] == 8
    assert stats["placed"] > 0


def test_spilled_jobs_refine_like_the_reference():
    """test_hierarchical.py:172: 16-slot blocks on a 256-job problem force
    heavy spill, which the refinement rounds then place."""
    demands, avail, totals, _ = exact_problem(256, 128, seed=7)
    base = dict(nodes_per_block=32, jobs_per_block=16, chunk=16, kc=16)
    stats0 = solve_both(demands, avail, totals, refine_rounds=0, **base)
    assert stats0["spilled"] > 0
    stats2 = solve_both(demands, avail, totals, refine_rounds=4, **base)
    assert stats2["placed"] > stats0["placed"]
    assert stats2["refine_placed"] > 0
