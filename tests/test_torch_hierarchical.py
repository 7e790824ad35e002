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
               gangs=(None, None), **params):
    j, n = demands.shape[0], avail.shape[0]
    job_valid = np.ones(j, bool) if job_valid is None else job_valid
    gang_id, gang_need = gangs
    want, want_stats = ref.hierarchical_match(RefProblem(
        demands=jnp.asarray(demands), job_valid=jnp.asarray(job_valid),
        avail=jnp.asarray(avail), totals=jnp.asarray(totals),
        node_valid=jnp.ones(n, bool),
        feasible=None if feasible is None else jnp.asarray(feasible)),
        params=ref.HierParams(**params), mesh=None, gang_id=gang_id,
        gang_need=gang_need)
    got, got_stats = port.hierarchical_match(from_numpy(
        demands, job_valid, avail, totals, np.ones(n, bool), feasible,
        device="cpu"), params=port.HierParams(**params), gang_id=gang_id,
        gang_need=gang_need)
    assert got.assignment.dtype == torch.int32
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.new_avail.numpy(),
                                  np.asarray(want.new_avail))
    for key in STATS:
        assert got_stats[key] == want_stats[key], key
    assert got_stats["block_stats"] == want_stats["block_stats"]
    assert got_stats.get("gangs") == want_stats.get("gangs")
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


@pytest.fixture
def ref_release_synced(monkeypatch):
    """The reference's `enforce_gangs` hands its host assignment buffer to
    JAX, dispatches `release_assignments` on it and then overwrites the
    buffer in place without waiting; on the CPU JAX may alias the numpy
    buffer, so the release sometimes reads the overwritten assignment and
    its results vary run to run.  Waiting for the release, as intended,
    makes the reference deterministic; the port copies the buffer."""
    import jax

    release = ref.release_assignments
    monkeypatch.setattr(ref, "release_assignments",
                        lambda *a: jax.block_until_ready(release(*a)))


def gang_rows(j, seed, n_gangs=24, sizes=(2, 3, 4, 6, 8)):
    """(gang_id, gang_need) [J] int32: `n_gangs` gangs on random rows,
    sizes cycling `sizes`; -1 / 0 elsewhere."""
    rng = np.random.default_rng(seed)
    gang_id = np.full(j, -1, dtype=np.int32)
    gang_need = np.zeros(j, dtype=np.int32)
    rows = rng.permutation(j)
    at = 0
    for g in range(n_gangs):
        k = sizes[g % len(sizes)]
        gang_id[rows[at:at + k]] = g
        gang_need[rows[at:at + k]] = k
        at += k
    return gang_id, gang_need


@pytest.mark.parametrize("masked", [False, True], ids=["free", "masked"])
@pytest.mark.parametrize("fine", ["xla", "pallas"])
@pytest.mark.parametrize("coarse", ["xla", "pallas"])
def test_hierarchical_gangs_match_reference(coarse, fine, masked,
                                            ref_release_synced):
    """The gang path: leaders route with the gang's summed demand, gated
    member-wise and on the block's host count, members ride their leader's
    block, every fine pass and refine round strips what is not whole in
    one block and releases it.  Assignment, new_avail and stats["gangs"]
    identical; a `pallas` coarse backend runs `xla` with gangs, as in the
    reference."""
    demands, avail, totals, feasible = exact_problem(200, 150, seed=4,
                                                     masked=masked)
    stats = solve_both(demands, avail, totals, feasible,
                       gangs=gang_rows(200, seed=4), coarse_backend=coarse,
                       fine_backend=fine, **FAST)
    assert stats["coarse_backend"] == "xla"
    gangs = stats["gangs"]
    # (the single-candidate fine passes stack a block's members on its
    # best host, which the filter strips: there the finalize chokepoint's
    # host-side repair places the gangs, in both packages)
    assert gangs["considered"] == 24
    assert gangs["placed"] > 0 or gangs["stripped_rows"] > 0


def test_hierarchical_gangs_strip_and_refine_like_the_reference(
        ref_release_synced):
    """Tight blocks of 8 nodes and gangs up to 8 wide: gangs strip, their
    demand returns, and the refine rounds re-route them, as in the
    reference; no gang ends partly placed or split over blocks."""
    demands, avail, totals, _ = exact_problem(128, 64, seed=9)
    gang_id, gang_need = gang_rows(128, seed=9, n_gangs=16,
                                   sizes=(8, 6, 4, 2))
    stats = solve_both(demands, avail, totals, gangs=(gang_id, gang_need),
                       nodes_per_block=8, chunk=16, kc=8, refine_rounds=3,
                       coarse_passes=4, fine_passes=6, fine_backend="pallas")
    got, _ = port.hierarchical_match(from_numpy(
        demands, np.ones(128, bool), avail, totals, np.ones(64, bool),
        device="cpu"), params=port.HierParams(
        nodes_per_block=8, chunk=16, kc=8, refine_rounds=3,
        coarse_passes=4, fine_passes=6, fine_backend="pallas"),
        gang_id=gang_id, gang_need=gang_need)
    asg = got.assignment.numpy()
    for g in range(16):
        rows = gang_id == g
        placed = asg[rows] >= 0
        assert placed.all() or not placed.any()
        if placed.all():
            assert np.unique(asg[rows]).size == rows.sum()
            assert np.unique(asg[rows] // 8).size == 1
    assert stats["gangs"]["stripped_rows"] > 0


def test_gang_rows_shorter_than_the_padded_problem():
    """The matcher passes one gang row per considerable job, fewer than
    the padded problem's rows: the padding rows are not gang rows."""
    demands, avail, totals, _ = exact_problem(64, 64, seed=2)
    gang_id, gang_need = gang_rows(40, seed=2, n_gangs=5, sizes=(2, 3))
    full = (np.concatenate([gang_id, np.full(24, -1, np.int32)]),
            np.concatenate([gang_need, np.zeros(24, np.int32)]))
    problem = from_numpy(demands, np.arange(64) < 40, avail, totals,
                         np.ones(64, bool), device="cpu")
    params = port.HierParams(**FAST)
    short, short_stats = port.hierarchical_match(
        problem, params=params, gang_id=gang_id, gang_need=gang_need)
    padded, padded_stats = port.hierarchical_match(
        problem, params=params, gang_id=full[0], gang_need=full[1])
    assert torch.equal(short.assignment, padded.assignment)
    assert short_stats["gangs"] == padded_stats["gangs"]
    assert short_stats["gangs"]["considered"] == 5
