"""`cook_tpu_torch.ops.match` against `cook_tpu.ops.match` on the shapes of
tests/test_ops_parity.py:93-224 and test_pallas_match.py:101: identical
`assignment` and `new_avail` for the exact greedy and for every chunked
candidate backend (xla with `use_approx` both ways — on a CPU the
reference's `approx_max_k` equals `top_k` — bucketed, and pallas, whose
reference kernel runs in interpret mode)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops import match as ref
from cook_tpu_torch.ops import match as port
from tests.test_ops_parity import random_match_problem

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def _solve_both(fn_name, demands, avail, totals, feasible, job_valid=None,
                node_valid=None, **kwargs):
    j, n = demands.shape[0], avail.shape[0]
    job_valid = np.ones(j, bool) if job_valid is None else job_valid
    node_valid = np.ones(n, bool) if node_valid is None else node_valid
    want = getattr(ref, fn_name)(ref.MatchProblem(
        demands=jnp.asarray(demands), job_valid=jnp.asarray(job_valid),
        avail=jnp.asarray(avail), totals=jnp.asarray(totals),
        node_valid=jnp.asarray(node_valid),
        feasible=None if feasible is None else jnp.asarray(feasible)),
        **kwargs)
    got = getattr(port, fn_name)(port.from_numpy(
        demands, job_valid, avail, totals, node_valid, feasible,
        device="cpu"), **kwargs)
    assert got.assignment.dtype == torch.int32
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))
    np.testing.assert_array_equal(got.new_avail.numpy(),
                                  np.asarray(want.new_avail))
    return got


def _skewed(rng, j=256, n=64):
    base = rng.choice([16, 64, 256, 1024, 4096], j,
                      p=[0.4, 0.3, 0.15, 0.1, 0.05]).astype(float)
    demands = np.stack([base, np.maximum(base / 256, 0.25), np.zeros(j)],
                       axis=-1)
    totals = np.stack([np.full(n, 8192.0), np.full(n, 32.0)], axis=-1)
    avail = np.concatenate([totals * rng.uniform(0.2, 1.0, (n, 1)),
                            np.zeros((n, 1))], axis=-1)
    return demands, avail, totals


def _few_feasible(rng):
    demands, avail, totals, _ = random_match_problem(rng, j=256, n=64)
    feasible = rng.uniform(size=(256, 64)) < 0.05
    feasible[np.arange(256), rng.integers(0, 64, 256)] = True
    return demands, avail, totals, feasible


@pytest.mark.parametrize("seed", range(3))
def test_greedy_match_matches_reference(seed):
    rng = np.random.default_rng(100 + seed)
    _solve_both("greedy_match", *random_match_problem(rng))


CHUNKED = {
    "xla": dict(chunk=64),
    "xla-exact-topk": dict(chunk=64, use_approx=False),
    "bucketed": dict(chunk=64, bucketed=True, passes=3),
    "pallas": dict(chunk=64, rounds=2, passes=12, use_pallas=True),
}


@pytest.mark.parametrize("backend", sorted(CHUNKED))
@pytest.mark.parametrize("seed", range(2))
def test_chunked_match_matches_reference(seed, backend):
    rng = np.random.default_rng(200 + seed)
    got = _solve_both("chunked_match",
                      *random_match_problem(rng, j=256, n=64),
                      **CHUNKED[backend])
    assert (got.assignment >= 0).sum() > 100


@pytest.mark.parametrize("backend", sorted(CHUNKED))
def test_chunked_match_skewed_demands_unconstrained(backend):
    rng = np.random.default_rng(400)
    _solve_both("chunked_match", *_skewed(rng), None, **CHUNKED[backend])


@pytest.mark.parametrize("backend", ["xla", "bucketed", "pallas"])
def test_chunked_match_few_feasible_nodes(backend):
    rng = np.random.default_rng(500)
    kwargs = dict(CHUNKED[backend])
    if backend == "bucketed":
        kwargs["passes"] = 6  # test_ops_parity.py:203's setting
    got = _solve_both("chunked_match", *_few_feasible(rng), **kwargs)
    a = got.assignment.numpy()
    placed = a >= 0
    feasible = _few_feasible(np.random.default_rng(500))[3]
    assert feasible[np.flatnonzero(placed), a[placed]].all()


def test_pallas_backend_parity_at_the_scheduler_test_shape():
    """test_pallas_match.py:101's problem (256 jobs x 128 nodes, 90% mask)
    with the scheduler-config knobs of its :156 (chunk 16, 2 rounds, 12
    passes)."""
    rng = np.random.default_rng(600)
    j, n = 256, 128
    demands = np.stack([rng.uniform(10, 500, j), rng.uniform(0.5, 8, j),
                        np.zeros(j)], axis=-1).astype(np.float32)
    totals = np.stack([rng.uniform(1000, 8000, n), rng.uniform(8, 64, n)],
                      axis=-1).astype(np.float32)
    avail = np.concatenate([
        totals * rng.uniform(0.3, 1.0, (n, 1)).astype(np.float32),
        np.zeros((n, 1), np.float32)], axis=-1)
    feasible = rng.uniform(size=(j, n)) > 0.1
    _solve_both("chunked_match", demands, avail, totals, feasible,
                chunk=16, rounds=2, passes=12, use_pallas=True)


@pytest.mark.parametrize("fn_name,kwargs", [
    ("greedy_match", {}),
    ("chunked_match", dict(chunk=8)),
    ("chunked_match", dict(chunk=8, rounds=2, passes=4, use_pallas=True)),
])
def test_match_respects_validity_masks(fn_name, kwargs):
    """test_ops_parity.py:224: invalid jobs stay unplaced, invalid nodes
    untouched."""
    j, n = 8, 4
    demands = np.tile([100.0, 1.0, 0.0], (j, 1))
    avail = np.tile([1000.0, 10.0, 0.0], (n, 1))
    got = _solve_both(fn_name, demands, avail, avail[:, :2].copy(), None,
                      job_valid=np.array([True] * 4 + [False] * 4),
                      node_valid=np.array([True, True, False, False]),
                      **kwargs)
    a = got.assignment.numpy()
    assert (a[4:] == -1).all() and set(a[:4]) <= {0, 1}


def test_chunked_match_rejects_bad_knobs():
    p = port.from_numpy(np.ones((8, 3)), np.ones(8, bool), np.ones((4, 3)),
                        np.ones((4, 2)), np.ones(4, bool), device="cpu")
    with pytest.raises(ValueError, match="multiple of chunk"):
        port.chunked_match(p, chunk=3)
    with pytest.raises(ValueError, match="one candidate backend"):
        port.chunked_match(p, chunk=8, use_pallas=True, bucketed=True)
    with pytest.raises(ValueError, match="passes >= 2"):
        port.chunked_match(p, chunk=8, bucketed=True, passes=1)
    with pytest.raises(ValueError, match="unknown match backend"):
        port.backend_flags("tpu")
