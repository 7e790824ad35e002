"""`cook_tpu_torch.ops.best_node` (its plain PyTorch version, which the
wrapper runs for CPU tensors) against the reference Pallas kernel run in
interpret mode, on the cases of tests/test_pallas_match.py plus prime
node counts.  The fitness arithmetic is the same sequence of float32
operations on both sides, so scores must agree to 0 ulp.  The CUDA kernel
itself is held against the same plain version on the card by
chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops.pallas_match import best_node as ref_best_node
from cook_tpu_torch.ops import best_node as bn
from cook_tpu_torch.ops.common import BIG

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def _problem(rng, k, n, r=3):
    demands = np.stack([rng.uniform(100, 4000, k), rng.uniform(0.5, 8, k)]
                       + [np.zeros(k)] * (r - 2), axis=-1).astype(np.float32)
    totals = np.stack([rng.uniform(4000, 64000, n), rng.uniform(8, 64, n)],
                      axis=-1).astype(np.float32)
    avail = np.concatenate(
        [totals * rng.uniform(0.1, 1.0, (n, 1)).astype(np.float32),
         np.zeros((n, r - 2), np.float32)], axis=-1)
    return demands, avail, totals


def _both(demands, avail, totals, valid, mask=None):
    want_v, want_i = ref_best_node(
        jnp.asarray(demands), jnp.asarray(avail), jnp.asarray(totals),
        jnp.asarray(valid), None if mask is None else jnp.asarray(mask),
        block_jobs=8, block_nodes=128, interpret=True)
    got_v, got_i = bn.best_node(
        torch.as_tensor(demands), torch.as_tensor(avail),
        torch.as_tensor(totals), torch.as_tensor(valid),
        None if mask is None else torch.as_tensor(mask))
    return (np.asarray(want_v), np.asarray(want_i),
            got_v.numpy(), got_i.numpy())


def _assert_identical(want_v, want_i, got_v, got_i):
    np.testing.assert_array_equal(got_i, want_i)
    # 0 ulp: compare the float32 bit patterns
    np.testing.assert_array_equal(got_v.view(np.int32),
                                  want_v.view(np.int32))


@pytest.mark.parametrize("k,n", [(16, 256), (13, 251), (7, 127)])
@pytest.mark.parametrize("seed", range(3))
def test_best_node_matches_reference(seed, k, n):
    """test_pallas_match.py:32 (16 x 256 with ~20% invalid nodes), and
    prime job/node counts that leave ragged tiles on the reference."""
    rng = np.random.default_rng(seed)
    demands, avail, totals = _problem(rng, k, n)
    valid = rng.uniform(size=n) > 0.2
    want_v, want_i, got_v, got_i = _both(demands, avail, totals, valid)
    assert (want_i >= 0).any()
    _assert_identical(want_v, want_i, got_v, got_i)


def test_best_node_infeasible_everything():
    """test_pallas_match.py:59: no node fits -> (-BIG, -1) everywhere."""
    k, n = 8, 128
    demands = np.full((k, 3), 1e9, dtype=np.float32)
    totals = np.ones((n, 2), dtype=np.float32)
    avail = np.concatenate([totals, np.zeros((n, 1), np.float32)], axis=-1)
    want_v, want_i, got_v, got_i = _both(demands, avail, totals,
                                         np.ones(n, bool))
    assert (got_i == -1).all()
    np.testing.assert_array_equal(got_v, np.float32(-BIG))
    _assert_identical(want_v, want_i, got_v, got_i)


@pytest.mark.parametrize("k,n", [(16, 256), (17, 263)])
@pytest.mark.parametrize("seed", range(3))
def test_best_node_constraint_mask(seed, k, n):
    """test_pallas_match.py:72: the masked variant honors the [K, N] mask
    (about half set), here with R = 4 resource columns as in the
    simulator."""
    rng = np.random.default_rng(40 + seed)
    demands, avail, totals = _problem(rng, k, n, r=4)
    mask = rng.uniform(size=(k, n)) > 0.5
    want_v, want_i, got_v, got_i = _both(demands, avail, totals,
                                         np.ones(n, bool), mask)
    _assert_identical(want_v, want_i, got_v, got_i)
    placed = got_i >= 0
    assert mask[np.flatnonzero(placed), got_i[placed]].all()


def test_best_node_ties_pick_the_first_index():
    """Identical nodes (bench.make_problem gives every node the same
    totals): the first feasible index wins, as in the reference."""
    k, n = 4, 200
    demands = np.tile(np.float32([512, 1, 0]), (k, 1))
    totals = np.tile(np.float32([65536, 32]), (n, 1))
    avail = np.concatenate([totals, np.zeros((n, 1), np.float32)], axis=-1)
    valid = np.ones(n, bool)
    valid[:3] = False
    want_v, want_i, got_v, got_i = _both(demands, avail, totals, valid)
    assert (got_i == 3).all()
    _assert_identical(want_v, want_i, got_v, got_i)


@pytest.mark.parametrize("kind", ["bench", "mixed", "fleet",
                                  "placed", "infeasible"])
def test_best_node_on_the_chip_smoke_cases(kind):
    """The input kinds chip_smoke.py holds the CUDA kernel to (R = 4, gpu
    and disk columns, masks, a fleet of identical hosts), at a small size:
    the plain version agrees with the reference kernel here, so the card's
    kernel-vs-plain check there is a check against the reference too."""
    from chip_smoke import make_inputs

    args = [None if a is None else a.numpy()
            for a in make_inputs(16, 509, kind, "cpu", seed=7)]
    want_v, want_i, got_v, got_i = _both(*args)
    _assert_identical(want_v, want_i, got_v, got_i)
    if kind == "fleet":
        assert (got_i == 0).all()
    assert (got_i >= 0).any() == (kind != "infeasible")


def test_best_node_rejects_what_the_kernel_does_not_take():
    d = torch.zeros(4, 3)
    a = torch.zeros(8, 3)
    t = torch.ones(8, 2)
    v = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        bn.best_node(d.double(), a, t, v)
    with pytest.raises(TypeError):
        bn.best_node(d, a, t, v.int())
    with pytest.raises(ValueError, match="shapes"):
        bn.best_node(d, a[:, :2], t, v)
    with pytest.raises(ValueError, match="mask"):
        bn.best_node(d, a, t, v, torch.ones(4, 7, dtype=torch.bool))
    with pytest.raises(ValueError, match="resource columns"):
        bn.best_node(torch.zeros(4, 9), torch.zeros(8, 9), t, v)
    with pytest.raises(ValueError, match="contiguous"):
        bn.best_node(torch.zeros(3, 4).t(), a, t, v)
    before = bn.launches
    bn.best_node(d, a, t, v)  # CPU tensors: the plain version, no launch
    assert bn.launches == before
