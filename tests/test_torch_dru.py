"""`cook_tpu_torch.ops.dru.dru_rank` against `cook_tpu.ops.dru.dru_rank` on
the cases of tests/test_ops_parity.py:30, plus ties, gpu_mode and the
backfill term.  `order` and `rank` must be identical.  `dru` is a float32
cumulative sum divided by a share: on inputs whose partial sums are exact
in float32 (the simulator's integer and half demands) it must agree to
rtol 1e-6; on the parity test's continuous random demands the reference
sums in XLA's blocked order and the port sequentially, so those agree to
the rtol 1e-4 the reference's own parity test uses."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops import dru as ref
from cook_tpu.ops.common import BIG, pad_to
from cook_tpu_torch.ops import dru as port
from tests.test_ops_parity import random_dru_problem

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def _padded(user, mem, cpus, gpus, order_key, pad_t=256):
    t = len(user)
    return (pad_to(user.astype(np.int32), pad_t), pad_to(mem, pad_t),
            pad_to(cpus, pad_t), pad_to(gpus, pad_t),
            pad_to(order_key, pad_t, fill=BIG),
            pad_to(np.ones(t, dtype=bool), pad_t, fill=False))


def _both(arrays, divs, *, gpu_mode, backfill=None, weight=None):
    want = ref.dru_rank(
        ref.DruTasks(*map(jnp.asarray, arrays)), *map(jnp.asarray, divs),
        gpu_mode=gpu_mode,
        backfill=None if backfill is None else jnp.asarray(backfill),
        backfill_weight=None if weight is None else jnp.float32(weight))
    got = port.dru_rank(
        port.from_numpy(*arrays, device="cpu"),
        *[torch.as_tensor(np.float32(d)) for d in divs],
        gpu_mode=gpu_mode,
        backfill=None if backfill is None else torch.as_tensor(backfill),
        backfill_weight=weight)
    return want, got


def _assert_parity(want, got, rtol):
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    np.testing.assert_array_equal(got.rank.numpy(), np.asarray(want.rank))
    assert got.order.dtype == got.rank.dtype == torch.int32
    np.testing.assert_allclose(got.dru.numpy(), np.asarray(want.dru),
                               rtol=rtol)


def _exact_grid(mem, cpus):
    """Demands on an exact float32 grid: whole MB and eighth cpus."""
    return np.round(mem), np.round(cpus * 8) / 8


@pytest.mark.parametrize("gpu_mode", [False, True])
@pytest.mark.parametrize("seed", range(5))
def test_dru_rank_matches_reference_exact_sums(seed, gpu_mode):
    rng = np.random.default_rng(seed)
    user, mem, cpus, gpus, order_key, *divs = random_dru_problem(rng)
    mem, cpus = _exact_grid(mem, cpus)
    want, got = _both(_padded(user, mem, cpus, gpus, order_key), divs,
                      gpu_mode=gpu_mode)
    _assert_parity(want, got, rtol=1e-6)


@pytest.mark.parametrize("gpu_mode", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_dru_rank_matches_reference_random_demands(seed, gpu_mode):
    rng = np.random.default_rng(seed)
    user, mem, cpus, gpus, order_key, *divs = random_dru_problem(rng)
    want, got = _both(_padded(user, mem, cpus, gpus, order_key), divs,
                      gpu_mode=gpu_mode)
    _assert_parity(want, got, rtol=1e-4)


@pytest.mark.parametrize("seed", range(3))
def test_dru_rank_ties(seed):
    """Every task the same size and every user the same share: DRU ties
    across users everywhere, broken by the per-user order key."""
    rng = np.random.default_rng(50 + seed)
    t, u = 180, 9
    user = rng.integers(0, u, t)
    ones = np.ones(t)
    order_key = rng.permutation(t).astype(np.float64)
    divs = (np.full(u, 100.0), np.full(u, 4.0), np.full(u, 2.0))
    for gpu_mode in (False, True):
        want, got = _both(_padded(user, 10 * ones, ones, ones, order_key),
                          divs, gpu_mode=gpu_mode)
        _assert_parity(want, got, rtol=1e-6)


@pytest.mark.parametrize("weight", [0.0, 0.05, 1.0])
def test_dru_rank_backfill_term(weight):
    rng = np.random.default_rng(70)
    user, mem, cpus, gpus, order_key, *divs = random_dru_problem(rng)
    mem, cpus = _exact_grid(mem, cpus)
    backfill = pad_to(rng.uniform(-0.2, 1.2, len(user)).astype(np.float32),
                      256, fill=1.0)
    want, got = _both(_padded(user, mem, cpus, gpus, order_key), divs,
                      gpu_mode=False, backfill=backfill, weight=weight)
    _assert_parity(want, got, rtol=1e-6)
