"""`cook_tpu_torch.ops.common` against `cook_tpu.ops.common` on the same
numpy inputs (random and heavily tied keys)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops import common as ref
from cook_tpu_torch.ops import common as port

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def _keys(rng, n, tied):
    hi = 3 if tied else 10 * n
    return (rng.integers(0, hi, n).astype(np.int32),
            rng.integers(0, hi, n).astype(np.float32),
            rng.permutation(n).astype(np.int32))


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_lexsort_perm_matches_reference(seed, tied):
    rng = np.random.default_rng(seed)
    for n in (1, 7, 300):
        k1, k2, k3 = _keys(rng, n, tied)
        for keys in ((k1,), (k1, k2), (k2, k1, k3)):
            want = np.asarray(ref.lexsort_perm(*map(jnp.asarray, keys)))
            got = port.lexsort_perm(*map(torch.as_tensor, keys)).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("seed", range(3))
def test_segmented_cumsum_matches_reference(seed, tied):
    """Values on an exact float32 grid (integers and halves, like the
    simulator's demands): every partial sum is exact, so the reference's
    blocked cumsum and torch's sequential one agree bit for bit."""
    rng = np.random.default_rng(10 + seed)
    n = 400
    ids = np.sort(rng.integers(0, 3 if tied else 60, n)).astype(np.int32)
    for shape in ((n,), (n, 3)):
        values = (rng.integers(0, 2000, shape) / 2).astype(np.float32)
        want = np.asarray(ref.segmented_cumsum(jnp.asarray(values),
                                               jnp.asarray(ids)))
        got = port.segmented_cumsum(torch.as_tensor(values),
                                    torch.as_tensor(ids)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", range(3))
def test_inverse_permutation_and_segment_starts_match_reference(seed):
    rng = np.random.default_rng(20 + seed)
    perm = rng.permutation(257).astype(np.int32)
    np.testing.assert_array_equal(
        port.inverse_permutation(torch.as_tensor(perm)).numpy(),
        np.asarray(ref.inverse_permutation(jnp.asarray(perm))))
    ids = np.sort(rng.integers(0, 5, 100)).astype(np.int32)
    np.testing.assert_array_equal(
        port.segment_starts(torch.as_tensor(ids)).numpy(),
        np.asarray(ref.segment_starts(jnp.asarray(ids))))


def test_padding_helpers_match_reference():
    for n in (1, 64, 65, 1000, 16384, 16385):
        assert port.bucket_size(n) == ref.bucket_size(n)
    arr = np.arange(6, dtype=np.float32).reshape(3, 2)
    np.testing.assert_array_equal(port.pad_to(arr, 5, fill=7),
                                  ref.pad_to(arr, 5, fill=7))
    with pytest.raises(ValueError):
        port.pad_to(arr, 2)


def test_fetch_result_copies_tensors_and_tuples_to_numpy():
    t = torch.arange(4)
    pending = port.dispatch(lambda a: (a, a * 2), t)
    a, b = pending.fetch()
    assert isinstance(a, np.ndarray) and b.tolist() == [0, 2, 4, 6]
