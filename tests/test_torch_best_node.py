"""`cook_tpu_torch.ops.best_node` (its plain PyTorch version, which the
wrapper runs for CPU tensors) against the reference Pallas kernel run in
interpret mode, on the cases of tests/test_pallas_match.py plus prime
node counts.  The fitness arithmetic is the same sequence of float32
operations on both sides, so scores must agree to 0 ulp.  The CUDA kernel
itself is held against the same plain version on the card by
chip_smoke.py."""
import zlib

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


@pytest.mark.parametrize("kind,n", [
    ("bench", 509), ("mixed", 509), ("fleet", 509), ("placed", 509),
    ("infeasible", 509), ("last_tile", 2049), ("tile_tie", 2049),
    ("r2", 1025), ("r8", 1025)])
def test_best_node_on_the_chip_smoke_cases(kind, n):
    """The input kinds chip_smoke.py holds the CUDA kernel to (R = 4, gpu
    and disk columns, masks, a fleet of identical hosts, the one feasible
    node in the last node tile, ties across node tiles, R = 2 and 8), at a
    small size: the plain version agrees with the reference kernel here,
    so the card's kernel-vs-plain check there is a check against the
    reference too."""
    from chip_smoke import make_inputs, tile_tie_first

    args = [None if a is None else a.numpy()
            for a in make_inputs(17, n, kind, "cpu", seed=7)]
    want_v, want_i, got_v, got_i = _both(*args)
    _assert_identical(want_v, want_i, got_v, got_i)
    if kind == "fleet":
        assert (got_i == 0).all()
    if kind == "last_tile":
        assert (got_i == n - 1).all()
    if kind == "tile_tie":
        np.testing.assert_array_equal(got_i, tile_tie_first(17, n))
    assert args[0].shape[-1] == {"r2": 2, "r8": 8}.get(kind, 4)
    assert (got_i >= 0).any() == (kind != "infeasible")


def _columns(rng, demands, avail, r):
    """Widen a 3-column draw to r columns, the extra ones in use (so that
    they decide feasibility), or cut it to 2."""
    if r <= 3:
        return demands[:, :r].copy(), avail[:, :r].copy()
    k, n = demands.shape[0], avail.shape[0]
    want = np.where(rng.uniform(size=(k, r - 3)) < 0.3,
                    rng.integers(1, 50, (k, r - 3)), 0)
    have = rng.integers(0, 100, (n, r - 3))
    return (np.concatenate([demands, want], -1).astype(np.float32),
            np.concatenate([avail, have], -1).astype(np.float32))


@pytest.mark.parametrize("n,r", [(1023, 4), (1025, 4), (2047, 4),
                                 (2049, 4), (1025, 2), (1025, 8)])
def test_best_node_at_node_tile_edges(n, r):
    """Node counts one under and one over node tiles of 1024 and 2048
    (the CUDA kernel's node tiles), 9 jobs (one past a job tile of 8), R =
    2 and 8, half the mask set."""
    rng = np.random.default_rng(n + r)
    demands, avail, totals = _problem(rng, 9, n)
    demands, avail = _columns(rng, demands, avail, r)
    mask = rng.uniform(size=(9, n)) < 0.5
    want_v, want_i, got_v, got_i = _both(demands, avail, totals,
                                         rng.uniform(size=n) > 0.1, mask)
    assert (got_i >= 0).any()
    _assert_identical(want_v, want_i, got_v, got_i)


@pytest.mark.parametrize("edge", [1024, 2048])
def test_best_node_tie_across_a_node_tile_boundary(edge):
    """Identical hosts, valid only at the last node of one tile and the
    first of the next (and one more later): the earlier index wins."""
    k, n = 5, edge + 7
    demands = np.tile(np.float32([512, 1, 0]), (k, 1))
    totals = np.tile(np.float32([65536, 32]), (n, 1))
    avail = np.concatenate([totals, np.zeros((n, 1), np.float32)], axis=-1)
    valid = np.zeros(n, bool)
    valid[[edge - 1, edge, edge + 5]] = True
    want_v, want_i, got_v, got_i = _both(demands, avail, totals, valid)
    assert (got_i == edge - 1).all()
    _assert_identical(want_v, want_i, got_v, got_i)


# -- the packed-key combine of csrc/node_tile.cuh, modelled in numpy ------
#
# Line for line the helpers of csrc/score_tile.cuh (order_key, pack_key,
# key_index, kEmptyKey) and the combine of node_tile.cuh: each node tile's
# first-index best, submitted as a key only above -BIG, a max over the
# tiles' keys taken in any order (atomicMax), then the winner unpacked and
# its score read back (finalize_keys recomputes its fitness).

EMPTY_KEY = np.uint64(0)


def order_key(f):
    u = np.asarray(f, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def pack_key(best, idx):
    return ((order_key(best).astype(np.uint64) << np.uint64(32))
            | (np.uint64(0xFFFFFFFF) - idx.astype(np.uint64)))


def key_index(key):
    return (np.uint64(0xFFFFFFFF)
            - (key & np.uint64(0xFFFFFFFF))).astype(np.int64)


def tiled_combine(score, tile, rng):
    """(val, idx) of a [K, N] score matrix (-BIG where infeasible) through
    node tiles of `tile` nodes, combined in a random tile order."""
    k, n = score.shape
    keys = np.full(k, EMPTY_KEY, np.uint64)
    rows = np.arange(k)
    for n0 in rng.permutation(np.arange(0, n, tile)):
        part = score[:, n0:n0 + tile]
        local = part.argmax(1)  # the first index of the tile's max
        best = part[rows, local]
        submit = best > np.float32(-BIG)
        keys = np.where(submit, np.maximum(keys, pack_key(best, local + n0)),
                        keys)
    found = keys != EMPTY_KEY
    idx = np.where(found, key_index(keys), -1)
    val = np.where(found, score[rows, np.maximum(idx, 0)], np.float32(-BIG))
    return val.astype(np.float32), idx.astype(np.int32)


def _scores(demands, avail, totals, valid, mask):
    """The [K, N] float32 scores best_node_reference takes its argmax of,
    in numpy."""
    fits = (avail[None, :, :] >= demands[:, None, :]).all(-1)
    ok = fits & valid[None, :] & mask & (demands[:, :1] < BIG)
    den = np.maximum(totals, np.float32(1e-30))
    used = totals - avail[:, :2]
    fit = ((used[None, :, 0] + demands[:, 0:1]) / den[None, :, 0]
           + (used[None, :, 1] + demands[:, 1:2]) / den[None, :, 1]) \
        * np.float32(0.5)
    return np.where(ok, fit, np.float32(-BIG)).astype(np.float32)


def _score_kind(kind, rng):
    """Inputs of best_node whose scores are of one kind."""
    k, n = 7, 40
    demands, avail, totals = _problem(rng, k, n)
    valid = np.ones(n, bool)
    mask = rng.uniform(size=(k, n)) < 0.6
    if kind == "tied":
        totals[:] = totals[0]
        avail[:] = avail[0]
        demands[:] = demands[0]
    elif kind == "infeasible":
        demands[:, 0] = 1e9
    elif kind in ("big_adjacent", "signed_zero"):
        # one-node-per-score fleets: tot (1, 1) gives den 1, and the
        # fitness is ((1 - av0 + d0) + (1 - av1 + d1)) * 0.5
        demands[:] = 0.0
        totals[:] = 1.0
        avail[:, 1] = 1.0
        if kind == "big_adjacent":
            # av0 = 2 BIG + 1 scores exactly -BIG (infeasible by the
            # output rule), the next float up scores just above it
            big2 = np.float32(2 * BIG)
            avail[:, 0] = np.where(rng.uniform(size=n) < 0.5, big2,
                                   np.nextafter(big2, np.float32(0)))
        else:
            # av0 = 1 scores +0.0; tot = -0.0, av = +0.0 and d = -0.0
            # score -0.0 (den 1e-30): the two tie, and the first wins
            # with its own sign
            avail[:, 0] = 1.0
            neg = rng.uniform(size=n) < 0.5
            totals[neg] = np.float32(-0.0)
            avail[neg, :2] = 0.0
            demands[:, :2] = np.float32(-0.0)
    return demands, avail, totals, valid, mask


@pytest.mark.parametrize("tile", [1, 3, 16, 40])
@pytest.mark.parametrize("kind", ["random", "tied", "infeasible",
                                  "big_adjacent", "signed_zero"])
def test_packed_key_combine_equals_the_plain_argmax(kind, tile):
    """The numpy model of the CUDA kernels' packed-key combine gives
    best_node_reference's answer bit for bit, whatever the tile size and
    the order the tiles arrive in."""
    rng = np.random.default_rng([zlib.crc32(kind.encode()), tile])
    args = _score_kind(kind, rng)
    score = _scores(*args)
    want_v, want_i = bn.best_node_reference(
        *(torch.as_tensor(a) for a in args))
    for _ in range(3):  # three tile orders
        got_v, got_i = tiled_combine(score, tile, rng)
        _assert_identical(want_v.numpy(), want_i.numpy(), got_v, got_i)
    if kind == "signed_zero":
        assert (score == 0).any() and np.signbit(score[score == 0]).any()
    if kind == "big_adjacent":
        assert (score == np.float32(-BIG)).any() and (got_i >= 0).any()


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
