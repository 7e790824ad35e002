"""`cook_tpu_torch.ops.best_block` (its plain PyTorch version, which the
wrapper runs for CPU tensors) against the reference Pallas kernel run in
interpret mode: the draw of tests/test_hierarchical.py:140, tied blocks,
padded blocks and an all-infeasible case.  Indices must be equal and
scores bit-equal (the fitness is the same sequence of float32 operations
on both sides).  The CUDA kernel itself is held against the same plain
version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops.pallas_match import best_block as ref_best_block
from cook_tpu_torch.ops import best_block as bb
from cook_tpu_torch.ops.common import BIG

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def _both(demands, bsum, bmax, btot, valid):
    want_v, want_i = ref_best_block(
        jnp.asarray(demands), jnp.asarray(bsum), jnp.asarray(bmax),
        jnp.asarray(btot), jnp.asarray(valid), block_jobs=8,
        block_nodes=8, interpret=True)
    got_v, got_i = bb.best_block(*(torch.as_tensor(a) for a in (
        demands, bsum, bmax, btot, valid)))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # 0 ulp: compare the float32 bit patterns
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
    return got_v.numpy(), got_i.numpy()


@pytest.mark.parametrize("k,b,r", [(16, 8, 3), (37, 13, 4), (64, 16, 4)])
@pytest.mark.parametrize("seed", range(3))
def test_best_block_matches_reference(seed, k, b, r):
    """test_hierarchical.py:140's draw (aggregate fit, max-node gate,
    ~20% invalid blocks), also with R = 4 and prime counts."""
    rng = np.random.default_rng(4 + seed)
    demands = rng.uniform(10, 500, (k, r)).astype(np.float32)
    bsum = rng.uniform(100, 2000, (b, r)).astype(np.float32)
    bmax = (bsum * rng.uniform(0.1, 1.0, (b, r))).astype(np.float32)
    btot = (bsum[:, :2] * 1.5).astype(np.float32)
    valid = rng.uniform(size=b) > 0.2
    _, idx = _both(demands, bsum, bmax, btot, valid)
    assert (idx >= 0).any()
    # the gate: a routed job fits the chosen block's max single node
    placed = idx >= 0
    assert (bmax[idx[placed]] >= demands[placed]).all()


def test_best_block_ties_pick_the_first_block():
    """A uniform fleet: every block holds the same hosts, so every score
    ties and the first valid block wins for every job."""
    k, b = 32, 16
    rng = np.random.default_rng(0)
    demands = np.stack([rng.choice([512, 1024, 8192], k),
                        rng.choice([0.5, 1, 4], k),
                        np.zeros(k), np.zeros(k)], -1).astype(np.float32)
    host = np.float32([64000, 32, 0, 0])
    bsum = np.tile(host * 1024, (b, 1))
    bmax = np.tile(host, (b, 1))
    btot = bsum[:, :2].copy()
    valid = np.ones(b, bool)
    _, idx = _both(demands, bsum, bmax, btot, valid)
    assert (idx == 0).all()
    valid[:2] = False
    _, idx = _both(demands, bsum, bmax, btot, valid)
    assert (idx == 2).all()


def test_best_block_never_picks_padded_blocks():
    """Padded blocks arrive as the hierarchical coarse pass pads them
    (summed capacity 0, max node -1, totals 1, invalid); with every real
    block full, nothing is routed."""
    k, b, real = 16, 16, 10
    rng = np.random.default_rng(1)
    demands = np.stack([rng.choice([512, 2048], k), rng.choice([1, 2], k),
                        np.zeros(k), np.zeros(k)], -1).astype(np.float32)
    bsum = np.zeros((b, 4), np.float32)
    bsum[:real, :2] = rng.integers(1, 64, (real, 2)) * np.float32([512, 1])
    bmax = np.full((b, 4), -1.0, np.float32)
    bmax[:real] = bsum[:real]
    btot = np.ones((b, 2), np.float32)
    btot[:real] = 65536.0
    valid = np.arange(b) < real
    _, idx = _both(demands, bsum, bmax, btot, valid)
    assert (idx < real).all() and (idx >= 0).any()
    bsum[:real] = 0.0
    bmax[:real] = 0.0
    _, idx = _both(demands, bsum, bmax, btot, valid)
    assert (idx == -1).all()


def test_best_block_infeasible_everything():
    k, b = 8, 16
    demands = np.full((k, 4), 1e9, dtype=np.float32)
    bsum = np.ones((b, 4), np.float32)
    val, idx = _both(demands, bsum, bsum, np.ones((b, 2), np.float32),
                     np.ones(b, bool))
    assert (idx == -1).all()
    np.testing.assert_array_equal(val, np.float32(-BIG))


@pytest.mark.parametrize("kind", ["bench", "fleet", "padded",
                                  "placed", "infeasible"])
def test_best_block_on_the_chip_smoke_cases(kind):
    """The input kinds chip_smoke.py holds the CUDA kernel to, at a small
    size: the plain version agrees with the reference kernel here, so the
    card's kernel-vs-plain check there is a check against it too."""
    from chip_smoke import make_block_inputs

    args = [a.numpy() for a in make_block_inputs(64, 16, kind, "cpu",
                                                 seed=7)]
    _, idx = _both(*args)
    if kind == "fleet":
        assert (idx == 0).all()
    assert (idx >= 0).any() == (kind != "infeasible")


def test_best_block_rejects_what_the_kernel_does_not_take():
    d = torch.zeros(4, 3)
    a = torch.zeros(8, 3)
    t = torch.ones(8, 2)
    v = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        bb.best_block(d.double(), a, a, t, v)
    with pytest.raises(TypeError):
        bb.best_block(d, a, a, t, v.int())
    with pytest.raises(ValueError, match="shapes"):
        bb.best_block(d, a, a[:, :2], t, v)
    with pytest.raises(ValueError, match="resource columns"):
        bb.best_block(torch.zeros(4, 9), torch.zeros(8, 9),
                      torch.zeros(8, 9), t, v)
    with pytest.raises(ValueError, match="contiguous"):
        bb.best_block(torch.zeros(3, 4).t(), a, a, t, v)
    before = bb.launches
    bb.best_block(d, a, a, t, v)  # CPU tensors: the plain version
    assert bb.launches == before
