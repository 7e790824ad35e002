"""`cook_tpu_torch.ops.best_node_batched` (its plain PyTorch version, which
the wrapper runs for CPU tensors) against the reference Pallas kernel run
in interpret mode: masked and unmasked, prime slot and node counts, and
ties.  Indices must be equal (block-local) and scores bit-equal.  It must
also equal the port's `best_node` run block by block
(tests/test_device_state.py:577).  The CUDA kernel itself is held against
the same plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops.pallas_match import best_node_batched as ref_batched
from cook_tpu_torch.ops import best_node as bn
from cook_tpu_torch.ops import best_node_batched as bnb

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)


def _both(demands, avail, totals, valid, mask=None):
    want_v, want_i = ref_batched(
        jnp.asarray(demands), jnp.asarray(avail), jnp.asarray(totals),
        jnp.asarray(valid), None if mask is None else jnp.asarray(mask),
        block_jobs=8, block_nodes=128, interpret=True)
    got_v, got_i = bnb.best_node_batched(
        *(torch.as_tensor(a) for a in (demands, avail, totals, valid)),
        None if mask is None else torch.as_tensor(mask))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    # 0 ulp: compare the float32 bit patterns
    np.testing.assert_array_equal(got_v.numpy().view(np.int32),
                                  np.asarray(want_v).view(np.int32))
    return got_v.numpy(), got_i.numpy()


def _draw(rng, b, s, n, r=4):
    """tests/test_device_state.py:577's draw (uniform demands and free
    capacity, ~20% invalid nodes, ~70% of the mask set)."""
    d = rng.uniform(1, 10, (b, s, r)).astype(np.float32)
    av = rng.uniform(0, 20, (b, n, r)).astype(np.float32)
    tot = (av[:, :, :2] + 5).astype(np.float32)
    nv = rng.uniform(size=(b, n)) > 0.2
    feas = rng.uniform(size=(b, s, n)) > 0.3
    return d, av, tot, nv, feas


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("b,s,n", [(3, 16, 32), (2, 13, 131), (5, 7, 257)])
def test_best_node_batched_matches_reference(b, s, n, masked):
    """Even and prime slot/node counts, which leave ragged tiles on the
    reference."""
    d, av, tot, nv, feas = _draw(np.random.default_rng(s + n), b, s, n)
    _, idx = _both(d, av, tot, nv, feas if masked else None)
    assert (idx >= 0).any() and (idx < n).all()


def test_best_node_batched_equals_best_node_per_block():
    """test_device_state.py:577: the batched scorer is `best_node` run on
    each block's problem."""
    d, av, tot, nv, feas = _draw(np.random.default_rng(0), 3, 16, 32)
    val, idx = bnb.best_node_batched(
        *(torch.as_tensor(a) for a in (d, av, tot, nv, feas)))
    for k in range(3):
        v1, i1 = bn.best_node(*(torch.as_tensor(a[k])
                                for a in (d, av, tot, nv, feas)))
        assert torch.equal(idx[k], i1)
        assert torch.equal(val[k].view(torch.int32), v1.view(torch.int32))


def test_best_node_batched_ties_pick_the_first_index():
    """Identical hosts in every block: the first feasible node of each
    block wins; a block without one gives -1."""
    b, s, n = 3, 8, 64
    d = np.tile(np.float32([512, 1, 0, 0]), (b, s, 1))
    tot = np.tile(np.float32([64000, 32]), (b, n, 1))
    av = np.concatenate([tot, np.zeros((b, n, 2), np.float32)], -1)
    nv = np.ones((b, n), bool)
    nv[1, :5] = False
    nv[2] = False
    _, idx = _both(d, av, tot, nv)
    np.testing.assert_array_equal(idx[0], 0)
    np.testing.assert_array_equal(idx[1], 5)
    np.testing.assert_array_equal(idx[2], -1)


@pytest.mark.parametrize("kind,n", [
    ("mixed", 96), ("fleet", 96), ("bench", 96), ("placed", 96),
    ("infeasible", 96), ("last_tile", 1025), ("tile_tie", 2049),
    ("r2", 96), ("r8", 96)])
def test_best_node_batched_on_the_chip_smoke_cases(kind, n):
    """The input kinds chip_smoke.py holds the CUDA kernel to, at a small
    size: the plain version agrees with the reference kernel here, so the
    card's kernel-vs-plain check there is a check against it too."""
    from chip_smoke import make_batched_inputs, tile_tie_first

    args = [None if a is None else a.numpy()
            for a in make_batched_inputs(4, 17, n, kind, "cpu", seed=7)]
    _, idx = _both(*args)
    if kind == "fleet":
        # blocks whose hosts are all real pick their first host
        assert (idx[:2] == 0).all()
    if kind == "last_tile":
        assert (idx == n - 1).all()
    if kind == "tile_tie":
        assert (idx == tile_tie_first(17, n)).all()
    assert args[0].shape[-1] == {"r2": 2, "r8": 8, "bench": 3}.get(kind, 4)
    assert (idx >= 0).any() == (kind != "infeasible")


@pytest.mark.parametrize("s,n,r", [(9, 1023, 4), (17, 1025, 4),
                                   (9, 1025, 2), (9, 1025, 8)])
def test_best_node_batched_at_tile_edges(s, n, r):
    """Nodes per block one under and one over a node tile of 1024 (the
    CUDA kernel splits a wider block into node tiles), slots one past a
    slot tile of 8 or 16, R = 2 and 8."""
    d, av, tot, nv, feas = _draw(np.random.default_rng(s + n + r), 2, s, n,
                                 r=r)
    _, idx = _both(d, av, tot, nv, feas)
    assert (idx >= 0).any() and (idx < n).all()


@pytest.mark.parametrize("edge", [1024, 2048])
def test_best_node_batched_tie_across_a_node_tile_boundary(edge):
    """Identical hosts valid only at the last node of one node tile and
    the first of the next: every slot takes the earlier one."""
    b, s, n = 2, 5, edge + 3
    d = np.tile(np.float32([512, 1, 0, 0]), (b, s, 1))
    tot = np.tile(np.float32([64000, 32]), (b, n, 1))
    av = np.concatenate([tot, np.zeros((b, n, 2), np.float32)], -1)
    nv = np.zeros((b, n), bool)
    nv[:, [edge - 1, edge]] = True
    _, idx = _both(d, av, tot, nv)
    np.testing.assert_array_equal(idx, edge - 1)


def test_chip_smoke_bound_counts_only_live_slots():
    """A placed or empty slot (a 2 BIG demand) is answered without its
    mask row, so the bound chip_smoke.py reports drops those rows' bytes."""
    from chip_smoke import (PEAK_BYTES_S, best_node_batched_bound,
                            make_batched_inputs)
    from cook_tpu_torch.ops.common import BIG

    b, s, n = 2, 16, 64
    args = list(make_batched_inputs(b, s, n, "mixed", "cpu", seed=3))
    full, by = best_node_batched_bound(*args)
    args[0] = args[0].clone()
    args[0][:, s // 2:, 0] = 2 * BIG
    half, _ = best_node_batched_bound(*args)
    assert by == "bytes"
    assert full - half == pytest.approx(b * (s // 2) * n / PEAK_BYTES_S
                                        * 1e3)


def test_best_node_batched_rejects_what_the_kernel_does_not_take():
    d = torch.zeros(2, 4, 3)
    a = torch.zeros(2, 8, 3)
    t = torch.ones(2, 8, 2)
    v = torch.ones(2, 8, dtype=torch.bool)
    with pytest.raises(TypeError):
        bnb.best_node_batched(d.double(), a, t, v)
    with pytest.raises(TypeError):
        bnb.best_node_batched(d, a, t, v.int())
    with pytest.raises(ValueError, match="shapes"):
        bnb.best_node_batched(d, a[:1], t, v)
    with pytest.raises(ValueError, match="mask"):
        bnb.best_node_batched(d, a, t, v, torch.ones(2, 4, 7,
                                                      dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        bnb.best_node_batched(d.transpose(0, 1).contiguous()
                              .transpose(0, 1), a, t, v)
    before = bnb.launches
    bnb.best_node_batched(d, a, t, v)  # CPU tensors: the plain version
    assert bnb.launches == before
