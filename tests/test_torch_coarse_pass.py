"""`cook_tpu_torch.ops.coarse_pass` on the CPU.

* Its plain version (`coarse_pass_reference`, which the wrapper runs for
  CPU tensors) against the reference's `_coarse_pallas`
  (`cook_tpu/ops/hierarchical.py:233`, its Pallas `best_block` in
  interpret mode): identical assignments, and the final availability
  equal to the starting one less the demand of the routed jobs (the
  reference returns no availability).
* A numpy model of the CUDA kernel's algorithm (`csrc/coarse_pass.cu`),
  line for line and summing in the kernel's order — per-warp segmented
  Kogge-Stone scans keyed by pick, the walk across warps, the CTA totals
  summed in cluster order, acceptance against avail + 1e-9, the largest
  accepted prefix as the round's one subtraction, the early ends of the
  round and pass loops — held to the plain version for every warp count
  and cluster size the kernel may be built with.
* The wrapper's checks, its mirror of the kernel's shared-memory need
  (which bounds B x R on the card), and the hierarchical matcher's
  routing through it.

Inputs are exact-sum (MB in multiples of 512, cpus in halves, whole gpus
and disk), as everywhere the port is held to identity: the kernel, the
plain version and the reference add in different orders, and on such
values every order gives the same float32 sums.  The CUDA kernel itself
is held against the plain version on the card by chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.ops import hierarchical as ref_hier
from cook_tpu_torch.ops import coarse_pass as cp
from cook_tpu_torch.ops import hierarchical as port_hier
from cook_tpu_torch.ops.common import BIG

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

F = np.float32
UNITS = F([512, 0.5, 1, 1])
HOST = F([16384, 8, 2, 200])


def contended(j, b, kind="mixed", seed=0):
    """(demands, active, block_avail, block_max, block_totals, block_valid)
    as numpy: blocks of 1-4 hosts partly used, so a chunk's jobs contend
    for a few blocks and fill them; later passes and rounds place more.
    Kinds: mixed, ties (capacities repeated over pairs of blocks), padded
    (the last quarter of the blocks padded as the coarse pass pads them),
    inactive (about 40% of the jobs not active), infeasible, r2, r8."""
    rng = np.random.default_rng(seed)
    demands = np.stack([
        rng.choice([512, 1024, 2048, 4096], j),
        rng.choice([0.5, 1, 2, 4], j),
        np.where(rng.uniform(size=j) < 0.1, 1, 0),
        np.where(rng.uniform(size=j) < 0.5, rng.integers(1, 50, j), 0),
    ], -1).astype(F)
    hosts = rng.integers(1, 5, b)
    full = hosts[:, None] * HOST
    used = (rng.uniform(0, 0.8, (b, 4)) * full / UNITS).astype(np.int64) \
        * UNITS
    node = (rng.uniform(0.3, 1.0, (b, 4)) * HOST / UNITS).astype(np.int64) \
        * UNITS
    if kind == "ties":
        hosts, full, used, node = (np.repeat(a[::2], 2, axis=0)[:b]
                                   for a in (hosts, full, used, node))
    bsum = (full - used).astype(F)
    bmax = np.minimum(bsum, node).astype(F)
    btot = full[:, :2].astype(F)
    valid = np.ones(b, bool)
    active = np.ones(j, bool)
    if kind == "padded":
        real = b - b // 4
        bsum[real:] = 0.0
        bmax[real:] = -1.0
        btot[real:] = 1.0
        valid[real:] = False
    elif kind == "inactive":
        active = rng.uniform(size=j) < 0.6
    elif kind == "infeasible":
        demands[:, 0] = 1e9
    elif kind == "r2":
        demands, bsum, bmax = demands[:, :2], bsum[:, :2], bmax[:, :2]
    elif kind == "r8":
        more = (rng.integers(0, 20, (b, 4)) * hosts[:, None]).astype(F)
        want = np.where(rng.uniform(size=(j, 4)) < 0.3,
                        rng.integers(1, 10, (j, 4)), 0).astype(F)
        demands = np.concatenate([demands, want], -1)
        bsum = np.concatenate([bsum, more], -1)
        bmax = np.concatenate([bmax, np.minimum(more, 20)], -1)
    return tuple(np.ascontiguousarray(a) for a in
                 (demands, active, bsum, bmax, btot, valid))


def plain(args, chunk, passes, rounds):
    got = cp.coarse_pass(*map(torch.as_tensor, args), chunk, passes, rounds)
    return got[0].numpy(), got[1].numpy()


def taken_from(args, assignment):
    """The starting availability less the demand of the routed jobs."""
    demands, _, bsum = args[:3]
    want = bsum.astype(np.float64).copy()
    routed = assignment >= 0
    np.add.at(want, assignment[routed], -demands[routed].astype(np.float64))
    return want


# ------------------------------------------------------ against the JAX kernel

JAX_CASES = [
    # (kind, J, B, chunk, passes, rounds, seed)
    ("mixed", 128, 16, 64, 4, 2, 0),
    ("mixed", 128, 16, 64, 4, 2, 1),
    ("mixed", 128, 16, 128, 4, 3, 2),
    ("mixed", 64, 8, 1, 4, 2, 3),
    ("ties", 128, 16, 64, 4, 1, 4),
    ("padded", 128, 16, 64, 1, 2, 5),
    ("infeasible", 64, 8, 64, 4, 2, 6),
    ("inactive", 128, 16, 64, 4, 2, 7),
    ("r2", 128, 16, 64, 4, 2, 8),
    ("r8", 128, 16, 64, 1, 3, 9),
]


@pytest.mark.parametrize("kind,j,b,chunk,passes,rounds,seed", JAX_CASES)
def test_plain_version_matches_the_reference(kind, j, b, chunk, passes,
                                            rounds, seed):
    args = contended(j, b, kind, seed)
    want = np.asarray(ref_hier._coarse_pallas(
        *map(jnp.asarray, args), chunk=chunk, rounds=rounds, passes=passes,
        interpret=True))
    assignment, avail = plain(args, chunk, passes, rounds)
    np.testing.assert_array_equal(assignment, want)
    np.testing.assert_array_equal(avail.astype(np.float64),
                                  taken_from(args, want))
    routed = assignment >= 0
    assert routed.any() == (kind != "infeasible")
    assert not (routed & ~args[1]).any()
    assert args[5][assignment[routed]].all()


def test_passes_and_rounds_place_more_on_contended_blocks():
    """The contended draw needs more than one pass and round: what later
    passes and rounds add is what the kernel's loops must get right."""
    args = contended(256, 16, "mixed", 11)
    counts = {(p, r): int((plain(args, 128, p, r)[0] >= 0).sum())
              for p, r in ((1, 1), (1, 2), (4, 2))}
    assert counts[1, 1] < counts[1, 2] < counts[4, 2] < 256


# ------------------------------------------------- numpy model of the kernel

NONE = -1


def gate_rows(avail, bmax, valid):
    """block_score.cuh `gate`: min(avail, max), NaN where either is NaN,
    NaN in column 0 of an invalid block."""
    g = np.where(avail >= bmax, bmax, avail)
    g = np.where(np.isnan(bmax), F(np.nan), g)
    g[~valid, 0] = F(np.nan)
    return g.astype(F)


def best_blocks(d, gate, used, den):
    """block_score.cuh `best_in_table` for every row of d: blocks in
    order, strict `>` from -BIG; -1 where nothing fits."""
    ok = (gate[None, :, :] >= d[:, None, :]).all(-1)
    fit = ((used[None, :, 0] + d[:, 0:1]) / den[None, :, 0]
           + (used[None, :, 1] + d[:, 1:2]) / den[None, :, 1]) * F(0.5)
    score = np.where(ok, fit, -np.inf)
    idx = score.argmax(-1)
    return np.where(score[np.arange(len(d)), idx] > F(-BIG), idx, -1)


def segmented_scan(keys, vals):
    """coarse_pass.cu `segmented_scan` on one warp (keys [32], vals
    [32, R]): per distinct key in first-lane order, a Kogge-Stone scan
    with the other lanes' entries 0."""
    incl = np.zeros_like(vals)
    todo = keys != NONE
    lane = np.arange(32)
    while todo.any():
        mine = keys == keys[np.argmax(todo)]
        x = np.where(mine[:, None], vals, F(0))
        for off in (1, 2, 4, 8, 16):
            y = np.zeros_like(x)
            y[off:] = x[:-off]
            x = np.where((lane >= off)[:, None], y + x, x)
        incl[mine] = x[mine]
        todo &= ~mine
    return incl


def model_coarse_pass(demands, active, bavail, bmax, btot, bvalid, chunk,
                      passes, rounds, *, threads, cluster):
    """The kernel's algorithm for T = threads a CTA (W warps) and C =
    cluster CTAs (COARSE_PASS_THREADS, COARSE_PASS_CLUSTER); returns
    (assignment, final availability) as numpy."""
    j, r = demands.shape
    b = bavail.shape[0]
    arrival = np.random.default_rng(0)
    t_, c_ = threads, cluster
    w_ = t_ // 32
    span = c_ * t_
    tiles = -(-chunk // span)
    avail = bavail.astype(F).copy()
    den = np.maximum(btot, F(1e-30))
    out = np.full(j, -1, np.int32)
    for c0 in range(0, j, chunk):
        d, ok = demands[c0:c0 + chunk], active[c0:c0 + chunk]
        # state: block >= 0 once placed; -1 no candidate; -2 - p candidate p
        state = np.full(chunk, -1, np.int64)
        for _ in range(passes):
            gate = gate_rows(avail, bmax, bvalid)
            used = (btot - avail[:, :2]).astype(F)
            cand = best_blocks(d, gate, used, den)
            scored = (state < 0) & ok & (d[:, 0] < BIG) & (cand >= 0)
            state = np.where(state < 0, np.where(scored, -2 - cand, -1),
                             state)
            changed = False
            for _ in range(rounds):
                carry = np.zeros((b, r), F)
                dmax = np.zeros((b, r), F)
                took = False
                for t in range(tiles):
                    ctas = []
                    for cta in range(c_):
                        jobs = t * span + cta * t_ + np.arange(t_)
                        inr = jobs < chunk
                        jc = np.where(inr, jobs, 0)
                        st = np.where(inr, state[jc], -1)
                        p = np.where(st <= -2, -2 - st, 0)
                        dj = np.where(inr[:, None], d[jc], F(0))
                        fits = (avail[p] >= dj).all(-1)
                        key = np.where((st <= -2) & fits, p, NONE)
                        incl = np.zeros((t_, r), F)
                        part = np.zeros((w_, b, r), F)
                        flags = np.zeros(w_, bool)
                        for w in range(w_):
                            lanes = slice(32 * w, 32 * w + 32)
                            kw = key[lanes]
                            if (kw == NONE).all():
                                continue
                            flags[w] = True
                            incl[lanes] = segmented_scan(kw, dj[lanes])
                            for k in set(kw[kw != NONE].tolist()):
                                last = 32 * w + np.nonzero(kw == k)[0][-1]
                                part[w, k] = incl[last]
                        run = np.zeros((b, r), F)
                        excl = np.zeros_like(part)
                        for w in range(w_):
                            excl[w] = run
                            if flags[w]:
                                run = run + part[w]
                        ctas.append((jc, key, incl, excl, run))
                    run, base = carry, []
                    for *_, total in ctas:
                        base.append(run)
                        run = run + total
                    carry = run
                    # the contenders in any order, as the atomicMax
                    # updates of the card's warps arrive
                    todo = [(cta, i) for cta, c in enumerate(ctas)
                            for i in np.nonzero(c[1] != NONE)[0]]
                    for n in arrival.permutation(len(todo)):
                        cta, i = todo[n]
                        jc, key, incl, excl, _ = ctas[cta]
                        k = key[i]
                        pre = base[cta][k] + excl[i // 32, k] + incl[i]
                        if (pre <= avail[k] + F(1e-9)).all():
                            state[jc[i]] = k
                            dmax[k] = np.maximum(dmax[k], pre)
                            took = True
                avail = avail - dmax
                if not took:
                    break
                changed = True
            if not changed:
                break
        out[c0:c0 + chunk] = np.maximum(state, -1)
    return out, avail


SPLITS = [(w, c) for w in (1, 2, 3, 5, 8) for c in (1, 2, 4, 8, 16)]


@pytest.mark.parametrize("warps,cluster", SPLITS,
                         ids=[f"w{w}-c{c}" for w, c in SPLITS])
def test_kernel_model_equals_plain_version_for_every_split(warps, cluster):
    """Two chunks of 256 jobs: with W warps a CTA and C CTAs the chunk
    spans one to eight tiles, or leaves CTAs without jobs."""
    args = contended(512, 16, "mixed", 20)
    want = plain(args, 256, 4, 2)
    got = model_coarse_pass(*args, 256, 4, 2, threads=32 * warps,
                            cluster=cluster)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))


MODEL_CASES = [
    # (kind, J, B, chunk, passes, rounds, warps, cluster)
    ("ties", 256, 16, 128, 4, 2, 2, 1),
    ("padded", 256, 16, 256, 4, 3, 1, 4),
    ("inactive", 256, 16, 64, 4, 2, 1, 2),
    ("infeasible", 64, 8, 64, 2, 2, 1, 1),
    ("r2", 256, 16, 128, 4, 2, 4, 1),
    ("r8", 256, 16, 128, 2, 3, 1, 8),
    ("mixed", 64, 16, 1, 4, 2, 1, 1),
    ("mixed", 64, 16, 1, 4, 2, 1, 16),
    ("mixed", 256, 128, 256, 4, 2, 2, 2),
    ("mixed", 256, 16, 256, 4, 1, 8, 1),
]


@pytest.mark.parametrize("kind,j,b,chunk,passes,rounds,warps,cluster",
                         MODEL_CASES)
def test_kernel_model_equals_plain_version(kind, j, b, chunk, passes, rounds,
                                           warps, cluster):
    """Ties, padded blocks, inactive jobs, nothing feasible, R = 2 and 8,
    chunk 1, 128 blocks, one round."""
    args = contended(j, b, kind, 30 + j + b)
    want = plain(args, chunk, passes, rounds)
    got = model_coarse_pass(*args, chunk, passes, rounds,
                            threads=32 * warps, cluster=cluster)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.int32), want[1].view(np.int32))


def test_segmented_scan_sums_each_pick_in_lane_order():
    keys = np.array([3, 1, 3, NONE, 1, 3] + [NONE] * 26)
    vals = np.zeros((32, 2), F)
    vals[:6] = [[512, 1], [1024, 2], [2048, 0.5], [7, 7], [512, 4],
                [4096, 1]]
    incl = segmented_scan(keys, vals)
    np.testing.assert_array_equal(incl[[0, 2, 5], 0], [512, 2560, 6656])
    np.testing.assert_array_equal(incl[[1, 4], 1], [2, 6])
    assert not incl[3].any()


# -------------------------------------------------------------- the wrapper

def test_coarse_pass_rejects_what_the_kernel_does_not_take():
    args = [torch.as_tensor(a) for a in contended(64, 8, "mixed", 1)]
    d, act, bsum, bmax, btot, valid = args
    with pytest.raises(TypeError):
        cp.coarse_pass(d.double(), act, bsum, bmax, btot, valid, 64, 2, 2)
    with pytest.raises(TypeError):
        cp.coarse_pass(d, act.int(), bsum, bmax, btot, valid, 64, 2, 2)
    with pytest.raises(ValueError, match="shapes"):
        cp.coarse_pass(d, act[:32], bsum, bmax, btot, valid, 64, 2, 2)
    with pytest.raises(ValueError, match="shapes"):
        cp.coarse_pass(d, act, bsum, bmax[:, :2], btot, valid, 64, 2, 2)
    with pytest.raises(ValueError, match="chunk"):
        cp.coarse_pass(d, act, bsum, bmax, btot, valid, 48, 2, 2)
    with pytest.raises(ValueError, match="chunk"):
        cp.coarse_pass(d, act, bsum, bmax, btot, valid, 64, -1, 2)
    with pytest.raises(ValueError, match="resource columns"):
        cp.coarse_pass(torch.zeros(64, 9), act, torch.zeros(8, 9),
                       torch.zeros(8, 9), btot, valid, 64, 2, 2)
    with pytest.raises(ValueError, match="contiguous"):
        cp.coarse_pass(torch.zeros(4, 64).t(), act, bsum, bmax, btot, valid,
                       64, 2, 2)
    before = cp.launches
    cp.coarse_pass(d, act, bsum, bmax, btot, valid, 64, 2, 2)  # CPU: plain
    assert cp.launches == before


def test_smem_bytes_counts_the_kernels_layout():
    """smem_bytes mirrors coarse_pass.cu's `layout` at its default shape
    (8 CTAs x 512 threads, 16 warps): 9 + 16 words a (block, resource),
    6 a block, one a warp and 4 flags, one a slot of a CTA's share of the
    chunk (512 at chunk 4096, 1024 at 8192)."""
    assert cp._CLUSTER * cp._THREADS == 4096
    for b, r, chunk in ((16, 4, 4096), (128, 8, 4096), (128, 8, 8192),
                        (16, 2, 1)):
        slots = -(-chunk // 4096) * 512
        words = 25 * b * r + 6 * b + 16 + 4 + slots
        assert cp.smem_bytes(b, r, chunk) == 4 * words


# the largest block count whose state fits in shared memory at chunk 4096
SMEM_EDGE = {2: 1028, 4: 543, 8: 279}


@pytest.mark.parametrize("r", [2, 4, 8])
def test_check_fits_at_the_shared_memory_limit(r):
    """The largest block count whose state fits the card's 227 KB keeps it
    in shared memory; one more pages it to a device-memory workspace (one
    stretch of block state a CTA) and keeps only the slots and flags in
    shared memory; both pass check_fits, as does B 1024.  B 128 (100k
    nodes at 1024 a block) fits at every R."""
    b = max(x for x in range(1, 4096) if not cp.paged(x, r, 4096))
    assert b == SMEM_EDGE[r]
    assert cp.SMEM_LIMIT - cp.smem_bytes(b, r, 4096) < 4 * (26 * r + 6)
    assert cp.workspace_floats(b, r, 4096) == 0
    assert cp.paged(b + 1, r, 4096)
    assert cp.smem_bytes(b + 1, r, 4096) == 4 * (16 + 4 + 512)
    assert cp.workspace_floats(b + 1, r, 4096) \
        == 8 * (25 * (b + 1) * r + 6 * (b + 1))
    for blocks in (b, b + 1, 128, 1024):
        cp.check_fits(blocks, r, 4096)
    assert not cp.paged(128, r, 4096)


def test_check_fits_raises_only_for_shapes_the_kernel_cannot_take():
    for r in (1, 9):
        with pytest.raises(ValueError, match="resource columns"):
            cp.check_fits(16, r, 4096)
    # a chunk whose job slots alone are over the shared memory
    with pytest.raises(ValueError, match="coarse_chunk"):
        cp.check_fits(16, 4, 1 << 20)


def test_plain_version_has_no_block_limit():
    """On the CPU, and in the kernel (paged), a B x R past the shared
    memory runs."""
    args = list(contended(64, 8, "r8", 3))
    args[2:5] = (np.tile(args[2], (128, 1)), np.tile(args[3], (128, 1)),
                 np.tile(args[4], (128, 1)))
    args[5] = np.tile(args[5], 128)
    assert cp.paged(1024, 8, 64)
    cp.check_fits(1024, 8, 64)
    assignment, avail = plain(tuple(args), 64, 2, 2)
    assert (assignment >= 0).any()
    np.testing.assert_array_equal(avail.astype(np.float64),
                                  taken_from(args, assignment))


def test_no_passes_or_rounds_route_nothing():
    args = contended(64, 8, "mixed", 2)
    for passes, rounds in ((0, 2), (2, 0)):
        assignment, avail = plain(args, 32, passes, rounds)
        assert (assignment == -1).all()
        np.testing.assert_array_equal(avail, args[2])


def test_hierarchical_coarse_pass_goes_through_the_wrapper(monkeypatch):
    """`_coarse_pallas` is one coarse_pass call per coarse pass."""
    calls = []
    real = port_hier.coarse_pass

    def keep(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(port_hier, "coarse_pass", keep)
    args = [torch.as_tensor(a) for a in contended(128, 16, "mixed", 3)]
    got = port_hier._coarse_pallas(*args, chunk=64, rounds=2, passes=4)
    assert len(calls) == 1 and calls[0][6:] == (64, 4, 2)
    np.testing.assert_array_equal(
        got.numpy(), plain([a.numpy() for a in args], 64, 4, 2)[0])


@pytest.mark.parametrize("kind", ["fleet", "mixed", "ties", "slice",
                                  "padded", "inactive", "infeasible", "r2",
                                  "r8"])
def test_plain_version_on_the_chip_smoke_kinds(kind):
    """chip_smoke.py's COARSE_CASES kinds at a small size, against the
    reference: the card's kernel-vs-plain check there is then a check
    against it too."""
    from chip_smoke import COARSE_KINDS, make_coarse_inputs

    assert kind in COARSE_KINDS
    args = tuple(a.numpy() for a in make_coarse_inputs(256, 16, kind,
                                                       "cpu", seed=5))
    want = np.asarray(ref_hier._coarse_pallas(
        *map(jnp.asarray, args), chunk=128, rounds=2, passes=2,
        interpret=True))
    assignment, avail = plain(args, 128, 2, 2)
    np.testing.assert_array_equal(assignment, want)
    np.testing.assert_array_equal(avail.astype(np.float64),
                                  taken_from(args, want))


def test_chip_smoke_bound_counts_the_jobs_each_pass_scores():
    """chip_smoke.py's coarse_pass bound: every input byte once and every
    output once, against (2R + 8) operations per (live job, valid block)
    pair of each pass, counting only the jobs still unplaced there."""
    from chip_smoke import PEAK_BYTES_S, PEAK_F32_OPS_S, coarse_pass_bound

    args = [torch.as_tensor(a) for a in contended(128, 16, "inactive", 4)]
    scored = []
    cp.coarse_pass_reference(*args, 64, 4, 2, scored=scored)
    assert len(scored) == 2 * 4
    assert scored[0] == int(args[1][:64].sum()) > scored[1]
    j, r, b = 128, 4, 16
    nbytes = j * r * 4 + j + 2 * b * r * 4 + b * 2 * 4 + b + j * 4 + b * r * 4
    ops = sum(scored) * b * (2 * r + 8)
    bound, by = coarse_pass_bound(*args, 64, 4, 2)
    want = {"bytes": nbytes / PEAK_BYTES_S * 1e3,
            "operations": ops / PEAK_F32_OPS_S * 1e3}
    assert by == max(want, key=want.get)
    assert bound == pytest.approx(want[by])


def test_plain_version_at_1024_blocks_matches_reference():
    """B 1024 x R 8 (paged on the card), the reference's `_coarse_pallas`
    in interpret mode at a J the CPU takes quickly: identical assignment,
    and the availability accounts for the routed jobs."""
    args = list(contended(256, 8, "r8", 6))
    # 1024 blocks: the 8 drawn ones repeated, every fourth invalid
    args[2:5] = (np.tile(args[2], (128, 1)), np.tile(args[3], (128, 1)),
                 np.tile(args[4], (128, 1)))
    args[5] = np.tile(args[5], 128) & (np.arange(1024) % 4 != 3)
    args = tuple(args)
    assert cp.paged(1024, 8, 128)
    want = np.asarray(ref_hier._coarse_pallas(
        *map(jnp.asarray, args), chunk=128, rounds=2, passes=2,
        interpret=True))
    assignment, avail = plain(args, 128, 2, 2)
    np.testing.assert_array_equal(assignment, want)
    assert (assignment >= 0).sum() > 0
    np.testing.assert_array_equal(avail.astype(np.float64),
                                  taken_from(args, want))


def test_hierarchical_pallas_coarse_past_512_padded_blocks():
    """A pool of 600 blocks (1024 padded) on the `pallas` coarse backend:
    the solve runs (the padded block count is past the old shared-memory
    cap at R 4), routes through coarse_pass, and equals the reference's
    two-level solve."""
    from tests.test_torch_hierarchical import exact_problem, solve_both

    demands, avail, totals, _ = exact_problem(64, 600, seed=8)
    stats = solve_both(demands, avail, totals, nodes_per_block=1, chunk=64,
                       kc=16, coarse_passes=2, fine_passes=2,
                       coarse_backend="pallas", fine_backend="xla",
                       refine_rounds=0)
    assert stats["block_pad"] == 1024 > 512
    assert cp.paged(stats["block_pad"], 4, 64)
    cp.check_fits(stats["block_pad"], 4, 64)
    assert stats["placed"] > 0


@pytest.mark.parametrize("kind", ["mixed", "r8"])
def test_plain_version_on_the_chip_smoke_paged_cases(kind):
    """chip_smoke.py's PAGED_CASES inputs at 1024 blocks and a small J,
    against the reference; its edge rows straddle the shared memory."""
    from chip_smoke import PAGED_CASES, make_coarse_inputs

    assert {case[-1] for case in PAGED_CASES} == {"mixed", "r8"}
    edge = max(b for b in range(1, 2048) if not cp.paged(b, 8, 4096))
    assert cp.paged(edge + 1, 8, 4096) and edge == SMEM_EDGE[8]
    args = tuple(a.numpy() for a in make_coarse_inputs(256, 1024, kind,
                                                       "cpu", seed=2))
    want = np.asarray(ref_hier._coarse_pallas(
        *map(jnp.asarray, args), chunk=128, rounds=2, passes=2,
        interpret=True))
    assignment, avail = plain(args, 128, 2, 2)
    np.testing.assert_array_equal(assignment, want)
    np.testing.assert_array_equal(avail.astype(np.float64),
                                  taken_from(args, want))
