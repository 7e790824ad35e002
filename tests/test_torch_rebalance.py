"""`cook_tpu_torch.ops.rebalance` against `cook_tpu.ops.rebalance`: the
exact victim search (`find_preemption_decision`) and the sort-once pair
(`sort_rebalance_state` + `decide_from_sorted`) on the same seeded numpy
inputs.

On exact-sum inputs (MB in multiples of 512, cpus in halves, whole gpus:
every order of summing gives the same float32 prefix sums) host, score,
preempt mask and freed must be identical — no tolerance.  On random
uniform inputs, whose float32 sums round with the scan order, the port is
held to the numpy oracle `ref_preemption_decision` under the acceptance
rules of tests/test_ops_parity.py:268 (the chosen host and victims exact,
the score to rtol 1e-6, any spare-fitting host for a spare-only
decision)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import REBALANCE_CASES, make_rebalance_inputs
from cook_tpu.ops import rebalance as ref
from cook_tpu_torch.ops import cpu_reference as port_oracle
from cook_tpu_torch.ops import rebalance as port
from cook_tpu_torch.ops.common import BIG, fetch_result
from tests.test_ops_parity import random_rebalance_problem

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

CPU = torch.device("cpu")
T, H = 1024, 128
F32 = np.float32
# kinds beyond chip_smoke's REBALANCE_CASES:
#   host_ok false   no host passes the job's constraints: nothing found,
#                   though spare and victims exist
#   threshold edge  DRUs at and one ulp either side of the safe threshold
#   min-diff edge   DRUs around pending + min_dru_diff, with a pending
#                   DRU (0.1) whose float32 and float64 values differ: the
#                   comparison must be made in float32
KINDS = REBALANCE_CASES + ("host_ok false", "threshold edge",
                           "min-diff edge")


def _case(kind, seed):
    """(numpy state fields, demand, pending, threshold, min_diff)."""
    base = kind if kind in REBALANCE_CASES else "victims"
    state, demand, pending, thr, diff = fetch_result(
        make_rebalance_inputs(T, H, base, CPU, seed=seed))
    state = [np.array(a) for a in state]
    host, dru, res, elig, spare, host_ok = state
    pending, thr, diff = float(pending), float(thr), float(diff)
    live = host >= 0
    rng = np.random.default_rng(1000 + seed)
    if kind == "host_ok false":
        host_ok[:] = False
    elif kind == "threshold edge":
        edge = np.array([np.nextafter(F32(1), F32(0)), F32(1),
                         np.nextafter(F32(1), F32(2))], F32)
        pick = live & (rng.uniform(size=T) < 0.5)
        dru[pick] = rng.choice(edge, int(pick.sum()))
    elif kind == "min-diff edge":
        pending, thr = 0.1, 0.0
        at = F32(0.6)
        edge = np.array([np.nextafter(np.nextafter(at, F32(0)), F32(0)),
                         np.nextafter(at, F32(0)), at,
                         np.nextafter(at, F32(1)),
                         np.nextafter(np.nextafter(at, F32(1)), F32(1))],
                        F32)
        dru[live] = rng.choice(edge, int(live.sum()))
    return (host, dru, res, elig, spare, host_ok), demand, pending, thr, diff


def _ref_decisions(fields, demand, pending, thr, diff):
    host, dru, res, elig, spare, host_ok = (jnp.asarray(a) for a in fields)
    scal = (jnp.float32(pending), jnp.float32(thr), jnp.float32(diff))
    d_exact = ref.find_preemption_decision(
        ref.RebalanceState(host, dru, res, elig, spare, host_ok),
        jnp.asarray(demand), *scal)
    ss = ref.sort_rebalance_state(host, dru, res, elig)
    d_sorted = ref.decide_from_sorted(ss, elig[ss.perm], dru[ss.perm], spare,
                                      host_ok, jnp.asarray(demand), *scal)
    return ([np.asarray(x) for x in d_exact],
            [np.asarray(x) for x in d_sorted], np.asarray(ss.perm))


def _port_decisions(fields, demand, pending, thr, diff):
    host, dru, res, elig, spare, host_ok = (torch.as_tensor(a)
                                            for a in fields)
    scal = (port.as_scalar(pending, CPU), port.as_scalar(thr, CPU),
            port.as_scalar(diff, CPU))
    d_exact = port.find_preemption_decision(
        port.RebalanceState(host, dru, res, elig, spare, host_ok),
        torch.as_tensor(demand), *scal)
    ss = port.sort_rebalance_state(host, dru, res, elig)
    d_sorted = port.decide_from_sorted(ss, elig[ss.perm], dru[ss.perm],
                                       spare, host_ok,
                                       torch.as_tensor(demand), *scal)
    return (list(fetch_result(d_exact)), list(fetch_result(d_sorted)),
            ss.perm.numpy())


def _assert_identical(got, want):
    names = ("host", "score", "preempt_mask", "freed")
    for name, g, w in zip(names, got, want):
        assert g.shape == w.shape, name
        if g.dtype.kind == "f":
            assert g.dtype == w.dtype == np.float32, name
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", KINDS)
def test_decisions_identical_to_reference_on_exact_sums(kind, seed):
    case = _case(kind, seed)
    want_exact, want_sorted, want_perm = _ref_decisions(*case)
    got_exact, got_sorted, got_perm = _port_decisions(*case)
    np.testing.assert_array_equal(got_perm, want_perm)
    _assert_identical(got_exact, want_exact)
    _assert_identical(got_sorted, want_sorted)
    host, score, mask, _ = got_exact
    (_, _, _, elig, spare, host_ok), demand = case[0], case[1]
    fits = host_ok & (spare >= demand).all(-1)
    if kind in ("none", "host_ok false"):
        assert host == -1 and not mask.any() and score == F32(-BIG)
    elif kind == "spare tie":
        # every 7th host fits by spare alone: the first of the BIG ties
        assert fits.sum() > 1
        assert host == np.argmax(fits) and score == F32(BIG)
        assert not mask.any()
    elif kind == "quota":
        # the search may take only the 10% of rows left eligible
        assert elig.mean() < 0.2 and elig[mask].all()
    else:
        assert host >= 0 and mask.any() and not fits.any()
        assert elig[mask].all()


@pytest.mark.parametrize("kind", ["min-diff edge", "threshold edge"])
def test_edge_cases_reach_both_sides_of_the_boundary(kind):
    """The edge kinds really straddle their comparison: some live rows
    pass and some fail it in float32, and for min-diff a float64
    comparison would decide some rows the other way."""
    (host, dru, _, elig, _, _), _, pending, thr, diff = _case(kind, 0)
    live = host >= 0
    if kind == "threshold edge":
        passed = dru[live] >= F32(thr)
    else:
        passed = (dru[live] - F32(pending)) > F32(diff)
        wide = (dru[live].astype(np.float64) - pending) > diff
        assert (passed != wide).any()
    assert passed.any() and not passed.all()


def test_sentinel_rows_sort_after_every_host():
    """Masked rows take the int32-max host key and sort last, so they
    never join a real host's segment."""
    host = torch.tensor([3, -1, 0, 3, 2], dtype=torch.int32)
    dru = torch.tensor([1.0, 9.0, 2.0, 5.0, 0.5])
    res = torch.ones(5, 4)
    elig = torch.tensor([True, False, True, True, False])
    ss = port.sort_rebalance_state(host, dru, res, elig)
    assert ss.perm.tolist() == [2, 3, 0, 1, 4]
    assert ss.s_host.tolist() == [0, 3, 3, port.SENTINEL_HOST,
                                  port.SENTINEL_HOST]


def test_scalars_are_float32_on_the_device():
    s = port.as_scalar(0.1, CPU)
    assert s.dtype == torch.float32 and s.dim() == 0
    assert float(s) == float(np.float32(0.1))


@pytest.mark.parametrize("seed", range(8))
def test_random_inputs_match_the_numpy_oracle(seed):
    """tests/test_ops_parity.py:268 with the port's search and the port's
    copy of the oracle."""
    rng = np.random.default_rng(300 + seed)
    task_host, task_dru, task_res, eligible, spare, host_ok = (
        random_rebalance_problem(rng))
    demand = (400.0, 6.0, 0.0)
    pending_dru, thresh, mindiff = 0.4, 1.0, 0.5
    want = port_oracle.ref_preemption_decision(
        task_host, task_dru, task_res[:, 0], task_res[:, 1], task_res[:, 2],
        eligible, spare, host_ok, demand, pending_dru, thresh, mindiff,
    )
    f32 = torch.float32
    state = port.RebalanceState(
        task_host=torch.as_tensor(task_host, dtype=torch.int32),
        task_dru=torch.as_tensor(task_dru, dtype=f32),
        task_res=torch.as_tensor(task_res, dtype=f32),
        task_eligible=torch.as_tensor(eligible),
        spare=torch.as_tensor(spare, dtype=f32),
        host_ok=torch.as_tensor(host_ok),
    )
    got = fetch_result(port.find_preemption_decision(
        state, torch.tensor(demand, dtype=f32),
        *(port.as_scalar(v, CPU) for v in (pending_dru, thresh, mindiff))))
    if want is None:
        assert int(got.host) == -1
        assert not got.preempt_mask.any()
        return
    want_host, want_tasks = want
    if not want_tasks:  # spare-only decision
        assert float(got.score) >= np.float32(BIG)
        assert not got.preempt_mask.any()
        assert np.all(spare[int(got.host)] >= np.asarray(demand))
    else:
        assert int(got.host) == want_host
        assert sorted(np.where(got.preempt_mask)[0].tolist()) == \
            sorted(want_tasks)
        np.testing.assert_allclose(float(got.score),
                                   task_dru[want_tasks[-1]], rtol=1e-6)


def test_port_oracle_is_the_reference_oracle():
    """The port's numpy copy decides as the reference's module does."""
    from cook_tpu.ops import cpu_reference as ref_oracle

    for seed in range(4):
        rng = np.random.default_rng(900 + seed)
        p = random_rebalance_problem(rng)
        args = (p[0], p[1], p[2][:, 0], p[2][:, 1], p[2][:, 2], p[3], p[4],
                p[5], (400.0, 6.0, 0.0), 0.4, 1.0, 0.5)
        assert port_oracle.ref_preemption_decision(*args) == \
            ref_oracle.ref_preemption_decision(*args)
