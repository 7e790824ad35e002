"""The plain reference against the program (`cook_tpu_torch`, on the CPU)
at a small size: the DRU order against `ops/dru.dru_rank`, the greedy
against the exact `ops/match.greedy_match`, one victim search against
`ops/rebalance.find_preemption_decision`; and the bfloat16 control, which
has to read otherwise."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cook_tpu_torch.ops import dru as port_dru
from cook_tpu_torch.ops import match as port_match
from cook_tpu_torch.ops import rebalance as port_rebalance
from cookbench.reference import dru, greedy
from cookbench.reference.precision import bf16, f32
from cookbench.reference.rebalance import VictimSearch

SEEDS = [1, 2, 3, 2**31 + 17]


def tasks(seed, n_run=60, n_pend=200, users=7):
    rng = np.random.default_rng(seed)

    def cols(n):
        return (rng.integers(0, users, n), rng.choice([25, 50, 75], n),
                np.stack([rng.choice([512.0, 1024, 2048, 4096, 8192], n),
                          rng.choice([0.5, 1.0, 2.0, 4.0], n),
                          rng.choice([0.0, 0.0, 1.0, 2.0], n)], axis=1))
    return cols(n_run), cols(n_pend)


def port_order(run, pend, div, gpu_mode):
    """The pending positions in the port's `dru_rank` order, its tasks laid
    out as `rank_pool_columnar` lays them out."""
    (ru, rp, rr), (pu, pp, pr) = run, pend
    n_run, n = len(ru), len(ru) + len(pu)
    user = np.concatenate([ru, pu])
    neg_prio = np.concatenate([-rp, -pp])
    start = np.concatenate([np.arange(n_run), np.full(len(pu), 2**62)])
    kept_order = np.lexsort((np.arange(len(pu)), -pp, pu))
    # pending jobs enter the kernel in (user, -priority, submission) order
    user = np.concatenate([ru, pu[kept_order]])
    neg_prio = np.concatenate([-rp, -pp[kept_order]])
    res = np.concatenate([rr, pr[kept_order]])
    perm = np.lexsort((np.arange(n), start, neg_prio, user))
    key = np.empty(n, np.float32)
    key[perm] = np.arange(n, dtype=np.float32)
    t = port_dru.from_numpy(user, res[:, 0], res[:, 1], res[:, 2], key,
                            np.ones(n, bool), device="cpu")
    d = torch.as_tensor(div)
    out = port_dru.dru_rank(t, d[:, 0], d[:, 1], d[:, 2], gpu_mode=gpu_mode)
    order = out.order.numpy()
    return kept_order[order[order >= n_run] - n_run]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("gpu_mode", [False, True])
def test_dru_order_matches_the_port(seed, gpu_mode):
    run, pend = tasks(seed)
    share = (3 * 8192.0, 12.0, 3.0)
    div = np.tile(dru.divisors(share), (7, 1))
    (ru, rp, rr), (pu, pp, pr) = run, pend
    ref = dru.dru_order(pu, pp, np.arange(len(pu)), pr, ru, rp, rr, div,
                        gpu_mode)
    assert list(ref) == list(port_order(run, pend, div, gpu_mode))


@pytest.mark.parametrize("seed", SEEDS)
def test_dru_control_reads_otherwise(seed):
    """In bfloat16 the shares' quotients collide: the order moves."""
    run, pend = tasks(seed, n_pend=2000)
    share = (3 * 8192.0 + 512, 12.5, 3.0)
    (ru, rp, rr), (pu, pp, pr) = run, pend
    a = dru.dru_order(pu, pp, np.arange(len(pu)), pr, ru, rp, rr,
                      np.tile(dru.divisors(share), (7, 1)), False)
    b = dru.dru_order(pu, pp, np.arange(len(pu)), pr, ru, rp, rr,
                      np.tile(dru.divisors(share, bf16), (7, 1)), False,
                      rnd=bf16)
    assert (a != b).sum() > 0


def test_bfloat16_rounding():
    x = np.array([1.0, 1.00390625, 1.005859375, 3.0e-3, 65536.0 + 256],
                 np.float32)
    got = bf16(x)
    assert got[0] == 1.0 and got[1] == 1.0          # ties to even
    assert got[2] == 1.0078125
    assert got[4] == 65536.0
    assert (f32(x) == x).all()


@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_matches_the_port(seed):
    rng = np.random.default_rng(seed)
    j, n = 120, 24
    demands = np.stack([rng.choice([512.0, 1024, 2048, 4096, 8192], j),
                        rng.choice([0.5, 1.0, 2.0, 4.0], j),
                        np.zeros(j)], axis=1)
    avail = np.stack([rng.choice([8192.0, 16384, 32768, 65536], n),
                      rng.choice([4.0, 8.0, 16.0, 32.0], n),
                      np.zeros(n)], axis=1)
    totals = np.tile([65536.0, 32.0], (n, 1))
    feasible = rng.uniform(size=(j, n)) < 0.8
    ref = greedy.greedy(demands, avail, totals, feasible)
    problem = port_match.MatchProblem(
        demands=torch.as_tensor(demands, dtype=torch.float32),
        job_valid=torch.ones(j, dtype=torch.bool),
        avail=torch.as_tensor(avail, dtype=torch.float32),
        totals=torch.as_tensor(totals, dtype=torch.float32),
        node_valid=torch.ones(n, dtype=torch.bool),
        feasible=torch.as_tensor(feasible))
    got = port_match.greedy_match(problem).assignment.numpy()
    assert (ref >= 0).sum() == (got >= 0).sum()
    w_ref = greedy.placed_weight(demands, ref >= 0)
    assert w_ref == pytest.approx(greedy.placed_weight(demands, got >= 0))


@pytest.mark.parametrize("seed", SEEDS)
def test_victim_search_matches_the_port(seed):
    rng = np.random.default_rng(seed)
    hosts, users = 12, 5
    share = (65536.0 * hosts / 50, 32.0 * hosts / 50, 1.0)
    running = []
    for k in range(80):
        running.append((f"t{k:03d}", f"u{rng.integers(users)}",
                        int(rng.choice([25, 50, 75])), int(rng.integers(5)),
                        int(rng.integers(hosts)), 8192.0, 4.0, 0.0))
    spare = np.zeros((hosts, 3), np.float32)
    params = {"safe_dru_threshold": 1.0, "min_dru_diff": 0.5,
              "max_preemption": 4}
    search = VictimSearch(running, spare, lambda u: share, gpu_mode=False,
                          params=params, failed_hosts={})
    # the port's search over the same rows, DRUs and spare
    n = len(search.host)
    state = port_rebalance.RebalanceState(
        task_host=torch.as_tensor(search.host, dtype=torch.int32),
        task_dru=torch.as_tensor(search.dru),
        task_res=torch.as_tensor(np.pad(search.res, ((0, 0), (0, 1)))),
        task_eligible=torch.as_tensor(search.elig),
        spare=torch.as_tensor(np.pad(spare, ((0, 0), (0, 1)))),
        host_ok=torch.ones(hosts, dtype=torch.bool))
    res = (16384.0, 8.0, 0.0)
    pending = np.float32(search._pending_dru("newcomer", 50, res))
    want = port_rebalance.find_preemption_decision(
        state, torch.tensor([*res, 0.0]), torch.tensor(pending),
        torch.tensor(1.0), torch.tensor(0.5))
    host, victims = search.decide("job-x", "newcomer", 50, res)
    assert host == int(want.host)
    mask = want.preempt_mask.numpy()
    assert sorted(victims) == sorted(search.row_ids[r]
                                     for r in np.flatnonzero(mask[:n]))
    assert victims, "the case preempts"
