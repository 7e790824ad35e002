"""The per-user launch rate limit of `cook_tpu_torch` against `cook_tpu`
on the CPU: tests/test_launch_ratelimit.py's case on both packages, the
same limit on the pool-batched and pipelined passes (the per-cycle
budget of the launch filter and the spend-through after each pool's
match), and the token bucket itself against the reference's."""
from types import SimpleNamespace

import pytest
import torch

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import ratelimit as ref_ratelimit
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import ratelimit as port_ratelimit
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(ent=ref_ent, store=ref_store, mock=ref_mock,
                      core=ref_core, extra={})
PORT = SimpleNamespace(ent=port_ent, store=port_store, mock=port_mock,
                       core=port_core, extra={"device": "cpu"})


def _rig(P, pools=("default",), jobs_per_user=10, users=("burster",)):
    """4 hosts of 8000 MB / 32 cpus per pool; each user submits
    `jobs_per_user` 100 MB / 1 cpu jobs in each pool; the limit is 60
    launches a minute with a burst of 3."""
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    hosts = []
    for pool in pools:
        store.set_pool(P.ent.Pool(name=pool))
        hosts += [P.mock.MockHost(node_id=f"{pool}-h{i}",
                                  hostname=f"{pool}-h{i}", mem=8000,
                                  cpus=32, pool=pool) for i in range(4)]
    cluster = P.mock.MockCluster("m", hosts, clock=clock)
    scheduler = P.core.Scheduler(
        store, [cluster],
        P.core.SchedulerConfig(user_launch_rate_per_minute=60.0,
                               user_launch_burst=3.0),
        **P.extra)
    e = P.ent
    store.submit_jobs([
        e.Job(uuid=f"{pool}-{user}-{i:02d}", user=user, pool=pool,
              priority=50, max_retries=1, command="true",
              resources=e.Resources(mem=100.0, cpus=1.0))
        for pool in pools for user in users for i in range(jobs_per_user)])
    return clock, store, scheduler


def _serial_cycles(P):
    """tests/test_launch_ratelimit.py:9: a burst of 3, then nothing while
    the bucket is empty, then 3 again once it refills (capped at the
    burst)."""
    clock, store, scheduler = _rig(P)
    pool = store.pools["default"]
    counts, placed = [], []
    for advance in (0, 0, 10_000):
        clock.advance(advance)
        scheduler.rank_cycle(pool)
        outcome = scheduler.match_cycle(pool)
        counts.append(len(outcome.matched))
        placed.append(sorted((j.uuid, o.hostname)
                             for j, o in outcome.matched))
    assert counts == [3, 0, 3]
    return placed


def test_user_launch_rate_limited_like_the_reference():
    assert _serial_cycles(PORT) == _serial_cycles(REF)


def _multi_pool_cycles(P, path):
    """Two pools, two users: each (user, pool) bucket admits its burst of
    3 in the first pass, none in the second, 3 after a 10 s refill; the
    spend-through after each pool's match drains the bucket on the
    multi-pool passes as on the serial one."""
    clock, store, scheduler = _rig(P, pools=("pa", "pb"),
                                   users=("u1", "u2"))
    placed = []
    for advance in (0, 0, 10_000):
        clock.advance(advance)
        for pool in store.pools.values():
            scheduler.rank_cycle(pool)
        if path == "batched":
            outcomes = scheduler.match_cycle_all_pools()
        else:
            outcomes = scheduler.match_cycle_pipelined()
        placed.append({name: sorted((j.uuid, o.hostname)
                                    for j, o in out.matched)
                       for name, out in outcomes.items()})
    assert [sum(len(v) for v in cycle.values()) for cycle in placed] \
        == [12, 0, 12]
    return placed


@pytest.mark.parametrize("path", ["batched", "pipelined"])
def test_multi_pool_passes_spend_through_like_the_reference(path):
    assert _multi_pool_cycles(PORT, path) == _multi_pool_cycles(REF, path)


def test_no_limit_means_no_launch_filter():
    _, _, scheduler = _rig(PORT)
    scheduler.launch_rate_limiter = None
    assert scheduler._make_launch_filter() is None


def test_token_bucket_matches_the_reference():
    """Refill at the rate, capped at the bucket; spend-through goes
    negative."""
    balances = []
    for mod in (ref_ratelimit, port_ratelimit):
        clock = FakeClock()
        bucket = mod.TokenBucketRateLimiter(
            tokens_replenished_per_minute=30.0, bucket_size=5.0,
            clock=clock)
        seen = [bucket.tokens_available("k")]
        bucket.spend("k", 7.0)
        seen.append(bucket.tokens_available("k"))
        for ms in (1_000, 4_000, 60_000):
            clock.advance(ms)
            seen.append(bucket.tokens_available("k"))
            bucket.spend("k")
        balances.append(seen)
    assert balances[0] == balances[1] == [5.0, -2.0, -1.5, -0.5, 5.0]
