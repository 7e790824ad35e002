"""The host-encode cache of `cook_tpu_torch` against `cook_tpu` on the CPU.

- `prepare_pool_problem` with and without the cache gives identical node
  encodings and feasibility masks over several cycles of a rig with
  attribute constraints, gpu hosts, failed-instance history, a group, a
  gang and a host reservation that lasts one cycle;
- the cache's node and row hits and misses equal the reference
  `EncodeCache`'s, cycle by cycle, on the same rig (both schedulers at
  their default configuration, so the event sequences are the same);
- each store event kind drops what the reference's drops (instance
  status, job state, pool move, the `_EPOCH_EVENTS` kinds) and nothing
  else;
- group and gang jobs are never cached;
- a reservation narrows this cycle's rows only: `feasibility` serves a
  fresh mask each call;
- estimated completion: the reference bypasses its cache while that
  constraint is active; the port has not got the constraint, so there is
  nothing to bypass on (its `MatchConfig` has no such knob).

Every count is an integer and every mask a boolean: all comparisons are
exact."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import encode_cache as ref_ec
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.utils import metrics as ref_metrics
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import encode_cache as port_ec
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.utils import metrics as port_metrics
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

REF = SimpleNamespace(ent=ref_ent, store=ref_store, mock=ref_mock,
                      core=ref_core, ec=ref_ec, matcher=ref_matcher,
                      metrics=ref_metrics, kw={})
PORT = SimpleNamespace(ent=port_ent, store=port_store, mock=port_mock,
                       core=port_core, ec=port_ec, matcher=port_matcher,
                       metrics=port_metrics, kw={"device": "cpu"})
CYCLES = 6
RESERVED_CYCLE = 3


def _hosts(P, n=12):
    return [P.mock.MockHost(
        node_id=f"h{i:02d}", hostname=f"h{i:02d}", mem=65536.0, cpus=32.0,
        gpus=4.0 if i % 4 == 0 else 0.0,
        attributes=(("zone", "a" if i % 3 else "b"),)) for i in range(n)]


def _jobs(P, rng, cycle, n=10):
    """One cycle's submits: plain jobs, zone-constrained jobs (zone "c"
    has no host: such a job waits, its row served from the cache while
    the offers keep their structure), gpu jobs, and (in cycle 1) a 2-gang
    and a balanced group.  No host ever fills, and the gpu hosts keep a
    free gpu, so the offer structure holds from cycle to cycle."""
    out, groups = [], []
    for i in range(n):
        kind = i % 5
        constraints = ()
        if kind in (1, 4):
            constraints = (P.ent.JobConstraint(
                attribute="zone", operator=P.ent.ConstraintOperator.EQUALS,
                pattern="a" if kind == 1 else "c"),)
        out.append(P.ent.Job(
            uuid=f"c{cycle}-{i}", user=f"u{i % 3}", command="x",
            pool="default", max_retries=3,
            expected_runtime_ms=int(rng.choice([30_000, 90_000])),
            constraints=constraints,
            resources=P.ent.Resources(
                mem=float(rng.choice([1024, 2048, 4096])),
                cpus=float(rng.choice([1.0, 2.0])),
                gpus=1.0 if kind == 2 else 0.0)))
    if cycle == 1:
        groups.append(P.ent.Group(
            uuid="gang", name="gang", host_placement=P.ent.HostPlacement(
                type=P.ent.GroupPlacementType.UNIQUE)))
        groups.append(P.ent.Group(
            uuid="spread", name="spread", host_placement=P.ent.HostPlacement(
                type=P.ent.GroupPlacementType.BALANCED, attribute="zone")))
        for k in range(2):
            out.append(P.ent.Job(
                uuid=f"gang-{k}", user="u0", command="x", pool="default",
                group_uuid="gang", gang_size=2,
                resources=P.ent.Resources(mem=1024.0, cpus=1.0)))
            out.append(P.ent.Job(
                uuid=f"spread-{k}", user="u1", command="x", pool="default",
                group_uuid="spread",
                resources=P.ent.Resources(mem=1024.0, cpus=1.0)))
    return out, groups


def _counts(P):
    reg = P.metrics.global_registry
    rows = reg.counter("match.encode_cache.rows")
    nodes = reg.counter("match.encode_cache.nodes")
    return (rows.value({"result": "hit"}), rows.value({"result": "miss"}),
            nodes.value({"result": "hit"}), nodes.value({"result": "miss"}))


def _rig(P, *, use_encode_cache=True):
    """CYCLES cycles of submit -> advance -> rank -> match.  A task fails
    in cycle 2 (failed-instance history: the novel-host constraint), and
    host h01 is reserved for an absent job in RESERVED_CYCLE only.
    Returns per cycle: (cache count deltas, [(attr codes, feasible)] of
    the prepares)."""
    rng = np.random.default_rng(11)
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster("m", _hosts(P), clock=clock)
    kw = {} if P is REF else {"use_columnar_index": True}
    scheduler = P.core.Scheduler(
        store, [cluster], P.core.SchedulerConfig(
            use_encode_cache=use_encode_cache, **kw), **P.kw)
    prepares = []
    solve = P.matcher.prepare_pool_problem

    def keep(*args, **kwargs):
        prepared = solve(*args, **kwargs)
        if prepared.nodes is not None:
            prepares.append((
                {k: v.copy() for k, v in prepared.nodes.attr_codes.items()},
                prepared.nodes.has_gpus.copy(), prepared.feasible.copy()))
        return prepared

    per_cycle = []
    pool = store.pools["default"]
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(P.matcher, "prepare_pool_problem", keep)
        for cycle in range(CYCLES):
            per_cycle.append(_rig_cycle(P, rng, cycle, store, clock,
                                        cluster, scheduler, pool))
    return per_cycle, prepares


def _rig_cycle(P, rng, cycle, store, clock, cluster, scheduler, pool):
    before = _counts(P)
    jobs, groups = _jobs(P, rng, cycle)
    store.submit_jobs(jobs, groups)
    clock.advance(30_000)
    cluster.advance_to(clock())
    if cycle == 2:
        live = [i for i in store.instances.values()
                if not i.status.terminal]
        store.update_instance_state(live[0].task_id,
                                    P.ent.InstanceStatus.FAILED,
                                    "container-preempted")
    scheduler.host_reservations = (
        {"h01": "absent-job"} if cycle == RESERVED_CYCLE else {})
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    return tuple(a - b for a, b in zip(_counts(P), before))


def _assert_prepares_equal(got, want):
    assert len(got) == len(want) == CYCLES
    for (codes_g, gpus_g, feas_g), (codes_w, gpus_w, feas_w) in zip(got,
                                                                    want):
        assert codes_g.keys() == codes_w.keys()
        for k in codes_w:
            np.testing.assert_array_equal(codes_g[k], codes_w[k])
        np.testing.assert_array_equal(gpus_g, gpus_w)
        np.testing.assert_array_equal(feas_g, feas_w)


def test_cache_on_and_off_prepare_identical_problems():
    counts, cached = _rig(PORT)
    _, plain = _rig(PORT, use_encode_cache=False)
    _assert_prepares_equal(cached, plain)
    # the rig exercised the cache: rows were served from it, nodes hit
    assert sum(c[0] for c in counts) > 0 and sum(c[2] for c in counts) > 0
    # the reservation closed h01 in its cycle only
    h01 = 1
    assert not cached[RESERVED_CYCLE][2][:, h01].any()
    assert cached[RESERVED_CYCLE + 1][2][:, h01].any()


def test_hit_and_miss_counts_equal_reference():
    want, want_prep = _rig(REF)
    got, got_prep = _rig(PORT)
    assert got == want
    _assert_prepares_equal(got_prep, want_prep)


def _direct(P, kind_events):
    """One pool, 4 offers, 3 jobs (one in a group): encode, serve the
    mask, apply `kind_events(store)`, serve again.  Returns the compute
    calls' job lists (the second call's are the second serve's recomputed
    rows)."""
    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    for name in ("default", "other"):
        store.set_pool(P.ent.Pool(name=name))
    cluster = P.mock.MockCluster("m", _hosts(P, 4), clock=clock)
    store.submit_jobs(
        [P.ent.Job(uuid=f"j{i}", user="u", command="x", pool="default",
                   resources=P.ent.Resources(mem=512.0, cpus=1.0))
         for i in range(2)]
        + [P.ent.Job(uuid="g0", user="u", command="x", pool="default",
                     group_uuid="grp",
                     resources=P.ent.Resources(mem=512.0, cpus=1.0))],
        [P.ent.Group(uuid="grp", name="grp")])
    cache = P.ec.EncodeCache(store)
    offers = [(cluster, o) for o in cluster.pending_offers("default")]
    jobs = [store.jobs[u] for u in ("j0", "j1", "g0")]
    calls = []

    def compute(subset, pre_rows):
        calls.append([j.uuid for j in subset])
        return np.ones((len(subset), len(offers)), dtype=bool)

    nodes, fp = cache.encoded_nodes("default", offers)
    cache.feasibility("default", jobs, nodes.n, fp, compute)
    kind_events(P, store, cache)
    _, fp2 = cache.encoded_nodes("default", offers)
    cache.feasibility("default", jobs, nodes.n, fp2, compute)
    return calls


def _event(P, kind, **data):
    return P.store.Event(seq=0, kind=kind, data=data)


EVENT_CASES = {
    # kind -> (apply(P, store, cache), the jobs whose rows recompute)
    "instance/status": (lambda P, s, c: c._on_event(_event(
        P, "instance/status", job="j0", task_id="t", status="failed")),
        {"j0"}),
    "job/state": (lambda P, s, c: c._on_event(_event(
        P, "job/state", uuid="j1", state="completed")), {"j1"}),
    "job/pool-moved (store)": (
        lambda P, s, c: s.move_job_pool("j0", "other"), {"j0"}),
    "kill (store)": (lambda P, s, c: s.kill_jobs(["j1"]), {"j1"}),
    "quota/set (store)": (lambda P, s, c: s.set_quota(P.ent.Quota(
        user="u", pool="default",
        resources=P.ent.Resources(mem=1.0, cpus=1.0))), {"j0", "j1"}),
    "share/set (store)": (lambda P, s, c: s.set_share(P.ent.Share(
        user="u", pool="default",
        resources=P.ent.Resources(mem=1.0, cpus=1.0))), {"j0", "j1"}),
    "pool/set (store)": (lambda P, s, c: s.set_pool(P.ent.Pool(
        name="third")), {"j0", "j1"}),
    "instance/cancelled": (lambda P, s, c: c._on_event(_event(
        P, "instance/cancelled", job="j0", task_id="t")), set()),
    "job/created": (lambda P, s, c: c._on_event(_event(
        P, "job/created", uuid="j0")), set()),
    "clear": (lambda P, s, c: c.clear(), {"j0", "j1"}),
}
# every epoch kind, also those the port's store never emits
for _kind in sorted(ref_ec._EPOCH_EVENTS):
    EVENT_CASES[_kind] = (
        lambda P, s, c, _k=_kind: c._on_event(_event(P, _k)),
        {"j0", "j1"})


@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_each_event_kind_invalidates_like_the_reference(case):
    apply, fresh = EVENT_CASES[case]
    assert port_ec._EPOCH_EVENTS == ref_ec._EPOCH_EVENTS
    got_calls = _direct(PORT, apply)
    want_calls = _direct(REF, apply)
    assert got_calls == want_calls
    # the first serve computes every row; the second only the rows the
    # event invalidated
    assert got_calls[0] == ["j0", "j1", "g0"]
    assert set(got_calls[1]) - {"g0"} == fresh
    # the group member is never cached: it is computed on every serve
    assert all("g0" in call for call in got_calls)


def test_group_and_gang_jobs_are_never_cached():
    for P in (REF, PORT):
        grouped = P.ent.Job(uuid="a", user="u", group_uuid="g")
        gang = P.ent.Job(uuid="b", user="u", group_uuid="g2", gang_size=2)
        plain = P.ent.Job(uuid="c", user="u")
        assert not P.ec.EncodeCache.cacheable_job(grouped)
        assert not P.ec.EncodeCache.cacheable_job(gang)
        assert P.ec.EncodeCache.cacheable_job(plain)


def test_feasibility_serves_a_fresh_mask_each_call():
    """The matcher narrows the served mask in place (host reservations):
    what it writes must not reach the cached rows."""
    for P in (REF, PORT):
        clock = FakeClock()
        store = P.store.JobStore(clock=clock)
        store.set_pool(P.ent.Pool(name="default"))
        store.submit_jobs([P.ent.Job(
            uuid="j", user="u", pool="default",
            resources=P.ent.Resources(mem=1.0, cpus=1.0))])
        cache = P.ec.EncodeCache(store)
        cluster = P.mock.MockCluster("m", _hosts(P, 3), clock=clock)
        offers = [(cluster, o) for o in cluster.pending_offers("default")]
        nodes, fp = cache.encoded_nodes("default", offers)
        jobs = [store.jobs["j"]]

        def compute(subset, pre_rows):
            return np.ones((len(subset), nodes.n), dtype=bool)

        first = cache.feasibility("default", jobs, nodes.n, fp, compute)
        first[:, 1] = False                 # a reservation closes host 1
        second = cache.feasibility("default", jobs, nodes.n, fp, compute)
        assert second.all(), P
        assert second is not first


LRU_ROWS = 3
# (window of job uuids, events applied before it is served)
LRU_STEPS = [
    (["a", "b"], []),
    (["a", "b", "c", "d"], []),           # past the bound: "a" goes
    (["a", "c", "g"], []),                # "g" is a group member
    (["b", "d", "e"], [("job/state", {"uuid": "d"})]),
    (["c", "e", "a"], [("quota/set", {})]),   # epoch: all recompute
    (["e", "a", "b", "c"], []),
    ([], []),
    (["f", "e", "c"], [("instance/status", {"job": "e"})]),
]


def _lru_run(P, cache, n_nodes):
    """Serve LRU_STEPS through `cache`; returns each step's computed job
    lists and served mask.  Rows are made from a seed, one per job, so a
    served row shows which job's row it is."""
    rng = np.random.default_rng(7)
    table = {u: rng.random(n_nodes) < 0.5 for u in "abcdefg"}
    clock = FakeClock()
    cluster = P.mock.MockCluster("m", _hosts(P, n_nodes), clock=clock)
    offers = [(cluster, o) for o in cluster.pending_offers("default")]
    out = []
    for window, events in LRU_STEPS:
        for kind, data in events:
            cache._on_event(_event(P, kind, **data))
        calls = []

        def compute(subset, pre_rows):
            calls.append([j.uuid for j in subset])
            return np.stack([table[j.uuid] for j in subset]) if subset \
                else np.zeros((0, n_nodes), dtype=bool)

        jobs = [P.ent.Job(uuid=u, user="u",
                          group_uuid="grp" if u == "g" else None)
                for u in window]
        nodes, fp = cache.encoded_nodes("default", offers)
        mask = cache.feasibility("default", jobs, nodes.n, fp, compute)
        out.append((calls, mask.tolist()))
        if window:
            np.testing.assert_array_equal(
                mask, np.stack([table[u] for u in window]))
    return out


@pytest.mark.parametrize("slack", [0, 4096])
@pytest.mark.parametrize("n_nodes", [5, 8, 13])
def test_lru_bound_and_served_rows_match_the_reference(monkeypatch,
                                                       n_nodes, slack):
    """The port's row blocks against the reference's per-job rows: the
    same rows recompute at every step (the LRU bound, drops, an epoch
    bump, a group member, an empty window) and the served masks are
    equal.  The slot arrays start at 2 so they grow mid-run; with no
    compaction slack the blocks are compacted whenever they hold more
    than twice the live rows."""
    monkeypatch.setattr(port_ec, "MAX_ROWS_PER_POOL", LRU_ROWS)
    monkeypatch.setattr(port_ec, "_MIN_SLOTS", 2)
    monkeypatch.setattr(port_ec, "_COMPACT_SLACK", slack)
    want = _lru_run(REF, REF.ec.EncodeCache(max_rows_per_pool=LRU_ROWS),
                    n_nodes)
    cache = PORT.ec.EncodeCache()
    got = _lru_run(PORT, cache, n_nodes)
    assert got == want
    entry = cache._pools["default"]
    assert sum(entry.live.values()) == len(entry.slot_of) <= LRU_ROWS
    if slack == 0:
        assert sum(len(b) for b in entry.blocks.values()) <= 2 * len(
            entry.slot_of)


COMPACT_STEPS = [
    (list("abcdefg"), []),
    # five of the first block's seven rows drop
    (["h"], [("job/state", {"uuid": u}) for u in "abcde"]),
    (["f", "g", "h", "i"], []),
    (["i", "g", "f", "h"], [("instance/status", {"job": "g"})]),
]


def _compact_run(P, cache, n_nodes=11):
    rng = np.random.default_rng(5)
    table = {u: rng.random(n_nodes) < 0.5 for u in "abcdefghi"}
    cluster = P.mock.MockCluster("m", _hosts(P, n_nodes), clock=FakeClock())
    offers = [(cluster, o) for o in cluster.pending_offers("default")]
    out = []
    for window, events in COMPACT_STEPS:
        for kind, data in events:
            cache._on_event(_event(P, kind, **data))
        calls = []

        def compute(subset, pre_rows):
            calls.append([j.uuid for j in subset])
            return np.stack([table[j.uuid] for j in subset])

        jobs = [P.ent.Job(uuid=u, user="u") for u in window]
        nodes, fp = cache.encoded_nodes("default", offers)
        mask = cache.feasibility("default", jobs, nodes.n, fp, compute)
        np.testing.assert_array_equal(mask,
                                      np.stack([table[u] for u in window]))
        out.append(calls)
    return out


def test_row_blocks_compact_and_serve_the_same_rows(monkeypatch):
    """Rows of dropped jobs leave their blocks behind until the blocks
    hold more than twice the live rows (plus `_COMPACT_SLACK`, 0 here):
    then the live rows move into one block.  The rows served and the
    rows recomputed stay the reference's throughout."""
    monkeypatch.setattr(port_ec, "_COMPACT_SLACK", 0)
    compactions = []
    compact = port_ec._PoolEntry._compact

    def counted(self):
        compactions.append(sum(len(b) for b in self.blocks.values()))
        compact(self)

    monkeypatch.setattr(port_ec._PoolEntry, "_compact", counted)
    cache = PORT.ec.EncodeCache()
    got = _compact_run(PORT, cache)
    assert got == _compact_run(REF, REF.ec.EncodeCache())
    # the second step's store found 8 rows held for 3 live ones
    assert compactions == [8]
    entry = cache._pools["default"]
    assert sum(len(b) for b in entry.blocks.values()) <= 2 * len(
        entry.slot_of)


@pytest.mark.parametrize("n_nodes,pad", [(5, (3, 3)), (13, (0, 3)),
                                         (13, (2, 0)), (8, (4, 8)),
                                         (16, (0, 0))])
def test_padded_serve_is_the_mask_padded_with_false(n_nodes, pad):
    """`pad_shape` (the solve's padded mask, built from the packed rows)
    against the unpadded serve of the same steps: the [:J, :N] view is
    the mask, the padding is False, and the padded serve is fresh too."""
    clock = FakeClock()
    cluster = port_mock.MockCluster("m", _hosts(PORT, n_nodes), clock=clock)
    offers = [(cluster, o) for o in cluster.pending_offers("default")]
    rng = np.random.default_rng(11)
    table = {u: rng.random(n_nodes) < 0.5 for u in "abcde"}

    def compute(subset, pre_rows):
        return np.stack([table[j.uuid] for j in subset])

    plain, padded = port_ec.EncodeCache(), port_ec.EncodeCache()
    for window in (["a", "b"], ["a", "b", "c"], ["c", "a"], ["d", "e"]):
        jobs = [port_ent.Job(uuid=u, user="u") for u in window]
        shape = (len(jobs) + pad[0], n_nodes + pad[1])
        nodes, fp = plain.encoded_nodes("default", offers)
        want = plain.feasibility("default", jobs, nodes.n, fp, compute)
        nodes, fp = padded.encoded_nodes("default", offers)
        got = padded.feasibility("default", jobs, nodes.n, fp, compute,
                                 pad_shape=shape)
        assert got.shape == shape and got.dtype == bool
        np.testing.assert_array_equal(got[:len(jobs), :n_nodes], want)
        assert not got[len(jobs):].any() and not got[:, n_nodes:].any()
        got[:] = False                    # must not reach the cache
    again = padded.feasibility("default", jobs, nodes.n, fp, compute,
                               pad_shape=shape)
    np.testing.assert_array_equal(again[:len(jobs), :n_nodes], want)


def test_estimated_completion_bypasses_the_reference_cache_only():
    """Neither package serves a row from its cache while the estimated-
    completion constraint is active (rows become clock-dependent), and
    both place the job; with the constraint off the same cycle goes
    through the cache.  (Until the port had the constraint, only the
    reference's cache stood aside: hence the name.)"""
    for P in (REF, PORT):
        for constrained in (True, False):
            clock = FakeClock()
            store = P.store.JobStore(clock=clock)
            store.set_pool(P.ent.Pool(name="default"))
            cluster = P.mock.MockCluster("m", _hosts(P, 3), clock=clock)
            store.submit_jobs([P.ent.Job(
                uuid="j", user="u", pool="default",
                expected_runtime_ms=60_000,
                resources=P.ent.Resources(mem=1.0, cpus=1.0))])
            match = (P.matcher.MatchConfig(completion_multiplier=1.5,
                                           host_lifetime_mins=60.0)
                     if constrained else P.matcher.MatchConfig())
            scheduler = P.core.Scheduler(store, [cluster],
                                         P.core.SchedulerConfig(match=match),
                                         **P.kw)
            before = _counts(P)
            pool = store.pools["default"]
            scheduler.rank_cycle(pool)
            outcome = scheduler.match_cycle(pool)
            assert [j.uuid for j, _ in outcome.matched] == ["j"]
            assert (_counts(P) == before) == constrained


def test_a_reservation_does_not_leak_into_the_next_cycles_rows():
    """Three prepares of one unchanged pool through the cache: without a
    reservation, with h01 reserved for another job, without again.  The
    second and third serve every row from the cache; the reservation
    closes h01 in the second only, and each mask equals the uncached
    prepare's."""
    for P in (REF, PORT):
        clock = FakeClock()
        store = P.store.JobStore(clock=clock)
        store.set_pool(P.ent.Pool(name="default"))
        cluster = P.mock.MockCluster("m", _hosts(P, 6), clock=clock)
        jobs, _ = _jobs(P, np.random.default_rng(3), 0)
        store.submit_jobs(jobs)
        scheduler = P.core.Scheduler(store, [cluster], **P.kw)
        pool = store.pools["default"]
        queue = scheduler.rank_cycle(pool)
        config = P.matcher.MatchConfig()
        cache = P.ec.EncodeCache(store)
        masks = []
        for cycle, reserved in enumerate(({}, {"h01": "other-job"}, {})):
            served = []
            for encode_cache in (cache, None):
                state = P.matcher.PoolMatchState(num_considerable=1000)
                before = _counts(P)
                prepared = P.matcher.prepare_pool_problem(
                    store, pool, queue, [cluster], config, state,
                    host_reservations=reserved, encode_cache=encode_cache,
                    **P.kw)
                served.append(prepared.feasible)
                if encode_cache is not None:
                    hits, misses = (np.subtract(_counts(P), before)[:2])
                    want = ((0, len(jobs)) if cycle == 0
                            else (len(jobs), 0))
                    assert (hits, misses) == want, (P, cycle)
            np.testing.assert_array_equal(served[0], served[1])
            masks.append(served[0])
        assert masks[0][:, 1].any() and not masks[1][:, 1].any()
        np.testing.assert_array_equal(masks[2], masks[0])
