"""The gang slice of `cook_tpu_torch` against `cook_tpu` on the CPU.

- `ops/gang.py`: the torch `gang_filter`, `release_assignments` and
  `block_free_hosts` equal the JAX ones on fuzzed inputs (exact); the
  numpy twins equal the reference twins, the vectorised `np_gang_repair`
  included (feasibility masks, `nodes_per_block` 0 and > 0, ragged last
  blocks);
- the all-or-nothing property of tests/test_gang.py:109 on the port's
  serial, batched (chunked), pipelined (`match_cycle_pipelined`) and
  hierarchical match paths, each beside the reference on the same rig
  with the same placements;
- the store's gang-submit invariants, drain-vs-kill admission and the
  scheduler's admission cycle (tests/test_gang.py:234-421);
- a gang that can only place partly places nothing in either package (a
  fault the port had before its gang chokepoint).

Every input is exact in float32 (MB in multiples of 50, whole cpus), so
no tolerance applies."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cook_tpu.cluster import mock as ref_mock
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.ops import gang as ref_gang
from cook_tpu.scheduler import core as ref_core
from cook_tpu.scheduler import gang as ref_sgang
from cook_tpu.scheduler import matcher as ref_matcher
from cook_tpu.scheduler import rebalancer as ref_rb
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.ops import gang as port_gang
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.scheduler import flight_recorder as port_flight
from cook_tpu_torch.scheduler import gang as port_sgang
from cook_tpu_torch.scheduler import matcher as port_matcher
from cook_tpu_torch.scheduler import rebalancer as port_rb
from tests.conftest import FakeClock

# one intra-op thread: the suite runs several pytest-xdist workers side
# by side, and idle OpenMP threads spinning in each would crowd them
torch.set_num_threads(1)

BLOCK_HOSTS = 4


# ------------------------------------------------ ops/gang: device code


def _fuzz_gangs(rng, j, n, g):
    gang_id = rng.integers(-1, g, size=j).astype(np.int32)
    gang_need = np.zeros(j, dtype=np.int32)
    for k in range(g):
        rows = gang_id == k
        if rows.any():
            gang_need[rows] = rng.integers(2, 5)
    assignment = rng.integers(-1, n, size=j).astype(np.int32)
    return assignment, gang_id, gang_need


@pytest.mark.parametrize("npb", [0, 1, 4, 8])
@pytest.mark.parametrize("seed", [7, 8])
def test_gang_filter_matches_reference_fuzz(seed, npb):
    """tests/test_gang.py:153 against the port: 25 draws of 12 rows over 8
    nodes and 3 gang slots (the JAX filter compiles once per shape), and
    the numpy twins of both packages."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        assignment, gang_id, gang_need = _fuzz_gangs(rng, 12, 8, 3)
        want_a, want_s = ref_gang.gang_filter(
            jnp.asarray(assignment), jnp.asarray(gang_id),
            jnp.asarray(gang_need), num_gangs=3, num_nodes=8,
            nodes_per_block=npb)
        got_a, got_s = port_gang.gang_filter(
            torch.as_tensor(assignment), torch.as_tensor(gang_id),
            torch.as_tensor(gang_need), num_gangs=3, num_nodes=8,
            nodes_per_block=npb)
        assert got_a.dtype == torch.int32 and got_s.dtype == torch.bool
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
        np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
        np_a, np_s = port_gang.np_gang_filter(assignment, gang_id,
                                              gang_need, npb)
        ref_a, ref_s = ref_gang.np_gang_filter(assignment, gang_id,
                                               gang_need, npb)
        np.testing.assert_array_equal(np_a, ref_a)
        np.testing.assert_array_equal(np_s, ref_s)
        np.testing.assert_array_equal(np_a, got_a.numpy())


def test_gang_filter_occupancy_is_a_max_not_a_last_write():
    """Two members on one host and a third unplaced row of the same gang
    (clipped to node 0): the unplaced row must not clear the host the
    placed rows set, nor count as a host."""
    assignment = np.array([0, 0, -1, 3, 2], dtype=np.int32)
    gang_id = np.array([0, 0, 0, 1, 1], dtype=np.int32)
    gang_need = np.array([3, 3, 3, 2, 2], dtype=np.int32)
    got_a, got_s = port_gang.gang_filter(
        torch.as_tensor(assignment), torch.as_tensor(gang_id),
        torch.as_tensor(gang_need), num_gangs=2, num_nodes=4,
        nodes_per_block=4)
    want_a, want_s = ref_gang.gang_filter(
        jnp.asarray(assignment), jnp.asarray(gang_id),
        jnp.asarray(gang_need), num_gangs=2, num_nodes=4, nodes_per_block=4)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_a.tolist() == [-1, -1, -1, 3, 2]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_release_assignments_matches_reference_fuzz(seed):
    rng = np.random.default_rng(seed)
    j, n, r = 40, 16, 4
    avail = (rng.integers(0, 64, (n, r)) * 512.0).astype(np.float32)
    demands = np.stack([rng.choice([512, 1024, 2048], j),
                        rng.choice([0.5, 1, 2], j),
                        rng.integers(0, 2, j), np.zeros(j)],
                       -1).astype(np.float32)
    assignment = rng.integers(-1, n, j).astype(np.int32)
    mask = (rng.uniform(size=j) < 0.5) & (assignment >= 0)
    want = ref_gang.release_assignments(
        *map(jnp.asarray, (avail, demands, assignment, mask)))
    got = port_gang.release_assignments(
        *map(torch.as_tensor, (avail, demands, assignment, mask)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("npb", [2, 4, 8])
def test_block_free_hosts_matches_reference(npb):
    rng = np.random.default_rng(11 + npb)
    avail = (rng.integers(0, 20, size=(8, 2)) * 50.0).astype(np.float32)
    node_valid = rng.random(8) > 0.3
    demand = np.array([400.0, 2.0], dtype=np.float32)
    want = ref_gang.block_free_hosts(
        jnp.asarray(avail), jnp.asarray(node_valid), jnp.asarray(demand),
        nodes_per_block=npb)
    got = port_gang.block_free_hosts(
        torch.as_tensor(avail), torch.as_tensor(node_valid),
        torch.as_tensor(demand), nodes_per_block=npb)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        port_gang.np_block_free_hosts(avail, node_valid, demand, npb),
        np.asarray(want))


@pytest.mark.parametrize("npb", [0, 3, 4, 5])
def test_np_block_free_hosts_matches_reference_ragged(npb):
    """The host twin tolerates a short last block (10 hosts)."""
    rng = np.random.default_rng(npb)
    avail = (rng.integers(0, 20, size=(10, 2)) * 50.0).astype(np.float32)
    node_valid = rng.random(10) > 0.2
    demand = np.array([300.0, 1.0], dtype=np.float32)
    np.testing.assert_array_equal(
        port_gang.np_block_free_hosts(avail, node_valid, demand, npb),
        ref_gang.np_block_free_hosts(avail, node_valid, demand, npb))


def _repair_case(rng, j, n, g, masked):
    gang_id = np.full(j, -1, dtype=np.int32)
    gang_need = np.zeros(j, dtype=np.int32)
    row = 0
    for k in range(g):
        size = int(rng.integers(2, 5))
        # a gang may miss members (fewer rows than its need)
        rows = min(j - row, size - int(rng.uniform() < 0.15))
        gang_id[row:row + rows] = k
        gang_need[row:row + rows] = size
        row += rows
    perm = rng.permutation(j)
    gang_id, gang_need = gang_id[perm], gang_need[perm]
    # stacked, block-split, partial and whole placements alike
    assignment = np.where(rng.uniform(size=j) < 0.7,
                          rng.integers(0, n, j), -1).astype(np.int32)
    demands = np.stack([rng.choice([100.0, 200.0, 300.0], j),
                        rng.choice([1.0, 2.0], j)], -1)
    avail = np.stack([rng.integers(2, 12, n) * 100.0,
                      rng.integers(1, 8, n) * 1.0], -1).astype(np.float32)
    feasible = rng.uniform(size=(j, n)) < 0.8 if masked else None
    return assignment, gang_id, gang_need, demands, avail, feasible


@pytest.mark.parametrize("masked", [False, True], ids=["free", "masked"])
@pytest.mark.parametrize("npb", [0, 3, 4, 5])
def test_np_gang_repair_matches_reference_fuzz(npb, masked):
    """The vectorised node scan gives the reference twin's assignment,
    member order and block order: 60 draws of 24 rows over 10 hosts (the
    last block ragged for npb 3 and 4), 5 gangs of 2-4, some short of
    members."""
    rng = np.random.default_rng(100 + npb + 10 * masked)
    repaired = 0
    for _ in range(60):
        case = _repair_case(rng, 24, 10, 5, masked)
        want = ref_gang.np_gang_repair(*case, npb)
        got = port_gang.np_gang_repair(*case, npb)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        repaired += int(((got >= 0) & (case[0] < 0)).sum())
    assert repaired > 0  # the fuzz exercises real repairs


def test_np_gang_repair_reference_cases():
    """tests/test_gang.py:185-226 on the port's twin: a stacked gang
    spreads over distinct hosts of one block, a block-split gang rehomes,
    an impossible gang stays unplaced, non-gang rows never move."""
    out = port_gang.np_gang_repair(
        np.array([0, 0, 0, 5], np.int32), np.array([0, 0, 0, -1], np.int32),
        np.array([3, 3, 3, 0], np.int32), np.full((4, 2), 100.0),
        np.full((8, 2), 1000.0), None, 4)
    assert np.unique(out[:3]).size == 3 and np.unique(out[:3] // 4).size == 1
    assert out[3] == 5
    out = port_gang.np_gang_repair(
        np.array([0, 4], np.int32), np.array([0, 0], np.int32),
        np.array([2, 2], np.int32), np.full((2, 2), 100.0),
        np.full((8, 2), 1000.0), None, 4)
    assert (out >= 0).all() and np.unique(out // 4).size == 1
    avail = np.zeros((8, 2))
    avail[0] = avail[1] = 1000.0
    out = port_gang.np_gang_repair(
        np.array([0, 1, -1], np.int32), np.zeros(3, np.int32),
        np.full(3, 3, np.int32), np.full((3, 2), 100.0), avail, None, 4)
    assert (out == -1).all()


# ------------------------------------- the matcher's gang inputs


def test_gang_context_matches_reference():
    def jobs(e):
        out = []
        for i, (group, k) in enumerate([("b", 2), (None, 0), ("a", 3),
                                        ("b", 2), ("c", 2), ("a", 3)]):
            out.append(e.Job(uuid=f"j{i}", user="u", pool="default",
                             group_uuid=group, gang_size=k))
        return out
    for enabled in (True, False):
        got = port_matcher.gang_context(
            jobs(port_ent), port_matcher.MatchConfig(gang_enabled=enabled))
        want = ref_matcher.gang_context(
            jobs(ref_ent), ref_matcher.MatchConfig(gang_enabled=enabled))
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if g is not None:
                np.testing.assert_array_equal(g, w)
    # dense ids in the order the groups first appear: b, a, c
    assert port_matcher.gang_context(jobs(port_ent),
                                     port_matcher.MatchConfig())[0] \
        .tolist() == [0, -1, 1, 0, 2, 1]
    assert port_matcher.gang_context(
        [port_ent.Job(uuid="x", user="u")], port_matcher.MatchConfig()) \
        == (None, None)


@pytest.mark.parametrize("block_hosts", [0, 3, 4])
def test_topology_bonus_matches_reference(block_hosts):
    def bonus(P, matcher):
        cluster = P.mock.MockCluster("m", [
            P.mock.MockHost(node_id=f"h{i}", hostname=f"h{i}",
                            mem=1000.0, cpus=8.0) for i in range(10)],
            clock=FakeClock())
        # hosts used to different degrees
        offers = [dataclasses.replace(o, mem=1000.0 - 100.0 * (i % 4),
                                      total_mem=1000.0)
                  for i, o in enumerate(cluster.pending_offers("default"))]
        encode = P.encode_nodes
        return matcher.topology_bonus(
            encode(offers), matcher.MatchConfig(
                topology_weight=0.5, topology_block_hosts=block_hosts))
    got, want = bonus(PORT, port_matcher), bonus(REF, ref_matcher)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert port_matcher.topology_bonus(
        PORT.encode_nodes([]), port_matcher.MatchConfig(
            topology_weight=0.5)) is None


# -------------------------------- all-or-nothing across the match paths


def _pkg(ent, store, mock, core, matcher, sgang, rb, constraints,
         **extra):
    return SimpleNamespace(ent=ent, JobStore=store.JobStore, mock=mock,
                           core=core, matcher=matcher, sgang=sgang, rb=rb,
                           encode_nodes=constraints.encode_nodes,
                           Vetoed=store.TransactionVetoed, extra=extra)


def _packages():
    from cook_tpu.scheduler import constraints as ref_cons
    from cook_tpu_torch.scheduler import constraints as port_cons
    return (_pkg(ref_ent, ref_store, ref_mock, ref_core, ref_matcher,
                 ref_sgang, ref_rb, ref_cons),
            _pkg(port_ent, port_store, port_mock, port_core, port_matcher,
                 port_sgang, port_rb, port_cons, device="cpu"))


REF, PORT = _packages()
PKGS = (REF, PORT)
# "batched" runs the chunked matcher on the best_node backend (the flat
# slice's route); "batched-xla" on the default top-kc candidate lists,
# where the reference's `approx_max_k` breaks ties among equal hosts in
# another order than the port's exact first-index top-kc (on 8 empty
# hosts it lists host 1 first): both packages hold the property there,
# on different hosts
PATHS = ("serial", "batched", "batched-xla", "pipelined", "hierarchical")


def _hosts(P, n, mem=1000.0, cpus=8.0):
    """Hosts h0..h{n-1}, zero-padded so that the sorted hostnames (gang
    admission's blocks) keep the offer order (the matcher's blocks)."""
    names = [f"h{i:0{len(str(n - 1))}d}" for i in range(n)]
    return [P.mock.MockHost(node_id=h, hostname=h, mem=mem, cpus=cpus,
                            attributes=(("slot", h),)) for h in names]


def _job(P, uuid, user="alice", mem=100.0, cpus=1.0, priority=50,
         pool="default", **kw):
    e = P.ent
    return e.Job(uuid=uuid, user=user, pool=pool, priority=priority,
                 max_retries=1, command="true",
                 resources=e.Resources(mem=mem, cpus=cpus), **kw)


def _pinned(P, host, mem=800.0, user="filler", **kw):
    e = P.ent
    return _job(P, f"pin-{host}", user=user, mem=mem, priority=100,
                constraints=(e.JobConstraint(
                    "slot", e.ConstraintOperator.EQUALS, host),), **kw)


def _gang_jobs(P, group, k, mem=500.0, user="ganguser", **kw):
    return [_job(P, f"{group}-m{i}", user=user, mem=mem, gang_size=k,
                 group_uuid=group, **kw) for i in range(k)]


def _gang_group(P, group):
    e = P.ent
    return e.Group(uuid=group, name=f"gang-{group}",
                   host_placement=e.HostPlacement(
                       type=e.GroupPlacementType.UNIQUE))


def _placed_hosts(store, group):
    out = []
    for uuid in store.groups[group].job_uuids:
        for inst in store.job_instances(uuid):
            if not inst.status.terminal:
                out.append(inst.hostname)
    return out


def _block(hostname):
    return int(hostname[1:]) // BLOCK_HOSTS


def _path_config(P, path):
    kw = dict(gang_enabled=True, topology_block_hosts=BLOCK_HOSTS)
    if path == "batched":
        kw.update(chunk=4, backend="pallas")
    elif path == "batched-xla":
        kw["chunk"] = 4
    elif path == "hierarchical":
        kw["hierarchical_threshold"] = 1
        kw["hierarchical_nodes_per_block"] = BLOCK_HOSTS
        if P is REF:
            kw["hierarchical_use_mesh"] = False
    return P.core.SchedulerConfig(match=P.matcher.MatchConfig(**kw))


def _scheduler(P, store, clusters, config):
    return P.core.Scheduler(store, clusters, config, **P.extra)


def _property_run(P, path):
    """tests/test_gang.py:109's rig: 8 hosts in blocks of 4, fillers pin
    h1, h3-h6, leaving {h0, h2} free in block 0 and {h7} in block 1; a
    3-gang must wait while a 2-gang lands whole, then the 3-gang lands
    whole in block 1 once the fillers drain.  Returns each cycle's
    placements (job -> host)."""
    clock = FakeClock()
    store = P.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster("m", _hosts(P, 8), clock=clock)
    scheduler = _scheduler(P, store, [cluster], _path_config(P, path))
    pool = store.pools["default"]
    placements = []

    def cycle():
        scheduler.rank_cycle(pool)
        if path == "pipelined":
            outcome = scheduler.match_cycle_pipelined()["default"]
        else:
            outcome = scheduler.match_cycle(pool)
        placements.append(sorted((j.uuid, o.hostname)
                                 for j, o in outcome.matched))

    busy = ("h1", "h3", "h4", "h5", "h6")
    store.submit_jobs([_pinned(P, h, expected_runtime_ms=60_000)
                       for h in busy])
    cycle()
    assert len(placements[-1]) == len(busy)
    store.submit_jobs(_gang_jobs(P, "gang-a", 3), [_gang_group(P, "gang-a")])
    store.submit_jobs(_gang_jobs(P, "gang-b", 2), [_gang_group(P, "gang-b")])
    cycle()
    placed_b = _placed_hosts(store, "gang-b")
    assert sorted(placed_b) == ["h0", "h2"]
    assert _placed_hosts(store, "gang-a") == []
    clock.advance(70_000)
    cluster.advance_to(clock())
    cycle()
    placed_a = _placed_hosts(store, "gang-a")
    assert len(placed_a) == 3 == len(set(placed_a))
    assert len({_block(h) for h in placed_a}) == 1
    return placements


@pytest.mark.parametrize("path", PATHS)
def test_gang_never_partially_places_like_the_reference(path, monkeypatch):
    """The acceptance property on the port's serial, batched, pipelined
    and hierarchical paths, with the reference's placements cycle by cycle
    (`_property_run` asserts the property itself).

    On the hierarchical path the reference's `hierarchical_match` raises
    on this rig (it fills gang rows up to the padded problem's 64 rows
    from the 5-row window) and its device-fallback ladder solves those
    cycles with the exact CPU greedy; the port routes the gangs through
    its two-level solve (checked here by its stats), with the same
    placements."""
    from cook_tpu_torch.ops import hierarchical as port_hier

    solves = []
    solve = port_hier.hierarchical_match

    def keep(*args, **kwargs):
        out = solve(*args, **kwargs)
        solves.append(out[1])
        return out

    monkeypatch.setattr(port_hier, "hierarchical_match", keep)
    got, want = _property_run(PORT, path), _property_run(REF, path)
    if path != "batched-xla":
        assert got == want
    if path == "hierarchical":
        gangs = [st["gangs"] for st in solves if "gangs" in st]
        assert len(gangs) == 2 and all(st["coarse_backend"] == "xla"
                                       for st in solves)
        assert [g["placed"] for g in gangs] == [1, 1]


def _one_host_gang(P):
    """One 1000 MB / 8 cpu host; two 500 MB / 1 cpu members of a UNIQUE
    2-gang; the default SchedulerConfig; one rank and one match cycle."""
    clock = FakeClock()
    store = P.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster("m", [P.mock.MockHost(
        node_id="h0", hostname="h0", mem=1000.0, cpus=8.0)], clock=clock)
    scheduler = _scheduler(P, store, [cluster], None)
    store.submit_jobs(_gang_jobs(P, "grp", 2, mem=500.0),
                      [_gang_group(P, "grp")])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    outcome = scheduler.match_cycle(pool)
    return outcome, scheduler


def test_a_gang_that_fits_one_host_only_places_nothing():
    """Both members fit the one host, but UNIQUE asks for two: the
    reference matches 0 jobs, and so must the port (it matched 1 before
    its gang chokepoint)."""
    for P in PKGS:
        outcome, scheduler = _one_host_gang(P)
        assert len(outcome.matched) == 0, P
        assert len(outcome.unmatched) == 2
    reasons = set(scheduler.placement_failures.values())
    assert reasons == {port_flight.REASON_TEXT[port_flight.GANG_INCOMPLETE]
                       + " (best block had 1/2 hosts free)"}


def test_gang_metrics_count_considered_placed_and_blocked():
    from cook_tpu_torch.utils.metrics import global_registry

    def value(name, **labels):
        return global_registry.counter(name).value(
            {"pool": "default", **labels})

    before = (value("gang.considered"), value("gang.placed"),
              value("gang.blocked", reason="no-block-capacity"))
    _one_host_gang(PORT)
    after = (value("gang.considered"), value("gang.placed"),
             value("gang.blocked", reason="no-block-capacity"))
    assert [a - b for a, b in zip(after, before)] == [1, 0, 1]


def test_a_gang_member_that_fails_to_transact_rolls_back_its_siblings():
    """A cluster that may launch one task this cycle: the gang's first
    member transacts, the second hits the launch cap, and the first is
    rolled back (mea-culpa launch-failed), as in the reference."""
    def run(P):
        clock = FakeClock()
        store = P.JobStore(clock=clock)
        store.set_pool(P.ent.Pool(name="default"))
        cluster = P.mock.MockCluster("m", _hosts(P, 4), clock=clock)
        cluster.max_launchable = lambda: 1
        scheduler = _scheduler(P, store, [cluster], None)
        store.submit_jobs(_gang_jobs(P, "g", 2), [_gang_group(P, "g")])
        pool = store.pools["default"]
        scheduler.rank_cycle(pool)
        outcome = scheduler.match_cycle(pool)
        return (len(outcome.matched),
                sorted(j.uuid for j in outcome.unmatched),
                sorted((i.job_uuid, i.status.value, i.reason_code)
                       for i in store.instances.values()))
    got, want = run(PORT), run(REF)
    assert got == want
    assert got[0] == 0 and len(got[2]) == 1


# ------------------------------------------------ store batch invariants


def test_store_gang_submit_invariants():
    """tests/test_gang.py:234 against the port's store."""
    P = PORT
    store = P.JobStore(clock=FakeClock())
    store.set_pool(P.ent.Pool(name="default"))
    store.set_pool(P.ent.Pool(name="other"))

    def veto(jobs, groups=(), match=""):
        with pytest.raises(P.Vetoed, match=match):
            store.submit_jobs(jobs, groups)

    veto([_job(P, "a", gang_size=1)], match="gang_size 1")
    veto([_job(P, "b", gang_size=2)], match="requires a group")
    g = _gang_group(P, "g-bad")
    veto([_job(P, "c", gang_size=2, group_uuid="g-bad"),
          _job(P, "d", gang_size=3, group_uuid="g-bad")], [g],
         match="disagree")
    veto([_job(P, "e", gang_size=2, group_uuid="g-bad"),
          _job(P, "f", gang_size=2, group_uuid="g-bad", pool="other")], [g],
         match="span pools")
    veto([_job(P, "g", gang_size=3, group_uuid="g-bad"),
          _job(P, "h", gang_size=3, group_uuid="g-bad")], [g],
         match="submit atomically")
    assert not store.jobs  # a veto writes nothing
    ok = _gang_jobs(P, "g-ok", 2)
    store.submit_jobs(ok, [_gang_group(P, "g-ok")])
    assert set(store.groups["g-ok"].job_uuids) == {j.uuid for j in ok}
    veto([_job(P, f"x{i}", gang_size=2, group_uuid="g-ok")
          for i in range(2)], match="extended")


# --------------------------------------------- drain-vs-kill admission


class _FixedPredictor:
    def __init__(self, runtime_ms):
        self.runtime_ms = runtime_ms

    def predict_runtime_ms(self, user, command):
        return self.runtime_ms


def _admission_rig(P, elapsed_ms, extra_gang=False):
    """tests/test_gang.py:263: one 4-host block, h0/h1 free, h2/h3 each
    running one task that started `elapsed_ms` ago."""
    clock = FakeClock()
    store = P.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    running = [_job(P, f"occ{i}", user="occupant", mem=900.0)
               for i in range(2)]
    store.submit_jobs(running)
    clock.advance(-elapsed_ms)
    for i, job in enumerate(running):
        store.create_instance(job.uuid, f"t{i}", hostname=f"h{i + 2}",
                              compute_cluster="m")
        store.update_instance_state(f"t{i}", P.ent.InstanceStatus.RUNNING)
    clock.advance(elapsed_ms)
    gang = _gang_jobs(P, "g-adm", 4, mem=500.0)
    store.submit_jobs(gang, [_gang_group(P, "g-adm")])
    if extra_gang:
        second = _gang_jobs(P, "g-two", 4, mem=500.0)
        store.submit_jobs(second, [_gang_group(P, "g-two")])
        gang = gang + second
    R = P.ent.Resources
    spare = {"h0": R(mem=1000, cpus=8), "h1": R(mem=1000, cpus=8),
             "h2": R(mem=100, cpus=8), "h3": R(mem=100, cpus=8)}
    return store, gang, spare


ADMISSIONS = {
    # victims ran 600 s, predicted done in 30 s: drain, nobody killed
    "drain": (600_000, 630_000.0, {}),
    # fresh victims predicted to run ~995 s more: kill
    "preempt": (5_000, 1_000_000.0, {}),
    # a 30 s drain against ~10 s of work to waste: kill
    "wasted factor": (5_000, 35_000.0, {}),
    # no predictor: the ETA is unknown, kill
    "no predictor": (5_000, None, {}),
    # two waiting gangs, one admission a cycle
    "capped": (5_000, 1_000_000.0, dict(gang_max_admissions=1)),
}


@pytest.mark.parametrize("case", sorted(ADMISSIONS))
def test_plan_gang_admissions_matches_reference(case):
    elapsed, runtime, params = ADMISSIONS[case]
    got = []
    for P in PKGS:
        store, gang, spare = _admission_rig(P, elapsed,
                                            extra_gang=case == "capped")
        predictor = None if runtime is None else _FixedPredictor(runtime)
        adms = P.sgang.plan_gang_admissions(
            store, store.pools["default"], gang, spare, nodes_per_block=4,
            predictor=predictor, params=P.rb.RebalancerParams(**params),
            now_ms=store.clock())
        got.append([a.to_json() for a in adms])
    assert got[0] == got[1]
    [adm] = got[0]
    assert adm["mode"] == ("drain" if case == "drain" else "preempt")
    if case == "drain":
        assert adm["victims"] == [] and adm["hosts"] == ["h0", "h1", "h2",
                                                         "h3"]
        assert adm["predicted_wait_ms"] == 30_000.0
    else:
        assert sorted(adm["victims"]) == ["t0", "t1"]
        assert adm["group"] == "g-adm"


def test_waiting_gangs_skips_partial_complements():
    members = _gang_jobs(PORT, "g-part", 3)[:2]
    assert port_sgang.waiting_gangs(members) == []
    whole = _gang_jobs(PORT, "g-whole", 2)
    assert [g for g, _ in port_sgang.waiting_gangs(whole + members)] \
        == ["g-whole"]
    assert port_sgang.gang_reservation_tag("x") == "gang:x"


# ------------------------------------- scheduler-level admission cycle


def _fleet_rig(P, n_hosts=4, block_hosts=BLOCK_HOSTS, gang_size=4):
    """tests/test_gang.py:346: occupants of the gang's own user fill
    every host (so the DRU rebalancer stays quiet and only gang admission
    acts), then a gang asks for `gang_size` whole hosts."""
    clock = FakeClock()
    store = P.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster("m", _hosts(P, n_hosts), clock=clock)
    scheduler = _scheduler(P, store, [cluster], P.core.SchedulerConfig(
        match=P.matcher.MatchConfig(gang_enabled=True,
                                    topology_block_hosts=block_hosts)))
    pool = store.pools["default"]
    store.submit_jobs([
        _pinned(P, h.hostname, mem=900.0, user="ganguser",
                expected_runtime_ms=60_000) for h in cluster.hosts.values()])
    scheduler.rank_cycle(pool)
    assert len(scheduler.match_cycle(pool).matched) == n_hosts
    clock.advance(30_000)
    store.submit_jobs(_gang_jobs(P, "g-core", gang_size, mem=900.0),
                      [_gang_group(P, "g-core")])
    scheduler.rank_cycle(pool)
    return clock, store, cluster, scheduler, pool


def _admission_view(store, scheduler):
    ledger = scheduler.fairness.snapshot()["pools"]["default"]
    return (scheduler.last_gang_admissions,
            sorted(scheduler.host_reservations.items()),
            sorted((i.task_id, i.status.value, i.reason_code)
                   for i in store.instances.values()),
            ledger["rollups"]["tasks_preempted"],
            ledger["rollups"]["wasted_s"])


def test_core_admission_preempts_reserves_and_places():
    """No predictor: drain ETA unknown, so the cycle kills the block's
    occupants, reserves the hosts gang:<group>, and the next match places
    the gang whole and releases the reservations — in both packages."""
    views = []
    for P in PKGS:
        clock, store, cluster, scheduler, pool = _fleet_rig(P)
        scheduler.rebalance_cycle(pool)
        [adm] = scheduler.last_gang_admissions
        assert adm["mode"] == "preempt"
        assert set(scheduler.host_reservations.values()) == {"gang:g-core"}
        assert len(scheduler.host_reservations) == 4
        after_rebalance = _admission_view(store, scheduler)
        assert after_rebalance[3] == 4
        assert after_rebalance[4]["fairness"] == pytest.approx(120.0)
        scheduler.rank_cycle(pool)
        outcome = scheduler.match_cycle(pool)
        placed = _placed_hosts(store, "g-core")
        assert len(placed) == 4 == len(set(placed))
        assert len(outcome.matched) == 4
        assert scheduler.host_reservations == {}
        views.append((after_rebalance, _admission_view(store, scheduler)))
    assert views[0] == views[1]


def test_core_admission_drains_without_killing():
    """A warm predictor (occupants predicted done in ~30 s, a kill would
    waste 120 s): admission goes preempt-less, nobody dies, and the gang
    lands after the natural drain.  The port has no runtime predictor yet,
    so both schedulers get the same fixed one."""
    views = []
    for P in PKGS:
        clock, store, cluster, scheduler, pool = _fleet_rig(P)
        scheduler.predictor = _FixedPredictor(60_000.0)
        scheduler.rebalance_cycle(pool)
        [adm] = scheduler.last_gang_admissions
        assert adm["mode"] == "drain" and adm["victims"] == []
        assert len(store.running_instances("default")) == 4
        first = _admission_view(store, scheduler)
        clock.advance(40_000)
        cluster.advance_to(clock())
        scheduler.rank_cycle(pool)
        scheduler.match_cycle(pool)
        assert len(set(_placed_hosts(store, "g-core"))) == 4
        assert scheduler.host_reservations == {}
        views.append((first, _admission_view(store, scheduler)))
    assert views[0] == views[1]


def test_core_prunes_stale_gang_reservations():
    for P in PKGS:
        clock, store, cluster, scheduler, pool = _fleet_rig(P)
        scheduler.rebalance_cycle(pool)
        assert len(scheduler.host_reservations) == 4
        # the gang leaves the queue (killed): its reservations must not
        # squat on the block
        store.kill_jobs(store.groups["g-core"].job_uuids)
        scheduler.rank_cycle(pool)
        scheduler.rebalance_cycle(pool)
        assert scheduler.host_reservations == {}


def test_core_admission_on_a_blocky_fleet_matches_reference():
    """chip_smoke.py's admission rig at a CPU size: 16 hosts in blocks of
    4, a 3-gang: one block's occupants killed, its hosts reserved, the
    gang placed whole inside it."""
    views = []
    for P in PKGS:
        clock, store, cluster, scheduler, pool = _fleet_rig(
            P, n_hosts=16, gang_size=3)
        scheduler.rebalance_cycle(pool)
        first = _admission_view(store, scheduler)
        scheduler.rank_cycle(pool)
        scheduler.match_cycle(pool)
        placed = _placed_hosts(store, "g-core")
        assert len(set(placed)) == 3 and len({_block(h) for h in placed}) == 1
        views.append((first, _admission_view(store, scheduler), placed))
    assert views[0] == views[1]
    assert len(views[0][0][1]) == 3  # three hosts reserved, one block


# ------------------------------------- chip_smoke.py's gang phases


def test_chip_smoke_gang_mix():
    """Every tenth job a member; members, in submit order, form gangs of
    2, 4, 8, 16 in turn; the last group is what is left."""
    from chip_smoke import GANG_SIZES, gang_mix
    from cook_tpu_torch.sim.simulator import synth_trace

    jobs, _ = synth_trace(2000, 4, n_users=50, submit_span_ms=60_000)
    mixed = gang_mix(jobs)
    assert [j.uuid for j in mixed] == [j.uuid for j in jobs]
    members = sorted((j for j in mixed if j.gang),
                     key=lambda j: (j.submit_time_ms, j.uuid))
    assert {j.uuid for j in members} == {j.uuid for j in jobs[::10]}
    sizes = {}
    for j in members:
        sizes[j.gang] = sizes.get(j.gang, 0) + 1
    order = list(dict.fromkeys(j.gang for j in members))
    full = [GANG_SIZES[i % 4] for i in range(len(order) - 1)]
    assert [sizes[g] for g in order] == full + [200 - sum(full)]
    assert 2 <= 200 - sum(full) <= GANG_SIZES[(len(order) - 1) % 4]
    # members of a gang are consecutive in submit order
    assert [j.gang for j in members] == sorted(j.gang for j in members)


def test_chip_smoke_gang_slice_on_cpu(tmp_path):
    """chip_smoke.py's gang slice at 2,000 jobs x 200 hosts on the CPU:
    both routes, every cycle checked (no gang partly launched, distinct
    hosts in one block, capacity), gangs launched, the hierarchical
    route's gang cycles on the xla coarse pass."""
    import chip_smoke
    from cook_tpu_torch.sim import cli

    trace = str(tmp_path / "t.json")
    cli.main(["synth", "--jobs", "2000", "--hosts", "200", "--users", "50",
              "--submit-span-ms", "60000", "--out", trace])
    out = chip_smoke.gang_slice_phase(trace, device="cpu")
    assert set(out) == {"flat", "hier", "ops"}
    chip_smoke.gang_ops_phase(*out.pop("ops"), device="cpu")
    for label, (launches, calls, summary) in out.items():
        assert summary["gangs_launched_per_cycle"][-1] > 0
        assert summary["gang_counts"]["placed"] \
            == summary["gangs_launched_per_cycle"][-1]
        assert "gang" in summary["phase_wall_s"]
        assert len(next(iter(calls.values()))) > 0  # kernel calls kept
    assert any(g for g in out["hier"][2]["hier_gangs"])


def test_chip_smoke_gang_admission_and_agreement_on_cpu(tmp_path):
    """The admission replay and the gang agreement phase, both sides on
    the CPU (on the card one side is the card)."""
    import chip_smoke

    view = chip_smoke.gang_admission_replay("cpu")
    [adm] = view["admissions"]
    assert adm["mode"] == "preempt" and len(adm["victims"]) == 8
    assert len(set(view["gang_hosts"])) == 8
    chip_smoke.gang_admission_phase(devices=("cpu", "cpu"))
    chip_smoke.gang_agreement_phase(str(tmp_path), n_jobs=1000, n_hosts=100,
                                    devices=("cpu", "cpu"))
