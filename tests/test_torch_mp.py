"""The multi-process shard-group runtime of `cook_tpu_torch` (`mp/`)
against `cook_tpu` on the CPU.

- The cases of tests/test_mp_runtime.py, all in-process as there, each on
  both packages (`P` over `ref` / `port`) with the reference's
  assertions: the topology and route map, the worker's misroute 421, 2PC
  commit, veto, outage replay and torn tail, the stitched traces,
  front-end forwarding with idempotency, scatter-merge, the debug
  surfaces and the hop split, the stitched timeline, and supervisor
  failover with the federated incident.  The reference's coordinator is
  async and the port's synchronous: `P.run` drives either.  The CLI case
  (`test_cli_renders_twopc_timeline_and_trace_waterfall`) waits for the
  port of `client`.
- Across the packages: a route map and a 2PC decision log written by
  either package, read and replayed by the other; a worker's `data_dir`
  of either package adopted by a standby of the other, with equal
  per-shard `snapshot_state`.
- The port's own design: the front end's loop lock is released around
  every call to a worker (a slow forward holds no other request back),
  its scatter reads run concurrently, and a keep-alive forward waits on
  no delayed ACK.
- The port's subprocess path: `MpRuntime` with real worker processes (2
  groups, 1 standby: SIGKILL, adoption, every ack read back) and
  `python -m cook_tpu_torch --mp 2` end to end (serve, survive a
  worker's SIGKILL, SIGTERM leaves no process behind).
"""
import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import requests
import torch

import cook_tpu.mp as ref_mp
import cook_tpu_torch.mp as port_mp
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import persistence as ref_persist
from cook_tpu.mp import twopc as ref_twopc
from cook_tpu.mp import worker as ref_worker
from cook_tpu.obs import distributed as ref_distributed
from cook_tpu.shard import router as ref_router
from cook_tpu.utils import tracing as ref_tracing
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import persistence as port_persist
from cook_tpu_torch.mp import twopc as port_twopc
from cook_tpu_torch.mp import worker as port_worker
from cook_tpu_torch.obs import distributed as port_distributed
from cook_tpu_torch.shard import router as port_router
from cook_tpu_torch.utils import tracing as port_tracing

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

REF = SimpleNamespace(
    name="ref", pkg="cook_tpu", mp=ref_mp, twopc=ref_twopc,
    worker=ref_worker, distributed=ref_distributed, router=ref_router,
    tracing=ref_tracing, ent=ref_ent, persist=ref_persist,
    # the reference's coordinator is async
    run=asyncio.run, is_async=True)
PORT = SimpleNamespace(
    name="port", pkg="cook_tpu_torch", mp=port_mp, twopc=port_twopc,
    worker=port_worker, distributed=port_distributed, router=port_router,
    tracing=port_tracing, ent=port_ent, persist=port_persist,
    run=lambda value: value, is_async=False)
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])
PAIRS = pytest.mark.parametrize(
    "W,R", [(REF, PORT), (PORT, REF)], ids=["ref-to-port", "port-to-ref"])

HDRS = {"X-Cook-Requesting-User": "alice"}
TIMEOUT_S = 15


def job_spec(uuid, pool, command="true"):
    return {"uuid": uuid, "command": command, "pool": pool,
            "mem": 64, "cpus": 1}


def get(url, **kw):
    return requests.get(url, headers=kw.pop("headers", HDRS),
                        timeout=TIMEOUT_S, **kw)


def post(url, **kw):
    return requests.post(url, headers=kw.pop("headers", HDRS),
                         timeout=TIMEOUT_S, **kw)


# -------------------------------------------------------------- topology


@PKGS
@pytest.mark.parametrize("n_shards,n_groups",
                         [(8, 4), (7, 3), (4, 4), (5, 1)])
def test_topology_blocks_partition_the_shard_space(P, n_shards, n_groups):
    topo = P.mp.ShardGroupTopology(n_shards, n_groups)
    covered = []
    for g in range(n_groups):
        block = topo.shards_of_group(g)
        assert block == tuple(sorted(block))  # contiguous, ascending
        assert block == tuple(range(block[0], block[-1] + 1))
        covered.extend(block)
        for shard in block:
            assert topo.group_of_shard(shard) == g
    assert covered == list(range(n_shards))  # exact partition


@PKGS
def test_topology_key_routing_matches_global_hash(P):
    topo = P.mp.ShardGroupTopology(8, 3)
    router = P.router.ShardRouter(8)
    for pool in ("prod", "dev", "gpu-a"):
        assert topo.group_for_pool(pool) == \
            topo.group_of_shard(router.shard_for_pool(pool))
    for user in ("alice", "bob"):
        assert topo.group_for_user(user) == \
            topo.group_of_shard(router.shard_for_user(user))


@PKGS
def test_topology_distinct_pool_helper(P):
    topo = P.mp.ShardGroupTopology(4, 4)
    pools = topo.pools_for_distinct_groups()
    assert sorted(topo.group_for_pool(p) for p in pools) == [0, 1, 2, 3]


@PKGS
def test_topology_validation(P):
    with pytest.raises(ValueError):
        P.mp.ShardGroupTopology(4, 5)  # more groups than shards
    with pytest.raises(ValueError):
        P.mp.ShardGroupTopology(4, 0)
    with pytest.raises(ValueError):
        P.mp.ShardGroupTopology(4, 2).shards_of_group(2)


@PKGS
def test_route_map_roundtrip(P, tmp_path):
    path = str(tmp_path / "mp" / "routemap.json")
    assert P.mp.read_route_map(path) is None  # missing: not an error
    topo = P.mp.ShardGroupTopology(4, 2)
    route_map = P.mp.build_route_map(topo, {
        0: {"url": "http://w0", "rpc_url": "http://w0r", "alive": True},
    }, map_seq=7)
    P.mp.write_route_map(path, route_map)
    loaded = P.mp.read_route_map(path)
    assert loaded == route_map
    assert loaded["map_seq"] == 7
    by_group = {e["group"]: e for e in loaded["groups"]}
    assert by_group[0]["alive"] and by_group[0]["shards"] == [0, 1]
    assert not by_group[1]["alive"]  # no entry -> dead, still serialized
    P.mp.write_route_map(path, {"schema": "bogus/v9"})
    with pytest.raises(ValueError):
        P.mp.read_route_map(path)


@PKGS
def test_group_router_localizes_owned_and_raises_on_misroute(P):
    global_router = P.router.ShardRouter(4)
    owned = (2, 3)
    router = P.mp.GroupShardRouter(4, owned)
    assert router.n_shards == 2  # LOCAL count: sizes the ShardedStore
    for pool in (f"p{i}" for i in range(16)):
        g = global_router.shard_for_pool(pool)
        if g in owned:
            assert router.shard_for_pool(pool) == owned.index(g)
        else:
            with pytest.raises(P.router.MisroutedKey) as exc:
                router.shard_for_pool(pool)
            assert exc.value.owner_shard == g
    with pytest.raises(ValueError):
        P.mp.GroupShardRouter(4, ())


# ---------------------------------------------------- worker REST surface


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def worker0(request, tmp_path):
    """Group 0 of a 2-shard/2-group fleet, REST + RPC up in-process."""
    P = request.param
    topo = P.mp.ShardGroupTopology(2, 2)
    pools = topo.pools_for_distinct_groups()
    worker = P.worker.ShardGroupWorker(
        data_dir=str(tmp_path), n_shards=2, group=0,
        shards=topo.shards_of_group(0),
        pools=("default", *pools)).start()
    yield worker, pools, P
    worker.stop()


def test_worker_serves_only_owned_shards(worker0):
    worker, pools, _ = worker0
    owned_pool, other_pool = pools  # one per group, by construction
    resp = post(f"{worker.url}/jobs",
                json={"jobs": [job_spec("j-own", owned_pool)]})
    assert resp.status_code == 201
    assert get(f"{worker.url}/jobs/j-own").status_code == 200
    # the other group's pool was filtered at registration: a misdirected
    # submit is an error (unknown pool), never a wrong-segment write
    assert other_pool not in worker.store.pools
    resp = post(f"{worker.url}/jobs",
                json={"jobs": [job_spec("j-far", other_pool)]})
    assert resp.status_code == 400


def test_worker_answers_421_for_misrouted_keys(worker0):
    worker, pools, P = worker0
    # simulate the stale state the registration filter prevents: a pool
    # present in this worker's tables whose shard it does not own
    worker.store.shards[0].pools[pools[1]] = P.ent.Pool(name=pools[1])
    for resp in (
        get(f"{worker.url}/list", params={"user": "alice"}),
        post(f"{worker.url}/jobs",
             json={"jobs": [job_spec("j-mis", pools[1])]}),
    ):
        assert resp.status_code == 421
        assert resp.headers["X-Cook-Owner-Shard"] == "1"
    assert "j-mis" not in worker.store.jobs


# ------------------------------------------------------- cross-group 2PC


class _Fleet:
    """Two in-process workers + a coordinator whose transport calls the
    participants directly (no sockets): the veto/replay state machine
    under test, not the HTTP stack."""

    def __init__(self, P, tmp_path, fail_commits_to=(), log_path=None):
        self.P = P
        self.topo = P.mp.ShardGroupTopology(2, 2)
        self.pools = self.topo.pools_for_distinct_groups()
        self.workers = {
            g: P.worker.ShardGroupWorker(
                data_dir=str(tmp_path), n_shards=2, group=g,
                shards=self.topo.shards_of_group(g),
                pools=("default", *self.pools))
            for g in (0, 1)}
        self.rpc_urls = {g: f"fleet://{g}" for g in (0, 1)}
        self.fail_commits_to = set(fail_commits_to)
        self.log_path = log_path or str(tmp_path / "2pc-decisions.jsonl")

    def _post(self, url, body, timeout_s, headers=None):
        base, _, method = url.partition("/rpc/2pc/")
        group = int(base.rsplit("/", 1)[-1])
        if method == "commit" and group in self.fail_commits_to:
            raise ConnectionError("injected commit outage")
        participant = self.workers[group].participant
        # the coordinator's trace context rides the headers, exactly as
        # the RPC surface would hand it to the participant
        parent = (headers or {}).get(self.P.distributed.PARENT_SPAN_HEADER)
        if method == "abort":
            return 200, participant.abort(body["txn_id"], parent=parent)
        return 200, getattr(participant, method)(
            body["txn_id"], body["op"], body["user"],
            body.get("payload") or {}, parent=parent)

    def post(self):
        if not self.P.is_async:
            return self._post

        async def post(*args, **kw):
            return self._post(*args, **kw)
        return post

    def coordinator(self, **kw):
        kw.setdefault("retry_backoff_s", 0.0)
        return self.P.twopc.TwoPCCoordinator(
            self.post(), self.P.twopc.DecisionLog(self.log_path), **kw)

    def submit_payloads(self, suffix=""):
        return {g: {"jobs": [job_spec(f"j{g}{suffix}", self.pools[g])]}
                for g in (0, 1)}

    def stop(self):
        for worker in self.workers.values():
            worker.stop()


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def fleet(request, tmp_path):
    fleet = _Fleet(request.param, tmp_path)
    yield fleet
    fleet.stop()


def test_twopc_commits_on_every_group(fleet):
    P = fleet.P
    coord = fleet.coordinator()
    result = P.run(coord.run(
        txn_id="pt-ok", op="jobs/submit", user="alice",
        per_group=fleet.submit_payloads(), rpc_urls=fleet.rpc_urls))
    assert result["ok"] and result["pending_groups"] == []
    for g in (0, 1):
        assert f"j{g}" in fleet.workers[g].store.jobs
    # done marker written: nothing left to replay
    assert coord.decisions.outstanding() == {}
    # a replayed commit is answered from the idempotency table
    reply = fleet.workers[0].participant.commit(
        "pt-ok", "jobs/submit", "alice", fleet.submit_payloads()[0])
    assert reply["ok"] and reply["duplicate"]


def test_twopc_veto_aborts_all_groups(fleet):
    P = fleet.P
    coord = fleet.coordinator()
    per_group = fleet.submit_payloads()
    per_group[1]["jobs"][0]["command"] = ""  # group 1 must veto
    result = P.run(coord.run(
        txn_id="pt-veto", op="jobs/submit", user="alice",
        per_group=per_group, rpc_urls=fleet.rpc_urls))
    assert not result["ok"]
    assert result["status"] == 400 and result["vetoed_by"] == 1
    # all-or-nothing: group 0 prepared fine but must not apply, and no
    # decision was journaled (presumed abort)
    for g in (0, 1):
        assert f"j{g}" not in fleet.workers[g].store.jobs
        assert fleet.workers[g].participant._pending == {}
    assert coord.decisions.outstanding() == {}
    assert os.path.getsize(fleet.log_path) == 0


@PKGS
def test_twopc_decision_survives_commit_outage_and_replays(P, tmp_path):
    fleet = _Fleet(P, tmp_path, fail_commits_to={1})
    try:
        coord = fleet.coordinator(commit_attempts=2)
        result = P.run(coord.run(
            txn_id="pt-replay", op="jobs/submit", user="alice",
            per_group=fleet.submit_payloads(), rpc_urls=fleet.rpc_urls))
        # the decision stands: group 0 applied, group 1 is pending
        assert result["ok"] and result["pending_groups"] == [1]
        assert "j0" in fleet.workers[0].store.jobs
        assert "j1" not in fleet.workers[1].store.jobs
        # a NEW coordinator on the same decision log (front-end restart)
        # finishes the transaction once the participant is reachable; it
        # re-validates from the payload the decision carries either way
        fleet.fail_commits_to.clear()
        fresh = fleet.coordinator()
        report = P.run(fresh.replay())
        assert report == {"outstanding": 1, "finished": 1,
                          "still_pending": 0}
        assert "j1" in fleet.workers[1].store.jobs
        # replay converges: running it again finds nothing outstanding
        assert P.run(fresh.replay())["outstanding"] == 0
    finally:
        fleet.stop()


def test_twopc_veto_trace_names_vetoing_group(fleet):
    """A vetoed cross-group txn leaves a stitched trace naming WHO
    said no: the coordinator's failed prepare span carries the group,
    and the participant lands a twopc.veto marker on its own track."""
    P = fleet.P
    coord = fleet.coordinator()
    per_group = fleet.submit_payloads("-vt")
    per_group[1]["jobs"][0]["command"] = ""  # group 1 must veto
    result = P.run(coord.run(
        txn_id="pt-veto-trace", op="jobs/submit", user="alice",
        per_group=per_group, rpc_urls=fleet.rpc_urls))
    assert not result["ok"] and result["vetoed_by"] == 1
    spans = P.tracing.spans_for_txn("pt-veto-trace")
    by_name = {}
    for entry in spans:
        by_name.setdefault(entry["name"], []).append(entry)
    assert any(e["tags"].get("process") == "worker-g1"
               for e in by_name["twopc.veto"])
    assert any(e["tags"].get("group") == 1 and e["tags"].get("error")
               for e in by_name["twopc.prepare"])
    # participants opened their phase spans under the coordinator's
    # X-Cook-Parent-Span, from BOTH groups' tracks
    prepares = by_name["mp.participant.prepare"]
    assert {e["parent"] for e in prepares} == {"twopc.prepare"}
    assert {"worker-g0", "worker-g1"} <= {
        e["tags"].get("process") for e in prepares}
    # group 0 prepared fine and was unwound: its abort is in the trace
    assert any(e["tags"].get("process") == "worker-g0"
               for e in by_name["mp.participant.abort"])
    # presumed abort: no decision write ever happened
    assert "twopc.decision_write" not in by_name


@PKGS
def test_twopc_replay_trace_names_replayed_group(P, tmp_path):
    """A torn decision (commit outage after the fsynced decision write)
    replays to convergence, and the stitched trace names the group the
    replay finished: the failed + successful commit RPCs and the
    participant's apply all carry the same txn id."""
    fleet = _Fleet(P, tmp_path, fail_commits_to={1})
    try:
        coord = fleet.coordinator(commit_attempts=1)
        result = P.run(coord.run(
            txn_id="pt-replay-trace", op="jobs/submit", user="alice",
            per_group=fleet.submit_payloads("-rt"),
            rpc_urls=fleet.rpc_urls))
        assert result["ok"] and result["pending_groups"] == [1]
        fleet.fail_commits_to.clear()
        P.run(fleet.coordinator().replay())
        spans = P.tracing.spans_for_txn("pt-replay-trace")
        commits = [e for e in spans if e["name"] == "twopc.commit"]
        assert any(e["tags"].get("group") == 1 and e["tags"].get("error")
                   for e in commits), "the outage never hit the ring"
        assert any(e["tags"].get("group") == 1
                   and not e["tags"].get("error")
                   for e in commits), "no successful replayed commit"
        applied = [e for e in spans
                   if e["name"] == "mp.participant.commit"
                   and e["tags"].get("process") == "worker-g1"]
        assert applied and applied[-1]["parent"] == "twopc.commit"
        # exactly one fsynced decision write, on the coordinator lane
        decisions = [e for e in spans
                     if e["name"] == "twopc.decision_write"]
        assert len(decisions) == 1
        assert decisions[0]["tags"]["process"] == "coordinator"
    finally:
        fleet.stop()


@PKGS
def test_decision_log_tolerates_torn_tail(P, tmp_path):
    path = str(tmp_path / "decisions.jsonl")
    log = P.twopc.DecisionLog(path)
    log.append({"txn_id": "a", "decision": "commit", "groups": {},
                "op": "jobs/submit"})
    log.append({"txn_id": "b", "decision": "commit", "groups": {},
                "op": "jobs/submit"})
    log.append({"txn_id": "a", "decision": "done"})
    log.close()
    with open(path, "a") as f:
        f.write('{"txn_id": "c", "decision": "com')  # torn: not durable
    outstanding = P.twopc.DecisionLog(path).outstanding()
    assert set(outstanding) == {"b"}  # a is done, c presumed abort


# ----------------------------------- front end + supervisor (in-process)


def _runtime(P, **kw):
    supervisor = __import__(f"{P.pkg}.mp.supervisor",
                            fromlist=["MpRuntime"])
    return supervisor.MpRuntime(**kw)


@pytest.fixture(scope="module", params=[REF, PORT], ids=["ref", "port"])
def runtime(request):
    runtime = _runtime(request.param, n_groups=2, standbys=0,
                       inprocess=True,
                       poll_s=30.0)  # tests drive check_once directly
    runtime.P = request.param
    yield runtime
    runtime.stop()


def test_frontend_forwards_with_headers_and_idempotency(runtime):
    pool = runtime.pools[1]  # one group's pool: a single-group forward
    body = {"jobs": [job_spec("fe-j0", pool)]}
    headers = {**HDRS, "X-Cook-Txn-Id": "pt-fe-txn-1"}
    first = post(f"{runtime.url}/jobs", json=body, headers=headers)
    assert first.status_code == 201
    assert first.headers["X-Cook-Shard-Group"].isdigit()
    # same txn-id again: the worker's idempotency table answers through
    # the front end because the forward preserves body + headers
    second = post(f"{runtime.url}/jobs", json=body, headers=headers)
    assert second.status_code == 201 and second.json() == first.json()
    # per-uuid read routes to the owning group
    read = get(f"{runtime.url}/jobs/fe-j0")
    assert read.status_code == 200
    assert read.headers["X-Cook-Shard-Group"] == \
        first.headers["X-Cook-Shard-Group"]


def test_frontend_cross_group_submit_and_kill_via_2pc(runtime):
    pool_a, pool_b = runtime.pools[1], runtime.pools[2]
    resp = post(f"{runtime.url}/jobs", json={
        "jobs": [job_spec("", pool_a) | {"uuid": ""},
                 job_spec("", pool_b) | {"uuid": ""}]})
    assert resp.status_code == 201
    assert "," in resp.headers["X-Cook-Shard-Group"]  # 2PC, two groups
    assert resp.headers["X-Cook-Txn-Id"]
    uuids = resp.json()["jobs"]
    assert len(uuids) == 2
    groups = set()
    for uuid in uuids:
        read = get(f"{runtime.url}/jobs/{uuid}")
        assert read.status_code == 200
        groups.add(read.headers["X-Cook-Shard-Group"])
    assert len(groups) == 2  # the jobs really live on different workers
    kill = requests.delete(f"{runtime.url}/jobs", headers=HDRS,
                           params=[("uuid", u) for u in uuids],
                           timeout=TIMEOUT_S)
    assert kill.status_code == 204
    for uuid in uuids:
        job = get(f"{runtime.url}/jobs/{uuid}").json()
        assert job["status"] in ("failed", "completed")


def test_frontend_scatter_merges_fleet_wide_reads(runtime):
    # /pools is scatter-merged: the union of every group's owned pools
    names = {p["name"] for p in get(f"{runtime.url}/pools").json()}
    assert set(runtime.pools) <= names
    # /list merges both groups' jobs for one user
    for g, pool in enumerate(runtime.pools[1:]):
        post(f"{runtime.url}/jobs",
             json={"jobs": [job_spec(f"sc-{g}", pool)]})
    listed = {j["uuid"] for j in get(
        f"{runtime.url}/list", params={"user": "alice"}).json()}
    assert {"sc-0", "sc-1"} <= listed


def test_frontend_debug_surfaces(runtime):
    shards = get(f"{runtime.url}/debug/shards").json()
    assert shards["n_groups"] == 2
    assert all(e["alive"] for e in shards["groups"])
    assert "breakers" in shards
    frontend = get(f"{runtime.url}/debug/frontend").json()
    assert "twopc" in frontend


def test_frontend_merged_trace_for_cross_group_submit(runtime):
    """ONE merged Chrome trace for a cross-group submit, with front-end
    (pid 0), coordinator-decision (pid 1), and both participants' (pid
    >= 2) tracks under one txn id."""
    pool_a, pool_b = runtime.pools[1], runtime.pools[2]
    txn_id = "pt-txn-merged-trace"
    resp = post(f"{runtime.url}/jobs",
                headers={**HDRS, "X-Cook-Txn-Id": txn_id},
                json={"jobs": [job_spec("tr-a", pool_a),
                               job_spec("tr-b", pool_b)]})
    assert resp.status_code == 201
    raw = get(f"{runtime.url}/debug/trace",
              params={"txn_id": txn_id, "format": "raw"}).json()
    assert raw["txn_id"] == txn_id and raw["groups_failed"] == []
    procs = {e["process"] for e in raw["spans"]}
    assert "frontend" in procs and "coordinator" in procs
    assert len({p for p in procs if p.startswith("worker-g")}) >= 2
    names = {e["name"] for e in raw["spans"]}
    assert {"mp.submit_2pc", "twopc.prepare", "twopc.decision_write",
            "twopc.commit", "mp.participant.prepare",
            "mp.participant.commit"} <= names
    # chrome rendering: one pid track per process, contract pids
    chrome = get(f"{runtime.url}/debug/trace",
                 params={"txn_id": txn_id}).json()
    events = chrome["traceEvents"]
    pids = {e["args"]["name"]: e["pid"] for e in events
            if e["name"] == "process_name"}
    assert pids["frontend"] == 0 and pids["coordinator"] == 1
    worker_pids = [p for label, p in pids.items()
                   if label.startswith("worker-g")]
    assert len(worker_pids) >= 2 and all(p >= 2 for p in worker_pids)
    decision = [e for e in events if e["name"] == "twopc.decision_write"]
    assert decision and decision[0]["pid"] == 1  # the commit point
    # bad requests fail crisply
    assert get(f"{runtime.url}/debug/trace").status_code == 400
    assert get(f"{runtime.url}/debug/trace",
               params={"txn_id": "x", "format": "svg"}).status_code == 400


def test_frontend_reports_nonzero_hop_splits(runtime):
    """/debug/frontend splits forward time by hop from the worker's
    X-Cook-Hop-Walls response header + the front end's own stamps."""
    pool = runtime.pools[1]
    for i in range(3):
        resp = post(f"{runtime.url}/jobs",
                    json={"jobs": [job_spec(f"hop-{i}", pool)]})
        assert resp.status_code == 201
        assert "server" in resp.headers.get("X-Cook-Hop-Walls", ""), \
            "worker phase walls never propagated back out"
    g = str(runtime.supervisor.topology.group_for_pool(pool))
    frontend = get(f"{runtime.url}/debug/frontend").json()
    hops = frontend["per_group"][g]["hops"]
    for hop in ("queue", "transport", "apply", "fsync"):
        assert hops[hop]["count"] > 0, f"no {hop} samples"
        assert hops[hop]["p99_ms"] > 0.0, f"{hop} split is zero"


def test_frontend_timeline_stitches_twopc_decision(runtime):
    """/jobs/{uuid}/timeline through the front end folds the 2PC commit
    decision + done markers into a cross-group job's event stream."""
    pool_a, pool_b = runtime.pools[1], runtime.pools[2]
    resp = post(f"{runtime.url}/jobs", json={
        "jobs": [job_spec("tl-a", pool_a), job_spec("tl-b", pool_b)]})
    assert resp.status_code == 201
    timeline = get(f"{runtime.url}/jobs/tl-a/timeline").json()
    kinds = [e["kind"] for e in timeline["events"]]
    assert "2pc-commit-decision" in kinds and "2pc-done" in kinds
    decision = next(e for e in timeline["events"]
                    if e["kind"] == "2pc-commit-decision")
    assert len(decision["groups"]) == 2
    assert set(decision["prepare_ms"]) == \
        {str(g) for g in decision["groups"]}
    twopc = timeline["twopc"]
    assert twopc["txn_id"] == decision["txn_id"]
    assert twopc["done_t"] >= twopc["decided_t"]
    # shared clock domain: the worker stamps jobs with wall-clock ms
    # (ShardGroupWorker's default clock), so the decision-log event
    # lands within seconds of the submit stamp — not decades away
    # (the decision write precedes the commit apply that stamps the
    # job, so the delta may be slightly negative)
    assert abs(decision["t_ms"] - timeline["submit_time_ms"]) < 60_000
    # a single-group job's timeline passes through unstitched
    post(f"{runtime.url}/jobs",
         json={"jobs": [job_spec("tl-solo", pool_a)]})
    solo = get(f"{runtime.url}/jobs/tl-solo/timeline").json()
    assert "twopc" not in solo
    # unknown uuid: 404, same contract as the worker's own surface
    assert get(f"{runtime.url}/jobs/no-such/timeline").status_code == 404


@PKGS
def test_supervisor_failover_promotes_standby_and_keeps_acks(P, tmp_path):
    runtime = _runtime(P, n_groups=2, standbys=1, inprocess=True,
                       poll_s=30.0, data_dir=str(tmp_path))
    try:
        pool0, pool1 = runtime.pools[1], runtime.pools[2]
        acked = []
        for i, pool in enumerate((pool0, pool1)):
            resp = post(f"{runtime.url}/jobs",
                        json={"jobs": [job_spec(f"fo-{i}", pool)]})
            assert resp.status_code == 201
            acked.append(f"fo-{i}")
        victim = runtime.supervisor.topology.group_for_pool(pool0)
        old_url = runtime.supervisor.workers[victim].describe["url"]
        runtime.supervisor.kill_worker(victim)
        assert runtime.supervisor.check_once() == [victim]
        # the map now points the victim group at the adopted standby
        route_map = P.mp.read_route_map(runtime.supervisor.map_path)
        assert route_map["map_seq"] >= 3
        entry = {e["group"]: e for e in route_map["groups"]}[victim]
        assert entry["alive"] and entry["url"] != old_url
        # the front end re-reads the map on mtime; poll until it did
        deadline = time.monotonic() + 5.0
        while True:
            shards = get(f"{runtime.url}/debug/shards").json()
            if shards["map_seq"] == route_map["map_seq"]:
                break
            assert time.monotonic() < deadline, \
                "front end never picked up the new map"
            time.sleep(0.1)
        # nothing acked was lost: the standby recovered the journal
        # segments, and fresh writes land on the adopter
        for uuid in acked:
            assert get(f"{runtime.url}/jobs/{uuid}").status_code == 200
        resp = post(f"{runtime.url}/jobs",
                    json={"jobs": [job_spec("fo-new", pool0)]})
        assert resp.status_code == 201
        # federated incident: the fleet poller saw the victim's
        # ok->degraded edge and captured through the FRONT END's
        # recorder, embedding the mp evidence collectors
        fed = [b for b in runtime.frontend.incidents.bundles()
               if b["trigger"] == "fleet-peer"]
        assert fed, "no federated incident for the killed worker"
        bundle = runtime.frontend.incidents.get(fed[-1]["id"])
        assert bundle["verdict"]["federated"]
        assert bundle["verdict"]["peer"].rstrip("/") == \
            old_url.rstrip("/")
        assert "records" in bundle["decision_log"]
        assert set(bundle["breakers"]) == {"0", "1"}
        assert bundle["route_map"]["groups"]
        # ...and the front end's /debug/incidents serves the same index
        served = get(f"{runtime.url}/debug/incidents").json()
        assert fed[-1]["id"] in {b["id"] for b in served["incidents"]}
        # the adoption is traceable: the supervisor stamped the adopt
        # RPC with a failover correlation id, and the adopter opened
        # mp.adopt on its OWN group's track under mp.failover
        adopts = [e for e in P.tracing.recent_spans(4096)
                  if e["name"] == "mp.adopt"
                  and e["tags"].get("group") == victim]
        assert adopts, "no mp.adopt span for the failover"
        adopt = adopts[-1]
        assert adopt["parent"] == "mp.failover"
        assert adopt["tags"]["process"] == f"worker-g{victim}"
        failover_txn = adopt["tags"]["txn_id"]
        assert failover_txn.startswith(f"failover-{victim}-")
        stitched = P.tracing.spans_for_txn(failover_txn)
        assert {"mp.adopt", "mp.failover"} <= \
            {e["name"] for e in stitched}
    finally:
        runtime.stop()


# ---------------------------------------------------- across the packages


@PAIRS
def test_route_map_written_by_one_package_is_read_by_the_other(W, R,
                                                               tmp_path):
    path = str(tmp_path / "mp" / "routemap.json")
    for n_shards, n_groups in ((8, 4), (7, 3), (5, 1)):
        topo = W.mp.ShardGroupTopology(n_shards, n_groups)
        route_map = W.mp.build_route_map(topo, {
            g: {"url": f"http://w{g}", "rpc_url": f"http://r{g}",
                "alive": g % 2 == 0} for g in range(n_groups)}, map_seq=3)
        W.mp.write_route_map(path, route_map)
        loaded = R.mp.read_route_map(path)
        assert loaded == route_map
        theirs = __import__(f"{R.pkg}.mp.topology",
                            fromlist=["topology_of"]).topology_of(loaded)
        assert (theirs.n_shards, theirs.n_groups) == (n_shards, n_groups)
        assert R.mp.build_route_map(theirs, {
            e["group"]: e for e in loaded["groups"]}, map_seq=3) == loaded
        for i in range(200):
            assert theirs.group_for_pool(f"pool{i}") == \
                topo.group_for_pool(f"pool{i}")
            assert theirs.group_for_user(f"user{i}") == \
                topo.group_for_user(f"user{i}")
        assert theirs.pools_for_distinct_groups() == \
            topo.pools_for_distinct_groups()


@PAIRS
def test_decision_log_written_by_one_package_is_replayed_by_the_other(
        W, R, tmp_path):
    """W's coordinator commits to group 0 and loses group 1's commit;
    W's fleet stops.  R's workers recover the same data_dir, and R's
    coordinator replays W's decision log: group 0 answers from its
    recovered idempotency table, group 1 applies from the payload."""
    data = tmp_path / "data"
    log_path = str(tmp_path / "2pc-decisions.jsonl")
    fleet = _Fleet(W, data, fail_commits_to={1}, log_path=log_path)
    try:
        coord = fleet.coordinator(commit_attempts=1)
        result = W.run(coord.run(
            txn_id="pt-cross", op="jobs/submit", user="alice",
            per_group=fleet.submit_payloads(), rpc_urls=fleet.rpc_urls))
        assert result["ok"] and result["pending_groups"] == [1]
        coord.decisions.close()
    finally:
        fleet.stop()
    assert set(R.twopc.DecisionLog(log_path).outstanding()) == {"pt-cross"}
    theirs = _Fleet(R, data, log_path=log_path)
    try:
        assert "j0" in theirs.workers[0].store.jobs
        assert "j1" not in theirs.workers[1].store.jobs
        report = R.run(theirs.coordinator().replay())
        assert report == {"outstanding": 1, "finished": 1,
                          "still_pending": 0}
        assert "j1" in theirs.workers[1].store.jobs
        assert W.twopc.DecisionLog(log_path).outstanding() == {}
        record, done_t = W.twopc.DecisionLog(log_path).find_for_uuid("j1")
        assert record["txn_id"] == "pt-cross" and done_t is not None
    finally:
        theirs.stop()


def _shard_states(P, store) -> list:
    return [json.loads(json.dumps(P.persist.snapshot_state(shard)))
            for shard in store.shards]


@PAIRS
def test_a_standby_adopts_a_worker_data_dir_of_the_other_package(
        W, R, tmp_path):
    """W's worker for group 1 takes submits (one of them killed) and
    stops; R's standby adopts group 1 over its RPC port and holds every
    shard's state as W's worker left it."""
    topo = W.mp.ShardGroupTopology(4, 2)
    pools = topo.pools_for_distinct_groups()
    worker = W.worker.ShardGroupWorker(
        data_dir=str(tmp_path), n_shards=4, group=1,
        shards=topo.shards_of_group(1),
        pools=("default", *pools)).start()
    standby = None
    try:
        uuids = [f"ad-{i}" for i in range(12)]
        for i in range(0, 12, 4):
            resp = post(f"{worker.url}/jobs", json={"jobs": [
                job_spec(u, pools[1]) for u in uuids[i:i + 4]]})
            assert resp.status_code == 201
        assert requests.delete(f"{worker.url}/jobs", headers=HDRS,
                               params={"job": uuids[0]},
                               timeout=TIMEOUT_S).status_code == 204
        want = _shard_states(W, worker.store)
    finally:
        worker.stop()
    try:
        standby = R.worker.ShardGroupWorker(
            data_dir=str(tmp_path), n_shards=4, shards=(),
            pools=("default", *pools)).start()
        assert not standby.active
        reply = requests.post(f"{standby.rpc_url}/rpc/adopt", json={
            "group": 1, "shards": list(topo.shards_of_group(1)),
            "pools": ["default", *pools]}, timeout=TIMEOUT_S)
        assert reply.status_code == 200 and reply.json()["ok"]
        assert reply.json()["group"] == 1
        assert _shard_states(R, standby.store) == want
        read = get(f"{standby.url}/jobs/{uuids[1]}")
        assert read.status_code == 200 and read.json()["pool"] == pools[1]
        # a second adoption is refused: the standby serves its group
        again = requests.post(f"{standby.rpc_url}/rpc/adopt", json={
            "group": 0, "shards": [0, 1]}, timeout=TIMEOUT_S)
        assert again.status_code == 409
    finally:
        if standby is not None:
            standby.stop()


def test_both_packages_merge_a_trace_alike():
    spans = [
        {"name": "mp.forward", "t": 2.0, "tid": 1, "duration_s": 0.5,
         "thread": "fe", "tags": {"process": "frontend", "group": 0}},
        {"name": "twopc.decision_write", "t": 1.5, "tid": 2,
         "duration_s": 0.1, "tags": {"process": "coordinator"}},
        {"name": "rest.commit", "t": 1.9, "tid": 3, "duration_s": 0.2,
         "parent": "mp.forward", "tags": {"op": "jobs/submit"}},
        {"name": "mark", "t": 1.0, "tid": 4, "duration_s": 0.0,
         "tags": {"process": "sidecar"}},
    ]
    sources = [{"process": "frontend", "spans": spans[:2]},
               {"process": "worker-g3", "spans": spans[1:]}]
    merged = port_distributed.merge_process_traces(sources)
    assert merged == ref_distributed.merge_process_traces(sources)
    assert port_distributed.merged_chrome_trace(merged) == \
        ref_distributed.merged_chrome_trace(merged)
    walls = {"server": 0.0123456, "apply": 1e-7, "fsync": 2.5}
    assert port_distributed.encode_hop_walls(walls) == \
        ref_distributed.encode_hop_walls(walls)
    assert port_distributed.parse_hop_walls("a=1;b=x;c;d=2.5") == \
        ref_distributed.parse_hop_walls("a=1;b=x;c;d=2.5")
    timeline = {"events": [{"t_ms": 5, "kind": "submitted"}]}
    record = {"txn_id": "t", "t": 0.004, "op": "jobs/submit",
              "groups": {"1": {}, "0": {}}, "prepare_s": {"0": 0.001}}
    assert port_distributed.stitch_twopc_events(timeline, record, 0.006) \
        == ref_distributed.stitch_twopc_events(timeline, record, 0.006)


# ------------------------------------------------ the front end's threads


class _SlowApp:
    """A stand-in worker whose every answer takes `delay_s`, with its
    own loop lock released while it sleeps (requests overlap)."""

    def __init__(self, delay_s):
        from cook_tpu_torch.rest.http import LoopLock

        self.delay_s = delay_s
        self.loop = LoopLock()

    def build_app(self):
        from cook_tpu_torch.rest.http import Application, json_response

        app = Application(loop=self.loop)

        def answer(request):
            with self.loop.released():
                time.sleep(self.delay_s)
            return json_response({"pools": [request.path]})
        app.router.add_route("*", "/{tail:.*}", answer)
        return app


@pytest.fixture
def slow_front_end(tmp_path):
    from cook_tpu_torch.mp.router import FrontEnd
    from cook_tpu_torch.rest.server import ServerThread

    servers = [ServerThread(_SlowApp(d)).start() for d in (0.0, 1.0, 1.0)]
    topo = port_mp.ShardGroupTopology(3, 3)
    route_map = port_mp.build_route_map(topo, {
        g: {"url": s.url, "rpc_url": s.url, "alive": True}
        for g, s in enumerate(servers)})
    front = FrontEnd(route_map=route_map,
                     decision_log_path=str(tmp_path / "d.jsonl"))
    server = ServerThread(front).start()
    yield server, topo
    server.stop()
    for s in servers:
        s.stop()


def test_a_slow_forward_holds_no_other_request_back(slow_front_end):
    server, topo = slow_front_end
    slow_user = next(f"u{i}" for i in range(1000)
                     if topo.group_for_user(f"u{i}") == 1)
    fast_user = next(f"u{i}" for i in range(1000)
                     if topo.group_for_user(f"u{i}") == 0)
    slow = threading.Thread(target=get, args=(
        f"{server.url}/share?user={slow_user}",), daemon=True)
    slow.start()
    time.sleep(0.2)  # the slow forward is in flight
    t0 = time.monotonic()
    resp = get(f"{server.url}/share?user={fast_user}")
    fast_wall = time.monotonic() - t0
    slow.join(TIMEOUT_S)
    assert resp.status_code == 200 and resp.headers[
        "X-Cook-Shard-Group"] == "0"
    assert fast_wall < 0.5, fast_wall


def test_scatter_reads_fan_out_concurrently(slow_front_end):
    server, _ = slow_front_end
    t0 = time.monotonic()
    resp = get(f"{server.url}/pools")
    wall = time.monotonic() - t0
    assert resp.status_code == 200 and len(resp.json()["pools"]) == 3
    # two groups of 1 s each: one second at once, not two in a row
    assert wall < 1.8, wall


def test_keep_alive_forwards_wait_on_no_delayed_ack(slow_front_end):
    from cook_tpu_torch.client.jobclient import Session

    server, topo = slow_front_end
    fast_users = [f"u{i}" for i in range(1000)
                  if topo.group_for_user(f"u{i}") == 0][:40]
    # the front end's own forwarding pool
    pool = Session(per_host=16)
    walls = []
    try:
        for user in fast_users:
            t0 = time.perf_counter()
            status = pool.send(
                "POST", f"{server.url}/share?user={user}",
                body=json.dumps({"pad": "x" * 2000}).encode(),
                headers={"Content-Type": "application/json"},
                timeout=5).status_code
            walls.append(time.perf_counter() - t0)
            assert status == 200
        # one connection to the front end, reused for every request
        assert sum(len(v) for v in pool._idle.values()) == 1
    finally:
        pool.close()
    # Nagle's algorithm against a delayed ACK costs ~40 ms a request
    assert sorted(walls)[len(walls) // 2] < 0.02, walls


# ------------------------------------------------- real worker processes


def _wait_until(what, deadline_s, probe):
    deadline = time.monotonic() + deadline_s
    while True:
        got = probe()
        if got:
            return got
        assert time.monotonic() < deadline, f"{what} not within " \
                                            f"{deadline_s} s"
        time.sleep(0.1)


def _alive(pid) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    # a zombie (exited, not yet reaped by its parent) counts as dead
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _fleet_pids(data_dir) -> set:
    mp_dir = os.path.join(data_dir, "mp")
    pids = set()
    for name in os.listdir(mp_dir):
        if name.startswith("ready-") and name.endswith(".json"):
            with open(os.path.join(mp_dir, name)) as f:
                pids.add(json.load(f)["pid"])
    return pids


def _submit_and_read_back(url, pools, n_posts, tag):
    """n_posts POSTs of 3 jobs, the odd ones across both groups (2PC);
    returns uuid -> pool of every acked job."""
    acked = {}
    for i in range(n_posts):
        pick = (pools[0], pools[0], pools[0]) if i % 2 == 0 \
            else (pools[0], pools[1], pools[1])
        specs = [job_spec(f"{tag}-{i}-{k}", p) for k, p in enumerate(pick)]
        resp = post(f"{url}/jobs", json={"jobs": specs})
        assert resp.status_code == 201, resp.text
        acked.update({s["uuid"]: s["pool"] for s in specs})
    return acked


def _read_back(url, acked):
    for uuid, pool in acked.items():
        resp = get(f"{url}/jobs/{uuid}")
        assert resp.status_code == 200, (uuid, resp.text)
        assert resp.json()["pool"] == pool


def test_mp_runtime_subprocess_failover_keeps_every_ack(tmp_path):
    """Real worker processes: 2 groups and 1 standby; the victim group's
    worker is SIGKILLed and the supervisor's monitor has the standby
    adopt its segments; every ack reads back, the victim's pool takes
    writes again, and no fleet process outlives the runtime."""
    from cook_tpu_torch.mp.supervisor import MpRuntime

    t_start = time.monotonic()
    data = str(tmp_path / "data")
    runtime = MpRuntime(n_groups=2, standbys=1, poll_s=0.2, data_dir=data)
    try:
        pools = runtime.pools[1:]
        acked = _submit_and_read_back(runtime.url, pools, 6, "sp")
        victim = runtime.supervisor.topology.group_for_pool(pools[0])
        old = runtime.supervisor.workers[victim]
        old_pid = old.describe["pid"]
        assert old.describe["pid"] != os.getpid()
        os.kill(old_pid, signal.SIGKILL)
        route_map = _wait_until(
            "adoption in the route map", 30,
            lambda: (lambda m: m if m["groups"][victim]["alive"]
                     and m["groups"][victim]["url"] != old.describe["url"]
                     else None)(port_mp.read_route_map(
                         runtime.supervisor.map_path)))
        assert route_map["map_seq"] >= 3
        _wait_until("the front end on the new map", 10, lambda: get(
            f"{runtime.url}/debug/shards").json()["map_seq"]
            == route_map["map_seq"])
        _read_back(runtime.url, acked)
        more = _submit_and_read_back(runtime.url, pools, 2, "after")
        _read_back(runtime.url, more)
        pids = {h.describe["pid"]
                for h in runtime.supervisor._spawned}
        assert old_pid in pids and len(pids) >= 3
    finally:
        runtime.stop()
    assert not [pid for pid in pids if _alive(pid)]
    assert time.monotonic() - t_start < 60


def test_python_m_mp_serves_survives_a_sigkill_and_stops_clean(tmp_path):
    """`python -m cook_tpu_torch --mp 2` end to end: submits through the
    front end (one-group and 2PC), a worker SIGKILLed and adopted, every
    ack read back, then SIGTERM: exit 0 and no worker left."""
    from cook_tpu_torch.rest.server import free_port

    data = str(tmp_path / "data")
    port = free_port()
    url = f"http://127.0.0.1:{port}"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    log = open(tmp_path / "mp.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "cook_tpu_torch", "--mp", "2",
         "--mp-shards", "4", "--mp-standbys", "1", "--data-dir", data,
         "--port", str(port)],
        cwd=REPO, env=env, stdout=log, stderr=log)
    pids = set()
    try:
        def up():
            try:
                return get(f"{url}/debug/shards").status_code == 200
            except requests.ConnectionError:
                assert proc.poll() is None, "front end exited at boot"
                return False
        _wait_until("the front end", 60, up)
        topo = port_mp.ShardGroupTopology(4, 2)
        pools = topo.pools_for_distinct_groups()
        acked = _submit_and_read_back(url, pools, 4, "cli")
        pids = _fleet_pids(data)
        assert len(pids) == 3 and os.getpid() not in pids
        with open(os.path.join(data, "mp", "ready-g0.json")) as f:
            victim = json.load(f)
        os.kill(victim["pid"], signal.SIGKILL)
        _wait_until("adoption", 30, lambda: (lambda m: m["groups"][0][
            "alive"] and m["groups"][0]["url"] != victim["url"])(get(
                f"{url}/debug/shards").json()))
        _read_back(url, acked)
        _read_back(url, _submit_and_read_back(url, pools, 2, "cli2"))
        pids |= _fleet_pids(data)
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        finally:
            if proc.poll() is None:
                proc.kill()
            log.close()
    assert rc == 0, (tmp_path / "mp.log").read_text()
    assert not [pid for pid in pids if _alive(pid)]


def test_chip_smoke_mp_fleet_phase_on_cpu(tmp_path):
    """chip_smoke.py's mp fleet phase (28) at a CPU test's size (1,000
    jobs in its 100 POSTs), without the CUDA-context check: boot, one-group
    and 2PC submits, kills, a worker SIGKILLed and adopted, every ack read
    back, the decision log settled, SIGTERM and no worker left."""
    import chip_smoke

    result = chip_smoke.mp_fleet_run(str(tmp_path), n_jobs=1000, cuda=False)
    assert result["read_back"] == 1000
    assert result["decisions"] == chip_smoke.MP_FLEET_POSTS // 2 + 1
    assert result["kill_to_adopter_alive_s"] < 30


def _worker_children() -> list:
    """pids of this process's live children running the mp worker."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                stat = f.read().split(")")[-1].split()
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmdline = f.read()
        except OSError:
            continue
        if (int(stat[1]) == os.getpid() and stat[0] != "Z"
                and b"cook_tpu_torch.mp.worker" in cmdline):
            pids.append(int(name))
    return pids


def test_stop_during_a_standby_replenish_leaves_no_worker(tmp_path):
    """The supervisor stopped right after a failover, while the standby
    that replaces the spent one still boots in the background: the boot
    is cut short and its process ended, as are the adopter and the
    workers (the reference's stop kills only the handles in its lists,
    and its replenish thread appends a standby that no stop ever ends)."""
    from cook_tpu_torch.mp.supervisor import MpRuntime

    runtime = MpRuntime(n_groups=1, standbys=1, poll_s=0.1,
                        data_dir=str(tmp_path / "data"))
    stopped = False
    try:
        assert len(_worker_children()) == 2
        old = runtime.supervisor.workers[0].describe["url"]
        runtime.supervisor.kill_worker(0)
        _wait_until("the adoption", 30, lambda: (lambda m: m["groups"][0][
            "alive"] and m["groups"][0]["url"] != old)(
                port_mp.read_route_map(runtime.supervisor.map_path)))
        # the replenishing standby is booting now
        _wait_until("the replacement standby's spawn", 10,
                    lambda: len(_worker_children()) >= 2)
        runtime.stop()
        stopped = True
        assert _worker_children() == []
    finally:
        if not stopped:
            runtime.stop()


def test_concurrent_submits_through_the_front_end(tmp_path):
    """More client threads than cores, one-group and 2PC submits at once,
    the interpreter switching threads often: every submit commits once,
    the front end counts every 2PC commit (its counters are updated with
    the loop lock held), and every job reads back from its group."""
    from concurrent.futures import ThreadPoolExecutor

    from cook_tpu_torch.mp.supervisor import MpRuntime

    runtime = MpRuntime(n_groups=2, standbys=0, inprocess=True,
                        poll_s=30.0, data_dir=str(tmp_path))
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        pool_a, pool_b = runtime.pools[1], runtime.pools[2]
        n_threads = 2 * (os.cpu_count() or 1) + 2

        def submit(i):
            pools = (pool_a, pool_b) if i % 2 else (pool_a, pool_a)
            jobs = [job_spec(f"st-{i}-{k}", p) for k, p in enumerate(pools)]
            resp = post(f"{runtime.url}/jobs", json={"jobs": jobs})
            return resp.status_code, [j["uuid"] for j in jobs]

        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            results = list(pool.map(submit, range(4 * n_threads),
                                    timeout=120))
        assert all(status == 201 for status, _ in results)
        frontend = get(f"{runtime.url}/debug/frontend").json()
        assert frontend["twopc"]["commits"] == 2 * n_threads
        uuids = [u for _, batch in results for u in batch]
        for uuid in uuids:
            assert get(f"{runtime.url}/jobs/{uuid}").status_code == 200
        listed = {j["uuid"] for j in get(
            f"{runtime.url}/list", params={"user": "alice"}).json()}
        assert set(uuids) <= listed
    finally:
        sys.setswitchinterval(switch)
        runtime.stop()
