"""Shard-group worker: one process, one group's shards — and nothing else.

Port of `cook_tpu/mp/worker.py`.  A worker owns a contiguous block of the
global shard space (`topology.shards_of_group`).  It builds ONLY those
shards' stores (recovered from their journal segments under
`data_dir/shards/shard-NN/`), their journal writers, idempotency
tables, and replication feeds (`CookApi`'s /replication endpoints serve
this worker's segments), wrapped in a `ShardedStore` behind a
`GroupShardRouter` — so a key whose shard this group does not own is a
421, never a silent write into the wrong segment.  The segments are the
reference's format: a port worker, or a port standby adopting a group,
recovers a reference worker's `data_dir` and the other way round.

Two server surfaces per worker, both on the standard library
(`rest/server.ServerThread`):

  * the EXISTING REST surface (`CookApi`) — the front end forwards
    client requests here verbatim;
  * an internal RPC port — the 2PC participant
    (prepare/commit/abort), uuid -> owner resolution for the front
    end's scatter cache, and `adopt` for standby promotion.

Standby mode (shards=()): only the RPC port serves, answering ping and
waiting for `adopt`, which recovers the dead group's journal segments
and brings the REST surface up on the port reserved at spawn.

The control plane is host-only: a worker builds its API with no
scheduler and never touches the card.  `main` hides every CUDA device
from the process before anything could initialise one, so five workers
never hold five CUDA contexts.

Entry point: `python -m cook_tpu_torch.mp.worker --data-dir D --n-shards
N --group G --shards 0,1 ...` (the supervisor's spawn command).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Optional

from cook_tpu_torch.mp.topology import GroupShardRouter
from cook_tpu_torch.obs import distributed
from cook_tpu_torch.rest.http import Application, LoopLock, json_response
from cook_tpu_torch.utils import tracing
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)

_RPC_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5, float("inf"))

# staged prepares older than this are presumed aborted (the coordinator
# journals commit decisions BEFORE sending commits, so a commit for a
# GC'd prepare still applies from the payload it carries)
PENDING_TTL_S = 120.0


class TwoPCParticipant:
    """The worker-side half of `mp/twopc.py`.

    prepare = the full single-process validation (veto now or never),
    staging parsed entities; commit = answer from the idempotency
    table, else apply staged, else re-validate from the payload the
    commit RPC carries (a participant that lost its staged prepare —
    crash between phases, segment adoption — still converges); abort =
    drop the staged prepare.
    """

    def __init__(self, store, txn, api, group: Optional[int] = None):
        self.store = store
        self.txn = txn
        self.api = api
        self.group = group
        self._lock = threading.Lock()
        self._pending: dict[str, dict] = {}  # txn_id -> staged payload

    def _span_tags(self) -> dict:
        """Tags that route a participant span to this worker's pid
        track in the merged trace (obs/distributed.py)."""
        if self.group is None:
            return {}
        return {"group": self.group,
                "process": distributed.worker_process_label(self.group)}

    # ------------------------------------------------------------ phases

    def prepare(self, txn_id: str, op: str, user: str, payload: dict,
                *, parent: Optional[str] = None) -> dict:
        with tracing.correlate(txn_id), tracing.span(
                "mp.participant.prepare", parent=parent, op=op,
                **self._span_tags()):
            staged, err = self._validate(op, user, payload)
            if err is not None:
                # name the vetoing group in the ring: the stitched
                # trace for an aborted txn must say WHO said no
                tracing.record_event("twopc.veto", op=op,
                                     status=err.get("status"),
                                     **self._span_tags())
                return {"ok": False, **err}
            with self._lock:
                self._gc(time.monotonic())
                self._pending[txn_id] = {"op": op, "staged": staged,
                                         "at": time.monotonic()}
            return {"ok": True, "uuids": staged.get("uuids", [])}

    def commit(self, txn_id: str, op: str, user: str, payload: dict,
               *, parent: Optional[str] = None) -> dict:
        with tracing.correlate(txn_id), tracing.span(
                "mp.participant.commit", parent=parent, op=op,
                **self._span_tags()):
            return self._commit(txn_id, op, user, payload)

    def _commit(self, txn_id: str, op: str, user: str,
                payload: dict) -> dict:
        from cook_tpu_torch.models.store import TransactionVetoed

        cached = self.store.txn_results.get(txn_id)
        if cached is not None:
            return {"ok": True, "duplicate": True,
                    "result": cached.get("result")}
        with self._lock:
            entry = self._pending.pop(txn_id, None)
        if entry is None or entry["op"] != op:
            # lost prepare (restart / adoption): re-validate from the
            # payload the decision carries
            entry_staged, err = self._validate(op, user, payload)
            if err is not None:
                # post-decision validation failure: the local state
                # changed between prepare and replay (e.g. a killed
                # job's submit uuid reused).  Surface it — the
                # coordinator logs and leaves it pending.
                return {"ok": False, **err}
        else:
            entry_staged = entry["staged"]
        try:
            outcome = self.txn.commit(op, entry_staged["payload"],
                                      txn_id=txn_id)
        except TransactionVetoed as e:
            return {"ok": False, "status": 400, "error": str(e)}
        return {"ok": True, "duplicate": outcome.duplicate,
                "result": outcome.result,
                "shard_seqs": {str(s): q for s, q in
                               (outcome.shard_seqs or {}).items()}}

    def abort(self, txn_id: str, *,
              parent: Optional[str] = None) -> dict:
        with tracing.correlate(txn_id), tracing.span(
                "mp.participant.abort", parent=parent,
                **self._span_tags()):
            with self._lock:
                dropped = self._pending.pop(txn_id, None) is not None
            return {"ok": True, "dropped": dropped}

    # -------------------------------------------------------- validation

    def _validate(self, op: str, user: str, payload: dict):
        """(staged, None) on success, (None, error-dict) on veto.
        Staged carries the entity-object payload `txn.commit` consumes
        plus the uuids the coordinator reports back."""
        from cook_tpu_torch.shard.router import MisroutedKey

        try:
            if op == "jobs/submit":
                jobs, groups, err = self.api.parse_submission(
                    payload.get("jobs", []), payload.get("groups", []),
                    user)
                if err:
                    return None, {"status": 400, "error": err}
                return {"payload": {"jobs": jobs,
                                    "groups": list(groups.values())},
                        "uuids": [j.uuid for j in jobs]}, None
            if op == "jobs/kill":
                uuids = list(payload.get("uuids", ()))
                admins = self.api.config.admins
                for uuid in uuids:
                    job = self.store.jobs.get(uuid)
                    if job is None:
                        return None, {"status": 404,
                                      "error": f"unknown job {uuid}"}
                    if job.user != user and user not in admins:
                        return None, {
                            "status": 403,
                            "error": f"user {user} may not kill {uuid}"}
                return {"payload": {"uuids": uuids}, "uuids": uuids}, None
            return None, {"status": 400,
                          "error": f"op {op} not supported over 2PC"}
        except MisroutedKey as e:
            return None, {"status": 421, "error": str(e)}

    def _gc(self, now: float) -> None:
        stale = [txn_id for txn_id, entry in self._pending.items()
                 if now - entry["at"] > PENDING_TTL_S]
        for txn_id in stale:
            del self._pending[txn_id]


class _RpcSurface:
    """The worker's internal RPC app (`ServerThread`-compatible through
    `build_app`).  No auth stack: this port is fleet-internal (bind it to
    loopback or the supervisor's private network).  Its handlers hold the
    app's loop lock, as the reference's run on its event loop, and release
    it where the reference awaits an executor: around the 2PC phases (a
    commit ends in an fsync) and the adoption."""

    def __init__(self, worker: "ShardGroupWorker"):
        self.worker = worker
        self.loop = LoopLock()
        self._rpc_seconds = global_registry.histogram(
            "mp.rpc_seconds",
            "worker internal-RPC service seconds per method",
            buckets=_RPC_BUCKETS)

    def build_app(self) -> Application:
        app = Application(loop=self.loop)
        r = app.router
        r.add_get("/rpc/ping", self.ping)
        r.add_get("/rpc/resolve", self.resolve)
        r.add_post("/rpc/2pc/prepare", self.twopc("prepare"))
        r.add_post("/rpc/2pc/commit", self.twopc("commit"))
        r.add_post("/rpc/2pc/abort", self.twopc("abort"))
        r.add_post("/rpc/adopt", self.adopt)
        return app

    def ping(self, request):
        return json_response(self.worker.describe())

    def resolve(self, request):
        """uuid -> owned-entity kind, for the front end's scatter
        resolution (a kill/read names uuids, not pools)."""
        if not self.worker.active:
            return json_response({"error": "standby"}, status=503)
        store = self.worker.store
        owned = {}
        for uuid in request.query.getall("uuid", []):
            if uuid in store.jobs:
                owned[uuid] = "job"
            elif uuid in store.instances:
                owned[uuid] = "instance"
            elif uuid in store.groups:
                owned[uuid] = "group"
        return json_response({"group": self.worker.group, "owned": owned})

    def twopc(self, method: str):
        def handler(request):
            if not self.worker.active:
                return json_response({"ok": False, "error": "standby"},
                                     status=503)
            body = request.json()
            participant = self.worker.participant
            # the coordinator's trace context: the participant's span
            # parents under the X-Cook-Parent-Span phase span
            parent = request.headers.get(distributed.PARENT_SPAN_HEADER)
            t0 = time.perf_counter()
            # commits end in fsync — other RPCs run meanwhile
            with self.loop.released():
                if method == "abort":
                    reply = participant.abort(body["txn_id"], parent=parent)
                else:
                    reply = getattr(participant, method)(
                        body["txn_id"], body.get("op", ""),
                        body.get("user", ""), body.get("payload") or {},
                        parent=parent)
            self._rpc_seconds.observe(time.perf_counter() - t0,
                                      {"method": method})
            return json_response(reply)

        return handler

    def adopt(self, request):
        """Standby promotion: recover the named group's journal
        segments, bring the REST surface up on the reserved port, and
        start answering as that group."""
        body = request.json()
        if self.worker.active:
            return json_response(
                {"ok": False,
                 "error": f"already serving group {self.worker.group}"},
                status=409)
        group = int(body["group"])
        parent = request.headers.get(distributed.PARENT_SPAN_HEADER)
        corr = request.headers.get(distributed.TXN_HEADER)
        try:
            with self.loop.released():
                # the adopting group names itself in the failover trace
                with tracing.correlate(corr), tracing.span(
                        "mp.adopt", parent=parent, group=group,
                        process=distributed.worker_process_label(group)):
                    describe = self.worker.adopt(
                        group, [int(s) for s in body["shards"]],
                        tuple(body.get("pools") or ("default",)))
        except Exception as e:  # noqa: BLE001 — adoption failure must
            # reach the supervisor as a reply, not a hung socket
            log.exception("adoption failed")
            return json_response(
                {"ok": False, "error": f"{type(e).__name__}: {e}"},
                status=500)
        return json_response({"ok": True, **describe})


class ShardGroupWorker:
    """One worker process's internals (also embeddable in-process for
    tests and harnesses)."""

    def __init__(self, *, data_dir: str, n_shards: int,
                 group: Optional[int] = None, shards=(),
                 pools: tuple = ("default",),
                 port: Optional[int] = None,
                 rpc_port: Optional[int] = None,
                 config=None, clock=None,
                 journal_kw: Optional[dict] = None,
                 history_sample_s: float = 0.5):
        from cook_tpu_torch.rest.server import ServerThread, free_port

        self.data_dir = data_dir
        self.n_shards = n_shards
        self.group = group
        self.shards: tuple = tuple(sorted(shards))
        self.pools = tuple(pools)
        self.config = config
        # wall-clock ms by default (rest/server.py uses the same): job
        # timestamps must share a domain with the 2PC decision log's
        # wall stamps or the front end's stitched timeline events
        # render decades away from the worker's own
        self.clock = clock or (lambda: int(time.time() * 1000))
        self.journal_kw = dict(journal_kw or {})
        self.history_sample_s = history_sample_s
        self.port = port or free_port()
        self.rpc_port = rpc_port or free_port()
        self.store = None
        self.txn = None
        self.api = None
        self.history = None
        self.journals: list = []
        self.participant: Optional[TwoPCParticipant] = None
        self.rest_server = None
        self._rest_started = False
        self.rpc_server = ServerThread(_RpcSurface(self),
                                       port=self.rpc_port)
        self._adoptions = global_registry.counter(
            "mp.adoptions",
            "standby adoptions of a dead worker's journal segments")
        if self.shards:
            self._activate()

    @property
    def active(self) -> bool:
        return self.store is not None

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    @property
    def rpc_url(self) -> str:
        return f"http://127.0.0.1:{self.rpc_port}"

    def describe(self) -> dict:
        return {"ok": True, "active": self.active, "group": self.group,
                "shards": list(self.shards), "url": self.url,
                "rpc_url": self.rpc_url, "pid": os.getpid(),
                "pools": list(self.pools)}

    # ------------------------------------------------------------- build

    def _activate(self) -> None:
        """Build this group's slice of the control plane: recover each
        owned shard from its GLOBAL segment dir, wire journals, the
        sharded commit pipeline, and the REST api."""
        from cook_tpu_torch.models import persistence
        from cook_tpu_torch.models.entities import Pool
        from cook_tpu_torch.obs.tsdb import HistoryConfig, MetricsHistory
        from cook_tpu_torch.rest.api import ApiConfig, CookApi
        from cook_tpu_torch.rest.server import ServerThread
        from cook_tpu_torch.shard import ShardedStore, ShardedTransactionLog
        from cook_tpu_torch.shard import journal as shard_journal

        clock = self.clock
        router = GroupShardRouter(self.n_shards, self.shards)
        locals_: list = []
        for gi in self.shards:
            directory = shard_journal.shard_dir(self.data_dir, gi)
            recovered = persistence.recover(
                directory, clock=clock,
                store_factory=shard_journal._shard_factory(gi, clock))
            locals_.append(recovered
                           or shard_journal._shard_factory(gi, clock)())
        self.store = ShardedStore(len(self.shards), clock=clock,
                                  router=router, shards=locals_)
        for gi, shard in zip(self.shards, self.store.shards):
            directory = shard_journal.shard_dir(self.data_dir, gi)
            os.makedirs(directory, exist_ok=True)
            writer = persistence.JournalWriter(
                os.path.join(directory, "journal.jsonl"),
                **self.journal_kw)
            shard.add_watcher(writer)
            self.journals.append(writer)
        self.txn = ShardedTransactionLog(self.store,
                                         journals=self.journals)
        for pool in self.pools:
            # register ONLY the pools this group owns: fleet-wide reads
            # (/list, /usage) iterate registered pools, and an unowned
            # pool would trip MisroutedKey mid-read.  A submit for an
            # unowned pool is still rejected (unknown pool) — the front
            # end never sends one unless its map is stale.
            try:
                self.store.shard_for_pool(pool)
            except Exception:  # noqa: BLE001 — MisroutedKey
                continue
            if pool not in self.store.pools:
                self.store.set_pool(Pool(name=pool))
        self.history = MetricsHistory(
            config=HistoryConfig(sample_s=self.history_sample_s))
        self.api = CookApi(self.store, None, self.config or ApiConfig(),
                           txn=self.txn, history=self.history)
        # REST-side spans/walls route to this worker's merged-trace pid
        # track and X-Cook-Hop-Walls header (obs/distributed.py)
        self.api.process_label = distributed.worker_process_label(
            self.group)
        self.participant = TwoPCParticipant(self.store, self.txn,
                                            self.api, group=self.group)
        self.rest_server = ServerThread(self.api, port=self.port)

    def adopt(self, group: int, shards, pools: tuple) -> dict:
        """Standby -> worker: take over a dead group's segments."""
        if self.active:
            raise RuntimeError(f"already serving group {self.group}")
        self.group = group
        self.shards = tuple(sorted(shards))
        self.pools = tuple(pools)
        self._activate()
        self.rest_server.start()
        self._rest_started = True
        self.history.start()
        self._adoptions.inc()
        log.info("adopted group %d (shards %s), serving at %s",
                 group, list(self.shards), self.url)
        return self.describe()

    # --------------------------------------------------------- lifecycle

    def start(self) -> "ShardGroupWorker":
        self.rpc_server.start()
        if self.active:
            self.rest_server.start()
            self._rest_started = True
            self.history.start()
        return self

    def stop(self) -> None:
        if self.history is not None:
            self.history.stop()
        if self._rest_started and self.rest_server is not None:
            self.rest_server.stop()
        self.rpc_server.stop()
        for journal in self.journals:
            journal.close()
        self.journals = []


def main(argv=None) -> int:
    # workers never touch the device: the control plane is host-only.
    # Hidden before any CUDA call, so no worker creates a CUDA context
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import argparse
    import signal

    parser = argparse.ArgumentParser(
        description="cook mp shard-group worker process")
    parser.add_argument("--data-dir", required=True)
    parser.add_argument("--n-shards", type=int, required=True)
    parser.add_argument("--group", type=int, default=None)
    parser.add_argument("--shards", default="",
                        help="comma-separated global shard ids; empty "
                             "for a standby")
    parser.add_argument("--pools", default="default")
    parser.add_argument("--port", type=int, default=None)
    parser.add_argument("--rpc-port", type=int, default=None)
    parser.add_argument("--ready-file", default="")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stop.set())
    shards = tuple(int(s) for s in args.shards.split(",") if s != "")
    worker = ShardGroupWorker(
        data_dir=args.data_dir, n_shards=args.n_shards,
        group=args.group, shards=shards,
        pools=tuple(p for p in args.pools.split(",") if p),
        port=args.port, rpc_port=args.rpc_port).start()
    ready = worker.describe()
    if args.ready_file:
        tmp = args.ready_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(ready, f)
        os.replace(tmp, args.ready_file)
    print(json.dumps(ready), flush=True)

    stop.wait()
    worker.stop()
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
