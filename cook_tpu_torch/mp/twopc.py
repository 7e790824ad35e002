"""Cross-group transactions: two-phase ordered apply over RPC.

Port of `cook_tpu/mp/twopc.py`.  This generalizes `shard/txn.py`'s
in-process discipline to workers in separate processes:

  * ascending order — participants are contacted in ascending GROUP
    order for both phases, the cross-process analog of the ascending
    shard-lock acquisition that makes concurrent cross-shard commits
    deadlock-free;
  * all-or-nothing veto — prepare runs the full single-process
    validation on every participant (rest/api.py `parse_submission`
    for submits, existence + ownership for kills); ANY veto aborts the
    whole transaction and the client sees the same 4xx a one-process
    submit would have produced;
  * single journaled decision — the coordinator appends
    {"decision": "commit"} (fsynced) BEFORE sending any commit, and
    {"decision": "done"} after every participant acknowledged.  A
    decision with no "done" is replayed on reconnect/restart; no
    decision means presumed abort (participants GC their staged
    prepare after a TTL);
  * idempotent replay — the commit RPC CARRIES the payload, so a
    participant that lost its staged prepare (crash between phases, a
    standby that adopted the segments) re-validates and applies from
    the payload, while one that already applied answers from its
    per-shard idempotency table.  Replaying a decision any number of
    times converges.

The reference's coordinator is async on the front end's event loop; this
one is synchronous: it runs on the thread of the request that needs it,
which the front end runs with its loop lock released (`mp/router.py`), so
one transaction's RPCs and fsyncs hold no other request back.  The
injectable `post` transport is how tests drive veto/abort/replay paths
without sockets.  The decision log's format is the reference's: either
package's coordinator replays the other's log.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Optional

from cook_tpu_torch.obs import distributed
from cook_tpu_torch.utils import tracing
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)

# cross-group txns pay two RPC rounds + the participants' fsyncs: ms to
# seconds under fsync stalls
_TXN_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                1.0, 2.5, 5.0, 10.0, float("inf"))

# transport: (url, body_dict, timeout_s, headers) -> (status:int,
# body:dict) — headers carry the trace context (X-Cook-Txn-Id +
# X-Cook-Parent-Span) so participants open child spans under the
# coordinator's phase span (obs/distributed.py header contract)
PostFn = Callable[[str, dict, float, Optional[dict]], tuple]


class DecisionLog:
    """The coordinator's write-ahead decision journal (jsonl).

    Two record kinds per txn_id: the COMMIT decision (op, user, and the
    per-group payload split — everything replay needs to re-send
    commits) and the DONE marker once every participant acknowledged.
    Append is flush+fsync: the decision must be durable before the
    first commit RPC leaves, or a coordinator crash could leave some
    participants committed with no record to finish the rest.
    """

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._lock = threading.Lock()
        self._f = open(path, "a", encoding="utf-8")

    def append(self, record: dict) -> None:
        line = json.dumps(record, separators=(",", ":"))
        with self._lock:
            self._f.write(line + "\n")
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.close()

    def _scan(self):
        """Durable records, oldest first (torn tail dropped — a
        half-written line is a decision that never became durable,
        i.e. presumed abort)."""
        if not os.path.exists(self.path):
            return
        with open(self.path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    return  # torn tail: nothing after it is durable

    def outstanding(self) -> dict[str, dict]:
        """Committed-but-not-done decisions, replayed at coordinator
        start (and after failovers): txn_id -> decision record."""
        pending: dict[str, dict] = {}
        for record in self._scan():
            txn_id = record.get("txn_id")
            if record.get("decision") == "commit":
                pending[txn_id] = record
            elif record.get("decision") == "done":
                pending.pop(txn_id, None)
        return pending

    def find_for_uuid(self, uuid: str) -> tuple[Optional[dict],
                                                Optional[float]]:
        """The newest commit decision whose per-group payload pins this
        job uuid, plus its done-marker timestamp (None while commits
        are still pending replay) — the timeline stitch's source."""
        found: Optional[dict] = None
        done_t: Optional[float] = None
        for record in self._scan():
            if record.get("decision") == "commit":
                for payload in (record.get("groups") or {}).values():
                    jobs = (payload or {}).get("jobs") or []
                    uuids = (payload or {}).get("uuids") or []
                    if uuid in uuids or any(
                            j.get("uuid") == uuid for j in jobs):
                        found, done_t = record, None
                        break
            elif (found is not None and record.get("decision") == "done"
                    and record.get("txn_id") == found.get("txn_id")):
                done_t = record.get("t")
        return found, done_t


class TwoPCCoordinator:
    """Drives prepare/decide/commit across worker RPC endpoints."""

    def __init__(self, post: PostFn, decisions: DecisionLog, *,
                 rpc_timeout_s: float = 10.0,
                 commit_attempts: int = 3,
                 retry_backoff_s: float = 0.2):
        self.post = post
        self.decisions = decisions
        self.rpc_timeout_s = rpc_timeout_s
        self.commit_attempts = commit_attempts
        self.retry_backoff_s = retry_backoff_s
        # one replay at a time: the reference's replays interleave on one
        # event loop, and two of them must not re-send one decision's
        # commits side by side on two threads here
        self._replay_lock = threading.Lock()
        self._prepares = global_registry.counter(
            "mp.txn.prepares",
            "cross-group 2PC prepare RPCs, per outcome (ok/veto/error)")
        self._commits = global_registry.counter(
            "mp.txn.commits",
            "cross-group 2PC commit RPCs, per outcome (ok/failed)")
        self._aborts = global_registry.counter(
            "mp.txn.aborts", "cross-group 2PC aborts sent to participants")
        self._txn_seconds = global_registry.histogram(
            "mp.txn.seconds",
            "cross-group transaction wall seconds (first prepare sent -> "
            "last commit acked), per op", buckets=_TXN_BUCKETS)

    def _rpc(self, rpc_url: str, method: str, body: dict, *,
             group: Optional[int] = None) -> tuple[int, dict]:
        # trace context on every 2PC RPC: the participant opens its
        # child span under the coordinator's phase span
        headers = {distributed.PARENT_SPAN_HEADER: f"twopc.{method}"}
        if body.get("txn_id"):
            headers[distributed.TXN_HEADER] = body["txn_id"]
        t0 = time.perf_counter()
        try:
            status, payload = self.post(
                f"{rpc_url}/rpc/2pc/{method}", body, self.rpc_timeout_s,
                headers)
            if not isinstance(payload, dict):
                payload = {"ok": False, "error": f"non-JSON {method} reply"}
        except Exception as e:  # noqa: BLE001 — transport failure is a
            # participant outcome, not a coordinator crash
            status, payload = 0, {"ok": False, "transport_error": True,
                                  "error": f"{type(e).__name__}: {e}"}
        tracing.record_span(
            f"twopc.{method}", time.perf_counter() - t0,
            txn_id=body.get("txn_id"),
            process=distributed.PROCESS_COORDINATOR,
            **({} if group is None else {"group": group}),
            **({} if payload.get("ok") else {"error": True}))
        return status, payload

    def run(self, *, txn_id: str, op: str, user: str,
            per_group: dict[int, dict],
            rpc_urls: dict[int, str]) -> dict:
        """One cross-group transaction.  Returns
        {"ok": True, "results": {group: commit-reply},
         "pending_groups": [...]} on commit (pending_groups lists
        participants whose commit RPC kept failing — the decision
        stands and replay finishes them), or
        {"ok": False, "status": http-ish, "error": str} on veto/error.
        """
        groups = sorted(per_group)
        t0 = time.perf_counter()
        prepared: list[int] = []
        prepare_s: dict[str, float] = {}
        for g in groups:  # ascending group order, both phases
            tp0 = time.perf_counter()
            status, reply = self._rpc(rpc_urls[g], "prepare", {
                "txn_id": txn_id, "op": op, "user": user,
                "payload": per_group[g]}, group=g)
            prepare_s[str(g)] = time.perf_counter() - tp0
            if not reply.get("ok"):
                outcome = ("error" if reply.get("transport_error")
                           or status >= 500 else "veto")
                self._prepares.inc(1, {"outcome": outcome})
                self._abort(txn_id, prepared, rpc_urls)
                return {"ok": False,
                        "status": int(reply.get("status")
                                      or (502 if outcome == "error"
                                          else 400)),
                        "error": reply.get("error", "prepare failed"),
                        "vetoed_by": g}
            self._prepares.inc(1, {"outcome": "ok"})
            prepared.append(g)
        # the single decision: durable BEFORE any participant applies.
        # `t` + per-group prepare walls ride in the record so the
        # timeline stitch can place the cross-group hop without a
        # second fsync.
        decision = {"txn_id": txn_id, "op": op, "user": user,
                    "decision": "commit", "t": time.time(),
                    "prepare_s": prepare_s,
                    "groups": {str(g): per_group[g] for g in groups},
                    "rpc_urls": {str(g): rpc_urls[g] for g in groups}}
        td0 = time.perf_counter()
        self.decisions.append(decision)
        # the fsynced decision write is its own span on the
        # coordinator's pid track — it IS the commit point
        tracing.record_span(
            "twopc.decision_write", time.perf_counter() - td0,
            txn_id=txn_id, op=op,
            process=distributed.PROCESS_COORDINATOR)
        results, pending = self._commit_all(txn_id, op, user, per_group,
                                            rpc_urls)
        if not pending:
            self.decisions.append(
                {"txn_id": txn_id, "decision": "done", "t": time.time()})
        wall = time.perf_counter() - t0
        self._txn_seconds.observe(wall, {"op": op})
        tracing.record_span(
            "twopc.txn", wall, txn_id=txn_id, op=op,
            process=distributed.PROCESS_COORDINATOR)
        return {"ok": True, "results": results,
                "pending_groups": sorted(pending)}

    def _commit_all(self, txn_id: str, op: str, user: str,
                    per_group: dict[int, dict],
                    rpc_urls: dict[int, str]):
        results: dict[int, dict] = {}
        pending: set[int] = set()
        for g in sorted(per_group):
            reply = None
            for attempt in range(self.commit_attempts):
                _status, reply = self._rpc(rpc_urls[g], "commit", {
                    "txn_id": txn_id, "op": op, "user": user,
                    "payload": per_group[g]}, group=g)
                if reply.get("ok"):
                    break
                time.sleep(self.retry_backoff_s * (attempt + 1))
            if reply.get("ok"):
                self._commits.inc(1, {"outcome": "ok"})
                results[g] = reply
            else:
                # the decision stands; this participant applies on
                # replay (or after a standby adopts its segments)
                self._commits.inc(1, {"outcome": "failed"})
                log.warning("2pc %s: commit to group %d failed (%s); "
                            "left for replay", txn_id, g,
                            reply.get("error"))
                pending.add(g)
        return results, pending

    def _abort(self, txn_id: str, prepared: list[int],
               rpc_urls: dict[int, str]) -> None:
        """Best-effort abort of already-prepared participants (reverse
        order — unwinding the ascending acquisition).  Participants
        also GC staged prepares by TTL, so a lost abort only delays
        cleanup (presumed abort: no decision record means the txn never
        happened)."""
        for g in reversed(prepared):
            self._aborts.inc()
            self._rpc(rpc_urls[g], "abort", {"txn_id": txn_id}, group=g)

    def replay(self, rpc_urls: Optional[dict[int, str]] = None) -> dict:
        """Finish outstanding decisions (coordinator restart, worker
        reconnect, post-failover).  Commits are idempotent on the
        participants, so replaying a decision that already applied is a
        duplicate answer, not a re-apply.  `rpc_urls` overrides the
        endpoints recorded in the decision (a promoted standby serves
        the dead worker's groups at a NEW url)."""
        with self._replay_lock:
            outstanding = self.decisions.outstanding()
            finished, still_pending = 0, 0
            for txn_id, record in outstanding.items():
                per_group = {int(g): payload
                             for g, payload in record["groups"].items()}
                urls = {int(g): url for g, url
                        in (record.get("rpc_urls") or {}).items()}
                if rpc_urls:
                    urls.update(rpc_urls)
                _results, pending = self._commit_all(
                    txn_id, record["op"], record.get("user", ""),
                    per_group, urls)
                if pending:
                    still_pending += 1
                else:
                    finished += 1
                    self.decisions.append(
                        {"txn_id": txn_id, "decision": "done",
                         "t": time.time()})
            return {"outstanding": len(outstanding), "finished": finished,
                    "still_pending": still_pending}
