"""The commit pipeline: one place every mutation becomes durable.

A copy of `cook_tpu/txn/log.py`, its imports the port's.

Pipeline (the reference's `transact-with-retries`, datomic.clj:79):

  1. idempotency — a txn_id already in the store's transaction table is
     answered from the recorded outcome, nothing re-applied;
  2. in-memory apply — the op handler runs under the store lock and the
     store emits the entity events, followed by a `txn/committed`
     record event carrying (txn_id, op, result).  Attached journal
     writers receive every event synchronously via the watcher fan-out,
     so by the time the lock drops the commit is written (not yet
     necessarily fsynced);
  3. journal durability — `JournalWriter.sync()` group-fsyncs: one
     fsync covers every event flushed so far, so concurrent commits
     share the disk barrier instead of paying one each;
  4. replication — callers that enforce a sync-ack bound await follower
     acks covering the commit's seq (rest/api.py `_await_replication`);
     the outcome records whether the bound was met.

Bounded retries (`DurabilityPolicy.max_attempts`) apply to handlers
raising `TransientTxnError`; `TransactionVetoed` is a definitive veto
and never retried.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Optional

from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.txn.ops import OPS, UnknownOperation
from cook_tpu_torch.txn.transaction import Transaction, TxnOutcome, new_txn_id
from cook_tpu_torch.utils import tracing
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)

# commits span lock-acquire + apply + group fsync: µs (in-memory dupe
# answer) to seconds (fsync stall on a loaded disk)
_COMMIT_BUCKETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, float("inf"))


class TransientTxnError(Exception):
    """An op failure worth retrying (the reference retries Datomic
    transactor hiccups a bounded number of times, datomic.clj:79)."""


@dataclass
class DurabilityPolicy:
    """The single knob-set for how hard a commit is."""

    # fsync the journal before the commit is reported (group commit:
    # one fsync covers all concurrently-flushed events)
    sync_journal: bool = True
    # bounded retries for TransientTxnError
    max_attempts: int = 3
    retry_backoff_s: float = 0.01


class TransactionLog:
    """Commit seam in front of a JobStore (+ optional journal writer)."""

    def __init__(self, store: JobStore, *,
                 journal: Any = None,
                 policy: Optional[DurabilityPolicy] = None):
        self.store = store
        self.journal = journal
        self.policy = policy or DurabilityPolicy()

    def commit(self, op: str, payload: Optional[dict] = None, *,
               txn_id: Optional[str] = None) -> TxnOutcome:
        txn = Transaction(op=op, payload=payload or {},
                          txn_id=txn_id or new_txn_id())
        return self.commit_txn(txn)

    def commit_txn(self, txn: Transaction) -> TxnOutcome:
        import time as _time

        handler = OPS.get(txn.op)
        if handler is None:
            raise UnknownOperation(txn.op)
        store = self.store
        attempts = 0
        t_commit = _time.perf_counter()
        while True:
            attempts += 1
            try:
                t_apply = _time.perf_counter()
                with store._lock:
                    cached = store.txn_results.get(txn.txn_id)
                    if cached is not None:
                        return TxnOutcome(
                            txn_id=txn.txn_id, op=cached.get("op", txn.op),
                            seq=cached.get("seq", 0),
                            result=cached.get("result"),
                            duplicate=True, attempts=attempts)
                    # correlation scope: every span opened while the op
                    # applies (including nested store spans) carries the
                    # transaction id, linking the span ring back to the
                    # client's X-Cook-Txn-Id
                    with tracing.correlate(txn.txn_id), \
                            tracing.span("txn.apply", op=txn.op):
                        result = handler(store, txn.payload)
                        seq = store.note_txn(txn.txn_id, txn.op, result)
                break
            except TransientTxnError:
                if attempts >= self.policy.max_attempts:
                    raise
                log.warning("transient failure committing %s (%s), "
                            "attempt %d/%d", txn.op, txn.txn_id, attempts,
                            self.policy.max_attempts)
                time.sleep(self.policy.retry_backoff_s)
        t_sync = _time.perf_counter()
        if self.journal is not None and self.policy.sync_journal:
            self.journal.sync()
        # phase walls feed the mp per-hop attribution: lock+apply vs
        # the group fsync (obs/distributed.py HOPS)
        phase_walls = {"apply": t_sync - t_apply,
                       "fsync": _time.perf_counter() - t_sync}
        # commit wall per op (apply under the store lock + group fsync;
        # idempotent replays answered from the txn table are excluded —
        # they pay neither), the txn-side half of the commit-ack latency
        # /debug/contention attributes
        global_registry.histogram(
            "txn.commit_seconds",
            "transaction commit wall seconds per op (apply + fsync)",
            buckets=_COMMIT_BUCKETS).observe(
            _time.perf_counter() - t_commit, {"op": txn.op})
        return TxnOutcome(txn_id=txn.txn_id, op=txn.op, seq=seq,
                          result=result, attempts=attempts,
                          phase_walls=phase_walls)
