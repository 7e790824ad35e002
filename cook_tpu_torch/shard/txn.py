"""ShardedTransactionLog: the partitioned commit pipeline.

A copy of `cook_tpu/shard/txn.py`, its imports the port's.

Single-shard ops (the overwhelming majority — every op whose keys hash
to one shard) commit through that shard's own `TransactionLog`: apply
under THAT shard's lock, group-fsync THAT shard's journal segment,
dedupe against THAT shard's idempotency table.  Two shards never touch,
so N shards give N independent commit pipelines — the fsync barriers
that serialize the single-journal design proceed in parallel.

Cross-shard ops (a pool move whose source and destination pools hash
differently, a submit batch spanning pools, a kill naming jobs on
several shards) commit as an ORDERED MULTI-SHARD APPLY:

  1. acquire every touched shard's lock in ascending shard order (one
     fixed global order — concurrent cross-shard commits cannot
     deadlock);
  2. answer duplicates from the LOWEST touched shard's idempotency
     table (the coordinator), then pre-validate vetoes across all
     shards BEFORE any shard applies (all-or-nothing under the held
     locks);
  3. apply per shard — each shard emits into its own event window and
     journal segment;
  4. seal the SAME txn_id on every touched shard (each shard's journal
     replay dedupes independently; a promoted replica answers retries
     from any shard it recovered);
  5. release the locks, group-fsync each touched segment, acknowledge
     ONCE to the client.

Lock order.  Shard locks are taken in ascending shard id, and only the
planned shards' (`_apply_multi`).  No code holding a shard lock takes
the REST layer's loop lock (`rest/api.CookApi.loop`): commits run with
the loop lock released (`_run_commit`), and the watchers a shard's
commit fans out to on the committing thread (the shard's journal
segment, the REST layer's replication condition, the columnar index,
the encode cache, the runtime predictor, the speculation guard, the
lifecycle histograms, the passport log, and the leader's kill fan-out,
which writes back to the same job's shard) take only their own leaf
locks and never another shard's.  A standby's shard followers apply on
one thread per shard under that shard's lock alone, and no watcher
touches the device from there.  A shard's resync listeners
(`persistence.restore_into`) run once that shard's lock is released:
the columnar index's rebuild reads every shard, so it takes every shard
lock in ascending id and then its own index lock, the order a committing
thread keeps (models/columnar.py).
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Optional, Sequence

from cook_tpu_torch.models.store import TransactionVetoed
from cook_tpu_torch.obs.contention import SloBurnTracker
from cook_tpu_torch.shard.router import RoutePlan
from cook_tpu_torch.shard.store import ShardedStore
from cook_tpu_torch.txn.log import (_COMMIT_BUCKETS, DurabilityPolicy,
                                   TransactionLog)
from cook_tpu_torch.txn.ops import OPS, UnknownOperation
from cook_tpu_torch.txn.transaction import (Transaction, TxnOutcome,
                                           new_txn_id)
from cook_tpu_torch.utils import tracing
from cook_tpu_torch.utils.metrics import global_registry


class ShardedTransactionLog:
    """Drop-in for `TransactionLog` over a `ShardedStore` (rest/api.py
    consumes either through the same `commit()` seam)."""

    def __init__(self, store: ShardedStore, *,
                 journals: Optional[Sequence[Any]] = None,
                 policy: Optional[DurabilityPolicy] = None):
        self.store = store
        self.policy = policy or DurabilityPolicy()
        self.journals = list(journals) if journals else \
            [None] * store.n_shards
        if len(self.journals) != store.n_shards:
            raise ValueError(f"{len(self.journals)} journals != "
                             f"{store.n_shards} shards")
        self.logs = [
            TransactionLog(shard, journal=journal, policy=self.policy)
            for shard, journal in zip(store.shards, self.journals)
        ]
        # per-shard commit service-time windows: the /debug/contention
        # per-shard breakdown reads these
        self.commit_ack = [SloBurnTracker(bucket_s=1.0,
                                          retention_s=3660.0 * 2)
                           for _ in range(store.n_shards)]
        self._commits = global_registry.counter(
            "shard.commits", "transactions committed per shard")
        self._cross = global_registry.counter(
            "shard.cross_shard_commits",
            "transactions that applied across more than one shard")
        self._commit_hist = global_registry.histogram(
            "shard.commit_seconds",
            "transaction commit wall seconds per shard (apply + fsync)",
            buckets=_COMMIT_BUCKETS)

    # the unsharded api reads txn.journal.telemetry; the sharded
    # pipeline's journals are per shard (ContentionObservatory shards_fn)
    journal = None

    def commit(self, op: str, payload: Optional[dict] = None, *,
               txn_id: Optional[str] = None) -> TxnOutcome:
        txn = Transaction(op=op, payload=payload or {},
                          txn_id=txn_id or new_txn_id())
        return self.commit_txn(txn)

    def commit_txn(self, txn: Transaction) -> TxnOutcome:
        if txn.op not in OPS:
            raise UnknownOperation(txn.op)
        plan = self.store.router.plan(txn.op, txn.payload, self.store)
        single = plan.single
        if single is not None:
            t0 = time.perf_counter()
            outcome = self.logs[single].commit_txn(txn)
            outcome.shard_seqs = {single: outcome.seq}
            self._note_commit(single, time.perf_counter() - t0,
                              duplicate=outcome.duplicate)
            return outcome
        return self._commit_multi(txn, plan)

    def _note_commit(self, shard: int, seconds: float, *,
                     duplicate: bool = False) -> None:
        labels = {"shard": str(shard)}
        self._commits.inc(1, labels)
        if not duplicate:
            self._commit_hist.observe(seconds, labels)
            self.commit_ack[shard].observe(seconds)

    # ------------------------------------------------------- multi-shard

    def _commit_multi(self, txn: Transaction,
                      plan: RoutePlan) -> TxnOutcome:
        t0 = time.perf_counter()
        shards = plan.shards
        stores = [self.store.shards[i] for i in shards]
        with contextlib.ExitStack() as stack:
            for store in stores:  # ascending shard order: deadlock-free
                stack.enter_context(store._lock)
            cached = stores[0].txn_results.get(txn.txn_id)
            if cached is not None:
                # every shard the original commit touched sealed the
                # txn_id with ITS OWN seq — reconstruct the per-shard
                # vector so batch callers never misattribute the
                # coordinator's seq to shard 0
                seqs = {}
                for i, store in zip(shards, stores):
                    rec = store.txn_results.get(txn.txn_id)
                    if rec is not None:
                        seqs[i] = rec.get("seq", 0)
                return TxnOutcome(
                    txn_id=txn.txn_id, op=cached.get("op", txn.op),
                    seq=cached.get("seq", 0), result=cached.get("result"),
                    duplicate=True, shard_seqs=seqs or None)
            with tracing.correlate(txn.txn_id), \
                    tracing.span("txn.apply_sharded", op=txn.op,
                                 shards=len(shards)):
                result = self._apply_multi(txn, plan)
                seqs = {i: store.note_txn(txn.txn_id, txn.op, result)
                        for i, store in zip(shards, stores)}
        t_sync = time.perf_counter()
        if self.policy.sync_journal:
            for i in shards:
                journal = self.journals[i]
                if journal is not None:
                    journal.sync()
        wall = time.perf_counter() - t0
        self._cross.inc()
        for i in shards:
            self._note_commit(i, wall)
        return TxnOutcome(txn_id=txn.txn_id, op=txn.op,
                          seq=max(seqs.values()), result=result,
                          shard_seqs=seqs,
                          phase_walls={
                              "apply": t_sync - t0,
                              "fsync": time.perf_counter() - t_sync})

    def _apply_multi(self, txn: Transaction, plan: RoutePlan) -> Any:
        """Apply one cross-shard transaction; caller holds every touched
        shard's lock.  Vetoes are raised BEFORE any shard mutates.

        LOCK DISCIPLINE: only PLANNED shards are touched.  An entity
        that migrated to an unplanned shard between plan and
        lock-acquire is simply not covered by this commit (the caller
        retries or observes a partial result) — reaching for an
        unplanned shard's lock here could deadlock against a concurrent
        cross-shard commit holding it while waiting on ours."""
        op, payload = txn.op, txn.payload
        planned = [self.store.shards[i] for i in plan.shards]
        if op == "jobs/submit":
            # all-or-nothing: validate duplicates across every target
            # shard first — shard A must not keep jobs a veto on shard B
            # rejected
            for i in plan.shards:
                sub = plan.per_shard.get(i, {})
                for job in sub.get("jobs", ()):
                    if job.uuid in self.store.shards[i].jobs:
                        raise TransactionVetoed(
                            f"job {job.uuid} already exists")
            for i in plan.shards:
                sub = plan.per_shard.get(i, {})
                self.store.shards[i].submit_jobs(sub.get("jobs", ()),
                                                 sub.get("groups", ()))
            return {"jobs": [j.uuid for j in payload.get("jobs", ())]}
        if op in ("jobs/kill", "group/kill"):
            if op == "group/kill":
                uuids = []
                for guuid in payload["groups"]:
                    group = self.store.groups.get(guuid)
                    if group is None:
                        raise TransactionVetoed(f"no such group {guuid}")
                    uuids.extend(group.job_uuids)
            else:
                uuids = list(payload["uuids"])
            killed = []
            for shard in planned:
                mine = [u for u in uuids if u in shard.jobs]
                if mine:
                    killed.extend(shard.kill_jobs(mine))
            return {"killed": killed}
        if op == "instance/cancel":
            cancelled = []
            for shard in planned:
                cancelled.extend(
                    tid for tid in payload["task_ids"]
                    if tid in shard.instances
                    and shard.mark_instance_cancelled(tid))
            return {"cancelled": cancelled}
        if op == "job/pool-move":
            moved = self._pool_move_planned(payload, plan)
            return {"uuid": payload["uuid"], "pool": payload["pool"],
                    "moved": moved}
        # a future op without a cross-shard rule: apply on the
        # coordinator shard (the router only multi-routes known ops)
        return OPS[op](planned[0], payload)

    def _pool_move_planned(self, payload: dict, plan: RoutePlan) -> bool:
        """Cross-shard pool move restricted to the planned (locked)
        shards; the move sequence itself is the facade's shared
        `move_job_cross_shard` (its lock acquisition is re-entrant
        under our held locks)."""
        uuid, new_pool = payload["uuid"], payload["pool"]
        dst_i = self.store.router.shard_for_pool(new_pool)
        if dst_i not in plan.shards or new_pool not in self.store.pools:
            return False
        src = next((self.store.shards[i] for i in plan.shards
                    if uuid in self.store.shards[i].jobs), None)
        if src is None:
            return False
        dst = self.store.shards[dst_i]
        if src is dst:
            return src.move_job_pool(uuid, new_pool)
        return self.store.move_job_cross_shard(src, dst, uuid, new_pool)

    # ------------------------------------------------------------- views

    def shard_view(self, params) -> list[dict]:
        """Per-shard contention rows for /debug/contention: lock
        profiler snapshot, journal telemetry, commit service-time
        percentiles/burn (`params` is the observatory's
        ContentionParams)."""
        rows = []
        for i, (store, journal) in enumerate(zip(self.store.shards,
                                                 self.journals)):
            profiler = getattr(store._lock, "profiler", None)
            telemetry = getattr(journal, "telemetry", None)
            rows.append({
                "shard": i,
                "last_seq": store.last_seq(),
                "jobs": len(store.jobs),
                "lock": (profiler.snapshot(top=5)
                         if profiler is not None else {"profiled": False}),
                "journal": (telemetry.snapshot()
                            if telemetry is not None else {}),
                "commit_ack": self.commit_ack[i].stats(
                    threshold_s=params.commit_ack_slo_s,
                    budget=params.commit_ack_budget,
                    fast_s=params.burn_fast_s,
                    slow_s=params.burn_slow_s),
            })
        return rows
