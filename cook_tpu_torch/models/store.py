"""Event-sourced in-memory job store: the framework's source of truth.

Port of `cook_tpu/models/store.py`: submits, launches, status updates,
kills, retries, instance progress and output, shares, quotas, pool moves
(`move_job_pool`, whose `job/pool-moved` event the columnar index and
the encode cache consume), the gang-submit invariants
(`_validate_gangs`), the queries the scheduler reads, and what the commit pipeline (`txn/`), the journal
(`models/persistence.py`) and the elastic capacity plane read: the
event's journal line (`Event.to_json`), the transaction table
(`record_txn` / `note_txn`), the runtime-mutable config
(`update_dynamic_config`), the capacity ledger (`apply_capacity_moves`
and its queries), `reset_seq`, `snapshot_events`, `recovered_stats` and
the resync listeners.  The store lock is the contention observatory's
profiled lock (`obs/contention.profiled_store_lock`), as in the
reference: every `with store._lock:` reports its wait and hold per call
site to `/debug/contention`.  A shard of the sharded store (`shard/`)
is a JobStore built with `lock_name="store-s{i}"` and `shard_id=i`, and
a cross-shard pool move is its shard handoff (`shard_out_job` on the
source, `shard_in_job` on the destination).

Plays the role Datomic plays in the reference (`cook.datomic`,
`cook/datomic.clj`): serialized transactions,
a transaction-report feed that downstream consumers subscribe to (the kill
fan-out in `scheduler.clj:378` tails it), and preconditions that can veto a
transaction (`:job/allowed-to-start?`).  Instead of a remote transactor we
use a process-local lock + an append-only event log; leader failover replays
the log (or a snapshot) to rebuild state.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional, Sequence

from cook_tpu_torch.models import state as state_mod
from cook_tpu_torch.models.entities import (
    DEFAULT_USER,
    Group,
    Instance,
    InstanceStatus,
    Job,
    JobState,
    Pool,
    Quota,
    Resources,
    Share,
)
from cook_tpu_torch.models.reasons import Reason, get_reason
from cook_tpu_torch.obs.contention import profiled_store_lock


@dataclass(frozen=True)
class Event:
    """One entry in the transaction log.

    `entities` holds references to the post-transaction entity objects the
    event touched (all immutable — mutation always replaces), keyed by
    entity kind ("job", "instance", "group", "pool", "share", "quota").
    """

    seq: int
    kind: str
    data: dict[str, Any]
    entities: Optional[dict[str, Any]] = None

    def to_json(self) -> str:
        from cook_tpu_torch.models import codec

        d = {"seq": self.seq, "kind": self.kind, "data": self.data}
        if self.entities:
            d["entities"] = {k: codec.encode(v)
                             for k, v in self.entities.items()}
        return json.dumps(d)


Watcher = Callable[[Event], None]


class TransactionVetoed(Exception):
    pass


class JobStore:
    """Thread-safe state store.  All mutation goes through `_transact`, which
    serializes writers, applies pure transitions, appends events, and fans
    them out to watchers (the tx-report-queue analog)."""

    def __init__(self, *, mea_culpa_limit: int = 5,
                 clock: Callable[[], int] = None,
                 lock_name: str = "store", shard_id: Optional[int] = None):
        # every `with store._lock:` in the tree reports its wait/hold to
        # the contention observatory, labeled by calling function.  A
        # sharded store (shard/) builds one JobStore per shard with
        # lock_name "store-s{i}", so each shard's lock is attributed on
        # its own at /debug/contention
        self._lock = profiled_store_lock(lock_name)
        # which shard of a ShardedStore this store is (None = unsharded)
        self.shard_id = shard_id
        self._seq = itertools.count(1)
        self._last_seq = 0
        self._events: list[Event] = []
        self._watchers: list[Watcher] = []
        # what the last persistence.recover replayed (snapshot seq,
        # journal entries)
        self.recovered_stats: dict[str, int] = {}
        self._resync_listeners: list[Callable[[], None]] = []
        self.mea_culpa_limit = mea_culpa_limit
        # clock returns milliseconds; injectable for the frozen-time simulator
        self.clock = clock or (lambda: 0)

        self.jobs: dict[str, Job] = {}
        # submission order per job — the deterministic tie-breaker the
        # reference gets from :db/id entity ids (tools.clj:614-641)
        self.job_seq: dict[str, int] = {}
        self.instances: dict[str, Instance] = {}
        self.groups: dict[str, Group] = {}
        self.pools: dict[str, Pool] = {}
        self.shares: dict[tuple[str, str], Share] = {}  # (user, pool)
        self.quotas: dict[tuple[str, str], Quota] = {}
        # runtime-mutable config (reference: Datomic-resident rebalancer
        # params + incremental configs); the rebalance cycle reads its
        # "rebalancer" overrides
        self.dynamic_config: dict[str, Any] = {}
        # committed-transaction table: txn_id -> {op, seq, result}
        # (cook_tpu_torch.txn) — the idempotency record.  Journaled via
        # txn/committed events and included in snapshots, so a recovered
        # leader answers retried commits of acked transactions without
        # re-applying them.  Insertion-ordered; bounded by
        # TXN_RESULTS_WINDOW.
        self.txn_results: dict[str, dict[str, Any]] = {}
        # elastic capacity ledger (cook_tpu_torch/elastic/): (lender,
        # borrower) -> {mem, cpus, gpus} currently on loan.  Mutated only
        # through the pool/capacity-delta txn op; every mutation's event
        # carries the full post-transaction ledger so journal replay is a
        # pure upsert — a recovered leader reconciles cluster capacity
        # from THIS table.
        self.capacity_ledger: dict[tuple[str, str], dict[str, float]] = {}

        # secondary indexes
        self._user_jobs: dict[str, set[str]] = {}
        self._pool_pending: dict[str, set[str]] = {}
        self._pool_running: dict[str, set[str]] = {}

    # ------------------------------------------------------------------ infra

    def add_watcher(self, watcher: Watcher) -> None:
        with self._lock:
            self._watchers.append(watcher)

    def add_resync_listener(self, listener: Callable[[], None]) -> None:
        """Register a callback for wholesale state replacement
        (persistence.restore_into).  Event watchers see each incremental
        commit; a resync invalidates everything at once, so derived state
        (columnar index, caches) rebuilds from the store instead."""
        with self._lock:
            self._resync_listeners.append(listener)

    def _notify_resync(self) -> None:
        for listener in list(self._resync_listeners):
            listener()

    def events_since(self, seq: int) -> list[Event]:
        with self._lock:
            return [e for e in self._events if e.seq > seq]

    def last_seq(self) -> int:
        """Sequence number of the last committed event (survives recovery —
        unlike `_events`, which only holds this process's events)."""
        with self._lock:
            return self._last_seq

    def reset_seq(self, seq: int) -> None:
        """Resume event numbering after `seq` (recovery from snapshot or
        journal replay)."""
        with self._lock:
            self._seq = itertools.count(seq + 1)
            self._last_seq = seq

    # retained recent-event window for events_since debugging/polling; the
    # durable record is the journal, so this may be bounded
    EVENT_WINDOW = 10_000

    def _emit(self, kind: str, data: dict[str, Any], **entities: Any) -> Event:
        event = Event(seq=next(self._seq), kind=kind, data=data,
                      entities=entities or None)
        self._last_seq = event.seq
        self._events.append(event)
        if len(self._events) > 2 * self.EVENT_WINDOW:
            del self._events[:-self.EVENT_WINDOW]
        return event

    def _fan_out(self, events: list[Event]) -> None:
        for event in events:
            for watcher in list(self._watchers):
                watcher(event)

    # ----------------------------------------------------------- transactions

    # committed-transaction records retained for idempotency answers; old
    # enough duplicates (>10k commits ago) re-apply, which is safe for
    # every registered op (all are state-idempotent upserts/kills)
    TXN_RESULTS_WINDOW = 10_000

    def record_txn(self, txn_id: str, op: str, seq: int, result: Any) -> None:
        """Remember a committed transaction's outcome (also called from
        journal/replication replay, persistence.apply_journal)."""
        with self._lock:
            self.txn_results[txn_id] = {"op": op, "seq": seq,
                                        "result": result}
            while len(self.txn_results) > self.TXN_RESULTS_WINDOW:
                self.txn_results.pop(next(iter(self.txn_results)))

    def note_txn(self, txn_id: str, op: str, result: Any) -> int:
        """Seal a transaction: emit the txn/committed record event (it
        replicates and journals like any entity event) and record the
        outcome for idempotency.  Called by cook_tpu_torch.txn with the store
        lock held, right after the op handler applied."""
        with self._lock:
            event = self._emit("txn/committed",
                               {"txn_id": txn_id, "op": op, "result": result})
            self.record_txn(txn_id, op, event.seq, result)
            self._fan_out([event])
            return event.seq

    # ---------------------------------------------------------------- indexes

    def _index_job(self, job: Job, old: Optional[Job]) -> None:
        self._user_jobs.setdefault(job.user, set()).add(job.uuid)
        pool = job.pool
        pending = self._pool_pending.setdefault(pool, set())
        running = self._pool_running.setdefault(pool, set())
        pending.discard(job.uuid)
        running.discard(job.uuid)
        if job.state == JobState.WAITING:
            pending.add(job.uuid)
        elif job.state == JobState.RUNNING:
            running.add(job.uuid)

    # ---------------------------------------------------------------- indexes

    def _index_job(self, job: Job, old: Optional[Job]) -> None:
        self._user_jobs.setdefault(job.user, set()).add(job.uuid)
        pool = job.pool
        pending = self._pool_pending.setdefault(pool, set())
        running = self._pool_running.setdefault(pool, set())
        pending.discard(job.uuid)
        running.discard(job.uuid)
        if job.state == JobState.WAITING:
            pending.add(job.uuid)
        elif job.state == JobState.RUNNING:
            running.add(job.uuid)

    # ----------------------------------------------------------------- writes

    def submit_jobs(
        self,
        jobs: Sequence[Job],
        groups: Sequence[Group] = (),
    ) -> list[str]:
        """Atomically create a batch of jobs (+ groups).  The reference makes
        this atomic with a metatransaction commit-latch
        (metatransaction/core.clj:47-140); here batch atomicity falls out of
        the store lock."""
        with self._lock:
            now = self.clock()
            for job in jobs:
                if job.uuid in self.jobs:
                    raise TransactionVetoed(f"job {job.uuid} already exists")
            self._validate_gangs(jobs)
            for group in groups:
                self.groups[group.uuid] = group
            created_jobs = []
            touched_groups: dict[str, bool] = {}
            for job in jobs:
                if job.submit_time_ms == 0:
                    job = job.with_(submit_time_ms=now)
                job = job.with_(last_waiting_start_time_ms=now)
                self.jobs[job.uuid] = job
                self.job_seq[job.uuid] = len(self.job_seq)
                self._index_job(job, None)
                if job.group_uuid and job.group_uuid in self.groups:
                    g = self.groups[job.group_uuid]
                    self.groups[job.group_uuid] = dataclasses.replace(
                        g, job_uuids=g.job_uuids + (job.uuid,)
                    )
                    touched_groups[job.group_uuid] = True
                created_jobs.append(job)
            # events carry the final post-transaction payloads (membership
            # updates included), so journal replay is a pure upsert
            events = []
            for group in groups:
                touched_groups.pop(group.uuid, None)
                events.append(self._emit("group/created",
                                         {"uuid": group.uuid},
                                         group=self.groups[group.uuid]))
            for guuid in touched_groups:
                events.append(self._emit("group/updated", {"uuid": guuid},
                                         group=self.groups[guuid]))
            for job in created_jobs:
                events.append(
                    self._emit(
                        "job/created",
                        {"uuid": job.uuid, "user": job.user, "pool": job.pool},
                        job=job,
                    )
                )
            self._fan_out(events)
            return [j.uuid for j in jobs]

    def _validate_gangs(self, jobs: Sequence[Job]) -> None:
        """Txn-level gang invariants (caller holds the store lock).

        A gang (gang_size=k, scheduler/gang.py) only ever places
        all-or-nothing, so a half-submitted gang would wait forever: the
        k members must arrive in ONE submit batch, share one group, agree
        on k and pool, and the group must not already hold members from
        an earlier transaction.  Violations veto the whole batch."""
        by_group: dict[str, list[Job]] = {}
        for job in jobs:
            if job.gang_size <= 0:
                continue
            if job.gang_size == 1:
                raise TransactionVetoed(
                    f"job {job.uuid}: gang_size 1 is not a gang (omit it)")
            if not job.group_uuid:
                raise TransactionVetoed(
                    f"job {job.uuid}: gang_size requires a group")
            by_group.setdefault(job.group_uuid, []).append(job)
        for guuid, members in by_group.items():
            k = members[0].gang_size
            if any(j.gang_size != k for j in members):
                raise TransactionVetoed(
                    f"group {guuid}: members disagree on gang_size")
            if any(j.pool != members[0].pool for j in members):
                raise TransactionVetoed(
                    f"group {guuid}: gang members span pools")
            existing = self.groups.get(guuid)
            if existing is not None and existing.job_uuids:
                raise TransactionVetoed(
                    f"group {guuid}: gang groups cannot be extended after "
                    "submit")
            if len(members) != k:
                raise TransactionVetoed(
                    f"group {guuid}: gang_size {k} but {len(members)} "
                    "member(s) in the batch (gangs submit atomically)")

    def create_instance(
        self,
        job_uuid: str,
        task_id: str,
        *,
        hostname: str,
        node_id: str = "",
        compute_cluster: str = "",
    ) -> Instance:
        """Launch transaction: enforces `:job/allowed-to-start?` then creates
        an UNKNOWN instance and moves the job to RUNNING (the reference's
        `matches->task-txns`, scheduler.clj:790-846)."""
        with self._lock:
            job = self.jobs.get(job_uuid)
            if job is None:
                raise TransactionVetoed(f"no such job {job_uuid}")
            insts = self.job_instances(job_uuid)
            try:
                state_mod.check_allowed_to_start(job, insts)
            except state_mod.JobNotAllowedToStart as e:
                raise TransactionVetoed(str(e)) from e
            inst = Instance(
                task_id=task_id,
                job_uuid=job_uuid,
                status=InstanceStatus.UNKNOWN,
                hostname=hostname,
                node_id=node_id,
                compute_cluster=compute_cluster,
                start_time_ms=self.clock(),
            )
            self.instances[task_id] = inst
            job = job.with_(
                state=JobState.RUNNING,
                instance_ids=job.instance_ids + (task_id,),
            )
            self.jobs[job_uuid] = job
            self._index_job(job, None)
            events = [
                self._emit(
                    "instance/created",
                    {"task_id": task_id, "job": job_uuid, "hostname": hostname},
                    instance=inst,
                ),
                self._emit("job/state", {"uuid": job_uuid, "state": "running"},
                           job=job),
            ]
            self._fan_out(events)
            return inst

    def update_instance_state(
        self,
        task_id: str,
        new_status: InstanceStatus,
        reason: Optional[Reason | int | str] = None,
    ) -> state_mod.StateUpdate:
        """The completion path (SURVEY §3.5): validate + apply the instance
        transition, re-derive job state, fan out events."""
        with self._lock:
            inst = self.instances.get(task_id)
            if inst is None:
                return state_mod.StateUpdate(applied=False)
            job = self.jobs[inst.job_uuid]
            siblings = self.job_instances(inst.job_uuid)
            reason_code = get_reason(reason).code if reason is not None else None
            update = state_mod.update_instance_state(
                job,
                siblings,
                task_id,
                new_status,
                reason_code,
                mea_culpa_limit=self.mea_culpa_limit,
            )
            if not update.applied:
                return update
            now = self.clock()
            new_inst = inst.with_(status=new_status, reason_code=reason_code)
            if new_status.terminal:
                new_inst = new_inst.with_(end_time_ms=now)
            self.instances[task_id] = new_inst
            events = [
                self._emit(
                    "instance/status",
                    {
                        "task_id": task_id,
                        "job": job.uuid,
                        "status": new_status.value,
                        "reason": reason_code,
                    },
                    instance=new_inst,
                )
            ]
            if update.new_job_state != job.state:
                job = job.with_(state=update.new_job_state)
                if update.job_newly_waiting:
                    job = job.with_(last_waiting_start_time_ms=now)
                events.append(
                    self._emit(
                        "job/state",
                        {"uuid": job.uuid, "state": update.new_job_state.value},
                        job=job,
                    )
                )
            self.jobs[job.uuid] = job
            self._index_job(job, None)
            self._fan_out(events)
            return update

    def kill_jobs(self, job_uuids: Iterable[str]) -> list[str]:
        """Job kill is 'mark completed in the store; the event feed does the
        rest' (reference: mesos.clj:331-364): live instances are killed by
        the tx-feed consumer in the scheduler, not here."""
        killed = []
        with self._lock:
            events = []
            for uuid in job_uuids:
                job = self.jobs.get(uuid)
                if job is None or job.state == JobState.COMPLETED:
                    continue
                job = job.with_(state=JobState.COMPLETED)
                self.jobs[uuid] = job
                self._index_job(job, None)
                events.append(
                    self._emit(
                        "job/state",
                        {"uuid": uuid, "state": "completed", "killed": True},
                        job=job,
                    )
                )
                killed.append(uuid)
            self._fan_out(events)
        return killed

    def mark_instance_cancelled(self, task_id: str) -> bool:
        with self._lock:
            inst = self.instances.get(task_id)
            if inst is None:
                return False
            new_inst = inst.with_(cancelled=True)
            self.instances[task_id] = new_inst
            self._fan_out([self._emit("instance/cancelled",
                                      {"task_id": task_id},
                                      instance=new_inst)])
            return True

    def retry_job(self, job_uuid: str, retries: int, *, increment: bool = False) -> Job:
        """`POST /retry` semantics (`:job/update-retry-count` +
        `:job/update-state-on-retry`)."""
        with self._lock:
            job = self.jobs.get(job_uuid)
            if job is None:
                raise TransactionVetoed(f"no such job {job_uuid}")
            insts = self.job_instances(job_uuid)
            if increment:
                retries = job.max_retries + retries
            new_state = state_mod.retry_job_state(
                job, insts, retries, mea_culpa_limit=self.mea_culpa_limit
            )
            old_state = job.state
            job = job.with_(max_retries=retries, state=new_state)
            if new_state == JobState.WAITING:
                job = job.with_(last_waiting_start_time_ms=self.clock())
            self.jobs[job_uuid] = job
            self._index_job(job, None)
            events = [
                self._emit(
                    "job/retried",
                    {"uuid": job_uuid, "retries": retries,
                     "state": job.state.value},
                    job=job,
                )
            ]
            if new_state != old_state:
                # state-change consumers (columnar index, kill fan-out...)
                # key off job/state events; a revived job must emit one
                events.append(
                    self._emit("job/state",
                               {"uuid": job_uuid, "state": new_state.value},
                               job=job)
                )
            self._fan_out(events)
            return job

    def move_job_pool(self, job_uuid: str, new_pool: str) -> bool:
        """Move a WAITING job to another pool (reference:
        plugins/pool_mover.clj — only pending jobs may move)."""
        with self._lock:
            job = self.jobs.get(job_uuid)
            if job is None or job.state != JobState.WAITING:
                return False
            if new_pool not in self.pools:
                return False
            old_pool = job.pool
            self._pool_pending.get(old_pool, set()).discard(job_uuid)
            job = job.with_(pool=new_pool)
            self.jobs[job_uuid] = job
            self._index_job(job, None)
            self._fan_out([
                self._emit("job/pool-moved",
                           {"uuid": job_uuid, "from": old_pool,
                            "to": new_pool},
                           job=job)
            ])
            return True

    # ---------------------------------------------------- shard handoff
    # Cross-shard pool move (shard/): the source shard forgets the job
    # (and its instance history), the destination shard adopts it.  Each
    # half emits into ITS OWN journal segment, so per-shard replay
    # reconstructs per-shard state exactly; the transaction layer orders
    # the two applies and acknowledges once.

    def shard_out_job(self, job_uuid: str):
        """Remove a job (and its instance records) from THIS shard.
        Returns (job, instances) as they stood, or (None, []) when the
        job is not here.  The emitted `job/shard-out` event carries the
        instance ids so journal replay removes the same set."""
        with self._lock:
            job = self.jobs.pop(job_uuid, None)
            if job is None:
                return None, []
            self.job_seq.pop(job_uuid, None)
            self._user_jobs.get(job.user, set()).discard(job_uuid)
            self._pool_pending.get(job.pool, set()).discard(job_uuid)
            self._pool_running.get(job.pool, set()).discard(job_uuid)
            instances = [self.instances.pop(tid)
                         for tid in job.instance_ids
                         if tid in self.instances]
            self._fan_out([self._emit(
                "job/shard-out",
                {"uuid": job_uuid, "pool": job.pool,
                 "instances": [i.task_id for i in instances]})])
            return job, instances

    def shard_in_job(self, job: Job, instances: Sequence[Instance] = (),
                     *, from_pool: str = "") -> None:
        """Adopt a job (post-move entity, pool already rewritten) and its
        instance history onto THIS shard.  Emits upsert events — an
        `instance/shard-in` per instance, then a `job/pool-moved`
        carrying the job — so replay and replication are pure upserts
        and downstream consumers (columnar index) see the same
        `job/pool-moved` a same-shard move produces."""
        with self._lock:
            self.jobs[job.uuid] = job
            self.job_seq.setdefault(job.uuid, len(self.job_seq))
            self._index_job(job, None)
            events = []
            for inst in instances:
                self.instances[inst.task_id] = inst
                events.append(self._emit(
                    "instance/shard-in",
                    {"task_id": inst.task_id, "job": job.uuid},
                    instance=inst))
            events.append(self._emit(
                "job/pool-moved",
                {"uuid": job.uuid, "from": from_pool, "to": job.pool,
                 "cross_shard": True},
                job=job))
            self._fan_out(events)

    def update_instance_progress(
        self, task_id: str, progress: int, message: str = ""
    ) -> bool:
        with self._lock:
            inst = self.instances.get(task_id)
            if inst is None:
                return False
            # progress must be monotone; stale updates are dropped
            # (reference: progress.clj progress-aggregator)
            if progress < inst.progress:
                return False
            new_inst = inst.with_(
                progress=progress, progress_message=message or inst.progress_message
            )
            self.instances[task_id] = new_inst
            self._fan_out([self._emit("instance/progress",
                                      {"task_id": task_id,
                                       "progress": progress},
                                      instance=new_inst)])
            return True

    def set_instance_output(
        self, task_id: str, *, exit_code: Optional[int] = None,
        sandbox_directory: Optional[str] = None,
    ) -> None:
        """Batched exit-code/sandbox publisher target (reference:
        mesos/sandbox.clj)."""
        with self._lock:
            inst = self.instances.get(task_id)
            if inst is None:
                return
            kw = {}
            if exit_code is not None:
                kw["exit_code"] = exit_code
            if sandbox_directory is not None:
                kw["sandbox_directory"] = sandbox_directory
            if kw:
                new_inst = inst.with_(**kw)
                self.instances[task_id] = new_inst
                self._fan_out([self._emit("instance/output",
                                          {"task_id": task_id},
                                          instance=new_inst)])

    # ------------------------------------------------------- share/quota/pool

    def set_pool(self, pool: Pool) -> None:
        with self._lock:
            self.pools[pool.name] = pool
            self._fan_out([self._emit("pool/set", {"name": pool.name},
                                      pool=pool)])

    def set_share(self, share: Share) -> None:
        with self._lock:
            self.shares[(share.user, share.pool)] = share
            self._fan_out([self._emit("share/set",
                                      {"user": share.user,
                                       "pool": share.pool},
                                      share=share)])

    def retract_share(self, user: str, pool: str) -> None:
        with self._lock:
            self.shares.pop((user, pool), None)
            self._fan_out([self._emit("share/retracted",
                                      {"user": user, "pool": pool})])

    def get_share(self, user: str, pool: str) -> Resources:
        """Share lookup with default-user fallback (share.clj:123).  A share
        is the DRU divisor; missing resources fall back to the default user's
        share, then to +inf (never constrains)."""
        with self._lock:
            own = self.shares.get((user, pool))
            default = self.shares.get((DEFAULT_USER, pool))
        inf = float("inf")
        base = default.resources if default else Resources(mem=inf, cpus=inf, gpus=inf)
        if own is None:
            return base
        r = own.resources
        return Resources(
            mem=r.mem if r.mem > 0 else base.mem,
            cpus=r.cpus if r.cpus > 0 else base.cpus,
            gpus=r.gpus if r.gpus > 0 else base.gpus,
        )

    def set_quota(self, quota: Quota) -> None:
        with self._lock:
            self.quotas[(quota.user, quota.pool)] = quota
            self._fan_out([self._emit("quota/set",
                                      {"user": quota.user,
                                       "pool": quota.pool},
                                      quota=quota)])

    def retract_quota(self, user: str, pool: str) -> None:
        with self._lock:
            self.quotas.pop((user, pool), None)
            self._fan_out([self._emit("quota/retracted",
                                      {"user": user, "pool": pool})])

    def get_quota(self, user: str, pool: str) -> Quota:
        with self._lock:
            own = self.quotas.get((user, pool))
            if own is not None:
                return own
            default = self.quotas.get((DEFAULT_USER, pool))
            if default is not None:
                return Quota(user=user, pool=pool, resources=default.resources,
                             count=default.count)
        inf = float("inf")
        return Quota(user=user, pool=pool,
                     resources=Resources(mem=inf, cpus=inf, gpus=inf, disk=inf),
                     count=2**31)

    def update_dynamic_config(self, updates: dict[str, Any]) -> None:
        """Runtime-mutable config writes (rebalancer params, incremental
        configs) go through the event feed so they survive failover."""
        with self._lock:
            self.dynamic_config.update(updates)
            self._fan_out([self._emit("config/updated",
                                      {"updates": updates})])

    # ------------------------------------------------------ capacity ledger

    CAPACITY_DIMS = ("mem", "cpus", "gpus")
    # loan amounts below this are float dust, not capacity: entries whose
    # every dimension sits under it are dropped from the ledger
    CAPACITY_EPSILON = 1e-6

    def apply_capacity_moves(self, moves: Sequence[dict]) -> dict:
        """Apply a capacity plan's loan/reclaim moves to the ledger (the
        pool/capacity-delta txn op's handler target).  Each move is
        {"kind": "loan"|"reclaim", "from": lender, "to": borrower,
        "mem"/"cpus"/"gpus": amounts}; reclaims are clamped to what is
        actually outstanding so a replayed or racing plan can never
        drive the ledger negative.  Emits one pool/capacity event
        carrying the full post-transaction ledger (replay = upsert)."""
        with self._lock:
            for move in moves:
                kind = move.get("kind", "loan")
                key = (move["from"], move["to"])
                entry = self.capacity_ledger.get(
                    key, {d: 0.0 for d in self.CAPACITY_DIMS})
                for dim in self.CAPACITY_DIMS:
                    amount = float(move.get(dim, 0.0))
                    if kind == "reclaim":
                        entry[dim] = max(entry[dim] - amount, 0.0)
                    else:
                        entry[dim] = entry[dim] + amount
                if any(v > self.CAPACITY_EPSILON for v in entry.values()):
                    self.capacity_ledger[key] = entry
                else:
                    self.capacity_ledger.pop(key, None)
            ledger = self.encoded_capacity_ledger()
            event = self._emit("pool/capacity",
                               {"moves": [dict(m) for m in moves],
                                "ledger": ledger})
            self._fan_out([event])
            return {"applied": len(moves), "ledger": ledger}

    def encoded_capacity_ledger(self) -> list[dict]:
        """JSON-able ledger rows (snapshot / event / REST payloads)."""
        with self._lock:
            return [
                {"from": lender, "to": borrower, **amounts}
                for (lender, borrower), amounts
                in sorted(self.capacity_ledger.items())
            ]

    def set_capacity_ledger(self, entries: Sequence[dict]) -> None:
        """Replace the ledger wholesale (journal replay / snapshot
        restore — entries are the encoded post-transaction rows)."""
        with self._lock:
            self.capacity_ledger = {
                (e["from"], e["to"]): {d: float(e.get(d, 0.0))
                                       for d in self.CAPACITY_DIMS}
                for e in entries
            }

    def net_capacity_adjustment(self, pool: str) -> dict[str, float]:
        """Ledger-derived net elastic capacity for a pool: inbound loans
        minus outbound (negative = the pool is a net lender).  This is
        the declarative target clusters converge their elastic capacity
        to (ComputeCluster.scale)."""
        net = {d: 0.0 for d in self.CAPACITY_DIMS}
        with self._lock:
            for (lender, borrower), amounts in self.capacity_ledger.items():
                if borrower == pool:
                    for dim in self.CAPACITY_DIMS:
                        net[dim] += amounts[dim]
                if lender == pool:
                    for dim in self.CAPACITY_DIMS:
                        net[dim] -= amounts[dim]
        return net

    def outstanding_loans_from(self, pool: str) -> dict[str, dict[str, float]]:
        """borrower -> amounts currently on loan FROM `pool` (the
        reclaim-on-demand input)."""
        with self._lock:
            return {borrower: dict(amounts)
                    for (lender, borrower), amounts
                    in self.capacity_ledger.items() if lender == pool}

    def get_quota(self, user: str, pool: str) -> Quota:
        with self._lock:
            own = self.quotas.get((user, pool))
            if own is not None:
                return own
            default = self.quotas.get((DEFAULT_USER, pool))
            if default is not None:
                return Quota(user=user, pool=pool, resources=default.resources,
                             count=default.count)
        inf = float("inf")
        return Quota(user=user, pool=pool,
                     resources=Resources(mem=inf, cpus=inf, gpus=inf, disk=inf),
                     count=2**31)

    # ---------------------------------------------------------------- queries

    def job_instances(self, job_uuid: str) -> list[Instance]:
        job = self.jobs.get(job_uuid)
        if job is None:
            return []
        return [self.instances[tid] for tid in job.instance_ids
                if tid in self.instances]

    def pending_jobs(self, pool: str) -> list[Job]:
        with self._lock:
            return [self.jobs[u] for u in self._pool_pending.get(pool, ())]

    def running_jobs(self, pool: str) -> list[Job]:
        with self._lock:
            return [self.jobs[u] for u in self._pool_running.get(pool, ())]

    def running_instances(self, pool: str) -> list[Instance]:
        """Live (UNKNOWN or RUNNING) instances of running jobs in a pool."""
        out = []
        with self._lock:
            for job in self.running_jobs(pool):
                for inst in self.job_instances(job.uuid):
                    if not inst.status.terminal:
                        out.append(inst)
        return out

    def live_instances_of_job(self, job_uuid: str) -> list[Instance]:
        return [i for i in self.job_instances(job_uuid) if not i.status.terminal]

    def user_jobs(self, user: str) -> list[Job]:
        with self._lock:
            return [self.jobs[u] for u in self._user_jobs.get(user, ())]

    def user_usage(self, pool: str) -> dict[str, Resources]:
        """Per-user resources of currently-running jobs in a pool (the
        `user->usage` input of the match cycle, scheduler.clj:711)."""
        usage: dict[str, Resources] = {}
        with self._lock:
            for job in self.running_jobs(pool):
                usage[job.user] = usage.get(job.user, Resources()) + job.resources
        return usage

    def pending_count(self, pool: Optional[str] = None,
                      user: Optional[str] = None) -> int:
        """Queue lengths for queue limits (queue_limit.clj:92)."""
        with self._lock:
            if pool is not None:
                ids = self._pool_pending.get(pool, set())
                if user is None:
                    return len(ids)
                return sum(1 for u in ids if self.jobs[u].user == user)
            total = 0
            for ids in self._pool_pending.values():
                if user is None:
                    total += len(ids)
                else:
                    total += sum(1 for u in ids if self.jobs[u].user == user)
            return total

    # ------------------------------------------------------------- snapshots

    def snapshot_events(self) -> list[Event]:
        with self._lock:
            return list(self._events)
