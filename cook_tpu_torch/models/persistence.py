"""Store durability: snapshots + append-only event journal.

A copy of `cook_tpu/models/persistence.py` (jax-free), its imports the
port's: a journal or snapshot either package writes recovers in the
other.

The reference delegates durability to Datomic (state survives leader
failover; the new leader reads the DB and reconstructs backend expectations
— kubernetes/compute_cluster.clj:269).  Here the JobStore persists itself:

  * `JournalWriter` appends every committed event as a JSON line (the
    transaction log).  Events carry the full post-transaction entity
    payloads (`Event.entities`), so the journal alone reconstructs every
    acknowledged write — the role Datomic's transaction log plays.
  * `snapshot` / `load_snapshot` serialize full store state; a snapshot +
    the journal suffix after it reconstructs the store exactly.
  * `attach_journal` wires a live store to a journal file; `recover`
    rebuilds a store from snapshot+journal at startup.

Entity (de)serialization lives in `cook_tpu_torch.models.codec`.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional

from cook_tpu_torch.models import codec
from cook_tpu_torch.models.store import Event, JobStore
from cook_tpu_torch.obs.contention import JournalTelemetry

log = logging.getLogger(__name__)

_encode = codec.encode  # back-compat aliases
_dec_resources = codec.dec_resources
_dec_job = codec.dec_job
_dec_instance = codec.dec_instance
_dec_group = codec.dec_group


def snapshot_state(store: JobStore) -> dict:
    """Serialize full store state to a JSON-ready dict (also served over
    HTTP to replicating standbys, rest/api.py /replication/snapshot).

    Entities are immutable, so only the dict copies happen under the
    store lock — the JSON encoding (the expensive part at 100k-job scale)
    runs outside it and never stalls writers."""
    with store._lock:
        seq = store.last_seq()
        jobs = dict(store.jobs)
        instances = dict(store.instances)
        groups = dict(store.groups)
        pools = dict(store.pools)
        shares = list(store.shares.values())
        quotas = list(store.quotas.values())
        dynamic_config = dict(store.dynamic_config)
        txns = dict(store.txn_results)
        capacity_ledger = [
            {"from": lender, "to": borrower, **amounts}
            for (lender, borrower), amounts
            in sorted(store.capacity_ledger.items())
        ]
    return {
        "txns": txns,
        "seq": seq,
        "capacity_ledger": capacity_ledger,
        "jobs": {k: codec.encode(v) for k, v in jobs.items()},
        "instances": {k: codec.encode(v) for k, v in instances.items()},
        "groups": {k: codec.encode(v) for k, v in groups.items()},
        "pools": {k: codec.encode(v) for k, v in pools.items()},
        "shares": [codec.encode(v) for v in shares],
        "quotas": [codec.encode(v) for v in quotas],
        "dynamic_config": dynamic_config,
    }


def snapshot(store: JobStore, path: str) -> None:
    """Write full store state atomically."""
    state = snapshot_state(store)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(state, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def load_snapshot(path: str, *, clock=None, store_factory=None) -> JobStore:
    with open(path) as f:
        state = json.load(f)
    store = store_factory() if store_factory is not None \
        else JobStore(clock=clock)
    _populate(store, state)
    return store


def restore_into(store: JobStore, state: dict) -> None:
    """Replace a LIVE store's contents with a snapshot state dict (the
    replicating standby's full-resync path — the store object is shared
    with the REST layer, so it must be rebuilt in place, atomically under
    the store lock).  The retained event window is cleared too: its
    entries predate the resync point, and a promoted standby serving
    `/replication/journal` must never mix pre-resync events with
    post-resync sequence numbering.  Watcher-derived state (columnar
    index, scheduler caches) is rebuilt via the store's resync listeners,
    called once the store lock is released: a listener on a sharded
    store reads every shard, and taking the others' locks while holding
    this one would break the ascending shard order (shard/txn.py)."""
    with store._lock:
        store.jobs.clear()
        store.job_seq.clear()
        store.instances.clear()
        store.groups.clear()
        store.pools.clear()
        store.shares.clear()
        store.quotas.clear()
        store.dynamic_config = {}
        store.txn_results.clear()
        store.capacity_ledger.clear()
        store._user_jobs.clear()
        store._pool_pending.clear()
        store._pool_running.clear()
        store._events.clear()
        _populate(store, state)
    store._notify_resync()


def _populate(store: JobStore, state: dict) -> None:
    for k, v in state["pools"].items():
        store.pools[k] = codec.dec_pool(v)
    for k, v in state["jobs"].items():
        job = codec.dec_job(v)
        store.jobs[k] = job
        store.job_seq[k] = len(store.job_seq)  # snapshot preserves order
        store._index_job(job, None)
    for k, v in state["instances"].items():
        store.instances[k] = codec.dec_instance(v)
    for k, v in state["groups"].items():
        store.groups[k] = codec.dec_group(v)
    for v in state["shares"]:
        share = codec.dec_share(v)
        store.shares[(share.user, share.pool)] = share
    for v in state["quotas"]:
        quota = codec.dec_quota(v)
        store.quotas[(quota.user, quota.pool)] = quota
    store.dynamic_config = state.get("dynamic_config", {})
    store.txn_results.update(state.get("txns", {}))
    store.set_capacity_ledger(state.get("capacity_ledger", []))
    store.reset_seq(state["seq"])


def _truncate_torn_tail(path: str) -> None:
    """Drop any unparsable tail left by a crash mid-write.  Appending onto a
    torn fragment would merge the next event into one corrupt line, silently
    discarding it (and everything after) on the NEXT recovery — so the
    fragment must go before a writer reopens the file."""
    if not os.path.exists(path):
        return
    with open(path, "rb") as f:
        data = f.read()
    end = len(data)
    while end > 0:
        if data[end - 1:end] != b"\n":
            # partial tail with no line terminator: drop it
            end = data.rfind(b"\n", 0, end) + 1  # no newline at all -> 0
            continue
        # prefix ends in a terminator; validate its final line
        nl = data.rfind(b"\n", 0, end - 1)
        line = data[nl + 1:end - 1].strip()
        if line:
            try:
                json.loads(line)
                break  # clean, parsable tail: keep through end
            except json.JSONDecodeError:
                pass
        end = nl + 1  # drop the blank/corrupt line (each step shrinks end)
    if end < len(data):
        with open(path, "r+b") as f:
            f.truncate(end)


class JournalWriter:
    """Append-only event journal (one JSON line per committed event).

    Durability is batched by default: every write is flushed to the OS,
    but fsync happens every `fsync_every` events OR whenever `sync()` is
    called.  The transaction pipeline (cook_tpu_torch.txn) calls `sync()` once
    per commit before the write is acknowledged — group commit: one
    fsync covers every event flushed so far, so concurrent commits share
    the disk barrier.  fsync_every is the backstop bound for writes that
    bypass the txn pipeline (scheduler-internal status updates): at most
    that many non-txn events are exposed to an OS crash (process crashes
    lose nothing — the data is in the page cache)."""

    DEFAULT_FSYNC_EVERY = 64

    # what an fsync failure means (docs/resilience.md): "fail-stop"
    # re-raises — the commit pipeline reports the write undurable (REST
    # 500) and, when wired (components.start_leader_duties), the leader
    # demotes so a standby with a working disk takes over; "degrade-async"
    # keeps committing WITHOUT the disk barrier (writes ride the page
    # cache), surfaces the `journal-fsync-degraded` health reason, and
    # probes the disk again every `degraded_retry_s`.
    FSYNC_POLICIES = ("fail-stop", "degrade-async")

    def __init__(self, path: str, *, fsync_every: int = DEFAULT_FSYNC_EVERY,
                 fsync_policy: str = "fail-stop",
                 degraded_retry_s: float = 5.0,
                 on_fsync_error=None):
        if fsync_policy not in self.FSYNC_POLICIES:
            raise ValueError(f"unknown fsync policy {fsync_policy!r}")
        self.path = path
        self.fsync_every = fsync_every
        self.fsync_policy = fsync_policy
        self.degraded_retry_s = degraded_retry_s
        # observer hook, called (under the writer lock) with the OSError;
        # the fail-stop leader-demotion wiring lives here
        self.on_fsync_error = on_fsync_error
        self._count = 0
        self._dirty = False
        self._degraded = False
        self._last_fsync_attempt = 0.0
        # events flushed to the OS but not yet covered by an fsync: the
        # append "queue" the contention observatory reports, and the
        # group-commit batch size the next fsync covers
        self._pending = 0
        # per-writer so the observatory reads ITS journal's stalls, not
        # some other process-resident writer's (obs/contention.py)
        self.telemetry = JournalTelemetry()
        import threading

        self._lock = threading.Lock()
        _truncate_torn_tail(path)
        self._f = open(path, "a")

    def _fsync_locked(self) -> None:
        import time as _time

        from cook_tpu_torch import faults

        batch = self._pending
        self._last_fsync_attempt = _time.monotonic()
        t0 = _time.perf_counter()
        try:
            fault_schedule = faults.ACTIVE
            if fault_schedule is not None:
                fault_schedule.hit(faults.JOURNAL_FSYNC, path=self.path)
            os.fsync(self._f.fileno())
        except OSError as e:
            self._handle_fsync_error(e)
            return
        self.telemetry.note_fsync(batch, _time.perf_counter() - t0)
        if self._degraded:
            log.warning("journal %s fsync recovered; leaving degraded "
                        "async mode", self.path)
            self._degraded = False
            self.telemetry.set_degraded(False)
        self._pending = 0
        self._dirty = False

    def _handle_fsync_error(self, exc: OSError) -> None:
        """Caller holds self._lock.  The pending/dirty counters are NOT
        reset: the exposure the gauge reports is real until an fsync
        succeeds."""
        self.telemetry.note_fsync_error()
        if self.on_fsync_error is not None:
            try:
                self.on_fsync_error(exc)
            except Exception:  # noqa: BLE001 — observer only
                log.exception("on_fsync_error callback failed")
        if self.fsync_policy == "degrade-async":
            if not self._degraded:
                log.error("journal %s fsync failed (%s); degrading to "
                          "async (no disk barrier) — commits remain "
                          "applied+replicated but an OS crash may lose "
                          "the unfsynced tail; retrying the disk every "
                          "%.0fs", self.path, exc, self.degraded_retry_s)
                self._degraded = True
                self.telemetry.set_degraded(True)
            return
        log.error("journal %s fsync failed (%s); fail-stop policy "
                  "re-raises — the commit is reported undurable",
                  self.path, exc)
        raise exc

    @property
    def degraded(self) -> bool:
        with self._lock:
            return self._degraded

    def __call__(self, event: Event) -> None:
        self.write_line(event.to_json())

    def write_line(self, line: str) -> None:
        """Append a pre-serialized journal line (the replication follower
        persists events it fetched from the leader — they arrive already
        encoded, and routing them through this writer keeps one lock and
        one file handle on the journal)."""
        with self._lock:
            payload = line.rstrip("\n") + "\n"
            self._f.write(payload)
            self._f.flush()
            self._count += 1
            self._pending += 1
            self._dirty = True
            self.telemetry.note_append(len(payload), self._pending)
            if self.fsync_every and self._count % self.fsync_every == 0:
                import time as _time

                # degraded-async cool-off applies to the backstop too, or
                # a broken disk gets probed every 64 events
                if not (self._degraded and _time.monotonic()
                        - self._last_fsync_attempt < self.degraded_retry_s):
                    self._fsync_locked()

    def sync(self) -> None:
        """Group-commit barrier: fsync anything flushed since the last
        sync.  A no-op when nothing is dirty — so of N concurrent
        commits, whichever syncs first pays the fsync for all of them.
        In degraded-async mode (an earlier fsync failed under the
        degrade policy) the disk is only re-probed every
        `degraded_retry_s`; between probes commits proceed without the
        barrier — that IS the degradation the health reason names."""
        import time as _time

        with self._lock:
            if not self._dirty or self._f.closed:
                return
            if self._degraded and _time.monotonic() \
                    - self._last_fsync_attempt < self.degraded_retry_s:
                return
            self._fsync_locked()

    def rotate(self) -> None:
        """After a snapshot, the journal prefix is redundant: move it aside
        and start fresh (the snapshot + new journal reconstruct state)."""
        with self._lock:
            self._f.close()
            if os.path.exists(self.path):
                os.replace(self.path, self.path + ".1")
            self._f = open(self.path, "a")
            self._dirty = False
            # the unfsynced tail went aside with the prefix (the
            # snapshot supersedes it); carrying _pending forward would
            # report a phantom fsync queue and inflate the next batch
            self._pending = 0
            self.telemetry.note_rotate()

    def close(self) -> None:
        with self._lock:
            if not self._f.closed and self._dirty:
                self._fsync_locked()
            self._f.close()


def attach_journal(store: JobStore, path: str, **kw) -> JournalWriter:
    writer = JournalWriter(path, **kw)
    store.add_watcher(writer)
    return writer


def read_journal(path: str) -> list[dict]:
    events = []
    if not os.path.exists(path):
        return events
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                break  # torn tail write from a crash: the suffix is unusable
    return events


def _upsert_job(store: JobStore, payload: dict):
    job = codec.dec_job(payload)
    old = store.jobs.get(job.uuid)
    if old is not None and old.pool != job.pool:
        store._pool_pending.get(old.pool, set()).discard(job.uuid)
        store._pool_running.get(old.pool, set()).discard(job.uuid)
    if old is None:
        store.job_seq[job.uuid] = len(store.job_seq)
    store.jobs[job.uuid] = job
    store._index_job(job, old)
    return job


def apply_journal(store: JobStore, events: list[dict],
                  *, after_seq: int = 0, live: bool = False) -> int:
    """Replay journal entries onto a store.  Entries carry post-transaction
    entity payloads, so replay is a pure upsert — no state-machine
    re-checks.  Returns the number of entries applied.

    Two modes:
      * cold replay (default) — startup recovery, before watchers attach:
        no event retention, no fan-out.
      * ``live=True`` — a replicating standby applying the leader's feed
        (control/replication.py): each applied entry becomes an ordinary
        committed Event on THIS store — appended to the retained window
        (so a promoted standby can serve `/replication/journal` itself)
        and fanned out to watchers, exactly like a local transaction.
        This is the Datomic-replication semantic: the tx-report mult
        delivers to ALL listeners on every peer (reference
        datomic.clj:49), so a standby's columnar rank index, journal
        writer, and passport stream track the leader continuously and
        promotion needs no rebuild.  Effect-executing consumers (the
        scheduler's kill fan-out) gate on leadership instead — the
        LEADER already performed those effects and their results arrive
        as further replicated events.
    """
    applied = 0
    max_seq = store.last_seq()
    fan: list[Event] = []
    # in commit (seq) order, not file order: an event emitted inside a
    # batch's fan-out (a killed job's task, reported failed by its
    # cluster's kill as the batch fans out) is journaled before the
    # batch's later events, and replaying the file as written would skip
    # those as already seen (the reference does: ROADMAP Queue C)
    for entry in sorted(events, key=lambda e: e.get("seq", 0)):
        seq = entry.get("seq", 0)
        if seq <= after_seq or seq <= max_seq:
            continue
        kind = entry.get("kind", "")
        data = entry.get("data", {})
        entities = entry.get("entities") or {}
        decoded: dict = {}
        if "job" in entities:
            decoded["job"] = _upsert_job(store, entities["job"])
        if "instance" in entities:
            inst = codec.dec_instance(entities["instance"])
            store.instances[inst.task_id] = inst
            decoded["instance"] = inst
        if "group" in entities:
            group = codec.dec_group(entities["group"])
            store.groups[group.uuid] = group
            decoded["group"] = group
        if "pool" in entities:
            pool = codec.dec_pool(entities["pool"])
            store.pools[pool.name] = pool
            decoded["pool"] = pool
        if "share" in entities:
            share = codec.dec_share(entities["share"])
            store.shares[(share.user, share.pool)] = share
            decoded["share"] = share
        if "quota" in entities:
            quota = codec.dec_quota(entities["quota"])
            store.quotas[(quota.user, quota.pool)] = quota
            decoded["quota"] = quota
        if kind == "job/shard-out":
            # cross-shard pool move (cook_tpu/shard/): this shard stops
            # owning the job; the destination shard's own journal carries
            # the matching upsert
            gone = store.jobs.pop(data.get("uuid", ""), None)
            if gone is not None:
                store.job_seq.pop(gone.uuid, None)
                store._user_jobs.get(gone.user, set()).discard(gone.uuid)
                store._pool_pending.get(gone.pool, set()).discard(gone.uuid)
                store._pool_running.get(gone.pool, set()).discard(gone.uuid)
            for tid in data.get("instances", ()):
                store.instances.pop(tid, None)
        elif kind == "share/retracted":
            store.shares.pop((data["user"], data["pool"]), None)
        elif kind == "quota/retracted":
            store.quotas.pop((data["user"], data["pool"]), None)
        elif kind == "config/updated":
            store.dynamic_config.update(data.get("updates", {}))
        elif kind == "pool/capacity":
            # the event carries the full post-transaction ledger, so
            # replay is a pure upsert (no move re-application, no
            # double-count on overlapping snapshot+journal replay)
            store.set_capacity_ledger(data.get("ledger", []))
        elif kind == "txn/committed":
            # rebuild the idempotency table: a promoted standby (or a
            # recovered leader) must answer retried commits of acked
            # transactions without re-applying them (cook_tpu_torch.txn)
            store.record_txn(data.get("txn_id", ""), data.get("op", ""),
                             seq, data.get("result"))
        if live:
            event = Event(seq=seq, kind=kind, data=data,
                          entities=decoded or None)
            store._events.append(event)
            fan.append(event)
        max_seq = max(max_seq, seq)
        applied += 1
    if live and len(store._events) > 2 * store.EVENT_WINDOW:
        del store._events[:-store.EVENT_WINDOW]
    store.reset_seq(max_seq)
    if fan:
        store._fan_out(fan)
    return applied


def recover(data_dir: str, *, clock=None,
            snapshot_name: str = "snapshot.json",
            journal_name: str = "journal.jsonl",
            store_factory=None) -> Optional[JobStore]:
    """Rebuild a store from the last snapshot plus the journal suffix after
    it (the documented failover path).  Returns None when the data dir holds
    neither a snapshot nor a journal (fresh start).  `store_factory`
    overrides the bare-JobStore construction — the sharded layout
    (cook_tpu/shard/journal.py) recovers each segment into a
    shard-labeled store.

    The rotated journal (`journal.jsonl.1`) is replayed too: rotation only
    happens after a successful snapshot, so its entries are normally all
    ≤ the snapshot seq and skip out — but if a crash lands between rotate
    and the next snapshot write, the suffix is still there to replay.
    """
    snap_path = os.path.join(data_dir, snapshot_name)
    journal_path = os.path.join(data_dir, journal_name)
    store = None
    snap_seq = 0
    if os.path.exists(snap_path):
        store = load_snapshot(snap_path, clock=clock,
                              store_factory=store_factory)
        snap_seq = store.last_seq()
    replayed = 0
    for path in (journal_path + ".1", journal_path):
        entries = read_journal(path)
        if not entries:
            continue
        if store is None:
            store = store_factory() if store_factory is not None \
                else JobStore(clock=clock)
        replayed += apply_journal(store, entries, after_seq=snap_seq)
    if store is not None:
        store.recovered_stats = {"snapshot_seq": snap_seq,
                                 "journal_replayed": replayed}
    return store
