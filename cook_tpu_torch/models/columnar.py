"""Columnar job/instance index: O(delta) host-side state for the cycles.

A copy of `cook_tpu/models/columnar.py` with its imports rewritten, but
for its lock order: `rebuild` and `consistent_with_store` hold the store
still (every shard lock, ascending) BEFORE they take the index lock, as
a committing thread does (its shard lock, then the index lock in
`_on_event`).  The reference takes the index lock first and then each
shard's lock through the merged views, which deadlocks a sharded standby
whose shard followers resync while another applies live events.

At north-star scale (100k pending jobs) rebuilding numpy arrays from Python
job objects each rank cycle is a Python walk over every job.  This index
subscribes to the store's event feed and maintains flat numpy columns
incrementally, so a cycle's tensor encoding is vectorized slicing instead
of Python loops (the role the reference's feature-vector/user caches play,
caches.clj + cached_queries.clj — but columnar, because our consumer is a
tensor kernel, not a comparator).

Guarantees: eventually consistent with the store at event granularity; safe
to rebuild from scratch at any time (`rebuild`); growth is amortized
doubling; job rows are never deleted (jobs are, at most, COMPLETED).
"""
from __future__ import annotations

import contextlib
import threading

import numpy as np

from cook_tpu_torch.models.entities import Job, JobState
from cook_tpu_torch.models.store import Event, JobStore

_STATE_CODE = {JobState.WAITING: 0, JobState.RUNNING: 1, JobState.COMPLETED: 2}


class _Interner:
    def __init__(self):
        self.by_name: dict[str, int] = {}
        self.names: list[str] = []

    def code(self, name: str) -> int:
        c = self.by_name.get(name)
        if c is None:
            c = len(self.names)
            self.by_name[name] = c
            self.names.append(name)
        return c


class ColumnarJobIndex:
    """Flat columns over all jobs + live instances of a store."""

    def __init__(self, store: JobStore, *, capacity: int = 1024):
        self.store = store
        self._lock = threading.Lock()
        self.users = _Interner()
        self.pools = _Interner()
        self._rows: dict[str, int] = {}
        self._n = 0
        self._alloc(capacity)
        # live instance columns (small: one per running task)
        self._inst_rows: dict[str, int] = {}
        self._inst_tids: list[str] = []
        self.inst_job_row: np.ndarray = np.empty(0, np.int64)
        self.inst_start: np.ndarray = np.empty(0, np.int64)
        self._rebuild()
        store.add_watcher(self._on_event)
        # a wholesale state replacement (persistence.restore_into): rebuild
        # from scratch
        store.add_resync_listener(self.rebuild)

    # ------------------------------------------------------------ storage

    def _alloc(self, capacity: int) -> None:
        self.user_code = np.zeros(capacity, np.int32)
        self.pool_code = np.zeros(capacity, np.int16)
        self.mem = np.zeros(capacity, np.float32)
        self.cpus = np.zeros(capacity, np.float32)
        self.gpus = np.zeros(capacity, np.float32)
        self.disk = np.zeros(capacity, np.float32)
        self.priority = np.zeros(capacity, np.int32)
        self.submit_ms = np.zeros(capacity, np.int64)
        self.state = np.full(capacity, 2, np.int8)
        self.uuids: list[str] = [""] * capacity

    def _grow(self) -> None:
        cap = len(self.state) * 2
        for name in ("user_code", "pool_code", "mem", "cpus", "gpus", "disk",
                     "priority", "submit_ms", "state"):
            old = getattr(self, name)
            new = np.zeros(cap, old.dtype)
            if name == "state":
                new[:] = 2
            new[: self._n] = old[: self._n]
            setattr(self, name, new)
        self.uuids.extend([""] * (cap - len(self.uuids)))

    def _add_job(self, job: Job) -> int:
        row = self._rows.get(job.uuid)
        if row is not None:
            return row
        if self._n >= len(self.state):
            self._grow()
        row = self._n
        self._n += 1
        self._rows[job.uuid] = row
        self.uuids[row] = job.uuid
        self.user_code[row] = self.users.code(job.user)
        self.pool_code[row] = self.pools.code(job.pool)
        r = job.resources
        self.mem[row] = r.mem
        self.cpus[row] = r.cpus
        self.gpus[row] = r.gpus
        self.disk[row] = r.disk
        self.priority[row] = job.priority
        self.submit_ms[row] = job.submit_time_ms or self.store.clock()
        self.state[row] = _STATE_CODE[job.state]
        return row

    # ------------------------------------------------------------- events

    def _on_event(self, event: Event) -> None:
        with self._lock:
            kind = event.kind
            if kind == "job/created":
                job = self.store.jobs.get(event.data["uuid"])
                if job is not None:
                    self._add_job(job)
            elif kind == "job/state":
                row = self._rows.get(event.data["uuid"])
                if row is not None:
                    self.state[row] = {"waiting": 0, "running": 1,
                                       "completed": 2}[event.data["state"]]
            elif kind == "job/pool-moved":
                row = self._rows.get(event.data["uuid"])
                if row is not None:
                    self.pool_code[row] = self.pools.code(event.data["to"])
            elif kind == "instance/created":
                task_id = event.data["task_id"]
                job_row = self._rows.get(event.data["job"])
                if job_row is None:
                    return
                irow = len(self._inst_rows)
                self._inst_rows[task_id] = irow
                if irow >= len(self.inst_job_row):
                    grow = max(1024, len(self.inst_job_row) * 2)
                    self.inst_job_row = np.resize(self.inst_job_row, grow)
                    self.inst_start = np.resize(self.inst_start, grow)
                self.inst_job_row[irow] = job_row
                self.inst_start[irow] = self.store.clock()
                if irow < len(self._inst_tids):
                    self._inst_tids[irow] = task_id
                else:
                    self._inst_tids.append(task_id)
            elif kind == "instance/status":
                if event.data["status"] in ("success", "failed"):
                    # live-instance set shrinks: O(1) swap-remove
                    irow = self._inst_rows.pop(event.data["task_id"], None)
                    if irow is None:
                        return
                    last = len(self._inst_rows)
                    if irow != last:
                        tid = self._inst_tids[last]
                        self._inst_tids[irow] = tid
                        self._inst_rows[tid] = irow
                        self.inst_job_row[irow] = self.inst_job_row[last]
                        self.inst_start[irow] = self.inst_start[last]

    # ------------------------------------------------------------ rebuild

    @contextlib.contextmanager
    def _store_held(self):
        """Every lock of the store, a sharded store's in ascending shard
        id (shard/txn.py's order): with them held no commit is between
        its store change and its `_on_event`, so a full read of the store
        is a cut of its event streams."""
        taken = []
        try:
            for shard in getattr(self.store, "shards", None) or [self.store]:
                shard._lock.acquire()
                taken.append(shard._lock)
            yield
        finally:
            for lock in reversed(taken):
                lock.release()

    def rebuild(self) -> None:
        """Full resync from the store (invariant recovery, promotion, the
        store's resync listener)."""
        with self._store_held():
            self._rebuild()

    def _rebuild(self) -> None:
        # at construction, as in the reference, the store is read unheld
        with self._lock:
            self._rows.clear()
            self._n = 0
            self._alloc(max(1024, len(self.store.jobs) * 2))
            self._inst_rows.clear()
            self._inst_tids = []
            for job in self.store.jobs.values():
                self._add_job(job)
            live = [
                inst for inst in self.store.instances.values()
                if not inst.status.terminal and inst.job_uuid in self._rows
            ]
            need = max(1024, len(live))
            self.inst_job_row = np.empty(need, np.int64)
            self.inst_start = np.empty(need, np.int64)
            for i, inst in enumerate(live):
                self._inst_rows[inst.task_id] = i
                self._inst_tids.append(inst.task_id)
                self.inst_job_row[i] = self._rows[inst.job_uuid]
                self.inst_start[i] = inst.start_time_ms

    # ------------------------------------------------------------- queries

    def pool_view(self, pool: str):
        """(pending_rows, live_inst_rows) for one pool — vectorized."""
        with self._lock:
            pcode = self.pools.by_name.get(pool)
            n = self._n
            if pcode is None or n == 0:
                return (np.empty(0, np.int64), np.empty(0, np.int64))
            mask = (self.pool_code[:n] == pcode)
            pending = np.nonzero(mask & (self.state[:n] == 0))[0]
            ninst = len(self._inst_rows)
            inst_rows = self.inst_job_row[:ninst]
            inst_sel = np.nonzero(mask[inst_rows])[0]
            return pending, inst_sel

    def consistent_with_store(self) -> bool:
        """Invariant check used by tests, anti-entropy and promotion."""
        with self._store_held(), self._lock:
            for uuid, job in self.store.jobs.items():
                row = self._rows.get(uuid)
                if row is None or self.state[row] != _STATE_CODE[job.state]:
                    return False
            live_store = {
                i.task_id for i in self.store.instances.values()
                if not i.status.terminal
            }
            return live_store == set(self._inst_rows)
