"""ShardedStore: N JobStore shards behind the store facade.

A copy of `cook_tpu/shard/store.py`, its imports the port's.

Each shard is a full `JobStore` — its own ProfiledRLock (labeled
`store-s{i}` so /debug/contention attributes waits per shard), its own
event window and sequence numbering, its own idempotency table, and
(when persistence is attached) its own journal segment.  This facade
presents the read/write surface the REST layer, scheduler, and elastic
planner already consume:

  * pool-scoped calls (`pending_jobs`, `running_jobs`, `user_usage`,
    `get_share`, `get_quota`, ...) route straight to the owning shard —
    ONE lock touched, which is the whole point: the match cycle's
    per-pool iteration becomes a per-shard snapshot;
  * entity-keyed calls (`create_instance`, `update_instance_state`,
    `kill_jobs`, ...) resolve the owning shard by lookup;
  * global state (dynamic config, capacity ledger) lives on the META
    shard; pool metadata writes broadcast so per-shard validation and
    per-shard recovery are self-contained;
  * merged mapping views (`jobs`, `instances`, ...) serve the listing
    endpoints; they snapshot per-shard under each shard's lock, never
    holding two shard locks at once.

Cross-shard pool moves go through `move_job_pool`: source and
destination apply in ascending shard order (the fixed global order that
makes concurrent cross-shard commits deadlock-free), each emitting into
its own journal segment.
"""
from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, Optional, Sequence

from cook_tpu_torch.models.entities import (
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
from cook_tpu_torch.models.reasons import Reason
from cook_tpu_torch.models.store import (Event, JobStore, TransactionVetoed,
                                         Watcher)
from cook_tpu_torch.shard.router import META_SHARD, ShardRouter


class _MergedView:
    """Read-only union of the shards' entity dicts.  Lookups probe
    shards in order (an entity lives on exactly one shard); iteration
    snapshots each shard's dict under that shard's lock."""

    def __init__(self, store: "ShardedStore",
                 pick: Callable[[JobStore], dict]):
        self._store = store
        self._pick = pick

    def _maps(self):
        return [self._pick(s) for s in self._store.shards]

    def get(self, key, default=None):
        for m in self._maps():
            found = m.get(key)
            if found is not None:
                return found
        return default

    def __getitem__(self, key):
        found = self.get(key)
        if found is None:
            raise KeyError(key)
        return found

    def __contains__(self, key) -> bool:
        return any(key in m for m in self._maps())

    def __len__(self) -> int:
        return sum(len(m) for m in self._maps())

    def __iter__(self):
        return iter(self.keys())

    def __bool__(self) -> bool:
        return any(self._maps())

    def keys(self):
        out = []
        for shard, m in zip(self._store.shards, self._maps()):
            with shard._lock:
                out.extend(m.keys())
        return out

    def values(self):
        out = []
        for shard, m in zip(self._store.shards, self._maps()):
            with shard._lock:
                out.extend(m.values())
        return out

    def items(self):
        out = []
        for shard, m in zip(self._store.shards, self._maps()):
            with shard._lock:
                out.extend(m.items())
        return out


class _PinnedPoolStore:
    """One pool's shard, seen as a full store (`store_for_pool`).

    Everything delegates to the shard — a per-pool cycle's reads and
    instance writes are pool-keyed, so they land on the right shard by
    construction — EXCEPT `groups`, which stays the owning facade's
    merged view: group entities ride the lowest shard of their
    submission plan and may not live on this pool's shard."""

    __slots__ = ("_shard", "_facade")

    def __init__(self, shard: JobStore, facade: "ShardedStore"):
        object.__setattr__(self, "_shard", shard)
        object.__setattr__(self, "_facade", facade)

    def __getattr__(self, name):
        if name == "groups":
            return self._facade.groups
        return getattr(self._shard, name)


class ShardedStore:
    """The partitioned control-plane store (see module docstring)."""

    def __init__(self, n_shards: int, *, mea_culpa_limit: int = 5,
                 clock: Callable[[], int] = None,
                 router: Optional[ShardRouter] = None,
                 shards: Optional[Sequence[JobStore]] = None):
        if n_shards < 2 and router is None:
            # a 1-shard facade is only meaningful with an explicit
            # router: the mp runtime's workers (the reference's mp/)
            # wrap ONE global shard behind a group-scoped router so
            # misrouted keys are detected instead of silently applied
            # locally
            raise ValueError("ShardedStore needs >= 2 shards; use a plain "
                             "JobStore for 1")
        self.n_shards = n_shards
        self.router = router or ShardRouter(n_shards)
        self.clock = clock or (lambda: 0)
        self.shards: list[JobStore] = list(shards) if shards else [
            JobStore(mea_culpa_limit=mea_culpa_limit, clock=self.clock,
                     lock_name=f"store-s{i}", shard_id=i)
            for i in range(n_shards)
        ]
        if len(self.shards) != n_shards:
            raise ValueError(f"{len(self.shards)} shards != {n_shards}")
        self.recovered_stats: dict[str, int] = {}
        # merged facade views (the REST layer reads these directly)
        self.jobs = _MergedView(self, lambda s: s.jobs)
        self.instances = _MergedView(self, lambda s: s.instances)
        self.groups = _MergedView(self, lambda s: s.groups)
        self.job_seq = _MergedView(self, lambda s: s.job_seq)
        self.shares = _MergedView(self, lambda s: s.shares)
        self.quotas = _MergedView(self, lambda s: s.quotas)
        self.txn_results = _MergedView(self, lambda s: s.txn_results)

    # --------------------------------------------------------- properties

    @property
    def mea_culpa_limit(self) -> int:
        return self.shards[0].mea_culpa_limit

    @mea_culpa_limit.setter
    def mea_culpa_limit(self, value: int) -> None:
        for shard in self.shards:
            shard.mea_culpa_limit = value

    @property
    def pools(self) -> dict[str, Pool]:
        # pool metadata is broadcast; any shard's copy is authoritative
        return self.shards[META_SHARD].pools

    @property
    def dynamic_config(self) -> dict[str, Any]:
        return self.shards[META_SHARD].dynamic_config

    @property
    def capacity_ledger(self):
        return self.shards[META_SHARD].capacity_ledger

    CAPACITY_DIMS = JobStore.CAPACITY_DIMS

    # ----------------------------------------------------------- routing

    def shard_for_pool(self, pool: str) -> JobStore:
        return self.shards[self.router.shard_for_pool(pool)]

    def store_for_pool(self, pool: str) -> "_PinnedPoolStore":
        """The pool's owning shard, pinned for a per-pool match/rank
        cycle (scheduler/core.py): snapshot reads and instance writes
        touch exactly one shard lock instead of the merged facade, so
        the cycle's encode cache / device-state mirror see one shard's
        event stream.  `groups` stays the merged view — a group entity
        rides the LOWEST shard of its submission plan, which may not be
        the pool's shard (matcher group-placement constraints)."""
        return _PinnedPoolStore(self.shard_for_pool(pool), self)

    def shard_of_job(self, job_uuid: str) -> Optional[JobStore]:
        for shard in self.shards:
            if job_uuid in shard.jobs:
                return shard
        return None

    def shard_of_instance(self, task_id: str) -> Optional[JobStore]:
        for shard in self.shards:
            if task_id in shard.instances:
                return shard
        return None

    def _job_shard(self, job_uuid: str) -> JobStore:
        shard = self.shard_of_job(job_uuid)
        if shard is None:
            raise TransactionVetoed(f"no such job {job_uuid}")
        return shard

    # ------------------------------------------------------------- infra

    def add_watcher(self, watcher: Watcher) -> None:
        for shard in self.shards:
            shard.add_watcher(watcher)

    def add_resync_listener(self, listener: Callable[[], None]) -> None:
        for shard in self.shards:
            shard.add_resync_listener(listener)

    def last_seqs(self) -> list[int]:
        """Per-shard committed-event heads (the replication/staleness
        vector — sequence numbers are only comparable within a shard)."""
        return [shard.last_seq() for shard in self.shards]

    def last_seq(self) -> int:
        """Scalar monotone commit counter (the sum of shard heads) for
        callers that only need 'did anything commit since'; replication
        and staleness use `last_seqs()`."""
        return sum(self.last_seqs())

    # ------------------------------------------------------------ writes

    def submit_jobs(self, jobs: Sequence[Job],
                    groups: Sequence[Group] = ()) -> list[str]:
        by_shard: dict[int, list[Job]] = {}
        for job in jobs:
            by_shard.setdefault(self.router.shard_for_pool(job.pool),
                                []).append(job)
        group_list = list(groups)
        for i in sorted(by_shard):
            self.shards[i].submit_jobs(by_shard[i], group_list)
            group_list = []  # groups ride with the lowest touched shard
        return [j.uuid for j in jobs]

    def create_instance(self, job_uuid: str, task_id: str, *,
                        hostname: str, node_id: str = "",
                        compute_cluster: str = "") -> Instance:
        return self._job_shard(job_uuid).create_instance(
            job_uuid, task_id, hostname=hostname, node_id=node_id,
            compute_cluster=compute_cluster)

    def update_instance_state(self, task_id: str,
                              new_status: InstanceStatus,
                              reason: Optional[Reason | int | str] = None):
        shard = self.shard_of_instance(task_id)
        if shard is None:
            from cook_tpu_torch.models import state as state_mod

            return state_mod.StateUpdate(applied=False)
        return shard.update_instance_state(task_id, new_status, reason)

    def kill_jobs(self, job_uuids: Iterable[str]) -> list[str]:
        killed = []
        uuids = list(job_uuids)
        for shard in self.shards:
            mine = [u for u in uuids if u in shard.jobs]
            if mine:
                killed.extend(shard.kill_jobs(mine))
        return killed

    def mark_instance_cancelled(self, task_id: str) -> bool:
        shard = self.shard_of_instance(task_id)
        return shard.mark_instance_cancelled(task_id) if shard else False

    def retry_job(self, job_uuid: str, retries: int,
                  *, increment: bool = False) -> Job:
        return self._job_shard(job_uuid).retry_job(job_uuid, retries,
                                                   increment=increment)

    def move_job_pool(self, job_uuid: str, new_pool: str) -> bool:
        """Pool move, cross-shard when source and destination pools hash
        to different shards."""
        src = self.shard_of_job(job_uuid)
        if src is None or new_pool not in self.pools:
            return False
        dst = self.shard_for_pool(new_pool)
        if src is dst:
            return src.move_job_pool(job_uuid, new_pool)
        return self.move_job_cross_shard(src, dst, job_uuid, new_pool)

    def move_job_cross_shard(self, src: JobStore, dst: JobStore,
                             job_uuid: str, new_pool: str) -> bool:
        """THE cross-shard move sequence (shared by this facade and the
        sharded txn pipeline): shard-out on the source, shard-in on the
        destination, under both locks in ascending shard order (one
        fixed global order — concurrent cross-shard moves cannot
        deadlock; re-entrant under the txn pipeline's already-held
        locks).  Only WAITING jobs move (pool_mover.clj semantics)."""
        first, second = sorted((src, dst), key=lambda s: s.shard_id)
        with first._lock, second._lock:
            job = src.jobs.get(job_uuid)
            if job is None or job.state != JobState.WAITING:
                return False
            old_pool = job.pool
            moved_job, instances = src.shard_out_job(job_uuid)
            dst.shard_in_job(moved_job.with_(pool=new_pool), instances,
                             from_pool=old_pool)
            return True

    def update_instance_progress(self, task_id: str, progress: int,
                                 message: str = "") -> bool:
        shard = self.shard_of_instance(task_id)
        return (shard.update_instance_progress(task_id, progress, message)
                if shard else False)

    def set_instance_output(self, task_id: str, *,
                            exit_code: Optional[int] = None,
                            sandbox_directory: Optional[str] = None) -> None:
        shard = self.shard_of_instance(task_id)
        if shard is not None:
            shard.set_instance_output(task_id, exit_code=exit_code,
                                      sandbox_directory=sandbox_directory)

    # -------------------------------------------------- share/quota/pool

    def set_pool(self, pool: Pool) -> None:
        # broadcast: every shard validates submissions and recovers its
        # journal segment without consulting another shard
        for shard in self.shards:
            shard.set_pool(pool)

    def set_share(self, share: Share) -> None:
        self.shard_for_pool(share.pool).set_share(share)

    def retract_share(self, user: str, pool: str) -> None:
        self.shard_for_pool(pool).retract_share(user, pool)

    def get_share(self, user: str, pool: str) -> Resources:
        return self.shard_for_pool(pool).get_share(user, pool)

    def set_quota(self, quota: Quota) -> None:
        self.shard_for_pool(quota.pool).set_quota(quota)

    def retract_quota(self, user: str, pool: str) -> None:
        self.shard_for_pool(pool).retract_quota(user, pool)

    def get_quota(self, user: str, pool: str) -> Quota:
        return self.shard_for_pool(pool).get_quota(user, pool)

    def update_dynamic_config(self, updates: dict[str, Any]) -> None:
        self.shards[META_SHARD].update_dynamic_config(updates)

    # -------------------------------------------------- capacity ledger

    def apply_capacity_moves(self, moves: Sequence[dict]) -> dict:
        return self.shards[META_SHARD].apply_capacity_moves(moves)

    def encoded_capacity_ledger(self) -> list[dict]:
        return self.shards[META_SHARD].encoded_capacity_ledger()

    def set_capacity_ledger(self, entries: Sequence[dict]) -> None:
        self.shards[META_SHARD].set_capacity_ledger(entries)

    def net_capacity_adjustment(self, pool: str) -> dict[str, float]:
        return self.shards[META_SHARD].net_capacity_adjustment(pool)

    def outstanding_loans_from(self, pool: str) -> dict[str, dict[str, float]]:
        return self.shards[META_SHARD].outstanding_loans_from(pool)

    # ----------------------------------------------------------- queries

    def job_instances(self, job_uuid: str) -> list[Instance]:
        shard = self.shard_of_job(job_uuid)
        return shard.job_instances(job_uuid) if shard else []

    def pending_jobs(self, pool: str) -> list[Job]:
        return self.shard_for_pool(pool).pending_jobs(pool)

    def running_jobs(self, pool: str) -> list[Job]:
        return self.shard_for_pool(pool).running_jobs(pool)

    def running_instances(self, pool: str) -> list[Instance]:
        return self.shard_for_pool(pool).running_instances(pool)

    def live_instances_of_job(self, job_uuid: str) -> list[Instance]:
        shard = self.shard_of_job(job_uuid)
        return shard.live_instances_of_job(job_uuid) if shard else []

    def user_jobs(self, user: str) -> list[Job]:
        return list(itertools.chain.from_iterable(
            shard.user_jobs(user) for shard in self.shards))

    def user_usage(self, pool: str) -> dict[str, Resources]:
        return self.shard_for_pool(pool).user_usage(pool)

    def pending_count(self, pool: Optional[str] = None,
                      user: Optional[str] = None) -> int:
        if pool is not None:
            return self.shard_for_pool(pool).pending_count(pool, user)
        return sum(shard.pending_count(None, user)
                   for shard in self.shards)

    # --------------------------------------------------------- snapshots

    def snapshot_events(self) -> list[Event]:
        return list(itertools.chain.from_iterable(
            shard.snapshot_events() for shard in self.shards))
