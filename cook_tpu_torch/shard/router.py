"""ShardRouter: deterministic txn-op -> shard mapping.

A copy of `cook_tpu/shard/router.py`: the routing must be identical to
the reference's key for key, because each package's journal segments
must recover in the other.

Routing policy:

  * pool-scoped keys (a job's pool, a share/quota's pool) route by a
    stable hash of the pool name — the match cycle iterates pools, so
    binding a pool to one shard gives every per-pool read a single-shard
    snapshot;
  * pool-less keys fall back to a stable hash of the user;
  * global state (dynamic config, the elastic capacity ledger, pool
    metadata writes) lives on the META shard (shard 0) — tiny, rarely
    written, and a single owner keeps replay trivial.

Hashes are `zlib.crc32` (NOT Python's salted `hash()`): the mapping
must be identical across processes and restarts, or journal-segment
recovery would scatter entities onto the wrong shards.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Optional, Sequence

# the shard that owns global state: dynamic config, capacity ledger,
# and pool metadata writes (pool metadata is also mirrored to every
# shard so per-shard validation never crosses shards)
META_SHARD = 0


class MisroutedKey(Exception):
    """A key whose owning shard this process does not serve.

    Raised by the multi-process runtime's group-scoped router (the
    reference's cook_tpu/mp/topology.py) when a request reaches a worker
    that owns only a subset of the global shard space — the symptom of a
    stale front-end route map or a client bypassing the front end with an
    old shard map.  The REST layer answers it with 421 Misdirected Request
    plus the owning shard, so the caller can refresh its map and retry
    instead of silently writing the key into the wrong journal segment.
    """

    def __init__(self, key: str, owner_shard: int,
                 owned: Sequence[int] = ()):
        self.key = key
        self.owner_shard = owner_shard
        self.owned = tuple(owned)
        super().__init__(
            f"{key} routes to shard {owner_shard}, which this process "
            f"does not serve (serving shards {list(self.owned)})")


def _stable_hash(key: str) -> int:
    return zlib.crc32(key.encode("utf-8")) & 0xFFFFFFFF


@dataclass(frozen=True)
class RoutePlan:
    """Where one transaction applies.

    `shards` is ascending and deduplicated; a single-element plan is the
    common fast path (one lock, one journal segment).  Multi-shard plans
    apply in shard order (the fixed global order that makes two
    concurrent cross-shard commits deadlock-free) and acknowledge once.
    `per_shard` optionally carries the payload split (e.g. a submit
    batch partitioned by pool).
    """

    shards: tuple[int, ...]
    per_shard: dict = field(default_factory=dict)

    @property
    def single(self) -> Optional[int]:
        return self.shards[0] if len(self.shards) == 1 else None


class ShardRouter:
    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards

    # ------------------------------------------------------------- keys

    def shard_for_pool(self, pool: str) -> int:
        return _stable_hash(f"pool:{pool}") % self.n_shards

    def shard_for_user(self, user: str) -> int:
        """Fallback for pool-less keys."""
        return _stable_hash(f"user:{user}") % self.n_shards

    def pools_for_distinct_shards(self, prefix: str = "pool",
                                  n: Optional[int] = None) -> list[str]:
        """n pool names that each land on a DIFFERENT shard (shard i gets
        one pool), found by probing the stable hash.  The chaos
        `wedged-shard` drill and the sharded loadtest use this so a
        per-pool traffic split is also a per-shard split."""
        n = self.n_shards if n is None else n
        if n > self.n_shards:
            raise ValueError(f"cannot spread {n} pools over "
                             f"{self.n_shards} shards distinctly")
        found: dict[int, str] = {}
        i = 0
        while len(found) < n:
            name = f"{prefix}{i}"
            found.setdefault(self.shard_for_pool(name), name)
            i += 1
        return [found[s] for s in sorted(found)][:n]

    # ------------------------------------------------------------- plans

    def plan(self, op: str, payload: dict, store) -> RoutePlan:
        """The shard set one transaction touches.  `store` resolves
        entity -> pool lookups (a kill names job uuids, not pools)."""
        if op == "jobs/submit":
            by_shard: dict[int, dict] = {}
            for job in payload.get("jobs", ()):
                shard = self.shard_for_pool(job.pool)
                entry = by_shard.setdefault(shard,
                                            {"jobs": [], "groups": []})
                entry["jobs"].append(job)
            groups = list(payload.get("groups", ()))
            if not by_shard:
                return RoutePlan(shards=(META_SHARD,))
            # groups ride with the lowest shard their jobs touch: a
            # group's jobs may span shards, but group metadata is small
            # and group-kill resolves membership per job anyway
            first = min(by_shard)
            by_shard[first]["groups"] = groups
            return RoutePlan(shards=tuple(sorted(by_shard)),
                             per_shard=by_shard)
        if op in ("jobs/kill", "group/kill"):
            shards = self._shards_for_jobs(
                self._kill_job_uuids(op, payload, store), store)
            return RoutePlan(shards=shards or (META_SHARD,))
        if op == "job/retry":
            return RoutePlan(shards=self._shards_for_jobs(
                [payload["uuid"]], store) or (META_SHARD,))
        if op == "job/pool-move":
            # the cross-shard case: the job's CURRENT shard plus the
            # destination pool's shard, applied in shard order with one
            # client-visible ack (txn.py)
            src = self._shards_for_jobs([payload["uuid"]], store)
            dst = self.shard_for_pool(payload["pool"])
            shards = tuple(sorted(set(src) | {dst}))
            return RoutePlan(shards=shards or (dst,))
        if op in ("share/set", "share/retract", "quota/set",
                  "quota/retract"):
            pool = self._share_quota_pool(op, payload)
            if pool is not None:
                return RoutePlan(shards=(self.shard_for_pool(pool),))
            user = self._share_quota_user(op, payload)
            return RoutePlan(shards=(self.shard_for_user(user or ""),))
        if op == "instance/cancel":
            jobs = []
            for task_id in payload.get("task_ids", ()):
                inst = store.instances.get(task_id)
                if inst is not None:
                    jobs.append(inst.job_uuid)
            return RoutePlan(shards=self._shards_for_jobs(jobs, store)
                             or (META_SHARD,))
        # global ops: config/update, pool/capacity-delta, and anything a
        # future op registers without a routing rule — one owner, the
        # meta shard, keeps ordering and replay trivial
        return RoutePlan(shards=(META_SHARD,))

    # ---------------------------------------------------------- helpers

    def _kill_job_uuids(self, op: str, payload: dict, store) -> list[str]:
        if op == "jobs/kill":
            return list(payload.get("uuids", ()))
        uuids: list[str] = []
        for guuid in payload.get("groups", ()):
            group = store.groups.get(guuid)
            if group is not None:
                uuids.extend(group.job_uuids)
        return uuids

    def _shards_for_jobs(self, uuids: Sequence[str],
                         store) -> tuple[int, ...]:
        shards = set()
        for uuid in uuids:
            job = store.jobs.get(uuid)
            if job is not None:
                shards.add(self.shard_for_pool(job.pool))
            else:
                # unknown job: the op handler will veto; route it
                # somewhere deterministic so the veto is consistent
                shards.add(self.shard_for_user(uuid))
        return tuple(sorted(shards))

    @staticmethod
    def _share_quota_pool(op: str, payload: dict) -> Optional[str]:
        if op == "share/set":
            return payload["share"].pool
        if op == "quota/set":
            return payload["quota"].pool
        return payload.get("pool")

    @staticmethod
    def _share_quota_user(op: str, payload: dict) -> Optional[str]:
        if op == "share/set":
            return payload["share"].user
        if op == "quota/set":
            return payload["quota"].user
        return payload.get("user")
