"""Sharded control plane: partitioned store + journal segments + replicas.

A copy of `cook_tpu/shard/`, its imports the port's.  Every mutation
otherwise serializes through ONE store RLock, ONE journal, and ONE
leader — the role Datomic's single transactor plays in the reference.
This package partitions that control plane into N shards:

  * `ShardRouter` (router.py) — deterministic op -> shard mapping:
    per-pool routing with a hashed-user fallback for pool-less keys,
    identical to the reference's key for key; `MisroutedKey`, which the
    REST layer answers with 421.
  * `ShardedStore` (store.py) — N `JobStore` shards behind the read
    facade the REST layer and scheduler already consume; each shard owns
    its own profiled lock (labeled `store-s{i}`), event window, and
    idempotency table.  Pool-scoped reads route straight to the owning
    shard — the match cycle's per-pool iteration binds to per-shard
    snapshots (`store_for_pool`, read by `Scheduler._pool_store`) with
    no cross-shard locking.
  * `ShardedTransactionLog` (txn.py) — the commit pipeline: single-shard
    ops commit exactly like the unsharded log (apply under THAT shard's
    lock, group-fsync THAT shard's journal segment); cross-shard ops
    (pool-move across shards, a submit batch spanning pools) commit as
    an ordered multi-shard apply with one client-visible ack.  Its
    docstring states the lock order.
  * journal.py — per-shard journal segments + snapshots under
    `data_dir/shards/shard-NN/`, a versioned manifest, sharded recovery,
    and the exactly-once migration from the single-journal layout.
  * replica.py — `ShardedJournalFollower`: one follower per shard on its
    own `?shard=i` feed, and `evaluate_staleness`, the bounded, monotonic
    replica-read contract (`X-Cook-Staleness-Ms`, a freshness ceiling
    that falls back to the leader, refusal when a replica stops
    applying).

Opt-in: `Settings.shards > 1` (components.py) or
`InprocessControlPlane(shards=N)` (rest/server.py).  With shards == 1
nothing here is constructed and the single-store path is what it was.
"""
from cook_tpu_torch.shard.router import RoutePlan, ShardRouter
from cook_tpu_torch.shard.store import ShardedStore
from cook_tpu_torch.shard.txn import ShardedTransactionLog

__all__ = [
    "RoutePlan",
    "ShardRouter",
    "ShardedStore",
    "ShardedTransactionLog",
]
