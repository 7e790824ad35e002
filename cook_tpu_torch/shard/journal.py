"""Per-shard journal segments: layout, recovery, snapshots, migration.

A copy of `cook_tpu/shard/journal.py`, its imports the port's: a
data_dir either package writes (or migrates) recovers in the other,
shard for shard.

On-disk layout (versioned by `manifest.json` so a process can tell the
layouts apart before touching anything):

    data_dir/
      manifest.json                  {"schema": "cook-journal/v2",
                                      "layout": "sharded", "shards": N}
      shards/shard-00/snapshot.json  per-shard snapshot (persistence.py
      shards/shard-00/journal.jsonl   format, unchanged) + segment
      shards/shard-01/...

Each segment is an ordinary `JournalWriter` file — torn-tail truncation,
group fsync, rotation, and the fsync-policy machinery all apply per
shard, and the fault plane's `journal.fsync` point matches on the
segment PATH, which is how the chaos `wedged-shard` drill stalls exactly
one shard.

`migrate_single_journal` converts the original single-journal layout
(snapshot.json + journal.jsonl at the data_dir root) into this one
EXACTLY ONCE: the manifest is the idempotency marker, and the original
files are renamed to `*.premigrate` so a later unsharded process cannot
silently resurrect the pre-migration state.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional

from cook_tpu_torch.models import persistence
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.shard.router import META_SHARD, ShardRouter
from cook_tpu_torch.shard.store import ShardedStore

log = logging.getLogger(__name__)

MANIFEST_NAME = "manifest.json"
MANIFEST_SCHEMA = "cook-journal/v2"


def shard_dir(data_dir: str, shard: int) -> str:
    return os.path.join(data_dir, "shards", f"shard-{shard:02d}")


def read_manifest(data_dir: str) -> Optional[dict]:
    path = os.path.join(data_dir, MANIFEST_NAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        manifest = json.load(f)
    if manifest.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(f"unknown manifest schema in {path}: "
                         f"{manifest.get('schema')!r}")
    return manifest


def write_manifest(data_dir: str, n_shards: int, *,
                   migrated_from: str = "") -> dict:
    manifest = {"schema": MANIFEST_SCHEMA, "layout": "sharded",
                "shards": n_shards}
    if migrated_from:
        manifest["migrated_from"] = migrated_from
    path = os.path.join(data_dir, MANIFEST_NAME)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return manifest


def has_single_journal_layout(data_dir: str) -> bool:
    """An UNMIGRATED single-journal data_dir: root snapshot/journal
    present, no sharded manifest."""
    if read_manifest(data_dir) is not None:
        return False
    return (os.path.exists(os.path.join(data_dir, "snapshot.json"))
            or os.path.exists(os.path.join(data_dir, "journal.jsonl")))


def attach_shard_journals(store: ShardedStore, data_dir: str,
                          **journal_kw) -> list:
    """One JournalWriter per shard, watching ONLY its shard's event
    feed — shard i's commits never touch shard j's file or fsync
    barrier.  Returns the writers in shard order (feed these to
    ShardedTransactionLog)."""
    writers = []
    for i, shard in enumerate(store.shards):
        directory = shard_dir(data_dir, i)
        os.makedirs(directory, exist_ok=True)
        writer = persistence.JournalWriter(
            os.path.join(directory, "journal.jsonl"), **journal_kw)
        shard.add_watcher(writer)
        writers.append(writer)
    write_manifest(data_dir, store.n_shards)
    return writers


def _shard_factory(i: int, clock):
    return lambda: JobStore(clock=clock, lock_name=f"store-s{i}",
                            shard_id=i)


def recover_sharded(data_dir: str, n_shards: int, *,
                    clock=None) -> Optional[ShardedStore]:
    """Rebuild a ShardedStore from the per-shard segments.  The manifest
    shard count wins over the caller's (resharding an existing data_dir
    is a migration, not a config edit).  Returns None on a fresh dir."""
    manifest = read_manifest(data_dir)
    if manifest is not None:
        disk_shards = int(manifest.get("shards", n_shards))
        if disk_shards != n_shards:
            log.warning("data_dir %s holds %d shards; configured %d — "
                        "using the on-disk count (resharding a data_dir "
                        "is a migration)", data_dir,
                        disk_shards, n_shards)
            n_shards = disk_shards
    shards: list[JobStore] = []
    anything = False
    stats = {"snapshot_seq": 0, "journal_replayed": 0}
    for i in range(n_shards):
        recovered = persistence.recover(
            shard_dir(data_dir, i), clock=clock,
            store_factory=_shard_factory(i, clock))
        if recovered is None:
            recovered = _shard_factory(i, clock)()
        else:
            anything = True
            for key in stats:
                stats[key] += recovered.recovered_stats.get(key, 0)
        shards.append(recovered)
    if not anything:
        return None
    store = ShardedStore(n_shards, clock=clock or (lambda: 0),
                         shards=shards)
    store.recovered_stats = stats
    return store


def snapshot_sharded(store: ShardedStore, data_dir: str) -> None:
    """Atomic per-shard snapshots (each shard's journal may then rotate
    independently)."""
    for i, shard in enumerate(store.shards):
        directory = shard_dir(data_dir, i)
        os.makedirs(directory, exist_ok=True)
        persistence.snapshot(shard, os.path.join(directory,
                                                 "snapshot.json"))
    write_manifest(data_dir, store.n_shards)


# ---------------------------------------------------------------- migration


def migrate_single_journal(data_dir: str, n_shards: int, *,
                           clock=None) -> dict:
    """Convert a single-journal data_dir to the per-shard segment layout
    EXACTLY ONCE.  Idempotent: a manifest already on disk means the dir
    is sharded — re-running changes nothing and says so.  The original
    snapshot/journal files are renamed `*.premigrate` (kept for rollback
    and audit, never replayed)."""
    manifest = read_manifest(data_dir)
    if manifest is not None:
        return {"migrated": False, "reason": "already-sharded",
                "shards": int(manifest.get("shards", n_shards))}
    if n_shards < 2:
        raise ValueError("migration target must be >= 2 shards")
    os.makedirs(data_dir, exist_ok=True)
    source = persistence.recover(data_dir, clock=clock)
    if source is None:
        # fresh dir: stamp the layout so every later open agrees
        for i in range(n_shards):
            os.makedirs(shard_dir(data_dir, i), exist_ok=True)
        write_manifest(data_dir, n_shards, migrated_from="fresh")
        return {"migrated": True, "reason": "fresh", "jobs": 0,
                "shards": n_shards}
    router = ShardRouter(n_shards)
    shards = [_shard_factory(i, clock)() for i in range(n_shards)]
    partition = _partition(source, router, shards)
    for i, shard in enumerate(shards):
        directory = shard_dir(data_dir, i)
        os.makedirs(directory, exist_ok=True)
        persistence.snapshot(shard, os.path.join(directory,
                                                 "snapshot.json"))
    for name in ("snapshot.json", "journal.jsonl", "journal.jsonl.1"):
        path = os.path.join(data_dir, name)
        if os.path.exists(path):
            os.replace(path, path + ".premigrate")
    write_manifest(data_dir, n_shards, migrated_from="single")
    log.info("migrated %s to %d journal segments (%d jobs, %d instances)",
             data_dir, n_shards, len(source.jobs), len(source.instances))
    return {"migrated": True, "reason": "single-journal",
            "jobs": len(source.jobs), "instances": len(source.instances),
            "shards": n_shards, **partition}


def _partition(source: JobStore, router: ShardRouter,
               shards: list[JobStore]) -> dict:
    """Scatter a recovered single store's entities onto shard stores by
    the router's rules.  Direct dict fills (no events — the per-shard
    snapshot written right after IS the durable record); per-shard
    submission order preserves the source's job_seq order so DRU
    tie-breaks survive the migration."""
    for pool in source.pools.values():
        for shard in shards:
            shard.pools[pool.name] = pool
    per_shard_jobs = [0] * len(shards)
    for uuid in sorted(source.jobs,
                       key=lambda u: source.job_seq.get(u, 0)):
        job = source.jobs[uuid]
        i = router.shard_for_pool(job.pool)
        shard = shards[i]
        shard.jobs[uuid] = job
        shard.job_seq[uuid] = len(shard.job_seq)
        shard._index_job(job, None)
        per_shard_jobs[i] += 1
    for task_id, inst in source.instances.items():
        owner = None
        for shard in shards:
            if inst.job_uuid in shard.jobs:
                owner = shard
                break
        (owner or shards[META_SHARD]).instances[task_id] = inst
    for guuid, group in source.groups.items():
        owner = shards[META_SHARD]
        for member in group.job_uuids:
            job = source.jobs.get(member)
            if job is not None:
                owner = shards[router.shard_for_pool(job.pool)]
                break
        owner.groups[guuid] = group
    for (user, pool), share in source.shares.items():
        shards[router.shard_for_pool(pool)].shares[(user, pool)] = share
    for (user, pool), quota in source.quotas.items():
        shards[router.shard_for_pool(pool)].quotas[(user, pool)] = quota
    meta = shards[META_SHARD]
    meta.dynamic_config = dict(source.dynamic_config)
    meta.capacity_ledger = {k: dict(v)
                            for k, v in source.capacity_ledger.items()}
    # the idempotency table replicates to EVERY shard: a retried commit
    # routes by its op's keys, and whichever shard it lands on must
    # answer from the recorded outcome, not re-apply
    for shard in shards:
        shard.txn_results.update(source.txn_results)
    return {"per_shard_jobs": per_shard_jobs}
