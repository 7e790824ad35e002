"""Incremental host-encode cache for the match cycle's tensor build.

`prepare_pool_problem` historically re-ran `encode_nodes` (O(N × attrs))
and `feasibility_mask` (O(J × N) bitwork) from scratch every cycle, even
when neither the pool's offers nor its considerable window had changed.
At the headline scale that host work is what the device waits on.  This
cache makes the encode incremental, the same store-event-driven pattern
as the columnar job index (models/columnar.py, ranking_columnar.py):

  * the node encoding is keyed by an OFFER-SET FINGERPRINT — the
    structure-relevant fields of the pool's offers (hostname/node id
    order, attributes, gpu-present flag, free-port count, cluster
    location).  Spare mem/cpus amounts are deliberately excluded: the
    resource fit is the kernel's job, so the encoding only changes when
    offer STRUCTURE changes (host added/removed/rescinded, attrs or
    ports changed);
  * feasibility rows are cached per job against that fingerprint — the
    considerable-window fingerprint is implicit: each cycle looks up
    exactly the rows of its window's jobs, so an unchanged pool
    re-encodes O(delta) rows (new jobs only) instead of O(J × N);
  * store events invalidate: an instance status change drops its job's
    rows (the novel-host constraint depends on failed-instance history),
    a job kill / pool move drops rows, quota/share/config/pool mutations
    bump a global epoch (conservative full invalidation — they can
    change which constraints apply).

Jobs in a placement group are never cached: their rows depend on other
members' running placements, which change outside this job's own event
stream.  Rows also bypass the cache entirely while the estimated-
completion constraint is active (rows become clock-dependent).

The port of `cook_tpu/scheduler/encode_cache.py`: the same fingerprint,
invalidation rules, hit/miss decisions and LRU bound.  Where the
reference copies each missed row into an [N] array of its own, the port
keeps the mask each compute returned as a block and indexes its rows
(block, row) per job slot, so a cycle stores its misses without a copy
and copies each hit's row once, straight into the mask it serves (blocks
that hold mostly dropped rows are compacted).  `feasibility` writes into a fresh
array each call, padded to the solve's shape when asked, so the host
reservations the matcher applies afterwards narrow this cycle's rows
only, never the cached ones.

Consumers that mirror this cache (the device-resident state,
scheduler/device_state.py) `subscribe()` a callback and observe
invalidations as they land — `("row-dropped", job_uuid=...)` when a
job's rows drop, `("epoch-bumped", epoch=...)` on a conservative full
invalidation — and read `feasibility`'s `served` report (a `RowServe`
per cacheable job: how its row was obtained this cycle) instead of
diffing fingerprints every cycle.
"""
from __future__ import annotations

import itertools
import threading
from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np

from cook_tpu_torch.models.store import Event, JobStore
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.scheduler.constraints import EncodedNodes, encode_nodes
from cook_tpu_torch.utils.callbacks import notify_all
from cook_tpu_torch.utils.metrics import global_registry

# events that can change which quota/share/config-derived constraints
# apply; cheap to honor conservatively (an epoch bump = one full
# re-encode, amortized away the next cycle)
_EPOCH_EVENTS = frozenset((
    "quota/set", "quota/retracted", "share/set", "share/retracted",
    "config/updated", "pool/set", "pool/capacity",
))

# cached rows per pool; past it the least recently served rows go
MAX_ROWS_PER_POOL = 100_000
# the slot arrays' first allocation (they double as needed)
_MIN_SLOTS = 1024
# row blocks are compacted once they hold this many rows more than twice
# the live ones
_COMPACT_SLACK = 4096


class _PoolEntry:
    __slots__ = ("nodes_fp", "has_gpus", "attr_codes", "attr_vocab",
                 "hostname_to_idx", "width", "slot_of", "uuid_at", "free",
                 "block_at", "row_at", "epoch_at", "used_at", "stamp",
                 "blocks", "live", "next_block", "dropped", "computing")

    def __init__(self):
        self.nodes_fp = None
        self.has_gpus = None
        self.attr_codes = None
        self.attr_vocab = None
        self.hostname_to_idx = None
        self.clear_rows(0)
        # uuids invalidated WHILE the scheduler thread computes rows (the
        # compute read the store before the invalidating event): such a
        # drop must veto the row's write-back, or the stale row would be
        # served until the next event happens to drop it again.  Only
        # populated while a compute is in flight (`computing` > 0) and
        # cleared when it ends — recording every terminal-instance event
        # unconditionally would grow the set by dead jobs that never
        # recompute, and its overflow fallback would wipe the whole cache
        # on a steady churn of completions
        self.dropped: set[str] = set()
        self.computing: int = 0

    def clear_rows(self, width: int) -> None:
        """Forget every cached row; rows from now on are `width` nodes."""
        self.width = width
        # job uuid -> slot; per slot its uuid (None = free), the block
        # and row holding its mask row, its epoch and its LRU stamp (the
        # order rows were last served or first stored)
        self.slot_of: dict[str, int] = {}
        self.uuid_at = np.empty(0, dtype=object)
        self.free: list[int] = []
        self.block_at = np.zeros(0, dtype=np.int64)
        self.row_at = np.zeros(0, dtype=np.int64)
        self.epoch_at = np.zeros(0, dtype=np.int64)
        self.used_at = np.zeros(0, dtype=np.int64)
        self.stamp = 0
        # block id -> a [rows, width] bool mask a compute returned (kept
        # as it is, no copy), and its count of live slots
        self.blocks: dict[int, np.ndarray] = {}
        self.live: dict[int, int] = {}
        self.next_block = 0

    def _release(self, slot: int) -> None:
        block = int(self.block_at[slot])
        self.live[block] -= 1
        if not self.live[block]:
            del self.live[block], self.blocks[block]

    def drop(self, job_uuid: str) -> None:
        slot = self.slot_of.pop(job_uuid, None)
        if slot is not None:
            self._release(slot)
            self.uuid_at[slot] = None
            self.free.append(slot)

    def touch(self, slots: np.ndarray) -> None:
        self.used_at[slots] = self.stamp + np.arange(len(slots))
        self.stamp += len(slots)

    def gather(self, slots: np.ndarray, out: np.ndarray,
               dest: np.ndarray) -> None:
        """out[dest[i], :width] = the cached row of slots[i], one row
        copy each (a fancy index would first gather into a temporary as
        large as the rows, and a fresh array costs its page faults)."""
        view = out[:, :self.width]
        blocks = self.blocks
        for d, b, r in zip(dest.tolist(), self.block_at[slots].tolist(),
                           self.row_at[slots].tolist()):
            view[d] = blocks[b][r]

    def store(self, uuids: list, block: np.ndarray, rows: list,
              epoch: int) -> None:
        """Cache row `rows[i]` of `block` for `uuids[i]`; the block is
        kept, not copied.  A job without a slot gets a new one, stamped
        newest in `uuids` order; a re-stored row keeps its slot and its
        LRU place."""
        slot_of = self.slot_of
        new = [u for u in uuids if u not in slot_of]
        restored = [slot_of[u] for u in uuids if u in slot_of]
        for slot in restored:
            self._release(slot)
        if new:
            cap = len(self.uuid_at)
            short = len(new) - len(self.free)
            if short > 0:
                size = max(2 * cap, cap + short, _MIN_SLOTS)
                for name in ("block_at", "row_at", "epoch_at", "used_at",
                             "uuid_at"):
                    setattr(self, name, np.resize(getattr(self, name), size))
                self.uuid_at[cap:] = None
                self.free.extend(range(size - 1, cap - 1, -1))
            taken = self.free[-len(new):][::-1]
            del self.free[-len(new):]
            slot_of.update(zip(new, taken))
            self.uuid_at[taken] = new
            self.used_at[taken] = self.stamp + np.arange(len(new))
            self.stamp += len(new)
        dest = np.fromiter(map(slot_of.__getitem__, uuids), dtype=np.int64,
                           count=len(uuids))
        block_id = self.next_block
        self.next_block += 1
        self.blocks[block_id] = block
        self.live[block_id] = len(uuids)
        self.block_at[dest] = block_id
        self.row_at[dest] = rows
        self.epoch_at[dest] = epoch

    def evict(self, max_rows: int) -> None:
        excess = len(self.slot_of) - max_rows
        if excess > 0:
            held = np.fromiter(self.slot_of.values(), dtype=np.int64,
                               count=len(self.slot_of))
            order = np.argsort(self.used_at[held], kind="stable")
            for slot in held[order[:excess]].tolist():
                self.drop(self.uuid_at[slot])
        held_rows = sum(len(b) for b in self.blocks.values())
        if held_rows > 2 * len(self.slot_of) + _COMPACT_SLACK:
            self._compact()

    def _compact(self) -> None:
        """Copy the live rows into one block (the blocks held mostly rows
        of dropped jobs)."""
        slots = np.fromiter(self.slot_of.values(), dtype=np.int64,
                            count=len(self.slot_of))
        block = np.empty((len(slots), self.width), dtype=bool)
        self.gather(slots, block, np.arange(len(slots)))
        block_id = self.next_block
        self.next_block += 1
        self.blocks = {block_id: block}
        self.live = {block_id: len(slots)}
        self.block_at[slots] = block_id
        self.row_at[slots] = np.arange(len(slots))


def offers_fingerprint(cluster_offers: Sequence[tuple]) -> int:
    """Hash of the encode-relevant structure of a pool's (cluster, offer)
    list.  Everything `encode_nodes` + the static feasibility columns
    read, nothing the kernel reads (spare amounts churn every launch)."""
    return hash(tuple(
        (cluster.location, o.node_id, o.hostname, o.attributes,
         o.gpus > 0, o.port_count(), o.disk > 0)
        for cluster, o in cluster_offers
    ))


class RowServe(NamedTuple):
    """How one cacheable job's feasibility row was served this cycle —
    the per-row report consumers (the device mirror) key residency on.
    `cached` is False when the row could not be written back (epoch
    moved mid-compute, open balanced pre-row, mid-compute invalidation):
    such rows must not be treated as stable by any downstream cache."""

    epoch: int
    fresh: bool      # recomputed this cycle (False = served from cache)
    cached: bool     # the row is (still) in the cache at `epoch`


class EncodeCache:
    """Per-pool incremental encode state, invalidated by store events.

    Subscriber callbacks (`subscribe`) run OUTSIDE the cache lock (they
    may take their own locks) on the event-delivering thread; they must
    be cheap and must not call back into the cache."""

    def __init__(self, store: Optional[JobStore] = None):
        self._pools: dict[str, _PoolEntry] = {}
        self._epoch = 0
        self._lock = threading.Lock()
        self._subscribers: list[Callable] = []
        self._rows_counter = global_registry.counter(
            "match.encode_cache.rows",
            "feasibility rows served from / recomputed into the host-"
            "encode cache, by result")
        self._nodes_counter = global_registry.counter(
            "match.encode_cache.nodes",
            "node encodings served from / recomputed into the host-"
            "encode cache, by result")
        if store is not None:
            store.add_watcher(self._on_event)

    # ------------------------------------------------------ subscribers

    def subscribe(self, callback: Callable) -> None:
        """Register an invalidation observer: callback(kind, **info)
        with kind "row-dropped" (job_uuid=...) or "epoch-bumped"
        (epoch=...)."""
        with self._lock:
            self._subscribers.append(callback)

    def _notify(self, kind: str, **info) -> None:
        # a sick subscriber must never block store-event delivery (the
        # mirror rebuilds from its own staleness checks; losing one
        # notification costs a rebuild, not correctness)
        notify_all(self._subscribers, f"encode-cache {kind}", kind, **info)

    # ------------------------------------------------------- invalidation

    def _on_event(self, event: Event) -> None:
        kind = event.kind
        if kind in _EPOCH_EVENTS:
            with self._lock:
                self._epoch += 1
                epoch = self._epoch
            self._notify("epoch-bumped", epoch=epoch)
            return
        if kind == "instance/status":
            # failed-instance history feeds the novel-host constraint.
            # (instance/cancelled is deliberately NOT handled: a cancel
            # only marks intent — the row's inputs change at the terminal
            # instance/status transition that follows)
            self._drop_job(event.data.get("job"))
        elif kind in ("job/state", "job/pool-moved"):
            self._drop_job(event.data.get("uuid"))

    def _drop_job(self, job_uuid: Optional[str]) -> None:
        if not job_uuid:
            return
        epoch_bumped = False
        with self._lock:
            for entry in self._pools.values():
                entry.drop(job_uuid)
                if not entry.computing:
                    continue  # no in-flight compute to veto
                if len(entry.dropped) < 10_000:
                    entry.dropped.add(job_uuid)
                else:
                    # overflow (event storm within ONE compute): fall
                    # back to a conservative epoch bump rather than
                    # forgetting an invalidation
                    self._epoch += 1
                    epoch_bumped = True
                    entry.dropped.clear()
            epoch = self._epoch
        self._notify("row-dropped", job_uuid=job_uuid)
        if epoch_bumped:
            self._notify("epoch-bumped", epoch=epoch)

    def clear(self) -> None:
        with self._lock:
            self._pools.clear()
            self._epoch += 1
            epoch = self._epoch
        self._notify("epoch-bumped", epoch=epoch)

    @property
    def epoch(self) -> int:
        with self._lock:
            return self._epoch

    # ------------------------------------------------------------- encode

    def encoded_nodes(self, pool: str, cluster_offers: Sequence[tuple]):
        """(EncodedNodes, fingerprint) for the pool's current offers,
        reusing the attribute/vocab encoding when the offer structure is
        unchanged (the offers list itself is always refreshed — spare
        amounts feed the kernel tensors and change every cycle)."""
        offers = [o for _, o in cluster_offers]
        fp = offers_fingerprint(cluster_offers)
        with self._lock:
            entry = self._pools.setdefault(pool, _PoolEntry())
            # collision guard: a colliding fingerprint with a DIFFERENT
            # node count must rebuild — serving the cached attr/gpu
            # columns against a differently-sized offer list would
            # corrupt every downstream mask
            hit = (entry.nodes_fp == fp and entry.has_gpus is not None
                   and len(entry.has_gpus) == len(offers))
            if hit:
                nodes = EncodedNodes(
                    offers=offers,
                    hostname_to_idx=entry.hostname_to_idx,
                    has_gpus=entry.has_gpus,
                    attr_codes=entry.attr_codes,
                    attr_vocab=entry.attr_vocab,
                )
        if not hit:
            nodes = encode_nodes(offers)
            with self._lock:
                entry = self._pools.setdefault(pool, _PoolEntry())
                entry.nodes_fp = fp
                entry.hostname_to_idx = nodes.hostname_to_idx
                entry.has_gpus = nodes.has_gpus
                entry.attr_codes = nodes.attr_codes
                entry.attr_vocab = nodes.attr_vocab
                # rows encode against a specific node set; a structural
                # change invalidates every cached row of the pool
                entry.clear_rows(len(offers))
        self._nodes_counter.inc(1, {"result": "hit" if hit else "miss"})
        # residency ledger: the node tensors are re-transferred every
        # cycle; a fingerprint hit means their encode-relevant content
        # was unchanged — the transfer was residency waste
        node_bytes = data_plane.NODE_ROW_BYTES * len(offers)
        data_plane.note_residency(0 if hit else node_bytes,
                                  node_bytes if hit else 0, kind="nodes")
        return nodes, fp

    # -------------------------------------------------------- feasibility

    @staticmethod
    def cacheable_job(job) -> bool:
        """Group members' rows depend on sibling placements that change
        outside this job's event stream — never cached."""
        return not job.group_uuid

    def feasibility(
        self,
        pool: str,
        jobs: Sequence,
        n_nodes: int,
        nodes_fp: int,
        compute: Callable[[list, dict[int, np.ndarray]], np.ndarray],
        balanced_pre_rows: Optional[dict[int, np.ndarray]] = None,
        pad_shape: Optional[tuple[int, int]] = None,
        served: Optional[dict[str, RowServe]] = None,
    ) -> np.ndarray:
        """Assemble the [J, N] mask from cached rows plus a delta
        computation.

        `compute(subset_jobs, subset_pre_rows)` must return the mask for
        just the uncached jobs, as a new array the cache may keep (the
        caller closes over group context etc.); its balanced_pre_rows (keyed by subset index) are remapped
        into the caller's dict keyed by full-window index.  Returns a
        FRESH array — callers may mutate it (host reservations) without
        corrupting the cache.

        With `pad_shape` (>= [J, N]) the mask comes back padded to it,
        the padding False: the solve's padded mask, built once (its
        [:J, :N] view is the mask).

        `served` (out-param) collects a RowServe per CACHEABLE job: how
        its row was obtained this cycle.  The device mirror keys slot
        persistence on it — a row the host cache itself refused to keep
        (mid-compute invalidation, open pre-closure) must not persist on
        device either."""
        j = len(jobs)
        uuids = [job.uuid for job in jobs]
        # cacheable_job, inlined: one generator step per job
        cacheable = np.fromiter((not job.group_uuid for job in jobs),
                                dtype=bool, count=j)
        out = np.zeros(pad_shape or (j, n_nodes), dtype=bool)
        feasible = out[:j, :n_nodes]
        with self._lock:
            epoch = self._epoch
            entry = self._pools.setdefault(pool, _PoolEntry())
            hit = np.zeros(j, dtype=bool)
            if entry.nodes_fp == nodes_fp and entry.width != n_nodes:
                # rows of another width can serve no job of this call
                entry.clear_rows(n_nodes)
            if entry.nodes_fp == nodes_fp and entry.slot_of:
                slots = np.fromiter(
                    map(entry.slot_of.get, uuids, itertools.repeat(-1, j)),
                    dtype=np.int64, count=j)
                hit = cacheable & (slots >= 0)
                hit[hit] = entry.epoch_at[slots[hit]] == epoch
            hit_idx = np.flatnonzero(hit)
            subset_idx = np.flatnonzero(~hit)
            # the hits' rows, copied out under the lock: a drop landing
            # during the compute below can release their blocks
            if hit_idx.size:
                entry.gather(slots[hit_idx], feasible, hit_idx)
                entry.touch(slots[hit_idx])
            if subset_idx.size:
                # open the veto window: drops landing from here until the
                # write-back completes must not be overwritten by a row
                # computed from pre-event store state
                entry.computing += 1
        if served is not None:
            hit_serve = RowServe(epoch, fresh=False, cached=True)
            for ji in hit_idx.tolist():
                served[uuids[ji]] = hit_serve
        if subset_idx.size:
            subset = [jobs[i] for i in subset_idx.tolist()]
            sub_pre_rows: dict[int, np.ndarray] = {}
            try:
                submask = np.asarray(compute(subset, sub_pre_rows),
                                     dtype=bool)
                if hit_idx.size:
                    feasible[subset_idx] = submask
                else:
                    feasible[:] = submask
                with self._lock:
                    entry = self._pools.setdefault(pool, _PoolEntry())
                    if (entry.nodes_fp == nodes_fp and self._epoch == epoch
                            and entry.width == n_nodes):
                        dropped = entry.dropped
                        keep = [k for k, ji in enumerate(subset_idx.tolist())
                                if cacheable[ji]
                                # a row with an open pre-closure variant
                                # is cycle-dependent; don't cache it
                                and k not in sub_pre_rows
                                # an event invalidated this job while the
                                # row was being computed: the compute may
                                # predate the event's effect — don't
                                # cache
                                and uuids[ji] not in dropped]
                        if keep:
                            # the compute's own mask becomes the rows'
                            # block: nothing else holds it (the caller
                            # gets `out`)
                            entry.store([uuids[subset_idx[k]] for k in keep],
                                        submask, keep, epoch)
                            entry.evict(MAX_ROWS_PER_POOL)
                    else:
                        keep = []
                if served is not None:
                    kept = set(keep)
                    for k, ji in enumerate(subset_idx.tolist()):
                        if cacheable[ji]:
                            served[uuids[ji]] = RowServe(
                                epoch, fresh=True, cached=k in kept)
            finally:
                with self._lock:
                    entry = self._pools.setdefault(pool, _PoolEntry())
                    entry.computing = max(entry.computing - 1, 0)
                    if entry.computing == 0:
                        entry.dropped.clear()
            if balanced_pre_rows is not None:
                for k, row in sub_pre_rows.items():
                    balanced_pre_rows[int(subset_idx[k])] = row
        hits = int(hit_idx.size)
        if hits:
            self._rows_counter.inc(hits, {"result": "hit"})
        if subset_idx.size:
            self._rows_counter.inc(int(subset_idx.size), {"result": "miss"})
        # residency ledger (obs/data_plane.py): a cache-hit row's bytes
        # were re-transferred UNCHANGED — the per-cycle rebuild_fraction
        # is fresh / (fresh + cached) over exactly these row bytes
        data_plane.note_residency(int(subset_idx.size) * n_nodes,
                                  hits * n_nodes)
        return out

