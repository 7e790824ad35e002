"""Device-resident match state: persistent encode tensors, O(delta) updates.

Port of `cook_tpu/scheduler/device_state.py`.  An unchanged cached pool
reports `rebuild_fraction` 0.0 on the host yet re-transfers 100% of its
node-encode and job-feasibility bytes every cycle.  This module removes
that waste: per-pool demand and feasibility tensors live ON THE DEVICE
across cycles, and a cycle uploads only

  * the delta rows (new jobs, invalidated feasibility rows), written into
    the resident buffers in place (`ops/device_update.scatter_rows`, one
    update bucket per padded delta size, compile-observatory keyed);
  * the per-cycle small tensors that genuinely change every cycle
    (avail/totals/node_valid — spare amounts churn with every launch —
    plus the [J] schedule-order permutation and job_valid).

**Validity.**  A mirror is keyed by the host `EncodeCache`'s own
currency: the offer-structure fingerprint, the encode-cache epoch, and
the per-row `RowServe` report the cache emits each cycle.  A resident
row is reused ONLY when the host cache served that job's row as a HIT at
the epoch the mirror stamped on upload — so mirror correctness never
depends on observing every invalidation: a lost notification costs one
re-upload, not a stale solve.  The cache's subscriber callback
(row-dropped / epoch-bumped) frees slots and forces rebuilds eagerly.

**Rebuilds.**  Epoch bumps (quota/share/config/pool mutations), offer
structure changes, job-axis bucket growth, and dtype flips (quantized
demotion) fall back to a clean full rebuild — the classic full-upload
path, amortized away the next cycle.

**Schedule order.**  The ranked queue reorders every cycle, so resident
rows are stored in SLOT order and gathered into schedule order on the
device (`gather_rows`): the permutation is the only per-cycle job-axis
upload.  The gather also produces FRESH problem tensors: the resident
buffers change in place on the next delta cycle, and a problem a reader
may still hold must never alias them.

**Quantization.**  `MatchConfig.quantized` stores the cost tensors
(demands/avail/totals) as bfloat16 (`torch.bfloat16`, cast on the host
before the transfer, so the H2D bytes halve) — half the resident bytes
and half the delta traffic; feasibility stays bool (already minimal).
The kernels cast them back to float32 at their boundary, as the
reference's Pallas calls do.  The QualityMonitor parity guard rides the
shadow-solve samples: a pool whose packing-efficiency ratio drops below
`QUANTIZATION_PARITY_FLOOR` is demoted to f32 (the mirror rebuilds at
the wider dtype) and stays demoted for the process lifetime.

**DRU columns.**  The rank cycle's task columns ride the same store via
`resident_array`: content-fingerprinted whole-column reuse (an unchanged
queue re-uploads nothing; any change re-uploads that column).

**Keyed rows.**  `ResidentRows` mirrors cycle-built tensor families with
no host cache (the rebalancer's victim tensors): content addressing is
the serve report.

The device is the owner's (the scheduler's): CUDA unless the caller
passes `device="cpu"`.  On the CPU a "device" tensor may share memory
with the host array it was made from, so the whole-array caches keep
private copies there.
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
import weakref
from collections import OrderedDict
from typing import Optional, Union

import numpy as np
import torch

from cook_tpu_torch.device import resolve
from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.ops.common import bucket_size, host_cast, pad_to
from cook_tpu_torch.ops.device_update import (
    gather_rows,
    mark_use,
    scatter_rows,
)
from cook_tpu_torch.scheduler.flight_recorder import NULL_CYCLE
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)

# resident_array cache bound: (pool, column-name) keys — a handful per
# pool; the bound only matters when pools churn
MAX_RESIDENT_ARRAYS = 256

# the quantization parity guard's floor: a quantized pool whose
# packing-efficiency ratio (quality monitor sample) falls under it is
# demoted to float32 (the reference's MatchConfig default)
QUANTIZATION_PARITY_FLOOR = 0.98


def quantized_dtype() -> torch.dtype:
    """The quantized cost-tensor dtype: bfloat16, 2 bytes an element."""
    return torch.bfloat16


def dtype_name(dtype: Optional[torch.dtype]) -> str:
    """"float32" / "bfloat16": the reference's (numpy) dtype names."""
    return str(dtype).removeprefix("torch.") if dtype is not None else ""


def _fingerprint(arr: np.ndarray) -> tuple:
    return (arr.shape, str(arr.dtype),
            hashlib.blake2b(arr.tobytes(), digest_size=16).digest())


def _slot_allocator(slots: OrderedDict, free: list, window: set):
    """One delta update's row allocator (both mirrors' slot maps: key ->
    (row, validity stamp), LRU order): a free row, else the row of the
    least recently used key outside this cycle's window, else None.  The
    update reorders and replaces only window keys' slots and evicts from
    the front of the evictable list, so the list taken once at its start
    gives every eviction the reference's scan from the oldest slot gives,
    without rescanning the window's keys for each one (that scan is
    quadratic in the window)."""
    evictable = iter([key for key in slots if key not in window])

    def allocate() -> Optional[int]:
        if free:
            return free.pop()
        for key in evictable:  # oldest first (LRU order)
            row, _ = slots.pop(key)
            return row
        return None

    return allocate


class _ArrayCache:
    """Content-fingerprinted whole-array residency: a key's device copy
    is served again while the host content stays byte-identical, else
    uploaded and replaced; at most MAX_RESIDENT_ARRAYS keys, the least
    recently used dropped first.  Served tensors are shared across
    cycles — kernel INPUT only, never written in place."""

    def __init__(self, device: torch.device, counter):
        self.device = device
        self._counter = counter      # device_state.array_reuse
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()  # key -> (fp, tensor)

    def get(self, key, host_array: np.ndarray, family: str) -> torch.Tensor:
        arr = np.ascontiguousarray(host_array)
        fp = _fingerprint(arr)
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry[0] == fp:
                self._entries.move_to_end(key)
                self._counter.inc(1, {"result": "hit"})
                return entry[1]
        if self.device.type == "cpu":
            # on the CPU the put would share the caller's memory
            arr = arr.copy()
        dev = data_plane.h2d(arr, family=family, device=self.device)
        with self._lock:
            self._entries[key] = (fp, dev)
            self._entries.move_to_end(key)
            while len(self._entries) > MAX_RESIDENT_ARRAYS:
                self._entries.popitem(last=False)
        self._counter.inc(1, {"result": "miss"})
        return dev

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def nbytes(self) -> dict:
        """key -> resident bytes."""
        with self._lock:
            return {key: int(dev.nbytes)
                    for key, (_fp, dev) in self._entries.items()}


class _Mirror:
    """One pool's resident buffers + slot map."""

    __slots__ = ("nodes_fp", "n_real", "n_pad", "cap", "dtype",
                 "cache_epoch", "demands", "feas", "slots", "free", "last")

    def __init__(self):
        self.nodes_fp = None
        self.n_real = 0          # UNPADDED node count: fingerprint-
        self.n_pad = 0           # collision guard (a colliding fp with a
        self.cap = 0             # different node count must rebuild)
        self.dtype = None
        self.cache_epoch = -1
        self.demands = None      # device [cap + 1, R]
        self.feas = None         # device [cap + 1, n_pad] bool
        # job uuid -> (row, epoch-at-upload); LRU order for eviction
        self.slots: OrderedDict[str, tuple[int, int]] = OrderedDict()
        self.free: list[int] = []
        self.last: dict = {}

    @property
    def resident_bytes(self) -> int:
        return sum(int(buf.nbytes) for buf in (self.demands, self.feas)
                   if buf is not None)


# every live DeviceResidentState, for the debug surface (snapshot_all)
_REGISTRY: "weakref.WeakSet[DeviceResidentState]" = weakref.WeakSet()

# every live ResidentRows mirror (the rebalancer's victim tensors)
_ROW_REGISTRY: "weakref.WeakSet[ResidentRows]" = weakref.WeakSet()


def snapshot_all() -> dict:
    """The device_state debug section: every live resident state's pools
    + guard status (normally exactly one per process), plus the
    keyed-row mirrors (`ResidentRows`)."""
    states = [state.debug_json() for state in list(_REGISTRY)]
    rows = sorted((m.debug_json() for m in list(_ROW_REGISTRY)),
                  key=lambda d: d["name"])
    return {"enabled": bool(states) or bool(rows), "states": states,
            "row_mirrors": rows}


class DeviceResidentState:
    """Per-pool device mirror of the encode cache + quantization guard.

    Thread-safety: builds run on the scheduler's driving thread; the
    encode-cache subscriber delivers invalidations from store-event
    threads — every mutation takes the state lock.
    """

    def __init__(self, encode_cache=None, observatory=None, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.encode_cache = encode_cache
        self.observatory = observatory
        self.device = resolve(device)
        self._lock = threading.RLock()
        self._mirrors: dict[str, _Mirror] = {}
        # resident-state epoch: bumped on cache epoch bumps and explicit
        # invalidation (a speculative dispatch stamps it in the
        # reference, so a commit never finalizes a problem built from
        # dropped state)
        self._epoch = 0
        # quantization guard: pools demoted to f32 after a parity breach
        self._demoted: set[str] = set()
        self._quant_armed: set[str] = set()
        if encode_cache is not None:
            encode_cache.subscribe(self._on_cache_event)
        self._resident_gauge = global_registry.gauge(
            "device_state.resident_bytes",
            "bytes of match-state tensors resident on device, per pool")
        self._delta_counter = global_registry.counter(
            "device_state.delta_rows",
            "resident-state rows updated via in-place scatter, per pool")
        self._update_counter = global_registry.counter(
            "device_state.updates",
            "match cycles served by O(delta) resident-state updates, "
            "per pool")
        self._rebuild_counter = global_registry.counter(
            "device_state.rebuilds",
            "resident-state full rebuilds, per pool/reason (cold / "
            "offers-changed / epoch-bumped / bucket-growth / "
            "dtype-changed)")
        self._update_hist = global_registry.histogram(
            "device_state.update_seconds",
            "wall seconds of the per-cycle resident-state update "
            "(delta upload + scatter, or full rebuild upload)")
        # resident whole-array cache (DRU columns), keyed (pool, name)
        self._arrays = _ArrayCache(self.device, global_registry.counter(
            "device_state.array_reuse",
            "resident whole-array (DRU column) requests, by result"))
        self._demotion_counter = global_registry.counter(
            "device_state.quant_demotions",
            "pools demoted from quantized (bf16) to f32 cost tensors by "
            "the QualityMonitor parity guard")
        _REGISTRY.add(self)

    # ---------------------------------------------------------- invalidation

    def _on_cache_event(self, kind: str, **info) -> None:
        """EncodeCache subscriber: free mirror slots / force rebuilds as
        invalidations land (correctness does not depend on this — the
        RowServe rule already refuses stale rows — but eager slot drops
        keep resident memory honest and rebuilds prompt)."""
        with self._lock:
            if kind == "epoch-bumped":
                self._epoch += 1
                for mirror in self._mirrors.values():
                    mirror.cache_epoch = -1  # next build rebuilds clean
            elif kind == "row-dropped":
                uuid = info.get("job_uuid")
                for mirror in self._mirrors.values():
                    slot = mirror.slots.pop(uuid, None)
                    if slot is not None:
                        mirror.free.append(slot[0])

    def invalidate(self) -> None:
        """Drop every mirror and resident array (tests, resync)."""
        with self._lock:
            self._epoch += 1
            self._mirrors.clear()
            self._arrays.clear()

    @property
    def epoch(self) -> int:
        """Resident-state generation (the reference's speculation guard
        stamps it at dispatch: a bump between dispatch and commit drops
        the speculation)."""
        with self._lock:
            return self._epoch

    # --------------------------------------------------------- quantization

    def quantized_for(self, config, pool: str) -> bool:
        """Whether this pool's cost tensors build as bf16 this cycle;
        arms the parity guard (a pool never observed quantized must not
        be demotable by an unrelated quality dip)."""
        if not getattr(config, "quantized", False):
            return False
        with self._lock:
            if pool in self._demoted:
                return False
            self._quant_armed.add(pool)
            return True

    def note_quality(self, pool: str, ratio: float) -> None:
        """QualityMonitor sample listener: demote a quantized pool whose
        packing-efficiency parity broke the floor.  The next build
        rebuilds the mirror at f32 (dtype change)."""
        with self._lock:
            if pool not in self._quant_armed or pool in self._demoted:
                return
            if ratio >= QUANTIZATION_PARITY_FLOOR:
                return
            self._demoted.add(pool)
        self._demotion_counter.inc(1, {"pool": pool})
        log.warning("pool %s: quantized cost tensors broke the parity "
                    "floor (%.4f < %.2f); demoting to f32", pool, ratio,
                    QUANTIZATION_PARITY_FLOOR)

    def demoted_pools(self) -> list[str]:
        with self._lock:
            return sorted(self._demoted)

    # -------------------------------------------------------------- build

    def build_problem(self, pool: str, jobs, nodes, feasible: np.ndarray,
                      nodes_fp: int, served: dict, config,
                      flight=NULL_CYCLE,
                      padded_feasible: Optional[np.ndarray] = None):
        """Build the pool's padded MatchProblem from the resident mirror
        plus this cycle's delta.  `served` is the EncodeCache's RowServe
        report for the cycle (cacheable jobs only); `feasible` the
        unpadded [J, N] host mask (reservation-free — callers bypass the
        mirror when reservations mutate rows).  `padded_feasible`, when
        given, is that mask padded with False to the mirror's buffer
        shape ([padded jobs + 1, padded nodes]; `feasible` a view of it):
        a rebuild uploads it as it is and a delta takes its rows, with no
        padded copy of their own."""
        from cook_tpu_torch.scheduler.matcher import (
            encode_problem_arrays,
            padded_job_axis,
        )

        t0 = time.perf_counter()
        j, n = len(jobs), nodes.n
        pad_j = padded_job_axis(j, config.chunk)
        pad_n = bucket_size(max(n, 1))
        quantized = self.quantized_for(config, pool)
        dtype = quantized_dtype() if quantized else torch.float32
        cache_epoch = (self.encode_cache.epoch
                       if self.encode_cache is not None else 0)
        demands, avail, totals = encode_problem_arrays(jobs, nodes.offers,
                                                       config)
        with self._lock:
            try:
                if padded_feasible is not None and \
                        padded_feasible.shape == (pad_j + 1, pad_n):
                    feasible = padded_feasible
                return self._build_locked(
                    pool, jobs, nodes, feasible, nodes_fp, served, config,
                    flight, demands, avail, totals, j, n, pad_j, pad_n,
                    quantized, dtype, cache_epoch, t0)
            except Exception:
                # a half-applied update (e.g. the second scatter raising
                # after the first landed) must never survive: slots could
                # claim rows whose content never landed.  Drop the mirror
                # — the next cycle rebuilds cold — and re-raise
                self._mirrors.pop(pool, None)
                raise

    def _build_locked(self, pool, jobs, nodes, feasible, nodes_fp, served,
                      config, flight, demands, avail, totals, j, n, pad_j,
                      pad_n, quantized, dtype, cache_epoch, t0):
        """The guarded body of build_problem; the caller holds the state
        lock (re-entrant — re-taken here so the lock scope reads locally)
        and drops the pool's mirror on ANY raise."""
        from cook_tpu_torch.ops.match import MatchProblem

        dev = self.device
        with self._lock:
            mirror = self._mirrors.get(pool)
            rebuild = None
            if mirror is None or mirror.demands is None:
                rebuild = "cold"
            elif mirror.nodes_fp != nodes_fp:
                rebuild = "offers-changed"
            elif mirror.n_real != n or mirror.n_pad != pad_n:
                # fingerprint collision guard: a matching fp with a
                # differing node count must never serve resident rows
                rebuild = "offers-changed"
            elif mirror.cache_epoch != cache_epoch:
                rebuild = "epoch-bumped"
            elif mirror.cap < pad_j:
                rebuild = "bucket-growth"
            elif mirror.dtype != dtype:
                rebuild = "dtype-changed"

            if rebuild is None:
                stats = self._delta_update(
                    mirror, jobs, demands, feasible, served, n, pad_n,
                    dtype)
                if stats is None:
                    rebuild = "bucket-growth"  # slot allocation failed
            if rebuild is not None:
                mirror, stats = self._rebuild(
                    pool, jobs, demands, feasible, served, nodes_fp,
                    cache_epoch, n, pad_j, pad_n, dtype)
                stats["reason"] = rebuild
                self._rebuild_counter.inc(1, {"pool": pool,
                                              "reason": rebuild})
            else:
                self._update_counter.inc(1, {"pool": pool})
                if stats["delta_rows"]:
                    self._delta_counter.inc(stats["delta_rows"],
                                            {"pool": pool})

            # schedule-order permutation: the one per-cycle job-axis
            # upload a warm cycle pays (rows live in slot order).  Padded
            # entries point at the dedicated all-zero pad row (index
            # cap), so the gathered problem is CONTENT-identical to the
            # classic build — zero demands, all-False feasibility — not
            # merely job_valid-masked
            perm = np.full(pad_j, mirror.cap, dtype=np.int32)
            perm[:j] = stats.pop("_rows")
            transient = stats.pop("_transient", ())
            mirror.free.extend(transient)
            resident_bytes = mirror.resident_bytes

            fam = data_plane.FAM_NODE_ENCODE
            perm_dev = data_plane.h2d(perm, family=fam, device=dev)
            data_plane.note_padding("match", (pad_j, pad_n),
                                    valid_cells=j * n,
                                    padded_cells=pad_j * pad_n)
            # the gathers are queued under the lock: a later build's
            # in-place scatter into these buffers is ordered after them
            problem = MatchProblem(
                demands=gather_rows(mirror.demands, perm_dev,
                                    observatory=self.observatory),
                job_valid=data_plane.h2d(
                    pad_to(np.ones(j, dtype=bool), pad_j, fill=False),
                    family=fam, device=dev),
                avail=data_plane.h2d(host_cast(pad_to(avail, pad_n), dtype),
                                     family=fam, device=dev),
                totals=data_plane.h2d(
                    host_cast(pad_to(totals, pad_n), dtype), family=fam,
                    device=dev),
                node_valid=data_plane.h2d(
                    pad_to(np.ones(n, dtype=bool), pad_n, fill=False),
                    family=fam, device=dev),
                feasible=gather_rows(mirror.feas, perm_dev,
                                     observatory=self.observatory),
            )
        update_s = time.perf_counter() - t0
        stats.update(resident_bytes=resident_bytes, update_s=update_s,
                     quantized=quantized, jobs=j,
                     resident_rows=j - stats["delta_rows"])
        self._resident_gauge.set(resident_bytes, {"pool": pool})
        self._update_hist.observe(update_s)
        with self._lock:
            mirror.last = dict(stats)
        flight.note_device_state(stats)
        return problem

    def _rebuild(self, pool: str, jobs, demands, feasible, served,
                 nodes_fp: int, cache_epoch: int, n: int, pad_j: int,
                 pad_n: int, dtype):
        """Clean full rebuild: fresh buffers, every row uploaded (the
        classic full-transfer cycle — amortized away from the next cycle
        on).  Caller holds the lock."""
        j = len(jobs)
        cap = max(pad_j, 1)
        mirror = _Mirror()
        mirror.nodes_fp = nodes_fp
        mirror.n_real = n
        mirror.n_pad = pad_n
        mirror.cap = cap
        mirror.dtype = dtype
        mirror.cache_epoch = cache_epoch
        # cap + 1 rows: the LAST row is the dedicated all-zero pad row
        # padded perm entries gather (never allocated, never scattered),
        # so padded problem rows read zero demands / all-False rows
        # exactly like the classic build's.  A mask the cache already
        # padded to that shape is uploaded as it is
        if feasible.shape == (cap + 1, pad_n):
            feas_buf = feasible
        else:
            feas_buf = np.zeros((cap + 1, pad_n), dtype=bool)
            feas_buf[:j, :n] = feasible[:j, :n]
        mirror.demands = data_plane.h2d(
            host_cast(pad_to(demands, cap + 1), dtype),
            family=data_plane.FAM_NODE_ENCODE, device=self.device)
        mirror.feas = data_plane.h2d(feas_buf,
                                     family=data_plane.FAM_FEASIBILITY,
                                     device=self.device)
        rows = []
        for ji, job in enumerate(jobs):
            serve = served.get(job.uuid) if served is not None else None
            if serve is not None and serve.cached:
                mirror.slots[job.uuid] = (ji, serve.epoch)
            rows.append(ji)
        occupied = {row for row, _ in mirror.slots.values()}
        mirror.free = [row for row in range(cap) if row not in occupied]
        self._mirrors[pool] = mirror
        return mirror, {"rebuild": True, "delta_rows": j, "_rows": rows,
                        "_transient": []}

    def _delta_update(self, mirror: _Mirror, jobs, demands, feasible,
                      served, n: int, pad_n: int,
                      dtype) -> Optional[dict]:
        """Apply this cycle's O(delta) row updates to a valid mirror.
        Returns the build stats (with the schedule-order row list), or
        None when slot allocation is impossible (forces a rebuild).
        Caller holds the lock."""
        j = len(jobs)
        rows = [0] * j
        delta_ji: list[int] = []
        delta_rows: list[int] = []
        transient: list[int] = []
        allocate = _slot_allocator(mirror.slots, mirror.free,
                                   {job.uuid for job in jobs})

        for ji, job in enumerate(jobs):
            serve = served.get(job.uuid) if served is not None else None
            slot = mirror.slots.get(job.uuid)
            if (serve is not None and not serve.fresh and slot is not None
                    and slot[1] == serve.epoch):
                # resident hit: the host cache served this row unchanged
                # at the epoch we uploaded it — zero bytes move
                rows[ji] = slot[0]
                mirror.slots.move_to_end(job.uuid)
                continue
            if slot is not None:
                row = slot[0]
            else:
                row = allocate()
                if row is None:
                    return None
            rows[ji] = row
            delta_ji.append(ji)
            delta_rows.append(row)
            if serve is not None and serve.cached:
                mirror.slots[job.uuid] = (row, serve.epoch)
                mirror.slots.move_to_end(job.uuid)
            else:
                # transient row (group job, uncacheable serve): freed
                # after the gather — its content is this cycle's only
                mirror.slots.pop(job.uuid, None)
                transient.append(row)

        if delta_ji:
            idx = np.asarray(delta_rows, dtype=np.int32)
            if feasible.shape[1] == pad_n:
                feas_rows = feasible[delta_ji]   # padded with False
            else:
                feas_rows = np.zeros((len(delta_ji), pad_n), dtype=bool)
                feas_rows[:, :n] = feasible[delta_ji][:, :n]
            mirror.demands = scatter_rows(
                mirror.demands, idx, host_cast(demands[delta_ji], dtype),
                family=data_plane.FAM_NODE_ENCODE,
                observatory=self.observatory)
            mirror.feas = scatter_rows(
                mirror.feas, idx, feas_rows,
                family=data_plane.FAM_FEASIBILITY,
                observatory=self.observatory)
        return {"rebuild": False, "reason": "",
                "delta_rows": len(delta_ji), "_rows": rows,
                "_transient": transient}

    # ----------------------------------------------------- resident arrays

    def resident_array(self, pool: str, name: str, host_array: np.ndarray,
                       family: Optional[str] = None) -> torch.Tensor:
        """Content-fingerprinted whole-array residency (DRU columns):
        returns the resident device copy when the host content is
        byte-identical to the last upload, else uploads and replaces.
        The returned tensor is shared across cycles — callers must treat
        it as immutable kernel INPUT (never write it in place)."""
        return self._arrays.get((pool, name), host_array,
                                family or data_plane.FAM_DRU)

    # -------------------------------------------------------------- debug

    def debug_json(self) -> dict:
        with self._lock:
            pools = {}
            for name, mirror in self._mirrors.items():
                pools[name] = {
                    "resident_bytes": mirror.resident_bytes,
                    "cap": mirror.cap,
                    "n_pad": mirror.n_pad,
                    "slots": len(mirror.slots),
                    "dtype": dtype_name(mirror.dtype),
                    "cache_epoch": mirror.cache_epoch,
                    "last": dict(mirror.last),
                }
            arrays = {}
            for (pool, name), nbytes in self._arrays.nbytes().items():
                arrays.setdefault(pool, {})[name] = nbytes
            return {
                "epoch": self._epoch,
                "quantized_demoted": sorted(self._demoted),
                "pools": pools,
                "resident_arrays": arrays,
            }


class ResidentRows:
    """Content-addressed keyed-row device mirror for cycle-built tensor
    families — the rebalancer's victim tensors, which the ledger showed
    rebuilding from host state on every dispatch.

    The match mirror above keys row validity on the host EncodeCache's
    RowServe report; these families have no host cache, so content
    addressing IS the serve report: each key's row is fingerprinted over
    the concatenated column bytes, and a row whose fingerprint matches
    the resident copy moves ZERO bytes (a stale fingerprint can only cost
    a re-upload, never a stale solve).  Deltas ride the same bucket-
    padded in-place scatters (`ops/device_update.scatter_rows`), and the
    per-cycle row order is a device gather through a FINGERPRINT-CACHED
    permutation — an unchanged layout re-uploads neither rows nor the
    perm, so a warm dispatch's H2D is ~0 against the cold rebuild's.

    Rebuild-reason ladder (stamped like the match mirror's): `cold` (no
    buffers), `width-changed` (column set / trailing shape / dtype
    differs), `bucket-growth` (key count outgrew the row bucket, or slot
    allocation failed).

    Like `_Mirror`, buffers carry cap + 1 rows with a dedicated all-zero
    pad row at index cap: out-of-window output rows gather zeros, so
    integer columns that need a -1 pad encode value+1 and subtract on
    the device after the gather (the rebalancer's task->host column).
    """

    def __init__(self, name: str, observatory=None,
                 family: Optional[str] = None, *,
                 device: Optional[Union[str, torch.device]] = None):
        self.name = name
        self.observatory = observatory
        self.family = family or data_plane.FAM_OTHER
        self.device = resolve(device)
        self._lock = threading.RLock()
        self._names: tuple = ()
        self._widths: dict = {}
        self._buffers: Optional[dict] = None   # name -> device [cap+1,...]
        self._cap = 0
        # key -> (slot row, content fingerprint); LRU order for eviction
        self._slots: OrderedDict = OrderedDict()
        self._free: list[int] = []
        # (perm-bytes fp, device perm): the gather permutation is the warm
        # cycle's only other row-axis upload, and it is ~stable
        self._perm_cache: Optional[tuple] = None
        self.last: dict = {}
        # the match mirror's metric families, pool-labelled by mirror name
        # (the registry is idempotent on names)
        self._resident_gauge = global_registry.gauge(
            "device_state.resident_bytes")
        self._delta_counter = global_registry.counter(
            "device_state.delta_rows")
        self._update_counter = global_registry.counter(
            "device_state.updates")
        self._rebuild_counter = global_registry.counter(
            "device_state.rebuilds")
        self._update_hist = global_registry.histogram(
            "device_state.update_seconds")
        # whole-array cache (spare/host_ok), keyed by array name
        self._arrays = _ArrayCache(self.device, global_registry.counter(
            "device_state.array_reuse"))
        _ROW_REGISTRY.add(self)

    # ------------------------------------------------------------- build

    @staticmethod
    def _row_fp(columns: dict, names: tuple, i: int) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        for name in names:
            h.update(columns[name][i].tobytes())
        return h.digest()

    def build(self, keys, columns: dict, out_len: int,
              flight=NULL_CYCLE) -> tuple[dict, dict]:
        """Serve this cycle's tensors from the mirror plus the delta.

        `keys`: one hashable identity per row (task id), in this cycle's
        row order.  `columns`: {name: host [K, ...] array}, all sharing
        the row axis.  `out_len`: padded output row count — rows beyond
        len(keys) gather the all-zero pad row.

        Returns ({name: FRESH device [out_len, ...] tensor}, stats) with
        the match-mirror stats schema (rebuild/reason/delta_rows/...).
        """
        t0 = time.perf_counter()
        k = len(keys)
        names = tuple(sorted(columns))
        cols = {name: np.ascontiguousarray(columns[name])
                for name in names}
        widths = {name: (cols[name].shape[1:], str(cols[name].dtype))
                  for name in names}
        pad_k = bucket_size(max(k, 1))
        fps = [self._row_fp(cols, names, i) for i in range(k)]
        with self._lock:
            rebuild = None
            if self._buffers is None:
                rebuild = "cold"
            elif self._names != names or self._widths != widths:
                rebuild = "width-changed"
            elif self._cap < pad_k:
                rebuild = "bucket-growth"
            if rebuild is None:
                stats = self._delta_locked(keys, fps, cols, names)
                if stats is None:
                    rebuild = "bucket-growth"
            if rebuild is not None:
                stats = self._rebuild_locked(keys, fps, cols, names,
                                             widths, pad_k)
                stats["reason"] = rebuild
                self._rebuild_counter.inc(1, {"pool": self.name,
                                              "reason": rebuild})
            else:
                self._update_counter.inc(1, {"pool": self.name})
                if stats["delta_rows"]:
                    self._delta_counter.inc(stats["delta_rows"],
                                            {"pool": self.name})
            perm = np.full(out_len, self._cap, dtype=np.int32)
            perm[:k] = stats.pop("_rows")
            resident_bytes = sum(int(b.nbytes)
                                 for b in self._buffers.values())

            perm_fp = hashlib.blake2b(perm.tobytes(),
                                      digest_size=16).digest()
            cached = self._perm_cache
            if cached is not None and cached[0] == perm_fp:
                perm_dev = cached[1]
                mark_use(perm_dev)
            else:
                perm_dev = data_plane.h2d(perm, family=self.family,
                                          device=self.device)
                self._perm_cache = (perm_fp, perm_dev)
            out = {
                name: gather_rows(self._buffers[name], perm_dev,
                                  observatory=self.observatory,
                                  op=f"{self.name}_gather")
                for name in names
            }
        update_s = time.perf_counter() - t0
        stats.update(resident_bytes=resident_bytes, update_s=update_s,
                     quantized=False, jobs=k,
                     resident_rows=k - stats["delta_rows"])
        self._resident_gauge.set(resident_bytes, {"pool": self.name})
        self._update_hist.observe(update_s)
        with self._lock:
            self.last = dict(stats)
        flight.note_device_state(stats)
        return out, stats

    def _rebuild_locked(self, keys, fps, cols, names, widths,
                        pad_k: int) -> dict:
        k = len(keys)
        cap = max(pad_k, 1)
        self._names = names
        self._widths = widths
        self._cap = cap
        self._slots = OrderedDict()
        # cap + 1 rows, all-zero pad row at index cap (see class doc)
        self._buffers = {
            name: data_plane.h2d(pad_to(cols[name], cap + 1),
                                 family=self.family, device=self.device)
            for name in names
        }
        rows = list(range(k))
        for i, key in enumerate(keys):
            self._slots[key] = (i, fps[i])
        self._free = list(range(k, cap))
        return {"rebuild": True, "delta_rows": k, "_rows": rows}

    def _delta_locked(self, keys, fps, cols, names) -> Optional[dict]:
        rows = [0] * len(keys)
        delta_i: list[int] = []
        delta_rows: list[int] = []
        allocate = _slot_allocator(self._slots, self._free, set(keys))

        for i, key in enumerate(keys):
            slot = self._slots.get(key)
            if slot is not None and slot[1] == fps[i]:
                # content hit: the resident row is byte-identical
                rows[i] = slot[0]
                self._slots.move_to_end(key)
                continue
            if slot is not None:
                row = slot[0]
            else:
                row = allocate()
                if row is None:
                    return None
            rows[i] = row
            self._slots[key] = (row, fps[i])
            self._slots.move_to_end(key)
            delta_i.append(i)
            delta_rows.append(row)

        if delta_i:
            idx = np.asarray(delta_rows, dtype=np.int32)
            for name in names:
                self._buffers[name] = scatter_rows(
                    self._buffers[name], idx, cols[name][delta_i],
                    family=self.family, observatory=self.observatory,
                    op=f"{self.name}_update")
        return {"rebuild": False, "reason": "",
                "delta_rows": len(delta_i), "_rows": rows}

    # ----------------------------------------------------- whole arrays

    def whole_array(self, name: str, host_array: np.ndarray) -> torch.Tensor:
        """Content-fingerprinted whole-array residency for the tensors
        with no row identity (the rebalancer's spare/host_ok):
        byte-identical content re-uploads nothing.  Returned tensors are
        shared across cycles — kernel INPUT only, never write them in
        place."""
        return self._arrays.get(name, host_array, self.family)

    def invalidate(self) -> None:
        """Drop the mirror (tests, resync): next build rebuilds cold."""
        with self._lock:
            self._buffers = None
            self._slots = OrderedDict()
            self._free = []
            self._perm_cache = None
            self._arrays.clear()

    # -------------------------------------------------------------- debug

    def debug_json(self) -> dict:
        with self._lock:
            resident_bytes = (sum(int(b.nbytes)
                                  for b in self._buffers.values())
                              if self._buffers else 0)
            return {
                "name": self.name,
                "family": self.family,
                "resident_bytes": resident_bytes,
                "cap": self._cap,
                "columns": {name: {"shape": list(shape),
                                   "dtype": dtype}
                            for name, (shape, dtype)
                            in self._widths.items()},
                "slots": len(self._slots),
                "arrays": self._arrays.nbytes(),
                "last": dict(self.last),
            }
