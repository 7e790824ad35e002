"""Device data-plane observatory: transfer accounting, residency ledger
and padding-waste attribution.

A copy of `cook_tpu/obs/data_plane.py` without its JAX parts: `h2d` is a
torch host-to-device put here (`torch.as_tensor` onto the caller's
device), and the reference's `device_put`, `tree_nbytes` and XLA roofline
probe (`cost_analysis`, `probe_roofline`) have no counterpart: the port's
kernels carry bounds computed from their code instead (`chip_smoke.py`).
Three instruments share one ledger:

  * **TransferLedger** — every host<->device crossing the scheduler owns
    (`ops/common.fetch_result` callers, the tensor builds' `h2d`)
    reports LOGICAL bytes per tensor family (node-encode /
    job-feasibility / dru-columns / hier-coarse / hier-fine / solve /
    fallback).  Logical bytes — the nbytes of the host array being put
    or fetched — are backend-stable: a CPU run and a card run move the
    same bytes.  Sampling fetches (the quality monitor's shadow solves)
    bucket under `fallback` and detach from the cycle's scope.

  * **residency ledger** — joins the encode-cache delta stats
    (scheduler/encode_cache.py) to report `rebuild_fraction`: the
    fraction of this cycle's per-job encode-row bytes that were freshly
    (re)computed.  A cold pool reports ~1.0; an unchanged pool served
    entirely from the host cache reports ~0.0 — yet its tensors were
    STILL re-transferred, and `(1 - rebuild_fraction)` of the encode
    traffic is what a device-resident encode cache would remove.

  * **padding-waste accounting** — valid-cell fraction per padded
    bucket per op (`bucket_size` rounds everything to power-of-two
    buckets; the dead lanes still cross the bus and cost device work).

Attribution is ambient: the match path activates a per-(pool, cycle)
`CycleDataPlane` scope on the driving thread, and instrumented sites
credit the innermost active scope plus the process-global ledger.  Sites
with no active scope still land in the ledger totals.
"""
from __future__ import annotations

import collections
import threading
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from cook_tpu_torch.utils.metrics import global_registry

# ------------------------------------------------------- tensor families
# Bounded label set: one family per logical tensor kind the scheduler
# moves, NOT per pool/shape (those live on the cycle records).

FAM_NODE_ENCODE = "node-encode"      # demands/avail/totals/valid tensors
FAM_FEASIBILITY = "job-feasibility"  # the [J, N] constraint mask
FAM_DRU = "dru-columns"              # DRU rank task columns + divisors
FAM_HIER_COARSE = "hier-coarse"      # hierarchical coarse pass traffic
FAM_HIER_FINE = "hier-fine"          # hierarchical fine batch traffic
FAM_MESH = "mesh-shard"              # parallel/mesh.py device_put sites
FAM_SOLVE = "solve-results"          # assignment fetches (D2H)
FAM_FALLBACK = "fallback"            # CPU-fallback / quality-audit puts
FAM_REBALANCE = "rebalance-state"    # rebalancer victim/spare tensors
FAM_ELASTIC = "elastic-plan"         # elastic demand/capacity tensors
FAM_OTHER = "other"                  # unattributed crossings

FAMILIES = (FAM_NODE_ENCODE, FAM_FEASIBILITY, FAM_DRU, FAM_HIER_COARSE,
            FAM_HIER_FINE, FAM_MESH, FAM_SOLVE, FAM_FALLBACK,
            FAM_REBALANCE, FAM_ELASTIC, FAM_OTHER)

# unpadded per-node byte width of the node encode tensors (avail [4]f32 +
# totals [2]f32 + node_valid bool) — the residency ledger's weight for
# the fingerprint-governed node encoding
NODE_ROW_BYTES = 4 * 4 + 2 * 4 + 1

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "scopes", None)
    if stack is None:
        stack = _tls.scopes = []
    return stack


def _families() -> list:
    fams = getattr(_tls, "families", None)
    if fams is None:
        fams = _tls.families = []
    return fams


# sentinel pushed by detached(): masks any enclosing cycle scope so
# audit/sampling transfers never land on the driving cycle's record
_DETACHED = object()


def active_scope() -> Optional["CycleDataPlane"]:
    stack = _stack()
    if not stack:
        return None
    top = stack[-1]
    return None if top is _DETACHED else top


def current_family() -> Optional[str]:
    fams = _families()
    return fams[-1] if fams else None


@contextmanager
def activate(scope: Optional["CycleDataPlane"]):
    """Make `scope` the innermost attribution target on this thread.
    Re-entrant (the serial cycle wraps the whole pass, the matcher wraps
    its sections again) and None-tolerant (NullCycle carries no scope)."""
    if scope is None:
        yield None
        return
    stack = _stack()
    stack.append(scope)
    try:
        yield scope
    finally:
        stack.pop()


@contextmanager
def detached():
    """Mask the enclosing cycle scope: audit/shadow sections run inside
    an activated cycle (e.g. the quality monitor's shadow solve on a
    speculation commit) but their transfers are sampling overhead, not
    the cycle's data plane — they go to the ledger only."""
    stack = _stack()
    stack.append(_DETACHED)
    try:
        yield
    finally:
        stack.pop()


@contextmanager
def family(name: str):
    """Ambient family for crossings whose call site can't know the
    tensor kind (fetch_result, the mesh device_puts): the innermost
    family() context labels them."""
    fams = _families()
    fams.append(name)
    try:
        yield
    finally:
        fams.pop()


class CycleDataPlane:
    """Per-(pool, cycle) data-plane accumulator.  Written only by the
    cycle's driving thread (the same single-writer contract as
    CycleBuilder); read after the cycle commits."""

    __slots__ = ("pool", "cycle_id", "h2d", "d2h",
                 "rows_fresh_bytes", "rows_cached_bytes",
                 "nodes_fresh_bytes", "nodes_cached_bytes", "padding")

    def __init__(self, pool: str = "", cycle_id: int = 0):
        self.pool = pool
        self.cycle_id = cycle_id
        # family -> [bytes, calls]
        self.h2d: dict[str, list] = {}
        self.d2h: dict[str, list] = {}
        # residency: per-job encode-row bytes governed by the encode
        # cache (fresh = recomputed this cycle, cached = unchanged rows
        # that were still re-transferred), plus the node-encoding split
        self.rows_fresh_bytes = 0
        self.rows_cached_bytes = 0
        self.nodes_fresh_bytes = 0
        self.nodes_cached_bytes = 0
        # op -> [valid_cells, padded_cells]
        self.padding: dict[str, list] = {}

    # ------------------------------------------------------------ writes

    def note_h2d(self, nbytes: int, fam: str) -> None:
        slot = self.h2d.setdefault(fam, [0, 0])
        slot[0] += int(nbytes)
        slot[1] += 1

    def note_d2h(self, nbytes: int, fam: str) -> None:
        slot = self.d2h.setdefault(fam, [0, 0])
        slot[0] += int(nbytes)
        slot[1] += 1

    def note_residency(self, fresh_bytes: int, cached_bytes: int,
                       kind: str = "rows") -> None:
        if kind == "nodes":
            self.nodes_fresh_bytes += int(fresh_bytes)
            self.nodes_cached_bytes += int(cached_bytes)
        else:
            self.rows_fresh_bytes += int(fresh_bytes)
            self.rows_cached_bytes += int(cached_bytes)

    def note_padding(self, op: str, valid_cells: int,
                     padded_cells: int) -> None:
        slot = self.padding.setdefault(op, [0, 0])
        slot[0] += int(valid_cells)
        slot[1] += int(padded_cells)

    # ------------------------------------------------------------- reads

    @property
    def h2d_bytes(self) -> int:
        return sum(slot[0] for slot in self.h2d.values())

    @property
    def d2h_bytes(self) -> int:
        return sum(slot[0] for slot in self.d2h.values())

    @property
    def rebuild_fraction(self) -> Optional[float]:
        """Fraction of this cycle's encode-ROW bytes freshly recomputed
        (1 - this) × the encode H2D traffic is the device-residency
        waste.  None when the cycle encoded nothing."""
        total = self.rows_fresh_bytes + self.rows_cached_bytes
        if total <= 0:
            return None
        return self.rows_fresh_bytes / total

    @property
    def padding_waste(self) -> Optional[float]:
        """1 - valid/padded cells across every padded bucket the cycle
        built; None when nothing padded was built."""
        valid = sum(slot[0] for slot in self.padding.values())
        padded = sum(slot[1] for slot in self.padding.values())
        if padded <= 0:
            return None
        return 1.0 - valid / padded

    def families_json(self) -> dict:
        return {
            fam: {"h2d_bytes": self.h2d.get(fam, [0, 0])[0],
                  "h2d_calls": self.h2d.get(fam, [0, 0])[1],
                  "d2h_bytes": self.d2h.get(fam, [0, 0])[0],
                  "d2h_calls": self.d2h.get(fam, [0, 0])[1]}
            for fam in sorted(set(self.h2d) | set(self.d2h))
        }

    def to_json(self) -> dict:
        return {
            "pool": self.pool,
            "cycle": self.cycle_id,
            "h2d_bytes": self.h2d_bytes,
            "d2h_bytes": self.d2h_bytes,
            "rebuild_fraction": self.rebuild_fraction,
            "padding_waste": self.padding_waste,
            "residency": {
                "rows_fresh_bytes": self.rows_fresh_bytes,
                "rows_cached_bytes": self.rows_cached_bytes,
                "nodes_fresh_bytes": self.nodes_fresh_bytes,
                "nodes_cached_bytes": self.nodes_cached_bytes,
            },
            "families": self.families_json(),
            "padding": {op: {"valid_cells": slot[0],
                             "padded_cells": slot[1],
                             "waste": (1.0 - slot[0] / slot[1]
                                       if slot[1] else 0.0)}
                        for op, slot in sorted(self.padding.items())},
        }


class TransferLedger:
    """Process-lifetime transfer accounting + a bounded ring of finished
    cycle scopes — the `GET /debug/device` substrate."""

    def __init__(self, cycle_ring: int = 256):
        self._lock = threading.Lock()
        # family -> [h2d_bytes, h2d_calls, d2h_bytes, d2h_calls]
        self._families: dict[str, list] = {}
        # (op) -> {shape_sig: [valid_cells, padded_cells]}
        self._padding: dict[str, dict[str, list]] = {}
        # pool -> last finished cycle's residency summary
        self._residency: dict[str, dict] = {}
        self._cycles: collections.deque[dict] = collections.deque(
            maxlen=cycle_ring)
        self._h2d_bytes = global_registry.counter(
            "data_plane.h2d_bytes",
            "host->device bytes transferred, per tensor family")
        self._h2d_calls = global_registry.counter(
            "data_plane.h2d_calls",
            "host->device transfer calls, per tensor family")
        self._d2h_bytes = global_registry.counter(
            "data_plane.d2h_bytes",
            "device->host bytes fetched, per tensor family")
        self._d2h_calls = global_registry.counter(
            "data_plane.d2h_calls",
            "device->host fetch calls, per tensor family")
        self._rebuild_gauge = global_registry.gauge(
            "data_plane.rebuild_fraction",
            "fraction of the last cycle's encode-row bytes freshly "
            "recomputed (1 - this = re-transferred unchanged)")
        self._padding_gauge = global_registry.gauge(
            "data_plane.padding_waste",
            "1 - valid/padded cell fraction of the last padded problem "
            "built, per op")

    # ------------------------------------------------------------ writes

    def note_h2d(self, nbytes: int, fam: str, scope=None) -> None:
        nbytes = int(nbytes)
        with self._lock:
            slot = self._families.setdefault(fam, [0, 0, 0, 0])
            slot[0] += nbytes
            slot[1] += 1
        self._h2d_bytes.inc(nbytes, {"family": fam})
        self._h2d_calls.inc(1, {"family": fam})
        if scope is not None:
            scope.note_h2d(nbytes, fam)

    def note_d2h(self, nbytes: int, fam: str, scope=None) -> None:
        nbytes = int(nbytes)
        with self._lock:
            slot = self._families.setdefault(fam, [0, 0, 0, 0])
            slot[2] += nbytes
            slot[3] += 1
        self._d2h_bytes.inc(nbytes, {"family": fam})
        self._d2h_calls.inc(1, {"family": fam})
        if scope is not None:
            scope.note_d2h(nbytes, fam)

    def note_padding(self, op: str, shape_sig: str, valid_cells: int,
                     padded_cells: int, scope=None) -> None:
        with self._lock:
            buckets = self._padding.setdefault(op, {})
            slot = buckets.setdefault(shape_sig, [0, 0])
            slot[0] += int(valid_cells)
            slot[1] += int(padded_cells)
        if padded_cells > 0:
            self._padding_gauge.set(1.0 - valid_cells / padded_cells,
                                    {"op": op})
        if scope is not None:
            scope.note_padding(op, valid_cells, padded_cells)

    def finish_cycle(self, scope: CycleDataPlane) -> None:
        """Fold a finished cycle scope into the ring + the per-pool
        residency surface (empty scopes — idle pools — are skipped so
        the ring holds signal, not heartbeats)."""
        fraction = scope.rebuild_fraction
        if fraction is not None:
            self._rebuild_gauge.set(fraction, {"pool": scope.pool})
        if (scope.h2d_bytes == 0 and scope.d2h_bytes == 0
                and fraction is None):
            return
        summary = scope.to_json()
        with self._lock:
            self._cycles.append(summary)
            if fraction is not None:
                self._residency[scope.pool] = summary["residency"] | {
                    "rebuild_fraction": fraction,
                    "cycle": scope.cycle_id,
                }

    # ------------------------------------------------------------- reads

    def family_totals(self) -> dict[str, dict]:
        with self._lock:
            return {
                fam: {"h2d_bytes": slot[0], "h2d_calls": slot[1],
                      "d2h_bytes": slot[2], "d2h_calls": slot[3]}
                for fam, slot in sorted(self._families.items())
            }

    def snapshot(self, cycles: int = 32) -> dict:
        """The `/debug/device` body (roofline rows are joined in by the
        handler from the CompileObservatory)."""
        families = self.family_totals()
        with self._lock:
            # NOT `[-cycles:]`: list[-0:] is the WHOLE list, and 0 must
            # mean "no cycle section", not the maximal payload
            recent = list(self._cycles)[-cycles:] if cycles > 0 else []
            residency = {pool: dict(r)
                         for pool, r in sorted(self._residency.items())}
            padding = {
                op: {sig: {"valid_cells": slot[0],
                           "padded_cells": slot[1],
                           "waste": (1.0 - slot[0] / slot[1]
                                     if slot[1] else 0.0)}
                     for sig, slot in sorted(buckets.items())}
                for op, buckets in sorted(self._padding.items())
            }
        return {
            "transfers": {
                "families": families,
                "h2d_bytes": sum(f["h2d_bytes"] for f in families.values()),
                "d2h_bytes": sum(f["d2h_bytes"] for f in families.values()),
            },
            "residency": residency,
            "padding": padding,
            "cycles": recent,
        }


# the process singleton every instrumented site reports to (the same
# pattern as utils/metrics.global_registry)
LEDGER = TransferLedger()


# ----------------------------------------------------- module-level notes
# Instrumented sites call these; attribution = explicit family, else the
# innermost family() context, else "other"; the innermost active cycle
# scope (if any) is credited alongside the ledger.

def note_h2d(nbytes: int, family: Optional[str] = None) -> None:
    if nbytes <= 0:
        return
    fam = family or current_family() or FAM_OTHER
    LEDGER.note_h2d(nbytes, fam, scope=active_scope())


def note_d2h(nbytes: int, family: Optional[str] = None) -> None:
    if nbytes <= 0:
        return
    fam = family or current_family() or FAM_OTHER
    LEDGER.note_d2h(nbytes, fam, scope=active_scope())


def note_residency(fresh_bytes: int, cached_bytes: int,
                   kind: str = "rows") -> None:
    scope = active_scope()
    if scope is not None:
        scope.note_residency(fresh_bytes, cached_bytes, kind=kind)


def note_padding(op: str, shape, valid_cells: int,
                 padded_cells: int) -> None:
    from cook_tpu_torch.obs.compile_observatory import shape_signature

    sig = shape if isinstance(shape, str) else shape_signature(shape)
    LEDGER.note_padding(op, sig, valid_cells, padded_cells,
                        scope=active_scope())


def h2d(array, family: Optional[str] = None, *, device):
    """`torch.as_tensor` onto `device` + ledger accounting — THE
    instrumented host->device put for tensor builds.  `array` is a numpy
    array or a CPU tensor (the quantized bfloat16 cost tensors, which
    numpy cannot hold).  Logical bytes: the host array's nbytes, whatever
    device it lands on (a CPU run counts what a card run would move).

    On a CUDA side stream (a pipelined stage's, scheduler/pipeline.py)
    the array is staged through pinned memory and copied with
    `non_blocking=True`, queued on that stream: a pageable copy would
    block the host until the copy is done, and on the default stream
    wait for every kernel already queued, so the next pool's encode
    would wait for this pool's solve.  (The caching host allocator keeps
    the pinned block until the copy has run.)"""
    host = (array if isinstance(array, torch.Tensor)
            else torch.as_tensor(np.asarray(array)))
    device = torch.device(device)
    if device.type == "cuda" and (torch.cuda.current_stream(device)
                                  != torch.cuda.default_stream(device)):
        out = host.pin_memory().to(device, non_blocking=True)
    else:
        out = host.to(device)
    note_h2d(int(host.nbytes), family=family)
    return out
