"""The ComputeCluster boundary: the pluggable backend interface.

Port of `cook_tpu/cluster/base.py` without its fault-injection points
(a later slice) and the elastic scaling the capacity plane uses.  The
async launch fan-out of the pipelined match pass is here: one launch
worker per cluster (`launch_tasks_async`, bounded by
`launch_queue_bound`) and `wait_all_launches`.

Mirrors the reference's `ComputeCluster` protocol
(Cook's compute_cluster.clj:27-112): offers in,
launches/kills out, autoscaling, draining, and the launch/kill read-write
lock that closes the kill-before-launch race the reference documents at
compute_cluster.clj:86-112 (a kill observed while a launch is mid-flight
must not be lost: kills take the write side, launches the read side).
"""
from __future__ import annotations

import abc
import enum
import logging
import threading
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

from cook_tpu_torch.faults.breaker import BreakerParams, CircuitBreaker

log = logging.getLogger(__name__)


@dataclass(frozen=True)
class Offer:
    """Available resources on one node.  K8s-style backends synthesize these
    from capacity minus consumption (kubernetes/compute_cluster.clj:68-190);
    mock/Mesos-style backends hand them out directly."""

    node_id: str
    hostname: str
    mem: float
    cpus: float
    gpus: float = 0.0
    disk: float = 0.0
    attributes: tuple = ()       # ((key, value), ...) host attributes
    total_mem: float = 0.0       # capacity, for binpacking fitness
    total_cpus: float = 0.0
    # free port ranges ((begin, end), ...) inclusive — Mesos-style offers
    # carry port resources (mesos_mock.clj:162 range arithmetic)
    ports: tuple = ()

    def port_count(self) -> int:
        return sum(e - b + 1 for b, e in self.ports)


def subtract_ports(ranges: tuple, taken) -> tuple:
    """Free (begin, end) ranges minus taken ports — interval arithmetic,
    O(ranges + taken log taken), never iterating individual ports
    (the range subtraction of mesos_mock.clj:184)."""
    if not taken:
        return tuple(ranges)
    import bisect

    taken_sorted = sorted(set(taken))
    out = []
    for begin, end in ranges:
        cur = begin
        i = bisect.bisect_left(taken_sorted, begin)
        while i < len(taken_sorted) and taken_sorted[i] <= end:
            p = taken_sorted[i]
            if p > cur:
                out.append((cur, p - 1))
            cur = p + 1
            i += 1
        if cur <= end:
            out.append((cur, end))
    return tuple(out)

    def attr_dict(self) -> dict:
        return dict(self.attributes)


@dataclass(frozen=True)
class TaskSpec:
    """What a backend needs to launch one task."""

    task_id: str
    job_uuid: str
    user: str
    command: str
    mem: float
    cpus: float
    gpus: float
    node_id: str
    hostname: str
    disk: float = 0.0
    env: tuple = ()
    container_image: str = ""
    expected_runtime_ms: int = 0
    # concrete ports assigned from the offer's ranges (mesos/task.clj
    # port assignment; surfaced to the task as PORT0..PORTn env vars)
    ports: tuple = ()
    # job checkpointing (schema.clj:84 :job/checkpoint): backends wire
    # mode/period into the task sandbox (k8s: tools volume + init
    # container + env, api.clj:934,1173-1198)
    checkpoint_mode: str = ""            # "" = checkpointing off
    checkpoint_periodic_sec: int = 0
    checkpoint_preserve_paths: tuple = ()


class ClusterState(enum.Enum):
    """Dynamic cluster config state machine
    (compute_cluster.clj:340-359,450-530): running accepts new work,
    draining only finishes existing work, deleted is gone."""

    RUNNING = "running"
    DRAINING = "draining"
    DELETED = "deleted"

    def valid_next(self) -> set["ClusterState"]:
        return {
            ClusterState.RUNNING: {ClusterState.RUNNING, ClusterState.DRAINING},
            ClusterState.DRAINING: {ClusterState.DRAINING, ClusterState.RUNNING,
                                    ClusterState.DELETED},
            ClusterState.DELETED: {ClusterState.DELETED},
        }[self]


class KillLock:
    """Read-write lock guarding launch (read side, many concurrent) against
    kill (write side, exclusive) — `kill-lock-object`
    (compute_cluster.clj:86-112)."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False

    class _Read:
        def __init__(self, lock):
            self.lock = lock

        def __enter__(self):
            with self.lock._cond:
                while self.lock._writer:
                    self.lock._cond.wait()
                self.lock._readers += 1

        def __exit__(self, *exc):
            with self.lock._cond:
                self.lock._readers -= 1
                self.lock._cond.notify_all()

    class _Write:
        def __init__(self, lock):
            self.lock = lock

        def __enter__(self):
            with self.lock._cond:
                while self.lock._writer or self.lock._readers:
                    self.lock._cond.wait()
                self.lock._writer = True

        def __exit__(self, *exc):
            with self.lock._cond:
                self.lock._writer = False
                self.lock._cond.notify_all()

    def read(self):
        return self._Read(self)

    def write(self):
        return self._Write(self)


def wait_all_launches(clusters, timeout: Optional[float] = None) -> list:
    """Block until every cluster's in-flight async launch batches have
    completed; returns the clusters still busy at the timeout.  THE one
    drain idiom — Scheduler.drain_launches and the pipelined pass's
    end-of-cycle drain both go through here."""
    stuck = []
    for cluster in clusters:
        wait = getattr(cluster, "wait_launches", None)
        if wait is not None and not wait(timeout=timeout):
            stuck.append(cluster)
    return stuck


def safe_pool_offers(cluster, pool: str) -> Optional[list]:
    """One cluster's offers for one pool, fault-injectable: an offer RPC
    raising returns None (the cluster is skipped this scan) instead of
    taking the whole rank/match cycle down — one flapping backend must
    not starve every pool.  Offer outcomes deliberately do NOT feed the
    circuit breaker: its window watches launch/kill RPC outcomes only
    (BreakerParams), and scans report no successes, so rare scan blips
    would accumulate one-sidedly until they opened the breaker on a
    healthy cluster."""
    try:
        return cluster.pending_offers(pool)
    except Exception:  # noqa: BLE001 — backend RPC boundary
        log.exception("pending_offers failed (cluster %s, pool %s); "
                      "skipping this scan", cluster.name, pool)
        return None


def scan_pool_offers(clusters, pool: str):
    """Yield every offer the pool's work-accepting clusters currently
    make.  THE one spare/capacity offer scan — the scheduler's spare
    cache, the cycle-start capacity snapshot, and the elastic planner's
    supply tensors all consume this, so offer-semantics changes (clamps,
    synthesized fields) happen in exactly one traversal.  Note each call
    re-queries the backends; per-cycle callers should scan once and
    share the result."""
    for cluster in clusters:
        if not cluster.accepts_work:
            continue
        offers = safe_pool_offers(cluster, pool)
        if offers is None:
            continue
        for offer in offers:
            yield cluster, offer


class ComputeCluster(abc.ABC):
    """Backend interface.  Implementations: `cluster.mock.MockCluster` (the
    simulator backbone, reference mesos_mock.clj) and `cluster.k8s`
    (synthesized offers + expected-vs-actual controller)."""

    name: str
    state: ClusterState

    def __init__(self, name: str, location: str = ""):
        self.name = name
        # physical location (e.g. region/zone); checkpoint-locality steers
        # restarted jobs to clusters co-located with their checkpoint
        # (reference: constraints.clj:218, job->acceptable-compute-clusters)
        self.location = location
        self.state = ClusterState.RUNNING
        self.kill_lock = KillLock()
        # per-cluster launch token bucket (launch-rate-limiter,
        # rate_limit.clj:44 + compute_cluster.clj); None = unlimited.
        # The matcher caps each cycle's launches on this cluster at the
        # bucket's balance and spends through it.
        self.launch_rate_limiter = None
        # async launch fan-out (scheduler/pipeline.py): one worker thread
        # per cluster serializes this backend's launch RPCs off the match
        # cycle's critical path; the semaphore bounds queued batches so a
        # stalled backend applies backpressure instead of growing an
        # unbounded queue.  Lazily created on first launch_tasks_async.
        # The worker touches only the backend and, through its callbacks,
        # the store: never the card
        self.launch_queue_bound = 8
        self._launch_executor = None
        self._launch_pending: set = set()
        self._launch_sema: Optional[threading.BoundedSemaphore] = None
        self._launch_lock = threading.Lock()
        # circuit breaker over this backend's launch/kill RPC outcomes
        # (faults/breaker.py): open = accepts_work False, so a
        # failing backend stops receiving offers/launches until a
        # half-open probe succeeds.  Replaceable (tests/chaos tune
        # params); kills are never gated, only counted.
        self.breaker = CircuitBreaker(name)

    def configure_breaker(self, params: BreakerParams,
                          clock=None) -> CircuitBreaker:
        """Swap in a breaker with custom thresholds (chaos/test knob)."""
        import time as _time

        self.breaker = CircuitBreaker(self.name, params,
                                      clock=clock or _time.monotonic)
        return self.breaker

    def run_launch(self, pool: str, specs: Sequence[TaskSpec]) -> None:
        """THE backend launch entry: breaker accounting around
        `launch_tasks`.  Callers hold the kill-lock's read side."""
        try:
            self.launch_tasks(pool, specs)
        except Exception:
            self.breaker.note_failure(probe=True)
            raise
        self.breaker.note_success(probe=True)

    # --- offers ---
    @abc.abstractmethod
    def pending_offers(self, pool: str) -> list[Offer]:
        ...

    def restore_offers(self, pool: str, offers: Sequence[Offer]) -> None:
        """Return unmatched offers (Mesos semantics; no-op for synthesized)."""

    # --- task lifecycle ---
    @abc.abstractmethod
    def launch_tasks(self, pool: str, specs: Sequence[TaskSpec]) -> None:
        ...

    @abc.abstractmethod
    def kill_task(self, task_id: str) -> None:
        ...

    def safe_kill_task(self, task_id: str) -> None:
        """Kill that tolerates backend errors (reference safe-kill-task).
        Never gated by the circuit breaker — a sick cluster must still
        honor kills — but outcomes feed its error window."""
        try:
            with self.kill_lock.write():
                self.kill_task(task_id)
        except Exception:  # noqa: BLE001 — kill must never propagate
            self.breaker.note_failure()
            return
        self.breaker.note_success()

    # --- async launch fan-out (scheduler/pipeline.py) ---

    def launch_tasks_async(self, pool: str, specs: Sequence[TaskSpec], *,
                           done_cb: Optional[Callable] = None):
        """Launch `specs` on this cluster's single worker thread and
        return a Future.

        The worker holds the kill-lock's READ side around the backend
        call, so a concurrent kill (write side) still excludes mid-launch
        exactly as the synchronous path does.  `done_cb(specs, exc)` runs
        on the worker AFTER the kill-lock is released (exc is None on
        success) — callers use it to flow launch failures back into the
        store's state machine; an RPC error must never be swallowed by
        the async boundary.  Backpressure: at most `launch_queue_bound`
        batches may be queued; beyond that this call blocks."""
        import concurrent.futures

        with self._launch_lock:
            if self._launch_executor is None:
                self._launch_executor = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix=f"launch-{self.name}")
                self._launch_sema = threading.BoundedSemaphore(
                    self.launch_queue_bound)
        self._launch_sema.acquire()
        specs = list(specs)

        def work():
            exc = None
            try:
                with self.kill_lock.read():
                    self.run_launch(pool, specs)
            except Exception as e:  # noqa: BLE001 — flows to done_cb
                exc = e
            finally:
                self._launch_sema.release()
            if done_cb is not None:
                try:
                    done_cb(specs, exc)
                except Exception:  # noqa: BLE001 — observability only
                    log.exception("launch done_cb failed (cluster %s)",
                                  self.name)
            elif exc is not None:
                log.error("async launch_tasks failed (cluster %s, "
                          "%d specs)", self.name, len(specs),
                          exc_info=exc)

        future = self._launch_executor.submit(work)
        with self._launch_lock:
            self._launch_pending.add(future)
        future.add_done_callback(self._launch_done)
        return future

    def _launch_done(self, future) -> None:
        with self._launch_lock:
            self._launch_pending.discard(future)

    def pending_launches(self) -> int:
        """Launch batches dispatched but not yet completed."""
        with self._launch_lock:
            return len(self._launch_pending)

    def wait_launches(self, timeout: Optional[float] = None) -> bool:
        """Block until every in-flight async launch batch has completed
        (tests, clean shutdown, and the pipelined cycle's default drain).
        Returns False on timeout."""
        import concurrent.futures

        with self._launch_lock:
            pending = list(self._launch_pending)
        if not pending:
            return True
        _, not_done = concurrent.futures.wait(pending, timeout=timeout)
        return not not_done

    # --- autoscaling ---
    def autoscaling(self, pool: str) -> bool:
        return False

    def autoscale(self, pool: str, pending_demand: Sequence[TaskSpec]) -> None:
        """Request capacity for unmatched demand (reference: synthetic pods,
        kubernetes/compute_cluster.clj:606)."""

    # --- capacity limits ---
    def max_launchable(self) -> int:
        return 2**31

    def max_tasks_per_host(self) -> int:
        return 2**31

    def num_tasks_on_host(self, hostname: str) -> int:
        return 0

    # --- state/queries ---
    def set_state(self, new_state: ClusterState) -> None:
        if new_state not in self.state.valid_next():
            raise ValueError(f"invalid cluster transition {self.state} -> {new_state}")
        self.state = new_state

    @property
    def accepts_work(self) -> bool:
        """RUNNING and circuit-closed (or half-open — offers flowing
        again IS the probe).  An open breaker withholds this cluster
        from every offer scan and launch path until its cooldown."""
        return self.state == ClusterState.RUNNING \
            and self.breaker.allows_work()

    def retrieve_sandbox_url_path(self, task_id: str) -> str:
        return ""
