"""In-memory mock compute cluster: the simulator backbone.

Port of `cook_tpu/cluster/mock.py`, elastic scaling included: `scale`
materializes a pool's borrowed capacity as one `elastic@{pool}` host and
withholds a lender pool's loaned-out capacity from its offers.

Plays the role of the reference's in-memory Mesos master mock
(Cook's mesos/mesos_mock.clj): hosts with fixed
capacity hand out offers of their spare resources; launched tasks consume
resources and complete (success) after their simulated runtime when virtual
time advances; kills release resources immediately.  Status transitions are
reported to a callback, exactly like a real backend's watch/callback feed.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Optional, Sequence

from cook_tpu_torch.cluster.base import (
    ComputeCluster,
    Offer,
    TaskSpec,
    subtract_ports,
)
from cook_tpu_torch.models.entities import InstanceStatus


@dataclass
class MockHost:
    node_id: str
    hostname: str
    mem: float
    cpus: float
    gpus: float = 0.0
    disk: float = 0.0
    attributes: tuple = ()
    pool: str = "default"
    # offerable port ranges ((begin, end), ...) inclusive — Mesos-style
    # port resources (mesos_mock.clj:162)
    ports: tuple = ()


@dataclass
class _RunningTask:
    spec: TaskSpec
    started_ms: int
    ends_ms: int  # virtual completion time


StatusCallback = Callable[[str, InstanceStatus, Optional[str]], None]
# (task_id, new_status, reason_name)


class MockCluster(ComputeCluster):
    """Deterministic fake backend driven by a virtual clock."""

    def __init__(self, name: str, hosts: Sequence[MockHost],
                 clock: Callable[[], int], *,
                 default_runtime_ms: int = 60_000,
                 sandbox_url_fn: Optional[Callable[[str], str]] = None):
        super().__init__(name)
        self.hosts = {h.node_id: h for h in hosts}
        self.clock = clock
        self.default_runtime_ms = default_runtime_ms
        self.running: dict[str, _RunningTask] = {}
        # async launch workers (ComputeCluster.launch_tasks_async) mutate
        # `running` off the scheduler thread; this lock keeps offer scans
        # from iterating a dict mid-mutation.  Status callbacks are always
        # emitted OUTSIDE it — the callback chain
        # re-enters the store (and from there possibly this cluster's kill
        # path), and holding the lock across it would invert lock order
        # against kill_lock/store
        self._mutate_lock = threading.RLock()
        # kills that raced a launch batch still queued (or about to be
        # queued — the kill can land between the match transaction and
        # launch_tasks_async) on the async executor: the launch must not
        # resurrect them.  Recorded unconditionally; FIFO-ordered so the
        # capacity bound evicts the OLDEST (stalest) entry
        self._killed_before_launch: "OrderedDict[str, None]" = OrderedDict()
        self.status_callback: Optional[StatusCallback] = None
        self.launched_count = 0
        self.killed_count = 0
        self.sandbox_url_fn = sandbox_url_fn
        # elastic capacity adjustments per pool (scale()): positive nets
        # materialize as a synthetic borrowed-capacity host, negative
        # nets are withheld from the pool's offers
        self.pool_adjust: dict[str, dict] = {}

    def retrieve_sandbox_url_path(self, task_id: str) -> str:
        if self.sandbox_url_fn is not None:
            return self.sandbox_url_fn(task_id)
        return ""

    # ------------------------------------------------------------- offers

    def _running_snapshot(self) -> list[_RunningTask]:
        with self._mutate_lock:
            return list(self.running.values())

    def pending_offers(self, pool: str) -> list[Offer]:
        offers = []
        with self._mutate_lock:
            hosts = list(self.hosts.values())
            running = list(self.running.values())
        # a net-lender pool's loaned-out capacity is withheld from its
        # offers (scale() with negative dims): walk the deficit down
        # across hosts in stable order so the matcher simply sees less
        # spare — running tasks are untouched (loans move FREE capacity)
        adj = self.pool_adjust.get(pool, {})
        deficit = {d: max(-float(adj.get(d, 0.0)), 0.0)
                   for d in ("mem", "cpus", "gpus")}
        # ONE pass over the running tasks builds per-node usage and taken
        # ports — per-host _host_used/_free_port_ranges calls would make
        # the offer scan O(hosts x tasks) in snapshot copies alone
        used: dict[str, list[float]] = {}
        ports_taken: dict[str, set] = {}
        for rt in running:
            u = used.setdefault(rt.spec.node_id, [0.0, 0.0, 0.0, 0.0])
            u[0] += rt.spec.mem
            u[1] += rt.spec.cpus
            u[2] += rt.spec.gpus
            u[3] += rt.spec.disk
            if rt.spec.ports:
                ports_taken.setdefault(rt.spec.node_id,
                                       set()).update(rt.spec.ports)
        for h in hosts:
            if h.pool != pool:
                continue
            um, uc, ug, ud = used.get(h.node_id, (0.0, 0.0, 0.0, 0.0))
            free = {"mem": max(h.mem - um, 0.0),
                    "cpus": max(h.cpus - uc, 0.0),
                    "gpus": max(h.gpus - ug, 0.0)}
            for dim in free:
                take = min(deficit[dim], free[dim])
                free[dim] -= take
                deficit[dim] -= take
            offers.append(
                Offer(
                    node_id=h.node_id,
                    hostname=h.hostname,
                    mem=free["mem"],
                    cpus=free["cpus"],
                    gpus=free["gpus"],
                    disk=max(h.disk - ud, 0.0),
                    attributes=h.attributes,
                    total_mem=h.mem,
                    total_cpus=h.cpus,
                    ports=(subtract_ports(
                        h.ports, ports_taken.get(h.node_id, ()))
                        if h.ports else ()),
                )
            )
        return offers

    # ------------------------------------------------------ elastic scale

    ELASTIC_NODE_PREFIX = "elastic@"

    def supports_scale(self) -> bool:
        return True

    def scale(self, pool: str, adjustment: dict) -> dict:
        """Converge the pool's elastic capacity to the declarative
        target: positive dims materialize as one synthetic
        `elastic@{pool}` host holding the borrowed capacity (launchable
        like any host); negative dims are withheld from the pool's
        offers in pending_offers.  A reclaimed-away elastic host still
        running tasks is drained (capacity zeroed, tasks finish) rather
        than yanked — reclaim is non-disruptive by design."""
        adj = {d: float(adjustment.get(d, 0.0))
               for d in ("mem", "cpus", "gpus")}
        self.pool_adjust[pool] = adj
        node_id = self.ELASTIC_NODE_PREFIX + pool
        positive = {d: max(v, 0.0) for d, v in adj.items()}
        host = self.hosts.get(node_id)
        if any(v > 0 for v in positive.values()):
            if host is None:
                self.hosts[node_id] = MockHost(
                    node_id=node_id, hostname=node_id,
                    mem=positive["mem"], cpus=positive["cpus"],
                    gpus=positive["gpus"], pool=pool,
                )
            else:
                host.mem = positive["mem"]
                host.cpus = positive["cpus"]
                host.gpus = positive["gpus"]
        elif host is not None:
            if any(rt.spec.node_id == node_id
                   for rt in self._running_snapshot()):
                host.mem = host.cpus = host.gpus = 0.0  # drain
            else:
                self.hosts.pop(node_id, None)
        return adj

    # ------------------------------------------------------ task lifecycle

    def launch_tasks(self, pool: str, specs: Sequence[TaskSpec]) -> None:
        now = self.clock()
        for spec in specs:
            with self._mutate_lock:
                if spec.task_id in self._killed_before_launch:
                    # a kill raced this batch in the async launch queue;
                    # the killer already drove the store transition — launching now would resurrect
                    # a terminal task
                    self._killed_before_launch.pop(spec.task_id, None)
                    continue
                known = spec.node_id in self.hosts
                if known:
                    runtime = (spec.expected_runtime_ms
                               or self.default_runtime_ms)
                    self.running[spec.task_id] = _RunningTask(
                        spec=spec, started_ms=now, ends_ms=now + runtime
                    )
                    self.launched_count += 1
            if known:
                self._report(spec.task_id, InstanceStatus.RUNNING, None)
            else:
                self._report(spec.task_id, InstanceStatus.FAILED,
                             "scheduling-failed-on-host")

    def kill_task(self, task_id: str) -> None:
        with self._mutate_lock:
            rt = self.running.pop(task_id, None)
            self.killed_count += 1
            if rt is None:
                if len(self._killed_before_launch) >= 10_000:
                    self._killed_before_launch.popitem(last=False)
                self._killed_before_launch[task_id] = None
        if rt is not None:
            self._report(task_id, InstanceStatus.FAILED, "killed-by-user")

    def num_tasks_on_host(self, hostname: str) -> int:
        return sum(1 for rt in self._running_snapshot()
                   if rt.spec.hostname == hostname)

    # --------------------------------------------------------- virtual time

    def advance_to(self, now_ms: int) -> list[str]:
        """Complete every task whose simulated runtime has elapsed; returns
        the completed task ids (mesos_mock.clj `complete-task!`)."""
        with self._mutate_lock:
            done = [tid for tid, rt in self.running.items()
                    if rt.ends_ms <= now_ms]
            for tid in done:
                self.running.pop(tid)
        for tid in sorted(done):  # deterministic order
            self._report(tid, InstanceStatus.SUCCESS, "normal-exit")
        return done

    def fail_task(self, task_id: str, reason: str = "unknown") -> None:
        """Test/fault-injection hook."""
        with self._mutate_lock:
            removed = self.running.pop(task_id, None)
        if removed is not None:
            self._report(task_id, InstanceStatus.FAILED, reason)

    def remove_host(self, node_id: str) -> list[str]:
        """Simulate node loss: fail all its tasks mea-culpa."""
        with self._mutate_lock:
            lost = [tid for tid, rt in self.running.items()
                    if rt.spec.node_id == node_id]
            for tid in lost:
                self.running.pop(tid)
            self.hosts.pop(node_id, None)
        for tid in sorted(lost):
            self._report(tid, InstanceStatus.FAILED, "node-removed")
        return lost

    def _report(self, task_id: str, status: InstanceStatus,
                reason: Optional[str]) -> None:
        if self.status_callback is not None:
            self.status_callback(task_id, status, reason)
