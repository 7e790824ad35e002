"""Kubernetes-style compute cluster: synthesized offers + two-map controller.

Port of `cook_tpu/cluster/k8s.py`, its imports the port's.  Two
changes: `autoscale` skips the synthetic pod names already on the
apiserver, so a leader restarted against a live apiserver does not
re-create `synthetic-1..` (the reference's counter restarts at 0 and its
create raises out of the match cycle); and `scan_all` leaves a task whose
pod it created less than STARTING_GRACE_MS ago, and has not seen yet,
to its watch (the reference's scan reads a pod list that a watch serves,
finds a pod POSTed moments ago missing, and fails the task as lost).

Reference: cook.kubernetes.{compute-cluster,controller,api}
(Cook's scheduler/src/cook/kubernetes/):

  * K8s has no offer protocol, so offers are SYNTHESIZED from node capacity
    minus pod consumption (compute_cluster.clj:68-190, api.clj:874-905).
  * Task lifecycle is driven by a two-map reconciliation controller:
    `expected_state` (what Cook wants) vs `actual_state` (what the pod
    watch last reported); every event runs `process(task_id)`, a state
    machine whose (expected x actual) table decides launch/kill/delete/
    status-report actions (controller.clj:482-828).
  * Autoscaling submits SYNTHETIC placeholder pods so the cluster
    autoscaler provisions nodes (compute_cluster.clj:606), bounded by
    outstanding/total caps.
  * A periodic anti-entropy scan re-processes every known task
    (compute_cluster.clj:199-230).

The `KubeApi` boundary below is the piece a production deployment swaps
for a real apiserver client (watches + pod CRUD, `cluster/k8s_http.py`);
`FakeKubeApi` is the in-memory stand-in used by tests and the simulator.
"""
from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

from cook_tpu_torch.cluster.base import (
    ComputeCluster,
    Offer,
    TaskSpec,
    subtract_ports,
)
from cook_tpu_torch.models.entities import InstanceStatus


class PodPhase(enum.Enum):
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"
    # kubelet stopped reporting (node unreachable); the pod may still be
    # running — treated as alive until reconciliation or a real phase
    UNKNOWN = "Unknown"


@dataclass
class KubeNode:
    name: str
    mem: float
    cpus: float
    gpus: float = 0.0
    pool: str = "default"
    labels: tuple = ()
    schedulable: bool = True


@dataclass
class KubePod:
    name: str
    node_name: str
    mem: float
    cpus: float
    gpus: float = 0.0
    phase: PodPhase = PodPhase.PENDING
    synthetic: bool = False
    failure_reason: str = ""
    # launch details a real apiserver client needs to build the pod
    # manifest (launch-pod, api.clj:2152); FakeKubeApi ignores them
    command: str = ""
    image: str = ""
    env: tuple = ()
    pool: str = ""
    # host ports assigned to this pod (surfaced as hostPort entries)
    ports: tuple = ()
    # checkpointing (api.clj:934 init container + :1173 volume wiring)
    checkpoint_mode: str = ""
    checkpoint_periodic_sec: int = 0


class KubeApi:
    """The apiserver boundary (api.clj): node/pod listings, pod CRUD, and a
    pod-event callback (the watch)."""

    def list_nodes(self) -> Sequence[KubeNode]:
        raise NotImplementedError

    def list_pods(self) -> Sequence[KubePod]:
        """Cook-managed pods (the controller's domain)."""
        raise NotImplementedError

    def list_all_pods(self) -> Sequence[KubePod]:
        """EVERY pod consuming node resources — daemonsets/system pods
        included — for offer synthesis (get-consumption, api.clj:886).
        The controller must NOT see these (it kills unknown pods)."""
        return self.list_pods()

    def create_pod(self, pod: KubePod) -> None:
        raise NotImplementedError

    def delete_pod(self, name: str) -> None:
        raise NotImplementedError

    def set_pod_watch(self, callback: Callable[[str, Optional[KubePod]], None]
                      ) -> None:
        raise NotImplementedError


class FakeKubeApi(KubeApi):
    """Deterministic in-memory apiserver.  Pods scheduled onto the emptiest
    feasible node; `tick()` moves Pending->Running; tests complete/fail pods
    explicitly."""

    def __init__(self, nodes: Sequence[KubeNode] = ()):
        self.nodes: dict[str, KubeNode] = {n.name: n for n in nodes}
        self.pods: dict[str, KubePod] = {}
        self._watch: Optional[Callable] = None
        self._lock = threading.RLock()

    def list_nodes(self) -> list[KubeNode]:
        with self._lock:
            return list(self.nodes.values())

    def list_pods(self) -> list[KubePod]:
        with self._lock:
            return list(self.pods.values())

    def create_pod(self, pod: KubePod) -> None:
        with self._lock:
            if pod.name in self.pods:
                raise ValueError(f"pod {pod.name} exists")
            self.pods[pod.name] = pod
        self._notify(pod.name)

    def delete_pod(self, name: str) -> None:
        with self._lock:
            self.pods.pop(name, None)
        self._notify(name)

    def set_pod_watch(self, callback) -> None:
        self._watch = callback

    def _notify(self, name: str) -> None:
        if self._watch is not None:
            self._watch(name, self.pods.get(name))

    def add_node(self, node: KubeNode) -> None:
        """Node-pool grow (the piece a real deployment's node-pool
        controller does in response to a resize request)."""
        with self._lock:
            self.nodes[node.name] = node

    def set_schedulable(self, name: str, schedulable: bool) -> None:
        """Cordon/uncordon a node (loaned-out capacity is withheld by
        cordoning, never by killing pods)."""
        with self._lock:
            node = self.nodes.get(name)
            if node is not None:
                node.schedulable = schedulable

    # ----- test/simulation controls -----

    def tick(self) -> None:
        """Start all pending pods (the kubelet's work)."""
        with self._lock:
            starting = [p for p in self.pods.values()
                        if p.phase == PodPhase.PENDING]
            for pod in starting:
                self.pods[pod.name] = replace(pod, phase=PodPhase.RUNNING)
        for pod in starting:
            self._notify(pod.name)

    def finish_pod(self, name: str, *, failed: bool = False,
                   reason: str = "") -> None:
        with self._lock:
            pod = self.pods.get(name)
            if pod is None:
                return
            self.pods[name] = replace(
                pod,
                phase=PodPhase.FAILED if failed else PodPhase.SUCCEEDED,
                failure_reason=reason,
            )
        self._notify(name)

    def remove_node(self, name: str) -> list[str]:
        with self._lock:
            self.nodes.pop(name, None)
            lost = [p.name for p in self.pods.values() if p.node_name == name]
            for pname in lost:
                self.pods[pname] = replace(
                    self.pods[pname], phase=PodPhase.FAILED,
                    failure_reason="node-removed",
                )
        for pname in lost:
            self._notify(pname)
        return lost


class ExpectedState(enum.Enum):
    """What Cook wants for a task (controller.clj cook-expected-state)."""

    STARTING = "starting"
    RUNNING = "running"
    COMPLETED = "completed"
    KILLED = "killed"
    MISSING = "missing"


class KubeCluster(ComputeCluster):
    def __init__(self, name: str, api: KubeApi, clock: Callable[[], int],
                 *, synthetic_pod_limits: Optional[dict] = None,
                 file_server_port: int = 8000,
                 host_port_range: tuple = (31000, 32767)):
        super().__init__(name)
        self.file_server_port = file_server_port
        # offerable hostPort range per node (K8s has no port offers; jobs
        # requesting ports get hostPorts from this window, mirroring the
        # NodePort service range)
        self.host_port_range = host_port_range
        self.api = api
        self.clock = clock
        self.expected: dict[str, ExpectedState] = {}
        self.task_pods: dict[str, KubePod] = {}  # task id -> last actual
        # kill tombstones consulted by launch_tasks: process() pops the
        # KILLED expected entry as soon as the kill is reported, so a
        # batch still queued on the async launch executor needs this
        # longer-lived marker or it would create a pod for a task the
        # store already drove terminal (a leaked pod — nothing would
        # ever delete it).  FIFO-bounded; consumed on launch skip.
        from collections import OrderedDict

        self._killed_tombstones: "OrderedDict[str, None]" = OrderedDict()
        # when each launched task's pod was created, until the first pod
        # event for it (see STARTING_GRACE_MS)
        self._created_at: dict[str, int] = {}
        self.status_callback = None
        self.synthetic_limits = {
            "max-pods-outstanding": 128,
            "max-total-pods": 32_000,
            **(synthetic_pod_limits or {}),
        }
        self._synthetic_seq = 0
        self._lock = threading.RLock()
        # elastic capacity (cook_tpu_torch/elastic/): node-pool resize requests
        # issued by scale(), newest last (bounded); nodes cordoned to
        # withhold loaned-out capacity, per pool
        self.resize_requests: list[dict] = []
        self._last_requested: dict[str, dict] = {}
        self._cordoned_for_loan: dict[str, set[str]] = {}
        api.set_pod_watch(self._pod_event)

    # ------------------------------------------------------------- offers

    def pending_offers(self, pool: str) -> list[Offer]:
        """Synthesize offers: capacity minus consumption per schedulable
        node (generate-offers)."""
        consumption: dict[str, list[float]] = {}
        ports_taken: dict[str, set] = {}
        for pod in self.api.list_all_pods():
            if pod.phase in (PodPhase.PENDING, PodPhase.RUNNING,
                             PodPhase.UNKNOWN):
                c = consumption.setdefault(pod.node_name, [0.0, 0.0, 0.0])
                c[0] += pod.mem
                c[1] += pod.cpus
                c[2] += pod.gpus
                if pod.ports:
                    ports_taken.setdefault(pod.node_name,
                                           set()).update(pod.ports)
        offers = []
        for node in self.api.list_nodes():
            if not node.schedulable or node.pool != pool:
                continue
            used = consumption.get(node.name, [0.0, 0.0, 0.0])
            offers.append(Offer(
                node_id=node.name,
                hostname=node.name,
                mem=node.mem - used[0],
                cpus=node.cpus - used[1],
                gpus=node.gpus - used[2],
                attributes=node.labels,
                total_mem=node.mem,
                total_cpus=node.cpus,
                ports=subtract_ports((self.host_port_range,),
                                     ports_taken.get(node.name, ())),
            ))
        return offers

    # ----------------------------------------------------- task lifecycle

    def launch_tasks(self, pool: str, specs: Sequence[TaskSpec]) -> None:
        """Create one pod per spec.  Safe under the async launch contract
        (ComputeCluster.launch_tasks_async): `expected` mutations are
        lock-guarded, per-spec API errors are reported as
        pod-submission-api-error without aborting the batch, and the
        status callback chain never runs while this cluster's internal
        lock is held."""
        for spec in specs:
            with self._lock:
                if (spec.task_id in self._killed_tombstones
                        or self.expected.get(spec.task_id)
                        is ExpectedState.KILLED):
                    # a kill raced this batch while it sat in the async
                    # launch queue (the kill-lock only excludes kills
                    # during the backend call itself): the store
                    # instance is already terminal, so creating the pod
                    # now would leak it — nothing would ever delete it
                    self._killed_tombstones.pop(spec.task_id, None)
                    continue
                self.expected[spec.task_id] = ExpectedState.STARTING
                self._created_at[spec.task_id] = self.clock()
            try:
                self.api.create_pod(KubePod(
                    name=spec.task_id,
                    node_name=spec.node_id,
                    mem=spec.mem,
                    cpus=spec.cpus,
                    gpus=spec.gpus,
                    command=spec.command,
                    image=spec.container_image,
                    env=tuple(spec.env),
                    pool=pool,
                    ports=tuple(spec.ports),
                    checkpoint_mode=spec.checkpoint_mode,
                    checkpoint_periodic_sec=spec.checkpoint_periodic_sec,
                ))
            except Exception:
                self._report(spec.task_id, InstanceStatus.FAILED,
                             "pod-submission-api-error")
                with self._lock:
                    self.expected.pop(spec.task_id, None)
                    self._created_at.pop(spec.task_id, None)

    def kill_task(self, task_id: str) -> None:
        with self._lock:
            self.expected[task_id] = ExpectedState.KILLED
            if len(self._killed_tombstones) >= 10_000:
                self._killed_tombstones.popitem(last=False)
            self._killed_tombstones[task_id] = None
            self._created_at.pop(task_id, None)
        self.process(task_id)

    # -------------------------------------------------------- controller

    def _pod_event(self, name: str, pod: Optional[KubePod]) -> None:
        """pod-update / pod-deleted (controller.clj:752-765)."""
        if name.startswith("synthetic-"):
            return
        with self._lock:
            self._created_at.pop(name, None)
            if pod is not None:
                self.task_pods[name] = pod
            else:
                self.task_pods.pop(name, None)
        self.process(name)

    def process(self, task_id: str) -> None:
        """The (expected x actual) state machine (controller.clj:482)."""
        with self._lock:
            expected = self.expected.get(task_id, ExpectedState.MISSING)
            pod = self.task_pods.get(task_id)
        phase = pod.phase if pod is not None else None

        if expected == ExpectedState.KILLED:
            if pod is not None and phase in (PodPhase.PENDING,
                                             PodPhase.RUNNING,
                                             PodPhase.UNKNOWN):
                self.api.delete_pod(task_id)
            self._report(task_id, InstanceStatus.FAILED, "killed-by-user")
            with self._lock:
                self.expected.pop(task_id, None)
            return

        if expected in (ExpectedState.STARTING, ExpectedState.RUNNING):
            if pod is None:
                # pod vanished: mea-culpa failure, scheduler may retry
                self._report(task_id, InstanceStatus.FAILED,
                             "could-not-reconstruct-state")
                with self._lock:
                    self.expected.pop(task_id, None)
            elif phase == PodPhase.RUNNING:
                if expected == ExpectedState.STARTING:
                    with self._lock:
                        self.expected[task_id] = ExpectedState.RUNNING
                    self._report(task_id, InstanceStatus.RUNNING, None)
            elif phase == PodPhase.SUCCEEDED:
                self._report(task_id, InstanceStatus.SUCCESS, "normal-exit")
                with self._lock:
                    self.expected[task_id] = ExpectedState.COMPLETED
                self.api.delete_pod(task_id)
            elif phase == PodPhase.FAILED:
                reason = pod.failure_reason or "command-executor-failed"
                self._report(task_id, InstanceStatus.FAILED, reason)
                with self._lock:
                    self.expected[task_id] = ExpectedState.COMPLETED
                self.api.delete_pod(task_id)
            return

        if expected == ExpectedState.MISSING and pod is not None \
                and not pod.synthetic:
            # unknown pod owned by us: kill it (controller's orphan branch)
            if phase in (PodPhase.PENDING, PodPhase.RUNNING,
                         PodPhase.UNKNOWN):
                self.api.delete_pod(task_id)

    # how long the scan leaves a launched task whose pod it has not seen
    # to the watch: `list_pods` may be served by a watch that has not yet
    # streamed a pod POSTed moments ago
    STARTING_GRACE_MS = 60_000

    def scan_all(self) -> None:
        """Anti-entropy scan (scan-process, compute_cluster.clj:199-230)."""
        with self._lock:
            known = set(self.expected) | set(self.task_pods)
        for pod in self.api.list_pods():
            known.add(pod.name)
            with self._lock:
                if not pod.synthetic:
                    self.task_pods[pod.name] = pod
        now = self.clock()
        for task_id in sorted(known):
            if task_id.startswith("synthetic-"):
                continue
            with self._lock:
                created = self._created_at.get(task_id)
                if created is not None and task_id not in self.task_pods:
                    if now - created < self.STARTING_GRACE_MS:
                        continue
                    del self._created_at[task_id]
            self.process(task_id)

    def determine_expected_state_on_startup(self, live_task_ids: set[str]
                                            ) -> None:
        """Failover recovery (compute_cluster.clj:269): rebuild the expected
        map from the store's live instances."""
        with self._lock:
            for task_id in live_task_ids:
                self.expected.setdefault(task_id, ExpectedState.RUNNING)
        self.scan_all()

    # -------------------------------------------------------- autoscaling

    def autoscaling(self, pool: str) -> bool:
        return True

    def autoscale(self, pool: str, pending_demand: Sequence[TaskSpec]) -> None:
        """Submit synthetic placeholder pods for unmatched demand so the
        cluster autoscaler provisions capacity (autoscale!,
        compute_cluster.clj:606)."""
        pods = self.api.list_pods()
        outstanding = sum(
            1
            for p in pods
            if p.synthetic and p.phase == PodPhase.PENDING
        )
        # names a previous leader's placeholders still hold on the
        # apiserver: creating one again would be refused
        taken = {p.name for p in pods if p.synthetic}
        budget = self.synthetic_limits["max-pods-outstanding"] - outstanding
        for spec in list(pending_demand)[: max(budget, 0)]:
            self._synthetic_seq += 1
            while f"synthetic-{self._synthetic_seq}" in taken:
                self._synthetic_seq += 1
            self.api.create_pod(KubePod(
                name=f"synthetic-{self._synthetic_seq}",
                node_name="",  # unschedulable until the autoscaler adds nodes
                mem=spec.mem,
                cpus=spec.cpus,
                gpus=spec.gpus,
                synthetic=True,
            ))

    def synthetic_pods(self) -> list[KubePod]:
        return [p for p in self.api.list_pods() if p.synthetic]

    # --------------------------------------------------- elastic capacity

    # fallback per-node shape when a pool has no template node to copy
    ELASTIC_NODE_SHAPE = {"mem": 65536.0, "cpus": 32.0, "gpus": 0.0}
    MAX_RESIZE_REQUESTS = 256

    def supports_scale(self) -> bool:
        return True

    def _node_busy(self, name: str) -> bool:
        return any(
            p.node_name == name
            and p.phase in (PodPhase.PENDING, PodPhase.RUNNING,
                            PodPhase.UNKNOWN)
            for p in self.api.list_all_pods()
        )

    def scale(self, pool: str, adjustment: dict) -> dict:
        """Elastic capacity as a NODE-POOL RESIZE REQUEST (the k8s
        analog of Aryl's loaned nodes): positive targets grow the pool
        with `elastic-{pool}-{i}` nodes sized like the pool's template
        node; negative targets cordon empty nodes so the loaned-out
        capacity stops being offered — pods are never killed (reclaim
        is non-disruptive; a cordoned node drains as work finishes).
        The request itself is always recorded (`resize_requests`) so a
        deployment whose node-pool controller lives outside this
        process can act on it; against an api exposing node CRUD
        (FakeKubeApi) it is applied immediately."""
        adj = {d: float(adjustment.get(d, 0.0))
               for d in ("mem", "cpus", "gpus")}
        # the request ring is for an EXTERNAL node-pool controller: only
        # target changes are worth recording — the planner reconciles
        # every interval, and a stream of unchanged/all-zero requests
        # would rotate real ones out of the bounded ring.  Convergence
        # work below still runs every call (a prior shrink may have
        # skipped then-busy nodes that have since drained).
        if self._last_requested.get(pool) != adj and (
                any(adj.values()) or pool in self._last_requested):
            self.resize_requests.append(
                {"pool": pool, "adjustment": dict(adj),
                 "t_ms": self.clock()})
            del self.resize_requests[:-self.MAX_RESIZE_REQUESTS]
            self._last_requested[pool] = dict(adj)

        prefix = f"elastic-{pool}-"
        nodes = self.api.list_nodes()
        regular = sorted((n for n in nodes
                          if n.pool == pool and not n.name.startswith(prefix)),
                         key=lambda n: n.name)
        # ownership = prefix AND pool: with pools "gpu" and "gpu-west",
        # "elastic-gpu-west-0" startswith "elastic-gpu-" — the prefix
        # alone would let pool "gpu" shrink away gpu-west's loaned nodes
        elastic = sorted((n for n in nodes
                          if n.pool == pool and n.name.startswith(prefix)),
                         key=lambda n: n.name)
        template = (regular[0] if regular else None)
        shape = ({"mem": template.mem, "cpus": template.cpus,
                  "gpus": template.gpus} if template is not None
                 else dict(self.ELASTIC_NODE_SHAPE))

        # grow: enough elastic nodes to cover every positive dimension
        want = 0
        for dim in adj:
            if adj[dim] > 0 and shape.get(dim, 0.0) > 0:
                want = max(want, -(-adj[dim] // shape[dim]))
        want = int(want)
        add_node = getattr(self.api, "add_node", None)
        if add_node is not None:
            seq = len(elastic)
            while len(elastic) < want:
                node = KubeNode(name=f"{prefix}{seq}", mem=shape["mem"],
                                cpus=shape["cpus"], gpus=shape["gpus"],
                                pool=pool)
                add_node(node)
                elastic.append(node)
                seq += 1
            # shrink: drop only EMPTY elastic nodes (drain, don't kill)
            remove_node = getattr(self.api, "remove_node", None)
            for node in elastic[want:]:
                if remove_node is not None and not self._node_busy(node.name):
                    remove_node(node.name)

        # negative dims: cordon empty regular nodes until the withheld
        # capacity covers the loaned-out amount; uncordon on reclaim
        set_schedulable = getattr(self.api, "set_schedulable", None)
        if set_schedulable is not None:
            need = {d: max(-v, 0.0) for d, v in adj.items()}
            cordoned = self._cordoned_for_loan.setdefault(pool, set())
            for name in sorted(cordoned):
                set_schedulable(name, True)
            cordoned.clear()
            if any(v > 0 for v in need.values()):
                for node in regular:
                    if all(v <= 0 for v in need.values()):
                        break
                    if self._node_busy(node.name):
                        continue
                    set_schedulable(node.name, False)
                    cordoned.add(node.name)
                    need["mem"] -= node.mem
                    need["cpus"] -= node.cpus
                    need["gpus"] -= node.gpus
        return adj

    # ------------------------------------------------------------- misc

    def num_tasks_on_host(self, hostname: str) -> int:
        return sum(
            1 for p in self.api.list_pods()
            if p.node_name == hostname
            and p.phase in (PodPhase.PENDING, PodPhase.RUNNING,
                            PodPhase.UNKNOWN)
            and not p.synthetic
        )

    def retrieve_sandbox_url_path(self, task_id: str) -> str:
        """The pod sidecar file-server URL (reference: the sidecar serves
        the Mesos files/ API on a well-known port inside each pod)."""
        pod = self.task_pods.get(task_id)
        if pod is None or not pod.node_name:
            return ""
        return f"http://{pod.node_name}:{self.file_server_port}"

    @property
    def running(self):
        """Task view for reconciliation (Scheduler.reconcile)."""
        return {
            p.name: p for p in self.api.list_pods()
            if not p.synthetic and p.phase in (PodPhase.PENDING,
                                               PodPhase.RUNNING,
                                               PodPhase.UNKNOWN)
        }

    def _report(self, task_id, status, reason) -> None:
        if self.status_callback is not None:
            self.status_callback(task_id, status, reason)
