"""Real Kubernetes apiserver client behind the `KubeApi` boundary.

Port of `cook_tpu/cluster/k8s_http.py`, on the standard library as the
reference's is, its imports the port's.  One change: `stop` also shuts
the live watch connections, so that a watch parked on a quiet stream
ends at once, and no event read after `stop` reaches the callback (the
reference's watch thread outlives `stop`'s 5 s join for up to
`watch_timeout_s` and may still deliver an event to a torn-down store).

This is the production implementation the reference keeps in
cook.kubernetes.api (Cook's scheduler/src/cook/kubernetes/api.clj):

  * pod LIST + WATCH loop with resourceVersion tracking and re-list on
    gap — a watch that dies, or that the apiserver answers with 410 Gone
    (history compacted past our resourceVersion), falls back to a full
    re-list whose diff against the local view is replayed as synthetic
    events, then the watch resumes from the fresh resourceVersion
    (initialize-pod-watch, api.clj:449-570);
  * node listing (api.clj:572 keeps a node watch; offers here re-list
    nodes each cycle, which matches the synthesized-offer cadence);
  * pod manifest construction from the launch details — main container
    with resource requests/limits, env, sidecar file-server container,
    labels, priority class for synthetic pods (launch-pod, api.clj:2152);
  * bearer-token refresh: tokens on disk rotate (projected service
    account tokens), so the Authorization header re-reads the file when
    it changes or a TTL lapses
    (scheduler/java/.../TokenRefreshingAuthenticator.java).

Everything is stdlib (http.client / json / threading): the scheduler's
backend boundary is synchronous, and the watch is one long-lived streaming
GET per client, not a connection pool workload.
"""
from __future__ import annotations

import http.client
import json
import logging
import os
import socket
import ssl
import threading
import time
from typing import Callable, Optional
from urllib.parse import urlencode, urlsplit

from cook_tpu_torch import faults
from cook_tpu_torch.cluster.k8s import KubeApi, KubeNode, KubePod, PodPhase
from cook_tpu_torch.utils.retry import RetryPolicy, call_with_retry

log = logging.getLogger(__name__)


class ApiError(OSError):
    """A non-2xx apiserver answer; `status` distinguishes client errors
    (4xx — never retried) from server errors (5xx — retryable on
    idempotent requests)."""

    def __init__(self, message: str, status: int):
        super().__init__(message)
        self.status = status


def _retryable_get_error(exc: BaseException) -> bool:
    """GET/LIST retry classification: transport failures and 5xx are
    transient; 4xx means the request itself is wrong (and a 410 WatchGap
    has its own re-list recovery)."""
    if isinstance(exc, WatchGap):
        return False
    if isinstance(exc, ApiError):
        return exc.status >= 500
    return isinstance(exc, OSError)

COOK_MANAGED_LABEL = "cook.scheduler/managed"
COOK_POOL_LABEL = "cook.scheduler/pool"
COOK_SYNTHETIC_LABEL = "cook.scheduler/synthetic"
SYNTHETIC_PRIORITY_CLASS = "cook-synthetic-pod"


class WatchGap(Exception):
    """The apiserver compacted history past our resourceVersion (HTTP 410
    or an ERROR event): the only recovery is a fresh LIST."""


_MIB = 1024.0 * 1024.0
_MEM_SUFFIXES = {
    # binary suffixes -> MiB
    "Ki": 1 / 1024, "Mi": 1.0, "Gi": 1024.0, "Ti": 1024.0**2,
    "Pi": 1024.0**3, "Ei": 1024.0**4,
    # decimal suffixes -> MiB
    "k": 1000 / _MIB, "K": 1000 / _MIB, "M": 1e6 / _MIB, "G": 1e9 / _MIB,
    "T": 1e12 / _MIB, "P": 1e15 / _MIB, "E": 1e18 / _MIB,
}


def parse_mem(q) -> float:
    """K8s memory quantity -> MiB.  An UNSUFFIXED quantity is BYTES (the
    apiserver's normalized form), not MiB."""
    if isinstance(q, (int, float)):
        return float(q) / _MIB
    s = str(q)
    for suffix, mult in _MEM_SUFFIXES.items():
        if s.endswith(suffix):
            return float(s[: -len(suffix)]) * mult
    if s.endswith("m"):  # millibytes: legal, absurd, normalize anyway
        return float(s[:-1]) / 1000 / _MIB
    return float(s) / _MIB


def parse_cpu(q) -> float:
    """K8s cpu quantity -> cores ("500m" -> 0.5, "4" -> 4.0)."""
    s = str(q)
    if s.endswith("m"):
        return float(s[:-1]) / 1000
    return float(s)


def format_mem(mem_mb: float) -> str:
    return f"{int(round(mem_mb))}Mi"


class TokenSource:
    """Re-reads a bearer-token file when its mtime changes or a TTL
    lapses (TokenRefreshingAuthenticator.java: periodic refresh so
    rotated projected tokens are picked up without restart)."""

    def __init__(self, path: Optional[str], ttl_s: float = 300.0):
        self.path = path
        self.ttl_s = ttl_s
        self._token: Optional[str] = None
        self._read_at = 0.0
        self._mtime = 0.0
        self._lock = threading.Lock()

    def token(self) -> Optional[str]:
        if self.path is None:
            return None
        with self._lock:
            now = time.time()
            try:
                mtime = os.path.getmtime(self.path)
            except OSError:
                return self._token
            if (self._token is None or mtime != self._mtime
                    or now - self._read_at > self.ttl_s):
                try:
                    with open(self.path) as f:
                        self._token = f.read().strip()
                    self._mtime = mtime
                    self._read_at = now
                except OSError:
                    pass
            return self._token


class HttpKubeApi(KubeApi):
    """KubeApi over a real apiserver.  `KubeCluster` runs unmodified
    against this class (same construction as with FakeKubeApi)."""

    def __init__(
        self,
        base_url: str,
        *,
        namespace: str = "default",
        token_file: Optional[str] = None,
        ca_file: Optional[str] = None,
        insecure_skip_verify: bool = False,
        request_timeout_s: float = 30.0,
        watch_timeout_s: float = 300.0,
        relist_backoff_s: float = 1.0,
        default_image: str = "busybox:stable",
        file_server_port: int = 0,
        file_server_image: str = "",
        checkpoint_tools_image: str = "",
    ):
        self.base_url = base_url.rstrip("/")
        # apiservers behind path-prefixed proxies (kubeconfig allows
        # "https://host/k8s/clusters/x"): keep the prefix on every request
        self._path_prefix = urlsplit(self.base_url).path.rstrip("/")
        self.namespace = namespace
        self.tokens = TokenSource(token_file)
        self.ca_file = ca_file
        self.insecure_skip_verify = insecure_skip_verify
        self.request_timeout_s = request_timeout_s
        self.watch_timeout_s = watch_timeout_s
        self.relist_backoff_s = relist_backoff_s
        self.default_image = default_image
        self.file_server_port = file_server_port
        self.file_server_image = file_server_image
        self.checkpoint_tools_image = checkpoint_tools_image
        self._watch_cb: Optional[Callable[[str, Optional[KubePod]], None]] = None
        self._known: dict[str, KubePod] = {}  # watch-maintained local view
        self._synced = threading.Event()  # set after the first LIST
        # second, selector-free watch: the cluster-wide consumption view
        # feeding list_all_pods (the reference computes consumption from
        # watch state, api.clj:886 — re-LISTing every cluster pod per
        # offer cycle is the apiserver-hammering alternative)
        self._known_all: dict[str, KubePod] = {}
        self._all_synced = threading.Event()
        self._stop = threading.Event()
        self._watch_thread: Optional[threading.Thread] = None
        self._all_watch_thread: Optional[threading.Thread] = None
        self._lock = threading.RLock()
        # the sockets of the streaming watches open now, shut by `stop`
        self._watch_socks: set = set()
        # bounded retry for idempotent GET/LIST only (see _request);
        # deadline keeps attempts + backoff inside ~2 request budgets
        self._get_retry_policy = RetryPolicy(
            max_attempts=2, base_s=0.2, cap_s=1.0,
            deadline_s=request_timeout_s * 2)

    # ----------------------------------------------------------- plumbing

    def _connection(self, timeout: float) -> http.client.HTTPConnection:
        parts = urlsplit(self.base_url)
        if parts.scheme == "https":
            if self.insecure_skip_verify:
                ctx = ssl._create_unverified_context()
            else:
                ctx = ssl.create_default_context(cafile=self.ca_file)
            return http.client.HTTPSConnection(
                parts.hostname, parts.port or 443, timeout=timeout,
                context=ctx)
        return http.client.HTTPConnection(
            parts.hostname, parts.port or 80, timeout=timeout)

    def _headers(self) -> dict:
        headers = {"Accept": "application/json",
                   "Content-Type": "application/json"}
        token = self.tokens.token()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        return headers

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 query: Optional[dict] = None) -> dict:
        """One apiserver call.  Idempotent GET/LIST requests get a
        bounded, deadline-aware retry (2 attempts, utils/retry.py shared
        policy) on transport errors and 5xx; MUTATING requests stay
        single-shot — a retried POST whose first attempt actually landed
        would double-create, and the watch/expected-state machinery
        already reconciles uncertainty."""
        path = self._path_prefix + path
        if query:
            path = f"{path}?{urlencode(query)}"

        def once() -> dict:
            fault_schedule = faults.ACTIVE
            if fault_schedule is not None:
                fault_schedule.hit(faults.K8S_REQUEST, method=method,
                                   path=path)
            conn = self._connection(self.request_timeout_s)
            try:
                conn.request(
                    method, path,
                    body=json.dumps(body) if body is not None else None,
                    headers=self._headers())
                resp = conn.getresponse()
                data = resp.read()
                if resp.status == 410:
                    raise WatchGap(path)
                if resp.status >= 400:
                    raise ApiError(
                        f"{method} {path} -> {resp.status}: "
                        f"{data[:200]!r}", resp.status)
                return json.loads(data) if data else {}
            finally:
                conn.close()

        if method != "GET":
            return once()
        return call_with_retry(once, self._get_retry_policy,
                               op="k8s.get",
                               retry_on=_retryable_get_error)

    # ------------------------------------------------------------ parsing

    @staticmethod
    def _pod_from_manifest(manifest: dict) -> KubePod:
        meta = manifest.get("metadata", {})
        spec = manifest.get("spec", {})
        status = manifest.get("status", {})
        labels = meta.get("labels", {}) or {}
        mem = cpus = gpus = 0.0
        host_ports = []
        for container in spec.get("containers", []):
            requests = container.get("resources", {}).get("requests", {})
            mem += parse_mem(requests.get("memory", 0))
            cpus += parse_cpu(requests.get("cpu", 0))
            gpus += parse_cpu(requests.get("nvidia.com/gpu", 0)
                              or requests.get("google.com/tpu", 0))
            for port in container.get("ports", []) or []:
                if port.get("hostPort"):
                    host_ports.append(int(port["hostPort"]))
        try:
            phase = PodPhase(status.get("phase", "Pending"))
        except ValueError:
            # e.g. a phase this client predates: treat as Unknown (alive)
            phase = PodPhase.UNKNOWN
        reason = ""
        if phase == PodPhase.FAILED:
            reason = status.get("reason", "")
            for cs in status.get("containerStatuses", []):
                term = cs.get("state", {}).get("terminated")
                if term and term.get("reason"):
                    reason = reason or term["reason"]
            # normalize the common kubelet reasons to cook failure reasons
            reason = {
                "OOMKilled": "max-mem-exceeded",
                "Evicted": "preempted-by-cluster",
                "DeadlineExceeded": "max-runtime-exceeded",
            }.get(reason, reason or "command-executor-failed")
        # a deletionTimestamp means the pod is going away; the watch will
        # deliver DELETED next, the phase meanwhile stays as reported
        return KubePod(
            name=meta.get("name", ""),
            node_name=spec.get("nodeName", ""),
            mem=mem,
            cpus=cpus,
            gpus=gpus,
            phase=phase,
            synthetic=labels.get(COOK_SYNTHETIC_LABEL) == "true",
            failure_reason=reason,
            pool=labels.get(COOK_POOL_LABEL, ""),
            ports=tuple(host_ports),
        )

    @staticmethod
    def _node_from_manifest(manifest: dict) -> KubeNode:
        meta = manifest.get("metadata", {})
        status = manifest.get("status", {})
        spec = manifest.get("spec", {})
        alloc = status.get("allocatable", {}) or status.get("capacity", {})
        labels = dict(meta.get("labels", {}) or {})
        ready = any(
            c.get("type") == "Ready" and c.get("status") == "True"
            for c in status.get("conditions", [])
        )
        # a NoSchedule taint makes the node unusable for new cook pods
        # (node-schedulable?, api.clj:782)
        tainted = any(
            t.get("effect") in ("NoSchedule", "NoExecute")
            for t in spec.get("taints", []) or []
            if not t.get("key", "").startswith("cook.scheduler/")
        )
        return KubeNode(
            name=meta.get("name", ""),
            mem=parse_mem(alloc.get("memory", 0)),
            cpus=parse_cpu(alloc.get("cpu", 0)),
            gpus=parse_cpu(alloc.get("nvidia.com/gpu", 0)
                           or alloc.get("google.com/tpu", 0)),
            pool=labels.get(COOK_POOL_LABEL, "default"),
            labels=tuple(sorted(labels.items())),
            schedulable=ready and not spec.get("unschedulable", False)
            and not tainted,
        )

    def pod_manifest(self, pod: KubePod) -> dict:
        """launch-pod parity (api.clj:2152): main container + optional
        sidecar file server, resource requests == limits, labels, node
        binding, synthetic priority class, checkpointing volume/init
        container/memory overhead (api.clj:934,1152-1198)."""
        # checkpoint env vars (mode/period/preserve-paths) arrive already
        # folded into pod.env by the matcher, and the memory overhead is
        # already in pod.mem — match-time padding keeps placement and the
        # launched pod in agreement (a backend-only pad would direct-bind
        # pods the kubelet rejects OutOfmemory on tight-fit nodes)
        checkpointing = bool(pod.checkpoint_mode)
        volume_mounts = []
        if checkpointing:
            volume_mounts = [{"name": "cook-checkpoint-tools",
                              "mountPath": "/opt/cook-checkpoint"}]
        containers = [{
            "name": "cook-job",
            "image": pod.image or self.default_image,
            "command": ["/bin/sh", "-c", pod.command] if pod.command else [],
            "env": [{"name": k, "value": str(v)} for k, v in pod.env],
            **({"ports": [{"containerPort": p, "hostPort": p}
                          for p in pod.ports]} if pod.ports else {}),
            **({"volumeMounts": volume_mounts} if volume_mounts else {}),
            "resources": {
                "requests": {
                    "memory": format_mem(pod.mem),
                    "cpu": str(pod.cpus),
                    **({"nvidia.com/gpu": str(int(pod.gpus))}
                       if pod.gpus else {}),
                },
                "limits": {
                    "memory": format_mem(pod.mem),
                    **({"nvidia.com/gpu": str(int(pod.gpus))}
                       if pod.gpus else {}),
                },
            },
        }]
        if self.file_server_port and not pod.synthetic:
            containers.append({
                "name": "cook-sidecar",
                "image": self.file_server_image or self.default_image,
                "command": ["cook-sidecar-fileserver", "--port",
                            str(self.file_server_port)],
                "ports": [{"containerPort": self.file_server_port}],
                "resources": {"requests": {"memory": "64Mi", "cpu": "0.1"}},
            })
        init_containers = []
        volumes = []
        if checkpointing:
            # the tools volume is populated by an init container from the
            # checkpoint image, so app images stay checkpoint-agnostic
            # (aux-cook-init-container-for-checkpoint, api.clj:934)
            volumes.append({"name": "cook-checkpoint-tools",
                            "emptyDir": {}})
            init_containers.append({
                "name": "aux-cook-init-container-for-checkpoint",
                "image": (self.checkpoint_tools_image
                          or self.default_image),
                "command": ["/bin/sh", "-c",
                            "cp -r /opt/checkpoint-tools/. "
                            "/opt/cook-checkpoint/ 2>/dev/null || true"],
                "volumeMounts": [{"name": "cook-checkpoint-tools",
                                  "mountPath": "/opt/cook-checkpoint"}],
            })
        manifest = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": pod.name,
                "namespace": self.namespace,
                "labels": {
                    COOK_MANAGED_LABEL: "true",
                    COOK_POOL_LABEL: pod.pool or "default",
                    **({COOK_SYNTHETIC_LABEL: "true"}
                       if pod.synthetic else {}),
                },
            },
            "spec": {
                "restartPolicy": "Never",
                "containers": containers,
                **({"initContainers": init_containers}
                   if init_containers else {}),
                **({"volumes": volumes} if volumes else {}),
                # synthetic pods must be preemptible by real workloads
                **({"priorityClassName": SYNTHETIC_PRIORITY_CLASS}
                   if pod.synthetic else {}),
                # the scheduler already picked the node: bind directly
                **({"nodeName": pod.node_name} if pod.node_name else {}),
                "tolerations": [{
                    "key": "cook.scheduler/pool",
                    "operator": "Equal",
                    "value": pod.pool or "default",
                    "effect": "NoSchedule",
                }],
            },
        }
        return manifest

    # ------------------------------------------------------------ KubeApi

    def list_nodes(self) -> list[KubeNode]:
        body = self._request("GET", "/api/v1/nodes")
        return [self._node_from_manifest(item)
                for item in body.get("items", [])]

    def list_pods(self) -> list[KubePod]:
        # the watch maintains a coherent local view; re-LISTing on every
        # caller (reconcile, scan, autoscale, offer cycles) would hammer
        # the apiserver for data the stream already delivers
        if self._watch_thread is not None and self._synced.is_set():
            with self._lock:
                return list(self._known.values())
        pods, _ = self._list_raw(
            f"/api/v1/namespaces/{self.namespace}/pods",
            f"{COOK_MANAGED_LABEL}=true")
        return pods

    def list_all_pods(self) -> list[KubePod]:
        """Cluster-wide, label-unfiltered: offers must account for
        daemonset/system pods or a direct-bound pod gets rejected
        OutOfcpu by the kubelet (get-consumption, api.clj:886).  Served
        from the selector-free watch view once synced."""
        if self._all_watch_thread is not None and self._all_synced.is_set():
            with self._lock:
                return list(self._known_all.values())
        body = self._request("GET", "/api/v1/pods")
        return [self._pod_from_manifest(item)
                for item in body.get("items", [])]

    def _list_pods_raw(self) -> tuple[list[KubePod], str]:
        body = self._request(
            "GET", f"/api/v1/namespaces/{self.namespace}/pods",
            query={"labelSelector": f"{COOK_MANAGED_LABEL}=true"})
        pods = [self._pod_from_manifest(item)
                for item in body.get("items", [])]
        rv = body.get("metadata", {}).get("resourceVersion", "")
        return pods, rv

    def create_pod(self, pod: KubePod) -> None:
        self._request("POST", f"/api/v1/namespaces/{self.namespace}/pods",
                      body=self.pod_manifest(pod))

    def delete_pod(self, name: str) -> None:
        try:
            self._request(
                "DELETE",
                f"/api/v1/namespaces/{self.namespace}/pods/{name}",
                body={"gracePeriodSeconds": 30})
        except ApiError as e:
            if e.status != 404:
                raise

    def set_pod_watch(self, callback) -> None:
        self._watch_cb = callback

    # -------------------------------------------------------------- watch

    def start(self, *, watch_all_pods: bool = True) -> None:
        """Start the watch loop threads: the cook-managed pod watch
        (initialize-pod-watch) and, by default, the selector-free
        cluster-wide watch that feeds `list_all_pods` consumption."""
        if self._watch_thread is None:
            self._stop.clear()
            self._watch_thread = threading.Thread(
                target=self._watch_loop,
                kwargs=dict(path=f"/api/v1/namespaces/{self.namespace}/pods",
                            selector=f"{COOK_MANAGED_LABEL}=true",
                            store=self._known, synced=self._synced,
                            emit=self._emit, what="pod"),
                name="kube-pod-watch", daemon=True)
            self._watch_thread.start()
        # not folded into the branch above: a second start(watch_all_pods=
        # True) after start(watch_all_pods=False) must still launch the
        # cluster-wide watch, or list_all_pods silently degrades to a full
        # cluster LIST per offer cycle
        if watch_all_pods and self._all_watch_thread is None:
            self._all_watch_thread = threading.Thread(
                target=self._watch_loop,
                kwargs=dict(path="/api/v1/pods", selector=None,
                            store=self._known_all, synced=self._all_synced,
                            emit=None, what="all-pods"),
                name="kube-all-pod-watch", daemon=True)
            self._all_watch_thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._synced.clear()
        self._all_synced.clear()
        with self._lock:
            socks = list(self._watch_socks)
        for sock in socks:
            # a watch parked in readline returns now, not at the
            # apiserver's timeout
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=5)
            self._watch_thread = None
        if self._all_watch_thread is not None:
            self._all_watch_thread.join(timeout=5)
            self._all_watch_thread = None

    def _emit(self, name: str, pod: Optional[KubePod]) -> None:
        if self._watch_cb is not None and not self._stop.is_set():
            try:
                self._watch_cb(name, pod)
            except Exception:
                log.exception("pod watch callback failed for %s", name)

    def _list_raw(self, path: str, selector: Optional[str]
                  ) -> tuple[list[KubePod], str]:
        query = {"labelSelector": selector} if selector else None
        body = self._request("GET", path, query=query)
        pods = [self._pod_from_manifest(item)
                for item in body.get("items", [])]
        rv = body.get("metadata", {}).get("resourceVersion", "")
        return pods, rv

    def _relist_and_diff(self, path, selector, store, synced, emit) -> str:
        """Fresh LIST; replay the diff against the local view as events —
        this is what closes a watch gap (missed events are reconstructed
        as state deltas, api.clj:449 re-list branch)."""
        pods, rv = self._list_raw(path, selector)
        fresh = {p.name: p for p in pods}
        with self._lock:
            gone = [name for name in store if name not in fresh]
            changed = [p for p in pods if store.get(p.name) != p]
            store.clear()
            store.update(fresh)
        synced.set()
        if emit is not None:
            for name in gone:
                emit(name, None)
            for pod in changed:
                emit(pod.name, pod)
        return rv

    def _watch_loop(self, *, path, selector, store, synced, emit,
                    what) -> None:
        while not self._stop.is_set():
            try:
                rv = self._relist_and_diff(path, selector, store, synced,
                                           emit)
                # a clean watch timeout resumes from the last event's (or
                # bookmark's) resourceVersion — only a gap or error pays
                # for a full re-list
                while not self._stop.is_set():
                    rv = self._stream_watch(rv, path, selector, store, emit)
            except WatchGap:
                log.info("%s watch gap (410): re-listing", what)
                continue
            except Exception as e:
                if self._stop.is_set():
                    return
                log.warning("%s watch error, re-listing: %s", what, e)
                self._stop.wait(self.relist_backoff_s)

    def _stream_watch(self, resource_version: str, path, selector, store,
                      emit) -> str:
        """One streaming watch connection; returns the last seen
        resourceVersion on clean timeout, raises WatchGap on 410."""
        params = {
            "watch": "1",
            "resourceVersion": resource_version,
            "allowWatchBookmarks": "true",
            "timeoutSeconds": str(int(self.watch_timeout_s)),
        }
        if selector:
            params["labelSelector"] = selector
        query = urlencode(params)
        conn = self._connection(self.watch_timeout_s + 10)
        last_rv = resource_version
        sock = None
        try:
            conn.request("GET", f"{self._path_prefix}{path}?{query}",
                         headers=self._headers())
            # the response reads this socket after the connection lets
            # go of it (a watch answers `Connection: close`)
            sock = conn.sock
            with self._lock:
                self._watch_socks.add(sock)
            if self._stop.is_set():
                return last_rv
            resp = conn.getresponse()
            if resp.status == 410:
                raise WatchGap(resource_version)
            if resp.status >= 400:
                raise OSError(f"watch -> {resp.status}")
            while not self._stop.is_set():
                line = resp.readline()
                if not line:
                    return last_rv  # clean close (timeout): caller resumes
                line = line.strip()
                if not line:
                    continue
                event = json.loads(line)
                etype = event.get("type")
                obj = event.get("object", {})
                if etype == "ERROR":
                    # apiserver reports expiry as an in-stream Status
                    if obj.get("code") == 410:
                        raise WatchGap(resource_version)
                    raise OSError(f"watch ERROR: {obj}")
                rv = obj.get("metadata", {}).get("resourceVersion")
                if rv:
                    last_rv = rv
                if etype == "BOOKMARK":
                    continue
                pod = self._pod_from_manifest(obj)
                if etype == "DELETED":
                    with self._lock:
                        store.pop(pod.name, None)
                    if emit is not None:
                        emit(pod.name, None)
                else:  # ADDED / MODIFIED
                    with self._lock:
                        store[pod.name] = pod
                    if emit is not None:
                        emit(pod.name, pod)
            return last_rv
        finally:
            with self._lock:
                self._watch_socks.discard(sock)
            conn.close()
