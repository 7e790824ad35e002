"""Leader election: single active scheduler with hot standbys.

A copy of `cook_tpu/control/leader.py` (jax-free), its imports rewritten to the
port's modules.

Reference: Curator/ZooKeeper LeaderSelector
(scheduler/src/cook/mesos.clj:153-328 +
components.clj:154): one instance leads and runs the scheduling loops;
standbys wait; on leadership loss the process fail-fast exits so a
supervisor restarts it clean (mesos.clj:296-313 — restarting state is
error-prone, a fresh process is safer).

Implementations:
  * InMemoryElector — single-process/tests.
  * FileLeaseElector — multi-process on one filesystem: an O_EXCL lease
    file with heartbeat timestamps; standbys take over when the lease
    goes stale.
  * HttpLeaseElector — the production path (the ZK-session analog):
    leases held by an external lease service
    (cook_tpu_torch.control.lease_server) over plain HTTP, so two
    schedulers on different machines with NO shared filesystem elect
    exactly one leader.  Server-side TTLs + fencing epochs; network partitions from
    the lease service dethrone the leader after one TTL (fail-fast,
    mesos.clj:296-313).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from abc import ABC, abstractmethod
from typing import Callable, Optional

from cook_tpu_torch import faults

log = logging.getLogger(__name__)


class LeaderElector(ABC):
    """`start` runs until leadership is lost, then calls on_loss — the
    caller is expected to exit the process (fail-fast)."""

    @abstractmethod
    def try_acquire(self) -> bool: ...

    @abstractmethod
    def heartbeat(self) -> bool:
        """Refresh the lease; False if leadership was lost."""

    @abstractmethod
    def release(self) -> None: ...

    @abstractmethod
    def current_leader(self) -> Optional[str]: ...


class InMemoryElector(LeaderElector):
    _leaders: dict[str, str] = {}
    _lock = threading.Lock()

    def __init__(self, group: str, member_id: str):
        self.group = group
        self.member_id = member_id

    def try_acquire(self) -> bool:
        with self._lock:
            if self._leaders.get(self.group) in (None, self.member_id):
                self._leaders[self.group] = self.member_id
                return True
            return False

    def heartbeat(self) -> bool:
        with self._lock:
            return self._leaders.get(self.group) == self.member_id

    def release(self) -> None:
        with self._lock:
            if self._leaders.get(self.group) == self.member_id:
                del self._leaders[self.group]

    def current_leader(self) -> Optional[str]:
        with self._lock:
            return self._leaders.get(self.group)


class FileLeaseElector(LeaderElector):
    def __init__(self, lease_path: str, member_id: str,
                 *, ttl_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 advertised_url: str = ""):
        self.lease_path = lease_path
        self.member_id = member_id
        self.ttl_s = ttl_s
        self.clock = clock
        # published in the lease so standbys can proxy to the leader
        self.advertised_url = advertised_url

    def _read(self) -> Optional[dict]:
        try:
            with open(self.lease_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _write(self) -> None:
        tmp = f"{self.lease_path}.{self.member_id}.tmp"
        with open(tmp, "w") as f:
            json.dump({"leader": self.member_id, "t": self.clock(),
                       "url": self.advertised_url}, f)
        os.replace(tmp, self.lease_path)

    def current_leader_url(self) -> str:
        lease = self._read()
        if lease is None or self.clock() - lease["t"] > self.ttl_s:
            return ""
        return lease.get("url", "")

    def try_acquire(self) -> bool:
        lease = self._read()
        now = self.clock()
        if lease is None or lease["leader"] == self.member_id \
                or now - lease["t"] > self.ttl_s:
            self._write()
            # re-read to detect a concurrent writer that beat us
            lease = self._read()
            return lease is not None and lease["leader"] == self.member_id
        return False

    def heartbeat(self) -> bool:
        lease = self._read()
        if lease is None or lease["leader"] != self.member_id:
            return False
        self._write()
        return True

    def release(self) -> None:
        lease = self._read()
        if lease is not None and lease["leader"] == self.member_id:
            try:
                os.unlink(self.lease_path)
            except FileNotFoundError:
                pass

    def current_leader(self) -> Optional[str]:
        lease = self._read()
        if lease is None or self.clock() - lease["t"] > self.ttl_s:
            return None
        return lease["leader"]


class HttpLeaseElector(LeaderElector):
    """Lease-service-backed elector (cook_tpu_torch.control.lease_server).

    Loss semantics mirror a ZK session: a heartbeat the service answers
    with ok=false (someone else holds the lease, or our fencing epoch is
    stale) is a DEFINITIVE loss.  A heartbeat that cannot reach the
    service at all is indeterminate — the lease may still be ours — so
    leadership survives transient partitions up to one TTL past the last
    confirmed renewal; beyond that the service may have re-granted the
    lease, and we must fail fast rather than risk two leaders.

    The TTL used for that grace window is the EFFECTIVE one the service
    reports back in /acquire and /heartbeat responses (the server clamps
    requested TTLs, lease_server.MAX_TTL_S): grace-checking against a
    configured-but-clamped TTL would keep a partitioned leader seated
    after the service already re-granted the lease — a two-leader
    window.
    """

    def __init__(self, endpoint: str, group: str, member_id: str,
                 *, ttl_s: float = 10.0, advertised_url: str = "",
                 timeout_s: float = 3.0,
                 clock: Callable[[], float] = time.monotonic):
        self.endpoint = endpoint.rstrip("/")
        self.group = group
        self.member_id = member_id
        self.ttl_s = ttl_s
        self.advertised_url = advertised_url
        self.timeout_s = timeout_s
        self.clock = clock
        self._epoch = 0
        self._last_renewal: Optional[float] = None
        # effective TTL granted by the service (it may clamp ttl_s);
        # adopted from every /acquire and /heartbeat response
        self.effective_ttl_s = ttl_s

    def _post(self, path: str, payload: dict) -> Optional[dict]:
        req = urllib.request.Request(
            self.endpoint + path,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def _get_leader(self) -> Optional[dict]:
        try:
            with urllib.request.urlopen(
                    f"{self.endpoint}/leader?group={self.group}",
                    timeout=self.timeout_s) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError):
            return None

    def try_acquire(self) -> bool:
        # measure the lease from BEFORE the request leaves: the server
        # starts the TTL when it processes the request, so stamping the
        # renewal at response time would extend our grace window up to one
        # RTT past server-side expiry — a two-leader window
        t0 = self.clock()
        resp = self._post("/acquire", {
            "group": self.group, "member": self.member_id,
            "url": self.advertised_url, "ttl_s": self.ttl_s})
        if resp is None or not resp.get("acquired"):
            return False
        self._epoch = int(resp.get("epoch", 0))
        self._adopt_ttl(resp)
        self._last_renewal = t0
        return True

    def _adopt_ttl(self, resp: dict) -> None:
        try:
            granted = float(resp.get("ttl_s", self.ttl_s))
        except (TypeError, ValueError):
            return
        if granted > 0:
            self.effective_ttl_s = granted

    def heartbeat(self) -> bool:
        t0 = self.clock()
        resp = self._post("/heartbeat", {
            "group": self.group, "member": self.member_id,
            "epoch": self._epoch, "ttl_s": self.ttl_s})
        if resp is None:
            # indeterminate: the service is unreachable, not lost — keep
            # leading until the lease could actually have lapsed, per the
            # TTL the service actually granted (not the configured ask)
            last = self._last_renewal
            return last is not None and \
                self.clock() - last < self.effective_ttl_s
        if not resp.get("ok"):
            return False
        self._adopt_ttl(resp)
        self._last_renewal = t0
        return True

    def release(self) -> None:
        self._post("/release", {"group": self.group,
                                "member": self.member_id,
                                "epoch": self._epoch})

    def current_leader(self) -> Optional[str]:
        resp = self._get_leader()
        return resp.get("leader") if resp else None

    def current_leader_url(self) -> str:
        resp = self._get_leader()
        return (resp.get("url") or "") if resp else ""


class LeaderSelector:
    """Blocks until leadership, runs `on_leadership`, watches the lease, and
    invokes `on_loss` (default: os._exit — the reference's System/exit 0)
    when it goes away."""

    def __init__(
        self,
        elector: LeaderElector,
        *,
        poll_s: float = 1.0,
        on_loss: Optional[Callable[[], None]] = None,
    ):
        self.elector = elector
        self.poll_s = poll_s
        self.on_loss = on_loss or (lambda: os._exit(0))
        self._stop = threading.Event()
        self._lost = threading.Event()
        self._loss_lock = threading.Lock()
        self.is_leader = False

    def wait_for_leadership(self) -> None:
        while not self._stop.is_set():
            if self.elector.try_acquire():
                self.is_leader = True
                return
            self._stop.wait(self.poll_s)

    def _heartbeat(self) -> bool:
        """One lease renewal, with the `leader.heartbeat` fault point in
        front: an injected error IS a lease loss (the chaos suite drives
        failover through the same fail-fast path a real expiry takes);
        a delay rule is a slow lease service."""
        try:
            fault_schedule = faults.ACTIVE
            if fault_schedule is not None:
                fault_schedule.hit(
                    faults.LEADER_HEARTBEAT,
                    member=getattr(self.elector, "member_id", ""))
        except faults.FaultInjected:
            return False
        return self.elector.heartbeat()

    def start_heartbeat_thread(self) -> threading.Thread:
        def loop():
            while not self._stop.is_set():
                if not self._heartbeat():
                    self.is_leader = False
                    self._fire_loss()
                    return
                self._stop.wait(self.poll_s)

        t = threading.Thread(target=loop, daemon=True, name="leader-heartbeat")
        t.start()
        return t

    def _fire_loss(self) -> None:
        # a voluntary demotion racing a heartbeat failure must not run
        # on_loss twice: the test-and-set must be atomic (Event alone
        # lets both threads pass the is_set check)
        with self._loss_lock:
            if self._lost.is_set():
                return
            self._lost.set()
        self.on_loss()

    def demote(self) -> None:
        """Voluntarily surrender a HELD lease (fail-stop on a journal
        fsync error): stop renewing, release the lease so a standby with
        a working disk can acquire it before the TTL runs out, then fire
        on_loss once.  The heartbeat-failure path never releases — there
        the lease is already lost."""
        self.is_leader = False
        self._stop.set()  # heartbeat loop exits without firing on_loss
        try:
            self.elector.release()
        except Exception:  # noqa: BLE001 — the lease still expires by TTL
            log.exception("lease release during demotion failed")
        self._fire_loss()

    def stop(self) -> None:
        self._stop.set()
        self.elector.release()
