"""Standalone lease service: the ZooKeeper role in leader election.

A copy of `cook_tpu/control/lease_server.py` (standard library only), with
the reference's current contract: the server clamps every requested TTL
(`MAX_TTL_S`, and at least 0.5 s) and `acquire` / `heartbeat` answer with
the EFFECTIVE `ttl_s`, which `control/leader.HttpLeaseElector` adopts for
its partition grace.

Reference: Cook elects a single leader through Curator/ZooKeeper
(scheduler/src/cook/mesos.clj:153-328, components.clj:154) — an
*external* coordination service holds a session-scoped lease; whichever
scheduler holds it runs the scheduling loops and the rest hot-stand-by.
This module is the deployment's equivalent coordination point: a tiny
HTTP lease service (deployed once per cell, like ZK) that grants TTL
leases with fencing tokens.  Schedulers talk to it via `HttpLeaseElector`
(cook_tpu_torch.control.leader), which needs only outbound HTTP — two
schedulers on different machines with nothing shared but this service's
address elect exactly one leader.

Design points (vs the FileLeaseElector it supersedes):
  * TTLs are measured on the SERVER's monotonic clock — client clock
    skew cannot extend or shorten a lease.
  * Every grant carries a monotonically increasing fencing token
    (`epoch`); heartbeats must present it, so a deposed leader whose
    heartbeat raced a takeover is told "lost", never silently re-seated.
  * State is in-memory: if the lease service restarts, leases lapse and
    the sitting leader re-acquires within one heartbeat — the same
    availability story as a ZK session bounce.

Run standalone:  python -m cook_tpu_torch.control.lease_server --port 12340
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional


# server-side TTL ceiling (seconds): leases must lapse fast enough for
# failover to be useful no matter what a client asks for
MAX_TTL_S = 60.0


@dataclass
class _Lease:
    leader: str
    url: str
    epoch: int
    deadline: float  # server-monotonic expiry


@dataclass
class LeaseTable:
    """The lease state machine, transport-independent (tested directly)."""

    clock: callable = time.monotonic
    _leases: dict[str, _Lease] = field(default_factory=dict)
    _epoch: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def acquire(self, group: str, member: str, url: str,
                ttl_s: float) -> dict:
        with self._lock:
            now = self.clock()
            lease = self._leases.get(group)
            if lease is not None and lease.deadline > now \
                    and lease.leader != member:
                return {"acquired": False, "leader": lease.leader,
                        "url": lease.url}
            # fresh grant OR the sitting leader re-acquiring: both bump
            # the epoch so stale heartbeats from a previous incarnation
            # of the same member (a restarted process) are fenced off
            self._epoch += 1
            self._leases[group] = _Lease(leader=member, url=url,
                                         epoch=self._epoch,
                                         deadline=now + ttl_s)
            # the EFFECTIVE (possibly clamped) TTL goes back to the
            # client: the elector's unreachable-service grace window must
            # match what the server actually granted, or a clamped lease
            # leaves the old leader believing it holds a longer one — a
            # two-leader window
            return {"acquired": True, "leader": member, "url": url,
                    "epoch": self._epoch, "ttl_s": ttl_s}

    def heartbeat(self, group: str, member: str, epoch: int,
                  ttl_s: float) -> dict:
        with self._lock:
            now = self.clock()
            lease = self._leases.get(group)
            if lease is None or lease.leader != member \
                    or lease.epoch != epoch or lease.deadline <= now:
                current = lease.leader if lease is not None \
                    and lease.deadline > now else None
                return {"ok": False, "leader": current}
            lease.deadline = now + ttl_s
            return {"ok": True, "leader": member, "ttl_s": ttl_s}

    def release(self, group: str, member: str, epoch: int) -> dict:
        with self._lock:
            lease = self._leases.get(group)
            if lease is not None and lease.leader == member \
                    and lease.epoch == epoch:
                del self._leases[group]
                return {"released": True}
            return {"released": False}

    def current(self, group: str) -> dict:
        with self._lock:
            lease = self._leases.get(group)
            if lease is None or lease.deadline <= self.clock():
                return {"leader": None, "url": ""}
            return {"leader": lease.leader, "url": lease.url,
                    "epoch": lease.epoch}


class _Handler(BaseHTTPRequestHandler):
    table: LeaseTable  # set by serve()

    def log_message(self, fmt, *args):  # quiet
        pass

    def _json(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        from urllib.parse import parse_qs, urlparse

        parsed = urlparse(self.path)
        if parsed.path == "/leader":
            q = parse_qs(parsed.query)
            group = (q.get("group") or ["cook"])[0]
            return self._json(200, self.table.current(group))
        if parsed.path == "/healthz":
            return self._json(200, {"ok": True})
        return self._json(404, {"error": "unknown path"})

    def do_POST(self):
        length = int(self.headers.get("Content-Length", 0) or 0)
        try:
            body = json.loads(self.rfile.read(length) or b"{}")
        except json.JSONDecodeError:
            return self._json(400, {"error": "malformed JSON"})
        group = str(body.get("group", "cook"))
        member = str(body.get("member", ""))
        if not member:
            return self._json(400, {"error": "member required"})
        try:
            ttl = float(body.get("ttl_s", 10.0))
            epoch = int(body.get("epoch", 0))
        except (TypeError, ValueError):
            return self._json(400, {"error": "malformed ttl_s/epoch"})
        # clamp: one buggy/malicious acquire with a huge TTL would lock
        # the group to a dead member until the service restarts,
        # defeating the fail-fast design
        ttl = max(0.5, min(ttl, MAX_TTL_S))
        if self.path == "/acquire":
            return self._json(200, self.table.acquire(
                group, member, str(body.get("url", "")), ttl))
        if self.path == "/heartbeat":
            return self._json(200, self.table.heartbeat(
                group, member, epoch, ttl))
        if self.path == "/release":
            return self._json(200, self.table.release(group, member, epoch))
        return self._json(404, {"error": "unknown path"})


class LeaseServer:
    """In-process harness (tests / embedded deployments)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 clock=time.monotonic):
        self.table = LeaseTable(clock=clock)
        handler = type("BoundHandler", (_Handler,), {"table": self.table})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self.url = f"http://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "LeaseServer":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True, name="lease-server")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=12340)
    args = parser.parse_args(argv)
    server = LeaseServer(args.host, args.port)
    print(f"lease server listening on {server.url}", flush=True)
    try:
        server._thread = threading.current_thread()
        server._httpd.serve_forever()
    except KeyboardInterrupt:
        server.stop()


if __name__ == "__main__":
    main()
