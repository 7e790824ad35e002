"""Fleet observatory: cross-process telemetry federation.

Port of `cook_tpu/obs/fleet.py`.  The control plane is multi-node
(sharded leader + journal-replaying replicas), but every debug surface is
a single-process view: the operator of a 4-node deployment would
hand-poll N hosts and mentally merge the verdicts.  `FleetObservatory` is
the leader-side merge: it polls every known peer — the `Settings.peers`
list plus every follower that identified itself (with its URL) through
the replication ack registry (control/replication.py -> rest/api.py) —
for its health verdict, per-shard staleness, contention summary, and a
configurable set of headline gauges, and serves one merged fleet verdict
at `GET /debug/fleet`:

  * one row per node (the leader itself included), each stamped with
    its poll age — a stale row is visibly stale, never silently fresh;
  * two federation-level degradation reasons: `peer-unreachable`
    (transport failure / timeout) and `peer-degraded` (the peer's own
    verdict is degraded, its reasons attached verbatim);
  * worst-shard-across-nodes replication staleness, so "is any replica
    falling behind anywhere" is one field;
  * a peer's ok -> degraded edge observed by the poller captures a
    FEDERATED entry in the leader's incident ring referencing the
    peer's own newest bundle id — the leader's `/debug/incidents` is
    the one place to start any investigation.  Edges are cooldown-
    suppressed per peer, the same flap discipline as the incident
    recorder itself.

The mp supervisor (`mp/supervisor.py`) runs one too: its rows are the
liveness signal of the worker fleet.

Cluster-wide, time-windowed telemetry is the input online scheduling
and capacity-loan decisions run on (arXiv:2501.05563; Aryl,
arXiv:2202.07896); this module is the collection plane for it.

Import discipline: stdlib + utils.metrics only (the REST layer and
control-plane-only nodes import this module).
"""
from __future__ import annotations

import json
import logging
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Optional

from cook_tpu_torch.utils.metrics import global_registry, prometheus_name

log = logging.getLogger(__name__)

PEER_UNREACHABLE = "peer-unreachable"
PEER_DEGRADED = "peer-degraded"

FLEET_REASONS = (PEER_UNREACHABLE, PEER_DEGRADED)

# registry names whose current value every fleet row carries (parsed
# from the peer's /metrics exposition; the worst labeled value wins)
DEFAULT_HEADLINE_METRICS = ("obs.health.degraded", "incident.open",
                            "rest.in_flight", "rank.queue_len")


def parse_headline(metrics_text: str, names: tuple) -> dict:
    """Pull the named registry metrics out of a Prometheus exposition.
    A labeled family collapses to its MAX across label sets (headline =
    "how bad is the worst one"); histogram series are not headline
    material and never match (their rendered names carry suffixes)."""
    wanted = {prometheus_name(n): n for n in names}
    out: dict[str, float] = {}
    for line in metrics_text.splitlines():
        if not line or line.startswith("#"):
            continue
        try:
            ident, value_txt = line.rsplit(" ", 1)
        except ValueError:
            continue
        brace = ident.find("{")
        pname = ident if brace < 0 else ident[:brace]
        name = wanted.get(pname)
        if name is None:
            continue
        try:
            value = float(value_txt)
        except ValueError:
            continue
        out[name] = max(out.get(name, float("-inf")), value)
    return out


class FleetObservatory:
    """Leader-side peer poller + merged fleet verdict.

    `peers_fn` returns the live peer URL list each poll (config peers +
    the replication ack registry), so standbys that appear after boot
    are picked up without a restart.  `fetch_fn(url, timeout_s)` is the
    injectable transport (tests drive federation without sockets); the
    default is urllib with the admin dev header."""

    def __init__(self, *,
                 self_url: str = "",
                 peers: tuple = (),
                 peers_fn: Optional[Callable[[], list]] = None,
                 poll_s: float = 5.0,
                 timeout_s: float = 3.0,
                 incidents=None,
                 self_verdict_fn: Optional[Callable[[], dict]] = None,
                 cooldown_s: float = 30.0,
                 headline_metrics: tuple = DEFAULT_HEADLINE_METRICS,
                 as_user: str = "admin",
                 fetch_fn: Optional[Callable] = None):
        self.self_url = self_url.rstrip("/")
        self.peers = tuple(peers)
        self.peers_fn = peers_fn
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        self.incidents = incidents
        self.self_verdict_fn = self_verdict_fn
        self.cooldown_s = cooldown_s
        self.headline_metrics = tuple(headline_metrics)
        self.as_user = as_user
        self.fetch_fn = fetch_fn or self._fetch
        self._lock = threading.Lock()
        self._rows: dict[str, dict] = {}
        # sticky peer registry: every peer EVER seen keeps being polled.
        # The dynamic half of peers_fn is the replication ack registry,
        # and a crashed standby's acks get liveness-pruned (~30s) — if
        # the peer list merely tracked it, the dead node would vanish
        # from /debug/fleet and flip the verdict back to ok exactly when
        # peer-unreachable matters most.  forget_peer() is the explicit
        # decommission path.
        self._known: set[str] = set()
        # per-peer edge state for federated incident capture:
        # state ("ok" | reason), last capture monotonic, deferred flag
        # (an edge inside the cooldown captures when it clears — the
        # incident-recorder pending discipline)
        self._peer_state: dict[str, dict] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._polls = global_registry.counter(
            "fleet.polls", "fleet peer polls attempted, per outcome")
        self._peers_gauge = global_registry.gauge(
            "fleet.peers", "peers the fleet observatory is polling")
        self._unreachable_gauge = global_registry.gauge(
            "fleet.peer_unreachable",
            "1 while the labeled peer is unreachable from the leader")
        self._degraded_gauge = global_registry.gauge(
            "fleet.peer_degraded",
            "1 while the labeled peer reports a degraded verdict")
        self._federated = global_registry.counter(
            "fleet.federated_incidents",
            "federated incident bundles captured from peer edges")
        self._suppressed = global_registry.counter(
            "fleet.federated_suppressed",
            "peer ok->degraded edges whose capture was deferred by the "
            "per-peer cooldown")

    # ----------------------------------------------------------- transport

    def _fetch(self, url: str, timeout_s: float):
        """GET one peer endpoint; JSON bodies parse, text bodies
        (the /metrics exposition) return as str.  Raises on transport
        errors — the poller turns that into peer-unreachable."""
        req = urllib.request.Request(
            url, headers={"X-Cook-Requesting-User": self.as_user})
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            body = r.read()
            content_type = r.headers.get("Content-Type", "")
        if "json" in content_type:
            return json.loads(body)
        return body.decode(errors="replace")

    # ------------------------------------------------------------- polling

    def peer_list(self) -> list[str]:
        urls = {u.rstrip("/") for u in self.peers if u}
        if self.peers_fn is not None:
            try:
                urls |= {u.rstrip("/") for u in self.peers_fn() if u}
            except Exception:  # noqa: BLE001 — a broken registry view
                # must not stop the configured peers from being polled
                log.exception("fleet peers_fn failed")
        urls.discard(self.self_url)
        urls.discard("")
        with self._lock:
            self._known |= urls
            return sorted(self._known)

    def forget_peer(self, url: str) -> None:
        """Explicitly decommission a peer: stop polling it and drop its
        row/gauges/edge state.  (Peers are otherwise STICKY — a dead
        node keeps reporting peer-unreachable rather than vanishing.)"""
        url = url.rstrip("/")
        with self._lock:
            self._known.discard(url)
            self._rows.pop(url, None)
        self._unreachable_gauge.remove({"peer": url})
        self._degraded_gauge.remove({"peer": url})
        self._peer_state.pop(url, None)

    def poll_once(self) -> dict[str, dict]:
        """Poll every peer once; returns the refreshed row map.  Peers
        poll CONCURRENTLY — serial polling would let a few black-holed
        peers (each a full transport timeout) stretch the cycle far past
        poll_s and break the within-one-poll detection promise for the
        healthy ones.  Each peer's ok->degraded edge (or reachability
        loss) lands a federated entry in the leader's incident ring,
        cooldown-suppressed per peer."""
        import concurrent.futures

        peers = self.peer_list()
        self._peers_gauge.set(len(peers))
        if not peers:
            with self._lock:
                self._rows = {}
            return {}
        if len(peers) == 1:
            rows = {peers[0]: self._poll_peer(peers[0])}
        else:
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=min(8, len(peers)),
                    thread_name_prefix="fleet-poll") as pool:
                rows = dict(zip(peers, pool.map(self._poll_peer, peers)))
        with self._lock:
            self._rows = rows
        for url, row in rows.items():
            self._observe_edge(url, row)
        return rows

    def _poll_peer(self, url: str) -> dict:
        row: dict = {"url": url, "polled_at": time.monotonic(),
                     "wall_time": time.time()}
        try:
            verdict = self.fetch_fn(f"{url}/debug/health", self.timeout_s)
            row["ok"] = True
            row["healthy"] = bool(verdict.get("healthy", False))
            row["status"] = verdict.get("status", "unknown")
            row["reasons"] = list(verdict.get("reasons", []))
            # the contention summary rides the verdict's checks — keep
            # the headline facts, not the full per-site tables
            contention = (verdict.get("checks") or {}).get(
                "contention") or {}
            row["contention"] = {
                key: contention[key] for key in
                ("store_lock", "journal", "commit_ack")
                if key in contention}
            self._polls.inc(1, {"outcome": "ok"})
        except Exception as e:  # noqa: BLE001 — any transport/parse
            # failure is the same operational fact: the peer is not
            # observable from here
            row.update({"ok": False, "healthy": False,
                        "status": "unreachable", "reasons": [],
                        "error": f"{type(e).__name__}: {e}"})
            self._polls.inc(1, {"outcome": "unreachable"})
            self._unreachable_gauge.set(1.0, {"peer": url})
            self._degraded_gauge.set(0.0, {"peer": url})
            return row
        self._unreachable_gauge.set(0.0, {"peer": url})
        self._degraded_gauge.set(0.0 if row["healthy"] else 1.0,
                                 {"peer": url})
        # best-effort extras: a peer that serves health but trips on the
        # side endpoints still gets a row (with the facts we did get)
        try:
            replica = self.fetch_fn(f"{url}/debug/replica", self.timeout_s)
            row["staleness"] = {
                shard: r.get("staleness_ms")
                for shard, r in (replica.get("shards") or {}).items()}
        except Exception:  # noqa: BLE001
            row["staleness"] = {}
        try:
            exposition = self.fetch_fn(f"{url}/metrics", self.timeout_s)
            row["headline"] = parse_headline(str(exposition),
                                             self.headline_metrics)
        except Exception:  # noqa: BLE001
            row["headline"] = {}
        return row

    # ------------------------------------------------- federated incidents

    def _observe_edge(self, url: str, row: dict) -> None:
        reason = None
        if not row["ok"]:
            reason = PEER_UNREACHABLE
        elif not row["healthy"]:
            reason = PEER_DEGRADED
        state = self._peer_state.setdefault(
            url, {"state": "ok", "last_capture": float("-inf"),
                  "pending": False, "bundle": None})
        if reason is None:
            state["pending"] = False
            if state["state"] != "ok" and state["bundle"] is not None:
                # recovery closes the federated incident, same as the
                # recorder's own degraded->ok stamping
                state["bundle"].setdefault("recovered_time", None)
                if state["bundle"]["recovered_time"] is None:
                    state["bundle"]["recovered_time"] = time.time()
            state["state"] = "ok"
            return
        was_ok = state["state"] == "ok"
        state["state"] = reason
        if self.incidents is None:
            return
        now = time.monotonic()
        if now - state["last_capture"] < self.cooldown_s:
            if was_ok:
                # flap inside the cooldown: defer, don't drop — a
                # sustained peer outage must still get its bundle
                state["pending"] = True
                self._suppressed.inc()
            return
        if not (was_ok or state["pending"]):
            return
        state["last_capture"] = now
        state["pending"] = False
        state["bundle"] = self._capture_federated(url, row, reason)

    def _capture_federated(self, url: str, row: dict,
                           reason: str) -> Optional[dict]:
        """Land the peer's degradation in the LEADER's incident ring,
        referencing the peer's own newest bundle so the investigation
        can hop straight to the peer's evidence."""
        peer_incident_id = None
        if row["ok"]:
            try:
                index = self.fetch_fn(f"{url}/debug/incidents",
                                      self.timeout_s)
                bundles = index.get("incidents") or []
                if bundles:
                    peer_incident_id = bundles[-1].get("id")
            except Exception:  # noqa: BLE001 — the reference is a
                # convenience; the federated capture stands without it
                pass
        verdict = {
            "healthy": False,
            "status": "degraded",
            "reasons": [reason],
            "degradations": [{
                "reason": reason,
                "peer": url,
                "peer_reasons": list(row.get("reasons", [])),
                "peer_incident_id": peer_incident_id,
                "detail": (
                    f"peer {url} is unreachable from the leader "
                    f"({row.get('error', 'transport failure')})"
                    if reason == PEER_UNREACHABLE else
                    f"peer {url} reports a degraded verdict "
                    f"({', '.join(row.get('reasons', [])) or '?'}) — "
                    f"its own bundle: {peer_incident_id or 'none yet'}"),
            }],
            "federated": True,
            "peer": url,
        }
        try:
            bundle = self.incidents.capture(verdict, trigger="fleet-peer")
        except Exception:  # noqa: BLE001 — a broken collector on the
            # leader must not take the poll loop down
            log.exception("federated incident capture failed for %s", url)
            return None
        self._federated.inc()
        return bundle

    # --------------------------------------------------------------- reads

    def verdict(self) -> dict:
        """The merged fleet verdict `GET /debug/fleet` serves: one row
        per node (self first), poll-age staleness on every peer row,
        fleet-level reasons, and the worst replication shard across the
        fleet."""
        now = time.monotonic()
        with self._lock:
            rows = dict(self._rows)
        nodes = []
        if self.self_verdict_fn is not None:
            self_verdict = self.self_verdict_fn()
            nodes.append({
                "url": self.self_url or "self",
                "self": True,
                "ok": True,
                "healthy": bool(self_verdict.get("healthy", True)),
                "status": self_verdict.get("status", "unknown"),
                "reasons": list(self_verdict.get("reasons", [])),
                "poll_age_s": 0.0,
            })
        reasons: set[str] = set()
        worst_shard = None
        for url in sorted(rows):
            row = dict(rows[url])
            row["poll_age_s"] = max(0.0, now - row.pop("polled_at"))
            if not row["ok"]:
                reasons.add(PEER_UNREACHABLE)
            elif not row["healthy"]:
                reasons.add(PEER_DEGRADED)
            for shard, ms in (row.get("staleness") or {}).items():
                if ms is None:
                    continue
                if worst_shard is None \
                        or ms > worst_shard["staleness_ms"]:
                    worst_shard = {"node": url, "shard": shard,
                                   "staleness_ms": ms}
            nodes.append(row)
        for node in nodes:
            if node.get("self") and not node["healthy"]:
                reasons.update(node["reasons"])
        return {
            "enabled": True,
            "poll_s": self.poll_s,
            "self_url": self.self_url,
            "nodes": nodes,
            "peers": len(rows),
            "healthy": not reasons,
            "status": "ok" if not reasons else "degraded",
            "reasons": sorted(reasons),
            "worst_shard": worst_shard,
            "wall_time": time.time(),
        }

    # ------------------------------------------------------------- running

    def start(self) -> "FleetObservatory":
        if self.poll_s <= 0 or self._thread is not None:
            return self

        def loop():
            while not self._stop.wait(self.poll_s):
                try:
                    self.poll_once()
                except Exception:  # noqa: BLE001 — the fleet poller
                    # must survive any peer misbehavior
                    log.exception("fleet poll failed")

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="fleet-observatory")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + self.poll_s + 5)
            self._thread = None
