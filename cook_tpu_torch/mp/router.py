"""Shard-aware front end: one public endpoint over the worker fleet.

Port of `cook_tpu/mp/router.py`.  Clients talk to the front end exactly
as they would a single-process control plane; it maps each request's key
to its owning shard-group (`topology.ShardGroupTopology` over the same
stable hash the workers use) and forwards it there, preserving the
request's idempotency key (X-Cook-Txn-Id) and propagating the worker's
staleness / replication headers back out.  What lands where:

  * pool-keyed writes (POST /jobs) — split by pool; one group means a
    raw forward, several means a cross-group 2PC
    (`twopc.TwoPCCoordinator`);
  * uuid-keyed requests (kill, /jobs/{uuid}, /retry, ...) — owner
    resolved via a TTL cache backed by a parallel /rpc/resolve scatter;
  * fleet-wide reads (/queue, /running, /list, /usage, ...) —
    scatter-gather with a structural merge;
  * meta-keyed ops (/pools, /settings, config) — the group owning the
    META shard;
  * GET /debug/shards — the route map, for shard-aware clients that want
    to skip the hop.

Forwarding keeps connections alive per worker (the job client's
`Session`, the reference's pooled aiohttp session) with a per-worker
`CircuitBreaker`: transport failures open the breaker and requests for
that group fail fast with 503 + Retry-After until the cooldown's
half-open probe closes it — a dead worker degrades ONLY the keys it
owns.  The supervisor rewrites the route map on failover; the front end
re-reads it on mtime change, clears its resolve cache, and replays
outstanding 2PC decisions against the promoted standby's urls (on a
thread of its own).

Concurrency.  The app runs on the standard library's threaded server
(`rest/server.ServerThread`), whose handlers hold one loop lock in place
of aiohttp's event loop (`rest/http.py`).  Every call to a worker — a
forward, a resolve, a 2PC transaction — runs with that lock released,
as the reference awaits it, so one slow worker or one transaction holds
no other request back.  The scatter reads fan out on a small thread
pool, concurrently as the reference's `asyncio.gather`.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from cook_tpu_torch.client.jobclient import Session
from cook_tpu_torch.faults.breaker import BreakerParams, CircuitBreaker
from cook_tpu_torch.mp.topology import read_route_map, topology_of
from cook_tpu_torch.mp.twopc import DecisionLog, TwoPCCoordinator
from cook_tpu_torch.obs import distributed
from cook_tpu_torch.obs.incident import (IncidentRecorder,
                                         add_default_collectors)
from cook_tpu_torch.rest.http import (Application, LoopLock, Response,
                                     json_response)
from cook_tpu_torch.txn.transaction import new_txn_id
from cook_tpu_torch.utils import tracing
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)

_FWD_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, float("inf"))

# request headers forwarded to workers / response headers propagated
# back to the client, by prefix
_HEADER_PREFIX = "X-Cook-"
_RESP_EXTRA = ("Retry-After",)

RESOLVE_TTL_S = 30.0
MAP_CHECK_INTERVAL_S = 0.25
# the scatter pool's threads: one request's fan-out to every group at
# once, and a few such requests side by side
SCATTER_THREADS = 16

# scatter-gather read routes: ask every alive group, merge structurally
# (/pools is here because each worker registers only its OWNED pools —
# the union is the cluster's pool list)
SCATTER_ROUTES = frozenset({
    "/queue", "/running", "/list", "/unscheduled_jobs",
    "/stats/instances", "/usage", "/pools",
    # pool-keyed fairness bodies: pools are group-owned and disjoint, so
    # the dict-union merge composes them without summing anything
    "/debug/fairness",
})


def _merge(a, b):
    """Structural merge for scatter-gather replies: dicts union
    (recursing on collisions), lists concatenate, numbers sum, anything
    else keeps the first answer."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = _merge(out[k], v) if k in out else v
        return out
    if isinstance(a, list) and isinstance(b, list):
        return a + b
    if isinstance(a, bool) or isinstance(b, bool):
        return a
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a + b
    return a


# set on every forward by the front end itself
_TRACE_HEADERS = (distributed.TXN_HEADER.lower(),
                  distributed.PARENT_SPAN_HEADER.lower())


def _err(status: int, message: str, headers=None) -> Response:
    return json_response({"error": message}, status=status, headers=headers)


def _is_cook_header(name: str) -> bool:
    return name.lower().startswith(_HEADER_PREFIX.lower())


class _Reservoir:
    """Bounded latency sample for /debug/frontend percentiles."""

    def __init__(self, cap: int = 2048):
        self.cap = cap
        self.samples: list[float] = []
        self.count = 0
        self._lock = threading.Lock()

    def add(self, value: float) -> None:
        with self._lock:
            self.count += 1
            if len(self.samples) < self.cap:
                self.samples.append(value)
            else:
                self.samples[self.count % self.cap] = value

    def quantile(self, q: float) -> float:
        with self._lock:
            if not self.samples:
                return 0.0
            ordered = sorted(self.samples)
            return ordered[min(len(ordered) - 1,
                               int(q * len(ordered)))]


class FrontEnd:
    """ServerThread-compatible (build_app) forwarding app."""

    def __init__(self, route_map_path: Optional[str] = None, *,
                 route_map: Optional[dict] = None,
                 decision_log_path: Optional[str] = None,
                 default_pool: str = "default",
                 rpc_timeout_s: float = 10.0,
                 forward_timeout_s: float = 30.0,
                 breaker_params: Optional[BreakerParams] = None):
        if route_map is None and route_map_path is None:
            raise ValueError("need route_map or route_map_path")
        self.route_map_path = route_map_path
        self._map = route_map or read_route_map(route_map_path)
        if self._map is None:
            raise ValueError(f"no route map at {route_map_path}")
        self._map_mtime = (os.path.getmtime(route_map_path)
                           if route_map_path
                           and os.path.exists(route_map_path) else 0.0)
        self._map_checked = 0.0
        self._map_lock = threading.Lock()
        self.topology = topology_of(self._map)
        self.default_pool = default_pool
        self.forward_timeout_s = forward_timeout_s
        # the event loop's stand-in: held by every handler, released
        # around every call to a worker
        self.loop = LoopLock()
        self._http = Session(per_host=16)
        self._scatter = ThreadPoolExecutor(
            max_workers=SCATTER_THREADS, thread_name_prefix="mp-scatter")
        params = breaker_params or BreakerParams(
            window=20, min_samples=5, error_threshold=0.5, cooldown_s=2.0)
        self.breakers = {g: CircuitBreaker(f"worker-{g}", params)
                         for g in range(self.topology.n_groups)}
        decisions = DecisionLog(
            decision_log_path
            or os.path.join(tempfile.gettempdir(),
                            f"cook-2pc-{os.getpid()}.jsonl"))
        self.decisions = decisions
        self.coordinator = TwoPCCoordinator(
            self._post_json, decisions, rpc_timeout_s=rpc_timeout_s)
        self._resolve_cache: dict[str, tuple[int, float]] = {}
        self._latency = {g: _Reservoir()
                         for g in range(self.topology.n_groups)}
        self._twopc_stats = {"commits": 0, "vetoes": 0, "errors": 0}
        # per-(group, hop) forward-time split: queue / transport /
        # apply / fsync / replication_ack (obs/distributed.py)
        self.hops = distributed.HopAttribution()
        # federated mp incidents: the supervisor's fleet observatory
        # points at this recorder (MpRuntime wiring), so a worker's
        # ok->degraded edge captures the decision-log tail, breaker
        # states, and route map in ONE bundle alongside the standard
        # trace/faults evidence
        self.incidents = add_default_collectors(IncidentRecorder())
        distributed.add_mp_collectors(
            self.incidents, decision_log_path=decisions.path,
            breakers_fn=lambda: {str(g): b.state.value
                                 for g, b in self.breakers.items()},
            route_map_fn=lambda: dict(self._map))
        self._forward_seconds = global_registry.histogram(
            "mp.forward_seconds",
            "front-end forward round-trip seconds per shard-group",
            buckets=_FWD_BUCKETS)
        self._forwarded = global_registry.counter(
            "mp.forwarded",
            "front-end forwarded requests per group and outcome "
            "(ok/error/breaker_open)")
        self._resolves = global_registry.counter(
            "mp.resolve.lookups",
            "uuid -> owning-group resolutions per source "
            "(cache/scatter/miss)")

    # --------------------------------------------------------- route map

    def _maybe_reload_map(self) -> None:
        if not self.route_map_path:
            return
        now = time.monotonic()
        with self._map_lock:
            if now - self._map_checked < MAP_CHECK_INTERVAL_S:
                return
            self._map_checked = now
        try:
            mtime = os.path.getmtime(self.route_map_path)
        except OSError:
            return
        if mtime == self._map_mtime:
            return
        new_map = read_route_map(self.route_map_path)
        if new_map is None:
            return
        with self._map_lock:
            self._map = new_map
            self._map_mtime = mtime
            # entity ownership may have moved with the segments
            self._resolve_cache.clear()
        log.info("route map reloaded (map_seq=%s)",
                 new_map.get("map_seq"))
        # finish any decision whose participant moved to a new url
        threading.Thread(target=self._replay, args=(self._rpc_urls(),),
                         daemon=True, name="mp-2pc-replay").start()

    def _replay(self, rpc_urls: dict[int, str]) -> None:
        try:
            self.coordinator.replay(rpc_urls)
        except Exception:  # noqa: BLE001 — a failed replay leaves the
            # decisions outstanding for the next one
            log.exception("2pc replay failed")

    def _entry(self, group: int) -> dict:
        return self._map["groups"][group]

    def _rpc_urls(self) -> dict[int, str]:
        return {e["group"]: e["rpc_url"] for e in self._map["groups"]
                if e.get("rpc_url")}

    def _alive_groups(self) -> list[int]:
        return [e["group"] for e in self._map["groups"] if e["alive"]]

    # --------------------------------------------------------- transport

    def _gather(self, calls) -> list:
        """Run every call at once on the scatter pool, with the loop
        lock released; their results in order."""
        with self.loop.released():
            futures = [self._scatter.submit(call) for call in calls]
            return [f.result() for f in futures]

    def _post_json(self, url: str, body: dict, timeout_s: float,
                   headers: Optional[dict] = None) -> tuple[int, dict]:
        """The 2PC transport (twopc.PostFn); `headers` carry the
        coordinator's trace context (X-Cook-Txn-Id +
        X-Cook-Parent-Span)."""
        resp = self._http.send(
            "POST", url, body=json.dumps(body).encode("utf-8"),
            headers={"Content-Type": "application/json", **(headers or {})},
            timeout=timeout_s)
        status, raw = resp.status_code, resp.content
        try:
            payload = json.loads(raw)
        except ValueError:  # non-JSON reply
            payload = {"ok": False,
                       "error": raw.decode("utf-8", "replace")[:200]}
        return status, payload

    def _forward(self, group: int, request, *, path: Optional[str] = None,
                 body: Optional[bytes] = None) -> Response:
        """Forward `request` to `group`'s worker, preserving X-Cook-*
        headers both ways and stamping X-Cook-Shard-Group."""
        breaker = self.breakers[group]
        if not breaker.allows_work():
            self._forwarded.inc(1, {"group": str(group),
                                    "outcome": "breaker_open"})
            return _err(503, f"shard-group {group} unavailable (circuit "
                        f"open)", headers={"Retry-After": "2",
                                           "X-Cook-Shard-Group": str(group)})
        entry = self._entry(group)
        if not entry["alive"] or not entry["url"]:
            self._forwarded.inc(1, {"group": str(group),
                                    "outcome": "error"})
            return _err(503, f"shard-group {group} has no live worker",
                        headers={"Retry-After": "2",
                                 "X-Cook-Shard-Group": str(group)})
        target = entry["url"] + (path if path is not None
                                 else request.path_qs)
        # trace context on EVERY forward: a client-provided txn id is
        # preserved (it is also the idempotency key); one is minted
        # otherwise so the hop is traceable end to end.  The worker
        # opens its server-side span under our forward span.
        txn_id = request.headers.get(distributed.TXN_HEADER) or new_txn_id()
        headers = {k: v for k, v in request.headers.items()
                   if (_is_cook_header(k) or k.lower() == "content-type")
                   and k.lower() not in _TRACE_HEADERS}
        headers[distributed.TXN_HEADER] = txn_id
        headers[distributed.PARENT_SPAN_HEADER] = "mp.forward"
        if body is None and request.can_read_body:
            body = request.body
        t0 = time.perf_counter()
        # front-end queue hop: arrival (stamped by _map_middleware) to
        # forward start — resolve scatters, body reads, map reloads
        queue_s = max(0.0, t0 - request.get("t_arrival", t0))
        try:
            with self.loop.released():
                resp = self._http.send(
                    request.method, target, body=body, headers=headers,
                    timeout=self.forward_timeout_s)
        except Exception as e:  # noqa: BLE001 — transport failure, not
            # an app error: the worker is unreachable
            breaker.note_failure()
            self._forwarded.inc(1, {"group": str(group),
                                    "outcome": "error"})
            tracing.record_span(
                "mp.forward", time.perf_counter() - t0, group=group,
                txn_id=txn_id, error=True,
                process=distributed.PROCESS_FRONTEND)
            return _err(502, f"shard-group {group} unreachable: "
                        f"{type(e).__name__}",
                        headers={"X-Cook-Shard-Group": str(group)})
        elapsed = time.perf_counter() - t0
        status, resp_headers, payload = (resp.status_code,
                                         resp.headers.items(), resp.content)
        breaker.note_success()
        self._latency[group].add(elapsed)
        self._forward_seconds.observe(elapsed, {"group": str(group)})
        self._forwarded.inc(1, {"group": str(group), "outcome": "ok"})
        resp_map = {k.lower(): v for k, v in resp_headers}
        self.hops.attribute(
            group, total_s=elapsed, queue_s=queue_s,
            walls=distributed.parse_hop_walls(
                resp_map.get(distributed.HOP_WALLS_HEADER.lower())))
        tracing.record_span(
            "mp.forward", elapsed, group=group, txn_id=txn_id,
            process=distributed.PROCESS_FRONTEND)
        out_headers = {k: v for k, v in resp_headers
                       if _is_cook_header(k) or k in _RESP_EXTRA}
        out_headers["X-Cook-Shard-Group"] = str(group)
        if distributed.TXN_HEADER.lower() not in {
                k.lower() for k in out_headers}:
            out_headers[distributed.TXN_HEADER] = txn_id
        content_type = resp_map.get("content-type")
        if content_type:
            out_headers["Content-Type"] = content_type
        return Response(
            body=payload, status=status, headers=out_headers,
            content_type=(content_type or "").split(";")[0] or None)

    # -------------------------------------------------------- resolution

    def _resolve_uuids(self, uuids) -> dict[str, int]:
        """uuid -> owning group, TTL cache over a parallel
        /rpc/resolve scatter.  Unknown uuids are absent from the
        result."""
        now = time.monotonic()
        owners: dict[str, int] = {}
        missing: list[str] = []
        for uuid in uuids:
            cached = self._resolve_cache.get(uuid)
            if cached is not None and now - cached[1] < RESOLVE_TTL_S:
                owners[uuid] = cached[0]
                self._resolves.inc(1, {"source": "cache"})
            else:
                missing.append(uuid)
        if not missing:
            return owners
        query = urllib.parse.urlencode([("uuid", u) for u in missing])

        def ask(group: int) -> tuple[int, dict]:
            rpc = self._entry(group).get("rpc_url", "")
            if not rpc:
                return group, {}
            try:
                raw = self._http.send("GET", f"{rpc}/rpc/resolve?{query}",
                                      timeout=3.0).content
                return group, json.loads(raw).get("owned", {})
            except Exception:  # noqa: BLE001 — dead worker: its keys
                # resolve nowhere until the standby adopts
                return group, {}

        replies = self._gather(
            [lambda g=g: ask(g) for g in self._alive_groups()])
        for group, owned in replies:
            for uuid in owned:
                owners[uuid] = group
                self._resolve_cache[uuid] = (group, now)
                self._resolves.inc(1, {"source": "scatter"})
        for uuid in missing:
            if uuid not in owners:
                self._resolves.inc(1, {"source": "miss"})
        return owners

    # ---------------------------------------------------------- handlers

    def post_jobs(self, request) -> Response:
        body_bytes = request.body
        try:
            body = json.loads(body_bytes or b"{}")
        except ValueError:
            return _err(400, "request body must be valid JSON")
        specs = body.get("jobs", [])
        group_specs = body.get("groups", [])
        by_group: dict[int, list] = {}
        for spec in specs:
            pool = spec.get("pool") or self.default_pool
            by_group.setdefault(
                self.topology.group_for_pool(pool), []).append(spec)
        if len(by_group) <= 1:
            # one owner: raw forward, headers (txn id) and body intact
            g = next(iter(by_group), self.topology.meta_group)
            return self._forward(g, request, body=body_bytes)
        # cross-group: pin uuids here so the per-group payloads are
        # stable under 2PC replay
        from cook_tpu_torch.models.entities import new_uuid

        for spec in specs:
            spec.setdefault("uuid", new_uuid())
        txn_id = request.headers.get("X-Cook-Txn-Id") or new_txn_id()
        user = request.headers.get("X-Cook-Requesting-User", "")
        lowest = min(by_group)
        per_group = {
            g: {"jobs": gspecs,
                # explicit group specs ride the lowest group (the
                # single-process plan's convention); other participants
                # materialize implicit groups from job references
                "groups": group_specs if g == lowest else []}
            for g, gspecs in sorted(by_group.items())}
        t0 = time.perf_counter()
        with self.loop.released():
            outcome = self.coordinator.run(
                txn_id=txn_id, op="jobs/submit", user=user,
                per_group=per_group, rpc_urls=self._rpc_urls())
        # the front-end track of the 2PC waterfall (the coordinator's
        # phase spans ride their own pid track)
        tracing.record_span(
            "mp.submit_2pc", time.perf_counter() - t0, txn_id=txn_id,
            groups=len(per_group), process=distributed.PROCESS_FRONTEND,
            **({} if outcome["ok"] else {"error": True}))
        if not outcome["ok"]:
            self._twopc_stats["vetoes" if outcome["status"] < 500
                              else "errors"] += 1
            return _err(outcome["status"], outcome["error"])
        self._twopc_stats["commits"] += 1
        uuids: list[str] = []
        for g in sorted(outcome["results"]):
            uuids.extend(
                outcome["results"][g].get("result", {}).get("jobs", []))
        return json_response(
            {"jobs": uuids}, status=201,
            headers={"X-Cook-Txn-Id": txn_id,
                     "X-Cook-Shard-Group":
                         ",".join(str(g) for g in sorted(per_group))})

    def delete_jobs(self, request) -> Response:
        uuids = request.query.getall("job", []) \
            + request.query.getall("uuid", [])
        owners = self._resolve_uuids(uuids)
        unknown = [u for u in uuids if u not in owners]
        if unknown:
            return _err(404, f"unknown jobs: {unknown}")
        groups = sorted(set(owners.values()))
        if len(groups) <= 1:
            g = groups[0] if groups else self.topology.meta_group
            return self._forward(g, request)
        txn_id = request.headers.get("X-Cook-Txn-Id") or new_txn_id()
        user = request.headers.get("X-Cook-Requesting-User", "")
        per_group = {g: {"uuids": [u for u in uuids if owners[u] == g]}
                     for g in groups}
        t0 = time.perf_counter()
        with self.loop.released():
            outcome = self.coordinator.run(
                txn_id=txn_id, op="jobs/kill", user=user,
                per_group=per_group, rpc_urls=self._rpc_urls())
        tracing.record_span(
            "mp.kill_2pc", time.perf_counter() - t0, txn_id=txn_id,
            groups=len(per_group), process=distributed.PROCESS_FRONTEND,
            **({} if outcome["ok"] else {"error": True}))
        if not outcome["ok"]:
            self._twopc_stats["vetoes" if outcome["status"] < 500
                              else "errors"] += 1
            return _err(outcome["status"], outcome["error"])
        self._twopc_stats["commits"] += 1
        return Response(status=204, headers={"X-Cook-Txn-Id": txn_id})

    def by_uuid(self, request) -> Response:
        """Requests keyed by entity uuid (path segment, query params, or
        JSON body `job` field): resolve the owner, forward there."""
        uuids = [u for u in (request.match_info.get("uuid"),) if u]
        for param in ("uuid", "job", "instance"):
            uuids.extend(request.query.getall(param, []))
        body = None
        if not uuids and request.can_read_body:
            body = request.body
            try:
                parsed = json.loads(body or b"{}")
                for field in ("job", "uuid", "jobs"):
                    value = parsed.get(field)
                    if isinstance(value, str):
                        uuids.append(value)
                    elif isinstance(value, list):
                        uuids.extend(value)
            except (ValueError, AttributeError):
                pass
        if not uuids:
            return self._forward(self.topology.meta_group, request,
                                 body=body)
        owners = self._resolve_uuids(uuids)
        if not owners:
            return _err(404, f"unknown entity: {uuids}")
        groups = sorted(set(owners.values()))
        if len(groups) > 1:
            return _err(400, "entities span shard-groups; issue one "
                        "request per group")
        return self._forward(groups[0], request, body=body)

    def by_user(self, request) -> Response:
        """share/quota: keyed by pool when given, else by user (the
        ShardRouter plan's convention)."""
        body = None
        pool = request.query.get("pool")
        user = request.query.get("user")
        if request.can_read_body:
            body = request.body
            try:
                parsed = json.loads(body or b"{}")
                pool = pool or parsed.get("pool")
                user = user or parsed.get("user")
            except (ValueError, AttributeError):
                pass
        if pool:
            g = self.topology.group_for_pool(pool)
        elif user:
            g = self.topology.group_for_user(user)
        else:
            g = self.topology.meta_group
        return self._forward(g, request, body=body)

    def scatter(self, request) -> Response:
        """Fleet-wide read: ask every alive group, merge structurally,
        stamp the WORST staleness seen (a merged read is only as fresh
        as its stalest contributor)."""
        alive = self._alive_groups()
        replies = self._gather(
            [lambda g=g: self._forward(g, request) for g in alive])
        merged = None
        worst_staleness = -1.0
        errors = []
        for g, resp in zip(alive, replies):
            if resp.status >= 400:
                errors.append(g)
                continue
            try:
                part = json.loads(resp.body or b"null")
            except ValueError:
                continue
            merged = part if merged is None else _merge(merged, part)
            staleness = resp.headers.get("X-Cook-Staleness-Ms")
            if staleness is not None:
                worst_staleness = max(worst_staleness, float(staleness))
        if merged is None:
            return _err(502, f"no shard-group answered (failed: {errors})")
        headers = {}
        if worst_staleness >= 0:
            headers["X-Cook-Staleness-Ms"] = str(worst_staleness)
        if errors:
            headers["X-Cook-Partial-Groups"] = \
                ",".join(str(g) for g in errors)
        return json_response(merged, headers=headers)

    def to_meta(self, request) -> Response:
        return self._forward(self.topology.meta_group, request)

    def get_metrics(self, request) -> Response:
        # the front end's OWN registry (forward/2pc/breaker series);
        # worker registries are scraped at the workers
        return Response(text=global_registry.render_prometheus(),
                        content_type="text/plain")

    def get_debug_shards(self, request) -> Response:
        with self._map_lock:
            route_map = dict(self._map)
        route_map["breakers"] = {
            str(g): b.state.value for g, b in self.breakers.items()}
        return json_response(route_map)

    def get_debug_frontend(self, request) -> Response:
        per_group = {}
        for g, reservoir in self._latency.items():
            per_group[str(g)] = {
                "forwarded": reservoir.count,
                "p50_ms": round(reservoir.quantile(0.5) * 1e3, 3),
                "p99_ms": round(reservoir.quantile(0.99) * 1e3, 3),
                "breaker": self.breakers[g].state.value,
                "alive": self._entry(g)["alive"],
                # forward time split by hop (queue / transport / apply /
                # fsync / replication_ack), from the worker's
                # X-Cook-Hop-Walls response headers
                "hops": self.hops.snapshot(g),
            }
        return json_response({
            "map_seq": self._map.get("map_seq"),
            "n_groups": self.topology.n_groups,
            "n_shards": self.topology.n_shards,
            "per_group": per_group,
            "twopc": dict(self._twopc_stats),
            "resolve_cache": len(self._resolve_cache),
        })

    def get_debug_trace(self, request) -> Response:
        """Federated trace collection: scatter GET /debug/trace?txn_id=
        to every live group, merge the slices with the front end's own
        spans (dedup + per-process pid tracks), and emit ONE
        Chrome-trace file (`?format=raw` for the merged ring entries).
        A txn id is required — the whole-ring export lives on the
        workers; this endpoint answers "show me THIS request's
        cross-process critical path"."""
        txn_id = request.query.get("txn_id")
        if not txn_id:
            return _err(400, "txn_id is required (per-transaction merged "
                        "trace; whole-ring exports live on the workers' "
                        "/debug/trace)")
        fmt = request.query.get("format", "chrome")
        if fmt not in ("chrome", "raw"):
            return _err(400, f"unknown format {fmt!r} (chrome | raw)")
        sources = [{"process": distributed.PROCESS_FRONTEND,
                    "spans": tracing.spans_for_txn(txn_id)}]
        alive = self._alive_groups()
        worker_path = "/debug/trace?" + urllib.parse.urlencode(
            {"txn_id": txn_id, "format": "raw"})
        replies = self._gather(
            [lambda g=g: self._forward(g, request, path=worker_path)
             for g in alive])
        failed: list[int] = []
        for g, resp in zip(alive, replies):
            if resp.status != 200:
                failed.append(g)
                continue
            try:
                payload = json.loads(resp.body or b"{}")
            except ValueError:
                failed.append(g)
                continue
            sources.append({
                "process": (payload.get("process")
                            or distributed.worker_process_label(g)),
                "spans": payload.get("spans") or []})
        merged = distributed.merge_process_traces(sources)
        distributed.note_collection(
            "empty" if not merged else
            "partial" if failed else "merged")
        if fmt == "raw":
            return json_response({"txn_id": txn_id, "spans": merged,
                          "groups_asked": alive, "groups_failed": failed})
        return json_response(distributed.merged_chrome_trace(merged))

    def get_debug_incidents(self, request) -> Response:
        """The front end's OWN federated incident index (worker-local
        bundles stay on the workers' /debug/incidents)."""
        return json_response({
            "incidents": self.incidents.bundles(),
            "capacity": self.incidents.capacity,
            "cooldown_s": self.incidents.cooldown_s,
            "dir": self.incidents.dir,
        })

    def get_debug_incident(self, request) -> Response:
        incident_id = request.match_info["incident_id"]
        bundle = self.incidents.get(incident_id)
        if bundle is None:
            return _err(404, f"incident {incident_id} not retained")
        return json_response(bundle, dumps=lambda d: json.dumps(
            d, default=str))

    def get_job_timeline(self, request) -> Response:
        """/jobs/{uuid}/timeline with the cross-group hop stitched in:
        the owning worker renders the job's lifecycle, and when the job
        arrived via a cross-group 2PC the commit decision's prepare
        walls / decision / done timestamps (decision log) are folded
        into the event stream (obs/distributed.py
        stitch_twopc_events)."""
        uuid = request.match_info.get("uuid", "")
        owners = self._resolve_uuids([uuid])
        if uuid not in owners:
            return _err(404, f"unknown entity: ['{uuid}']")
        resp = self._forward(owners[uuid], request)
        if resp.status != 200:
            return resp
        with self.loop.released():
            record, done_t = self.decisions.find_for_uuid(uuid)
        if record is None:
            return resp  # single-group job: the worker's view is whole
        try:
            timeline = json.loads(resp.body or b"{}")
        except ValueError:
            return resp
        out_headers = {k: v for k, v in resp.headers.items()
                       if _is_cook_header(k)}
        return json_response(
            distributed.stitch_twopc_events(timeline, record, done_t),
            headers=out_headers)

    def get_debug_health(self, request) -> Response:
        alive = self._alive_groups()
        replies = self._gather(
            [lambda g=g: self._forward(g, request) for g in alive])
        per_group, worst = {}, 200
        for g, resp in zip(alive, replies):
            try:
                per_group[str(g)] = json.loads(resp.body or b"{}")
            except ValueError:
                per_group[str(g)] = {"error": resp.status}
            worst = max(worst, resp.status)
        dead = [e["group"] for e in self._map["groups"]
                if not e["alive"]]
        if dead:
            worst = max(worst, 503)
        return json_response({"groups": per_group, "dead_groups": dead},
                     status=worst)

    def post_pool_move(self, request) -> Response:
        body = request.body
        try:
            parsed = json.loads(body or b"{}")
        except ValueError:
            parsed = {}
        dest = parsed.get("pool", "")
        uuids = parsed.get("jobs") or \
            ([parsed["job"]] if parsed.get("job") else [])
        owners = self._resolve_uuids(uuids)
        groups = sorted(set(owners.values()))
        if dest and groups and \
                any(self.topology.group_for_pool(dest) != g
                    for g in groups):
            # moving a job between shard-groups means moving it between
            # journal segments — out of scope for this runtime
            # (ROADMAP: cross-group rebalancing)
            return _err(501, "pool-move across shard-groups is not "
                        "supported by the mp runtime")
        g = groups[0] if groups else self.topology.meta_group
        return self._forward(g, request, body=body)

    # -------------------------------------------------------------- app

    def _map_middleware(self, request, handler):
        # arrival stamp: everything between here and the forward's
        # request is the "queue" hop of the per-hop split
        request["t_arrival"] = time.perf_counter()
        self._maybe_reload_map()
        return handler(request)

    def build_app(self) -> Application:
        app = Application(middlewares=[self._map_middleware],
                          loop=self.loop)
        r = app.router
        for path in ("/rawscheduler", "/jobs"):
            r.add_post(path, self.post_jobs)
            r.add_delete(path, self.delete_jobs)
            r.add_get(path, self.by_uuid)
        r.add_get("/jobs/{uuid}", self.by_uuid)
        r.add_get("/jobs/{uuid}/timeline", self.get_job_timeline)
        r.add_get("/instances/{uuid}", self.by_uuid)
        r.add_get("/instances", self.by_uuid)
        r.add_delete("/instances", self.by_uuid)
        r.add_get("/group", self.by_uuid)
        r.add_delete("/group", self.by_uuid)
        r.add_get("/retry", self.by_uuid)
        r.add_post("/retry", self.by_uuid)
        r.add_put("/retry", self.by_uuid)
        r.add_get("/progress/{uuid}", self.by_uuid)
        r.add_post("/progress/{uuid}", self.by_uuid)
        r.add_post("/heartbeat/{uuid}", self.by_uuid)
        r.add_post("/pool-move", self.post_pool_move)
        for path in ("/share", "/quota"):
            r.add_get(path, self.by_user)
            r.add_post(path, self.by_user)
            r.add_delete(path, self.by_user)
        for path in sorted(SCATTER_ROUTES):
            r.add_get(path, self.scatter)
        r.add_get("/metrics", self.get_metrics)
        r.add_get("/debug/shards", self.get_debug_shards)
        r.add_get("/debug/frontend", self.get_debug_frontend)
        r.add_get("/debug/health", self.get_debug_health)
        r.add_get("/debug/trace", self.get_debug_trace)
        r.add_get("/debug/incidents", self.get_debug_incidents)
        r.add_get("/debug/incidents/{incident_id}",
                  self.get_debug_incident)
        # everything else (pools/settings/info/config/debug) lives on
        # the meta group
        r.add_route("*", "/{tail:.*}", self.to_meta)
        # the reference's on_startup: finish what an earlier front end
        # decided before serving
        self.coordinator.replay(self._rpc_urls())
        return app

    def on_cleanup(self) -> None:
        """The reference's on_cleanup, run by `ServerThread.stop` once no
        request runs."""
        self._scatter.shutdown(wait=True)
        self._http.close()
        self.coordinator.decisions.close()
