"""JobClient: the programmatic REST client.

Port of `cook_tpu/client/jobclient.py` (Cook's Python cookclient
`JobClient`, jobclient/python/cookclient/__init__.py: submit returns
uuids, query returns job dicts, kill, wait-for-completion polling loop
with backoff; and the Java client's retry semantics).

The reference rides on `requests`; a submit host of the port need not
have it (the card's machine has none), so the client talks over the
standard library: `Session` keeps HTTP/1.1 connections alive per address
as `requests.Session` does, follows redirects as it does (a standby's 307
to its leader), and answers with a `Response` carrying the four names the
client and the `cs` CLI read (`status_code`, `headers`, `text`, `json()`).
Transport failures raise `RequestError`: `ConnectError` when no answer
came back, `ReadTimeout` when the server did not answer in time.
"""
from __future__ import annotations

import http.client
import json as json_mod
import threading
import time
import urllib.parse
import uuid as uuid_mod
from typing import Any, Callable, Optional, Sequence

from cook_tpu_torch.client.models import InstanceView, JobView


class RequestError(OSError):
    """A transport failure: no HTTP answer (requests' RequestException)."""


class ConnectError(RequestError):
    """The connection failed or broke before an answer came back."""


class ReadTimeout(RequestError):
    """Connected, but no answer within the timeout."""


# the statuses a Session follows to their Location, as requests does: 307
# and 308 resend the method and body, the others turn a POST into a GET
_REDIRECTS = (301, 302, 303, 307, 308)
MAX_REDIRECTS = 30


class Response:
    def __init__(self, status_code: int, headers: http.client.HTTPMessage,
                 content: bytes, url: str):
        self.status_code = status_code
        # case-insensitive `get`, as requests' header map
        self.headers = headers
        self.content = content
        self.url = url

    @property
    def text(self) -> str:
        return self.content.decode("utf-8", errors="replace")

    def json(self) -> Any:
        return json_mod.loads(self.content)


def _encode_params(params) -> str:
    """requests' query encoding: a dict or (name, value) pairs, None
    values left out, every value through str()."""
    if not params:
        return ""
    items = params.items() if isinstance(params, dict) else params
    return urllib.parse.urlencode(
        [(k, str(v)) for k, v in items if v is not None])


class Session:
    """Keep-alive HTTP/1.1 connections per address (`requests.Session`'s
    pool; the mp front end forwards on one too).  A connection is checked
    out for one request and back in once its response is read, at most
    `per_host` idle ones kept per address.  `http.client` sends a
    request's head and body in one write and sets TCP_NODELAY, so a
    keep-alive request waits on no delayed ACK.  A request that fails on
    a reused connection before any answer (the server closed it while it
    sat idle) is sent once more on a fresh one.  `headers` go on every
    `request`."""

    def __init__(self, per_host: int = 10):
        self.headers: dict[str, str] = {}
        self.per_host = per_host
        self._idle: dict[tuple, list] = {}
        self._lock = threading.Lock()
        self._closed = False

    def _checkout(self, key: tuple, timeout: float):
        with self._lock:
            idle = self._idle.get(key)
            if idle:
                conn = idle.pop()
                conn.timeout = timeout
                if conn.sock is not None:
                    conn.sock.settimeout(timeout)
                return conn, True
        scheme, host, port = key
        cls = (http.client.HTTPSConnection if scheme == "https"
               else http.client.HTTPConnection)
        return cls(host, port, timeout=timeout), False

    def _checkin(self, key: tuple, conn) -> None:
        with self._lock:
            idle = self._idle.setdefault(key, [])
            if not self._closed and len(idle) < self.per_host:
                idle.append(conn)
                return
        conn.close()

    def send(self, method: str, url: str, *, body: Optional[bytes] = None,
             headers: Optional[dict] = None,
             timeout: float = 30.0) -> Response:
        """One request as given: no redirect followed, no session
        headers added."""
        headers = headers or {}
        parts = urllib.parse.urlsplit(url)
        if parts.scheme not in ("http", "https") or not parts.hostname:
            raise ConnectError(f"not an http url: {url!r}")
        key = (parts.scheme, parts.hostname, parts.port)
        path = (parts.path or "/") + (f"?{parts.query}" if parts.query
                                      else "")
        while True:
            conn, reused = self._checkout(key, timeout)
            try:
                if conn.sock is None:
                    conn.connect()
            except OSError as e:
                conn.close()
                raise ConnectError(f"{method} {url}: {e}") from e
            try:
                conn.request(method, path, body=body, headers=headers)
                resp = conn.getresponse()
                payload = resp.read()
            except TimeoutError as e:
                conn.close()
                raise ReadTimeout(f"{method} {url}: {e}") from e
            except (ConnectionResetError, BrokenPipeError,
                    http.client.BadStatusLine) as e:
                conn.close()
                if reused:
                    continue
                raise ConnectError(f"{method} {url}: {e!r}") from e
            except (OSError, http.client.HTTPException) as e:
                conn.close()
                raise ConnectError(f"{method} {url}: {e!r}") from e
            except BaseException:
                conn.close()
                raise
            if resp.will_close:
                conn.close()
            else:
                self._checkin(key, conn)
            return Response(resp.status, resp.msg, payload, url)

    def request(self, method: str, url: str, *, params=None, json=None,
                headers: Optional[dict] = None,
                timeout: float = 30.0) -> Response:
        query = _encode_params(params)
        if query:
            url += ("&" if "?" in url else "?") + query
        merged = {**self.headers, **(headers or {})}
        body = None
        if json is not None:
            body = json_mod.dumps(json).encode("utf-8")
            merged.setdefault("Content-Type", "application/json")
        for _ in range(MAX_REDIRECTS + 1):
            resp = self.send(method.upper(), url, body=body, headers=merged,
                             timeout=timeout)
            location = resp.headers.get("Location")
            if resp.status_code not in _REDIRECTS or not location:
                return resp
            url = urllib.parse.urljoin(url, location)
            if resp.status_code not in (307, 308) and method.upper() != "HEAD":
                method, body = "GET", None
                merged.pop("Content-Type", None)
        raise ConnectError(f"more than {MAX_REDIRECTS} redirects: {url}")

    def get(self, url: str, **kw) -> Response:
        return self.request("GET", url, **kw)

    def post(self, url: str, **kw) -> Response:
        return self.request("POST", url, **kw)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            conns = [c for idle in self._idle.values() for c in idle]
            self._idle.clear()
        for conn in conns:
            conn.close()


class JobClientError(Exception):
    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


ROUTE_MAP_TTL_S = 10.0


class JobClient:
    def __init__(
        self,
        url: str,
        *,
        user: str = "anonymous",
        session: Optional[Session] = None,
        retries: int = 3,
        retry_backoff_s: float = 0.2,
        direct_reads: bool = False,
        max_staleness_ms: float = 5000.0,
    ):
        self.url = url.rstrip("/")
        self.user = user
        self.session = session or Session()
        self.retries = retries
        self.retry_backoff_s = retry_backoff_s
        # shard-aware direct reads (the mp runtime, cook_tpu_torch/mp/):
        # the client fetches the route map from the front end's
        # GET /debug/shards, remembers which shard-group owns each uuid
        # (learned from the X-Cook-Shard-Group response header), and
        # sends read polls (query/wait) straight to the owning worker —
        # skipping the forwarding hop.  Any direct miss (connection
        # error, 404/421 from a moved segment, a staleness header past
        # `max_staleness_ms`) falls back to the front end and drops the
        # cached mapping.  Off by default: against a single-process
        # server /debug/shards 404s once and direct routing stays off.
        self.direct_reads = direct_reads
        self.max_staleness_ms = max_staleness_ms
        self._route_map: Optional[dict] = None
        self._route_map_at = 0.0
        self._uuid_group: dict[str, int] = {}

    # ------------------------------------------------------------- plumbing

    def _headers(self) -> dict:
        return {"X-Cook-Requesting-User": self.user}

    # ------------------------------------------------------ direct routing

    def _group_url(self, group: Optional[int]) -> Optional[str]:
        """The live worker url for a shard-group, from a TTL-cached
        route map; None turns the caller into a front-end request."""
        if group is None or not self.direct_reads:
            return None
        now = time.monotonic()
        if self._route_map is None \
                or now - self._route_map_at > ROUTE_MAP_TTL_S:
            try:
                resp = self.session.get(
                    f"{self.url}/debug/shards",
                    headers=self._headers(), timeout=10)
                if resp.status_code != 200:
                    self.direct_reads = False  # not an mp front end
                    return None
                self._route_map = resp.json()
                self._route_map_at = now
            except RequestError:
                return None
        for entry in self._route_map.get("groups", []):
            if entry["group"] == group:
                return entry["url"] if entry.get("alive") else None
        return None

    def _learn_owner(self, resp, uuids: Sequence[str]) -> None:
        """Remember uuid -> shard-group from the response header the
        front end (and workers via it) stamp on every reply."""
        if not self.direct_reads:
            return
        header = resp.headers.get("X-Cook-Shard-Group", "")
        if not header or "," in header:  # multi-group (2PC) reply
            return
        try:
            group = int(header)
        except ValueError:
            return
        for uuid in uuids:
            self._uuid_group[uuid] = group

    def _drop_owner(self, uuids: Sequence[str]) -> None:
        self._route_map = None  # refetch: the fleet may have failed over
        for uuid in uuids:
            self._uuid_group.pop(uuid, None)

    def _direct_get(self, path: str, uuids: Sequence[str],
                    **kw) -> Optional[Response]:
        """One direct read against the owning worker; None means route
        through the front end instead (and on a miss the mapping is
        dropped so the next poll re-learns)."""
        groups = {self._uuid_group.get(u) for u in uuids}
        if len(groups) != 1 or None in groups:
            return None
        base = self._group_url(groups.pop())
        if base is None:
            return None
        try:
            resp = self.session.get(f"{base}{path}",
                                    headers=self._headers(),
                                    timeout=30, **kw)
        except RequestError:
            self._drop_owner(uuids)
            return None
        if resp.status_code in (404, 421) or resp.status_code >= 500:
            # stale map: the segment moved (421 Misdirected / adopted
            # elsewhere) or the worker is mid-failover
            self._drop_owner(uuids)
            return None
        staleness = resp.headers.get("X-Cook-Staleness-Ms")
        if staleness is not None \
                and float(staleness) > self.max_staleness_ms:
            return None
        return resp

    def _request(self, method: str, path: str, **kw) -> Any:
        last_exc: Optional[Exception] = None
        for attempt in range(self.retries):
            try:
                resp = self.session.request(
                    method, f"{self.url}{path}", headers=self._headers(),
                    timeout=30, **kw,
                )
            except ConnectError as e:
                last_exc = e
                time.sleep(self.retry_backoff_s * (2 ** attempt))
                continue
            if resp.status_code >= 500:
                last_exc = JobClientError(resp.text, resp.status_code)
                time.sleep(self.retry_backoff_s * (2 ** attempt))
                continue
            if resp.status_code >= 400:
                try:
                    message = resp.json().get("error", resp.text)
                except Exception:
                    message = resp.text
                raise JobClientError(message, resp.status_code)
            return resp
        raise JobClientError(f"request failed after {self.retries} tries: "
                             f"{last_exc}")

    # ------------------------------------------------------------------ api

    def submit(self, jobs: Sequence[dict], *, groups: Sequence[dict] = (),
               pool: Optional[str] = None,
               gang_size: int = 0) -> list[str]:
        """Submit jobs; fills in uuids when absent; returns the uuids.

        `gang_size` >= 2 marks the batch ONE all-or-nothing gang: the
        batch must hold exactly `gang_size` jobs; each gets
        `gang_size=k` and a shared fresh group (the server promotes it
        to unique-host placement, and the scheduler places all k
        members inside one topology block or none at all)."""
        if gang_size:
            if gang_size < 2 or len(jobs) != gang_size:
                raise ValueError(
                    f"gang_size {gang_size} needs a batch of exactly "
                    f"that many jobs (got {len(jobs)})")
            gang_group = str(uuid_mod.uuid4())
        payload = []
        for job in jobs:
            job = dict(job)
            job.setdefault("uuid", str(uuid_mod.uuid4()))
            if pool is not None:
                job.setdefault("pool", pool)
            if gang_size:
                job.setdefault("gang_size", gang_size)
                job.setdefault("group", gang_group)
            payload.append(job)
        body: dict = {"jobs": payload}
        if groups:
            body["groups"] = list(groups)
        resp = self._request("POST", "/jobs", json=body)
        uuids = resp.json()["jobs"]
        self._learn_owner(resp, uuids)
        return uuids

    def query(self, uuids: Sequence[str]) -> list[dict]:
        params = [("uuid", u) for u in uuids]
        direct = self._direct_get("/jobs", uuids, params=params)
        if direct is not None and direct.status_code < 400:
            return direct.json()
        resp = self._request("GET", "/jobs", params=params)
        self._learn_owner(resp, uuids)
        return resp.json()

    def query_views(self, uuids: Sequence[str]) -> list[JobView]:
        """Typed views over `query` (reference cookclient dataclasses)."""
        return [JobView(d) for d in self.query(uuids)]

    def query_instance_view(self, task_id: str) -> InstanceView:
        return InstanceView(self.query_instance(task_id))

    def query_one(self, uuid: str) -> dict:
        direct = self._direct_get(f"/jobs/{uuid}", [uuid])
        if direct is not None and direct.status_code < 400:
            return direct.json()
        resp = self._request("GET", f"/jobs/{uuid}")
        self._learn_owner(resp, [uuid])
        return resp.json()

    def query_instance(self, task_id: str) -> dict:
        return self._request("GET", f"/instances/{task_id}").json()

    def list_jobs(self, user: Optional[str] = None, *,
                  states: Sequence[str] = (), start_ms: int = 0,
                  end_ms: int = 2**62, limit: int = 1000) -> list[dict]:
        params: list = [("user", user or self.user), ("limit", str(limit)),
                        ("start-ms", str(start_ms)), ("end-ms", str(end_ms))]
        for s in states:
            params.append(("state", s))
        return self._request("GET", "/list", params=params).json()

    def kill(self, uuids: Sequence[str]) -> None:
        self._request("DELETE", "/jobs",
                      params=[("uuid", u) for u in uuids])

    def retry(self, uuid: str, retries: int) -> None:
        self._request("POST", "/retry", json={"job": uuid, "retries": retries})

    def wait(self, uuids: Sequence[str], *, timeout_s: float = 300.0,
             poll_s: float = 1.0,
             sleep: Callable[[float], None] = time.sleep) -> list[dict]:
        """Poll until every job completes (reference: JobClient listener/
        wait loops)."""
        deadline = time.monotonic() + timeout_s
        while True:
            jobs = self.query(uuids)
            if all(j["status"] == "completed" for j in jobs):
                return jobs
            if time.monotonic() > deadline:
                raise JobClientError(
                    f"timed out waiting for {[j['uuid'] for j in jobs if j['status'] != 'completed']}"
                )
            sleep(poll_s)

    def usage(self, user: Optional[str] = None) -> dict:
        return self._request("GET", "/usage",
                             params={"user": user or self.user}).json()

    def timeline(self, uuid: str) -> dict:
        """GET /jobs/{uuid}/timeline: the job's causally-ordered
        lifecycle with per-cycle skip/wait attribution."""
        return self._request("GET", f"/jobs/{uuid}/timeline").json()

    def history(self, metric: str = "", *, since: float = 0.0,
                step: str = "raw") -> dict:
        """GET /debug/history: multi-resolution metrics history — the
        series index when `metric` is empty, else the selected series'
        points at the requested resolution."""
        params: dict = {}
        if metric:
            params["metric"] = metric
        if since:
            params["since"] = since
        if step != "raw":
            params["step"] = step
        return self._request("GET", "/debug/history", params=params).json()

    def fleet(self) -> dict:
        """GET /debug/fleet: the leader's merged fleet verdict (one row
        per node, peer staleness, federation reasons)."""
        return self._request("GET", "/debug/fleet").json()

    def fairness(self, pool: Optional[str] = None,
                 ledger: int = 50) -> dict:
        """GET /debug/fairness: per-(pool, user) DRU trajectories, the
        preemption ledger (preemptor/victim users, wasted-work seconds),
        per-pool rollups + Jain index + fragmentation.  Against the mp
        front end the body merges every shard group's pools."""
        params: dict = {"ledger": ledger}
        if pool:
            params["pool"] = pool
        return self._request("GET", "/debug/fairness", params=params).json()

    def trace(self, txn_id: str) -> dict:
        """GET /debug/trace?txn_id=: one transaction's merged
        cross-process trace (raw span records; the mp front end
        federates worker slices, a single node serves its own ring)."""
        return self._request("GET", "/debug/trace",
                             params={"txn_id": txn_id,
                                     "format": "raw"}).json()

    def unscheduled_reasons(self, uuid: str) -> list[dict]:
        resp = self._request("GET", "/unscheduled_jobs",
                             params={"job": uuid})
        return resp.json()[0]["reasons"]

    def groups(self, uuids: Sequence[str], detailed: bool = False) -> list[dict]:
        params: list = [("uuid", u) for u in uuids]
        if detailed:
            params.append(("detailed", "true"))
        return self._request("GET", "/group", params=params).json()
