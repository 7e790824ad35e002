"""The REST layer's HTTP plumbing on the standard library.

The reference serves its handlers with aiohttp (`cook_tpu/rest/api.py`,
`rest/server.py`); the card's machine has no aiohttp, so the port serves
the same handlers on `http.server.ThreadingHTTPServer` (`rest/server.py`).
This module is the shim between the two: a `Request` with the names the
handlers read from an aiohttp request (`method`, `path`, `path_qs`,
`query` with `get` / `getall`, `match_info`, `headers`, `json()`,
`can_read_body`, and `request["key"]` storage), the responses they build
(`Response`, `json_response`, `HTTPException` and the 307 redirect), and a
route table of aiohttp's `{name}` path templates with its middlewares.

`Application.handle` resolves a request, runs the middleware chain and
the handler holding `LoopLock` (one lock standing in for aiohttp's event
loop; `rest/api.py` says why), and turns an `HTTPException` into its
response and any other exception into a 500.
"""
from __future__ import annotations

import contextlib
import json
import logging
import re
import threading
import urllib.parse
from dataclasses import dataclass
from typing import Callable, Iterable, Optional

log = logging.getLogger(__name__)

# the statuses a handler raises rather than returns
_REASONS = {307: "Temporary Redirect", 404: "Not Found",
            405: "Method Not Allowed"}


class Headers:
    """Case-insensitive header map that keeps each name's spelling."""

    def __init__(self, items: Iterable[tuple[str, str]] = ()):
        self._d: dict[str, tuple[str, str]] = {}
        for k, v in items:
            self[k] = v

    def __setitem__(self, key: str, value: str) -> None:
        self._d[key.lower()] = (key, str(value))

    def __getitem__(self, key: str) -> str:
        return self._d[key.lower()][1]

    def __contains__(self, key: str) -> bool:
        return key.lower() in self._d

    def get(self, key: str, default=None):
        entry = self._d.get(key.lower())
        return default if entry is None else entry[1]

    def setdefault(self, key: str, value: str) -> str:
        if key not in self:
            self[key] = value
        return self[key]

    def items(self) -> list[tuple[str, str]]:
        return list(self._d.values())


class Query:
    """A query string's values by name, first value wins on `get`."""

    def __init__(self, pairs: list[tuple[str, str]]):
        self._pairs = pairs

    def get(self, key: str, default=None):
        for k, v in self._pairs:
            if k == key:
                return v
        return default

    def getall(self, key: str, default=None) -> list[str]:
        values = [v for k, v in self._pairs if k == key]
        if not values and default is not None:
            return list(default)
        return values


class Request:
    """One HTTP request as a handler sees it."""

    def __init__(self, method: str, target: str, headers, body: bytes = b""):
        self.method = method.upper()
        split = urllib.parse.urlsplit(target)
        self.path = urllib.parse.unquote(split.path)
        self.path_qs = split.path + (f"?{split.query}" if split.query else "")
        self.query = Query(urllib.parse.parse_qsl(split.query,
                                                  keep_blank_values=True))
        self.headers = headers
        self.body = body
        self.match_info: dict[str, str] = {}
        # the matched route's template ("/jobs/{uuid}"), None unmatched
        self.route: Optional[str] = None
        self._state: dict = {}

    @property
    def can_read_body(self) -> bool:
        return bool(self.body)

    def json(self):
        return json.loads(self.body.decode("utf-8") if self.body else "")

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value) -> None:
        self._state[key] = value

    def get(self, key, default=None):
        return self._state.get(key, default)


class Response:
    def __init__(self, *, status: int = 200, body: bytes = b"",
                 text: Optional[str] = None,
                 content_type: Optional[str] = None, headers=None):
        self.status = status
        self.headers = Headers(headers.items() if headers else ())
        if text is not None:
            body = text.encode("utf-8")
            content_type = content_type or "text/plain"
        self.body = body
        self.content_type = content_type or (
            "application/octet-stream" if body else "")
        if self.content_type:
            charset = ("; charset=utf-8" if text is not None
                       or self.content_type == "application/json" else "")
            self.headers.setdefault("Content-Type",
                                    self.content_type + charset)

    @property
    def text(self) -> str:
        return self.body.decode("utf-8")


def json_response(data, *, status: int = 200,
                  dumps: Callable = json.dumps) -> Response:
    return Response(status=status, body=dumps(data).encode("utf-8"),
                    content_type="application/json")


class HTTPException(Response, Exception):
    """A response raised instead of returned (aiohttp's web.HTTPException
    family): the middlewares see it as an exception, the client as a
    response with the status's reason as its text body."""

    status_code: int

    def __init__(self, *, headers=None):
        Response.__init__(
            self, status=self.status_code, headers=headers,
            text=f"{self.status_code}: {_REASONS[self.status_code]}")
        Exception.__init__(self, self.text)


class HTTPNotFound(HTTPException):
    status_code = 404


class HTTPMethodNotAllowed(HTTPException):
    status_code = 405

    def __init__(self, allowed: Iterable[str]):
        super().__init__(headers={"Allow": ",".join(sorted(allowed))})


class HTTPTemporaryRedirect(HTTPException):
    status_code = 307

    def __init__(self, location: str):
        super().__init__(headers={"Location": location})


@dataclass(frozen=True)
class Route:
    method: str
    template: str
    pattern: re.Pattern
    handler: Callable


class Router:
    """aiohttp's route table: `{name}` segments match one path segment;
    routes resolve in registration order; a path registered under other
    methods only answers 405."""

    def __init__(self):
        self._routes: list[Route] = []

    def add_route(self, method: str, template: str, handler) -> None:
        parts = re.split(r"\{(\w+)\}", template)
        regex = "".join(re.escape(p) if i % 2 == 0 else f"(?P<{p}>[^{{}}/]+)"
                        for i, p in enumerate(parts))
        self._routes.append(Route(method, template,
                                  re.compile(f"^{regex}$"), handler))

    def add_get(self, template, handler):
        self.add_route("GET", template, handler)

    def add_post(self, template, handler):
        self.add_route("POST", template, handler)

    def add_put(self, template, handler):
        self.add_route("PUT", template, handler)

    def add_delete(self, template, handler):
        self.add_route("DELETE", template, handler)

    def routes(self) -> list[Route]:
        return list(self._routes)

    def resolve(self, request: Request) -> Callable:
        """The handler for `request` (a raiser of the 404 / 405 when no
        route takes it), with its `match_info` and `route` filled in."""
        allowed = set()
        method = "GET" if request.method == "HEAD" else request.method
        for route in self._routes:
            m = route.pattern.match(request.path)
            if m is None:
                continue
            if route.method != method:
                allowed.add(route.method)
                continue
            request.match_info = m.groupdict()
            request.route = route.template
            return route.handler
        if allowed:
            def not_allowed(_request):
                raise HTTPMethodNotAllowed(allowed)
            return not_allowed

        def not_found(_request):
            raise HTTPNotFound()
        return not_found


class LoopLock:
    """One lock in place of aiohttp's event loop: each request holds it
    while its middlewares and handler run, and `released()` marks an
    `await` of blocking work in an executor, where the reference's loop
    serves other requests meanwhile.  A thread that does not hold it (a
    test calling a handler's helper directly) passes through."""

    def __init__(self):
        self._lock = threading.Lock()
        self._owner: Optional[int] = None

    def __enter__(self) -> "LoopLock":
        self._lock.acquire()
        self._owner = threading.get_ident()
        return self

    def __exit__(self, *exc) -> None:
        self._owner = None
        self._lock.release()

    @contextlib.contextmanager
    def released(self):
        if self._owner != threading.get_ident():
            yield
            return
        self._owner = None
        self._lock.release()
        try:
            yield
        finally:
            self._lock.acquire()
            self._owner = threading.get_ident()


class Application:
    def __init__(self, middlewares: Iterable[Callable] = (),
                 loop: Optional[LoopLock] = None):
        self.router = Router()
        self.middlewares = list(middlewares)
        self.loop = loop or LoopLock()

    def handle(self, request: Request) -> Response:
        handler = self.router.resolve(request)
        for middleware in reversed(self.middlewares):
            handler = _bind(middleware, handler)
        try:
            with self.loop:
                return handler(request)
        except HTTPException as e:
            return e
        except Exception:  # noqa: BLE001 — a failed handler is a 500
            log.exception("%s %s failed", request.method, request.path_qs)
            return Response(status=500, text=(
                "500 Internal Server Error\n\n"
                "Server got itself in trouble"))


def _bind(middleware, handler):
    return lambda request: middleware(request, handler)
