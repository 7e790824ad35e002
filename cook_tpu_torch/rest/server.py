"""Threaded server harness: serves a `CookApi` on a background thread.

Port of `cook_tpu/rest/server.py` on the standard library: the reference
runs its aiohttp app on an event loop in a thread; here
`http.server.ThreadingHTTPServer` answers each connection on a thread of
its own and hands every request to the app (`rest/http.Application`),
which holds the API's loop lock while it runs.  Used by tests and by
`components.py`, which runs the REST layer beside the scheduler loops in
one process (the reference runs jetty in-process, components.clj:260-294).

`InprocessControlPlane` is the reference's full write path in one process
(store + journal with real fsyncs + transaction pipeline + API, no
scheduler), unsharded or over N shards (`shards=N`: a `ShardedStore`,
one journal segment per shard, the sharded commit pipeline).
"""
from __future__ import annotations

import socket
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from cook_tpu_torch.rest.api import CookApi
from cook_tpu_torch.rest.http import Application, Request


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    # an idle keep-alive connection's thread gives up after this long
    timeout = 60
    # TCP_NODELAY, as aiohttp sets it: the head and the body go out in two
    # writes, and on a keep-alive connection Nagle's algorithm holds the
    # body back until the client's delayed ACK, ~40 ms a request
    disable_nagle_algorithm = True
    app: Application = None

    def _serve(self) -> None:
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length > 0 else b""
        request = Request(self.command, self.path, self.headers, body)
        response = self.app.handle(request)
        self.send_response(response.status)
        for key, value in response.headers.items():
            self.send_header(key, value)
        self.send_header("Content-Length", str(len(response.body)))
        self.end_headers()
        if self.command != "HEAD":
            self.wfile.write(response.body)

    do_GET = do_POST = do_PUT = do_DELETE = do_HEAD = _serve

    def log_message(self, fmt, *args) -> None:
        pass  # access logs stay off, as aiohttp's are by default


class _Server(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: aiohttp's default.  The standard library's 5
    # resets connections once a handful of clients connect at once
    request_queue_size = 128


class ServerThread:
    def __init__(self, api: CookApi, host: str = "127.0.0.1",
                 port: Optional[int] = None):
        self.api = api
        self.host = host
        self.port = port or 0
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def start(self) -> "ServerThread":
        handler = type("CookHandler", (_Handler,),
                       {"app": self.api.build_app()})
        self._server = _Server((self.host, self.port), handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, kwargs={"poll_interval": 0.1},
            daemon=True, name="cook-rest")
        self._thread.start()
        return self

    def stop(self) -> None:
        # parked replication long-polls and sync-ack waits answer now:
        # server_close joins every handler thread
        self.api.close_replication_waits()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)


class InprocessControlPlane:
    """A full control-plane write path in one process: JobStore + journal
    (real fsyncs) + transaction pipeline + CookApi on a ServerThread — no
    scheduler, no device.  Every serialization point the contention
    observatory instruments (store lock, journal fsync, REST) is real;
    only the match cycle is absent, which submission/query/kill traffic
    never touches."""

    def __init__(self, *, data_dir: Optional[str] = None,
                 pools: tuple = ("default",), config=None, clock=None,
                 journal_kw: Optional[dict] = None, shards: int = 1,
                 history_sample_s: float = 0.5):
        import tempfile
        import time as _time

        from cook_tpu_torch.models import persistence
        from cook_tpu_torch.models.entities import Pool
        from cook_tpu_torch.models.store import JobStore
        from cook_tpu_torch.obs.tsdb import HistoryConfig, MetricsHistory
        from cook_tpu_torch.rest.api import ApiConfig
        from cook_tpu_torch.txn import TransactionLog

        self._own_dir = data_dir is None
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="cook-cp-")
        clock = clock or (lambda: int(_time.time() * 1000))
        self.shards = shards
        if shards > 1:
            # sharded control plane (shard/): N store shards, N journal
            # segments, the sharded commit pipeline
            from cook_tpu_torch.shard import (ShardedStore,
                                              ShardedTransactionLog)
            from cook_tpu_torch.shard import journal as shard_journal

            self.store = ShardedStore(shards, clock=clock)
            self.journals = shard_journal.attach_shard_journals(
                self.store, self.data_dir, **(journal_kw or {}))
            self.journal = None
            self.txn = ShardedTransactionLog(self.store,
                                             journals=self.journals)
        else:
            self.store = JobStore(clock=clock)
            # journal_kw: JournalWriter knobs (fsync_policy,
            # degraded_retry_s, ...)
            self.journal = persistence.attach_journal(
                self.store, f"{self.data_dir}/journal.jsonl",
                **(journal_kw or {}))
            self.journals = [self.journal]
            self.txn = TransactionLog(self.store, journal=self.journal)
        for pool in pools:
            self.store.set_pool(Pool(name=pool))
        # fast-sampled, memory-only metrics history
        self.history = MetricsHistory(
            config=HistoryConfig(sample_s=history_sample_s))
        self.api = CookApi(self.store, None, config or ApiConfig(),
                           txn=self.txn, history=self.history)
        self.server = ServerThread(self.api)

    @property
    def url(self) -> str:
        return self.server.url

    def start(self) -> "InprocessControlPlane":
        self.server.start()
        self.history.start()
        return self

    def stop(self) -> None:
        import shutil

        self.history.stop()
        self.server.stop()
        for journal in self.journals:
            journal.close()
        if self._own_dir:
            shutil.rmtree(self.data_dir, ignore_errors=True)
