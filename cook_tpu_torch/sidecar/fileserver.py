"""Sandbox file server: the pod sidecar for `cs ls/cat/tail`.

Port of `cook_tpu/sidecar/fileserver.py` (Cook's sidecar/file_server.py:
a small HTTP server replicating the Mesos `files/` API inside the pod:
/files/browse, /files/read, /files/download, rooted at COOK_WORKDIR),
with the same three endpoints and the same containment checks.  The
reference serves them with aiohttp; the port serves them on the REST
layer's standard-library shim (`rest/http.py`, `rest/server.ServerThread`),
so the sidecar needs no aiohttp and no torch.

    python -m cook_tpu_torch.sidecar.fileserver --port 8000 --workdir /sandbox
"""
from __future__ import annotations

import os
import re
import signal
import stat as stat_mod
import threading
from typing import BinaryIO, Optional

from cook_tpu_torch.rest.http import (Application, LoopLock, Request,
                                      Response, StreamResponse,
                                      json_response)


class FileServer:
    def __init__(self, workdir: str):
        self.workdir = os.path.realpath(workdir)
        # the shim's stand-in for aiohttp's event loop: released around
        # file reads, which the reference runs in an executor
        self.loop = LoopLock()

    def _resolve(self, path: str) -> Optional[str]:
        """Resolve a requested path inside the sandbox; None if it escapes.

        realpath (not abspath) on both ends: a task could otherwise plant a
        symlink inside its sandbox pointing outside COOK_WORKDIR and read
        arbitrary pod-readable files through it.
        """
        if not path:
            return None
        full = os.path.realpath(
            path if os.path.isabs(path) else os.path.join(self.workdir, path)
        )
        if full != self.workdir and not full.startswith(self.workdir + os.sep):
            return None
        return full

    def _open_contained(self, path: str) -> Optional[BinaryIO]:
        """Open a sandbox file with the containment verified on the OPENED
        fd, not just the pre-open path: _resolve alone is check-then-use —
        a task can swap a directory for an outside-pointing symlink between
        the realpath check and the open.  After opening, the fd's real path
        (via /proc/self/fd) tells us what was actually opened; if that
        escaped the sandbox, the handle is discarded."""
        full = self._resolve(path)
        if full is None:
            return None
        try:
            # O_NONBLOCK: opening a task-planted FIFO read-only must not
            # block the server waiting for a writer (harmless for regular
            # files).  O_NOFOLLOW: the realpath above already resolved
            # symlinks, so a symlink at the final component now means a
            # race — reject it.
            fd = os.open(full, os.O_RDONLY | os.O_NONBLOCK
                         | getattr(os, "O_NOFOLLOW", 0))
        except OSError:
            return None
        f = os.fdopen(fd, "rb")
        if not stat_mod.S_ISREG(os.fstat(fd).st_mode):
            f.close()
            return None
        try:
            actual = os.path.realpath(f"/proc/self/fd/{fd}")
        except OSError:
            # non-Linux fallback: re-resolve the path post-open (narrows
            # but does not fully close the race window)
            actual = os.path.realpath(full)
        if (actual != self.workdir
                and not actual.startswith(self.workdir + os.sep)):
            f.close()
            return None
        return f

    def build_app(self) -> Application:
        app = Application(loop=self.loop)
        app.router.add_get("/files/browse", self.browse)
        app.router.add_get("/files/read", self.read)
        app.router.add_get("/files/download", self.download)
        return app

    def browse(self, request: Request) -> Response:
        path = self._resolve(request.query.get("path", self.workdir))
        if path is None or not os.path.exists(path):
            return json_response({"error": "no such path"}, status=404)
        if not os.path.isdir(path):
            return json_response({"error": "not a directory"}, status=400)
        entries = []
        for name in sorted(os.listdir(path)):
            full = os.path.join(path, name)
            stat = os.stat(full)
            entries.append({
                "path": full,
                "size": stat.st_size,
                "nlink": stat.st_nlink,
                "mtime": int(stat.st_mtime),
                "mode": ("d" if os.path.isdir(full) else "-"),
            })
        return json_response(entries)

    def read(self, request: Request) -> Response:
        """Mesos-style paged read: ?path=&offset=&length=.
        offset=-1 returns just the file size (how `cs tail` seeks)."""
        f = self._open_contained(request.query.get("path", ""))
        if f is None:
            return json_response({"error": "no such file"}, status=404)
        with f:
            size = os.fstat(f.fileno()).st_size
            offset = int(request.query.get("offset", 0))
            if offset == -1:
                return json_response({"offset": size, "data": ""})
            if offset < 0:
                return json_response({"error": "bad offset"}, status=400)
            # clamp below as well: length=-1 would turn f.read into
            # read-whole-file and OOM the sidecar on a large log
            length = min(max(int(request.query.get("length", 64 * 1024)), 0),
                         1024 * 1024)
            with self.loop.released():
                f.seek(offset)
                data = f.read(length)
        return json_response({
            "offset": offset,
            "data": data.decode(errors="replace"),
        })

    def download(self, request: Request) -> Response:
        f = self._open_contained(request.query.get("path", ""))
        if f is None:
            return json_response({"error": "no such file"}, status=404)
        # sanitized: filenames are task-controlled, and quotes/control
        # chars would malform the header
        name = re.sub(r"[^\w.+-]", "_", os.path.basename(
            request.query.get("path", "file"))) or "file"
        # the server writes the chunks once the handler has returned, so
        # the file is read outside the loop lock, and closed after
        return StreamResponse(
            iter(lambda: f.read(256 * 1024), b""),
            headers={
                "Content-Type": "application/octet-stream",
                "Content-Disposition": f'attachment; filename="{name}"',
            },
            on_close=f.close)


def main(argv=None) -> int:
    import argparse

    from cook_tpu_torch.rest.server import ServerThread

    parser = argparse.ArgumentParser(prog="cook-sidecar-fileserver")
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--workdir",
                        default=os.environ.get("COOK_WORKDIR", "."))
    args = parser.parse_args(argv)
    # every interface, as aiohttp's run_app binds; SIGTERM and SIGINT
    # stop the server and exit 0
    stop = threading.Event()
    for signum in (signal.SIGTERM, signal.SIGINT):
        signal.signal(signum, lambda *_: stop.set())
    server = ServerThread(FileServer(args.workdir), host="0.0.0.0",
                          port=args.port).start()
    print(f"serving {os.path.realpath(args.workdir)} on "
          f"http://0.0.0.0:{server.port}", flush=True)
    try:
        stop.wait()
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
