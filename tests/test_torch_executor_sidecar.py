"""The executor and the sandbox file server of `cook_tpu_torch` against
`cook_tpu` on the CPU.

- The 7 cases of tests/test_executor_sidecar.py on both packages (`P`
  over `ref` / `port`): the package's `TaskRunner` (success, exit code,
  progress scrape, kill) and its `FileServer` (browse / read / download,
  traversal and symlink escapes refused).  The reference's file server
  runs on aiohttp, the port's on the REST layer's standard-library
  `ServerThread`.
- The 4 cases of tests/test_sandbox_cli.py on both packages: the
  package's executor writes a sandbox, its sidecar serves it, its
  scheduler's mock cluster names the sidecar as the task's output_url,
  and its `cs ls/cat/tail` read the files back.
- The port's own: the executor's REST sink and heartbeats carry
  X-Cook-Executor-Token over the standard library, a large download
  streams whole, and `python -m cook_tpu_torch.sidecar.fileserver`
  serves and exits 0 on SIGTERM.
"""
import asyncio
import json
import os
import signal
import subprocess
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import requests
import torch

from cook_tpu.client import cli as ref_cli
from cook_tpu.cluster import mock as ref_mock
from cook_tpu.executor import runner as ref_runner
from cook_tpu.models import entities as ref_ent
from cook_tpu.models import store as ref_store
from cook_tpu.rest import api as ref_api
from cook_tpu.rest import server as ref_server
from cook_tpu.scheduler import core as ref_core
from cook_tpu.sidecar import fileserver as ref_fileserver
from cook_tpu_torch.client import cli as port_cli
from cook_tpu_torch.cluster import mock as port_mock
from cook_tpu_torch.executor import runner as port_runner
from cook_tpu_torch.models import entities as port_ent
from cook_tpu_torch.models import store as port_store
from cook_tpu_torch.rest import api as port_api
from cook_tpu_torch.rest import server as port_server
from cook_tpu_torch.scheduler import core as port_core
from cook_tpu_torch.sidecar import fileserver as port_fileserver
from tests.conftest import FakeClock

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 15


def _serve_aiohttp(server):
    """The reference's FileServer on an aiohttp loop on a thread, as
    tests/test_executor_sidecar.py runs it: (url, stop)."""
    port = ref_server.free_port()
    loop = asyncio.new_event_loop()
    started = threading.Event()

    def run():
        asyncio.set_event_loop(loop)
        from aiohttp import web

        runner = web.AppRunner(server.build_app())
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", port)
        loop.run_until_complete(site.start())
        started.set()
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    assert started.wait(5)
    return f"http://127.0.0.1:{port}", lambda: loop.call_soon_threadsafe(
        loop.stop)


def _serve_port(server):
    srv = port_server.ServerThread(server).start()
    return srv.url, srv.stop


REF = SimpleNamespace(name="ref", runner=ref_runner,
                      fileserver=ref_fileserver, serve=_serve_aiohttp,
                      cli=ref_cli, mock=ref_mock, ent=ref_ent,
                      store=ref_store, api=ref_api, server=ref_server,
                      core=ref_core, kw={})
PORT = SimpleNamespace(name="port", runner=port_runner,
                       fileserver=port_fileserver, serve=_serve_port,
                       cli=port_cli, mock=port_mock, ent=port_ent,
                       store=port_store, api=port_api, server=port_server,
                       core=port_core, kw={"device": "cpu"})
PKGS = pytest.mark.parametrize("P", [REF, PORT], ids=["ref", "port"])


class Sink:
    def __init__(self):
        self.updates = []

    def __call__(self, u):
        self.updates.append(u)

    def of_kind(self, kind):
        return [u for u in self.updates if u.kind == kind]


# ------------------------------------- tests/test_executor_sidecar.py


@PKGS
def test_executor_success(P, tmp_path):
    sink = Sink()
    runner = P.runner.TaskRunner(
        "t1", "echo out1 && echo err1 >&2 && exit 0", sink,
        P.runner.ExecutorConfig(sandbox_dir=str(tmp_path / "sb")),
    )
    code = runner.run()
    assert code == 0
    statuses = [u.status for u in sink.of_kind("status")]
    assert statuses == ["running", "success"]
    [exit_update] = sink.of_kind("exit-code")
    assert exit_update.exit_code == 0
    assert (tmp_path / "sb" / "stdout").read_text() == "out1\n"
    assert (tmp_path / "sb" / "stderr").read_text() == "err1\n"
    [sandbox] = sink.of_kind("sandbox")
    assert sandbox.sandbox.endswith("sb")


@PKGS
def test_executor_failure_exit_code(P, tmp_path):
    sink = Sink()
    runner = P.runner.TaskRunner("t2", "exit 3", sink,
                                 P.runner.ExecutorConfig(
                                     sandbox_dir=str(tmp_path)))
    assert runner.run() == 3
    assert sink.of_kind("status")[-1].status == "failed"
    assert sink.of_kind("exit-code")[0].exit_code == 3


@PKGS
def test_executor_progress_scraping(P, tmp_path):
    sink = Sink()
    runner = P.runner.TaskRunner(
        "t3",
        "echo 'progress: 25 quarter done'; echo 'progress: 50 half'; "
        "echo not progress; echo 'progress: 100'",
        sink,
        P.runner.ExecutorConfig(sandbox_dir=str(tmp_path),
                                progress_sample_interval_s=0.0),
    )
    runner.run()
    progresses = [(u.progress, u.progress_message)
                  for u in sink.of_kind("progress")]
    assert (25, "quarter done") in progresses
    assert progresses[-1][0] == 100
    # monotone
    values = [p for p, _ in progresses]
    assert values == sorted(values)


@PKGS
def test_executor_kill(P, tmp_path):
    sink = Sink()
    runner = P.runner.TaskRunner("t4", "sleep 30", sink,
                                 P.runner.ExecutorConfig(
                                     sandbox_dir=str(tmp_path),
                                     shutdown_grace_s=0.2))
    t = threading.Thread(target=runner.run)
    t.start()
    for _ in range(100):
        if runner.proc is not None:
            break
        time.sleep(0.01)
    runner.kill()
    t.join(timeout=5)
    assert not t.is_alive()
    assert sink.of_kind("status")[-1].status == "failed"


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def fileserver(request, tmp_path):
    (tmp_path / "stdout").write_text("hello sandbox\n" * 10)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "data.txt").write_text("nested")
    P = request.param
    url, stop = P.serve(P.fileserver.FileServer(str(tmp_path)))
    yield url, tmp_path
    stop()


def get(url, **kw):
    return requests.get(url, timeout=TIMEOUT_S, **kw)


def test_fileserver_browse_read_download(fileserver):
    url, tmp_path = fileserver
    entries = get(f"{url}/files/browse").json()
    names = [e["path"].rsplit("/", 1)[-1] for e in entries]
    assert "stdout" in names and "sub" in names
    # read with offset paging
    r = get(f"{url}/files/read",
            params={"path": "stdout", "offset": 6, "length": 7}).json()
    assert r["data"] == "sandbox"
    # offset=-1 returns the size (tail seeks with this)
    r = get(f"{url}/files/read",
            params={"path": "stdout", "offset": -1}).json()
    assert r["offset"] == len("hello sandbox\n") * 10
    # download
    r = get(f"{url}/files/download", params={"path": "sub/data.txt"})
    assert r.text == "nested"


def test_fileserver_blocks_traversal(fileserver):
    url, _ = fileserver
    r = get(f"{url}/files/read", params={"path": "../../etc/passwd"})
    assert r.status_code == 404
    r = get(f"{url}/files/read", params={"path": "/etc/passwd"})
    assert r.status_code == 404


def test_fileserver_blocks_symlink_escape(fileserver):
    """A task-planted symlink pointing outside the sandbox must not be
    readable through the file server."""
    url, tmp_path = fileserver
    os.symlink("/etc/passwd", tmp_path / "sneaky")
    os.symlink("/etc", tmp_path / "sneakydir")
    for path in ("sneaky", "sneakydir/passwd"):
        r = get(f"{url}/files/read", params={"path": path})
        assert r.status_code == 404, path
        r = get(f"{url}/files/download", params={"path": path})
        assert r.status_code == 404, path
    # a symlink that stays inside the sandbox still works
    os.symlink(tmp_path / "stdout", tmp_path / "inlink")
    r = get(f"{url}/files/read",
            params={"path": "inlink", "offset": 0, "length": 5})
    assert r.json()["data"] == "hello"


# ----------------------------------------- tests/test_sandbox_cli.py


def mk_job(P):
    """tests/conftest.make_job in package P."""
    return P.ent.Job(uuid=P.ent.new_uuid(), user="alice", pool="default",
                     priority=50, max_retries=1,
                     resources=P.ent.Resources(mem=100.0, cpus=1.0,
                                               gpus=0.0),
                     command="true")


@pytest.fixture(params=[REF, PORT], ids=["ref", "port"])
def stack(request, tmp_path):
    """Scheduler + mock cluster whose sandbox URLs point at a real sidecar
    file server over the executor's real sandbox, all of package P."""
    P = request.param
    sandbox = tmp_path / "sandbox"

    # run the job's command with the real executor
    sink_updates = []
    runner = P.runner.TaskRunner(
        "task-x", "echo line one && echo line two", sink_updates.append,
        P.runner.ExecutorConfig(sandbox_dir=str(sandbox)),
    )
    runner.run()

    # sidecar file server over that sandbox
    fs_url, fs_stop = P.serve(P.fileserver.FileServer(str(sandbox)))

    clock = FakeClock()
    store = P.store.JobStore(clock=clock)
    store.set_pool(P.ent.Pool(name="default"))
    cluster = P.mock.MockCluster(
        "mock", [P.mock.MockHost(node_id="h0", hostname="h0", mem=4000,
                                 cpus=8)],
        clock=clock,
        sandbox_url_fn=lambda tid: fs_url,
    )
    scheduler = P.core.Scheduler(store, [cluster], **P.kw)
    api = P.api.CookApi(store, scheduler, P.api.ApiConfig())
    srv = P.server.ServerThread(api).start()

    job = mk_job(P)
    store.submit_jobs([job])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)

    cfg = tmp_path / "cs.json"
    cfg.write_text(json.dumps(
        {"clusters": [{"name": "c1", "url": srv.url}]}))
    yield P, job, str(cfg)
    srv.stop()
    fs_stop()


def cli(P, cfg, *argv):
    return P.cli.main(["--config", cfg, "--user", "alice", *argv])


def test_cli_ls(stack, capsys):
    P, job, cfg = stack
    assert cli(P, cfg, "ls", job.uuid) == 0
    out = capsys.readouterr().out
    assert "stdout" in out and "stderr" in out


def test_cli_cat(stack, capsys):
    P, job, cfg = stack
    assert cli(P, cfg, "cat", job.uuid, "stdout") == 0
    assert capsys.readouterr().out == "line one\nline two\n"


def test_cli_tail(stack, capsys):
    P, job, cfg = stack
    assert cli(P, cfg, "tail", job.uuid, "stdout", "--bytes", "9") == 0
    assert capsys.readouterr().out == "line two\n"


def test_cli_cat_missing_file(stack, capsys):
    P, job, cfg = stack
    assert cli(P, cfg, "cat", job.uuid, "nope") == 1


# ------------------------------------------------------ the port's own


def test_port_sinks_carry_the_executor_token(monkeypatch):
    """RestUpdateSink posts progress and HeartbeatSender beats, each with
    X-Cook-Executor-Token from COOK_EXECUTOR_TOKEN, over the standard
    library; a sink whose server is gone swallows the failure."""
    from cook_tpu_torch.rest.http import Application, json_response

    seen = []

    class App:
        def build_app(self):
            app = Application()

            def record(request):
                seen.append((request.path,
                             request.headers.get("X-Cook-Executor-Token"),
                             request.json() if request.body else None))
                return json_response({})

            app.router.add_post("/progress/{task_id}", record)
            app.router.add_post("/heartbeat/{task_id}", record)
            return app

    monkeypatch.setenv("COOK_EXECUTOR_TOKEN", "s3cret")
    srv = port_server.ServerThread(App()).start()
    try:
        sink = port_runner.RestUpdateSink(srv.url)
        sink(port_runner.TaskUpdate("t9", "progress", progress=40,
                                    progress_message="m"))
        sink(port_runner.TaskUpdate("t9", "status", status="running"))
        beats = port_runner.HeartbeatSender(srv.url, "t9",
                                            interval_s=0.05).start()
        deadline = time.monotonic() + 10
        while len(seen) < 3 and time.monotonic() < deadline:
            time.sleep(0.02)
        beats.stop()
    finally:
        srv.stop()
    assert seen[0] == ("/progress/t9", "s3cret",
                       {"progress_percent": 40, "progress_message": "m"})
    assert seen[1][:2] == ("/heartbeat/t9", "s3cret")
    # only progress updates post; the server gone, a post is dropped
    sink(port_runner.TaskUpdate("t9", "progress", progress=50))


def test_port_download_streams_a_large_file_whole(tmp_path):
    blob = os.urandom(3 * 1024 * 1024 + 17)
    (tmp_path / "big.bin").write_bytes(blob)
    url, stop = _serve_port(port_fileserver.FileServer(str(tmp_path)))
    try:
        r = get(f"{url}/files/download", params={"path": "big.bin"})
        assert r.status_code == 200 and r.content == blob
        assert r.headers["Content-Disposition"] == \
            'attachment; filename="big.bin"'
        # the connection stays usable after a chunked body
        assert get(f"{url}/files/read", params={
            "path": "big.bin", "offset": -1}).json()["offset"] == len(blob)
    finally:
        stop()


def test_port_sidecar_entry_point_serves_and_stops(tmp_path):
    (tmp_path / "stdout").write_text("from the task\n")
    port = port_server.free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "cook_tpu_torch.sidecar.fileserver",
         "--port", str(port), "--workdir", str(tmp_path)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        url = f"http://127.0.0.1:{port}"
        deadline = time.monotonic() + 30
        while True:
            try:
                r = get(f"{url}/files/read", params={"path": "stdout"})
                break
            except requests.ConnectionError:
                assert proc.poll() is None and time.monotonic() < deadline
                time.sleep(0.05)
        assert r.json() == {"offset": 0, "data": "from the task\n"}
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
    assert proc.returncode == 0, err
    assert f"on http://0.0.0.0:{port}" in out
