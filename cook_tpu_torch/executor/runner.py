"""Task executor: runs a job's command and feeds the scheduler.

Port of `cook_tpu/executor/runner.py` (Cook's executor/cook/executor.py —
`CookExecutor` + `manage_task`): launch the command in a sandbox, scrape
progress updates from its output (configurable regex), publish the exit
code and sandbox location, honor kills with a grace period, and send
status transitions.  Here the backend transport is a callable feed rather
than Mesos framework messages; the k8s deployment runs this as the pod's
main process with the sidecar (cook_tpu_torch.sidecar) for file serving.
The REST sink and the heartbeats post over the job client's
standard-library `Session` instead of `requests`.
"""
from __future__ import annotations

import os
import re
import signal
import subprocess
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from cook_tpu_torch.client.jobclient import Session

# default progress regex, same shape the reference scrapes:
#   "progress: 25 doing the thing" -> (25, "doing the thing")
DEFAULT_PROGRESS_REGEX = r"progress:?\s+([0-9]*\.?[0-9]+)($|\s+.*)"


@dataclass
class ExecutorConfig:
    sandbox_dir: str = "."
    progress_regex: str = DEFAULT_PROGRESS_REGEX
    progress_sample_interval_s: float = 1.0
    shutdown_grace_s: float = 2.0
    stdout_file: str = "stdout"
    stderr_file: str = "stderr"


@dataclass
class TaskUpdate:
    task_id: str
    kind: str                 # "status" | "progress" | "exit-code" | "sandbox"
    status: Optional[str] = None
    progress: int = 0
    progress_message: str = ""
    exit_code: Optional[int] = None
    sandbox: str = ""


UpdateSink = Callable[[TaskUpdate], None]


class TaskRunner:
    """Runs one task; the executor process hosts one of these per task."""

    def __init__(self, task_id: str, command: str, sink: UpdateSink,
                 config: Optional[ExecutorConfig] = None,
                 env: Optional[dict] = None):
        self.task_id = task_id
        self.command = command
        self.sink = sink
        self.config = config or ExecutorConfig()
        self.env = env or {}
        self.proc: Optional[subprocess.Popen] = None
        self._progress_re = re.compile(self.config.progress_regex)
        self._last_progress = -1
        self._last_progress_sent = 0.0
        self._killed = threading.Event()

    def run(self) -> int:
        cfg = self.config
        os.makedirs(cfg.sandbox_dir, exist_ok=True)
        self.sink(TaskUpdate(self.task_id, "sandbox",
                             sandbox=os.path.abspath(cfg.sandbox_dir)))
        stdout_path = os.path.join(cfg.sandbox_dir, cfg.stdout_file)
        stderr_path = os.path.join(cfg.sandbox_dir, cfg.stderr_file)
        env = {**os.environ, **self.env,
               "COOK_TASK_ID": self.task_id,
               "COOK_WORKDIR": os.path.abspath(cfg.sandbox_dir)}
        with open(stdout_path, "wb") as out, open(stderr_path, "wb") as err:
            self.proc = subprocess.Popen(
                ["/bin/sh", "-c", self.command],
                stdout=subprocess.PIPE,
                stderr=err,
                cwd=cfg.sandbox_dir,
                env=env,
                start_new_session=True,  # kill the whole process group
            )
            self.sink(TaskUpdate(self.task_id, "status", status="running"))
            # tee stdout to the sandbox file while scraping progress
            assert self.proc.stdout is not None
            for raw in self.proc.stdout:
                out.write(raw)
                out.flush()
                self._scrape_progress(raw)
            self.proc.stdout.close()
            code = self.proc.wait()
        self._flush_progress(force=True)
        self.sink(TaskUpdate(self.task_id, "exit-code", exit_code=code))
        status = "success" if code == 0 and not self._killed.is_set() \
            else "failed"
        self.sink(TaskUpdate(self.task_id, "status", status=status))
        return code

    def _scrape_progress(self, raw: bytes) -> None:
        try:
            line = raw.decode(errors="replace").strip()
        except Exception:
            return
        match = self._progress_re.search(line)
        if not match:
            return
        pct = int(float(match.group(1)))
        message = (match.group(2) or "").strip()
        if pct > self._last_progress:
            self._last_progress = pct
            self._progress_message = message
            self._flush_progress()

    def _flush_progress(self, force: bool = False) -> None:
        """Sampled publication (the reference throttles progress sends)."""
        now = time.monotonic()
        if self._last_progress < 0:
            return
        if not force and now - self._last_progress_sent \
                < self.config.progress_sample_interval_s:
            return
        self._last_progress_sent = now
        self.sink(TaskUpdate(
            self.task_id, "progress",
            progress=min(self._last_progress, 100),
            progress_message=getattr(self, "_progress_message", ""),
        ))

    def kill(self) -> None:
        """Graceful shutdown: SIGTERM, grace period, SIGKILL (reference:
        executor gracefully_shutdown)."""
        self._killed.set()
        if self.proc is None or self.proc.poll() is not None:
            return
        try:
            os.killpg(self.proc.pid, signal.SIGTERM)
        except ProcessLookupError:
            return
        deadline = time.monotonic() + self.config.shutdown_grace_s
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                return
            time.sleep(0.05)
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass


def _executor_session(session=None):
    """A Session carrying the shared executor secret
    (COOK_EXECUTOR_TOKEN) so heartbeat/progress posts stay spoof-proof
    under strict auth."""
    session = session or Session()
    token = os.environ.get("COOK_EXECUTOR_TOKEN", "")
    if token:
        session.headers["X-Cook-Executor-Token"] = token
    return session


class RestUpdateSink:
    """Publishes executor updates to the scheduler's REST API (the k8s-mode
    transport; the sidecar progress reporter does the same,
    sidecar/progress.py)."""

    def __init__(self, base_url: str, session=None):
        self.base_url = base_url.rstrip("/")
        self.session = _executor_session(session)

    def __call__(self, update: TaskUpdate) -> None:
        if update.kind == "progress":
            try:
                self.session.post(
                    f"{self.base_url}/progress/{update.task_id}",
                    json={"progress_percent": update.progress,
                          "progress_message": update.progress_message},
                    timeout=10,
                )
            except Exception:  # noqa: BLE001 — progress is best-effort
                pass


class HeartbeatSender:
    """Background liveness beats to the scheduler while a task runs
    (reference: the executor's heartbeat framework messages)."""

    def __init__(self, base_url: str, task_id: str, *,
                 interval_s: float = 30.0, session=None):
        self.url = f"{base_url.rstrip('/')}/heartbeat/{task_id}"
        self.interval_s = interval_s
        self.session = _executor_session(session)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "HeartbeatSender":
        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.session.post(self.url, timeout=10)
                except Exception:  # noqa: BLE001 — best-effort
                    pass

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="heartbeat")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
