"""The repo's C++ job client (native/jobclient/) against the port's
service on the CPU: the 4 cases of tests/test_cpp_jobclient.py, with
`cook_tpu_torch`'s `build_process` in place of the reference's.  They pin
that the port's REST keeps the contract a non-Python client relies on
(status codes, bodies, the listener's polling).

The binary is built with the repo's Makefile (`make cook_cli`) in a copy
of native/ under the test's temporary directory, so that this module and
tests/test_cpp_jobclient.py, which builds native/cook_cli, never write
one file at once when they run side by side.
"""
import os
import shutil
import subprocess
import time

import pytest
import requests

from cook_tpu_torch.components import (build_process, shutdown,
                                       start_leader_duties)
from cook_tpu_torch.rest.server import free_port
from cook_tpu_torch.utils.config import Settings

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    native = tmp_path_factory.mktemp("native")
    shutil.copy(os.path.join(NATIVE, "Makefile"), native)
    shutil.copytree(os.path.join(NATIVE, "jobclient"), native / "jobclient")
    subprocess.run(["make", "-C", str(native), "cook_cli"], check=True,
                   capture_output=True, timeout=180)
    return str(native / "cook_cli")


@pytest.fixture(scope="module")
def service():
    settings = Settings(
        port=free_port(), platform="cpu",
        rank_interval_s=0.2, match_interval_s=0.2,
        clusters=[{"kind": "mock", "name": "m", "default_runtime_ms": 800,
                   "hosts": [{"node_id": "h", "mem": 8000, "cpus": 16}]}],
    )
    process = build_process(settings)
    start_leader_duties(process, block=False, on_loss=lambda: None)
    url = f"http://127.0.0.1:{settings.port}"
    # service reachable before clients hit it
    deadline = time.time() + 10
    while time.time() < deadline:
        try:
            requests.get(f"{url}/debug", timeout=1)
            break
        except requests.ConnectionError:
            time.sleep(0.1)
    yield url
    shutdown(process)


def run_cli(cli, url, *args, user="alice", timeout=60):
    return subprocess.run(
        [cli, "--url", url, "--user", user, *args],
        capture_output=True, text=True, timeout=timeout)


def test_submit_wait_show_roundtrip(cli, service):
    out = run_cli(cli, service, "submit", "echo hi", "256", "1")
    assert out.returncode == 0, out.stderr
    uuid = out.stdout.strip()
    assert len(uuid) == 36

    out = run_cli(cli, service, "wait", uuid, "30000")
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "completed"
    # the listener observed intermediate states on stderr
    assert "status:" in out.stderr

    out = run_cli(cli, service, "show", uuid)
    assert out.returncode == 0
    assert "completed" in out.stdout
    assert "host=h" in out.stdout


def test_kill(cli, service):
    out = run_cli(cli, service, "submit", "sleep 9999", "256", "1")
    uuid = out.stdout.strip()
    time.sleep(1)  # let it start
    out = run_cli(cli, service, "kill", uuid)
    assert out.returncode == 0, out.stderr
    deadline = time.time() + 10
    while time.time() < deadline:
        out = run_cli(cli, service, "show", uuid)
        if "completed" in out.stdout:
            break
        time.sleep(0.2)
    assert "completed" in out.stdout


def test_kill_authz_enforced(cli, service):
    """Another user cannot kill alice's job (403 surfaces as rc=1)."""
    out = run_cli(cli, service, "submit", "sleep 9999", "256", "1")
    uuid = out.stdout.strip()
    out = run_cli(cli, service, "kill", uuid, user="mallory")
    assert out.returncode == 1
    assert "403" in out.stderr
    run_cli(cli, service, "kill", uuid)  # cleanup as owner


def test_unknown_job_is_client_error(cli, service):
    out = run_cli(cli, service, "show",
                  "00000000-0000-0000-0000-000000000000")
    assert out.returncode == 1
    assert "404" in out.stderr
