"""Worker-fleet supervisor: spawn, watch, fail over.

Port of `cook_tpu/mp/supervisor.py`.  The supervisor owns the fleet's
shape: it writes the shard manifest, spawns one
`cook_tpu_torch.mp.worker` process per shard-group plus N warm standbys
(RPC port up, no shards), writes the route map the front end and
shard-aware clients read, and then watches.

Death detection is two-signal: the child's exit status
(`Popen.poll()`) catches clean crashes instantly, and a
`FleetObservatory` polling each worker's REST /debug/health catches
the uglier half — a live process that stopped answering (SIGSTOP, a
wedged server, a network partition in a real deployment).  Either
signal, sustained for `unreachable_threshold` consecutive checks
(exit is immediate), triggers failover:

  1. the dead group's route-map entry is marked dead (map_seq bump,
     atomic rewrite) — the front end starts failing fast for those
     keys instead of burning its breaker on a corpse;
  2. a standby is told to `adopt` the group: it recovers the group's
     journal segments from `data_dir/shards/shard-NN/` (every acked
     commit is an fsynced journal line, so nothing acked is lost) and
     brings the REST surface up;
  3. the map is rewritten again with the standby's urls (alive=True),
     the front end re-reads it, clears its resolve cache, and replays
     any outstanding 2PC decisions at the new rpc_url;
  4. a replacement standby is spawned to restore the spare pool.

With no standby available the supervisor falls back to a cold respawn
of the group (same recovery path, slower by one process boot).

`MpRuntime` is the one-call harness (supervisor + front end) that
`python -m cook_tpu_torch --mp N` runs.  spawn/fetch are injectable so
tests exercise failover without processes or sockets
(`Supervisor.check_once()` runs one monitor pass synchronously).

No worker process outlives the supervisor: `stop` ends every worker and
standby, waits out a standby being spawned in the background, and a
spawn that `stop` overtakes kills its child.
"""
from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from typing import Callable, Optional

from cook_tpu_torch.mp.topology import (ShardGroupTopology, build_route_map,
                                        write_route_map)
from cook_tpu_torch.obs import distributed
from cook_tpu_torch.txn.transaction import new_txn_id
from cook_tpu_torch.utils import tracing
from cook_tpu_torch.utils.metrics import global_registry

log = logging.getLogger(__name__)

# a worker boot imports torch and the REST layer (a few seconds, more on
# a loaded host); generous on 1 cpu
READY_TIMEOUT_S = 90.0


class SubprocessHandle:
    """A spawned worker process + the describe dict it wrote at boot."""

    def __init__(self, proc: subprocess.Popen, describe: dict,
                 log_path: str = ""):
        self.proc = proc
        self.describe = describe
        self.log_path = log_path

    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self, sig: int = signal.SIGTERM) -> None:
        if self.alive():
            self.proc.send_signal(sig)

    def join(self, timeout: float = 10.0) -> None:
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=timeout)


class InprocessHandle:
    """A `ShardGroupWorker` embedded in this process (tests and smoke
    harnesses: no subprocess boot)."""

    def __init__(self, worker):
        self.worker = worker
        self.describe = worker.describe()
        self._killed = False

    def alive(self) -> bool:
        return not self._killed

    def kill(self, sig: int = signal.SIGTERM) -> None:
        if not self._killed:
            self._killed = True
            self.worker.stop()

    def join(self, timeout: float = 10.0) -> None:
        pass


class Supervisor:
    def __init__(self, data_dir: str, *, n_shards: int, n_groups: int,
                 pools: tuple = ("default",), standbys: int = 1,
                 spawn_fn: Optional[Callable] = None,
                 fetch_fn: Optional[Callable] = None,
                 post_fn: Optional[Callable] = None,
                 poll_s: float = 0.5,
                 unreachable_threshold: int = 3,
                 journal_kw: Optional[dict] = None):
        self.data_dir = data_dir
        self.topology = ShardGroupTopology(n_shards, n_groups)
        self.pools = tuple(pools)
        self.n_standbys = standbys
        self.spawn_fn = spawn_fn or self._spawn_subprocess
        self.post_fn = post_fn or self._post
        self.poll_s = poll_s
        self.unreachable_threshold = unreachable_threshold
        self.journal_kw = dict(journal_kw or {})
        self.workers: dict[int, object] = {}  # group -> handle
        self.standbys: list = []
        self.map_seq = 0
        self.map_path = os.path.join(data_dir, "mp", "routemap.json")
        self._miss: dict[int, int] = {}  # group -> consecutive misses
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._replenishers: list[threading.Thread] = []
        # every handle ever spawned: stop ends each one still running,
        # whatever list it sat in (a standby mid-adoption sits in none)
        self._spawned: list = []
        self.observatory = None
        self._fetch_fn = fetch_fn
        self._failovers = global_registry.counter(
            "mp.failovers",
            "standby promotions / cold respawns per shard-group")
        self._alive_gauge = global_registry.gauge(
            "mp.workers_alive",
            "shard-group workers currently serving (standbys excluded)")

    # ------------------------------------------------------------- spawn

    def _spawn_subprocess(self, *, group: Optional[int],
                          shards: tuple) -> SubprocessHandle:
        from cook_tpu_torch.rest.server import free_port

        name = f"g{group}" if group is not None \
            else f"standby-{int(time.monotonic() * 1e3) % 100000}"
        mp_dir = os.path.join(self.data_dir, "mp")
        os.makedirs(mp_dir, exist_ok=True)
        ready_file = os.path.join(mp_dir, f"ready-{name}.json")
        if os.path.exists(ready_file):
            os.remove(ready_file)
        log_path = os.path.join(mp_dir, f"worker-{name}.log")
        cmd = [sys.executable, "-m", "cook_tpu_torch.mp.worker",
               "--data-dir", self.data_dir,
               "--n-shards", str(self.topology.n_shards),
               "--shards", ",".join(str(s) for s in shards),
               "--pools", ",".join(self.pools),
               "--port", str(free_port()),
               "--rpc-port", str(free_port()),
               "--ready-file", ready_file]
        if group is not None:
            cmd += ["--group", str(group)]
        # the package is importable from the child wherever it runs
        # (the checkout's root, not the caller's working directory), and
        # the child sees no CUDA device: the control plane is host-only
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.environ.get("PYTHONPATH", "")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   PYTHONPATH=root + (os.pathsep + path if path else ""))
        log_f = open(log_path, "ab")
        proc = subprocess.Popen(cmd, stdout=log_f, stderr=log_f, env=env)
        log_f.close()
        deadline = time.monotonic() + READY_TIMEOUT_S
        try:
            while time.monotonic() < deadline and not self._stop.is_set():
                if os.path.exists(ready_file):
                    with open(ready_file) as f:
                        describe = json.load(f)
                    return SubprocessHandle(proc, describe, log_path)
                if proc.poll() is not None:
                    raise RuntimeError(
                        f"worker {name} died at boot "
                        f"(exit {proc.returncode}); see {log_path}")
                time.sleep(0.05)
        except BaseException:
            # an interrupted boot (SIGTERM on the front end) leaves no
            # child behind
            proc.kill()
            proc.wait()
            raise
        proc.kill()
        proc.wait()
        if self._stop.is_set():
            raise RuntimeError(f"worker {name}: the supervisor stopped "
                               f"while it booted")
        raise RuntimeError(f"worker {name} missed the ready deadline "
                           f"({READY_TIMEOUT_S:.0f} s); see {log_path}")

    def _spawn(self, *, group: Optional[int], shards: tuple):
        handle = self.spawn_fn(group=group, shards=shards)
        with self._lock:
            self._spawned.append(handle)
        return handle

    def _post(self, url: str, body: dict, timeout_s: float = 30.0,
              headers: Optional[dict] = None):
        req = urllib.request.Request(
            url, method="POST", data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     **(headers or {})})
        with urllib.request.urlopen(req, timeout=timeout_s) as r:
            return r.status, json.loads(r.read() or b"{}")

    # --------------------------------------------------------- lifecycle

    def start(self) -> "Supervisor":
        from cook_tpu_torch.obs.fleet import FleetObservatory
        from cook_tpu_torch.shard.journal import write_manifest

        os.makedirs(self.data_dir, exist_ok=True)
        write_manifest(self.data_dir, self.topology.n_shards)
        try:
            for g in range(self.topology.n_groups):
                self.workers[g] = self._spawn(
                    group=g, shards=self.topology.shards_of_group(g))
            for _ in range(self.n_standbys):
                self.standbys.append(self._spawn(group=None, shards=()))
        except BaseException:
            # a worker that failed its boot leaves none of its fleet
            self.stop()
            raise
        self._write_map()
        # the observatory polls each worker's REST surface; its rows
        # (row["ok"]) are the liveness signal check_once consumes
        self.observatory = FleetObservatory(
            peers=tuple(h.describe["url"] for h in self.workers.values()),
            poll_s=self.poll_s, timeout_s=2.0,
            fetch_fn=self._fetch_fn)
        self._alive_gauge.set(float(len(self.workers)))
        self._thread = threading.Thread(target=self._monitor,
                                        name="mp-supervisor",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # a standby spawn in flight sees the stop and kills its child
        for thread in self._replenishers:
            thread.join(timeout=READY_TIMEOUT_S)
        with self._lock:
            handles = list(self._spawned)
        for handle in handles:
            handle.kill(signal.SIGTERM)
        for handle in handles:
            handle.join()

    # --------------------------------------------------------- route map

    def _write_map(self) -> None:
        with self._lock:
            self.map_seq += 1
            entries = {
                g: {"url": h.describe["url"],
                    "rpc_url": h.describe["rpc_url"],
                    "alive": h.alive()}
                for g, h in self.workers.items()}
            write_route_map(self.map_path, build_route_map(
                self.topology, entries, map_seq=self.map_seq))

    # --------------------------------------------------------- monitoring

    def _monitor(self) -> None:
        while not self._stop.wait(self.poll_s):
            try:
                self.check_once()
            except Exception:  # noqa: BLE001 — the monitor must outlive
                # any single bad poll
                log.exception("supervisor check failed")

    def check_once(self) -> list[int]:
        """One monitor pass; returns the groups failed over (tests call
        this directly instead of racing the thread)."""
        rows = self.observatory.poll_once() if self.observatory else {}
        failed: list[int] = []
        for g, handle in list(self.workers.items()):
            if not handle.alive():
                misses = self.unreachable_threshold  # exit: no grace
            else:
                row = rows.get(handle.describe["url"].rstrip("/"), {})
                if row and not row.get("ok", False):
                    misses = self._miss.get(g, 0) + 1
                else:
                    misses = 0
            self._miss[g] = misses
            if misses >= self.unreachable_threshold:
                failed.append(g)
        for g in failed:
            self.failover(g)
        self._alive_gauge.set(float(sum(
            1 for h in self.workers.values() if h.alive())))
        return failed

    # ----------------------------------------------------------- failover

    def failover(self, group: int) -> None:
        """Promote a standby to adopt `group`'s journal segments (cold
        respawn when the spare pool is empty)."""
        t_failover = time.perf_counter()
        old = self.workers[group]
        old_url = old.describe["url"]
        old.kill(signal.SIGKILL)  # ensure the corpse releases nothing
        old.join()
        self._miss[group] = 0
        log.warning("failing over shard-group %d (was %s)", group,
                    old_url)
        # phase 1: the map shows the group dead so the front end fails
        # fast instead of timing out against the corpse
        self._write_map()
        shards = self.topology.shards_of_group(group)
        # trace context: the adoption RPC carries a failover correlation
        # id so the adopter's `mp.adopt` span lands in a stitched trace
        # naming the adopting group (GET /debug/trace?txn_id=<this>)
        failover_txn = f"failover-{group}-{new_txn_id()}"
        adopt_headers = {distributed.TXN_HEADER: failover_txn,
                         distributed.PARENT_SPAN_HEADER: "mp.failover"}
        promoted = None
        while self.standbys and promoted is None:
            with self._lock:
                standby = self.standbys.pop(0)
            try:
                status, reply = self.post_fn(
                    standby.describe["rpc_url"] + "/rpc/adopt",
                    {"group": group, "shards": list(shards),
                     "pools": list(self.pools)},
                    headers=adopt_headers)
                if status == 200 and reply.get("ok"):
                    standby.describe = {**standby.describe, **reply}
                    promoted = standby
                else:
                    log.error("standby refused adoption: %s", reply)
                    standby.kill(signal.SIGTERM)
                    standby.join()
            except Exception:  # noqa: BLE001 — a dead standby: try the
                # next one
                log.exception("standby adoption failed")
                standby.kill(signal.SIGTERM)
                standby.join()
        if promoted is None:
            log.warning("no standby for group %d; cold respawn", group)
            promoted = self._spawn(group=group, shards=shards)
        with self._lock:
            self.workers[group] = promoted
        # phase 2: the map points at the adopter; front end re-reads,
        # clears its resolve cache, replays outstanding 2PC decisions
        self._write_map()
        if self.observatory is not None:
            self.observatory.forget_peer(old_url)
            self.observatory.peers = tuple(
                h.describe["url"] for h in self.workers.values())
        self._failovers.inc(1, {"group": str(group)})
        tracing.record_span(
            "mp.failover", time.perf_counter() - t_failover,
            txn_id=failover_txn, group=group,
            process=distributed.PROCESS_FRONTEND)
        # restore the spare pool in the background (a standby boot
        # takes seconds)
        thread = threading.Thread(target=self._replenish_standby,
                                  daemon=True, name="mp-replenish")
        self._replenishers = [t for t in self._replenishers
                              if t.is_alive()] + [thread]
        thread.start()

    def _replenish_standby(self) -> None:
        if self._stop.is_set():
            return
        try:
            handle = self._spawn(group=None, shards=())
        except Exception:  # noqa: BLE001
            if not self._stop.is_set():
                log.exception("standby replenish failed")
            return
        with self._lock:
            if not self._stop.is_set():
                self.standbys.append(handle)
                return
        # the supervisor stopped while this standby booted
        handle.kill(signal.SIGTERM)
        handle.join()

    # -------------------------------------------------------------- chaos

    def kill_worker(self, group: int,
                    sig: int = signal.SIGKILL) -> None:
        """Chaos entry point: hard-kill a group's worker and let the
        monitor discover it."""
        self.workers[group].kill(sig)


class MpRuntime:
    """Supervisor + front end in one handle: the multi-process analog
    of `rest.server.InprocessControlPlane` (`python -m cook_tpu_torch
    --mp N` runs one)."""

    def __init__(self, *, n_groups: int = 4,
                 n_shards: Optional[int] = None,
                 data_dir: Optional[str] = None,
                 pools: Optional[tuple] = None,
                 standbys: int = 1,
                 inprocess: bool = False,
                 poll_s: float = 0.5,
                 journal_kw: Optional[dict] = None,
                 port: Optional[int] = None):
        import tempfile

        from cook_tpu_torch.mp.router import FrontEnd
        from cook_tpu_torch.rest.server import ServerThread

        self._tmp = None
        if data_dir is None:
            self._tmp = tempfile.mkdtemp(prefix="cook-mp-")
            data_dir = self._tmp
        self.data_dir = data_dir
        n_shards = n_shards or n_groups
        topology = ShardGroupTopology(n_shards, n_groups)
        if pools is None:
            pools = ("default",
                     *topology.pools_for_distinct_groups())
        self.pools = tuple(pools)
        self._n_shards = n_shards
        self._journal_kw = dict(journal_kw or {})
        spawn_fn = self._spawn_inprocess if inprocess else None
        self.supervisor = Supervisor(
            data_dir, n_shards=n_shards, n_groups=n_groups,
            pools=self.pools, standbys=standbys, spawn_fn=spawn_fn,
            poll_s=poll_s, journal_kw=journal_kw)
        self.supervisor.start()
        try:
            self.frontend = FrontEnd(
                self.supervisor.map_path,
                decision_log_path=os.path.join(data_dir, "mp",
                                               "2pc-decisions.jsonl"))
            # federated incidents: a worker's ok->degraded edge seen by
            # the supervisor's fleet poller captures through the FRONT
            # END's recorder — whose collectors embed the 2PC
            # decision-log tail, breaker states, and route map alongside
            # each peer's newest bundle reference (obs/distributed.py
            # add_mp_collectors)
            if self.supervisor.observatory is not None:
                self.supervisor.observatory.incidents = \
                    self.frontend.incidents
            self.server = ServerThread(self.frontend, port=port)
            self.server.start()
        except BaseException:
            self.supervisor.stop()
            raise

    def _spawn_inprocess(self, *, group: Optional[int],
                         shards: tuple) -> InprocessHandle:
        from cook_tpu_torch.mp.worker import ShardGroupWorker

        worker = ShardGroupWorker(
            data_dir=self.data_dir, n_shards=self._n_shards,
            group=group, shards=shards, pools=self.pools,
            journal_kw=self._journal_kw).start()
        return InprocessHandle(worker)

    @property
    def url(self) -> str:
        return f"http://127.0.0.1:{self.server.port}"

    def stop(self) -> None:
        self.server.stop()
        self.supervisor.stop()
        if self._tmp:
            import shutil

            shutil.rmtree(self._tmp, ignore_errors=True)
