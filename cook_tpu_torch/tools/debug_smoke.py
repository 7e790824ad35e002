#!/usr/bin/env python
"""Debug-surface smoke: GET every /debug/* endpoint, assert 200 + JSON.

Port of `tools/debug_smoke.py`.  Unit tests pin individual handler
behaviors; what this tool pins is the whole surface at once: a
schema-breaking refactor (a renamed field, a handler raising on an empty
ring, a route dropped from build_app) would otherwise ship silently until
an operator mid-incident finds the endpoint 500s.  It boots a REAL
full-stack node (JobStore + MockCluster + Scheduler on `--device`, one
match cycle run so rings hold data, CookApi on a ServerThread), walks the
route table from the generated OpenAPI doc, GETs every `/debug` path (plus
the per-job timeline), and asserts every answer is 200 with a parseable
JSON body.

A second rig boots the multi-process analog in-process (`MpRuntime`:
supervisor + shard-group workers + front end, host-only), drives single-
and cross-group submits through the front end, and walks ITS debug
surface: /debug/shards, /debug/frontend (per-hop latency splits must be
non-zero), the federated /debug/trace?txn_id= (the merged Chrome trace
must carry front-end + coordinator + both participants' tracks), and the
federated incident routes.

    python -m cook_tpu_torch.tools.debug_smoke              # on the card
    python -m cook_tpu_torch.tools.debug_smoke --device cpu

Wired into `cook_tpu_torch/tools/ci_checks.py` as the `debug_smoke` step
(a subprocess: the scheduler takes the card, which does not belong in the
ci_checks process itself).
"""
from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request

ADMIN = {"X-Cook-Requesting-User": "admin"}


def build_rig(device="cuda"):
    """A full-stack node with data in every debug ring; its scheduler
    solves on `device`."""
    from cook_tpu_torch.cluster.mock import MockCluster, MockHost
    from cook_tpu_torch.models.entities import Job, Pool, Resources
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.rest.api import ApiConfig, CookApi
    from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
    from cook_tpu_torch.scheduler.matcher import MatchConfig

    from cook_tpu_torch.models.entities import DEFAULT_USER, Share

    store = JobStore()
    store.set_pool(Pool(name="default"))
    cluster = MockCluster(
        "smoke",
        [MockHost(node_id=f"h{i}", hostname=f"h{i}", mem=4000, cpus=8)
         for i in range(2)],
        clock=store.clock)
    # device residency on: /debug/device must serve populated
    # device_state residency fields (mirror pools, resident bytes)
    scheduler = Scheduler(store, [cluster],
                          SchedulerConfig(match=MatchConfig(
                              chunk=0, device_residency=True)),
                          device=device)
    store.submit_jobs([
        Job(uuid=f"smoke-{i}", user="smoke", pool="default", command="true",
            resources=Resources(mem=200, cpus=1)) for i in range(3)])
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    # force a rebalance so /debug/fairness serves a POPULATED ledger:
    # a finite share makes DRU meaningful, a hog user fills the hosts,
    # then a starved user's job that no longer fits drives the
    # preemption search to a transacted victim kill
    store.set_share(Share(user=DEFAULT_USER, pool="default",
                          resources=Resources(mem=500, cpus=4)))
    store.submit_jobs([
        Job(uuid=f"smoke-hog-{i}", user="hog", pool="default",
            command="true", resources=Resources(mem=1600, cpus=2))
        for i in range(4)])
    scheduler.rank_cycle(pool)
    scheduler.match_cycle(pool)
    store.submit_jobs([
        Job(uuid="smoke-starved", user="starved", pool="default",
            command="true", resources=Resources(mem=1000, cpus=1))])
    scheduler.rank_cycle(pool)
    scheduler.rebalance_cycle(pool)
    # fault_injection on so GET /debug/faults serves its (disarmed) state
    # instead of the production 403
    api = CookApi(store, scheduler, ApiConfig(fault_injection=True))
    # force metrics-history ticks so /debug/history serves NON-EMPTY
    # series (two ticks: counters/histograms need a previous tick to
    # difference against)
    api.history.sample_once()
    api.history.sample_once()
    # a zero-peer fleet observatory so /debug/fleet serves the real
    # merged-verdict shape (self row included), not the disabled stub
    from cook_tpu_torch.obs.fleet import FleetObservatory

    api.fleet = FleetObservatory(self_url="http://smoke.local",
                                 incidents=api.incidents,
                                 self_verdict_fn=api.health_verdict)
    api.fleet.poll_once()
    # mint one incident so /debug/incidents/{id} has a real id to serve
    incident = api.incidents.capture(
        {"healthy": False, "reasons": ["debug-smoke"]}, trigger="smoke")
    return api, incident["id"]


def smoke_paths(api, incident_id: str) -> list[str]:
    """Every GET /debug route from the generated OpenAPI doc, templates
    substituted with ids that exist in this rig, plus the per-job
    timeline (the debug surface that lives under /jobs)."""
    substitutions = {"{cycle_id}": "1", "{incident_id}": incident_id}
    paths = []
    for path, methods in sorted(api._openapi["paths"].items()):
        if "get" not in methods or not path.startswith("/debug"):
            continue
        for template, value in substitutions.items():
            path = path.replace(template, value)
        if "{" in path:
            raise AssertionError(
                f"debug route {path} has a path parameter this smoke "
                f"doesn't know how to substitute — teach smoke_paths()")
        paths.append(path)
    return paths + ["/jobs/smoke-0/timeline"]


def _http(url: str, body: dict | None = None,
          headers: dict | None = None):
    """One request, JSON in/out: (status, parsed_or_None, n_bytes)."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url, data=data, method="POST" if data else "GET",
        headers={**ADMIN, "Content-Type": "application/json",
                 **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            status, raw = r.status, r.read()
    except urllib.error.HTTPError as e:
        status, raw = e.code, e.read()
    try:
        return status, json.loads(raw), len(raw)
    except ValueError:
        return status, None, len(raw)


def mp_smoke() -> list[str]:
    """Boot an in-process MpRuntime, push traffic through the front
    end, then walk its debug surface — the cross-process tracing /
    incident routes that no single-node rig exercises."""
    from cook_tpu_torch.mp.supervisor import MpRuntime

    failures: list[str] = []

    def check(path: str, ok: bool, problem: str, n_bytes: int) -> None:
        if ok:
            print(f"debug_smoke[mp]: {path}: 200 OK ({n_bytes} bytes)")
        else:
            failures.append(f"mp {path}: {problem}")
            print(f"debug_smoke[mp]: {path}: FAIL ({problem})")

    def spec(uuid: str, pool: str) -> dict:
        return {"uuid": uuid, "command": "true", "pool": pool,
                "mem": 64, "cpus": 1}

    runtime = MpRuntime(n_groups=2, standbys=0, inprocess=True,
                        poll_s=30.0)
    try:
        pool_a, pool_b = runtime.pools[1], runtime.pools[2]
        # single-group forwards: the hop reservoirs need samples before
        # /debug/frontend can report non-zero splits
        for i in range(3):
            status, _, _ = _http(f"{runtime.url}/jobs", body={
                "jobs": [spec(f"mp-hop-{i}", pool_a)]})
            if status != 201:
                failures.append(f"mp submit mp-hop-{i}: status {status}")
        # cross-group submit under a known txn id: the 2PC spans this
        # mints are what /debug/trace must stitch into one trace
        txn_id = "smoke-mp-trace"
        status, _, _ = _http(
            f"{runtime.url}/jobs",
            body={"jobs": [spec("mp-tr-a", pool_a),
                           spec("mp-tr-b", pool_b)]},
            headers={"X-Cook-Txn-Id": txn_id})
        if status != 201:
            failures.append(f"mp cross-group submit: status {status}")
        # mint one incident through the FRONT END's recorder so the
        # federated routes have a bundle (mp collectors embed the 2PC
        # decision-log tail, breaker states, and the route map)
        incident = runtime.frontend.incidents.capture(
            {"healthy": False, "reasons": ["debug-smoke"]},
            trigger="smoke")

        status, shards, n = _http(f"{runtime.url}/debug/shards")
        check("/debug/shards",
              status == 200 and isinstance(shards, dict)
              and shards.get("groups"),
              f"status {status} / no groups in route map", n)

        status, fe, n = _http(f"{runtime.url}/debug/frontend")
        g = str(runtime.supervisor.topology.group_for_pool(pool_a))
        hops = ((fe or {}).get("per_group", {}).get(g) or {}).get(
            "hops", {})
        flat = (status == 200) and [
            hop for hop in ("queue", "transport", "apply", "fsync")
            if not (hops.get(hop, {}).get("count", 0) > 0
                    and hops.get(hop, {}).get("p99_ms", 0.0) > 0.0)]
        check("/debug/frontend",
              status == 200 and flat == [],
              f"status {status} / zero hop splits {flat}", n)

        status, raw, n = _http(
            f"{runtime.url}/debug/trace?txn_id={txn_id}&format=raw")
        procs = {s.get("process") for s in (raw or {}).get("spans", [])}
        workers = {p for p in procs if str(p).startswith("worker-g")}
        check("/debug/trace?format=raw",
              status == 200 and raw.get("groups_failed") == []
              and "frontend" in procs and "coordinator" in procs
              and len(workers) >= 2,
              f"status {status} / merged processes {sorted(map(str, procs))}",
              n)

        status, chrome, n = _http(
            f"{runtime.url}/debug/trace?txn_id={txn_id}")
        pids = {e["args"]["name"]: e["pid"]
                for e in (chrome or {}).get("traceEvents", [])
                if e.get("name") == "process_name"}
        check("/debug/trace",
              status == 200 and pids.get("frontend") == 0
              and pids.get("coordinator") == 1
              and sum(1 for name, pid in pids.items()
                      if name.startswith("worker-g") and pid >= 2) >= 2,
              f"status {status} / pid tracks {pids}", n)

        status, _, n = _http(f"{runtime.url}/debug/trace")
        check("/debug/trace (no txn_id)", status == 400,
              f"expected 400, got {status}", n)

        # fairness scatter-merge: feed each shard group's worker
        # observatory one ledger entry for a pool it OWNS (the same
        # public call the scheduler makes), then the front end's
        # /debug/fairness must merge both groups' pool-keyed bodies
        for pool in (pool_a, pool_b):
            g_idx = runtime.supervisor.topology.group_for_pool(pool)
            worker = runtime.supervisor.workers[g_idx].worker
            worker.api.fairness.record_decisions(pool, [{
                "t_ms": 0,
                "preemptor_job": f"job-{pool}",
                "preemptor_user": "alice",
                "hostname": "h0",
                "min_preempted_dru": 1.5,
                "victims": [{"task_id": f"t-{pool}", "user": "bob",
                             "dru": 2.0, "wasted_s": 12.5,
                             "mem": 100.0, "cpus": 1.0, "gpus": 0.0}],
                "freed": {"mem": 100.0, "cpus": 1.0, "gpus": 0.0},
                "wasted_s": 12.5,
            }])
        status, fairness, n = _http(f"{runtime.url}/debug/fairness")
        merged_pools = (fairness or {}).get("pools", {})
        missing_pools = (status == 200) and [
            pool for pool in (pool_a, pool_b)
            if not (merged_pools.get(pool) or {}).get("ledger")]
        check("/debug/fairness",
              status == 200 and missing_pools == [],
              f"status {status} / pools missing ledger entries "
              f"{missing_pools}", n)

        status, index, n = _http(f"{runtime.url}/debug/incidents")
        ids = {b.get("id") for b in (index or {}).get("incidents", [])}
        check("/debug/incidents",
              status == 200 and incident["id"] in ids,
              f"status {status} / bundle index {sorted(map(str, ids))}",
              n)

        status, bundle, n = _http(
            f"{runtime.url}/debug/incidents/{incident['id']}")
        missing = (status == 200) and [
            k for k in ("decision_log", "breakers", "route_map")
            if not isinstance((bundle or {}).get(k), dict)]
        check(f"/debug/incidents/{incident['id']}",
              status == 200 and missing == [],
              f"status {status} / missing evidence {missing}", n)
    finally:
        runtime.stop()
    return failures


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="GET every /debug endpoint of a full-stack node and "
                    "of an mp fleet")
    parser.add_argument("--device", default="cuda",
                        help="the scheduler's device: cuda (default) or "
                             "cpu")
    args = parser.parse_args(argv)
    from cook_tpu_torch.rest.server import ServerThread

    api, incident_id = build_rig(args.device)
    server = ServerThread(api).start()
    failures = []
    try:
        for path in smoke_paths(api, incident_id):
            url = server.url + path
            try:
                req = urllib.request.Request(url, headers=ADMIN)
                with urllib.request.urlopen(req, timeout=10) as r:
                    status, body = r.status, r.read()
            except urllib.error.HTTPError as e:
                status, body = e.code, e.read()
            except OSError as e:
                failures.append(f"{path}: {e}")
                print(f"debug_smoke: {path}: FAIL ({e})")
                continue
            problem = ""
            if status != 200:
                problem = f"status {status}"
            else:
                try:
                    parsed = json.loads(body)
                except ValueError as e:
                    problem = f"unparseable JSON: {e}"
                else:
                    if path == "/debug/device":
                        # residency fields: the rig runs with
                        # device_residency on, so the device_state
                        # section must exist AND carry a mirror
                        ds = parsed.get("device_state") or {}
                        if not ds.get("enabled"):
                            problem = ("device_state residency section "
                                       "missing/empty")
                        elif not any(s.get("pools")
                                     for s in ds.get("states", [])):
                            problem = ("device_state has no resident "
                                       "pool mirrors")
                    elif path == "/debug/history":
                        # the rig forced sample ticks, so the series
                        # index must be NON-EMPTY — an empty history
                        # after a forced tick is a broken sampler, not
                        # a quiet system
                        if not parsed.get("series"):
                            problem = ("history series index empty "
                                       "after forced sample ticks")
                    elif path == "/debug/fairness":
                        # the rig forced a rebalance: the ledger,
                        # rollups, and trajectories must all be
                        # populated — an empty body after a transacted
                        # preemption is a broken feed, not a fair pool
                        view = (parsed.get("pools") or {}).get(
                            "default") or {}
                        rollups = view.get("rollups") or {}
                        if not view.get("ledger"):
                            problem = ("fairness ledger empty after a "
                                       "forced rebalance")
                        elif rollups.get("tasks_preempted", 0) < 1:
                            problem = ("fairness rollups show no "
                                       "preempted tasks")
                        elif not view.get("trajectories"):
                            problem = ("fairness trajectories empty "
                                       "after rank cycles")
                    elif path == "/debug/fleet":
                        # the rig wired a fleet observatory: the merged
                        # verdict must render (self row at minimum)
                        if not parsed.get("enabled") \
                                or not parsed.get("nodes"):
                            problem = ("fleet verdict missing/empty "
                                       "nodes despite a wired "
                                       "observatory")
            if problem:
                failures.append(f"{path}: {problem}")
                print(f"debug_smoke: {path}: FAIL ({problem})")
            else:
                print(f"debug_smoke: {path}: 200 OK "
                      f"({len(body)} bytes)")
    finally:
        server.stop()
    failures += mp_smoke()
    if failures:
        print(f"debug_smoke: FAILED: {len(failures)} endpoint(s)")
        return 1
    print("debug_smoke: all debug endpoints healthy")
    return 0


if __name__ == "__main__":
    sys.exit(main())
