#!/usr/bin/env python
"""Sustained control-plane load harness: p50/p99 commit-ack at target RPS.

Port of `tools/loadtest.py`.  The sharded control plane is judged by one
number, p99 commit-ack latency under sustained concurrent
submit/query/kill traffic, and by WHERE the time goes when it degrades.
This tool produces both: it replays a seeded bursty traffic schedule
(`cook_tpu_torch.sim.loadgen.rest_traffic_trace`, shared with the
simulator so load shapes reproduce) against a live server, and closes by
scraping `GET /debug/contention` so the report attributes the run's
latency to store-lock wait, journal fsync stalls, and replication lag.
The HTTP client is the port's standard-library keep-alive session
(`client/jobclient.Session`).  Host-only: the control plane's write path
touches no card.

Two loop disciplines:

  * ``open``  (default): requests start at the trace's arrival offsets
    regardless of completions: constant-rate pressure, what "p99 at
    target RPS" means.  A saturated server grows client-side queueing,
    which the latency numbers then honestly include.
  * ``closed``: N workers issue back-to-back with no pacing: the
    throughput ceiling probe.

    python -m cook_tpu_torch.tools.loadtest --url http://host:port --rps 100 --duration 10
    python -m cook_tpu_torch.tools.loadtest --smoke              # in-process plane
    python -m cook_tpu_torch.tools.loadtest --smoke --shards 2   # sharded plane
    python -m cook_tpu_torch.tools.loadtest --smoke --mp 2       # mp fleet

Commit-ack latency here is CLIENT-observed POST /jobs wall time (apply
under the store lock + journal group-fsync + (sync-ack mode) the
replication wait), the same interval the server-side
`cook_job_latency_submit_commit_ack` histogram measures from its end.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import sys
import threading
import time
import uuid as uuid_mod

from cook_tpu_torch.client.jobclient import RequestError, Session


def _percentile(sorted_values, q):
    if not sorted_values:
        return None
    idx = min(len(sorted_values) - 1,
              max(0, round(q / 100 * (len(sorted_values) - 1))))
    return sorted_values[idx]


class _Recorder:
    def __init__(self):
        self._lock = threading.Lock()
        self.latency_ms: dict[str, list] = {}
        self.errors: dict[str, int] = {}      # transport + 5xx
        self.not_found: dict[str, int] = {}   # 4xx races (kill-before-
        #                                       submit-visible etc.)

    def note(self, kind: str, ms: float, status: int,
             transport_error: bool = False) -> None:
        with self._lock:
            if transport_error or status >= 500:
                self.errors[kind] = self.errors.get(kind, 0) + 1
            elif status >= 400:
                self.not_found[kind] = self.not_found.get(kind, 0) + 1
            else:
                self.latency_ms.setdefault(kind, []).append(ms)

    def kind_summary(self) -> dict:
        out = {}
        with self._lock:
            kinds = set(self.latency_ms) | set(self.errors) \
                | set(self.not_found)
            for kind in sorted(kinds):
                lat = sorted(self.latency_ms.get(kind, []))
                out[kind] = {
                    "count": len(lat),
                    "errors": self.errors.get(kind, 0),
                    "rejected_4xx": self.not_found.get(kind, 0),
                    "p50_ms": _percentile(lat, 50),
                    "p99_ms": _percentile(lat, 99),
                    "max_ms": lat[-1] if lat else None,
                }
        return out


def _execute_op(session_factory, url, op, uuids, recorder):
    session = session_factory()
    headers = {"X-Cook-Requesting-User": op.user}
    t0 = time.perf_counter()
    status, transport_error = 0, False
    try:
        if op.kind == "submit":
            spec = dict(op.spec)
            spec["uuid"] = uuids[op.index]
            if op.pool:
                spec["pool"] = op.pool
            r = session.post(f"{url}/jobs", json={"jobs": [spec]},
                             headers=headers, timeout=30)
            status = r.status_code
            if op.pool:
                # per-pool split (a per-SHARD split when the pools were
                # drawn from ShardRouter.pools_for_distinct_shards):
                # skew and wedged-shard isolation show in one run
                recorder.note(f"submit@{op.pool}",
                              (time.perf_counter() - t0) * 1000, status)
        elif op.kind == "query":
            r = session.get(f"{url}/jobs", params={"uuid": uuids[op.ref]},
                            headers=headers, timeout=30)
            status = r.status_code
        else:  # kill: admin impersonates nobody; the submitting user
            # owns the job, so kill as that user
            r = session.request("DELETE", f"{url}/jobs",
                                params={"uuid": uuids[op.ref]},
                                headers=headers, timeout=30)
            status = r.status_code
    except RequestError:
        transport_error = True
    recorder.note(op.kind, (time.perf_counter() - t0) * 1000, status,
                  transport_error)


class _ThreadSessions:
    """One keep-alive Session per worker thread (per-op sessions would
    pay a TCP handshake each); `close()` closes them all."""

    def __init__(self):
        self._local = threading.local()
        self._lock = threading.Lock()
        self._sessions: list = []

    def __call__(self) -> Session:
        session = getattr(self._local, "session", None)
        if session is None:
            session = self._local.session = Session()
            with self._lock:
                self._sessions.append(session)
        return session

    def close(self) -> None:
        with self._lock:
            sessions, self._sessions = self._sessions, []
        for session in sessions:
            session.close()


def run_loadtest(url: str, *, rps: float = 50.0, duration_s: float = 5.0,
                 mode: str = "open", workers: int = 32,
                 mix: tuple = (0.7, 0.2, 0.1), n_users: int = 8,
                 seed: int = 0, pool=None, pools=None,
                 admin_user: str = "admin",
                 warmup: int = 0, log=lambda *a: None) -> dict:
    """Drive the trace against a live server; return the report dict.
    `warmup` serial submits are issued first and NOT recorded — they pay
    the connection setup and first-touch code paths (JSON, route
    resolution, journal open) that would otherwise skew a short run's
    percentiles."""
    from cook_tpu_torch.sim.loadgen import rest_traffic_trace

    if warmup:
        session = Session()
        try:
            for i in range(warmup):
                session.post(
                    f"{url}/jobs",
                    json={"jobs": [{"command": "true", "mem": 64,
                                    "cpus": 0.5,
                                    "uuid": str(uuid_mod.uuid4()),
                                    **({"pool": pool} if pool else {})}]},
                    headers={"X-Cook-Requesting-User": "warmup"},
                    timeout=30)
        except RequestError:
            pass
        finally:
            session.close()

    ops = rest_traffic_trace(duration_s=duration_s, rps=rps, mix=mix,
                             n_users=n_users, seed=seed, pool=pool)
    # pre-assign every submit's uuid so query/kill ops can target their
    # referenced submit even while it is still in flight (a lost race
    # shows up as a 4xx, counted separately from real failures)
    uuids: dict[int, str] = {
        i: str(uuid_mod.uuid4()) for i, op in enumerate(ops)
        if op.kind == "submit"}

    class _Op:
        __slots__ = ("index", "offset_s", "kind", "user", "spec", "ref",
                     "pool")

        def __init__(self, index, src):
            self.index = index
            self.offset_s = src.offset_s
            self.kind = src.kind
            self.user = src.user
            self.spec = src.spec
            self.ref = src.ref
            self.pool = None

    run_ops = [_Op(i, op) for i, op in enumerate(ops)]
    if pools:
        # spread submits round-robin over the pool list (with pools
        # drawn per shard, this is the per-shard traffic split the
        # sharded control plane is judged on)
        submit_i = 0
        for op in run_ops:
            if op.kind == "submit":
                op.pool = pools[submit_i % len(pools)]
                submit_i += 1
    for op in run_ops:
        if op.kind == "kill":
            # only the owner (or an admin) may kill: issue the kill as
            # the user who submitted the referenced job
            op.user = ops[op.ref].user
    recorder = _Recorder()
    session_factory = _ThreadSessions()
    start = time.perf_counter()
    try:
        with concurrent.futures.ThreadPoolExecutor(
                max_workers=workers) as pool_:
            futures = []
            for op in run_ops:
                if mode == "open":
                    lag = op.offset_s - (time.perf_counter() - start)
                    if lag > 0:
                        time.sleep(lag)
                # closed loop: no pacing, back-to-back pressure
                futures.append(pool_.submit(_execute_op, session_factory,
                                            url, op, uuids, recorder))
        wall_s = time.perf_counter() - start
        for future in futures:
            future.result()
    finally:
        session_factory.close()
    kinds = recorder.kind_summary()
    submit = kinds.get("submit", {})
    # "submit@pool" rows are the per-pool SPLIT of the "submit" row,
    # not extra traffic — exclude them from the volume totals
    total = sum(k["count"] + k["errors"] + k["rejected_4xx"]
                for name, k in kinds.items() if "@" not in name)
    report = {
        "mode": mode,
        "target_rps": rps,
        "achieved_rps": round(total / wall_s, 2) if wall_s else 0.0,
        "duration_s": round(wall_s, 3),
        "ops": kinds,
        "commit_ack": {"p50_ms": submit.get("p50_ms"),
                       "p99_ms": submit.get("p99_ms"),
                       "count": submit.get("count", 0)},
        "errors": sum(k["errors"] for name, k in kinds.items()
                      if "@" not in name),
    }
    # close with the server's own attribution: where the run's write-
    # path time went (store lock / fsync / replication / per-endpoint)
    admin = {"X-Cook-Requesting-User": admin_user}
    scrape = Session()
    try:
        r = scrape.get(f"{url}/debug/contention", headers=admin,
                       timeout=10)
        if r.status_code == 200:
            report["contention"] = r.json()
    except (RequestError, ValueError) as e:  # attribution is
        # best-effort; the latency numbers stand on their own
        log(f"loadtest: /debug/contention scrape failed: {e}")
    shard_summary = per_shard_summary(report.get("contention"))
    if shard_summary is not None:
        report["per_shard"] = shard_summary
    # ... and the server's retained history for the run's window: the
    # commit-ack p99 TREND (obs/tsdb.py sampled it while we drove load),
    # so a mid-run regression is visible as a slope, not hidden inside
    # one final percentile
    try:
        r = scrape.get(
            f"{url}/debug/history",
            params={"metric": "job.latency.submit_commit_ack.p99",
                    "since": -(wall_s + 5.0)},
            headers=admin, timeout=10)
        if r.status_code == 200:
            trend = commit_ack_trend(r.json(), wall_s)
            if trend is not None:
                report["commit_ack_trend"] = trend
    except (RequestError, ValueError) as e:  # best-effort, as above
        log(f"loadtest: /debug/history scrape failed: {e}")
    finally:
        scrape.close()
    return report


def commit_ack_trend(history_body, duration_s: float,
                     n_buckets: int = 5) -> "dict | None":
    """Bucket the server-side commit-ack p99 series over the run's
    window: [{offset_s, p99_ms, samples}] oldest-first, plus the
    first->last delta.  The window is clamped to the run's duration
    (the scrape's `since` carries slack, and a long-lived server
    retains pre-run samples that must not read as this run's trend).
    None when the server retained no points in the window (history
    sampler off, or a run shorter than one sample tick)."""
    points = []
    for series_points in (history_body.get("series") or {}).values():
        points.extend(series_points)
    if not points:
        return None
    points.sort()
    cutoff = points[-1][0] - duration_s
    points = [p for p in points if p[0] >= cutoff]
    t0, t1 = points[0][0], points[-1][0]
    span = max(t1 - t0, 1e-9)
    buckets: list[list[float]] = [[] for _ in range(n_buckets)]
    for t, v in points:
        idx = min(n_buckets - 1, int((t - t0) / span * n_buckets))
        buckets[idx].append(v * 1000.0)  # histogram points are seconds
    rows = [{"offset_s": round(i * span / n_buckets, 2),
             "p99_ms": round(max(vals), 3), "samples": len(vals)}
            for i, vals in enumerate(buckets) if vals]
    return {
        "buckets": rows,
        "first_p99_ms": rows[0]["p99_ms"],
        "last_p99_ms": rows[-1]["p99_ms"],
        "delta_p99_ms": round(rows[-1]["p99_ms"] - rows[0]["p99_ms"], 3),
        "window_s": round(span, 2),
    }


def per_shard_summary(contention) -> "dict | None":
    """Per-shard commit-ack breakdown from a /debug/contention scrape
    (the sharded control plane's `shards` section): p50/p99 commit
    service time, commits, lock contention — and the hottest-shard
    attribution, so skew is visible in one loadtest run."""
    if not contention or "shards" not in contention:
        return None
    rows = {}
    hottest, hottest_p99 = None, -1.0
    for row in contention["shards"]:
        shard = row.get("shard")
        ack = row.get("commit_ack") or {}
        lock = row.get("lock") or {}
        p99 = float(ack.get("p99_ms") or 0.0)
        rows[str(shard)] = {
            "commit_p50_ms": ack.get("p50_ms"),
            "commit_p99_ms": ack.get("p99_ms"),
            "commits": ack.get("slow_samples", 0),
            "jobs": row.get("jobs", 0),
            "lock_contention_ratio": lock.get("contention_ratio", 0.0),
        }
        if p99 > hottest_p99:
            hottest, hottest_p99 = shard, p99
    return {"shards": rows, "hottest_shard": hottest,
            "hottest_commit_p99_ms": hottest_p99}


def run_inprocess(shards: int = 1, **kw) -> dict:
    """Smoke form: spin an InprocessControlPlane (real store lock, real
    journal fsyncs, real REST stack; no scheduler, no card) and drive it:
    the reference bench's `control_plane` (shards=1) and
    `control_plane_sharded` cells.  shards > 1 builds the sharded plane and spreads the
    submit traffic over one pool per shard, so the summary's per-shard
    breakdown covers every shard."""
    from cook_tpu_torch.rest.server import InprocessControlPlane

    if shards > 1:
        from cook_tpu_torch.shard import ShardRouter

        pools = ShardRouter(shards).pools_for_distinct_shards()
        # "default" stays for warmup traffic; the trace rides the
        # per-shard pools
        plane = InprocessControlPlane(
            shards=shards, pools=("default", *pools)).start()
        kw.setdefault("pools", pools)
    else:
        plane = InprocessControlPlane().start()
    try:
        return run_loadtest(plane.url, **kw)
    finally:
        plane.stop()


def run_mp(groups: int = 4, standbys: int = 1, *,
           inprocess: bool = False, **kw) -> dict:
    """Multi-process form: an `MpRuntime` fleet (one worker process per
    shard-group behind the shard-aware front end) driven through the
    front end's public port — forwarding, 2PC, and breaker costs are
    all in the measured path.  Traffic rides one pool per GROUP
    (`pools_for_distinct_groups`), so the per-worker breakdown in
    report["mp"] covers every worker: the reference bench's
    `control_plane_mp` cell.  `inprocess=True` embeds the workers (the
    CPU tests: no subprocess boots)."""
    from cook_tpu_torch.mp.supervisor import MpRuntime
    from cook_tpu_torch.mp.topology import ShardGroupTopology

    pools = ShardGroupTopology(groups, groups).pools_for_distinct_groups()
    kw.setdefault("pools", pools)
    runtime = MpRuntime(n_groups=groups, standbys=standbys,
                        inprocess=inprocess,
                        pools=("default", *pools))
    try:
        report = run_loadtest(runtime.url, **kw)
        # per-worker accounting from the front end's own ledger:
        # forwarded counts + forwarded-request percentiles per group
        session = Session()
        try:
            front = session.get(runtime.url + "/debug/frontend",
                                timeout=10).json()
        finally:
            session.close()
        wall = max(report["duration_s"], 1e-6)
        per_worker = {}
        for g, row in front.get("per_group", {}).items():
            per_worker[g] = {
                "forwarded": row["forwarded"],
                "rps": round(row["forwarded"] / wall, 1),
                "forward_p50_ms": row["p50_ms"],
                "forward_p99_ms": row["p99_ms"],
                "breaker": row["breaker"],
            }
        report["mp"] = {"groups": groups,
                        "map_seq": front.get("map_seq"),
                        "per_worker": per_worker,
                        "twopc": front.get("twopc", {})}
        return report
    finally:
        runtime.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="sustained control-plane load harness")
    parser.add_argument("--url", default="",
                        help="target server; omit with --smoke to use an "
                             "in-process control plane")
    parser.add_argument("--rps", type=float, default=50.0,
                        help="target request rate (open-loop pacing)")
    parser.add_argument("--duration", type=float, default=5.0)
    parser.add_argument("--mode", choices=("open", "closed"),
                        default="open")
    parser.add_argument("--workers", type=int, default=32)
    parser.add_argument("--users", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--pool", default=None)
    parser.add_argument("--mix", default="0.7,0.2,0.1",
                        help="submit:query:kill fractions")
    parser.add_argument("--smoke", action="store_true",
                        help="tiny in-process run (rps 40, 2 s)")
    parser.add_argument("--shards", type=int, default=1,
                        help="with --smoke: drive a SHARDED in-process "
                             "control plane (one traffic pool per "
                             "shard; per-shard breakdown in the "
                             "summary)")
    parser.add_argument("--mp", type=int, default=0, metavar="N",
                        help="drive an N-worker multi-process fleet "
                             "through its front end (one traffic pool "
                             "per worker; per-worker RPS and "
                             "forwarded-request p99 in the summary)")
    parser.add_argument("--mp-standbys", type=int, default=1)
    parser.add_argument("--out", default="",
                        help="write the JSON report here too")
    args = parser.parse_args(argv)

    mix = tuple(float(x) for x in args.mix.split(","))
    kw = dict(rps=args.rps, duration_s=args.duration, mode=args.mode,
              workers=args.workers, mix=mix, n_users=args.users,
              seed=args.seed, pool=args.pool,
              log=lambda *a: print(*a, file=sys.stderr))
    if args.mp:
        if args.smoke:
            kw.update(rps=min(args.rps, 40.0),
                      duration_s=min(args.duration, 2.0))
        report = run_mp(groups=args.mp, standbys=args.mp_standbys, **kw)
    elif args.smoke:
        kw.update(rps=min(args.rps, 40.0), duration_s=min(args.duration, 2.0))
        report = run_inprocess(shards=args.shards, **kw)
    elif args.url:
        report = run_loadtest(args.url, **kw)
    else:
        parser.error("--url required (or --smoke for in-process)")
    summary = {k: report[k] for k in ("mode", "target_rps", "achieved_rps",
                                      "duration_s", "commit_ack", "errors")}
    if "per_shard" in report:
        summary["per_shard"] = report["per_shard"]
    if "commit_ack_trend" in report:
        # the trend next to the hottest-shard attribution: a mid-run
        # regression reads as a slope here, not just a final percentile
        summary["commit_ack_trend"] = report["commit_ack_trend"]
    if "mp" in report:
        summary["mp"] = report["mp"]
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 1 if report["errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
