"""`cs` — the command-line client.

Port of `cook_tpu/client/cli.py` (Cook's cli/cook/subcommands/*: submit,
show, wait, jobs, kill, usage, queue-position; multi-cluster federation —
the CLI reads a config listing several schedulers and fans queries out to
all of them, reporting which cluster owns each uuid, cli/cook/querying.py).

    python -m cook_tpu_torch.client.cli --config cs.json --user alice submit "echo hi"

The same subcommands, flags and rendered text as the reference's; the
sandbox reads (`ls`, `cat`, `tail`) and the admin posts go over the job
client's standard-library `Session`.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Optional, Sequence

from cook_tpu_torch.client.jobclient import (JobClient, JobClientError,
                                             Session)

DEFAULT_CONFIG_PATHS = (
    os.path.expanduser("~/.cs.json"),
    ".cs.json",
)


@dataclass
class ClusterConfig:
    name: str
    url: str


def load_config(path: Optional[str] = None) -> list[ClusterConfig]:
    paths = [path] if path else list(DEFAULT_CONFIG_PATHS)
    for p in paths:
        if p and os.path.exists(p):
            with open(p) as f:
                data = json.load(f)
            return [ClusterConfig(c["name"], c["url"])
                    for c in data.get("clusters", [])]
    url = os.environ.get("COOK_SCHEDULER_URL", "http://localhost:12321")
    return [ClusterConfig("default", url)]


def _clients(args) -> list[tuple[ClusterConfig, JobClient]]:
    clusters = load_config(args.config)
    if args.cluster:
        clusters = [c for c in clusters if c.name == args.cluster]
        if not clusters:
            raise SystemExit(f"no cluster named {args.cluster} in config")
    user = args.user or os.environ.get("USER", "anonymous")
    direct = bool(getattr(args, "route_map", False))
    return [(c, JobClient(c.url, user=user, direct_reads=direct))
            for c in clusters]


def _fan_out_query(args, uuids: Sequence[str]):
    """Find each uuid on whichever cluster knows it (querying.py)."""
    found: dict[str, tuple[str, dict]] = {}
    for cluster, client in _clients(args):
        remaining = [u for u in uuids if u not in found]
        if not remaining:
            break
        for uuid in remaining:
            try:
                job = client.query_one(uuid)
                found[uuid] = (cluster.name, job)
            except JobClientError as e:
                if e.status != 404:
                    raise
    return found


def cmd_submit(args) -> int:
    (cluster, client) = _clients(args)[0]
    command = " ".join(args.command)
    if not command and not sys.stdin.isatty():
        command = sys.stdin.read().strip()
    spec = {"command": command, "mem": args.mem, "cpus": args.cpus}
    if args.gpus:
        spec["gpus"] = args.gpus
    if args.name:
        spec["name"] = args.name
    if args.priority is not None:
        spec["priority"] = args.priority
    if args.max_retries is not None:
        spec["max_retries"] = args.max_retries
    if args.pool:
        spec["pool"] = args.pool
    if args.env:
        spec["env"] = dict(kv.split("=", 1) for kv in args.env)
    if args.gang_size:
        # one gang of k copies, all-or-nothing on one topology block
        uuids = client.submit([spec] * args.gang_size,
                              gang_size=args.gang_size)
    else:
        uuids = client.submit([spec] * args.copies)
    for uuid in uuids:
        print(uuid)
    return 0


def cmd_show(args) -> int:
    found = _fan_out_query(args, args.uuid)
    rc = 0
    for uuid in args.uuid:
        if uuid not in found:
            print(f"{uuid}: not found on any cluster", file=sys.stderr)
            rc = 1
            continue
        cluster_name, job = found[uuid]
        if args.json:
            print(json.dumps({"cluster": cluster_name, **job}, indent=2))
        else:
            print(f"{job['uuid']}  {job['status']:9s}  {job['name']}  "
                  f"(cluster {cluster_name}, user {job['user']}, "
                  f"mem {job['mem']}, cpus {job['cpus']})")
            for inst in job.get("instances", []):
                line = (f"  task {inst['task_id']}  {inst['status']:8s}  "
                        f"host {inst['hostname']}")
                if "reason_string" in inst:
                    line += f"  reason: {inst['reason_string']}"
                print(line)
    return rc


def cmd_wait(args) -> int:
    found = _fan_out_query(args, args.uuid)
    missing = [u for u in args.uuid if u not in found]
    if missing:
        print(f"not found: {missing}", file=sys.stderr)
        return 1
    by_cluster: dict[str, list[str]] = {}
    for uuid, (cluster_name, _) in found.items():
        by_cluster.setdefault(cluster_name, []).append(uuid)
    clients = {c.name: cl for c, cl in _clients(args)}
    deadline = time.monotonic() + args.timeout
    for cluster_name, uuids in by_cluster.items():
        remaining = max(1.0, deadline - time.monotonic())
        clients[cluster_name].wait(uuids, timeout_s=remaining)
    print("completed")
    return 0


def cmd_jobs(args) -> int:
    states = args.state.split(",") if args.state else []
    for cluster, client in _clients(args):
        jobs = client.list_jobs(args.lookup_user, states=states,
                                limit=args.limit)
        for job in jobs:
            print(f"{cluster.name}  {job['uuid']}  {job['status']:9s}  "
                  f"{job['name']}")
    return 0


def cmd_kill(args) -> int:
    found = _fan_out_query(args, args.uuid)
    rc = 0
    clients = {c.name: cl for c, cl in _clients(args)}
    for uuid in args.uuid:
        if uuid not in found:
            print(f"{uuid}: not found", file=sys.stderr)
            rc = 1
            continue
        cluster_name, _ = found[uuid]
        clients[cluster_name].kill([uuid])
        print(f"killed {uuid} on {cluster_name}")
    return rc


def _instance_output_url(args, uuid: str) -> Optional[tuple[str, dict]]:
    """Resolve a job/instance uuid to its sandbox file-server URL."""
    found = _fan_out_query(args, [uuid])
    if uuid not in found:
        print(f"{uuid}: not found", file=sys.stderr)
        return None
    _, job = found[uuid]
    insts = job.get("instances", [])
    if not insts:
        print(f"{uuid}: no instances yet", file=sys.stderr)
        return None
    inst = insts[-1]
    url = inst.get("output_url")
    if not url:
        print(f"{uuid}: no sandbox file server available", file=sys.stderr)
        return None
    return url, inst


def cmd_ls(args) -> int:
    resolved = _instance_output_url(args, args.uuid)
    if resolved is None:
        return 1
    url, _ = resolved
    params = {"path": args.path} if args.path else {}
    r = Session().get(f"{url}/files/browse", params=params, timeout=30)
    if r.status_code != 200:
        print(f"error: {r.text}", file=sys.stderr)
        return 1
    for entry in r.json():
        print(f"{entry['mode']} {entry['size']:>12}  {entry['path']}")
    return 0


def cmd_cat(args) -> int:
    resolved = _instance_output_url(args, args.uuid)
    if resolved is None:
        return 1
    url, _ = resolved
    session = Session()
    offset = 0
    while True:
        r = session.get(f"{url}/files/read",
                        params={"path": args.path, "offset": offset,
                                "length": 65536}, timeout=30)
        if r.status_code != 200:
            print(f"error: {r.text}", file=sys.stderr)
            return 1
        data = r.json()["data"]
        if not data:
            return 0
        sys.stdout.write(data)
        offset += len(data.encode())


def cmd_tail(args) -> int:
    resolved = _instance_output_url(args, args.uuid)
    if resolved is None:
        return 1
    url, _ = resolved
    session = Session()
    # seek to the end (offset=-1 returns the size), back off `lines`-ish
    r = session.get(f"{url}/files/read",
                    params={"path": args.path, "offset": -1}, timeout=30)
    if r.status_code != 200:
        print(f"error: {r.text}", file=sys.stderr)
        return 1
    size = r.json()["offset"]
    offset = max(0, size - args.bytes)
    while True:
        r = session.get(f"{url}/files/read",
                        params={"path": args.path, "offset": offset,
                                "length": 65536}, timeout=30)
        data = r.json().get("data", "")
        if data:
            sys.stdout.write(data)
            sys.stdout.flush()
            offset += len(data.encode())
        if not args.follow:
            if not data:
                return 0
        else:
            time.sleep(args.sleep_interval)


def cmd_why(args) -> int:
    """Explain why a job isn't running (unscheduled_jobs)."""
    found = _fan_out_query(args, [args.uuid])
    if args.uuid not in found:
        print(f"{args.uuid}: not found", file=sys.stderr)
        return 1
    cluster_name, job = found[args.uuid]
    clients = {c.name: cl for c, cl in _clients(args)}
    print(f"{args.uuid} is {job['status']} (cluster {cluster_name})")
    if job["status"] == "waiting":
        for reason in clients[cluster_name].unscheduled_reasons(args.uuid):
            line = f"  - {reason['reason']}"
            data = reason.get("data")
            if data:
                line += f"  {data}"
            print(line)
    return 0


def _fmt_ms(ms: Optional[float]) -> str:
    """Human-scale duration: 4100 -> "4.1s", 3_720_000 -> "1h02m"."""
    if ms is None:
        return "?"
    s = ms / 1000.0
    if s < 60:
        return f"{s:.1f}s"
    if s < 3600:
        return f"{int(s // 60)}m{int(s % 60):02d}s"
    return f"{int(s // 3600)}h{int(s % 3600 // 60):02d}m"


def cmd_timeline(args) -> int:
    """Render a job's lifecycle history (GET /jobs/{uuid}/timeline)."""
    found = _fan_out_query(args, [args.uuid])
    if args.uuid not in found:
        print(f"{args.uuid}: not found", file=sys.stderr)
        return 1
    cluster_name, _ = found[args.uuid]
    clients = {c.name: cl for c, cl in _clients(args)}
    tl = clients[cluster_name].timeline(args.uuid)
    if args.json:
        print(json.dumps(tl, indent=2))
        return 0
    print(f"{tl['uuid']}  {tl['state']}  (cluster {cluster_name}, "
          f"user {tl['user']}, pool {tl['pool']}, "
          f"priority {tl['priority']})")
    t0 = tl["submit_time_ms"]
    for event in tl["events"]:
        offset = _fmt_ms(event["t_ms"] - t0)
        kind = event["kind"]
        if kind == "submitted":
            line = f"submitted to pool {event['pool']}"
        elif kind == "waiting":
            line = event.get("summary") or (
                f"{event['cycles']} cycles skipped: {event['code']}")
            extras = [f"rank {event['last_rank']}"
                      if "last_rank" in event else "",
                      f"dru {event['last_dru']:.3f}"
                      if "last_dru" in event else ""]
            extras = ", ".join(e for e in extras if e)
            if extras:
                line += f"  ({extras})"
        elif kind == "matched":
            line = f"matched to {event.get('host', '?')} " \
                   f"(cycle {event['cycle']}"
            if "rank" in event:
                line += f", rank {event['rank']}"
            if "dru" in event:
                line += f", dru {event['dru']:.3f}"
            line += ")"
        elif kind == "launched":
            line = (f"launched task {event['task_id']} on "
                    f"{event['host']} (cluster {event['cluster']})")
        elif kind == "preempted":
            line = (f"PREEMPTED on {event.get('host', '?')} "
                    f"({event.get('reason', '?')})")
            ledger = event.get("preemption")
            if ledger:
                detail = [f"by user {ledger.get('preemptor_user', '?')}"]
                if ledger.get("dru_at_decision") is not None:
                    detail.append(f"dru {ledger['dru_at_decision']:.3f}")
                if ledger.get("runtime_lost_s") is not None:
                    detail.append(
                        f"runtime lost {ledger['runtime_lost_s']:.1f}s")
                line += "  [" + ", ".join(detail) + "]"
        elif kind == "instance-failed":
            line = (f"instance failed on {event.get('host', '?')} "
                    f"({event.get('reason', '?')})")
        elif kind == "completed":
            line = f"completed on {event.get('host', '?')}"
        elif kind == "re-queued":
            line = "re-queued (waiting again)"
        elif kind == "2pc-commit-decision":
            prepares = ", ".join(
                f"g{g} {ms:.1f}ms" for g, ms in sorted(
                    (event.get("prepare_ms") or {}).items()))
            line = (f"2PC commit decision across groups "
                    f"{event.get('groups')} (txn {event.get('txn_id')}"
                    + (f"; prepare {prepares}" if prepares else "") + ")")
        elif kind == "2pc-done":
            line = (f"2PC done across groups {event.get('groups')} "
                    f"(txn {event.get('txn_id')})")
        else:
            line = json.dumps(event)
        print(f"  +{offset:>8}  {line}")
    waiting = tl.get("waiting", {})
    if waiting.get("total_cycles"):
        parts = ", ".join(f"{code}: {n}" for code, n in sorted(
            waiting["cycles_by_reason"].items()))
        print(f"waiting attribution: {waiting['total_cycles']} cycles "
              f"({parts})")
    phases = tl.get("phases", {})
    summary = []
    if "submit_to_first_match_ms" in phases:
        summary.append("submit->first-match "
                       f"{_fmt_ms(phases['submit_to_first_match_ms'])}")
    summary.append(f"total run {_fmt_ms(phases.get('run_ms_total', 0))}")
    if "waiting_ms_current" in phases:
        summary.append(
            f"waiting now {_fmt_ms(phases['waiting_ms_current'])}")
    print("phases: " + ", ".join(summary))
    return 0


_SPARK_BLOCKS = "▁▂▃▄▅▆▇█"


def sparkline(values: Sequence[float], width: int = 60) -> str:
    """Render a value series as a unicode sparkline, downsampled to
    `width` columns (mean per column) — the terminal form of "what did
    this gauge look like for the last N minutes"."""
    values = [v for v in values if v is not None]
    if not values:
        return ""
    if len(values) > width:
        # mean-pool into `width` columns so a long window still fits
        chunk = len(values) / width
        values = [
            sum(col) / len(col) for col in (
                values[int(i * chunk):max(int(i * chunk) + 1,
                                          int((i + 1) * chunk))]
                for i in range(width))]
    lo, hi = min(values), max(values)
    span = hi - lo
    if span <= 0:
        return _SPARK_BLOCKS[0] * len(values)
    return "".join(
        _SPARK_BLOCKS[min(len(_SPARK_BLOCKS) - 1,
                          int((v - lo) / span * len(_SPARK_BLOCKS)))]
        for v in values)


def _fmt_value(v: Optional[float]) -> str:
    if v is None:
        return "?"
    if v == int(v) and abs(v) < 1e9:
        return str(int(v))
    return f"{v:.4g}"


def cmd_history(args) -> int:
    """Render metric history (GET /debug/history) as sparklines."""
    (cluster, client) = _clients(args)[0]
    body = client.history(args.metric, since=-abs(args.window),
                          step=args.step)
    if args.json:
        print(json.dumps(body, indent=2))
        return 0
    if not args.metric:
        for key, info in sorted(body.get("series", {}).items()):
            print(f"{info['points']:>6}  {key}")
        return 0
    series = body.get("series", {})
    if not any(series.values()):
        print(f"{args.metric}: no points in the last {args.window:.0f}s "
              f"on {cluster.name} (is the history sampler running?)",
              file=sys.stderr)
        return 1
    for key in sorted(series):
        points = series[key]
        if not points:
            continue
        if args.step == "raw":
            values = [v for _, v in points]
        else:
            values = [p["mean"] for p in points]
        print(f"{key}  [{args.step}] "
              f"last={_fmt_value(values[-1])} "
              f"min={_fmt_value(min(values))} "
              f"max={_fmt_value(max(values))} n={len(points)}")
        print(f"  {sparkline(values)}")
    return 0


def cmd_fleet(args) -> int:
    """Render the merged fleet verdict (GET /debug/fleet)."""
    rc = 0
    for cluster, client in _clients(args):
        fleet = client.fleet()
        if args.json:
            print(json.dumps({"cluster": cluster.name, **fleet}, indent=2))
            continue
        if not fleet.get("enabled"):
            print(f"{cluster.name}: fleet observatory disabled "
                  f"({fleet.get('detail', 'no peers configured')})")
            continue
        status = fleet.get("status", "?")
        reasons = ", ".join(fleet.get("reasons", [])) or "-"
        print(f"{cluster.name}: {status}  ({fleet.get('peers', 0)} peers, "
              f"reasons: {reasons})")
        for node in fleet.get("nodes", []):
            mark = "*" if node.get("self") else " "
            stale = node.get("staleness") or {}
            worst = max((ms for ms in stale.values() if ms is not None),
                        default=None)
            head = node.get("headline") or {}
            line = (f" {mark} {node.get('url', '?'):40s} "
                    f"{node.get('status', '?'):12s} "
                    f"poll-age {node.get('poll_age_s', 0):5.1f}s")
            if worst is not None:
                line += f"  staleness {worst:.0f}ms"
            if node.get("reasons"):
                line += f"  [{', '.join(node['reasons'])}]"
            if node.get("error"):
                line += f"  ({node['error']})"
            if head:
                line += "  " + " ".join(
                    f"{k.split('.')[-1]}={_fmt_value(v)}"
                    for k, v in sorted(head.items()))
            print(line)
        worst_shard = fleet.get("worst_shard")
        if worst_shard:
            print(f"  worst shard: {worst_shard['node']} "
                  f"shard {worst_shard['shard']} "
                  f"({worst_shard['staleness_ms']:.0f}ms behind)")
        if status != "ok":
            rc = 1
    return rc


def cmd_fairness(args) -> int:
    """Render the fairness observatory (GET /debug/fairness): per-pool
    Jain index, per-user DRU trajectories, preemption rollups and the
    recent ledger tail."""
    rc = 0
    for cluster, client in _clients(args):
        body = client.fairness(pool=args.pool, ledger=args.ledger)
        if args.json:
            print(json.dumps({"cluster": cluster.name, **body}, indent=2))
            continue
        pools = body.get("pools", {})
        if not pools:
            print(f"{cluster.name}: no fairness samples yet "
                  "(has a rank cycle run?)")
            continue
        for pool, view in sorted(pools.items()):
            jain = view.get("jain_index")
            rollups = view.get("rollups", {})
            wasted = rollups.get("wasted_s", {})
            frag = view.get("fragmentation", {})
            print(f"{cluster.name}/{pool}: jain {jain:.3f}  "
                  f"preemptions {rollups.get('preemptions', 0)} "
                  f"({rollups.get('tasks_preempted', 0)} tasks)  "
                  f"wasted {wasted.get('fairness', 0.0):.1f}s fairness / "
                  f"{wasted.get('mea_culpa', 0.0):.1f}s mea-culpa  "
                  f"fragmentation {frag.get('fragmentation', 0.0):.2f}")
            users = view.get("trajectories", {})
            for user in sorted(users,
                               key=lambda u: users[u].get("dru", 0.0),
                               reverse=True):
                point = users[user]
                usage = point.get("usage", {})
                line = (f"   {user:16s} dru {point.get('dru', 0.0):7.3f}  "
                        f"mem {usage.get('mem', 0.0):8.0f}  "
                        f"cpus {usage.get('cpus', 0.0):5.1f}  "
                        f"queued {point.get('queued', 0)}")
                if point.get("queue_dru") is not None:
                    line += f"  queue-dru {point['queue_dru']:.3f}"
                print(line)
            for entry in view.get("ledger", [])[-args.ledger:]:
                victims = entry.get("victims", [])
                vusers = sorted({v.get("user", "?") for v in victims})
                print(f"   ledger t={entry.get('t_ms', 0)}ms "
                      f"{entry.get('preemptor_user', '?')} preempted "
                      f"{len(victims)} task(s) of {', '.join(vusers)} "
                      f"on {entry.get('hostname', '?')} "
                      f"(dru {entry.get('min_preempted_dru', 0.0):.3f}, "
                      f"wasted {entry.get('wasted_s', 0.0):.1f}s)")
    return rc


def cmd_trace(args) -> int:
    """Render one transaction's merged cross-process trace as a text
    waterfall (GET /debug/trace?txn_id=; against the mp front end the
    body federates the front-end, coordinator, and worker slices)."""
    width = 40
    for cluster, client in _clients(args):
        body = client.trace(args.txn_id)
        spans = body.get("spans") or []
        if not spans:
            continue
        if args.json:
            print(json.dumps({"cluster": cluster.name, **body}, indent=2))
            return 0
        starts = [s["t"] - s.get("duration_s", 0.0) for s in spans]
        t0 = min(starts)
        window = max(max(s["t"] for s in spans) - t0, 1e-9)
        procs = [str(s.get("process") or
                     (s.get("tags") or {}).get("process") or "?")
                 for s in spans]
        proc_w = max(len(p) for p in procs)
        name_w = max(len(s["name"]) for s in spans)
        print(f"{args.txn_id}: {len(spans)} spans, "
              f"{len(set(procs))} process(es), "
              f"{window * 1000:.1f}ms window (cluster {cluster.name})")
        for proc, start, s in zip(procs, starts, spans):
            dur = s.get("duration_s", 0.0)
            lead = int((start - t0) / window * width)
            if dur <= 0.0:  # record_event marker (veto, replication ack)
                bar = " " * min(lead, width - 1) + "·"
                stamp = "event"
            else:
                fill = max(1, round(dur / window * width))
                bar = " " * min(lead, width - fill) + "█" * fill
                stamp = f"{dur * 1000:.2f}ms"
            mark = "  !error" if (s.get("tags") or {}).get("error") else ""
            print(f"  {proc:<{proc_w}}  {s['name']:<{name_w}}  "
                  f"|{bar:<{width}}|  {stamp}{mark}")
        failed = body.get("groups_failed")
        if failed:
            print(f"  (groups unreachable during collection: {failed})")
        return 0
    print(f"{args.txn_id}: no spans retained on any cluster "
          f"(span rings are finite — trace soon after the request)",
          file=sys.stderr)
    return 1


def cmd_usage(args) -> int:
    for cluster, client in _clients(args):
        usage = client.usage(args.lookup_user)
        total = usage["total_usage"]
        print(f"{cluster.name}: mem {total['mem']} cpus {total['cpus']} "
              f"gpus {total['gpus']} jobs {total['jobs']}")
    return 0


def cmd_retry(args) -> int:
    found = _fan_out_query(args, args.uuid)
    clients = {c.name: cl for c, cl in _clients(args)}
    for uuid in args.uuid:
        if uuid not in found:
            print(f"{uuid}: not found", file=sys.stderr)
            return 1
        cluster_name, _ = found[uuid]
        clients[cluster_name].retry(uuid, args.retries)
        print(f"set retries={args.retries} for {uuid}")
    return 0


def cmd_config(args) -> int:
    """Show or edit the federation config (reference: cs config)."""
    path = args.config or next(
        (p for p in DEFAULT_CONFIG_PATHS if os.path.exists(p)),
        DEFAULT_CONFIG_PATHS[0],
    )
    data = {"clusters": []}
    if os.path.exists(path):
        with open(path) as f:
            data = json.load(f)
    changed = False
    if args.add_cluster:
        name, url = args.add_cluster
        data["clusters"] = [c for c in data.get("clusters", [])
                            if c["name"] != name]
        data["clusters"].append({"name": name, "url": url})
        changed = True
    if args.remove_cluster:
        data["clusters"] = [c for c in data.get("clusters", [])
                            if c["name"] != args.remove_cluster]
        changed = True
    if changed:
        with open(path, "w") as f:
            json.dump(data, f, indent=2)
        print(f"wrote {path}")
    for c in data.get("clusters", []):
        print(f"{c['name']}\t{c['url']}")
    return 0


def cmd_admin_set_share(args) -> int:
    for cluster, client in _clients(args):
        r = client.session.post(
            f"{cluster.url}/share",
            json={"user": args.target_user, "pool": args.pool,
                  "share": {"mem": args.mem, "cpus": args.cpus,
                            "gpus": args.gpus},
                  "reason": args.reason},
            headers=client._headers(), timeout=30)
        print(f"{cluster.name}: {r.status_code}")
    return 0


def cmd_admin_set_quota(args) -> int:
    quota = {}
    for key in ("mem", "cpus", "gpus", "count"):
        value = getattr(args, key)
        if value is not None:
            quota[key] = value
    for cluster, client in _clients(args):
        r = client.session.post(
            f"{cluster.url}/quota",
            json={"user": args.target_user, "pool": args.pool,
                  "quota": quota, "reason": args.reason},
            headers=client._headers(), timeout=30)
        print(f"{cluster.name}: {r.status_code}")
    return 0


def cmd_admin_drain(args) -> int:
    for cluster, client in _clients(args):
        r = client.session.post(
            f"{cluster.url}/compute-clusters",
            json={"name": args.name, "state": "draining"},
            headers=client._headers(), timeout=30)
        print(f"{cluster.name}: {r.status_code} {r.text.strip()}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cs", description="cook-tpu scheduler CLI"
    )
    p.add_argument("--config", help="path to cluster config json")
    p.add_argument("--cluster", help="restrict to one named cluster")
    p.add_argument("--user", help="requesting user")
    p.add_argument("--route-map", action="store_true", dest="route_map",
                   help="shard-aware direct reads: fetch the route map "
                        "from GET /debug/shards and poll the owning "
                        "worker directly (mp fleets; falls back to the "
                        "front end on staleness or a moved segment)")
    sub = p.add_subparsers(dest="subcommand", required=True)

    sp = sub.add_parser("submit", help="submit a job")
    sp.add_argument("command", nargs="*", help="command to run")
    sp.add_argument("--mem", type=float, default=128.0)
    sp.add_argument("--cpus", type=float, default=1.0)
    sp.add_argument("--gpus", type=float, default=0.0)
    sp.add_argument("--name")
    sp.add_argument("--priority", type=int)
    sp.add_argument("--max-retries", type=int, dest="max_retries")
    sp.add_argument("--pool")
    sp.add_argument("--env", action="append", metavar="K=V")
    sp.add_argument("--copies", type=int, default=1)
    sp.add_argument("--gang-size", type=int, default=0, dest="gang_size",
                    help="submit K copies as ONE all-or-nothing gang "
                         "(all K place inside one topology block or "
                         "none do; overrides --copies)")
    sp.set_defaults(fn=cmd_submit)

    for name, fn, help_ in [
        ("show", cmd_show, "show jobs"),
        ("wait", cmd_wait, "wait for jobs to complete"),
        ("kill", cmd_kill, "kill jobs"),
    ]:
        q = sub.add_parser(name, help=help_)
        q.add_argument("uuid", nargs="+")
        if name == "show":
            q.add_argument("--json", action="store_true")
        if name == "wait":
            q.add_argument("--timeout", type=float, default=300.0)
        q.set_defaults(fn=fn)

    q = sub.add_parser("retry", help="update a job's retries")
    q.add_argument("uuid", nargs="+")
    q.add_argument("--retries", type=int, required=True)
    q.set_defaults(fn=cmd_retry)

    q = sub.add_parser("jobs", help="list a user's jobs")
    q.add_argument("--lookup-user", dest="lookup_user")
    q.add_argument("--state")
    q.add_argument("--limit", type=int, default=150)
    q.set_defaults(fn=cmd_jobs)

    q = sub.add_parser("usage", help="show a user's usage")
    q.add_argument("--lookup-user", dest="lookup_user")
    q.set_defaults(fn=cmd_usage)

    q = sub.add_parser("why", help="explain why a job isn't running")
    q.add_argument("uuid")
    q.set_defaults(fn=cmd_why)

    q = sub.add_parser(
        "timeline",
        help="render a job's full lifecycle history (per-cycle waits, "
             "launches, preemptions, re-queues)")
    q.add_argument("uuid")
    q.add_argument("--json", action="store_true")
    q.set_defaults(fn=cmd_timeline)

    q = sub.add_parser(
        "trace",
        help="render one transaction's merged cross-process trace "
             "(GET /debug/trace?txn_id=) as a text waterfall")
    q.add_argument("txn_id")
    q.add_argument("--json", action="store_true")
    q.set_defaults(fn=cmd_trace)

    q = sub.add_parser(
        "history",
        help="render a metric's retained history as a sparkline "
             "(GET /debug/history); no metric = list tracked series")
    q.add_argument("metric", nargs="?", default="",
                   help="series key, base name, or trailing-* prefix")
    q.add_argument("--step", choices=("raw", "1m", "10m"), default="raw")
    q.add_argument("--window", type=float, default=3600.0,
                   help="seconds of history to render (default 1h)")
    q.add_argument("--json", action="store_true")
    q.set_defaults(fn=cmd_history)

    q = sub.add_parser(
        "fleet",
        help="render the leader's merged fleet verdict (GET /debug/fleet):"
             " one row per node with peer health/staleness")
    q.add_argument("--json", action="store_true")
    q.set_defaults(fn=cmd_fleet)

    q = sub.add_parser(
        "fairness",
        help="render the fairness observatory (GET /debug/fairness): "
             "per-user DRU trajectories, preemption ledger, Jain index")
    q.add_argument("--pool", default=None, help="narrow to one pool")
    q.add_argument("--ledger", type=int, default=10,
                   help="recent preemption-ledger entries to show")
    q.add_argument("--json", action="store_true")
    q.set_defaults(fn=cmd_fairness)

    q = sub.add_parser("config", help="show or edit the federation config")
    q.add_argument("--add-cluster", nargs=2, metavar=("NAME", "URL"))
    q.add_argument("--remove-cluster", metavar="NAME")
    q.set_defaults(fn=cmd_config)

    q = sub.add_parser("ls", help="list a job's sandbox files")
    q.add_argument("uuid")
    q.add_argument("path", nargs="?", default="")
    q.set_defaults(fn=cmd_ls)

    q = sub.add_parser("cat", help="print a sandbox file")
    q.add_argument("uuid")
    q.add_argument("path")
    q.set_defaults(fn=cmd_cat)

    q = sub.add_parser("admin", help="admin operations")
    asub = q.add_subparsers(dest="admin_cmd", required=True)
    aq = asub.add_parser("set-share")
    aq.add_argument("--for-user", required=True, dest="target_user")
    aq.add_argument("--pool", default="default")
    aq.add_argument("--mem", type=float, default=0)
    aq.add_argument("--cpus", type=float, default=0)
    aq.add_argument("--gpus", type=float, default=0)
    aq.add_argument("--reason", default="")
    aq.set_defaults(fn=cmd_admin_set_share)
    aq = asub.add_parser("set-quota")
    aq.add_argument("--for-user", required=True, dest="target_user")
    aq.add_argument("--pool", default="default")
    aq.add_argument("--mem", type=float)
    aq.add_argument("--cpus", type=float)
    aq.add_argument("--gpus", type=float)
    aq.add_argument("--count", type=int)
    aq.add_argument("--reason", default="")
    aq.set_defaults(fn=cmd_admin_set_quota)
    aq = asub.add_parser("drain-cluster")
    aq.add_argument("name")
    aq.set_defaults(fn=cmd_admin_drain)

    q = sub.add_parser("tail", help="tail a sandbox file")
    q.add_argument("uuid")
    q.add_argument("path")
    q.add_argument("--bytes", type=int, default=2048)
    q.add_argument("--follow", "-f", action="store_true")
    q.add_argument("--sleep-interval", type=float, default=1.0)
    q.set_defaults(fn=cmd_tail)

    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except JobClientError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
