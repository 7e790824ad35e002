"""Simulator CLI: trace replay from the command line.

Port of `cook_tpu/sim/cli.py` (`run`, `synth`, `compare`, `loadgen`):
JSON trace in, CSV run-trace out, plus `compare` for determinism/
equivalence checking between two run traces — of either package, the
formats are the same — and `loadgen`, which drives a running service over
HTTP.

    python -m cook_tpu_torch.sim.cli run --trace trace.json --out run.csv [--device cpu]
    python -m cook_tpu_torch.sim.cli run --trace trace.json --rebalance-every 1 ...
    python -m cook_tpu_torch.sim.cli run --trace trace.json --resident ...
    python -m cook_tpu_torch.sim.cli run --trace trace.json --speculate ...
    python -m cook_tpu_torch.sim.cli run --trace trace.json --elastic [--elastic-every N] ...
    python -m cook_tpu_torch.sim.cli run --trace trace.json --faults faults.json ...
    python -m cook_tpu_torch.sim.cli run --trace trace.json --history-every 4 --history-out h.json ...
    python -m cook_tpu_torch.sim.cli run --trace trace.json --cycles-out c.json --trace-out tr.json --incidents-out inc/ --health-out h.json ...
    python -m cook_tpu_torch.sim.cli synth --jobs 1000 --hosts 100 --out trace.json
    python -m cook_tpu_torch.sim.cli synth --completion-heavy --jobs 48 --out trace.json
    python -m cook_tpu_torch.sim.cli synth --imbalanced --jobs 24 --out trace.json
    python -m cook_tpu_torch.sim.cli compare run1.csv run2.csv
    python -m cook_tpu_torch.sim.cli loadgen --url http://host:port --jobs 500 --rate 600

`run` solves on the CUDA card unless `--device cpu` is given; with no card
and no `--device cpu` it fails rather than run on the CPU.
"""
from __future__ import annotations

import argparse
import csv
import json
import os

from cook_tpu_torch.scheduler.core import SchedulerConfig
from cook_tpu_torch.scheduler.rebalancer import RebalancerParams
from cook_tpu_torch.sim.loadgen import (
    completion_heavy_trace,
    imbalanced_pool_trace,
)
from cook_tpu_torch.sim.simulator import (
    SimConfig,
    Simulator,
    load_trace,
    synth_trace,
)
from cook_tpu_torch.utils import tracing
from cook_tpu_torch.utils.config import default_match_config


def run_summary(result, jobs, hosts) -> dict:
    """The summary `run` prints: the reference's keys that the port can
    fill, the device-telemetry health verdict, the incidents captured,
    the committed elastic plans, the speculation A/B numbers and the
    data-plane summary (its rebuild fraction among them) included."""
    completed = sum(1 for r in result.rows if r["status"] == "success")
    p50 = (sorted(result.cycle_wall_s)[len(result.cycle_wall_s) // 2] * 1000
           if result.cycle_wall_s else 0.0)
    waits = result.queued_wait_ms()
    return {
        "cycles": result.cycles,
        "virtual_ms": result.virtual_ms,
        "jobs": len(jobs),
        "completed": completed,
        "utilization": round(result.utilization(hosts), 4),
        "cycle_wall_p50_ms": round(p50, 2),
        "phase_wall_s": {k: round(v, 3)
                         for k, v in result.phase_wall_s.items()},
        # device-telemetry verdict: a run that storms the padded shapes
        # or drifts from the CPU reference says so in its summary line
        "health": result.health.get("status", "unknown"),
        "health_reasons": result.health.get("reasons", []),
        # incident bundles captured mid-run (ok->degraded transitions)
        "incidents": len(result.incidents),
        # capacity-plane summary: committed plans + queued-wait p50, the
        # number the elastic A/B moves
        "elastic_plans": sum(1 for p in result.elastic_plans if p["moves"]),
        "queued_wait_p50_ms": (sorted(waits)[len(waits) // 2]
                               if waits else None),
        # speculation A/B numbers (with --speculate; zeros otherwise): the
        # fraction of cycles served from a committed speculative solve and
        # the cycle-start-to-first-launch p50 it exists to lower
        "speculation": result.speculation_stats(),
        # device data-plane summary: bytes the run moved host<->device and
        # the mean rebuild fraction of the encode rows
        "data_plane": result.data_plane,
    }


def sim_config(args) -> SimConfig:
    """SimConfig from `run`'s arguments: chunk/backend default to the
    tuned config (tuned_match.json) like the reference; flags override.
    `--faults` names a fault-schedule JSON armed for the run."""
    fault_schedule = None
    if args.faults:
        with open(args.faults) as f:
            fault_schedule = json.load(f)
    return SimConfig(
        cycle_ms=args.cycle_ms,
        rebalance_every=args.rebalance_every,
        elastic_every=(args.elastic_every if args.elastic else 0),
        max_cycles=args.max_cycles,
        batched_match=args.batched,
        resident=args.resident,
        speculate=args.speculate,
        fault_schedule=fault_schedule,
        history_every=args.history_every,
        scheduler=SchedulerConfig(
            match=default_match_config(
                max_jobs_considered=args.considerable,
                **{k: v for k, v in
                   (("chunk", args.chunk), ("backend", args.backend))
                   if v is not None}),
            rebalancer=RebalancerParams(
                safe_dru_threshold=args.safe_dru_threshold,
                min_dru_diff=args.min_dru_diff,
                max_preemption=args.max_preemption,
            ),
        ),
    )


def replay(args, on_sim=None):
    """`run`'s work without the printing: load the trace, replay it, write
    the run-trace CSV.  `on_sim`, if given, is called with the built
    Simulator just before it runs.  Returns (simulator, hosts, result)."""
    jobs, hosts = load_trace(args.trace)
    sim = Simulator(jobs, hosts, sim_config(args), device=args.device)
    if on_sim is not None:
        on_sim(sim)
    result = sim.run()
    with open(args.out, "w") as f:
        f.write(result.to_csv())
    return sim, hosts, result


def write_outputs(args, result) -> None:
    """`run`'s dump files, each in the reference's schema and each only
    when its flag names a path: the flight-recorder cycle records
    (`--cycles-out`, the GET /debug/cycles schema), the span ring as a
    Chrome trace (`--trace-out`, GET /debug/trace?format=chrome), the
    metrics history (`--history-out`, with `--history-every`), one JSON
    file per captured incident bundle (`--incidents-out`, GET
    /debug/incidents/{id}; tensors and profiler objects in a bundle are
    written as their `str`) and the end-of-run health verdict
    (`--health-out`, GET /debug/health)."""
    if args.cycles_out:
        with open(args.cycles_out, "w") as f:
            f.write(result.cycle_records_json())
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump(tracing.chrome_trace(), f, default=str)
    if args.history_out and result.metrics_history:
        # virtual-clock timestamps
        with open(args.history_out, "w") as f:
            json.dump(result.metrics_history, f, indent=1)
    if args.incidents_out:
        os.makedirs(args.incidents_out, exist_ok=True)
        for bundle in result.incidents:
            with open(os.path.join(args.incidents_out,
                                   f"{bundle['id']}.json"), "w") as f:
                json.dump(bundle, f, indent=1, default=str)
    if args.health_out:
        with open(args.health_out, "w") as f:
            json.dump(result.health, f, indent=1)


def cmd_run(args) -> int:
    sim, hosts, result = replay(args)
    # the summary first, then the files (the reference writes the health
    # file after its summary line)
    print(json.dumps(run_summary(result, sim.trace_jobs, hosts)))
    write_outputs(args, result)
    return 0


def write_trace(path: str, jobs, hosts) -> None:
    """The trace JSON both packages' `load_trace` read."""
    with open(path, "w") as f:
        json.dump({
            "jobs": [vars(j) for j in jobs],
            "hosts": [
                {k: (dict(v) if k == "attributes" else v)
                 for k, v in vars(h).items()}
                for h in hosts
            ],
        }, f)


def cmd_synth(args) -> int:
    if args.completion_heavy:
        # the speculative-cycle wave-drain scenario (sim/loadgen.py
        # completion_heavy_trace, the reference's 4 hosts); pair with
        # `run --speculate`
        jobs, hosts = completion_heavy_trace(jobs=args.jobs, seed=args.seed)
    elif args.imbalanced:
        # the elastic capacity plane's two-pool starving/idle scenario
        # (sim/loadgen.py imbalanced_pool_trace); pair with `run --elastic`
        jobs, hosts = imbalanced_pool_trace(busy_jobs=args.jobs,
                                            seed=args.seed)
    else:
        jobs, hosts = synth_trace(
            args.jobs, args.hosts, n_users=args.users, seed=args.seed,
            mean_runtime_ms=args.mean_runtime_ms,
            submit_span_ms=args.submit_span_ms,
        )
    write_trace(args.out, jobs, hosts)
    print(f"wrote {len(jobs)} jobs / {len(hosts)} hosts to {args.out}")
    return 0


def load_rows(path: str) -> list[dict]:
    with open(path) as f:
        return list(csv.DictReader(f))


def traces_equivalent(rows1: list[dict], rows2: list[dict],
                      *, keys=("job_uuid", "start_ms", "host", "status")
                      ) -> tuple[bool, list[str]]:
    """Order-insensitive equality on the decision-relevant columns."""
    def norm(rows):
        return sorted(tuple(r.get(k, "") for k in keys) for r in rows)

    n1, n2 = norm(rows1), norm(rows2)
    if n1 == n2:
        return True, []
    diffs = []
    s1, s2 = set(n1), set(n2)
    for row in list(s1 - s2)[:10]:
        diffs.append(f"only in first:  {row}")
    for row in list(s2 - s1)[:10]:
        diffs.append(f"only in second: {row}")
    return False, diffs


def cmd_compare(args) -> int:
    ok, diffs = traces_equivalent(load_rows(args.trace1),
                                  load_rows(args.trace2))
    if ok:
        print("traces equivalent")
        return 0
    print("traces DIFFER:")
    for d in diffs:
        print(" ", d)
    return 1


def cmd_loadgen(args) -> int:
    """Replay a generated workload against a deployed service over HTTP
    (`sim/loadgen.run_load`); exit 0 only when nothing failed and every
    submitted job completed."""
    import sys

    from cook_tpu_torch.sim.loadgen import LoadConfig, run_load

    config = LoadConfig(
        n_jobs=args.jobs, rate_per_minute=args.rate, n_users=args.users,
        seed=args.seed, speedup=args.speedup, pool=args.pool,
    )
    report = run_load(args.url, config, wait_timeout_s=args.wait_timeout_s,
                      log=lambda *a: print(*a, file=sys.stderr))
    summary = report.summary()
    print(json.dumps(summary))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f)
    return 0 if summary["failed"] == 0 and \
        summary["completed"] == summary["submitted"] else 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cook-tpu-torch-sim")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="replay a trace")
    r.add_argument("--trace", required=True)
    r.add_argument("--out", default="run.csv")
    r.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card only cpu runs")
    r.add_argument("--health-out", default="",
                   help="write the end-of-run /debug/health verdict here")
    r.add_argument("--cycles-out", default="",
                   help="dump flight-recorder cycle records (JSON) here")
    r.add_argument("--trace-out", default="",
                   help="dump the run's span ring as a chrome-trace JSON "
                        "(Perfetto-loadable) here")
    r.add_argument("--incidents-out", default="",
                   help="write captured incident bundles (one JSON per "
                        "bundle) into this directory")
    r.add_argument("--cycle-ms", type=int, default=30_000)
    r.add_argument("--rebalance-every", type=int, default=0,
                   help="cycles between rebalance passes (0 = off)")
    r.add_argument("--max-cycles", type=int, default=10_000)
    r.add_argument("--chunk", type=int, default=None,
                   help="matcher chunk; default = tuned_match.json / 0")
    r.add_argument("--backend", default=None,
                   choices=["xla", "pallas", "bucketed"],
                   help="candidate-pass backend; default = tuned config")
    r.add_argument("--considerable", type=int, default=1000)
    r.add_argument("--batched", action="store_true",
                   help="one device call for all pools")
    r.add_argument("--resident", action="store_true",
                   help="device-resident match state "
                        "(scheduler/device_state.py): encode tensors "
                        "stay on the device across cycles, O(delta) "
                        "updates")
    r.add_argument("--speculate", action="store_true",
                   help="prediction-assisted speculative match cycles "
                        "(scheduler/prediction.py): overlap cycle N+1's "
                        "solve with cycle N's drain")
    r.add_argument("--safe-dru-threshold", type=float, default=1.0)
    r.add_argument("--min-dru-diff", type=float, default=0.5)
    r.add_argument("--max-preemption", type=int, default=100)
    r.add_argument("--elastic", action="store_true",
                   help="enable the elastic capacity plane (pool "
                        "loaning + reclaim, cook_tpu_torch/elastic/)")
    r.add_argument("--elastic-every", type=int, default=1,
                   help="cycles between capacity plans (with --elastic)")
    r.add_argument("--faults", default="",
                   help="fault-schedule JSON armed for the run "
                        "(cook_tpu_torch.faults)")
    r.add_argument("--history-every", type=int, default=0,
                   help="cycles between metrics-history sample ticks on "
                        "the virtual clock (0 = off); dump with "
                        "--history-out")
    r.add_argument("--history-out", default="",
                   help="with --history-every: write the run's metrics "
                        "history dump here")
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("synth", help="generate a synthetic trace")
    s.add_argument("--jobs", type=int, default=1000)
    s.add_argument("--hosts", type=int, default=100)
    s.add_argument("--users", type=int, default=10)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--mean-runtime-ms", type=int, default=120_000)
    s.add_argument("--submit-span-ms", type=int, default=300_000)
    s.add_argument("--completion-heavy", action="store_true",
                   help="wave-drain speculation scenario (one job per "
                        "host per cycle); pair with `run --speculate`")
    s.add_argument("--imbalanced", action="store_true",
                   help="two-pool starving/idle elastic scenario instead "
                        "of the skewed single-pool workload")
    s.add_argument("--out", default="trace.json")
    s.set_defaults(fn=cmd_synth)

    c = sub.add_parser("compare", help="diff two run traces")
    c.add_argument("trace1")
    c.add_argument("trace2")
    c.set_defaults(fn=cmd_compare)

    lg = sub.add_parser(
        "loadgen",
        help="generate + replay a workload against a DEPLOYED service "
             "over HTTP (the deploy-scale simulator, simulator/README.md)")
    lg.add_argument("--url", required=True)
    lg.add_argument("--jobs", type=int, default=200)
    lg.add_argument("--rate", type=float, default=600.0,
                    help="arrival rate, jobs/minute")
    lg.add_argument("--users", type=int, default=8)
    lg.add_argument("--seed", type=int, default=0)
    lg.add_argument("--speedup", type=float, default=1.0)
    lg.add_argument("--pool", default=None)
    lg.add_argument("--wait-timeout-s", type=float, default=300.0)
    lg.add_argument("--out", default="")
    lg.set_defaults(fn=cmd_loadgen)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
