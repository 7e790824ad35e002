"""Simulator CLI: trace replay from the command line.

Port of `cook_tpu/sim/cli.py` (`run`, `synth`, `compare`): JSON trace in,
CSV run-trace out, plus `compare` for determinism/equivalence checking
between two run traces — of either package, the formats are the same.

    python -m cook_tpu_torch.sim.cli run --trace trace.json --out run.csv [--device cpu]
    python -m cook_tpu_torch.sim.cli run --trace trace.json --rebalance-every 1 ...
    python -m cook_tpu_torch.sim.cli run --trace trace.json --resident ...
    python -m cook_tpu_torch.sim.cli synth --jobs 1000 --hosts 100 --out trace.json
    python -m cook_tpu_torch.sim.cli compare run1.csv run2.csv

`run` solves on the CUDA card unless `--device cpu` is given; with no card
and no `--device cpu` it fails rather than run on the CPU.
"""
from __future__ import annotations

import argparse
import csv
import json

from cook_tpu_torch.scheduler.core import SchedulerConfig
from cook_tpu_torch.scheduler.rebalancer import RebalancerParams
from cook_tpu_torch.sim.simulator import (
    SimConfig,
    Simulator,
    load_trace,
    synth_trace,
)
from cook_tpu_torch.utils.config import default_match_config


def run_summary(result, jobs, hosts) -> dict:
    """The summary `run` prints: the reference's keys that the port can
    fill, the device-telemetry health verdict and the data-plane summary
    (its rebuild fraction among them) included (`cook_tpu/sim/cli.py`
    also reports incidents, elastic and speculation numbers from layers
    not ported yet)."""
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
        "queued_wait_p50_ms": (sorted(waits)[len(waits) // 2]
                               if waits else None),
        # device data-plane summary: bytes the run moved host<->device and
        # the mean rebuild fraction of the encode rows
        "data_plane": result.data_plane,
    }


def sim_config(args) -> SimConfig:
    """SimConfig from `run`'s arguments: chunk/backend default to the
    tuned config (tuned_match.json) like the reference; flags override."""
    return SimConfig(
        cycle_ms=args.cycle_ms,
        rebalance_every=args.rebalance_every,
        max_cycles=args.max_cycles,
        batched_match=args.batched,
        resident=args.resident,
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


def cmd_run(args) -> int:
    sim, hosts, result = replay(args)
    print(json.dumps(run_summary(result, sim.trace_jobs, hosts)))
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="cook-tpu-torch-sim")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="replay a trace")
    r.add_argument("--trace", required=True)
    r.add_argument("--out", default="run.csv")
    r.add_argument("--device", default=None,
                   help="cuda (default) or cpu; without a card only cpu runs")
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
    r.add_argument("--safe-dru-threshold", type=float, default=1.0)
    r.add_argument("--min-dru-diff", type=float, default=0.5)
    r.add_argument("--max-preemption", type=int, default=100)
    r.set_defaults(fn=cmd_run)

    s = sub.add_parser("synth", help="generate a synthetic trace")
    s.add_argument("--jobs", type=int, default=1000)
    s.add_argument("--hosts", type=int, default=100)
    s.add_argument("--users", type=int, default=10)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--mean-runtime-ms", type=int, default=120_000)
    s.add_argument("--submit-span-ms", type=int, default=300_000)
    s.add_argument("--out", default="trace.json")
    s.set_defaults(fn=cmd_synth)

    c = sub.add_parser("compare", help="diff two run traces")
    c.add_argument("trace1")
    c.add_argument("trace2")
    c.set_defaults(fn=cmd_compare)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
