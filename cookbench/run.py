"""The benchmark of the PyTorch and CUDA scheduler (`cook_tpu_torch`).

One cell per process:

    python3 cookbench/run.py --workload one-pool.backlog --seed 7 \\
        --seconds 30 --trace 0

The cell (`BENCHMARK.json` `workloads`) names a deployment
(`cookbench/configs/<config>.json`) and a traffic mix
(`cookbench/traffic/<traffic>.json`).  Set-up makes the fleet and the
jobs from `--seed`, builds the program's store, mock cluster and
scheduler, and runs the traffic's warm-up cycles, which build every
kernel and warm every shape the window uses.  The window then runs whole
cycles (`loop.py`) until `--seconds` have passed; the cycle in progress
runs to its end.  Once the window has closed the judge
(`reference/judge.py`) holds what the window produced against the plain
reference, and the run prints each number compared beside its limit on
standard error, then one JSON line on standard output.  On the card the
window runs under `torch.profiler` in both modes, so the device's busy
time and the traced window come with every line:

- `--trace 0`: the cell's end-to-end metrics: the device's busy time a
  cycle, from the trace, and the set-up time, on the host clock;
- `--trace 1`: the cell's per-layer metrics, each read by
  `cookbench/metrics/<name>.py`, and a breakdown.

`--rehearse` runs the cell at its configuration's tiny size on the CPU
(for the tests; no device metric); `--control` also judges the controls
of the limits in the program's place (the reference in bfloat16, and the
reference with half of each solve's placements left out) and prints
their readings on standard error.  Without
`--rehearse` a run needs as many CUDA devices as the cell's chips.
"""
from __future__ import annotations

import time

_T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# whole top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "cook_tpu")
# window cycles whose packing and victims are held against the reference
SAMPLE_CYCLES = 3
REHEARSE_WARMUP = 1


def process_age_s() -> float:
    """Seconds since this process started (its start time in
    /proc/self/stat), or since this module was imported where /proc is
    not there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.monotonic() - _T_IMPORT


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "cookbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class WindowRun:
    """What the per-layer readers read, as plain data: the window's wall
    and the tasks it launched, each window cycle's step walls and the
    program's own phase walls summed over its pools, the program's
    data-plane counts over the window, each pool problem's size
    (considered jobs, hosts), the packing the judge measured, and on the
    card the device timeline and the card's peaks."""

    def __init__(self, window, wall_s, rebalance, h2d_bytes, problems,
                 timeline, peak):
        self.wall_s = wall_s
        self.launched = sum(sum(c.launched().values()) for c in window)
        self.walls = [dict(c.walls) for c in window]
        self.phases = []
        for c in window:
            sums: dict[str, float] = {}
            for out in c.outcomes.values():
                for k, v in out.phase_wall_s.items():
                    sums[k] = sums.get(k, 0.0) + v
            self.phases.append(sums)
        self.rebalance = rebalance
        self.h2d_bytes = h2d_bytes
        self.problems = problems
        self.timeline = timeline
        self.peak = peak
        self.packing: dict[str, float] = {}

    @property
    def cycles(self) -> int:
        return len(self.walls)

    def mean_wall(self, step: str):
        if not self.walls:
            return None
        return 1000.0 * statistics.fmean(w[step] for w in self.walls)

    def mean_phase(self, phase: str):
        if not self.phases:
            return None
        return 1000.0 * statistics.fmean(p.get(phase, 0.0)
                                         for p in self.phases)


def history(dep, hosts, config, cycles, first, rebalance, seed, records,
            sample_cycles=SAMPLE_CYCLES):
    """The run as the judge reads it (plain data); `sample_cycles` window
    cycles, drawn from the seed, have their packing and victims judged;
    `records` are the program's flight records, which name the route
    each pool's match took."""
    import numpy as np

    from cookbench.deploy import shares
    from cookbench.reference.judge import History

    cols = {k: [] for k in ("uuid", "user", "pool", "mem", "cpus", "gpus",
                            "priority", "runtime_ms")}
    recs = []
    for c, rec in enumerate(cycles):
        for a in rec.arrivals:
            for k in cols:
                cols[k].append(getattr(a, k))
        pools = {}
        for pool in dep.pools:
            name = pool.name
            out = rec.outcomes.get(name)
            entry = {"placed": [(j.uuid, o.hostname, tid) for (j, o), tid
                                in zip(out.matched, out.launched_task_ids)]
                     if out is not None else []}
            if c >= first:
                entry["queue"] = [j.uuid for j in rec.queues.get(name, ())]
            if rebalance:
                entry["decisions"] = [(d.job.uuid, d.hostname,
                                       list(d.task_ids))
                                      for d in rec.decisions.get(name, ())]
            pools[name] = entry
        recs.append({"t_ms": rec.t_ms, "n_arrivals": len(rec.arrivals),
                     "pools": pools})
    cfg = json.loads(json.dumps(config))
    for pool in cfg["pools"]:
        pool["share"] = shares(config, hosts)[pool["name"]]
    cycle_of = {rec.t_ms: c for c, rec in enumerate(cycles)}
    routes = {(cycle_of[r["t_ms"]], r["pool"]):
              "hierarchical" if r["hierarchical"] else "flat"
              for r in records if r["t_ms"] in cycle_of}
    window = list(range(first, len(cycles)))
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 11]))
    sample = sorted(int(c) for c in rng.choice(
        window, size=min(sample_cycles, len(window)), replace=False))
    return History(
        jobs={k: (np.asarray(v) if k not in ("uuid", "user", "pool") else v)
              for k, v in cols.items()},
        hosts={"pool": hosts.pool, "hostname": hosts.hostname,
               "mem": hosts.mem, "cpus": hosts.cpus, "gpus": hosts.gpus},
        cycles=recs, config=cfg, window_first=first, rebalance=rebalance,
        sample=sample, routes=routes)


def report(rec, phase: str) -> None:
    """One line on standard error a cycle: its walls and launches."""
    walls = " ".join(f"{k}={v:.3f}" for k, v in rec.walls.items())
    print(f"{phase} cycle {rec.index} t={rec.t_ms}: {walls} launched="
          f"{sum(rec.launched().values())} arrivals={len(rec.arrivals)} "
          f"preempted={sum(len(d.task_ids) for ds in rec.decisions.values() for d in ds)}",
          file=sys.stderr, flush=True)


def checks_line(numbers: dict) -> dict:
    """Each number compared, with its limit (at most), and whether it
    holds."""
    from cookbench.reference.judge import LIMITS

    return {name: {"value": value, "limit": LIMITS[name],
                   "ok": value <= LIMITS[name]}
            for name, value in numbers.items() if not name.startswith("_")}


def main(argv=None, bench=None) -> int:
    """One run; `bench` stands in for `BENCHMARK.json` (the tests)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse", action="store_true",
                    help="the cell at its tiny size on the CPU")
    ap.add_argument("--control", action="store_true",
                    help="judge the reference in bfloat16 in the program's "
                         "place")
    args = ap.parse_args(argv)

    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]

    import torch

    if not args.rehearse and (not torch.cuda.is_available()
                              or torch.cuda.device_count() < cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()} "
              f"and {torch.cuda.device_count()} are visible",
              file=sys.stderr)
        return 2

    from cookbench import deploy, loop
    from cookbench.reference import judge
    from cookbench.traffic import generator

    config = deploy.load_config(cell["config"])
    if args.rehearse:
        config = deploy.rehearsal(config)
    mix = generator.load(cell["traffic"])
    device = "cpu" if args.rehearse else "cuda"
    hosts = deploy.make_hosts(config, args.seed)
    dep = deploy.Deployment(config, hosts, device)
    traffic = generator.Traffic(mix, config, args.seed)
    lp = loop.Loop(dep, traffic, batched=bool(config["batched_match"]))
    warmup = REHEARSE_WARMUP if args.rehearse else traffic.warmup_cycles
    for _ in range(warmup):
        report(lp.cycle(), "warm-up")
    if device == "cuda":
        torch.cuda.synchronize()
    # every run enters its window with the collector's generations empty,
    # and what set-up built (fleet, store, backlog) is moved out of the
    # collector's reach: a full collection inside the window then scans
    # only what the window made, not the whole heap of set-up
    gc.collect()
    gc.freeze()

    from cook_tpu_torch.obs import data_plane

    h2d0 = {f: v["h2d_bytes"]
            for f, v in data_plane.LEDGER.family_totals().items()}
    traced = device == "cuda"
    prof = None
    if traced:
        from cookbench.trace import Profiler

        prof = Profiler()
        prof.__enter__()
        lp.span = prof.span
    setup_s = process_age_s()
    first = len(lp.cycles)
    t0 = time.perf_counter()
    window_span = prof.span("bench.window") if traced else None
    if window_span is not None:
        window_span.__enter__()
    while True:
        lp.cycle()
        if time.perf_counter() - t0 >= args.seconds:
            break
    if window_span is not None:
        window_span.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)

    window = lp.cycles[first:]
    for rec in window:
        report(rec, "window")
    print(f"setup {setup_s:.3f} s, window {wall:.3f} s, {len(window)} "
          f"cycles", file=sys.stderr)
    device_info = {"platform": "cpu", "kind": "cpu", "count": 0,
                   "memory_peak_bytes": 0}
    peak = None
    if device == "cuda":
        name = torch.cuda.get_device_name(0)
        device_info = {"platform": "gpu", "kind": name, "count": 1,
                       "memory_peak_bytes": int(
                           torch.cuda.max_memory_allocated(0))}
        with open(os.path.join(HERE, "metrics", "peaks.json")) as f:
            peak = json.load(f).get(name)

    timeline = prof.timeline() if prof is not None else None
    records = (dep.scheduler.recorder.records_json(
        limit=dep.scheduler.recorder.capacity)
        if dep.scheduler.recorder is not None else [])
    window_t = {c.t_ms for c in window}
    h2d1 = data_plane.LEDGER.family_totals()
    run = WindowRun(window, wall, traffic.rebalance,
                    {f: v["h2d_bytes"] - h2d0.get(f, 0)
                     for f, v in h2d1.items()},
                    [(r["considered"], r["offers"]) for r in records
                     if r["t_ms"] in window_t],
                    timeline, peak)

    found = forbidden_modules()
    if found:
        print("forbidden modules loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3

    # the judge runs once the window has closed, the peak is read and the
    # program's state is freed
    hist = history(dep, hosts, config, lp.cycles, first, traffic.rebalance,
                   args.seed, records,
                   len(window) if args.rehearse else SAMPLE_CYCLES)
    del dep, lp, window, prof, traffic, records
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    numbers = judge.judge(hist)
    print(f"judged in {time.perf_counter() - t_judge:.3f} s; max rss "
          f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss} kB",
          file=sys.stderr)
    controls = ({name: judge.judge(hist, control=name)
                 for name in judge.CONTROLS} if args.control else {})
    run.packing = {k[len("_packing_"):]: v for k, v in numbers.items()
                   if k.startswith("_packing_")}
    print("packing against the plain greedy: " + json.dumps(run.packing),
          file=sys.stderr)

    if args.trace == 1:
        metrics = {}
        for m in bench["per_layer"]:
            if args.workload not in m.get("workloads", [args.workload]):
                continue
            value = load_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {}
        if timeline is not None:
            metrics["device_busy_ms"] = {
                "value": 1000.0 * timeline.busy_s() / run.cycles,
                "unit": "ms"}
        metrics["setup_s"] = {"value": setup_s, "unit": "s"}
    if timeline is not None:
        device_info["busy_s"] = timeline.busy_s()
        device_info["window_s"] = timeline.window_s
    checks = checks_line(numbers)
    result = {
        "correct": all(c["ok"] for c in checks.values()),
        "attempted": numbers["_placements"] + numbers["_decisions"],
        "failed": sum(numbers[k] for k in checks if k.endswith("_errors")),
        "metrics": metrics,
        "device": device_info,
    }
    if timeline is not None and args.trace == 1:
        result["breakdown"] = {"device_ops": timeline.device_ops(),
                               "idle_gaps": timeline.idle_gaps()}
    result["checks"] = checks
    for name, control in controls.items():
        print(f"control {name} (the reference in the program's place): "
              + json.dumps(checks_line(control)), file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']} (limit {c['limit']})"
              f" {'ok' if c['ok'] else 'FAILED'}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
