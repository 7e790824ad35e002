#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`cook_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

  1. device    — a CUDA card is present; its name and power limit as
                 `nvidia-smi` reports them.
  2. build     — the `best_node` kernel compiles from
                 cook_tpu_torch/csrc/best_node.cu into cook_tpu_torch/_build/.
  3. kernel    — `best_node` on the card against its plain PyTorch version
                 (`best_node_reference`) on the same inputs: identical
                 indices and bit-identical scores, at the cases listed in
                 KERNEL_CASES; CUDA-event times of both (median of 20).
  4. slice     — the simulator's CLI path on the card: a synthetic trace of
                 100,000 jobs x 10,000 hosts replayed for 3 cycles with the
                 chunked matcher on the `best_node` backend, with its launch
                 count reset just before and read just after.  The
                 arguments of every `best_node` call the matcher makes are
                 kept.
  5. launches  — every kept slice launch rerun and held against the plain
                 version (identical indices, bit-identical scores); the
                 kernel line's times are those of one of them.
  6. agreement — a small trace replayed on the card and on the CPU, whose
                 run traces must agree.
  7. report    — a `{"kernels": [...]}` line, then the last line
                 `{"ok": true, "device": {...}}`.

Imports nothing of JAX and nothing of `cook_tpu`.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# (label, K jobs, N nodes, kind), all with the simulator's R = 4 resource
# columns (mem, cpus, gpus, disk; matcher.encode_problem_arrays):
#   bench      bench.make_problem's jobs and hosts 20-100% free, no mask
#   mixed      the same plus gpu and disk columns in use, about half the
#              mask set
#   fleet      the slice's own fleet at a cycle's start: 10,000 identical
#              empty hosts padded to 16384, every real host feasible, so
#              every score ties and the first-index rule decides
#   infeasible demands no node can hold
KERNEL_CASES = [
    ("bench 16384x2048", 16384, 2048, "bench"),
    ("mixed 1024x16384 masked", 1024, 16384, "mixed"),
    ("fleet 1024x16384 masked", 1024, 16384, "fleet"),
    ("prime 1021x2039 masked", 1021, 2039, "mixed"),
    ("infeasible 1024x2048", 1024, 2048, "infeasible"),
]
FLEET_HOSTS = 10_000

SLICE_ARGS = ["--considerable", "16384", "--chunk", "1024",
              "--backend", "pallas", "--max-cycles", "3",
              "--cycle-ms", "30000"]


def phase(name):
    print(f"== {name}", flush=True)


def device_phase():
    import torch

    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def build_phase():
    from cook_tpu_torch import build

    phase("build")
    t0 = time.perf_counter()
    build.load("best_node")
    print(f"best_node built and loaded in {time.perf_counter() - t0:.2f} s",
          flush=True)


def make_inputs(k, n, kind, device, seed=0):
    """(demands, avail, totals, node_valid, mask) for one KERNEL_CASES
    kind; node_valid is all set, as chunked_match passes it when a mask
    carries node validity."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    mem = rng.choice([512, 1024, 2048, 4096, 8192], k).astype(np.float32)
    cpus = rng.choice([0.5, 1, 2, 4], k).astype(np.float32)
    zeros_k = np.zeros(k, dtype=np.float32)
    demands = np.stack([mem, cpus, zeros_k, zeros_k], axis=-1)
    totals = np.stack([np.full(n, 65536.0, dtype=np.float32),
                       np.full(n, 32.0, dtype=np.float32)], axis=-1)
    frac = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    avail = np.concatenate([totals * frac, np.zeros((n, 2), np.float32)],
                           axis=-1)
    mask = None
    if kind == "infeasible":
        demands[:, 0] = 1e9
    elif kind == "mixed":
        # one host in 8 carries 0-8 free gpus, every host 0-100 GB of free
        # disk; one job in 16 wants 1-2 gpus and half want 1-10 GB of disk
        gpu_host = rng.uniform(size=n) < 0.125
        avail[:, 2] = np.where(gpu_host, rng.integers(0, 9, n), 0)
        avail[:, 3] = rng.integers(0, 100_000, n)
        demands[:, 2] = np.where(rng.uniform(size=k) < 0.0625,
                                 rng.integers(1, 3, k), 0)
        demands[:, 3] = np.where(rng.uniform(size=k) < 0.5,
                                 rng.integers(1_000, 10_000, k), 0)
        mask = rng.uniform(size=(k, n)) < 0.5
    elif kind == "fleet":
        real = np.arange(n) < FLEET_HOSTS
        totals[~real] = 0.0
        avail = np.concatenate([totals, np.zeros((n, 2), np.float32)],
                               axis=-1)
        mask = np.broadcast_to(real, (k, n)).copy()
    valid = np.ones(n, dtype=bool)

    def put(a):
        return None if a is None else torch.as_tensor(a, device=device)

    return put(demands), put(avail), put(totals), put(valid), put(mask)


def cuda_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def best_node_bound(demands, avail, totals, valid, mask):
    """(bound_ms, bound_by) of one call on these inputs: each input read
    once and each output written once over the HBM rate, against the
    float32 operations of the (job, node) pairs the kernel scores — those
    the mask and node_valid let through — at ~(R + 8) each (R fit compares;
    two subtracts, two adds, two divides, a multiply and the running max)
    over the float32 peak."""
    k, r = demands.shape
    n = avail.shape[0]
    nbytes = (k * r * 4 + n * r * 4 + n * 2 * 4 + n
              + (k * n if mask is not None else 0) + k * 8)
    pairs = (int((mask & valid[None, :]).sum()) if mask is not None
             else k * int(valid.sum()))
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = pairs * (r + 8) / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_identical(label, args):
    """Kernel and plain version on the same arguments: identical indices
    and bit-identical scores.  Returns (val, idx, max_abs_err)."""
    import torch

    from cook_tpu_torch.ops import best_node as bn

    val, idx = bn.best_node(*args)
    rval, ridx = bn.best_node_reference(*args)
    torch.cuda.synchronize()
    if not torch.equal(idx, ridx):
        bad = int((idx != ridx).sum())
        raise AssertionError(f"best_node {label}: {bad}/{idx.numel()} "
                             "indices differ from the plain version")
    if not torch.equal(val.view(torch.int32), rval.view(torch.int32)):
        raise AssertionError(f"best_node {label}: scores not "
                             "bit-identical to the plain version")
    found = ridx >= 0
    err = (float((val[found] - rval[found]).abs().max())
           if bool(found.any()) else 0.0)
    return val, idx, err


def time_case(args):
    from cook_tpu_torch.ops import best_node as bn

    ms = cuda_ms(lambda: bn.best_node(*args))
    plain_ms = cuda_ms(lambda: bn.best_node_reference(*args))
    bound_ms, bound_by = best_node_bound(*args)
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def kernel_phase():
    import torch

    phase("kernel")
    dev = torch.device("cuda")
    max_err = 0.0
    for label, k, n, kind in KERNEL_CASES:
        args = make_inputs(k, n, kind, dev)
        _, idx, err = check_identical(label, args)
        max_err = max(max_err, err)
        if kind == "infeasible" and not bool((idx == -1).all()):
            raise AssertionError("best_node infeasible case placed a job")
        if kind == "fleet" and not bool((idx == 0).all()):
            raise AssertionError("best_node fleet case: on identical hosts "
                                 "every job must take the first host")
        row = time_case(args)
        print(f"best_node {label}: identical (found "
              f"{int((idx >= 0).sum())}/{k})  kernel {row['ms']:.4f} ms  "
              f"plain {row['plain_ms']:.4f} ms  bound {row['bound_ms']:.4f} "
              f"ms ({row['bound_by']})", flush=True)
    return max_err


def check_capacity(sim):
    """No host's running demand exceeds its capacity."""
    used = {}
    for rt in sim.cluster.running.values():
        u = used.setdefault(rt.spec.node_id, [0.0, 0.0, 0.0])
        u[0] += rt.spec.mem
        u[1] += rt.spec.cpus
        u[2] += rt.spec.gpus
    for node_id, (mem, cpus, gpus) in used.items():
        h = sim.cluster.hosts[node_id]
        if mem > h.mem or cpus > h.cpus or gpus > h.gpus:
            raise AssertionError(
                f"host {node_id} oversubscribed: running ({mem}, {cpus}, "
                f"{gpus}) > capacity ({h.mem}, {h.cpus}, {h.gpus})")
    return len(used)


@contextlib.contextmanager
def kept_best_node_calls(calls):
    """Append the arguments of every `best_node` call that `chunked_match`
    makes while the block runs.  The matcher builds fresh tensors for each
    call and never writes them in place, so keeping references keeps the
    exact inputs of each launch."""
    from cook_tpu_torch.ops import match

    original = match.best_node

    def keep(*args):
        calls.append(args)
        return original(*args)

    match.best_node = keep
    try:
        yield calls
    finally:
        match.best_node = original


def slice_phase(workdir, n_jobs=100_000, n_hosts=10_000):
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.sim import cli

    phase("slice")
    trace = os.path.join(workdir, "trace.json")
    t0 = time.perf_counter()
    cli.main(["synth", "--jobs", str(n_jobs), "--hosts", str(n_hosts),
              "--users", "50", "--submit-span-ms", "60000",
              "--out", trace])
    print(f"synth {time.perf_counter() - t0:.1f} s", flush=True)
    args = cli.build_parser().parse_args(
        ["run", "--trace", trace, "--out", os.path.join(workdir, "run.csv"),
         "--device", "cuda", *SLICE_ARGS])
    calls = []
    with kept_best_node_calls(calls):
        bn.launches = 0
        t0 = time.perf_counter()
        sim, hosts, result = cli.replay(args)
        wall = time.perf_counter() - t0
        launches = bn.launches
    summary = cli.run_summary(result, sim.trace_jobs, hosts)
    matched = sum(1 for r in result.rows if r["start_ms"] is not None)
    summary.update(matched=matched, best_node_launches=launches,
                   replay_wall_s=round(wall, 2),
                   cycle_wall_ms=[round(s * 1e3, 1)
                                  for s in result.cycle_wall_s])
    print("slice " + json.dumps(summary), flush=True)
    # best_node counts only launches on CUDA tensors, so launches > 0 also
    # shows the solve's tensors were on the card
    if sim.scheduler.device.type != "cuda" or launches <= 0:
        raise AssertionError(f"the slice solved on {sim.scheduler.device} "
                             f"with {launches} best_node launches")
    if len(calls) != launches:
        raise AssertionError(f"kept {len(calls)} best_node calls but the "
                             f"kernel counted {launches} launches")
    if matched <= 0:
        raise AssertionError("the slice placed no job")
    busy = check_capacity(sim)
    print(f"capacity ok on {busy} busy hosts", flush=True)
    return launches, calls


def slice_launch_phase(calls):
    """Every kept slice launch against the plain version; the times of the
    full-chunk first-pass launch of the last cycle (the most jobs still
    unplaced, latest first)."""
    import torch

    from cook_tpu_torch.ops.common import BIG

    phase("launches")
    max_err = 0.0
    shapes = set()
    for i, args in enumerate(calls):
        _, _, err = check_identical(f"slice launch {i}", args)
        max_err = max(max_err, err)
        shapes.add((tuple(args[0].shape), tuple(args[1].shape),
                    args[4] is not None))
    active = [int((a[0][:, 0] < BIG).sum()) for a in calls]
    pick = max(range(len(calls)), key=lambda i: (active[i], i))
    args = calls[pick]
    torch.cuda.synchronize()
    row = time_case(args)
    print(f"best_node slice launches: {len(calls)}/{len(calls)} identical "
          f"to the plain version; shapes (demands, avail, masked) "
          f"{sorted(shapes)}", flush=True)
    print(f"best_node slice launch {pick} ({active[pick]} jobs unplaced): "
          f"kernel {row['ms']:.4f} ms  plain {row['plain_ms']:.4f} ms  "
          f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    return row, max_err


def agreement_phase(workdir, n_jobs=3000, n_hosts=300):
    """A small trace replayed on the card and on the CPU (whose path the
    CPU tests hold against the JAX reference) must give the same run
    trace."""
    from cook_tpu_torch.sim import cli

    phase("agreement")
    trace = os.path.join(workdir, "small.json")
    cli.main(["synth", "--jobs", str(n_jobs), "--hosts", str(n_hosts),
              "--users", "50", "--submit-span-ms", "60000",
              "--out", trace])
    rows = {}
    for device in ("cuda", "cpu"):
        out = os.path.join(workdir, f"small-{device}.csv")
        args = cli.build_parser().parse_args(
            ["run", "--trace", trace, "--out", out, "--device", device,
             "--considerable", "16384", "--chunk", "1024",
             "--backend", "pallas", "--max-cycles", "6"])
        cli.replay(args)
        rows[device] = cli.load_rows(out)
    ok, diffs = cli.traces_equivalent(rows["cuda"], rows["cpu"])
    if not ok:
        raise AssertionError("card and CPU run traces differ:\n"
                             + "\n".join(diffs))
    placed = sum(1 for r in rows["cuda"] if r["start_ms"])
    print(f"card and CPU traces equivalent ({placed} placements)",
          flush=True)


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "cook_tpu_torch")):
        print("chip_smoke.py: cook_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_phase()
    build_phase()
    max_err = kernel_phase()
    with tempfile.TemporaryDirectory(prefix="cook-smoke-") as workdir:
        launches, calls = slice_phase(workdir)
        main_row, err = slice_launch_phase(calls)
        max_err = max(max_err, err)
        del calls
        agreement_phase(workdir)
    # the card's name and power limit again, beside the numbers above
    print(card)
    print(json.dumps({"kernels": [{
        "name": "best_node",
        "route": "cuda",
        "source": "cook_tpu_torch/csrc/best_node.cu",
        "replaces": "cook_tpu/ops/pallas_match.py:135",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        # no single PyTorch call computes a masked fit-and-argmax
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
