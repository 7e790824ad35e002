"""Tuning sweep of the chunked matcher's knobs at the headline shape.

Port of `tools/tpu_sweep.py`, renamed: the port runs on the card, not a
TPU.  It solves `make_problem`'s 100,000 jobs x 10,000 hosts (seed 2,
padded to 131,072 x 16,384) with `chunked_match` at each (chunk, passes,
rounds, kc) of the backend's grid, the reference's grids unchanged, and
holds each answer against the native exact greedy (`ops/native.py`; the
numpy greedy where the library cannot build): `packing_eff` is the placed
cpus over the oracle's.  Every record is a JSON line that
`tools/pick_tuned.py` reads unchanged, with the reference's keys,
`platform` "cuda" on the card (the device type otherwise, which
pick_tuned skips), and the card's name and power limit.  The sweep
resumes: configurations already recorded in `--out` are skipped.

The port's service reads the repo-root `tuned_match.json`, picked by the
reference's TPU sweep; this tool never writes it (`pick_tuned --out`
names where a pick goes).

    python -m cook_tpu_torch.tools.match_sweep --backend pallas
    python -m cook_tpu_torch.tools.match_sweep --backend xla --limit 2

`sweep(..., jobs=, hosts=, configs=)` runs a smaller problem or other
configurations from Python (the CPU tests do).
"""
from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys
import time

import numpy as np

# the reference's grids (tools/tpu_sweep.py), (chunk, passes, rounds, kc)
# axes per backend
GRIDS = {
    # kc is fixed at 1 by the backend; passes do the heavy lifting
    "pallas": ([4096, 8192, 16384, 32768, 131072], [4, 8, 12, 16],
               [1, 2, 3], [1]),
    # early passes are ~chunk/128 x cheaper, so larger chunks and one
    # extra pass (the exact cleanup) are the interesting region
    "bucketed": ([1024, 2048, 4096, 8192], [2, 3, 4], [2, 3], [64, 128]),
    "xla": ([1024, 2048, 4096, 8192], [1, 2, 3], [2, 3, 4],
            [32, 64, 128]),
}


def grid(backend: str) -> list[tuple[int, int, int, int]]:
    """The backend's (chunk, passes, rounds, kc) configurations, in the
    reference's order."""
    return list(itertools.product(*GRIDS[backend]))


def make_problem(j: int, n: int, seed: int = 0):
    """`bench.make_problem` (the reference's benchmark problem): j jobs
    of 512-8192 MB and 0.5-4 cpus, n hosts of 64 GB / 32 cpus each 20-100%
    free; (demands [j, 3], avail [n, 3], totals [n, 2]) float32."""
    rng = np.random.default_rng(seed)
    demands = np.stack(
        [
            rng.choice([512, 1024, 2048, 4096, 8192], j).astype(np.float32),
            rng.choice([0.5, 1, 2, 4], j).astype(np.float32),
            np.zeros(j, dtype=np.float32),
        ],
        axis=-1,
    )
    totals = np.stack(
        [np.full(n, 65536.0, dtype=np.float32),
         np.full(n, 32.0, dtype=np.float32)],
        axis=-1,
    )
    frac = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    avail = np.concatenate([totals * frac, np.zeros((n, 1), np.float32)],
                           axis=-1)
    return demands, avail, totals


def padded(count: int) -> int:
    """The padded axis: the next power of two (100,000 -> 131,072 and
    10,000 -> 16,384, the reference's shapes)."""
    return 1 << max(0, count - 1).bit_length()


def card_info(device) -> dict:
    """The device's name and power limit (nvidia-smi's words) for every
    record; the CPU has neither."""
    import torch

    if device.type != "cuda":
        return {"device": "cpu", "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.splitlines()[device.index or 0].strip()
    except (OSError, IndexError, subprocess.SubprocessError):
        limit = "not read"
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": limit}


def oracle(demands, avail, totals):
    """(assignment, kind, ms): the exact greedy on the host, native where
    the library builds, else numpy."""
    from cook_tpu_torch.ops import cpu_reference as ref
    from cook_tpu_torch.ops import native

    t0 = time.perf_counter()
    if native.available():
        assignment, kind = native.greedy_match(
            demands.astype(np.float64), avail.astype(np.float64),
            totals.astype(np.float64)), "c++"
    else:
        assignment, kind = ref.np_greedy_match(demands, avail,
                                               totals), "numpy"
    return assignment, kind, (time.perf_counter() - t0) * 1000


def _done_and_started(path: str):
    """Configurations `path` already holds a result for, and how often
    each was started without one (a config that hangs its process twice
    is abandoned, not retried forever)."""
    done, started = set(), {}
    try:
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    key = (r.get("backend", "xla"), r["chunk"],
                           r["passes"], r["rounds"], r["kc"])
                except (json.JSONDecodeError, KeyError, TypeError):
                    continue  # a truncated line from a killed writer
                if "p50_ms" in r or "error" in r:
                    done.add(key)
                elif r.get("started"):
                    started[key] = started.get(key, 0) + 1
    except FileNotFoundError:
        pass
    return done, started


def sweep(out_path: str, backend: str, *, jobs: int = 100_000,
          hosts: int = 10_000, seed: int = 2, repeats: int = 3,
          limit: int = 0, device="cuda", configs=None,
          log=lambda *a: None) -> list[dict]:
    """Run the backend's grid (or `configs`) on the problem, appending a
    record per configuration to `out_path`; at most `limit` of them when
    `limit` > 0.  Returns the records written."""
    import torch

    from cook_tpu_torch import device as device_mod
    from cook_tpu_torch.ops import cpu_reference as ref
    from cook_tpu_torch.ops.match import (MatchProblem, backend_flags,
                                          chunked_match)

    dev = device_mod.resolve(device)
    info = card_info(dev)
    platform = dev.type
    log(f"device: {info['device']} ({info['power_limit']})")
    J, N = padded(jobs), padded(hosts)
    demands, avail, totals = make_problem(J, N, seed=seed)
    job_valid = np.zeros(J, bool)
    job_valid[:jobs] = True
    node_valid = np.zeros(N, bool)
    node_valid[:hosts] = True

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    problem = MatchProblem(demands=put(demands), job_valid=put(job_valid),
                           avail=put(avail), totals=put(totals),
                           node_valid=put(node_valid), feasible=None)
    cpu_assign, kind, cpu_ms = oracle(demands[:jobs], avail[:hosts],
                                      totals[:hosts])
    q_cpu = ref.packing_quality(demands[:jobs], cpu_assign)
    log(f"cpu[{kind}] {cpu_ms:.0f} ms placed {q_cpu['num_placed']}")

    done, started = _done_and_started(out_path)
    records = []
    ran = 0
    with open(out_path, "a") as out:
        def write(record):
            print(json.dumps(record), flush=True)
            out.write(json.dumps(record) + "\n")
            out.flush()

        for chunk, passes, rounds, kc in (configs or grid(backend)):
            key = (backend, chunk, passes, rounds, kc)
            if key in done:
                continue
            if limit and ran >= limit:
                break
            ran += 1
            base = {"backend": backend, "chunk": chunk, "passes": passes,
                    "rounds": rounds, "kc": kc}
            if started.get(key, 0) >= 2:
                # a terminal record, so that an analysis of the grid can
                # tell "gave up after hangs" from "never ran"
                record = {**base,
                          "error": "abandoned after 2 hung attempts"}
                write(record)
                records.append(record)
                done.add(key)
                continue
            out.write(json.dumps({**base, "started": True}) + "\n")
            out.flush()
            try:
                # the fetch to the host waits for the card: each wall is
                # the whole solve
                def solve():
                    return chunked_match(
                        problem, chunk=chunk, rounds=rounds, kc=kc,
                        passes=passes, **backend_flags(backend)
                    ).assignment.cpu().numpy()

                t0 = time.perf_counter()
                a = solve()
                compile_ms = (time.perf_counter() - t0) * 1000
                times = []
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    a = solve()
                    times.append((time.perf_counter() - t0) * 1000)
                q = ref.packing_quality(demands[:jobs], a[:jobs])
                eff = (q["cpus_placed"] / q_cpu["cpus_placed"]
                       if q_cpu["cpus_placed"] else 1.0)
                record = {
                    "platform": platform,
                    **base,
                    "p50_ms": round(float(np.percentile(times, 50)), 1),
                    "compile_ms": round(compile_ms),
                    "placed": q["num_placed"],
                    "packing_eff": round(eff, 4),
                    "cpu_ms": round(cpu_ms),
                    **info,
                }
            except Exception as e:  # noqa: BLE001 — record and continue
                record = {**base, "error": str(e)[:200]}
            write(record)
            records.append(record)
    return records


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="sweep the chunked matcher's knobs on the card")
    parser.add_argument("--out", default="match_sweep.jsonl")
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--pallas", action="store_true",
                        help="alias for --backend pallas")
    parser.add_argument("--backend", default="xla",
                        choices=["xla", "pallas", "bucketed"],
                        help="candidate-pass backend to sweep")
    parser.add_argument("--limit", type=int, default=0, metavar="N",
                        help="run at most N configurations not yet in "
                             "--out (0: the whole grid)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.pallas:
        if args.backend not in ("xla", "pallas"):
            parser.error("--pallas conflicts with --backend "
                         f"{args.backend}; drop the legacy flag")
        args.backend = "pallas"
    sweep(args.out, args.backend, repeats=args.repeats, limit=args.limit,
          device=args.device,
          log=lambda *a: print(*a, file=sys.stderr, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
