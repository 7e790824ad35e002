"""One entry point for the port's standing checks.

Port of `tools/ci_checks.py`: the same steps in the same order, one
verdict.

  1. `lint_metrics`: `cook_tpu_torch/tools/lint_metrics.py` over the
     port's tree, metric/span registration lint plus the
     docs/observability.md catalog drift check in both directions (the
     rows the port leaves out by design are its `LEFT_OUT`);
  2. `smoke_bench` and 3. `bench_gate`: the port has no benchmark yet
     (ROADMAP.md N1: the reference's `bench.py` imports JAX, which the
     card's machine lacks).  Both steps say so and run nothing; they
     report SKIP, which fails nothing;
  4. `chaos_smoke`: `python -m cook_tpu_torch.tools.chaos --smoke` (fsync
     stall -> shed, launch failures -> breaker, device error -> health
     device-degraded with no CPU re-solve, wedged shard -> single-shard
     blast radius, killed worker -> standby adoption); each scenario
     injects its fault, observes the health reason AND the reaction, then
     asserts full recovery;
  5. `debug_smoke`: `python -m cook_tpu_torch.tools.debug_smoke` boots a
     full-stack node and an mp fleet and GETs every /debug/* endpoint.

    python -m cook_tpu_torch.tools.ci_checks [--root DIR] [--device cpu]
                                             [--skip-bench]

`--skip-bench` runs the lint only.  Steps 4 and 5 run in subprocesses on
`--device` (the card by default): they take the card and arm the
process-global fault plane, neither of which belongs in this process.
Exit code: 0 when no step failed, 1 when any failed; each step's verdict
is printed either way (a later failure never masks an earlier one).
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# what the bench steps print instead of running
NO_BENCHMARK = ("the port has no benchmark yet (ROADMAP.md N1); "
                "nothing to run")


def run_lint(root: str) -> int:
    from cook_tpu_torch.tools import lint_metrics

    return lint_metrics.main([root])


def run_smoke_bench(root: str) -> None:
    """The reference's `bench.py --smoke` step: nothing to run until the
    port has its benchmark (ROADMAP.md N1)."""
    print(f"ci_checks: smoke_bench: {NO_BENCHMARK}", flush=True)


def run_bench_gate(root: str, threshold: float) -> None:
    """The reference's `tools/bench_gate.py` step over the smoke records:
    nothing to gate until the port writes them (ROADMAP.md N1)."""
    print(f"ci_checks: bench_gate: {NO_BENCHMARK} (threshold "
          f"{threshold})", flush=True)


def _module(root: str, module: str, *args: str, timeout_env: str,
            default_timeout_s: str) -> int:
    proc = subprocess.run(
        [sys.executable, "-m", module, *args], cwd=root,
        timeout=float(os.environ.get(timeout_env, default_timeout_s)))
    return proc.returncode


def run_chaos_smoke(root: str, device: str = "cuda") -> int:
    """Chaos smoke in a SUBPROCESS: the scenarios take the device and arm
    the process-global fault plane."""
    return _module(root, "cook_tpu_torch.tools.chaos", "--smoke",
                   "--device", device, timeout_env="CI_CHAOS_TIMEOUT_S",
                   default_timeout_s="300")


def run_debug_smoke(root: str, device: str = "cuda") -> int:
    """Debug-surface smoke in a SUBPROCESS (boots a full scheduler on the
    device): GET every /debug/* endpoint of a live node and an mp fleet
    and assert 200 + parseable JSON."""
    return _module(root, "cook_tpu_torch.tools.debug_smoke", "--device",
                   device, timeout_env="CI_DEBUG_SMOKE_TIMEOUT_S",
                   default_timeout_s="180")


STEPS = ("lint_metrics", "smoke_bench", "bench_gate", "chaos_smoke",
         "debug_smoke")


def main(argv: list[str] | None = None, *,
         steps: dict | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="run the port's standing checks as one pipeline")
    parser.add_argument("--root", default=REPO_ROOT)
    parser.add_argument("--threshold", type=float, default=0.2,
                        help="bench-gate max tolerated slowdown")
    parser.add_argument("--skip-bench", action="store_true",
                        help="lint only (no smoke bench, no gate)")
    parser.add_argument("--device", default="cuda",
                        help="the chaos and debug smokes' device: cuda "
                             "(default) or cpu")
    args = parser.parse_args(argv)

    # injectable steps so the orchestration is testable without paying
    # for the real ones; a step returns its exit code, or None when it
    # ran nothing
    steps = steps or {
        "lint_metrics": lambda: run_lint(args.root),
        "smoke_bench": lambda: run_smoke_bench(args.root),
        "bench_gate": lambda: run_bench_gate(args.root, args.threshold),
        "chaos_smoke": lambda: run_chaos_smoke(args.root, args.device),
        "debug_smoke": lambda: run_debug_smoke(args.root, args.device),
    }
    selected = ["lint_metrics"] if args.skip_bench else list(STEPS)

    failures = []
    for name in selected:
        print(f"ci_checks: === {name} ===", flush=True)
        try:
            code = steps[name]()
        except Exception as e:  # noqa: BLE001 — report, keep checking
            print(f"ci_checks: {name} raised {type(e).__name__}: {e}",
                  file=sys.stderr)
            code = 1
        status = ("SKIP" if code is None else
                  "PASS" if code == 0 else f"FAIL (exit {code})")
        print(f"ci_checks: {name}: {status}", flush=True)
        if code:
            failures.append(name)
    if failures:
        print(f"ci_checks: FAILED: {', '.join(failures)}")
        return 1
    print("ci_checks: all checks passed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
