"""Where a replay's time goes: `sim.cli run` under `torch.profiler`.

    python -m cook_tpu_torch.sim.profile --trace t.json [run options]

Takes the options of `python -m cook_tpu_torch.sim.cli run`, replays the
trace once under the profiler (CPU and CUDA activity), and prints one
JSON object: the per-cycle walls; the host-clock totals of the phases the
simulator records (`SimResult.phase_wall_s`: submit, the store's event
fan-out; rank; then match's encode = `prepare_pool_problem`, solve =
dispatch through the fetch that observes completion, launch =
`finalize_pool_match`, and for a hierarchical solve its coarse_solve /
fine_solve / refine split of solve, and rebalance under
`--rebalance-every`); the device time of every
kernel and copy the profiler saw (total, and the top ones); and the
device busy share of the replay's wall.  The profiler's own overhead is
inside those walls.  On a CPU-only run the device figures are null.
"""
from __future__ import annotations

import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cook_tpu_torch.sim import cli

def main(argv=None) -> int:
    args = cli.build_parser().parse_args(
        ["run", *(sys.argv[1:] if argv is None else argv)])
    activities = [ProfilerActivity.CPU]
    if args.device != "cpu":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        sim, hosts, result = cli.replay(args)
        if sim.scheduler.device.type == "cuda":
            torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    on_card = sim.scheduler.device.type == "cuda"
    # device-side rows only (kernels and copies): a CPU op's row repeats
    # its kernels' time as its own "self device" time
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in rows)
    top = sorted(rows, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    print(json.dumps({
        "device": (torch.cuda.get_device_name(0) if on_card else "cpu"),
        "summary": cli.run_summary(result, sim.trace_jobs, hosts),
        "cycle_wall_ms": [round(s * 1e3, 3) for s in result.cycle_wall_s],
        "replay_wall_ms": round(wall_s * 1e3, 3),
        # every phase but match, which is encode + solve + launch
        "phase_wall_ms": {k: round(v * 1e3, 3)
                          for k, v in result.phase_wall_s.items()
                          if k != "match"},
        "device_ms": round(device_us / 1e3, 3) if on_card else None,
        "device_busy_share": (round(device_us / 1e6 / wall_s, 5)
                              if on_card else None),
        "top_device_ms": ({e.key[:80]: [round(e.self_device_time_total
                                              / 1e3, 3), e.count]
                           for e in top} if on_card else None),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
