"""Multi-host dry run: the scale-out path on local processes.

Port of `examples/multihost_dryrun.py`.  It launches N processes that
join one `torch.distributed` process group (one rank a process, each
solving on its own device), form the global mesh over all ranks, and run
the pool-sharded match solve (`parallel/mesh.pool_sharded_match`) across
it: the recipe a deployment over several hosts uses, with local processes
standing in for the hosts.  Each rank holds POOLS_PER_PROCESS of the
batch's pools, the reference's 4 host devices a process, so 2 workers
solve the reference's 8-pool problem.

The ranks meet at `--coordinator` (`host:port`, a TCP rendezvous) or, by
default, at a `file://` rendezvous in a temporary directory, which needs
no port.  The backend is NCCL when each rank has a card of its own and
gloo otherwise (ranks sharing one card, or `--device cpu`).

    python -m cook_tpu_torch.examples.multihost_dryrun              # 2 workers
    python -m cook_tpu_torch.examples.multihost_dryrun --workers 4
    python -m cook_tpu_torch.examples.multihost_dryrun --device cpu --out a.json
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

POOLS_PER_PROCESS = 4
# jobs and hosts of each pool (the reference's recipe)
JOBS, HOSTS = 32, 16


def make_problems(n_pools: int):
    """The reference recipe's seeded pool batch, as numpy arrays:
    (demands [P, J, 3], avail [P, N, 3], totals [P, N, 2])."""
    import numpy as np

    rng = np.random.default_rng(0)
    demands = rng.uniform(1, 100, (n_pools, JOBS, 3)).astype(np.float32)
    demands[:, :, 2] = 0.0
    totals = rng.uniform(500, 1000, (n_pools, HOSTS, 2)).astype(np.float32)
    avail = np.concatenate(
        [totals, np.zeros((n_pools, HOSTS, 1), np.float32)], axis=-1)
    return demands, avail, totals


def _backend(device, num_processes: int) -> str:
    import torch

    return ("nccl" if torch.device(device).type == "cuda"
            and torch.cuda.device_count() >= num_processes else "gloo")


def worker(process_id: int, num_processes: int, init_method: str,
           device: str, out: str) -> int:
    # the ranks meet on this host's loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch
    import torch.distributed as dist

    from cook_tpu_torch.ops.match import MatchProblem
    from cook_tpu_torch.parallel.mesh import make_mesh, pool_sharded_match

    if "://" not in init_method:
        init_method = f"tcp://{init_method}"
    mesh = make_mesh(backend=_backend(device, num_processes), device=device,
                     init_method=init_method, rank=process_id,
                     world_size=num_processes)
    try:
        n_pools = POOLS_PER_PROCESS * mesh.size
        demands, avail, totals = make_problems(n_pools)
        problems = MatchProblem(
            demands=torch.from_numpy(demands),
            job_valid=torch.ones((n_pools, JOBS), dtype=torch.bool),
            avail=torch.from_numpy(avail),
            totals=torch.from_numpy(totals),
            node_valid=torch.ones((n_pools, HOSTS), dtype=torch.bool),
            feasible=torch.ones((n_pools, JOBS, HOSTS), dtype=torch.bool),
        )
        result = pool_sharded_match(mesh, problems)
        assignment = result.assignment.cpu().numpy()
        placed = int((assignment[mesh.lanes(n_pools)] >= 0).sum())
        print(f"[proc {process_id}] mesh {mesh.size} devices across "
              f"{num_processes} processes ({mesh.backend} on "
              f"{mesh.device.type}); local shards placed {placed} jobs",
              flush=True)
        if process_id == 0 and out:
            with open(out, "w") as f:
                json.dump({"assignment": assignment.tolist(),
                           "placed": int((assignment >= 0).sum()),
                           "backend": mesh.backend,
                           "device": str(mesh.device)}, f)
    finally:
        dist.destroy_process_group()
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workers", type=int, default=2)
    parser.add_argument("--worker-id", type=int, default=None)
    parser.add_argument("--coordinator", default="",
                        help="host:port of a TCP rendezvous, or a "
                             "file:// or tcp:// init method (default: a "
                             "file:// rendezvous in a temporary directory)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--out", default="",
                        help="rank 0 writes the whole batch's assignment "
                             "here as JSON")
    args = parser.parse_args(argv)
    if args.worker_id is not None:
        return worker(args.worker_id, args.workers, args.coordinator,
                      args.device, args.out)
    rendezvous = None
    if args.coordinator:
        init_method = args.coordinator
    else:
        rendezvous = tempfile.mkdtemp(prefix="cook-dryrun-")
        init_method = f"file://{os.path.join(rendezvous, 'rendezvous')}"
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    procs = []
    rc = 0
    try:
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "cook_tpu_torch.examples."
                 "multihost_dryrun", "--workers", str(args.workers),
                 "--worker-id", str(i), "--coordinator", init_method,
                 "--device", args.device, "--out", args.out],
                env=env)
            for i in range(args.workers)
        ]
        for p in procs:
            rc |= p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
                rc |= 1
        if rendezvous is not None:
            shutil.rmtree(rendezvous, ignore_errors=True)
    print("multihost dryrun", "OK" if rc == 0 else f"FAILED rc={rc}")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
