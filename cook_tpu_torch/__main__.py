"""`python -m cook_tpu_torch --config config.json` — run one scheduler node.

Port of `cook_tpu/__main__.py` (reference: cook.components/-main,
components.clj:345): the REST service on the standard library, and with
leadership the scheduling loops, the match cycle on the card's kernels.
`"platform": "cpu"` in the config runs the scheduler on the CPU; without
it and without a card the process refuses to start.  SIGTERM stops the
node as Ctrl-C does: the loops and the server shut down, and every
acknowledged submission is already on disk in `data_dir`'s journal.
With `leader_endpoint` (a `python -m cook_tpu_torch.control.lease_server`)
or `leader_lease_path` in the config the node runs as leader or hot
standby, whichever the lease decides: a standby tails the leader's
journal into its own `data_dir` and takes over when the lease lapses.
With `"shards": N` (N > 1) the store, its commit pipeline and its
journal are split into N shards (`shard/`), and a standby tails each
shard's segment on its own feed.

`python -m cook_tpu_torch --mp N [--mp-shards S] [--mp-standbys K]
[--data-dir D] [--port P]` runs the multi-process runtime (`mp/`)
instead: N shard-group worker processes over S global shards (one each by
default) and K warm standbys, behind a shard-aware front end on port P
(a free one by default) whose URL it prints.  The fleet is host-only: no
process of it touches the card.  SIGTERM stops the front end and every
worker and standby; none is left behind.
"""
from __future__ import annotations

import argparse
import logging
import signal
import sys

from cook_tpu_torch.components import (
    build_process,
    shutdown,
    start_leader_duties,
)
from cook_tpu_torch.utils.config import read_config


def _interrupt(_signum, _frame):
    raise KeyboardInterrupt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="cook-tpu-torch")
    parser.add_argument("--config", help="path to config json")
    parser.add_argument("--port", type=int)
    parser.add_argument("--no-leader", action="store_true",
                        help="serve REST only (no scheduling loops; /debug "
                             "reports leader false)")
    parser.add_argument("--mp", type=int, metavar="N",
                        help="multi-process mode: N shard-group worker "
                             "processes behind a shard-aware front end "
                             "(cook_tpu_torch.mp)")
    parser.add_argument("--mp-standbys", type=int, default=1,
                        help="warm standby workers for --mp failover")
    parser.add_argument("--mp-shards", type=int, default=None,
                        help="global shard count for --mp "
                             "(default: one shard per group)")
    parser.add_argument("--data-dir", default=None,
                        help="journal root for --mp "
                             "(default: a temp dir)")
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    if args.mp:
        return _mp_main(args)
    overrides = {}
    if args.port:
        overrides["port"] = args.port
    settings = read_config(args.config, overrides)
    process = build_process(settings)
    print(f"cook-tpu-torch listening on :{process.server.port} "
          f"(member {process.member_id}, device "
          f"{process.scheduler.device})", file=sys.stderr, flush=True)
    try:
        # SIGTERM stops a node that has booted; during boot it keeps its
        # default action, and during shutdown it is ignored so that the
        # journal is always closed
        signal.signal(signal.SIGTERM, _interrupt)
        if not args.no_leader:
            start_leader_duties(process)
        else:
            import time

            # a REST-only node is no leader: /debug must not say it is
            # (the reference's --no-leader leaves api.leader True), and
            # its scheduler executes no side effects
            process.api.leader = False
            process.scheduler.active = False
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        shutdown(process)
    return 0


def _mp_main(args) -> int:
    """`python -m cook_tpu_torch --mp N`: supervised worker fleet +
    front end, blocking until interrupted (Ctrl-C or SIGTERM)."""
    import time

    from cook_tpu_torch.mp.supervisor import MpRuntime

    # SIGTERM from the start: a fleet interrupted while it boots stops
    # the workers it spawned (MpRuntime and Supervisor.start clean up on
    # the way out)
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        runtime = MpRuntime(n_groups=args.mp, n_shards=args.mp_shards,
                            data_dir=args.data_dir,
                            standbys=args.mp_standbys, port=args.port)
    except KeyboardInterrupt:
        return 0
    try:
        workers = runtime.supervisor.workers
        print(f"cook-tpu-torch mp front end at {runtime.url} "
              f"({len(workers)} shard-group workers, "
              f"{args.mp_standbys} standby)", file=sys.stderr, flush=True)
        for g, handle in sorted(workers.items()):
            print(f"  group {g}: {handle.describe['url']} "
                  f"shards={handle.describe['shards']}", file=sys.stderr,
                  flush=True)
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        runtime.stop()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
