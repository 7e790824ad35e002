"""Multi-process shard-group runtime.

Port of `cook_tpu/mp/`.  The sharded control plane (`shard/`) keeps every
shard's lock, journal segment, and replication feed in ONE process, so
the interpreter lock caps the throughput win.  This package places
shard-GROUPS in separate worker processes behind a shard-aware front
end, all on the standard library's HTTP stack:

  * `topology`   — shard -> group assignment + the route map the front
    end serves at GET /debug/shards;
  * `worker`     — the per-group process: only its shards' stores,
    journal segments, idempotency tables, and replication feeds, the
    existing REST surface plus an internal RPC port
    (`python -m cook_tpu_torch.mp.worker`);
  * `twopc`      — cross-group transactions as a two-phase ordered
    apply over RPC, decision-journaled by the coordinator;
  * `router`     — the forwarding front end (keep-alive connections,
    per-worker circuit breakers, header passthrough, 2PC coordinator);
  * `supervisor` — spawns/monitors the worker fleet, promotes a standby
    to adopt a dead worker's journal segments, plus the `MpRuntime`
    harness `python -m cook_tpu_torch --mp N` runs.

The runtime is host-only: no process of it touches the card.
"""
from cook_tpu_torch.mp.topology import (GroupShardRouter, ShardGroupTopology,
                                        build_route_map, read_route_map,
                                        write_route_map)

__all__ = [
    "GroupShardRouter",
    "ShardGroupTopology",
    "build_route_map",
    "read_route_map",
    "write_route_map",
]
