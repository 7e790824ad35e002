"""Shard routing: the one piece the port's REST layer needs so far.

From `cook_tpu/shard/router.py`: `MisroutedKey`, which the REST layer
answers with 421.  The deterministic op -> shard mapping (`ShardRouter`,
`RoutePlan`) waits for the control-plane slice.
"""
from __future__ import annotations

from typing import Sequence


class MisroutedKey(Exception):
    """A key whose owning shard this process does not serve.

    Raised by the multi-process runtime's group-scoped router (the
    reference's cook_tpu/mp/topology.py) when a request reaches a worker
    that owns only a subset of the global shard space — the symptom of a stale
    front-end route map or a client bypassing the front end with an old
    shard map.  The REST layer answers it with 421 Misdirected Request
    plus the owning shard, so the caller can refresh its map and retry
    instead of silently writing the key into the wrong journal segment.
    """

    def __init__(self, key: str, owner_shard: int,
                 owned: Sequence[int] = ()):
        self.key = key
        self.owner_shard = owner_shard
        self.owned = tuple(owned)
        super().__init__(
            f"{key} routes to shard {owner_shard}, which this process "
            f"does not serve (serving shards {list(self.owned)})")
