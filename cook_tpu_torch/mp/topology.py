"""Shard-group topology: which worker process owns which shards.

Port of `cook_tpu/mp/topology.py`.  The multi-process runtime splits the
N global shards (the `shard/` keyspace — pool-hash routing, per-shard journal
segments) over G worker processes.  Assignment is CONTIGUOUS blocks in
shard order: group g owns `shards_of_group(g)`, computed purely from
(n_shards, n_groups) so every process — front end, workers, supervisor,
clients holding a route map — derives the identical mapping without
coordination.  Key -> shard stays `ShardRouter`'s stable crc32 hash
(identical across processes and restarts, or journal-segment adoption
would scatter entities onto the wrong workers); key -> group is just
`group_of_shard(shard_for_key)`.

The ROUTE MAP is the serialized topology plus each group's live
endpoints.  The supervisor owns the file (data_dir/mp/routemap.json,
rewritten with a bumped `map_seq` on every failover) and the front end
serves it at GET /debug/shards, which is where shard-aware clients
fetch it for direct reads — a stale map shows up as a 421/404 and the
client falls back to the front end.  The reference's and the port's
route maps are the same file: either package's front end reads the
other's.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional, Sequence

from cook_tpu_torch.shard.router import META_SHARD, MisroutedKey, ShardRouter

ROUTEMAP_SCHEMA = "cook-routemap/v1"


@dataclass(frozen=True)
class ShardGroupTopology:
    """Deterministic (n_shards, n_groups) -> ownership mapping."""

    n_shards: int
    n_groups: int

    def __post_init__(self):
        if self.n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {self.n_shards}")
        if not 1 <= self.n_groups <= self.n_shards:
            raise ValueError(
                f"n_groups must be in [1, {self.n_shards}], "
                f"got {self.n_groups}")

    def shards_of_group(self, group: int) -> tuple[int, ...]:
        """Group g's contiguous shard block; the first
        `n_shards % n_groups` groups carry one extra shard."""
        if not 0 <= group < self.n_groups:
            raise ValueError(f"no group {group} in {self.n_groups}")
        base, rem = divmod(self.n_shards, self.n_groups)
        start = group * base + min(group, rem)
        return tuple(range(start, start + base + (1 if group < rem else 0)))

    def group_of_shard(self, shard: int) -> int:
        if not 0 <= shard < self.n_shards:
            raise ValueError(f"no shard {shard} in {self.n_shards}")
        base, rem = divmod(self.n_shards, self.n_groups)
        # invert the block layout: the first `rem` groups are (base+1)
        # wide, the rest `base` wide
        boundary = rem * (base + 1)
        if shard < boundary:
            return shard // (base + 1)
        return rem + (shard - boundary) // base

    # the group owning the META shard (global config, capacity ledger):
    # pool-less / global ops route here
    @property
    def meta_group(self) -> int:
        return self.group_of_shard(META_SHARD)

    # --------------------------------------------------------------- keys

    def group_for_pool(self, pool: str) -> int:
        return self.group_of_shard(
            ShardRouter(self.n_shards).shard_for_pool(pool))

    def group_for_user(self, user: str) -> int:
        return self.group_of_shard(
            ShardRouter(self.n_shards).shard_for_user(user))

    def pools_for_distinct_groups(self, prefix: str = "pool") -> list[str]:
        """One pool name per GROUP (probing the stable hash, the
        `pools_for_distinct_shards` pattern): a per-pool traffic split
        is then also a per-worker split — the killed-worker drill's
        blast-radius accounting depends on it."""
        found: dict[int, str] = {}
        i = 0
        while len(found) < self.n_groups:
            name = f"{prefix}{i}"
            found.setdefault(self.group_for_pool(name), name)
            i += 1
        return [found[g] for g in sorted(found)]


class GroupShardRouter(ShardRouter):
    """A worker's view of the global router: keys hash over the GLOBAL
    shard space, then map to this group's local shard indices.

    The worker's ShardedStore holds only its owned shards (local index
    order = ascending global shard id), so `plan()` and every facade
    lookup keep working unchanged — they just see local indices.  A key
    whose global shard this group does not own raises `MisroutedKey`
    (stale front-end map / stale client map), which the REST layer
    answers with 421 instead of writing into the wrong journal segment.
    """

    def __init__(self, n_global_shards: int, owned: Sequence[int]):
        owned = tuple(sorted(owned))
        if not owned:
            raise ValueError("a shard group must own at least one shard")
        for shard in owned:
            if not 0 <= shard < n_global_shards:
                raise ValueError(f"shard {shard} outside global space "
                                 f"of {n_global_shards}")
        # n_shards is the LOCAL count: ShardedStore sizes its shard list
        # and RoutePlan indices off it
        super().__init__(len(owned))
        self.n_global_shards = n_global_shards
        self.owned = owned
        self._local = {g: i for i, g in enumerate(owned)}

    def _localize(self, global_shard: int, key: str) -> int:
        local = self._local.get(global_shard)
        if local is None:
            raise MisroutedKey(key, global_shard, self.owned)
        return local

    def shard_for_pool(self, pool: str) -> int:
        return self._localize(
            ShardRouter(self.n_global_shards).shard_for_pool(pool),
            f"pool {pool!r}")

    def shard_for_user(self, user: str) -> int:
        return self._localize(
            ShardRouter(self.n_global_shards).shard_for_user(user),
            f"user {user!r}")


# ------------------------------------------------------------- route map


def build_route_map(topology: ShardGroupTopology,
                    entries: dict, map_seq: int = 1) -> dict:
    """The serialized topology + live endpoints.  `entries` maps group
    -> {"url", "rpc_url", "alive"}; groups without an entry render as
    dead (alive=False, empty urls) so a partially-booted fleet still
    serializes."""
    groups = []
    for g in range(topology.n_groups):
        entry = entries.get(g, {})
        groups.append({
            "group": g,
            "shards": list(topology.shards_of_group(g)),
            "url": entry.get("url", ""),
            "rpc_url": entry.get("rpc_url", ""),
            "alive": bool(entry.get("alive", False)),
        })
    return {
        "schema": ROUTEMAP_SCHEMA,
        "map_seq": int(map_seq),
        "n_shards": topology.n_shards,
        "n_groups": topology.n_groups,
        "groups": groups,
    }


def topology_of(route_map: dict) -> ShardGroupTopology:
    return ShardGroupTopology(int(route_map["n_shards"]),
                              int(route_map["n_groups"]))


def write_route_map(path: str, route_map: dict) -> None:
    """Atomic rewrite (tmp + fsync + rename): the front end and clients
    re-read on mtime change, and must never see a torn map."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(route_map, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def read_route_map(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        route_map = json.load(f)
    if route_map.get("schema") != ROUTEMAP_SCHEMA:
        raise ValueError(f"unknown route map schema in {path}: "
                         f"{route_map.get('schema')!r}")
    return route_map
