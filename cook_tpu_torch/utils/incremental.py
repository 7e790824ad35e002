"""Incremental (percentage-rollout) config values.

A copy of `cook_tpu/utils/incremental.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.config-incremental (scheduler/src/cook/
config_incremental.clj): a runtime-mutable key maps to a list of
{value, portion} entries; an entity (job/user uuid) hashes to [0,1) and
picks the value whose cumulative portion covers it
(`select-config-from-values`, config_incremental.clj:89).  Used to roll
out defaults (e.g. container images) to a fraction of jobs.
"""
from __future__ import annotations

import hashlib
from typing import Any, Optional, Sequence

from cook_tpu_torch.models.store import JobStore

INCREMENTAL_PREFIX = "incremental:"


def entity_fraction(entity_id: str) -> float:
    """Stable hash of an entity id to [0, 1)."""
    digest = hashlib.sha256(entity_id.encode()).digest()
    return int.from_bytes(digest[:8], "big") / 2**64


def select_from_values(values: Sequence[dict], entity_id: str) -> Optional[Any]:
    """values: [{"value": v, "portion": 0.2}, ...] — portions should sum to
    1.0; the tail value absorbs any remainder."""
    if not values:
        return None
    x = entity_fraction(entity_id)
    cumulative = 0.0
    for entry in values:
        cumulative += float(entry.get("portion", 0.0))
        if x < cumulative:
            return entry.get("value")
    return values[-1].get("value")


def write_incremental(store: JobStore, key: str,
                      values: Sequence[dict]) -> None:
    store.update_dynamic_config({INCREMENTAL_PREFIX + key: list(values)})


def read_incremental(store: JobStore, key: str) -> list[dict]:
    return store.dynamic_config.get(INCREMENTAL_PREFIX + key, [])


def resolve_incremental(store: JobStore, key: str, entity_id: str,
                        default: Any = None) -> Any:
    value = select_from_values(read_incremental(store, key), entity_id)
    return default if value is None else value
