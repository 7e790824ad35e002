"""Transaction records: the unit every state mutation commits as.

A copy of `cook_tpu/txn/transaction.py`.

The reference's analog is one Datomic transaction (datomic.clj:79): a
named operation plus its data, identified well enough that a retried
commit is detected and answered from the log instead of re-applied.
"""
from __future__ import annotations

import uuid
from dataclasses import dataclass, field
from typing import Any, Optional


def new_txn_id() -> str:
    return uuid.uuid4().hex


@dataclass(frozen=True)
class Transaction:
    """One mutation heading into the commit pipeline.

    `payload` is op-specific and may hold live entity objects (e.g. the
    parsed `Job`s of a submission) — it is consumed by the op handler,
    never serialized.  What reaches the journal/replication feed is the
    `txn/committed` event (txn_id, op, JSON-able result) plus the entity
    events the op itself emitted.
    """

    op: str
    payload: dict[str, Any] = field(default_factory=dict)
    txn_id: str = field(default_factory=new_txn_id)


@dataclass
class TxnOutcome:
    """What a commit produced.

    `duplicate` means the idempotency key matched an already-committed
    transaction: nothing was re-applied and `result`/`seq` come from the
    recorded outcome.  `replicated` is None until a caller awaits the
    replication stage (rest/api.py), then True/False per the configured
    durability bound.
    """

    txn_id: str
    op: str
    seq: int
    result: Any
    duplicate: bool = False
    attempts: int = 1
    replicated: Optional[bool] = None
    # sharded control plane (cook_tpu/shard/): shard id -> the commit's
    # sequence number ON THAT SHARD.  Sequence numbers are only
    # comparable within one shard's history, so sync-ack replication
    # awaits each entry separately.  None on unsharded commits.
    shard_seqs: Optional[dict[int, int]] = None
    # per-phase wall seconds ({"apply": ..., "fsync": ...}; rest/api.py
    # adds "replication_ack") — the server-side half of the mp front
    # end's per-hop attribution, returned in the X-Cook-Hop-Walls
    # response header (obs/distributed.py).  None on duplicate answers.
    phase_walls: Optional[dict[str, float]] = None
