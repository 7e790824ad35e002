"""Unified durable transaction log: every state mutation is a Transaction.

A copy of `cook_tpu/txn/` (jax-free), its imports the port's.

Reference: every Cook mutation — submit, kill, retry, share/quota, group
ops, pool moves — goes through Datomic's `transact-with-retries`
(cook/datomic.clj:79) and is durable the
moment the REST call returns.  This package is that seam for the
rebuild: mutations are first-class `Transaction` records with
idempotency keys, committed through ONE pipeline

    in-memory apply (store lock) -> journal append (group fsync)
        -> sync-ack replication to live followers

with bounded retries and a single place to enforce durability policy
(`DurabilityPolicy`).  Followers replay the same records off the
journal feed, so leader and standby converge by construction and a
promoted standby answers idempotent re-submissions of already-acked
transactions without re-applying them.
"""
from cook_tpu_torch.txn.log import DurabilityPolicy, TransactionLog, TransientTxnError
from cook_tpu_torch.txn.ops import OPS, UnknownOperation, txn_op
from cook_tpu_torch.txn.transaction import Transaction, TxnOutcome

__all__ = [
    "DurabilityPolicy",
    "OPS",
    "Transaction",
    "TransactionLog",
    "TransientTxnError",
    "TxnOutcome",
    "UnknownOperation",
    "txn_op",
]
