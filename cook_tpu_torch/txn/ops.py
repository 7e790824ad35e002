"""Operation registry: op name -> handler(store, payload) -> result.

A copy of `cook_tpu/txn/ops.py`, its imports the port's: every op the
reference registers is registered here.

Every mutation type the REST surface (or an internal caller) can commit
is registered here, so the commit pipeline — idempotency, journal
durability, replication acks, bounded retries — is enforced in exactly
one place (`txn/log.py`) instead of per call site.  Handlers run under
the store lock (the store's RLock makes nested store calls safe), apply
via the store's transition methods (which emit the entity events), and
return a JSON-able result that is recorded with the transaction for
idempotent replays.
"""
from __future__ import annotations

from typing import Any, Callable

from cook_tpu_torch.models.store import JobStore, TransactionVetoed

OPS: dict[str, Callable[[JobStore, dict], Any]] = {}


class UnknownOperation(KeyError):
    pass


def txn_op(name: str):
    def deco(fn: Callable[[JobStore, dict], Any]):
        OPS[name] = fn
        return fn
    return deco


@txn_op("jobs/submit")
def _submit(store: JobStore, payload: dict) -> Any:
    uuids = store.submit_jobs(payload["jobs"], payload.get("groups", ()))
    return {"jobs": uuids}


@txn_op("jobs/kill")
def _kill(store: JobStore, payload: dict) -> Any:
    return {"killed": store.kill_jobs(payload["uuids"])}


@txn_op("group/kill")
def _group_kill(store: JobStore, payload: dict) -> Any:
    # membership resolves at apply time so a replayed record kills the
    # same set the original commit saw (the group events replicated with
    # the original commit carry the membership)
    killed = []
    for guuid in payload["groups"]:
        group = store.groups.get(guuid)
        if group is None:
            raise TransactionVetoed(f"no such group {guuid}")
        killed += store.kill_jobs(group.job_uuids)
    return {"killed": killed}


@txn_op("job/retry")
def _retry(store: JobStore, payload: dict) -> Any:
    job = store.retry_job(payload["uuid"], int(payload["retries"]),
                          increment=bool(payload.get("increment", False)))
    return {"uuid": job.uuid, "retries": job.max_retries,
            "state": job.state.value}


@txn_op("job/pool-move")
def _pool_move(store: JobStore, payload: dict) -> Any:
    moved = store.move_job_pool(payload["uuid"], payload["pool"])
    return {"uuid": payload["uuid"], "pool": payload["pool"], "moved": moved}


@txn_op("share/set")
def _share_set(store: JobStore, payload: dict) -> Any:
    share = payload["share"]
    store.set_share(share)
    return {"user": share.user, "pool": share.pool}


@txn_op("share/retract")
def _share_retract(store: JobStore, payload: dict) -> Any:
    store.retract_share(payload["user"], payload["pool"])
    return {"user": payload["user"], "pool": payload["pool"]}


@txn_op("quota/set")
def _quota_set(store: JobStore, payload: dict) -> Any:
    quota = payload["quota"]
    store.set_quota(quota)
    return {"user": quota.user, "pool": quota.pool}


@txn_op("quota/retract")
def _quota_retract(store: JobStore, payload: dict) -> Any:
    store.retract_quota(payload["user"], payload["pool"])
    return {"user": payload["user"], "pool": payload["pool"]}


@txn_op("pool/capacity-delta")
def _capacity_delta(store: JobStore, payload: dict) -> Any:
    """Elastic capacity plan deltas (cook_tpu/elastic/): loan/reclaim
    moves apply to the capacity ledger durably BEFORE any cluster is
    resized, so a failover between commit and resize leaves the new
    leader a consistent ledger to reconcile capacity from.  Idempotent
    like pool-move: a retried commit (same txn id) is answered from the
    transaction table; reclaims clamp at outstanding amounts."""
    moves = payload["moves"]
    for move in moves:
        if move.get("kind", "loan") not in ("loan", "reclaim"):
            raise TransactionVetoed(f"bad capacity move kind {move!r}")
        for side in ("from", "to"):
            if move.get(side) not in store.pools:
                raise TransactionVetoed(
                    f"unknown pool {move.get(side)!r} in capacity move")
        if move["from"] == move["to"]:
            raise TransactionVetoed("capacity move from a pool to itself")
        if any(float(move.get(d, 0.0)) < 0.0
               for d in store.CAPACITY_DIMS):
            raise TransactionVetoed("negative capacity move amount")
    return store.apply_capacity_moves(moves)


@txn_op("instance/cancel")
def _instance_cancel(store: JobStore, payload: dict) -> Any:
    cancelled = [tid for tid in payload["task_ids"]
                 if store.mark_instance_cancelled(tid)]
    return {"cancelled": cancelled}


@txn_op("config/update")
def _config_update(store: JobStore, payload: dict) -> Any:
    store.update_dynamic_config(payload["updates"])
    return {"updated": sorted(payload["updates"])}
