"""Replica-served reads: the staleness contract.

The port of `cook_tpu/shard/replica.py`'s decision rule,
`evaluate_staleness`, which the REST layer's replica-read gate calls on a
standby (`rest/api.py`); `ShardedJournalFollower` waits for the port's
sharded store.  An unsharded standby's `JournalFollower.staleness_view`
is shard 0 of a one-shard view.

The staleness contract replica reads advertise (rest/api.py serves it):

  * every replica-served heavy read carries `X-Cook-Staleness-Ms` — the
    worst shard's milliseconds since that shard last PROVED it held the
    leader's head — plus `X-Cook-Shard-Staleness` with the per-shard
    split; JSON-object bodies also carry a `staleness_ms` field;
  * staleness is MONOTONE per shard while the shard is behind (it
    counts from the newest freshness proof, so it can only grow until
    the next catch-up);
  * a staleness above the freshness ceiling falls back to the leader
    (307, the existing leader-proxy pattern);
  * a replica that STOPPED APPLYING (no successful leader poll within
    the refuse bound) refuses reads outright (503) — never served
    arbitrarily stale forever.
"""
from __future__ import annotations


def evaluate_staleness(view: dict[int, dict], *, ceiling_ms: float,
                       refuse_after_s: float) -> dict:
    """Fold a per-shard staleness view into the read decision:
    {"action": "serve"|"fallback"|"refuse", "staleness_ms": worst,
     "shards": {shard: ms}}.

    Refusal is reserved for a replica that STOPPED APPLYING (no
    successful leader poll within the refuse bound) — it must not serve
    stale forever, and it cannot vouch for a redirect target either.  A
    replica that is merely behind — including a fresh standby still
    catching up a backlog (staleness +inf, polls succeeding) — FALLS
    BACK to the leader instead: that keeps reads available through
    restarts exactly when clients need the redirect."""
    worst = 0.0
    shards: dict[int, float] = {}
    refusing = False
    for shard, row in sorted(view.items()):
        staleness = float(row.get("staleness_ms", float("inf")))
        shards[shard] = staleness
        worst = max(worst, staleness)
        if float(row.get("stalled_s", float("inf"))) >= refuse_after_s:
            refusing = True
    if refusing:
        action = "refuse"
    elif worst > ceiling_ms or worst == float("inf"):
        action = "fallback"
    else:
        action = "serve"
    return {"action": action, "staleness_ms": worst, "shards": shards}
