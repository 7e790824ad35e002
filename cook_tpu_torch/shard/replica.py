"""Replica-served reads: per-shard followers + the staleness contract.

A copy of `cook_tpu/shard/replica.py`, its imports the port's.
`ShardedJournalFollower` runs one `JournalFollower` per shard, each
tailing its own `?shard=i` feed into its own shard store and journal
segment — shard streams replicate independently, so one slow segment
never holds back the others' reads.  `evaluate_staleness` is the
decision rule the REST layer's replica-read gate calls on a standby
(`rest/api.py`); an unsharded standby's `JournalFollower.staleness_view`
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

from typing import Callable, Optional

from cook_tpu_torch.control.replication import JournalFollower
from cook_tpu_torch.shard.journal import shard_dir
from cook_tpu_torch.shard.store import ShardedStore
from cook_tpu_torch.utils.metrics import global_registry

_STALENESS_GAUGE_NAME = "shard.replica_staleness_ms"


class ShardedJournalFollower:
    """One JournalFollower per shard (same knobs, fanned out)."""

    def __init__(
        self,
        store: ShardedStore,
        *,
        leader_url_fn: Callable[[], str],
        self_url: str = "",
        data_dir: str = "",
        journals: Optional[list] = None,
        as_user: str = "admin",
        poll_s: float = 1.0,
        timeout_s: float = 10.0,
        long_poll_s: Optional[float] = None,
        member_id: str = "",
        on_leader_url: Optional[Callable[[str], None]] = None,
    ):
        self.store = store
        journals = journals or [None] * store.n_shards
        self.followers = [
            JournalFollower(
                shard,
                leader_url_fn=leader_url_fn,
                self_url=self_url,
                data_dir=shard_dir(data_dir, i) if data_dir else "",
                journal=journals[i],
                as_user=as_user,
                poll_s=poll_s,
                timeout_s=timeout_s,
                long_poll_s=long_poll_s,
                member_id=member_id or self_url or "standby",
                # one leader-url refresher is plenty; N followers
                # rewriting the same proxy target would just race
                on_leader_url=on_leader_url if i == 0 else None,
                shard=i,
            )
            for i, shard in enumerate(store.shards)
        ]
        self._staleness_gauge = global_registry.gauge(
            _STALENESS_GAUGE_NAME,
            "ms since this replica's shard last proved it held the "
            "leader's head (per shard)")

    def start(self) -> "ShardedJournalFollower":
        for follower in self.followers:
            follower.start()
        return self

    def stop(self) -> None:
        for follower in self.followers:
            follower.stop()

    def sync_once(self) -> int:
        return sum(f.sync_once() for f in self.followers)

    @property
    def synced_events(self) -> int:
        return sum(f.synced_events for f in self.followers)

    @property
    def full_resyncs(self) -> int:
        return sum(f.full_resyncs for f in self.followers)

    def staleness_view(self) -> dict[int, dict]:
        view: dict[int, dict] = {}
        for i, follower in enumerate(self.followers):
            row = follower.staleness_view()[i]
            staleness = row["staleness_ms"]
            self._staleness_gauge.set(
                staleness if staleness != float("inf") else -1.0,
                {"shard": str(i)})
            view[i] = row
        return view


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
