"""Journal replication: standbys tail the leader's committed-event feed.

A copy of `cook_tpu/control/replication.py` (standard library only), its
imports the port's; the feed it tails is `rest/api.py`'s
`/replication/*` routes, whose wire format both packages share (a port
follower tails a reference leader and the other way round).

Reference: Datomic is an external, REPLICATED source of truth — every
scheduler node sees the same transaction log, and leader failover simply
replays state from the DB (datomic.clj:45-127, the tx-report mult at
:49; kubernetes/compute_cluster.clj:269).  This rebuild's store persists
to the leader's local disk, so without replication a dead leader machine
takes the cluster state with it.  `JournalFollower` closes that gap: a
standby polls the leader's `/replication/journal` feed (rest/api.py),
applies the events to its own in-memory store, and appends them to its
OWN on-disk journal — so promotion works entirely from the standby's
local copy, and the old leader's data directory can be lost outright.

Bootstrap / gap handling: when the leader reports `snapshot_required`
(the follower is behind the leader's retained event window — e.g. a
fresh standby, or a leader that itself just recovered from disk), the
follower fetches `/replication/snapshot`, rebuilds its store in place,
rewrites its local snapshot file, and rotates its journal — then resumes
tailing from the snapshot's sequence number.

The follower also refreshes `api.leader_url` each poll so a standby's
REST layer always proxies to the CURRENT leader (the reference's
leader-proxying, rest/api.clj:2408).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Optional

from cook_tpu_torch import faults
from cook_tpu_torch.models import persistence
from cook_tpu_torch.models.store import JobStore
from cook_tpu_torch.utils.metrics import global_registry
from cook_tpu_torch.utils.retry import RetryPolicy, backoff_s

log = logging.getLogger(__name__)

# follower-side apply walls: a batch is normally sub-ms, but a snapshot-
# sized backlog page can take seconds
_APPLY_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                  30.0, float("inf"))


class JournalFollower:
    def __init__(
        self,
        store: JobStore,
        *,
        leader_url_fn: Callable[[], str],
        self_url: str = "",
        data_dir: str = "",
        journal: Optional[persistence.JournalWriter] = None,
        as_user: str = "admin",
        poll_s: float = 1.0,
        timeout_s: float = 10.0,
        long_poll_s: Optional[float] = None,
        member_id: str = "",
        on_leader_url: Optional[Callable[[str], None]] = None,
        reconnect_policy: Optional[RetryPolicy] = None,
        shard: Optional[int] = None,
    ):
        self.store = store
        # sharded control plane (the reference's cook_tpu/shard/, whose
        # port waits): this follower tails ONE shard's journal segment
        # (`?shard=` on the feed/snapshot endpoints, `shard` in every
        # ack).  None = the unsharded feed.
        self.shard = shard
        self.leader_url_fn = leader_url_fn
        self.self_url = self_url.rstrip("/")
        self.data_dir = data_dir
        self.journal = journal
        self.as_user = as_user
        self.poll_s = poll_s
        self.timeout_s = timeout_s
        # long-poll window: the journal request parks on the leader until
        # the next commit, so replication is push-like.  Must stay under
        # timeout_s or an idle long-poll reads as a transport error.
        self.long_poll_s = (max(0.0, timeout_s - 2.0)
                            if long_poll_s is None else long_poll_s)
        self.member_id = member_id or self.self_url or "standby"
        self._last_acked = -1
        self.on_leader_url = on_leader_url
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # the leader incarnation the feed we're tailing belongs to: event
        # sequence numbers are only comparable within one leader history,
        # so a change (failover, or a leader restarted from its own disk)
        # forces a snapshot bootstrap rather than risking silent
        # divergence (a deposed leader may hold committed events the new
        # leader never saw)
        self._leader_incarnation: Optional[str] = None
        # observability for tests/debug endpoints
        self.synced_events = 0
        self.full_resyncs = 0
        self.last_error: str = ""
        # correlation: txn_id of the newest txn/committed event applied —
        # rides in every ack so the leader can tie a replication ack back
        # to the mutation it makes durable (docs/observability.md)
        self.last_txn_id: str = ""
        # reconnect backoff: on leader transport errors the poll loop
        # backs off with jittered exponential delays (capped) instead of
        # retrying tight at poll_s — a dead leader with N standbys must
        # not eat N tight retry loops of connection attempts.  The
        # max_attempts bound is irrelevant here (the loop retries until
        # stopped); only the delay curve is used.
        self.reconnect_policy = reconnect_policy or RetryPolicy(
            base_s=max(poll_s, 0.2), multiplier=2.0, cap_s=30.0,
            jitter=0.5)
        self._consecutive_failures = 0
        self._transport_error = False
        self.reconnect_attempts = 0  # lifetime total, tests/chaos read it
        # replica-read staleness (shard/replica.py): when this
        # follower last PROVED it held the leader's head (applied >= the
        # feed's last_seq on a successful poll), and when it last made
        # any successful poll at all.  Replica-served reads bound their
        # staleness from the first and refuse off the second.
        self._fresh_at: Optional[float] = None
        self._last_progress: Optional[float] = None
        self._reconnects = global_registry.counter(
            "replication.reconnects",
            "follower reconnect attempts after leader transport errors")

    # ------------------------------------------------------------- transport

    def _get(self, url: str, *, timeout_s: Optional[float] = None
             ) -> Optional[dict]:
        req = urllib.request.Request(
            url, headers={"X-Cook-Requesting-User": self.as_user})
        try:
            # fault point: a dropped fetch (error mode) takes the exact
            # transport-failure path below; a delay rule is a slow link
            # or wedged follower
            fault_schedule = faults.ACTIVE
            if fault_schedule is not None:
                fault_schedule.hit(faults.REPLICATION_FETCH,
                                   follower=self.member_id)
            with urllib.request.urlopen(
                    req, timeout=timeout_s or self.timeout_s) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            self.last_error = str(e)
            self._transport_error = True
            return None

    def _post(self, url: str, payload: dict) -> Optional[dict]:
        req = urllib.request.Request(
            url, data=json.dumps(payload).encode(),
            headers={"X-Cook-Requesting-User": self.as_user,
                     "Content-Type": "application/json"}, method="POST")
        try:
            fault_schedule = faults.ACTIVE
            if fault_schedule is not None:
                fault_schedule.hit(faults.REPLICATION_ACK,
                                   follower=self.member_id)
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return json.loads(r.read())
        except (urllib.error.URLError, OSError, ValueError) as e:
            self.last_error = str(e)
            self._transport_error = True
            return None

    # ------------------------------------------------------------------ sync

    def sync_once(self) -> int:
        """One poll: fetch and apply everything the leader has past our
        sequence number.  Returns the number of events applied."""
        leader = (self.leader_url_fn() or "").rstrip("/")
        if self.on_leader_url is not None:
            self.on_leader_url(leader)
        if not leader or leader == self.self_url:
            return 0
        applied = 0
        first_fetch = True
        while not self._stop.is_set():
            after = self.store.last_seq()
            # only the first fetch of a cycle long-polls: follow-up pages
            # of a backlog should stream back-to-back
            wait_s = self.long_poll_s if first_fetch else 0.0
            first_fetch = False
            shard_q = f"&shard={self.shard}" if self.shard is not None \
                else ""
            resp = self._get(
                f"{leader}/replication/journal?after_seq={after}"
                f"&wait_s={wait_s}{shard_q}",
                timeout_s=self.timeout_s + wait_s)
            # a response landing after stop() is the promotion race: we
            # may already be (about to be) the leader, and a reply from a
            # still-alive deposed leader must not clobber our state
            if resp is None or self._stop.is_set():
                break
            import time as _time

            self._last_progress = _time.monotonic()
            incarnation = resp.get("incarnation")
            if incarnation and self._leader_incarnation not in (
                    None, incarnation):
                log.info("replication: leader incarnation changed %s -> %s;"
                         " forcing snapshot bootstrap",
                         self._leader_incarnation, incarnation)
                if not self._full_resync(leader):
                    break
                continue
            if incarnation:
                self._leader_incarnation = incarnation
            if resp.get("snapshot_required"):
                if not self._full_resync(leader):
                    break
                continue
            events = resp.get("events", [])
            if events:
                applied += self._apply(events)
            # freshness proof: our applied head covers the feed's head
            # at the moment the leader answered — staleness_ms() counts
            # from the newest such proof
            if self.store.last_seq() >= int(resp.get("last_seq", 0)):
                self._fresh_at = _time.monotonic()
            if not resp.get("more"):
                break
        # confirm what we hold: sync-ack commits on the leader block
        # until a standby's ack covers them (rest/api.py:_await_replication).
        # Only a follower with a local journal/data_dir may claim the
        # durable flag — "applied AND journaled locally" — a memory-only
        # follower's ack must not satisfy the leader's durability bound
        # (the leader skips non-durable acks when counting min_acks).
        if not self._stop.is_set():
            seq = self.store.last_seq()
            if seq != self._last_acked and leader:
                durable = self.is_durable()
                if durable and self.journal is not None:
                    # the durable claim is "on OUR disk": group-fsync the
                    # journal BEFORE the ack leaves, or an OS crash after
                    # the ack could still lose the write the leader just
                    # told its client was replicated
                    self.journal.sync()
                ack = {"follower": self.member_id, "seq": seq,
                       "durable": durable,
                       "last_txn_id": self.last_txn_id,
                       # fleet federation (obs/fleet.py): the ack doubles
                       # as peer registration — the leader's fleet
                       # observatory polls this URL for health/staleness
                       "url": self.self_url}
                if self.shard is not None:
                    ack["shard"] = self.shard
                if self._post(f"{leader}/replication/ack", ack):
                    self._last_acked = seq
                    # one correlation event per txn: later acks driven by
                    # non-txn events (status updates) must not keep
                    # re-attributing themselves to this transaction
                    self.last_txn_id = ""
        return applied

    def is_durable(self) -> bool:
        """Whether acks may claim "journaled locally": this follower
        persists what it applies (an attached journal writer, or a
        data_dir it snapshots into)."""
        return self.journal is not None or bool(self.data_dir)

    def _apply(self, events: list[dict]) -> int:
        import time as _time

        # live mode: each entry becomes an ordinary committed event on our
        # store — retained in the event window and fanned out to watchers
        # (columnar index, attached journal writer, passport), so the
        # standby's derived state tracks the leader continuously and
        # promotion needs no rebuild.  Journal persistence rides the
        # watcher fan-out (persistence.attach_journal), same as a local
        # transaction.
        t0 = _time.perf_counter()
        with self.store._lock:
            applied = persistence.apply_journal(self.store, events,
                                                live=True)
        global_registry.histogram(
            "replication.apply_seconds",
            "follower wall seconds applying one replicated event batch",
            buckets=_APPLY_BUCKETS).observe(_time.perf_counter() - t0)
        global_registry.counter(
            "replication.events_applied",
            "events this follower applied from the leader's feed").inc(
            applied)
        for e in reversed(events):
            if e.get("kind") == "txn/committed":
                txn_id = (e.get("data") or {}).get("txn_id")
                if txn_id:
                    self.last_txn_id = txn_id
                break
        self.synced_events += applied
        return applied

    def _full_resync(self, leader: str) -> bool:
        shard_q = f"?shard={self.shard}" if self.shard is not None else ""
        state = self._get(f"{leader}/replication/snapshot{shard_q}")
        if state is None or "seq" not in state or self._stop.is_set():
            return False
        if state.get("incarnation"):
            self._leader_incarnation = state["incarnation"]
        # the pre-resync correlation id belongs to a history this snapshot
        # supersedes; carrying it into the next ack would misattribute
        # which txn the ack makes durable
        self.last_txn_id = ""
        global_registry.counter(
            "replication.full_resyncs",
            "snapshot bootstraps this follower performed").inc()
        persistence.restore_into(self.store, state)
        if self.data_dir:
            # the local snapshot now IS the bootstrap point; the journal
            # restarts from here (the rotated segment only held pre-resync
            # entries that the new snapshot supersedes)
            persistence.snapshot(self.store,
                                 os.path.join(self.data_dir,
                                              "snapshot.json"))
            if self.journal is not None:
                self.journal.rotate()
        self.full_resyncs += 1
        import time as _time

        # the snapshot IS the leader's head as of the fetch
        now = _time.monotonic()
        self._fresh_at = now
        self._last_progress = now
        log.info("replication: full resync from %s at seq %s", leader,
                 state["seq"])
        return True

    # ------------------------------------------------------- staleness
    # Replica-served reads (shard/replica.py, rest/api.py):
    # how stale is the state this follower serves, and is it still
    # applying at all.

    def staleness_ms(self, now: Optional[float] = None) -> float:
        """Milliseconds since this follower last PROVED it held the
        leader's head.  +inf before the first proof (a replica that
        never synced must not serve 'slightly stale' reads).  Monotone
        while the follower is behind; resets on catch-up."""
        import time as _time

        if self._fresh_at is None:
            return float("inf")
        now = _time.monotonic() if now is None else now
        return max(0.0, (now - self._fresh_at) * 1000.0)

    def stalled_s(self, now: Optional[float] = None) -> float:
        """Seconds since the last successful leader poll — the
        stopped-applying signal replica reads refuse on."""
        import time as _time

        if self._last_progress is None:
            return float("inf")
        now = _time.monotonic() if now is None else now
        return max(0.0, now - self._last_progress)

    def staleness_view(self) -> dict[int, dict]:
        """Per-shard staleness rows ({shard: row}); an unsharded
        follower is shard 0 of a 1-shard view."""
        shard = self.shard if self.shard is not None else 0
        return {shard: {
            "staleness_ms": self.staleness_ms(),
            "stalled_s": self.stalled_s(),
            "applied_seq": self.store.last_seq(),
        }}

    # --------------------------------------------------------------- running

    def _next_wait_s(self, cycle_elapsed_s: float = 0.0) -> float:
        """Poll interval for the next cycle: poll_s while healthy,
        jittered exponential backoff (capped) after leader transport
        errors — the follower must not hammer a dead or flapping leader
        at full poll rate.  The delay is measured from cycle START: a
        fetch that burned `timeout_s` before failing already served as
        its own backoff (the tight-retry risk only exists for cycles
        that fail fast, e.g. connection-refused from a dead leader)."""
        if self._consecutive_failures == 0:
            return self.poll_s
        delay = backoff_s(self.reconnect_policy,
                          self._consecutive_failures)
        return max(self.poll_s, delay - cycle_elapsed_s)

    def _note_cycle_outcome(self) -> None:
        if self._transport_error:
            self._transport_error = False
            self._consecutive_failures += 1
            self.reconnect_attempts += 1
            self._reconnects.inc()
        else:
            self._consecutive_failures = 0

    def start(self) -> "JournalFollower":
        import time as _time

        def loop():
            wait_s = self.poll_s
            while not self._stop.wait(wait_s):
                self._transport_error = False
                t0 = _time.monotonic()
                try:
                    self.sync_once()
                except OSError:
                    # a transport failure that escaped _get/_post's own
                    # handling: back off like any other reconnect
                    log.exception("journal follower sync failed "
                                  "(transport)")
                    self._transport_error = True
                except Exception:  # noqa: BLE001 — a standby's sync loop
                    # must survive any leader hiccup; an APPLY failure is
                    # not a transport error, so it retries at the normal
                    # poll cadence and stays out of the reconnect
                    # counter (the backoff would stretch replication lag
                    # to cap_s while pointing operators at the network)
                    log.exception("journal follower sync failed (apply)")
                self._note_cycle_outcome()
                wait_s = self._next_wait_s(_time.monotonic() - t0)

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="journal-follower")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop tailing and JOIN the sync thread fully.  The join timeout
        must cover the longest possible in-flight fetch — a long-poll
        parks on the leader for long_poll_s on top of the transport
        timeout (sync_once passes timeout_s + wait_s to urlopen) — plus
        slack: promotion calls this before taking writes, and a late
        response from a deposed leader applying after promotion would
        clobber the new leader's state (the sync loop also re-checks
        _stop after every fetch as a second line of defense)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s + self.long_poll_s + 5)
