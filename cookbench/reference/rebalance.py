"""The plain rebalancer victim search (Cook's rebalancer.clj), one
pending job at a time.

For the first `max_preemption` pending jobs in DRU order: the running
tasks whose DRU is at least `safe_dru_threshold` and exceeds the job's
by more than `min_dru_diff` may be preempted; on each host they are
taken in descending DRU (then row) until, with the host's spare, the
job's demand is covered; the host whose covering prefix has the largest
smallest DRU wins (the lowest host on a tie), and a host whose spare
alone covers the demand beats every preemption.  The winner is then
simulated: the victims leave, the job joins its user's tasks on that
host, the users involved are rescored and the host's spare becomes what
was freed less the demand.

Users' DRUs are cumulative over their tasks ordered by (-priority,
start, task id), in float64, stored in the precision under test, in
which every comparison is made.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from cookbench.reference.precision import f32

BIG = 1e30
PENDING_START = 2 ** 62
PENDING_ID = "￿"


@dataclass
class _User:
    keys: list = field(default_factory=list)
    ids: list = field(default_factory=list)
    res: list = field(default_factory=list)
    rows: list = field(default_factory=list)
    dru: list = field(default_factory=list)


class VictimSearch:
    """One pool's rebalance cycle.

    tasks: (task id, user, priority, start ms, host index, mem, cpus,
    gpus) of every running task; spare [H, 3] per host (hosts sorted by
    name); divisors: user -> (mem, cpus, gpus) share; failed_hosts: job
    uuid -> host indexes the job may not use."""

    def __init__(self, tasks, spare, divisors, *, gpu_mode: bool,
                 params: dict, failed_hosts: dict, rnd=f32):
        self.rnd = rnd
        self.gpu_mode = gpu_mode
        self.params = params
        self.divisors = divisors
        self.failed_hosts = failed_hosts
        self.spare = rnd(np.asarray(spare, np.float32)).copy()
        self.users: dict[str, _User] = {}
        self.info: dict[str, tuple] = {}
        by_user: dict[str, list] = {}
        for t in tasks:
            by_user.setdefault(t[1], []).append(t)
        n = len(tasks) + int(params["max_preemption"])
        self.host = np.full(n, -1, np.int64)
        self.res = np.zeros((n, 3), np.float32)
        self.dru = np.zeros(n, np.float32)
        self.elig = np.zeros(n, bool)
        self.row_ids = [""] * n
        row = 0
        for user in sorted(by_user):
            ts = sorted(by_user[user], key=lambda t: (-t[2], t[3], t[0]))
            u = self.users[user] = _User()
            for t in ts:
                u.keys.append((-t[2], t[3], t[0]))
                u.ids.append(t[0])
                u.res.append((t[5], t[6], t[7]))
                u.rows.append(row)
                self.info[t[0]] = (user, t[4])
                self.row_ids[row] = t[0]
                self.host[row] = t[4]
                self.res[row] = (t[5], t[6], t[7])
                self.elig[row] = True
                row += 1
            self._rescore(user)
        self.next_row = row

    def _div(self, user):
        return tuple(min(v, BIG) for v in self.divisors(user))

    def _rescore(self, user: str) -> None:
        u = self.users.get(user)
        if u is None:
            return
        md, cd, gd = self._div(user)
        cm = cc = cg = 0.0
        u.dru = []
        for (mem, cpus, gpus), row in zip(u.res, u.rows):
            cm += mem
            cc += cpus
            cg += gpus
            value = cg / gd if self.gpu_mode else max(cm / md, cc / cd)
            u.dru.append(value)
            self.dru[row] = self.rnd(np.float32(value))

    def _pending_dru(self, user: str, prio: int, res) -> float:
        md, cd, gd = self._div(user)
        u = self.users.get(user)
        nearest = 0.0
        if u is not None and u.ids:
            pos = bisect.bisect_right(u.keys, (-prio, PENDING_START,
                                               PENDING_ID))
            if pos > 0:
                nearest = u.dru[pos - 1]
        if self.gpu_mode:
            return nearest + res[2] / gd
        return max(nearest + res[0] / md, nearest + res[1] / cd)

    def decide(self, uuid: str, user: str, prio: int, res):
        """(host index, [victim task ids]) for one pending job, applied
        to the cycle's state; None when no host can be freed."""
        rnd = self.rnd
        demand = rnd(np.asarray(res, np.float32))
        pending = rnd(np.float32(self._pending_dru(user, prio, res)))
        safe = rnd(np.float32(self.params["safe_dru_threshold"]))
        diff = rnd(np.float32(self.params["min_dru_diff"]))
        host_ok = np.ones(len(self.spare), bool)
        for h in self.failed_hosts.get(uuid, ()):
            host_ok[h] = False
        mask = (self.elig & (self.dru >= safe)
                & (rnd(self.dru - pending) > diff))
        rows = np.flatnonzero(mask)
        rows = rows[np.lexsort((rows, -self.dru[rows], self.host[rows]))]
        best_score, best_host, best_rows = -np.inf, -1, None
        if len(rows):
            hosts = self.host[rows]
            starts = np.flatnonzero(np.r_[True, hosts[1:] != hosts[:-1]])
            ends = np.r_[starts[1:], len(rows)]
            for s, e in zip(starts, ends):
                h = int(hosts[s])
                if not host_ok[h]:
                    continue
                freed = rnd(np.cumsum(self.res[rows[s:e]], axis=0,
                                      dtype=np.float32) + self.spare[h])
                ok = np.flatnonzero((freed >= demand).all(axis=1))
                if len(ok) == 0:
                    continue
                k = int(ok[0])
                score = float(self.dru[rows[s + k]])
                if score > best_score:
                    best_score, best_host = score, h
                    best_rows = (rows[s:s + k + 1], freed[k])
        fits = np.flatnonzero(host_ok & (self.spare >= demand).all(axis=1))
        if len(fits):
            h = int(fits[0])
            self._apply(uuid, user, prio, res, h, [], self.spare[h])
            return h, []
        if best_host < 0:
            return None
        victims = [self.row_ids[r] for r in best_rows[0]]
        self._apply(uuid, user, prio, res, best_host, victims, best_rows[1])
        return best_host, victims

    def _apply(self, uuid, user, prio, res, host, victims, freed) -> None:
        changed = {user}
        for tid in victims:
            owner, _ = self.info[tid]
            u = self.users[owner]
            k = u.ids.index(tid)
            self.elig[u.rows[k]] = False
            del u.keys[k], u.ids[k], u.res[k], u.rows[k]
            changed.add(owner)
        u = self.users.setdefault(user, _User())
        key = (-prio, PENDING_START, PENDING_ID)
        pos = bisect.bisect_right(u.keys, key)
        row = self.next_row
        self.next_row += 1
        sim = f"sim-{uuid}"
        u.keys.insert(pos, key)
        u.ids.insert(pos, sim)
        u.res.insert(pos, tuple(res))
        u.rows.insert(pos, row)
        self.row_ids[row] = sim
        self.info[sim] = (user, host)
        self.host[row] = host
        self.res[row] = res
        self.elig[row] = True
        for name in changed:
            self._rescore(name)
        self.spare[host] = self.rnd(np.maximum(
            np.asarray(freed, np.float32) - np.asarray(res, np.float32),
            0.0).astype(np.float32))
