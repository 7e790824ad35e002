"""The judge: replays a run from its inputs and the program's outputs,
and holds each window cycle's outputs against the plain reference.

The program's state is never read.  The judge keeps its own copy of the
cluster, built from the benchmark's inputs (the fleet, the arrivals and
their runtimes) and the program's decisions, one cycle at a time, in the
benchmark's cycle order: completions fall due on the virtual clock,
arrivals join the pending set, the program's placements start tasks and
its preemptions end them (a preempted job waits again, and may not
return to the host it was preempted on).  So the reference follows the
program step by step from its outputs, and checks every step from the
first cycle, which starts from an empty fleet.

In every window cycle, for every pool:

- `rank_errors`: positions at which the program's ranked queue differs
  from the reference's DRU order (`dru.py`);
- `placement_errors`: placements of a job that was not pending or not in
  the considered window (the first `num_considerable` jobs of the
  reference's order, with the program's documented head-of-queue
  backoff), placed twice, on a host outside its pool, on a host it was
  preempted from, on a host reserved for another job, against the gpu-
  host rule, or that together overflow their host's free resources;
- on a sample of window cycles drawn from the seed, where the traffic
  rebalances, `victim_errors`: preemption decisions (job, host, victims)
  that differ from the reference's (`rebalance.py`).

On the same sample the judge holds the packing against the plain greedy
(`greedy.py`) on the same window and free resources: `packing_shortfall`
is one less the program's placed demand over the greedy's, summed over
the sample and every pool, so a matcher that places half of its window,
or none of it, fails.  The same ratio is kept for flat and for
hierarchical pools apart (`_packing_flat`, `_packing_hierarchical`; the
per-layer metrics read them); which route a pool's window took is the
program's own output, its flight record, handed in as plain data.

Two controls put the reference itself in the program's place: its DRU
order, the greedy's placements over its own window, and its victim
search, each judged as the program's are.  `bfloat16` computes them in
bfloat16; `half_placements` computes them in float32 and leaves out every
second placement of each solve (the fault "half of the batch left out").
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np

from cookbench.reference import dru as dru_ref
from cookbench.reference import greedy as greedy_ref
from cookbench.reference.precision import ROUNDING, f32
from cookbench.reference.rebalance import VictimSearch


@dataclass
class History:
    """A run as the judge reads it: plain data only.

    jobs: per submitted job, in submission order: uuid, user, pool, mem,
    cpus, gpus, priority, runtime_ms.  hosts: pool, hostname, mem, cpus,
    gpus per host.  cycles: per cycle {"t_ms", "n_arrivals", "pools":
    {pool: {"queue": [uuid] (window cycles), "placed": [(uuid, host,
    task id)], "decisions": [(uuid, host, [task id])]}}}.  config: the
    deployment's file."""

    jobs: dict
    hosts: dict
    cycles: list
    config: dict
    window_first: int
    rebalance: bool
    sample: list = field(default_factory=list)
    # (cycle, pool) -> "flat" | "hierarchical": the route the program's
    # matcher took (its flight record); "flat" where it recorded none
    routes: dict = field(default_factory=dict)


class World:
    """The judge's own copy of the cluster."""

    def __init__(self, h: History):
        self.h = h
        cfg = h.config
        jobs = h.jobs
        n = len(jobs["uuid"])
        self.n = n
        self.idx = {u: i for i, u in enumerate(jobs["uuid"])}
        names: dict[str, int] = {}
        self.user = np.array([names.setdefault(u, len(names))
                              for u in jobs["user"]], np.int64)
        self.user_names = list(names)
        self.pool_names = [p["name"] for p in cfg["pools"]]
        pool_code = {p: k for k, p in enumerate(self.pool_names)}
        self.pool = np.array([pool_code[p] for p in jobs["pool"]], np.int64)
        self.res = np.stack([jobs["mem"], jobs["cpus"], jobs["gpus"]],
                            axis=1).astype(np.float64)
        self.prio = np.asarray(jobs["priority"], np.int64)
        self.runtime = np.asarray(jobs["runtime_ms"], np.int64)
        self.seq = np.arange(n)
        self.pending = np.zeros(n, bool)
        self.submitted = 0
        self.preempts = np.zeros(n, np.int64)
        self.failed_hosts: dict[int, set] = {}
        hosts = h.hosts
        self.host_idx = {name: i for i, name in enumerate(hosts["hostname"])}
        self.host_pool = np.array([pool_code[p] for p in hosts["pool"]])
        self.total = np.stack([hosts["mem"], hosts["cpus"], hosts["gpus"]],
                              axis=1).astype(np.float64)
        self.used = np.zeros_like(self.total)
        # running tasks: task id -> (job, host, start ms)
        self.running: dict[str, tuple] = {}
        self.ends: list = []
        self.reserved: dict[int, int] = {}   # host -> job
        self.dru_mode = {p["name"]: p["dru_mode"] for p in cfg["pools"]}
        self.share = {p["name"]: p["share"] for p in cfg["pools"]}
        m = cfg["match"]
        self.k_max = int(m["max_jobs_considered"])
        self.scaleback = float(m.get("scaleback", 0.95))
        self.floor_reset = int(m.get("floor_iterations_before_reset",
                                     1_000_000))
        self.k = {p: self.k_max for p in self.pool_names}
        self.at_floor = {p: 0 for p in self.pool_names}
        self.mea_culpa = int(cfg["jobs"].get("mea_culpa_limit", 5))
        self.max_retries = int(cfg["jobs"].get("max_retries", 5))

    # ------------------------------------------------------------ state

    def free(self) -> np.ndarray:
        return self.total - self.used

    def _complete_due(self, t_ms: int) -> None:
        while self.ends and self.ends[0][0] <= t_ms:
            _, tid = heapq.heappop(self.ends)
            task = self.running.pop(tid, None)
            if task is not None:
                self.used[task[1]] -= self.res[task[0]]

    def _start(self, j: int, host: int, tid: str, t_ms: int) -> None:
        self.pending[j] = False
        self.running[tid] = (j, host, t_ms)
        self.used[host] += self.res[j]
        heapq.heappush(self.ends, (t_ms + int(self.runtime[j]), tid))
        if self.reserved.get(host) == j:
            del self.reserved[host]

    def _preempt(self, tid: str) -> None:
        task = self.running.pop(tid, None)
        if task is None:
            return
        j, host, _ = task
        self.used[host] -= self.res[j]
        self.preempts[j] += 1
        self.failed_hosts.setdefault(j, set()).add(host)
        consumed = max(0, int(self.preempts[j]) - self.mea_culpa)
        if consumed < self.max_retries:
            self.pending[j] = True

    # ------------------------------------------------------------ pieces

    def divisors(self, pool: str, rnd) -> np.ndarray:
        d = dru_ref.divisors(self.share[pool], rnd)
        return np.tile(d, (len(self.user_names), 1))

    def order(self, pool: str, rnd) -> np.ndarray:
        """Pending jobs of `pool` (job indexes) in the reference's DRU
        order at `rnd`'s precision.  A job that no host of the pool could
        hold is left out (Cook's offensive-job filter, which holds a job's
        size against fixed limits, here the pool's largest host): its mem,
        cpus and gpus each against the most any host of the pool has in
        total."""
        p = self.pool_names.index(pool)
        pend = np.flatnonzero(self.pending & (self.pool == p))
        hosts = self.host_pool == p
        cap = self.total[hosts].max(axis=0)
        pend = pend[(self.res[pend] <= cap).all(axis=1)]
        run = [t[0] for t in self.running.values()
               if self.pool[t[0]] == p]
        run = np.asarray(run, np.int64)
        pos = dru_ref.dru_order(
            self.user[pend], self.prio[pend], self.seq[pend], self.res[pend],
            self.user[run], self.prio[run], self.res[run],
            self.divisors(pool, rnd), self.dru_mode[pool] == "gpu", rnd)
        return pend[pos]

    def feasible(self, jobs: np.ndarray, hosts: np.ndarray) -> np.ndarray:
        """[J, N] the constraints the program states: the gpu-host rule
        (on a host's free gpus), the novel-host rule, reservations."""
        free = self.free()
        has_gpu = free[hosts, 2] > 0
        mask = (self.res[jobs, 2] > 0)[:, None] == has_gpu[None, :]
        col = {h: c for c, h in enumerate(hosts)}
        for r, j in enumerate(jobs):
            for h in self.failed_hosts.get(int(j), ()):
                if h in col:
                    mask[r, col[h]] = False
        for h, owner in self.reserved.items():
            if h in col:
                mask[:, col[h]] &= jobs == owner
        return mask

    def judge_placements(self, pool, window, placed):
        """Errors among `placed` [(job, host)] against the window; starts
        nothing."""
        p = self.pool_names.index(pool)
        in_window = np.zeros(self.n, bool)
        in_window[window] = True
        errors = 0
        seen = set()
        free = self.free()
        load = np.zeros_like(self.total)
        for j, host in placed:
            bad = (j < 0 or host < 0 or j in seen or not self.pending[j]
                   or not in_window[j] or self.host_pool[host] != p
                   or host in self.failed_hosts.get(j, ())
                   or self.reserved.get(host, j) != j
                   or (self.res[j, 2] > 0) != (free[host, 2] > 0))
            seen.add(j)
            if bad:
                errors += 1
                continue
            load[host] += self.res[j]
        over = (load > free + 1e-9).any(axis=1)
        return errors + int(over.sum())

    # ------------------------------------------------------------ cycle

    def cycle(self, c: int, rec: dict, out: dict, control: str = "") -> None:
        judged = c >= self.h.window_first
        sampled = c in self.h.sample
        t_ms = rec["t_ms"]
        self._complete_due(t_ms)
        stop = self.submitted + rec["n_arrivals"]
        self.pending[self.submitted:stop] = True
        self.submitted = stop
        rnd = ROUNDING.get(control, f32)
        ranked = {}
        for pool in self.pool_names:
            prec = rec["pools"].get(pool, {})
            order = self.order(pool, f32)
            k = min(self.k[pool], len(order))
            window = order[:k]
            alt = self.order(pool, rnd) if rnd is not f32 else order
            alt_window = alt[:k]
            ranked[pool] = (order, alt)
            if judged:
                if control:
                    out["rank_errors"] += _differ(alt, order)
                else:
                    queue = [self.idx.get(u, -1) for u in prec["queue"]]
                    out["rank_errors"] += _differ(np.asarray(queue), order)
            placed = [(self.idx.get(u, -1), self.host_idx.get(hn, -1), tid)
                      for u, hn, tid in prec.get("placed", ())]
            hosts = np.flatnonzero(self.host_pool ==
                                   self.pool_names.index(pool))
            if judged and (sampled or control):
                free = self.free()
                ref = greedy_ref.greedy(
                    self.res[window], free[hosts],
                    self.total[hosts][:, :2], self.feasible(window, hosts))
                if control:
                    alt_assign = ref if alt is order else greedy_ref.greedy(
                        self.res[alt_window], free[hosts],
                        self.total[hosts][:, :2],
                        self.feasible(alt_window, hosts), rnd)
                    got = [(int(alt_window[r]), int(hosts[a]))
                           for r, a in enumerate(alt_assign) if a >= 0]
                    if control == "half_placements":
                        got = got[::2]
                    out["placement_errors"] += self.judge_placements(
                        pool, window, got)
                else:
                    got = [(j, h) for j, h, _ in placed]
                kind = self.h.routes.get((c, pool), "flat")
                out[f"packing_{kind}_num"] += _placed_weight(window, got,
                                                             self.res)
                out[f"packing_{kind}_den"] += greedy_ref.placed_weight(
                    self.res[window], ref >= 0)
            if judged and not control:
                out["placement_errors"] += self.judge_placements(
                    pool, window, [(j, h) for j, h, _ in placed])
                out["placements"] += len(placed)
            # head-of-queue backoff, as the program documents it
            if k:
                head = int(window[0])
                head_matched = any(j == head for j, _, _ in placed)
                self._backoff(pool, head_matched)
            for j, host, tid in placed:
                if j >= 0 and host >= 0 and self.pending[j]:
                    self._start(j, host, tid, t_ms)
        if not self.h.rebalance:
            return
        for pool in self.pool_names:
            prec = rec["pools"].get(pool, {})
            decisions = prec.get("decisions", [])
            if judged:
                out["decisions"] += len(decisions)
            if judged and (sampled or control):
                ref = self.victims(pool, f32, ranked[pool][0])
                if control:
                    got = self.victims(pool, rnd, ranked[pool][1])
                else:
                    got = [(u, h, sorted(v)) for u, h, v in decisions]
                out["victim_errors"] += _differ_lists(got, ref)
            for uuid, host, victims in decisions:
                for tid in victims:
                    self._preempt(tid)
                if len(victims) > 1:
                    self.reserved[self.host_idx[host]] = self.idx[uuid]

    def victims(self, pool: str, rnd, order: np.ndarray) -> list:
        """The reference's decisions for this cycle's rebalance of
        `pool`: the pending jobs of the cycle's DRU `order` less those the
        program just placed, the first `max_preemption` of them."""
        p = self.pool_names.index(pool)
        hosts = np.flatnonzero(self.host_pool == p)
        names = [self.h.hosts["hostname"][i] for i in hosts]
        by_name = sorted(range(len(hosts)), key=lambda i: names[i])
        local = {int(hosts[i]): r for r, i in enumerate(by_name)}
        sorted_names = [names[i] for i in by_name]
        tasks = [(tid, self.user_names[self.user[j]], int(self.prio[j]),
                  start, local[host], *self.res[j])
                 for tid, (j, host, start) in self.running.items()
                 if self.pool[j] == p]
        spare = self.free()[hosts[by_name]]
        share = self.share[pool]
        search = VictimSearch(
            tasks, spare, lambda user: share,
            gpu_mode=self.dru_mode[pool] == "gpu",
            params=self.h.config["rebalancer"],
            failed_hosts={self.h.jobs["uuid"][j]: {local[h] for h in hs
                                                   if h in local}
                          for j, hs in self.failed_hosts.items()},
            rnd=rnd)
        queue = order[self.pending[order]]
        out = []
        for j in queue[: int(self.h.config["rebalancer"]["max_preemption"])]:
            uuid = self.h.jobs["uuid"][j]
            got = search.decide(uuid, self.user_names[self.user[j]],
                                int(self.prio[j]), tuple(self.res[j]))
            if got is not None and got[1]:
                out.append((uuid, sorted_names[got[0]], sorted(got[1])))
        return out

    def _backoff(self, pool: str, head_matched: bool) -> None:
        if head_matched:
            self.k[pool] = self.k_max
            self.at_floor[pool] = 0
            return
        shrunk = max(1, int(self.k[pool] * self.scaleback))
        if shrunk == self.k[pool]:
            self.at_floor[pool] += 1
            if self.at_floor[pool] >= self.floor_reset:
                self.k[pool] = self.k_max
                self.at_floor[pool] = 0
                return
        self.k[pool] = shrunk


def _placed_weight(window: np.ndarray, placed: list, res) -> float:
    """The greedy's weighting of the demand that `placed` [(job, host)]
    places out of `window`."""
    got = np.zeros(len(window), bool)
    pos = {int(j): r for r, j in enumerate(window)}
    for j, _ in placed:
        if j in pos:
            got[pos[j]] = True
    return greedy_ref.placed_weight(res[window], got)


def _differ(got: np.ndarray, want: np.ndarray) -> int:
    """Positions at which two orders differ, and the length difference."""
    m = min(len(got), len(want))
    return int((got[:m] != want[:m]).sum()) + abs(len(got) - len(want))


def _differ_lists(got: list, want: list) -> int:
    m = min(len(got), len(want))
    return (sum(1 for a, b in zip(got[:m], want[:m]) if a != b)
            + abs(len(got) - len(want)))


def judge(history: History, control: str = "") -> dict:
    """Every compared number of a run (see the module docstring); with
    `control` ("bfloat16", "half_placements") that control's readings
    instead."""
    world = World(history)
    out = {"rank_errors": 0, "placement_errors": 0, "victim_errors": 0,
           "placements": 0, "decisions": 0,
           "packing_flat_num": 0.0, "packing_flat_den": 0.0,
           "packing_hierarchical_num": 0.0,
           "packing_hierarchical_den": 0.0}
    for c, rec in enumerate(history.cycles):
        world.cycle(c, rec, out, control)
    numbers = {"rank_errors": out["rank_errors"],
               "placement_errors": out["placement_errors"]}
    if history.rebalance:
        numbers["victim_errors"] = out["victim_errors"]
    num = den = 0.0
    for kind in ("flat", "hierarchical"):
        num += out[f"packing_{kind}_num"]
        den += out[f"packing_{kind}_den"]
        if out[f"packing_{kind}_den"] > 0:
            numbers[f"_packing_{kind}"] = (out[f"packing_{kind}_num"]
                                           / out[f"packing_{kind}_den"])
    numbers["packing_shortfall"] = 1.0 - num / den if den > 0 else 0.0
    numbers["_placements"] = out["placements"]
    numbers["_decisions"] = out["decisions"]
    return numbers


# each compared number's limit (at most): the errors are exact counts;
# the packing shortfall's limit lies between the sound runs' largest
# reading and the half_placements control's smallest (PERF.md section 2)
LIMITS = {"rank_errors": 0, "placement_errors": 0, "victim_errors": 0,
          "packing_shortfall": 0.35}
# the controls of the limits, each judged in the program's place
CONTROLS = ("bfloat16", "half_placements")
