"""The one job generator every traffic mix of the benchmark goes through.

A traffic mix is a JSON file beside this module (`<name>.json`); a
deployment is a JSON file under `cookbench/configs/`.  The mix names its
job streams, and each stream says who submits, what shape the jobs are,
how long they run and when they arrive:

- ``"users"``: ``"config"`` (the deployment's users, Zipf-weighted) or
  ``{"name": "hog"}`` (one user) or ``{"prefix": "late", "count": 49}``
  (users in equal shares);
- ``"shape"``: ``"config"`` (the deployment's job shapes: mem, cpus,
  priority and the GPU column) or ``{"host_fraction": 0.5}`` (a fixed
  share of one host of the pool, priority ``"priority"``);
- ``"runtime_ms"``: ``{"fixed": ms}`` or ``{"exp_mean": ms, "plus": ms}``;
- how many: ``"backlog": true`` (the pool's backlog from the deployment),
  or ``"per_host"`` (a multiple of the pool's hosts);
- ``"at_ms"``: the virtual time of arrival (default 0);
- ``"refill": true``: after the first batch, every job the scheduler
  launched in a pool is replaced next cycle by a new job of the stream,
  so the pool's backlog holds its size.

Arrivals follow the virtual clock, and the order comes from `--seed`, so
a seed always makes the same jobs.  The work does not depend on the
seed: each block of `BLOCK` rows holds the same multiset of users, sizes,
priorities and runtimes for every seed (each value as often as its
weight says, runtimes at the law's quantiles), and the seed only
shuffles each column.  A `Job` object is built only when its arrival is
submitted.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BLOCK = 65536


def load(name: str) -> dict:
    """The traffic mix `name` (`cookbench/traffic/<name>.json`)."""
    with open(os.path.join(HERE, f"{name}.json")) as f:
        return json.load(f)


def zipf_weights(count: int, exponent: float) -> np.ndarray:
    """Deterministic Zipf weights: the k-th user (k from 1) weighs
    k ** -exponent; the k-th user name holds the k-th rank."""
    w = np.arange(1, count + 1, dtype=np.float64) ** -exponent
    return w / w.sum()


def fixed_column(rng: np.random.Generator, values, n: int,
                 weights=None) -> np.ndarray:
    """`n` rows holding each of `values` as often as its weight says
    (equal weights by default; rounded by largest remainder), in an
    order the seed draws."""
    values = np.asarray(values)
    w = (np.full(len(values), 1.0 / len(values)) if weights is None
         else np.asarray(weights, np.float64) / np.sum(weights))
    counts = np.floor(w * n).astype(np.int64)
    rest = np.argsort(-(w * n - counts), kind="stable")[:n - counts.sum()]
    counts[rest] += 1
    return rng.permutation(np.repeat(values, counts))


def exp_quantiles(rng: np.random.Generator, mean: float, n: int
                  ) -> np.ndarray:
    """`n` exponential runtimes with mean `mean`: the law's quantiles at
    (i + 1/2) / n, in an order the seed draws."""
    q = (np.arange(n, dtype=np.float64) + 0.5) / n
    return rng.permutation(-mean * np.log1p(-q))


@dataclass
class Arrival:
    """One job to submit: the generator's row, as the store gets it."""

    uuid: str
    user: str
    pool: str
    mem: float
    cpus: float
    gpus: float
    priority: int
    runtime_ms: int


class Stream:
    """One stream of one pool: draws its jobs in blocks from its own
    random generator, in order."""

    def __init__(self, spec: dict, index: int, pool: dict, config: dict,
                 rng: np.random.Generator):
        self.spec = spec
        self.pool = pool
        self.config = config
        self.rng = rng
        self.tag = spec.get("name", f"s{index}")
        self.at_ms = int(spec.get("at_ms", 0))
        self.refill = bool(spec.get("refill", False))
        self.drawn = 0          # rows drawn so far
        self.cols: dict[str, np.ndarray] = {}
        users = spec.get("users", "config")
        if users == "config":
            u = config["users"]
            # the k-th name holds the k-th Zipf rank, for every seed
            self.user_names = [f"{u['prefix']}{k}" for k in range(u["count"])]
            self.user_p = zipf_weights(len(self.user_names),
                                       float(u["zipf"]))
        elif "name" in users:
            self.user_names = [users["name"]]
            self.user_p = np.ones(1)
        else:
            self.user_names = [f"{users['prefix']}{k}"
                               for k in range(users["count"])]
            self.user_p = np.full(len(self.user_names),
                                  1.0 / len(self.user_names))
        if spec.get("backlog"):
            self.first = int(pool["backlog"])
        else:
            self.first = int(round(float(spec["per_host"]) * pool["hosts"]))

    def _draw_block(self) -> None:
        rng, n = self.rng, BLOCK
        cfg_jobs = self.config["jobs"]
        shape = self.spec.get("shape", "config")
        cols = {"user": fixed_column(rng, np.arange(len(self.user_names)), n,
                                     self.user_p)}
        if shape == "config":
            cols["mem"] = fixed_column(rng, np.asarray(cfg_jobs["mem"], float),
                                       n)
            cols["cpus"] = fixed_column(
                rng, np.asarray(cfg_jobs["cpus"], float), n)
            cols["priority"] = fixed_column(
                rng, np.asarray(cfg_jobs["priority"], np.int64), n)
            frac = float(cfg_jobs.get("gpu_job_fraction", 0.0))
            gpu_job = fixed_column(rng, np.array([True, False]), n,
                                   [frac, 1.0 - frac])
            cols["gpus"] = np.zeros(n)
            cols["gpus"][gpu_job] = fixed_column(
                rng, np.asarray(cfg_jobs.get("gpus", [1]), float),
                int(gpu_job.sum()))
        else:
            host = self.config["host"]
            frac = float(shape["host_fraction"])
            cols["mem"] = np.full(n, host["mem"] * frac)
            cols["cpus"] = np.full(n, host["cpus"] * frac)
            cols["gpus"] = np.zeros(n)
            cols["priority"] = np.full(n, int(self.spec.get("priority", 50)),
                                       np.int64)
        rt = self.spec["runtime_ms"]
        if "fixed" in rt:
            cols["runtime_ms"] = np.full(n, int(rt["fixed"]), np.int64)
        else:
            cols["runtime_ms"] = (exp_quantiles(rng, float(rt["exp_mean"]), n)
                                  .astype(np.int64) + int(rt.get("plus", 0)))
        for key, col in cols.items():
            old = self.cols.get(key)
            self.cols[key] = col if old is None else np.concatenate([old,
                                                                     col])

    def take(self, count: int) -> list[Arrival]:
        """The stream's next `count` jobs."""
        out = []
        while len(self.cols.get("user", ())) < self.drawn + count:
            self._draw_block()
        c = self.cols
        name = self.pool["name"]
        for i in range(self.drawn, self.drawn + count):
            out.append(Arrival(
                uuid=f"{name}-{self.tag}-{i:08d}",
                user=self.user_names[int(c["user"][i])],
                pool=name,
                mem=float(c["mem"][i]),
                cpus=float(c["cpus"][i]),
                gpus=float(c["gpus"][i]),
                priority=int(c["priority"][i]),
                runtime_ms=int(c["runtime_ms"][i])))
        self.drawn += count
        return out


class Traffic:
    """Every stream of a traffic mix over every pool of a deployment."""

    def __init__(self, mix: dict, config: dict, seed: int):
        self.mix = mix
        self.cycle_ms = int(mix["cycle_ms"])
        self.warmup_cycles = int(mix["warmup_cycles"])
        self.rebalance = bool(mix.get("rebalance", False))
        root = np.random.SeedSequence(int(seed))
        pools = config["pools"]
        children = root.spawn(len(pools) * len(mix["streams"]))
        self.streams: list[Stream] = []
        for p, pool in enumerate(pools):
            for s, spec in enumerate(mix["streams"]):
                child = children[p * len(mix["streams"]) + s]
                self.streams.append(Stream(spec, s, pool, config,
                                           np.random.default_rng(child)))

    def due(self, now_ms: int,
            launched: Optional[dict[str, int]] = None) -> list[Arrival]:
        """The arrivals due at virtual time `now_ms`: each stream's first
        batch once its time has come, then, for a refilling stream, as
        many jobs as `launched` (pool -> tasks launched last cycle) says
        its pool started."""
        out = []
        for st in self.streams:
            if st.drawn == 0:
                if st.at_ms <= now_ms:
                    out += st.take(st.first)
            elif st.refill and launched:
                out += st.take(launched.get(st.pool["name"], 0))
        return out
