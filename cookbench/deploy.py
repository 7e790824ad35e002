"""A deployment (`cookbench/configs/<name>.json`) built on the program:
its hosts on the program's mock cluster, its pools and shares in the
program's store, and the program's scheduler with the configuration's
knobs, all on the benchmark's virtual clock."""
from __future__ import annotations

import copy
import json
import os
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def load_config(name: str) -> dict:
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return json.load(f)


def rehearsal(config: dict) -> dict:
    """The configuration at the tiny size the CPU rehearsal runs: hosts
    and backlogs scaled by its `rehearse.scale`, the matcher's knobs
    overridden by `rehearse.match`."""
    cfg = copy.deepcopy(config)
    r = cfg["rehearse"]
    for pool in cfg["pools"]:
        pool["hosts"] = max(4, int(round(pool["hosts"] * r["scale"])))
        pool["backlog"] = max(8, int(round(pool["backlog"] * r["scale"])))
    cfg["match"].update(r.get("match", {}))
    return cfg


@dataclass
class HostTable:
    """Every host of the deployment, pool by pool (the reference's copy
    of the fleet)."""

    pool: list[str]
    hostname: list[str]
    node_id: list[str]
    mem: np.ndarray
    cpus: np.ndarray
    gpus: np.ndarray


def make_hosts(config: dict, seed: int) -> HostTable:
    """The fleet: each pool's hosts alike, and exactly
    `gpu_host_fraction` of them (which ones, from the seed) carrying the
    host's gpus."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 7]))
    host = config["host"]
    pools, names, nodes, gpus = [], [], [], []
    for pool in config["pools"]:
        n = int(pool["hosts"])
        with_gpu = np.zeros(n, bool)
        k = int(round(n * float(host.get("gpu_host_fraction", 0.0))))
        with_gpu[rng.permutation(n)[:k]] = True
        for i in range(n):
            pools.append(pool["name"])
            names.append(f"{pool['name']}-host-{i:05d}")
            nodes.append(f"{pool['name']}-node-{i:05d}")
            gpus.append(float(host["gpus"]) if with_gpu[i] else 0.0)
    count = len(names)
    return HostTable(pool=pools, hostname=names, node_id=nodes,
                     mem=np.full(count, float(host["mem"])),
                     cpus=np.full(count, float(host["cpus"])),
                     gpus=np.asarray(gpus, float))


def shares(config: dict, hosts: HostTable) -> dict[str, tuple]:
    """pool -> the default user's share (mem, cpus, gpus): the pool's
    fleet over `share_fraction`."""
    frac = float(config["share_fraction"])
    out = {}
    pool_of = np.asarray(hosts.pool)
    for pool in config["pools"]:
        sel = pool_of == pool["name"]
        out[pool["name"]] = (float(hosts.mem[sel].sum()) / frac,
                             float(hosts.cpus[sel].sum()) / frac,
                             float(hosts.gpus[sel].sum()) / frac)
    return out


class Deployment:
    """The program under test, built for one configuration: a `JobStore`,
    a `MockCluster` and a `Scheduler`, on the virtual clock `now_ms`."""

    def __init__(self, config: dict, hosts: HostTable, device: str):
        from cook_tpu_torch.cluster.mock import MockCluster, MockHost
        from cook_tpu_torch.models.entities import (
            DEFAULT_USER,
            DruMode,
            Pool,
            Resources,
            Share,
        )
        from cook_tpu_torch.models.store import JobStore
        from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
        from cook_tpu_torch.scheduler.matcher import MatchConfig
        from cook_tpu_torch.scheduler.rebalancer import RebalancerParams

        self.config = config
        self.now_ms = 0
        self.store = JobStore(clock=lambda: self.now_ms)
        self.pools = []
        for pool in config["pools"]:
            p = Pool(name=pool["name"], dru_mode=DruMode(pool["dru_mode"]))
            self.store.set_pool(p)
            self.pools.append(self.store.pools[pool["name"]])
        for name, (mem, cpus, gpus) in shares(config, hosts).items():
            self.store.set_share(Share(
                user=DEFAULT_USER, pool=name,
                resources=Resources(mem=mem, cpus=cpus, gpus=gpus)))
        self.cluster = MockCluster(
            "bench",
            [MockHost(node_id=hosts.node_id[i], hostname=hosts.hostname[i],
                      mem=float(hosts.mem[i]), cpus=float(hosts.cpus[i]),
                      gpus=float(hosts.gpus[i]), pool=hosts.pool[i])
             for i in range(len(hosts.hostname))],
            clock=lambda: self.now_ms)
        sched = SchedulerConfig(
            match=MatchConfig(**config["match"]),
            rebalancer=RebalancerParams(**config["rebalancer"]),
            **config.get("scheduler", {}))
        self.scheduler = Scheduler(self.store, [self.cluster], sched,
                                   device=device)
        self._job = _job_factory(int(config["jobs"].get("max_retries", 5)))

    def jobs(self, arrivals) -> list:
        """The store's `Job` for each arrival (the client's side of a
        submit)."""
        return [self._job(a) for a in arrivals]


def _job_factory(max_retries: int):
    from cook_tpu_torch.models.entities import Job, Resources

    def make(a):
        return Job(uuid=a.uuid, user=a.user, pool=a.pool, priority=a.priority,
                   resources=Resources(mem=a.mem, cpus=a.cpus, gpus=a.gpus),
                   expected_runtime_ms=a.runtime_ms, command="bench",
                   max_retries=max_retries)

    return make
