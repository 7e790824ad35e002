"""Elastic worker-pool adapter: run framework workers (Dask, Spark, ...)
as cook-tpu jobs.

Port of `cook_tpu/integrations/workerpool.py`, a copy on the port's job
client.  Reference intent: spark/ (patches adding Cook as a Spark
scheduler backend) and dask/docs/design.md (a `CookCluster` Dask
deployment class).
This module is the transport both need: submit N identical worker jobs
pointed at a coordinator address, scale the count up/down, tear down.

`DaskCookCluster` implements the Dask `Cluster` duck-type (scale /
close / scheduler_address) when `distributed` is importable; the plain
`WorkerPool` works with no extra dependencies.
"""
from __future__ import annotations

import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Optional

from cook_tpu_torch.client.jobclient import JobClient


@dataclass
class WorkerSpec:
    command_template: str      # e.g. "dask-worker {address} --nthreads {cpus}"
    mem: float = 4096.0
    cpus: float = 2.0
    gpus: float = 0.0
    pool: Optional[str] = None
    max_retries: int = 5       # workers restart on failure/preemption
    env: dict = field(default_factory=dict)


class WorkerPool:
    """N identical long-running worker jobs, grouped for lifecycle ops."""

    def __init__(self, client: JobClient, spec: WorkerSpec,
                 coordinator_address: str, *, name: str = "workerpool"):
        self.client = client
        self.spec = spec
        self.coordinator_address = coordinator_address
        self.name = name
        self.group_uuid = str(uuid_mod.uuid4())
        self.worker_uuids: list[str] = []

    def _worker_job(self) -> dict:
        spec = self.spec
        return {
            "command": spec.command_template.format(
                address=self.coordinator_address,
                cpus=spec.cpus,
                mem=spec.mem,
            ),
            "name": f"{self.name}-worker",
            "mem": spec.mem,
            "cpus": spec.cpus,
            "gpus": spec.gpus,
            "max_retries": spec.max_retries,
            "env": spec.env,
            "group": self.group_uuid,
            **({"pool": spec.pool} if spec.pool else {}),
        }

    def scale(self, n: int) -> list[str]:
        """Grow or shrink to n workers; returns the current worker uuids."""
        current = len(self.worker_uuids)
        if n > current:
            new = self.client.submit(
                [self._worker_job() for _ in range(n - current)],
                groups=[{"uuid": self.group_uuid, "name": self.name}]
                if current == 0 else (),
            )
            self.worker_uuids.extend(new)
        elif n < current:
            victims = self.worker_uuids[n:]
            self.worker_uuids = self.worker_uuids[:n]
            self.client.kill(victims)
        return list(self.worker_uuids)

    def status(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        if self.worker_uuids:
            for job in self.client.query(self.worker_uuids):
                counts[job["status"]] = counts.get(job["status"], 0) + 1
        return counts

    def close(self) -> None:
        if self.worker_uuids:
            self.client.kill(self.worker_uuids)
            self.worker_uuids = []


class DaskCookCluster:
    """Dask `Cluster`-shaped deployment over a cook-tpu scheduler
    (the class dask/docs/design.md sketches).

    Usage (requires `distributed` at runtime):

        cluster = DaskCookCluster(JobClient(url, user=me),
                                  scheduler_address="tcp://...:8786")
        cluster.scale(16)
        client = distributed.Client(cluster.scheduler_address)
    """

    def __init__(self, client: JobClient, scheduler_address: str,
                 spec: Optional[WorkerSpec] = None):
        self.scheduler_address = scheduler_address
        self.pool = WorkerPool(
            client,
            spec or WorkerSpec(
                command_template=(
                    "dask-worker {address} --nthreads {cpus} "
                    "--memory-limit {mem}MB"
                )
            ),
            scheduler_address,
            name="dask",
        )

    def scale(self, n: int) -> None:
        self.pool.scale(n)

    @property
    def workers(self) -> list[str]:
        return list(self.pool.worker_uuids)

    def close(self) -> None:
        self.pool.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
