"""Spark-on-cook: the coarse-grained scheduler backend, cook-side.

Port of `cook_tpu/integrations/spark.py`, a copy on the port's job
client.  Reference: Cook's spark/ — patches teaching Spark 1.5/1.6 a
`cook://user@host:port` master URL whose backend submits each Spark
executor as a Cook job and (in the 1.6.1 patch) supports dynamic
allocation.  Spark dropped those patch points long ago; the durable
shape of the integration is the one implemented here: a driver-side
backend object that

  * parses the `cook://` master URL,
  * runs each executor as a cook job carrying a distinct executor id and
    the driver's coordination URL (Spark's CoarseGrainedExecutorBackend
    contract),
  * sizes the fleet from `spark.cores.max` / `spark.executor.cores`,
  * implements Spark's ExecutorAllocationClient verbs
    (`request_total_executors`, `kill_executors`) for dynamic allocation,
  * retries lost executors through cook's own retry machinery
    (max_retries + mea-culpa preemption retries, like the patch relied
    on).
"""
from __future__ import annotations

import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Optional
from urllib.parse import urlsplit

from cook_tpu_torch.client.jobclient import JobClient


@dataclass(frozen=True)
class CookMaster:
    """Parsed `cook://user@host:port` master URL (spark/README.md)."""

    user: str
    host: str
    port: int

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"


def parse_master_url(master: str) -> CookMaster:
    if not master.startswith("cook://"):
        raise ValueError(f"not a cook master URL: {master!r}")
    parts = urlsplit(master)
    if not parts.hostname or not parts.port:
        raise ValueError(f"cook master URL needs host:port: {master!r}")
    return CookMaster(user=parts.username or "spark",
                      host=parts.hostname, port=parts.port)


@dataclass
class SparkExecutorSpec:
    """What one Spark executor job looks like.

    `command_template` receives {driver_url}, {executor_id}, {cores},
    {mem} — the arguments CoarseGrainedExecutorBackend needs."""

    command_template: str = (
        "spark-class org.apache.spark.executor.CoarseGrainedExecutorBackend"
        " --driver-url {driver_url} --executor-id {executor_id}"
        " --cores {cores} --app-id cook-spark"
    )
    executor_cores: float = 1.0    # spark.executor.cores
    executor_mem: float = 4096.0   # spark.executor.memory (MB)
    max_cores: float = 0.0         # spark.cores.max; 0 = no initial fleet
    pool: Optional[str] = None
    max_retries: int = 10          # executors ride cook's retry machinery
    env: dict = field(default_factory=dict)


class SparkCookBackend:
    """Driver-side executor fleet manager (the patched
    CoarseGrainedSchedulerBackend subclass, cook-side half)."""

    def __init__(self, master: str, driver_url: str,
                 spec: Optional[SparkExecutorSpec] = None,
                 client: Optional[JobClient] = None):
        self.master = parse_master_url(master)
        self.driver_url = driver_url
        self.spec = spec or SparkExecutorSpec()
        self.client = client or JobClient(self.master.url,
                                          user=self.master.user)
        self.app_group = str(uuid_mod.uuid4())
        # executor id -> job uuid (live fleet)
        self.executors: dict[str, str] = {}
        self._next_executor_id = 0
        self._started = False

    # ------------------------------------------------------------- fleet

    @property
    def target_executors(self) -> int:
        if self.spec.max_cores <= 0:
            return 0
        return max(int(self.spec.max_cores // self.spec.executor_cores), 1)

    def start(self) -> list[str]:
        """Submit the initial fleet per spark.cores.max (the patch refuses
        to launch executors without it, spark/README.md)."""
        self._started = True
        return self.request_total_executors(self.target_executors)

    def _executor_job(self, executor_id: str) -> dict:
        spec = self.spec
        return {
            "name": f"spark-executor-{executor_id}",
            "command": spec.command_template.format(
                driver_url=self.driver_url,
                executor_id=executor_id,
                cores=int(spec.executor_cores),
                mem=int(spec.executor_mem),
            ),
            "mem": spec.executor_mem,
            "cpus": spec.executor_cores,
            "max_retries": spec.max_retries,
            "group": self.app_group,
            "env": {
                "SPARK_EXECUTOR_ID": executor_id,
                "SPARK_DRIVER_URL": self.driver_url,
                **spec.env,
            },
            "labels": {"spark-app-group": self.app_group},
            **({"pool": spec.pool} if spec.pool else {}),
        }

    # Spark ExecutorAllocationClient verbs (dynamic allocation)

    def request_total_executors(self, n: int) -> list[str]:
        """Grow/shrink the fleet to n executors; returns live job uuids."""
        if len(self.executors) < n:
            # one batched submit for the whole growth step: fleet startup
            # is O(1) round-trips and never half-submitted on failure
            new_ids = []
            while len(self.executors) + len(new_ids) < n:
                new_ids.append(str(self._next_executor_id))
                self._next_executor_id += 1
            groups = ([{"uuid": self.app_group, "name": "spark-app"}]
                      if not self.executors else ())
            uuids = self.client.submit(
                [self._executor_job(eid) for eid in new_ids], groups=groups)
            self.executors.update(zip(new_ids, uuids))
        if len(self.executors) > n:
            surplus = sorted(self.executors, key=int, reverse=True)
            victims = surplus[: len(self.executors) - n]
            self.kill_executors(victims)
        return list(self.executors.values())

    def kill_executors(self, executor_ids: list[str]) -> None:
        uuids = [self.executors.pop(e) for e in executor_ids
                 if e in self.executors]
        if uuids:
            self.client.kill(uuids)

    def executor_status(self) -> dict[str, str]:
        """executor id -> job status (the backend's heartbeat view)."""
        if not self.executors:
            return {}
        by_uuid = {uuid: eid for eid, uuid in self.executors.items()}
        return {
            by_uuid[job["uuid"]]: job["status"]
            for job in self.client.query(list(self.executors.values()))
        }

    def stop(self) -> None:
        if self.executors:
            self.client.kill(list(self.executors.values()))
            self.executors = {}

    def __enter__(self):
        if not self._started:
            self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
