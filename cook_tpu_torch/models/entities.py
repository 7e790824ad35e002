"""Domain entities: jobs, instances, groups, pools, resources.

A copy of `cook_tpu/models/entities.py` (the port imports nothing of
`cook_tpu`).

Mirrors the capability surface of the reference's Datomic schema
(`cook/schema.clj:20-966`) as plain Python
dataclasses.  State lives in an event-sourced store (`cook_tpu_torch.models.store`);
these objects are the *values* it holds, and all state transitions go through
the pure functions in `cook_tpu_torch.models.state`.
"""
from __future__ import annotations

import dataclasses
import enum
import uuid as uuid_mod
from dataclasses import dataclass, field
from typing import Any, Optional


class JobState(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    COMPLETED = "completed"


class InstanceStatus(enum.Enum):
    UNKNOWN = "unknown"  # launched, not yet confirmed running
    RUNNING = "running"
    SUCCESS = "success"
    FAILED = "failed"

    @property
    def terminal(self) -> bool:
        return self in (InstanceStatus.SUCCESS, InstanceStatus.FAILED)


class DruMode(enum.Enum):
    """Per-pool fairness mode (reference: `:pool.dru-mode/default|gpu`)."""

    DEFAULT = "default"  # dominant of mem/cpu
    GPU = "gpu"          # cumulative gpu share


@dataclass(frozen=True)
class Resources:
    """A resource vector.  `mem` is MB, `cpus`/`gpus` are counts.

    Reference: resource attributes in schema.clj (`:resource/type` etc.).
    """

    mem: float = 0.0
    cpus: float = 0.0
    gpus: float = 0.0
    disk: float = 0.0
    ports: int = 0
    # requested disk type ("" = any); a typed request only matches hosts
    # advertising that type (disk-host-constraint, constraints.clj:164)
    disk_type: str = ""

    def __add__(self, other: "Resources") -> "Resources":
        return Resources(
            mem=self.mem + other.mem,
            cpus=self.cpus + other.cpus,
            gpus=self.gpus + other.gpus,
            disk=self.disk + other.disk,
            ports=self.ports + other.ports,
        )

    def __sub__(self, other: "Resources") -> "Resources":
        return Resources(
            mem=self.mem - other.mem,
            cpus=self.cpus - other.cpus,
            gpus=self.gpus - other.gpus,
            disk=self.disk - other.disk,
            ports=self.ports - other.ports,
        )

    def fits_within(self, other: "Resources") -> bool:
        return (
            self.mem <= other.mem
            and self.cpus <= other.cpus
            and self.gpus <= other.gpus
            and self.disk <= other.disk
            and self.ports <= other.ports
        )

    def to_dict(self) -> dict:
        return {"mem": self.mem, "cpus": self.cpus, "gpus": self.gpus,
                "disk": self.disk, "ports": self.ports}


@dataclass(frozen=True)
class Application:
    """Client application metadata (reference: `:job/application`)."""

    name: str = ""
    version: str = ""
    workload_class: str = ""
    workload_id: str = ""


@dataclass(frozen=True)
class Container:
    """Container spec (reference: container attributes in schema.clj)."""

    image: str = ""
    kind: str = "docker"
    volumes: tuple = ()
    ports: tuple = ()
    env: tuple = ()  # ((k, v), ...)


@dataclass(frozen=True)
class Checkpoint:
    """Job checkpointing config (reference: `:job/checkpoint`, schema.clj:84)."""

    mode: str = ""  # "auto" | "periodic" | "preemption"
    periodic_sec: int = 0
    preserve_paths: tuple = ()
    location: str = ""  # where the last checkpoint was written (locality hint)


class GroupPlacementType(enum.Enum):
    """Group host-placement constraint types (reference: `docs/groups.md`,
    constraints.clj:568-660)."""

    ALL = "all"                # no constraint
    UNIQUE = "unique"          # each member on a distinct host
    BALANCED = "balanced"      # spread across attribute values, max skew
    ATTRIBUTE_EQUALS = "attribute-equals"  # all members share an attribute value


@dataclass(frozen=True)
class HostPlacement:
    type: GroupPlacementType = GroupPlacementType.ALL
    attribute: str = ""
    minimum: int = 0  # for BALANCED: min distinct attr values to spread over


@dataclass(frozen=True)
class StragglerHandling:
    """Group straggler handling (reference: `docs/groups.md`)."""

    type: str = "none"  # "none" | "quantile-deviation"
    quantile: float = 0.5
    multiplier: float = 2.0


@dataclass(frozen=True)
class Group:
    uuid: str
    name: str = "defaultgroup"
    host_placement: HostPlacement = field(default_factory=HostPlacement)
    straggler_handling: StragglerHandling = field(default_factory=StragglerHandling)
    job_uuids: tuple = ()


class ConstraintOperator(enum.Enum):
    """User-specified job constraint operators
    (reference: constraints.clj:356-430 `build-constraint`)."""

    EQUALS = "EQUALS"


@dataclass(frozen=True)
class JobConstraint:
    attribute: str
    operator: ConstraintOperator
    pattern: str


@dataclass(frozen=True)
class Job:
    """An immutable job description + its mutable scheduling state.

    Reference: job attributes, schema.clj (`:job/...`).
    """

    uuid: str
    user: str
    command: str = ""
    name: str = "cookjob"
    priority: int = 50
    max_retries: int = 1
    max_runtime_ms: int = 2**62
    expected_runtime_ms: int = 0
    resources: Resources = field(default_factory=lambda: Resources(mem=128.0, cpus=1.0))
    pool: str = ""
    state: JobState = JobState.WAITING
    submit_time_ms: int = 0
    user_provided_env: tuple = ()
    labels: tuple = ()
    constraints: tuple = ()  # tuple[JobConstraint]
    group_uuid: Optional[str] = None
    # gang scheduling (ROADMAP item 3): k > 0 marks this job one member
    # of a k-host gang — all members share `group_uuid` and must place
    # together inside ONE topology block or not at all (the matcher's
    # all-or-nothing rule; scheduler/gang.py).  0 = not a gang member.
    gang_size: int = 0
    container: Optional[Container] = None
    application: Optional[Application] = None
    checkpoint: Optional[Checkpoint] = None
    disable_mea_culpa_retries: bool = False
    instance_ids: tuple = ()  # ordered instance uuids
    custom_executor: bool = False
    last_waiting_start_time_ms: int = 0
    last_fenzo_placement_failure: str = ""  # json blob for /unscheduled_jobs

    def with_(self, **kw) -> "Job":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Instance:
    """One attempt at running a job (reference: `:instance/...`)."""

    task_id: str
    job_uuid: str
    status: InstanceStatus = InstanceStatus.UNKNOWN
    hostname: str = ""
    node_id: str = ""  # reference: slave-id
    compute_cluster: str = ""
    start_time_ms: int = 0
    end_time_ms: int = 0
    reason_code: Optional[int] = None
    preempted: bool = False
    progress: int = 0
    progress_message: str = ""
    exit_code: Optional[int] = None
    sandbox_directory: str = ""
    backfilled: bool = False
    cancelled: bool = False

    def with_(self, **kw) -> "Instance":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class Pool:
    """A named scheduling domain (reference: pool.clj)."""

    name: str
    purpose: str = ""
    state: str = "active"  # "active" | "inactive"
    dru_mode: DruMode = DruMode.DEFAULT

    @property
    def schedules_jobs(self) -> bool:
        return self.state == "active"

    @property
    def accepts_submissions(self) -> bool:
        return self.state == "active"


@dataclass(frozen=True)
class Share:
    """Per-user per-pool fair-share divisors (reference: share.clj)."""

    user: str
    pool: str
    resources: Resources
    reason: str = ""


@dataclass(frozen=True)
class Quota:
    """Per-user per-pool hard caps (reference: quota.clj). `count` caps the
    number of concurrently running jobs."""

    user: str
    pool: str
    resources: Resources
    count: int = 2**31
    launch_rate_saved: float = 0.0
    launch_rate_per_minute: float = 0.0
    reason: str = ""


DEFAULT_USER = "default"  # fallback share/quota owner (reference: share.clj default-user)


def new_uuid() -> str:
    return str(uuid_mod.uuid4())


def job_display(job: Job) -> dict[str, Any]:
    """JSON-friendly view of a job, REST-response shaped."""
    return {
        "uuid": job.uuid,
        "user": job.user,
        "command": job.command,
        "name": job.name,
        "priority": job.priority,
        "max_retries": job.max_retries,
        "max_runtime": job.max_runtime_ms,
        "status": job.state.value,
        "pool": job.pool,
        "submit_time": job.submit_time_ms,
        "mem": job.resources.mem,
        "cpus": job.resources.cpus,
        "gpus": job.resources.gpus,
        "disk": job.resources.disk,
        "disk_type": job.resources.disk_type,
        "ports": job.resources.ports,
        "labels": dict(job.labels),
        "gang_size": job.gang_size,
        "env": dict(job.user_provided_env),
        "instances": list(job.instance_ids),
        "application": (
            {"name": job.application.name,
             "version": job.application.version,
             "workload-class": job.application.workload_class,
             "workload-id": job.application.workload_id}
            if job.application else None
        ),
    }
