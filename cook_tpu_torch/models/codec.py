"""Entity JSON codec shared by the snapshot and the journal.

A copy of `cook_tpu/models/codec.py` (jax-free), its imports the port's:
the two packages' snapshots and journals encode and decode alike.

Encoding is generic (dataclasses + enums); decoding is explicit per entity
type so schema drift fails loudly.  The reference gets this for free from
Datomic's serialization; here it is the durability boundary, so both the
snapshot (`persistence.snapshot`) and every journal entry's entity payload
go through these functions.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any

from cook_tpu_torch.models.entities import (
    Application,
    Checkpoint,
    ConstraintOperator,
    Container,
    DruMode,
    Group,
    GroupPlacementType,
    HostPlacement,
    Instance,
    InstanceStatus,
    Job,
    JobConstraint,
    JobState,
    Pool,
    Quota,
    Resources,
    Share,
    StragglerHandling,
)


def encode(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: encode(v)
                for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [encode(v) for v in obj]
    if isinstance(obj, dict):
        return {k: encode(v) for k, v in obj.items()}
    if isinstance(obj, float) and obj == float("inf"):
        return "Infinity"
    return obj


def dec_float(x):
    return float("inf") if x == "Infinity" else x


def dec_resources(d: dict) -> Resources:
    return Resources(
        mem=dec_float(d["mem"]), cpus=dec_float(d["cpus"]),
        gpus=dec_float(d["gpus"]), disk=dec_float(d.get("disk", 0.0)),
        ports=int(d.get("ports", 0)),
        disk_type=d.get("disk_type", ""),
    )


def dec_job(d: dict) -> Job:
    return Job(
        uuid=d["uuid"],
        user=d["user"],
        command=d["command"],
        name=d["name"],
        priority=d["priority"],
        max_retries=d["max_retries"],
        max_runtime_ms=d["max_runtime_ms"],
        expected_runtime_ms=d["expected_runtime_ms"],
        resources=dec_resources(d["resources"]),
        pool=d["pool"],
        state=JobState(d["state"]),
        submit_time_ms=d["submit_time_ms"],
        user_provided_env=tuple(map(tuple, d["user_provided_env"])),
        labels=tuple(map(tuple, d["labels"])),
        constraints=tuple(
            JobConstraint(attribute=c["attribute"],
                          operator=ConstraintOperator(c["operator"]),
                          pattern=c["pattern"])
            for c in d["constraints"]
        ),
        group_uuid=d["group_uuid"],
        container=(Container(**{**d["container"],
                                "volumes": tuple(d["container"]["volumes"]),
                                "ports": tuple(d["container"]["ports"]),
                                "env": tuple(map(tuple, d["container"]["env"]))})
                   if d["container"] else None),
        application=(Application(**d["application"])
                     if d.get("application") else None),
        checkpoint=(Checkpoint(
            mode=d["checkpoint"]["mode"],
            periodic_sec=d["checkpoint"]["periodic_sec"],
            preserve_paths=tuple(d["checkpoint"]["preserve_paths"]),
            location=d["checkpoint"]["location"],
        ) if d["checkpoint"] else None),
        disable_mea_culpa_retries=d["disable_mea_culpa_retries"],
        instance_ids=tuple(d["instance_ids"]),
        custom_executor=d["custom_executor"],
        last_waiting_start_time_ms=d["last_waiting_start_time_ms"],
        last_fenzo_placement_failure=d["last_fenzo_placement_failure"],
    )


def dec_instance(d: dict) -> Instance:
    d = dict(d)
    d["status"] = InstanceStatus(d["status"])
    return Instance(**d)


def dec_group(d: dict) -> Group:
    return Group(
        uuid=d["uuid"],
        name=d["name"],
        host_placement=HostPlacement(
            type=GroupPlacementType(d["host_placement"]["type"]),
            attribute=d["host_placement"]["attribute"],
            minimum=d["host_placement"]["minimum"],
        ),
        straggler_handling=StragglerHandling(**d["straggler_handling"]),
        job_uuids=tuple(d["job_uuids"]),
    )


def dec_pool(d: dict) -> Pool:
    return Pool(name=d["name"], purpose=d["purpose"], state=d["state"],
                dru_mode=DruMode(d["dru_mode"]))


def dec_share(d: dict) -> Share:
    return Share(user=d["user"], pool=d["pool"],
                 resources=dec_resources(d["resources"]),
                 reason=d["reason"])


def dec_quota(d: dict) -> Quota:
    return Quota(user=d["user"], pool=d["pool"],
                 resources=dec_resources(d["resources"]),
                 count=d["count"], reason=d.get("reason", ""),
                 launch_rate_saved=d.get("launch_rate_saved", 0.0),
                 launch_rate_per_minute=d.get("launch_rate_per_minute", 0.0))
