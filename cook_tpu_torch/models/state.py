"""The job/instance state machine as pure transition functions.

A copy of `cook_tpu/models/state.py`.

Reference semantics: the `:instance/update-state` / `:job/update-state` /
`:job/allowed-to-start?` Datomic db-fns
(Cook's schema.clj:1112-1413).  Those run inside
the Datomic transactor to get atomicity; here they are pure functions applied
under the store's transaction lock (`cook_tpu_torch.models.store`), which gives the
same serializability with far less machinery.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from cook_tpu_torch.models import reasons as reasons_mod
from cook_tpu_torch.models.entities import Instance, InstanceStatus, Job, JobState

# Valid instance status transitions (schema.clj:1259-1264).
INSTANCE_TRANSITIONS: dict[InstanceStatus, frozenset[InstanceStatus]] = {
    InstanceStatus.UNKNOWN: frozenset(
        {InstanceStatus.RUNNING, InstanceStatus.FAILED, InstanceStatus.SUCCESS}
    ),
    InstanceStatus.RUNNING: frozenset({InstanceStatus.FAILED, InstanceStatus.SUCCESS}),
    InstanceStatus.SUCCESS: frozenset(),
    InstanceStatus.FAILED: frozenset(),
}


def valid_instance_transition(old: InstanceStatus, new: InstanceStatus) -> bool:
    return new in INSTANCE_TRANSITIONS[old]


def attempts_consumed(
    job: Job,
    instances: Sequence[Instance],
    *,
    mea_culpa_limit: int = reasons_mod.DEFAULT_MEA_CULPA_FAILURE_LIMIT,
) -> int:
    """Retry attempts the job has used: one per terminal instance, except
    mea-culpa failures under their limit (schema.clj:1175-1191)."""
    codes = [
        inst.reason_code
        for inst in instances
        if inst.status.terminal
    ]
    return reasons_mod.attempts_consumed_by_reasons(
        codes,
        mea_culpa_limit=mea_culpa_limit,
        disable_mea_culpa_retries=job.disable_mea_culpa_retries,
    )


def all_attempts_consumed(
    job: Job,
    instances: Sequence[Instance],
    *,
    mea_culpa_limit: int = reasons_mod.DEFAULT_MEA_CULPA_FAILURE_LIMIT,
) -> bool:
    return job.max_retries <= attempts_consumed(
        job, instances, mea_culpa_limit=mea_culpa_limit
    )


def derive_job_state(
    job: Job,
    instance_statuses: Sequence[InstanceStatus],
    exhausted: bool,
) -> JobState:
    """Job-state derivation given its instances' statuses
    (schema.clj:1294-1310):

    - completed stays completed (terminal)
    - any success, or all failed with retries exhausted -> completed
    - any running/unknown -> running
    - otherwise -> waiting
    """
    if job.state == JobState.COMPLETED:
        return JobState.COMPLETED
    statuses = list(instance_statuses)
    any_success = any(s == InstanceStatus.SUCCESS for s in statuses)
    any_live = any(
        s in (InstanceStatus.RUNNING, InstanceStatus.UNKNOWN) for s in statuses
    )
    all_failed = bool(statuses) and all(s == InstanceStatus.FAILED for s in statuses)
    if any_success or (all_failed and exhausted):
        return JobState.COMPLETED
    if any_live:
        return JobState.RUNNING
    return JobState.WAITING


@dataclass(frozen=True)
class StateUpdate:
    """Result of applying `update_instance_state`."""

    applied: bool
    new_instance_status: Optional[InstanceStatus] = None
    new_job_state: Optional[JobState] = None
    job_newly_waiting: bool = False  # job (re)entered WAITING -> stamp time


def update_instance_state(
    job: Job,
    instances: Sequence[Instance],
    task_id: str,
    new_status: InstanceStatus,
    reason_code: Optional[int],
    *,
    mea_culpa_limit: int = reasons_mod.DEFAULT_MEA_CULPA_FAILURE_LIMIT,
) -> StateUpdate:
    """The `:instance/update-state` transition (schema.clj:1240-1310), pure.

    Validates the instance transition; if valid, computes the new job state
    considering all sibling instances with this instance at its new status.
    Returns `applied=False` for invalid transitions (they are silently
    ignored, as in the reference).
    """
    by_id = {inst.task_id: inst for inst in instances}
    inst = by_id.get(task_id)
    if inst is None or not valid_instance_transition(inst.status, new_status):
        return StateUpdate(applied=False)

    updated = inst.with_(status=new_status, reason_code=reason_code)
    siblings = [updated if i.task_id == task_id else i for i in instances]
    exhausted = all_attempts_consumed(
        job, siblings, mea_culpa_limit=mea_culpa_limit
    )
    new_job_state = derive_job_state(
        job, [i.status for i in siblings], exhausted
    )
    return StateUpdate(
        applied=True,
        new_instance_status=new_status,
        new_job_state=new_job_state,
        job_newly_waiting=(
            new_job_state == JobState.WAITING and job.state != JobState.WAITING
        ),
    )


class JobNotAllowedToStart(Exception):
    """Raised to veto a launch transaction (reference:
    `:job/allowed-to-start?`, schema.clj:1311-1330)."""


def check_allowed_to_start(job: Job, instances: Sequence[Instance]) -> None:
    """A job may only start if it is WAITING and has no live instances."""
    if job.state != JobState.WAITING:
        raise JobNotAllowedToStart(
            f"job {job.uuid} is {job.state.value}, not waiting"
        )
    live = [
        i.task_id
        for i in instances
        if i.status in (InstanceStatus.UNKNOWN, InstanceStatus.RUNNING)
    ]
    if live:
        raise JobNotAllowedToStart(
            f"job {job.uuid} has live instances: {live}"
        )


def retry_job_state(
    job: Job,
    instances: Sequence[Instance],
    new_max_retries: int,
    *,
    mea_culpa_limit: int = reasons_mod.DEFAULT_MEA_CULPA_FAILURE_LIMIT,
) -> JobState:
    """`:job/update-state-on-retry` (schema.clj:1370-1385): a completed job
    with retries remaining under the new budget goes back to WAITING."""
    consumed = attempts_consumed(job, instances, mea_culpa_limit=mea_culpa_limit)
    if consumed > new_max_retries:
        raise ValueError(
            f"cannot set retries to {new_max_retries}: {consumed} already consumed"
        )
    if job.state == JobState.COMPLETED and consumed < new_max_retries:
        # Only a failed-complete job can be revived; a successful job stays done.
        if not any(i.status == InstanceStatus.SUCCESS for i in instances):
            return JobState.WAITING
    return job.state
