"""Structured JSON logging + passport audit events.

A copy of `cook_tpu/utils/logging.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.log-structured (scheduler/src/cook/
log_structured.clj — JSON log lines with standard keys) and cook.passport
(passport.clj — an audit event stream on a dedicated logger: job-created,
job-launched, pod-completed, ...).
"""
from __future__ import annotations

import json
import logging
from typing import Any, Optional

structured_logger = logging.getLogger("cook_tpu_torch.structured")
passport_logger = logging.getLogger("cook_tpu_torch.passport")


def log_structured(
    level: int,
    message: str,
    *,
    pool: Optional[str] = None,
    user: Optional[str] = None,
    job: Optional[str] = None,
    instance: Optional[str] = None,
    compute_cluster: Optional[str] = None,
    component: Optional[str] = None,
    **extra: Any,
) -> None:
    record = {"message": message}
    for key, value in [
        ("pool", pool), ("user", user), ("job", job), ("instance", instance),
        ("compute-cluster", compute_cluster), ("component", component),
    ]:
        if value is not None:
            record[key] = value
    record.update(extra)
    structured_logger.log(level, json.dumps(record, default=str))


def log_info(message: str, **kw) -> None:
    log_structured(logging.INFO, message, **kw)


def log_error(message: str, **kw) -> None:
    log_structured(logging.ERROR, message, **kw)


# Passport event types (the reference enumerates these as keywords)
JOB_CREATED = "job-created"
JOB_SUBMITTED = "job-submitted"
JOB_LAUNCHED = "job-launched"
JOB_COMPLETED = "job-completed"
INSTANCE_COMPLETED = "instance-completed"
INSTANCE_PREEMPTED = "instance-preempted"
CLUSTER_STATE_CHANGED = "cluster-state-changed"


def passport(event_type: str, **data: Any) -> None:
    """Emit one audit event (reference: passport.clj `log-event`)."""
    passport_logger.info(
        json.dumps({"event-type": event_type, **data}, default=str)
    )


_STORE_EVENT_TO_PASSPORT = {
    "job/created": JOB_CREATED,
    "instance/created": JOB_LAUNCHED,
    "instance/status": INSTANCE_COMPLETED,   # terminal statuses only
    "job/state": JOB_COMPLETED,              # completed transitions only
}


def attach_passport(store) -> None:
    """Bridge the store's transaction feed onto the passport audit stream
    (the reference sprinkles passport calls through the code; the event
    log lets us derive the same audit trail in one place)."""

    def on_event(event) -> None:
        kind = event.kind
        mapped = _STORE_EVENT_TO_PASSPORT.get(kind)
        if mapped is None:
            return
        if kind == "instance/status" and event.data.get("status") not in (
            "success", "failed"
        ):
            return
        if kind == "job/state" and event.data.get("state") != "completed":
            return
        passport(mapped, seq=event.seq, **event.data)

    store.add_watcher(on_event)
