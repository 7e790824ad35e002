"""Failure-reason registry with mea-culpa retry semantics.

A copy of `cook_tpu/models/reasons.py`.

A "mea-culpa" failure is the cluster's fault, not the job's: such failures do
not consume the job's retry budget until a per-reason failure limit is hit.
Reference: `reason-entities` + `:job/reasons->attempts-consumed`
(Cook's schema.clj:1155-1199,1413-1666) and
`docs/reason-code`.  Codes are kept API-compatible where behavior depends on
them (normal-exit, killed-by-user, preempted-by-rebalancer, max-runtime,
straggler, unknown).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# failure_limit semantics: None = use the scheduler-wide mea-culpa limit;
# -1 = unlimited free retries for this reason.
UNLIMITED = -1
DEFAULT_MEA_CULPA_FAILURE_LIMIT = 5


@dataclass(frozen=True)
class Reason:
    code: int
    name: str
    mea_culpa: bool
    description: str = ""
    failure_limit: Optional[int] = None


_REASONS: list[Reason] = [
    Reason(1000, "normal-exit", False, "Normal exit"),
    Reason(1001, "killed-by-user", False, "Killed by user"),
    Reason(1002, "preempted-by-rebalancer", True, "Preempted by rebalancer"),
    Reason(1003, "container-preempted", False, "Container preempted by cluster"),
    Reason(1004, "killed-during-launch", False, "Killed during launch"),
    Reason(1005, "running", False, "Task is (still) running"),
    Reason(1006, "scheduling-failed-on-host", True, "Scheduling failed on host",
           failure_limit=3),
    Reason(1007, "container-initialization-timed-out", False,
           "Container initialization timed out"),
    Reason(1008, "killed-externally", True, "Killed by an external entity"),
    Reason(1009, "container-readiness-timed-out", True,
           "Container readiness probe timed out"),
    Reason(1010, "pod-submission-api-error", True, "Backend API error at launch"),
    Reason(1011, "launch-failed", True,
           "Backend launch RPC failed after the match transacted",
           failure_limit=5),
    Reason(2000, "container-limitation", False, "Container resource limitation"),
    Reason(2001, "container-limitation-disk", False, "Container disk limit exceeded"),
    Reason(2002, "container-limitation-memory", False, "Container memory limit exceeded"),
    Reason(2003, "max-runtime-exceeded", False, "Max runtime exceeded"),
    Reason(2004, "straggler", True, "Killed as a straggler"),
    Reason(3000, "reconciliation", False, "Task lost during reconciliation"),
    Reason(3006, "task-unknown", False, "Backend did not recognize the task"),
    Reason(3008, "could-not-reconstruct-state", True,
           "Could not reconstruct task state on failover"),
    Reason(4000, "node-removed", True, "Node was removed"),
    Reason(4001, "node-restarted", True, "Node restarted"),
    Reason(4003, "container-launch-failed", True, "Container launch failed",
           failure_limit=10),
    Reason(4005, "node-disconnected", True, "Node disconnected"),
    Reason(4006, "heartbeat-lost", True, "Executor heartbeat lost"),
    Reason(5001, "backend-disconnected", True, "Compute backend disconnected"),
    Reason(6000, "executor-registration-timeout", True,
           "Executor registration timed out"),
    Reason(6002, "executor-unregistered", False, "Executor unregistered"),
    Reason(99000, "unknown", False, "Unknown reason"),
    Reason(99002, "executor-terminated", True, "Executor terminated",
           failure_limit=3),
    Reason(99003, "command-executor-failed", False, "Command executor failed"),
]

REASONS_BY_CODE: dict[int, Reason] = {r.code: r for r in _REASONS}
REASONS_BY_NAME: dict[str, Reason] = {r.name: r for r in _REASONS}

NORMAL_EXIT = REASONS_BY_NAME["normal-exit"]
KILLED_BY_USER = REASONS_BY_NAME["killed-by-user"]
PREEMPTED_BY_REBALANCER = REASONS_BY_NAME["preempted-by-rebalancer"]
MAX_RUNTIME_EXCEEDED = REASONS_BY_NAME["max-runtime-exceeded"]
STRAGGLER = REASONS_BY_NAME["straggler"]
KILLED_DURING_LAUNCH = REASONS_BY_NAME["killed-during-launch"]
HEARTBEAT_LOST = REASONS_BY_NAME["heartbeat-lost"]
UNKNOWN = REASONS_BY_NAME["unknown"]


def get_reason(code_or_name) -> Reason:
    if isinstance(code_or_name, Reason):
        return code_or_name
    if isinstance(code_or_name, int):
        return REASONS_BY_CODE.get(code_or_name, UNKNOWN)
    return REASONS_BY_NAME.get(code_or_name, UNKNOWN)


def attempts_consumed_by_reasons(
    reason_codes: list[Optional[int]],
    *,
    mea_culpa_limit: int = DEFAULT_MEA_CULPA_FAILURE_LIMIT,
    disable_mea_culpa_retries: bool = False,
) -> int:
    """How many retry-budget attempts a list of failure reasons consumes.

    Non-mea-culpa failures (and unknown/None reasons) each consume one
    attempt.  Mea-culpa failures are free until their per-reason failure
    limit (or the global limit) is exceeded; a limit of -1 means always free.
    Reference: `:job/reasons->attempts-consumed` (schema.clj:1155-1174).
    """
    counts: dict[Optional[int], int] = {}
    for code in reason_codes:
        counts[code] = counts.get(code, 0) + 1
    consumed = 0
    for code, count in counts.items():
        reason = REASONS_BY_CODE.get(code) if code is not None else None
        if reason is not None and reason.mea_culpa:
            if disable_mea_culpa_retries:
                limit = 0
            elif reason.failure_limit is not None:
                limit = reason.failure_limit
            else:
                limit = mea_culpa_limit
            if limit == UNLIMITED:
                continue
            consumed += max(0, count - limit)
        else:
            # A missing/unknown reason counts as a plain failure.
            consumed += count
    return consumed
