"""Plugin hook points.

A copy of `cook_tpu/scheduler/plugins.py` (jax-free), its imports rewritten to the
port's modules.

Reference: cook.plugins (scheduler/src/cook/plugins/
definitions.clj:18-70 + submission.clj/launch.clj caching wrappers).  The
same seven extension seams, as Python protocols resolved from dotted paths
(the analog of `lazy-load-var`), with the submission/launch results cached
for a TTL like the reference's caching wrappers.
"""
from __future__ import annotations

import importlib
import logging
from dataclasses import dataclass, field
from typing import Any, Protocol, runtime_checkable

from cook_tpu_torch.models.entities import Job
from cook_tpu_torch.utils.incremental import entity_fraction


@dataclass(frozen=True)
class PluginResult:
    accepted: bool
    message: str = ""
    # for launch filters: suppress retries until this time
    cache_expires_ms: int = 0


ACCEPT = PluginResult(accepted=True)


@runtime_checkable
class JobSubmissionValidator(Protocol):
    def check_job_submission(self, job_spec: dict, user: str, pool: str
                             ) -> PluginResult: ...


@runtime_checkable
class JobSubmissionModifier(Protocol):
    def modify_job(self, job_spec: dict, user: str, pool: str) -> dict: ...


@runtime_checkable
class JobLaunchFilter(Protocol):
    def check_job_launch(self, job: Job) -> PluginResult: ...


@runtime_checkable
class InstanceCompletionHandler(Protocol):
    def on_instance_completion(self, job: Job, instance) -> None: ...


@runtime_checkable
class PoolSelector(Protocol):
    def select_pool(self, job_spec: dict, default_pool: str) -> str: ...


@runtime_checkable
class JobAdjuster(Protocol):
    def adjust_job(self, job: Job) -> Job: ...


@runtime_checkable
class JobRouter(Protocol):
    def route_pool(self, job_spec: dict) -> str: ...


@runtime_checkable
class FileUrlGenerator(Protocol):
    """Generates the sandbox-file URL surfaced to clients for one
    instance (reference: FileUrlGenerator, plugins/definitions.clj:56 —
    deployments front sandbox access with their own file service)."""

    def file_url(self, instance) -> str: ...


class AttributePoolSelector:
    """Default pool selection: an explicit `pool` field, else the default
    (reference plugins/pool.clj attribute-pool-selector)."""

    def select_pool(self, job_spec: dict, default_pool: str) -> str:
        return job_spec.get("pool") or default_pool


class PoolMoverAdjuster:
    """Percentage-rollout migration of a user's jobs between pools at
    submission (reference plugins/pool_mover.clj): config maps a
    submission pool to `{"destination_pool": ..., "users": {user:
    {"portion": 0..1}}}`; a job moves when its uuid's stable hash bucket
    (mod 100) falls under portion*100 — the same jobs move on every
    resubmission, giving a deterministic gradual rollout."""

    def __init__(self, config: dict):
        self.config = dict(config or {})

    def adjust_job(self, job: Job) -> Job:
        rule = self.config.get(job.pool)
        if not rule:
            return job
        portion = (rule.get("users", {}).get(job.user) or {}).get("portion")
        destination = rule.get("destination_pool")
        if not isinstance(portion, (int, float)) or not destination:
            return job
        # stable uuid-hash rollout (pool_mover.clj: (mod (hash uuid) 100)),
        # via the same bucketing idiom as incremental config rollouts
        if entity_fraction(job.uuid) < portion:
            return job.with_(pool=destination)
        return job


def load_plugin(dotted_path: str) -> Any:
    """`lazy-load-var` analog: 'package.module:ClassName' or
    'package.module.factory_fn'."""
    if ":" in dotted_path:
        mod_name, attr = dotted_path.split(":", 1)
    else:
        mod_name, _, attr = dotted_path.rpartition(".")
    module = importlib.import_module(mod_name)
    obj = getattr(module, attr)
    return obj() if isinstance(obj, type) else obj


@dataclass
class PluginRegistry:
    submission_validators: list = field(default_factory=list)
    submission_modifiers: list = field(default_factory=list)
    launch_filters: list = field(default_factory=list)
    completion_handlers: list = field(default_factory=list)
    pool_selector: Any = field(default_factory=AttributePoolSelector)
    job_adjusters: list = field(default_factory=list)
    job_routers: list = field(default_factory=list)
    # None = the backend's own sandbox URL (retrieve_sandbox_url_path)
    file_url_generator: Any = None

    def sandbox_url(self, instance, default_fn) -> str:
        """Sandbox file URL for an instance: the FileUrlGenerator plugin
        when configured, else the backend default."""
        if self.file_url_generator is not None:
            return self.file_url_generator.file_url(instance)
        return default_fn()

    def validate_submission(self, job_spec: dict, user: str, pool: str
                            ) -> PluginResult:
        for validator in self.submission_validators:
            result = validator.check_job_submission(job_spec, user, pool)
            if not result.accepted:
                return result
        return ACCEPT

    def modify_submission(self, job_spec: dict, user: str, pool: str) -> dict:
        for modifier in self.submission_modifiers:
            job_spec = modifier.modify_job(job_spec, user, pool)
        return job_spec

    def check_launch(self, job: Job, now_ms: int,
                     cache: dict[str, tuple[int, PluginResult]]) -> bool:
        """Launch-filter with TTL cache (reference plugins/launch.clj)."""
        cached = cache.get(job.uuid)
        if cached is not None and cached[0] > now_ms:
            return cached[1].accepted
        for plugin in self.launch_filters:
            result = plugin.check_job_launch(job)
            if not result.accepted:
                expires = result.cache_expires_ms or (now_ms + 60_000)
                cache[job.uuid] = (expires, result)
                return False
        cache[job.uuid] = (now_ms + 60_000, ACCEPT)
        return True

    def on_completion(self, job: Job, instance) -> None:
        for handler in self.completion_handlers:
            handler.on_instance_completion(job, instance)

    def adjust(self, job: Job) -> Job:
        """Run JobAdjusters over a parsed job at submission.  A failing
        adjuster is skipped and the job passes through unchanged, like
        the reference's catch-and-keep (pool_mover.clj error path)."""
        for adjuster in self.job_adjusters:
            try:
                job = adjuster.adjust_job(job)
            except Exception:  # noqa: BLE001 — plugin faults never block
                logging.getLogger(__name__).exception(
                    "job adjuster %r failed; keeping job unchanged",
                    adjuster)
        return job


def registry_from_config(conf: dict) -> "PluginRegistry":
    """Build the registry from the `plugins` config section: dotted paths
    per seam (the reference's lazy-load-var wiring, components.clj) plus
    the built-in pool-mover rule table.

        {"submission_validators": ["pkg.mod:Cls", ...],
         "submission_modifiers": [...], "launch_filters": [...],
         "completion_handlers": [...], "job_adjusters": [...],
         "job_routers": [...], "pool_selector": "pkg.mod:Cls",
         "file_url_generator": "pkg.mod:Cls",
         "pool_mover": {submission_pool: {"destination_pool": ...,
                        "users": {user: {"portion": 0.25}}}}}
    """
    conf = conf or {}
    registry = PluginRegistry()
    for seam in ("submission_validators", "submission_modifiers",
                 "launch_filters", "completion_handlers",
                 "job_adjusters", "job_routers"):
        for path in conf.get(seam, []):
            getattr(registry, seam).append(load_plugin(path))
    if conf.get("pool_selector"):
        registry.pool_selector = load_plugin(conf["pool_selector"])
    if conf.get("file_url_generator"):
        registry.file_url_generator = load_plugin(conf["file_url_generator"])
    if conf.get("pool_mover"):
        registry.job_adjusters.append(PoolMoverAdjuster(conf["pool_mover"]))
    return registry
