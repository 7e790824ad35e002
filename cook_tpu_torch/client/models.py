"""Typed client-side views of API responses.

Port of `cook_tpu/client/models.py`, a copy (it needs no HTTP library):
Cook's cookclient Job/Instance dataclasses
(jobclient/python/cookclient/{jobs,instance}.py) — thin wrappers over the
JSON with typed accessors; the raw dict stays available as `.raw` for
fields the wrapper doesn't surface.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class InstanceView:
    raw: dict[str, Any]

    @property
    def task_id(self) -> str:
        return self.raw["task_id"]

    @property
    def status(self) -> str:
        return self.raw["status"]

    @property
    def hostname(self) -> str:
        return self.raw.get("hostname", "")

    @property
    def reason_code(self) -> Optional[int]:
        return self.raw.get("reason_code")

    @property
    def reason_string(self) -> str:
        return self.raw.get("reason_string", "")

    @property
    def mea_culpa(self) -> bool:
        return bool(self.raw.get("reason_mea_culpa"))

    @property
    def exit_code(self) -> Optional[int]:
        return self.raw.get("exit_code")

    @property
    def output_url(self) -> str:
        return self.raw.get("output_url", "")

    @property
    def progress(self) -> int:
        return int(self.raw.get("progress", 0))


@dataclass(frozen=True)
class JobView:
    raw: dict[str, Any]

    @property
    def uuid(self) -> str:
        return self.raw["uuid"]

    @property
    def status(self) -> str:
        return self.raw["status"]

    @property
    def user(self) -> str:
        return self.raw["user"]

    @property
    def name(self) -> str:
        return self.raw.get("name", "")

    @property
    def pool(self) -> str:
        return self.raw.get("pool", "")

    @property
    def mem(self) -> float:
        return float(self.raw.get("mem", 0.0))

    @property
    def cpus(self) -> float:
        return float(self.raw.get("cpus", 0.0))

    @property
    def gpus(self) -> float:
        return float(self.raw.get("gpus", 0.0))

    @property
    def max_retries(self) -> int:
        return int(self.raw.get("max_retries", 1))

    @property
    def retries_remaining(self) -> int:
        return int(self.raw.get("retries_remaining", 0))

    @property
    def instances(self) -> list[InstanceView]:
        return [InstanceView(i) for i in self.raw.get("instances", [])]

    @property
    def last_instance(self) -> Optional[InstanceView]:
        insts = self.instances
        return insts[-1] if insts else None

    @property
    def completed(self) -> bool:
        return self.status == "completed"

    @property
    def succeeded(self) -> bool:
        last = self.last_instance
        return self.completed and last is not None and last.status == "success"
