"""Python job client.

Port of `cook_tpu/client/` (Cook's cookclient `JobClient`,
jobclient/python/cookclient/__init__.py:46): submit / query / kill / wait
over the REST API, with dataclass views of jobs and instances, on the
standard library.  Imports no torch: a submit host needs no GPU stack.
"""
from cook_tpu_torch.client.jobclient import (  # noqa: F401
    JobClient,
    JobClientError,
)
from cook_tpu_torch.client.models import InstanceView, JobView  # noqa: F401
