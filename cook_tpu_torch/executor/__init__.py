"""Task executor (port of `cook_tpu/executor/`, on the standard library)."""
from cook_tpu_torch.executor.runner import (  # noqa: F401
    ExecutorConfig,
    HeartbeatSender,
    RestUpdateSink,
    TaskRunner,
    TaskUpdate,
)
