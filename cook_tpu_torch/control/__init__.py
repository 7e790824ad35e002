"""Control plane: leader election."""
from cook_tpu_torch.control.leader import (  # noqa: F401
    FileLeaseElector,
    InMemoryElector,
    LeaderElector,
    LeaderSelector,
)
