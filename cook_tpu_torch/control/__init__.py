"""Control plane: leader election (`leader`), the lease service
(`lease_server`) and standby journal replication (`replication`)."""
from cook_tpu_torch.control.leader import (  # noqa: F401
    FileLeaseElector,
    InMemoryElector,
    LeaderElector,
    LeaderSelector,
)
