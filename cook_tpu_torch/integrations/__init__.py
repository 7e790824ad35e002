"""Framework integrations: run Dask/Spark-style worker fleets as jobs
(port of `cook_tpu/integrations/`)."""
from cook_tpu_torch.integrations.workerpool import (  # noqa: F401
    DaskCookCluster,
    WorkerPool,
    WorkerSpec,
)
