"""Mesh and sharding layer: pool-axis and node-axis sharded scheduling
solves on `torch.distributed` (`mesh.py`)."""
from cook_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    node_sharded_chunked_match,
    node_sharded_greedy_match,
    pool_sharded_coarse,
    pool_sharded_dru,
    pool_sharded_match,
    run_on_mesh,
    shard_pools,
    task_sharded_dru,
)
