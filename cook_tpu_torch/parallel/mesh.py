"""Dead-lane padding of batched match problems.

Port of `invalid_match_problem` from `cook_tpu/parallel/mesh.py` (:74),
which the hierarchical matcher uses to pad its fine batch's block axis to
a bucket (`ops/hierarchical._pad_block_axis`).  The reference's mesh
collectives (`pool_sharded_match`, `pool_sharded_coarse`, the sharded dru
and chunked solves) are ROADMAP Queue A item 9: on one card the batched
single-device solve is the schedule.
"""
from __future__ import annotations

import torch

from cook_tpu_torch.ops.match import MatchProblem


def invalid_match_problem(j: int, n: int, n_res: int = 4,
                          with_feasible: bool = True,
                          dtype=torch.float32, *,
                          device) -> MatchProblem:
    """An all-invalid padded problem: job_valid and node_valid all False,
    so the kernels place nothing on it; `totals` is ones so the binpack
    fitness stays finite on the dead lanes.  `with_feasible=False` for
    batches whose real problems carry no constraint mask."""
    return MatchProblem(
        demands=torch.zeros((j, n_res), dtype=dtype, device=device),
        job_valid=torch.zeros((j,), dtype=torch.bool, device=device),
        avail=torch.zeros((n, n_res), dtype=dtype, device=device),
        totals=torch.ones((n, 2), dtype=dtype, device=device),
        node_valid=torch.zeros((n,), dtype=torch.bool, device=device),
        feasible=(torch.zeros((j, n), dtype=torch.bool, device=device)
                  if with_feasible else None),
    )
