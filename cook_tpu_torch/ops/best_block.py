"""Fused block-aggregate fit + max-node gate + fitness + argmax: each job's
best topology block, the hierarchical matcher's coarse-pass scorer.

Port of `best_block` in `cook_tpu/ops/pallas_match.py` (:218).  On a CUDA
tensor `best_block` launches the hand-written Hopper kernel in
`csrc/best_block.cu`; on a CPU tensor it runs `best_block_reference`, the
plain PyTorch version of the same function, which is also what the kernel
is held against on the card.  Nothing falls back: a CUDA call that cannot
launch raises.
"""
from __future__ import annotations

import torch

from cook_tpu_torch.ops.best_node import (
    check_inputs,
    fits,
    kernel_floats,
    score_argmax,
)

# kernel launches since the last reset (see ops/best_node.launches)
launches = 0


def best_block_reference(demands: torch.Tensor, block_avail: torch.Tensor,
                         block_max: torch.Tensor, block_totals: torch.Tensor,
                         block_valid: torch.Tensor):
    """Plain PyTorch version: the full [K, B] score and a first-index
    argmax.  A job may route to block b only if the block's summed
    availability AND its per-resource max single node both hold the
    demand, and the block is valid."""
    ok = (fits(block_avail, demands) & fits(block_max, demands)
          & block_valid[None, :])
    return score_argmax(demands, block_avail, block_totals, ok)


def _check(demands, block_avail, block_max, block_totals, block_valid):
    _, r = demands.shape
    b = block_avail.shape[0]
    if block_avail.shape != (b, r) or block_max.shape != (b, r) \
            or block_totals.shape != (b, 2) or block_valid.shape != (b,):
        raise ValueError(
            f"best_block shapes: demands {tuple(demands.shape)}, "
            f"block_avail {tuple(block_avail.shape)}, block_max "
            f"{tuple(block_max.shape)}, block_totals "
            f"{tuple(block_totals.shape)}, block_valid "
            f"{tuple(block_valid.shape)}")
    check_inputs("best_block", (demands, block_avail, block_max,
                                block_totals), (block_valid,))


def _launch(demands, block_avail, block_max, block_totals, block_valid):
    global launches
    from cook_tpu_torch import build

    launch = build.launcher("best_block", 7, 3)
    k, r = demands.shape
    b = block_avail.shape[0]
    with torch.cuda.device(demands.device):
        val = torch.empty(k, dtype=torch.float32, device=demands.device)
        idx = torch.empty(k, dtype=torch.int32, device=demands.device)
        launch(demands.data_ptr(), block_avail.data_ptr(),
               block_max.data_ptr(), block_totals.data_ptr(),
               block_valid.data_ptr(), val.data_ptr(), idx.data_ptr(),
               k, b, r, torch.cuda.current_stream(demands.device).cuda_stream)
    launches += 1
    return val, idx


def best_block(demands: torch.Tensor, block_avail: torch.Tensor,
               block_max: torch.Tensor, block_totals: torch.Tensor,
               block_valid: torch.Tensor):
    """Per-job best feasible block: (best_score [K] f32, best_idx [K]
    int32); best_idx is -1 (and score -BIG) when no block is feasible.

    demands [K, R]; block_avail (summed free capacity) and block_max (max
    single-node free capacity) [B, R]; block_totals (summed capacity, the
    fitness denominators) [B, 2] float32 (bfloat16 is cast to float32
    here); block_valid [B] bool; all contiguous and on one device
    (2 <= R <= 8)."""
    demands, block_avail, block_max, block_totals = kernel_floats(
        demands, block_avail, block_max, block_totals)
    _check(demands, block_avail, block_max, block_totals, block_valid)
    if demands.device.type == "cuda":
        return _launch(demands, block_avail, block_max, block_totals,
                       block_valid)
    return best_block_reference(demands, block_avail, block_max,
                                block_totals, block_valid)
