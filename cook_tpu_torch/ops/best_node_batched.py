"""`best_node` over a batch of per-block problems: the hierarchical
matcher's fused fine-pass scorer.

Port of `best_node_batched` in `cook_tpu/ops/pallas_match.py` (:316).  On
a CUDA tensor `best_node_batched` launches the hand-written Hopper kernel
in `csrc/best_node_batched.cu`; on a CPU tensor it runs
`best_node_batched_reference`, the plain PyTorch version of the same
function, which is also what the kernel is held against on the card.
Nothing falls back: a CUDA call that cannot launch raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from cook_tpu_torch.ops.best_node import (
    check_inputs,
    fits,
    kernel_floats,
    score_argmax,
)

# kernel launches since the last reset (see ops/best_node.launches)
launches = 0


def best_node_batched_reference(demands: torch.Tensor, avail: torch.Tensor,
                                totals: torch.Tensor,
                                node_valid: torch.Tensor,
                                feasible: Optional[torch.Tensor] = None):
    """Plain PyTorch version: the full [B, S, N] score and a first-index
    argmax per (block, slot); indices are block-local."""
    ok = fits(avail, demands) & node_valid[:, None, :]
    if feasible is not None:
        ok = ok & feasible
    return score_argmax(demands, avail, totals, ok)


def _check(demands, avail, totals, node_valid, feasible):
    b, s, r = demands.shape
    n = avail.shape[1]
    if avail.shape != (b, n, r) or totals.shape != (b, n, 2) \
            or node_valid.shape != (b, n):
        raise ValueError(
            f"best_node_batched shapes: demands {tuple(demands.shape)}, "
            f"avail {tuple(avail.shape)}, totals {tuple(totals.shape)}, "
            f"node_valid {tuple(node_valid.shape)}")
    if feasible is not None and feasible.shape != (b, s, n):
        raise ValueError(f"best_node_batched mask "
                         f"{tuple(feasible.shape)} != {(b, s, n)}")
    check_inputs("best_node_batched", (demands, avail, totals),
                 (node_valid, feasible))


def _launch(demands, avail, totals, node_valid, feasible):
    global launches
    from cook_tpu_torch import build

    launch = build.launcher("best_node_batched", 8, 4)
    b, s, r = demands.shape
    n = avail.shape[1]
    with torch.cuda.device(demands.device):
        val = torch.empty((b, s), dtype=torch.float32, device=demands.device)
        idx = torch.empty((b, s), dtype=torch.int32, device=demands.device)
        # packed-key scratch, used only when a block's nodes span several
        # node tiles (see ops/best_node._launch)
        keys = torch.empty(2 * b * s, dtype=torch.int64,
                           device=demands.device)
        launch(demands.data_ptr(), avail.data_ptr(), totals.data_ptr(),
               node_valid.data_ptr(),
               feasible.data_ptr() if feasible is not None else None,
               val.data_ptr(), idx.data_ptr(), keys.data_ptr(), b, s, n, r,
               torch.cuda.current_stream(demands.device).cuda_stream)
    launches += 1
    return val, idx


def best_node_batched(demands: torch.Tensor, avail: torch.Tensor,
                      totals: torch.Tensor, node_valid: torch.Tensor,
                      feasible: Optional[torch.Tensor] = None):
    """Per-(block, slot) best feasible node of that block: (best_score
    [B, S] f32, best_idx [B, S] int32, block-local); best_idx is -1 (and
    score -BIG) when no node of the block is feasible.

    demands [B, S, R], avail [B, N, R], totals [B, N, 2] float32
    (bfloat16 is cast to float32 here); node_valid [B, N] and the
    optional constraint mask feasible [B, S, N] bool; all contiguous and
    on one device (2 <= R <= 8, B <= 65535)."""
    demands, avail, totals = kernel_floats(demands, avail, totals)
    _check(demands, avail, totals, node_valid, feasible)
    if demands.device.type == "cuda":
        return _launch(demands, avail, totals, node_valid, feasible)
    return best_node_batched_reference(demands, avail, totals, node_valid,
                                       feasible)
