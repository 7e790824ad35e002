"""Fused feasibility + binpacking fitness + argmax: each job's best node.

Port of `best_node` in `cook_tpu/ops/pallas_match.py` (:135).  On a CUDA
tensor `best_node` launches the hand-written Hopper kernel in
`csrc/best_node.cu`; on a CPU tensor it runs `best_node_reference`, the
plain PyTorch version of the same function, which is also what the kernel
is held against on the card.  Nothing falls back: a CUDA call that cannot
launch raises.

`fits`, `score_argmax`, `kernel_floats` and `check_inputs` are shared
with the other kernels' modules (`ops/best_block.py`,
`ops/best_node_batched.py`, `ops/coarse_pass.py`), as the kernels share
`csrc/score_tile.cuh`.  Every wrapper takes bfloat16 cost tensors (the
quantized match state, `MatchConfig.quantized`) and casts them to
float32 at its boundary, as the reference casts its inputs before every
Pallas call (`cook_tpu/ops/pallas_match.py:177-178`); the kernels
themselves read float32.
"""
from __future__ import annotations

from typing import Optional

import torch

from cook_tpu_torch.ops.common import BIG

MAX_R = 8

# kernel launches since the last reset; the main path's proof that it ran
# through the kernel (a launch made to compare the kernel with its plain
# version counts here too, so callers reset it before the run they read)
launches = 0


def fits(avail: torch.Tensor, demands: torch.Tensor) -> torch.Tensor:
    """[..., K, N] bool: every resource column of demand k fits node n
    (avail [..., N, R], demands [..., K, R])."""
    return (avail[..., None, :, :] >= demands[..., :, None, :]).all(-1)


def score_argmax(demands: torch.Tensor, avail: torch.Tensor,
                 totals: torch.Tensor, ok: torch.Tensor):
    """The plain versions' shared scoring (the rules of
    csrc/score_tile.cuh): the cpuMemBinPacker fitness of every (job, node)
    pair, -BIG where `ok` [..., K, N] is False or the job's row is not
    live, and a first-index argmax over the node axis (`torch.argmax`
    returns the first maximal index).  A row is live while its first
    demand is under BIG: the matchers mark placed and empty rows with a
    2*BIG demand, which no capacity holds.  Returns (best_score [..., K]
    f32, best_idx [..., K] int32), (-BIG, -1) where nothing is feasible."""
    denom = totals.clamp_min(1e-30)
    used = totals - avail[..., :2]
    fit = ((used[..., None, :, 0] + demands[..., :, 0:1])
           / denom[..., None, :, 0]
           + (used[..., None, :, 1] + demands[..., :, 1:2])
           / denom[..., None, :, 1]) * 0.5
    ok = ok & (demands[..., :, 0:1] < BIG)
    score = torch.where(ok, fit, torch.full_like(fit, -BIG))
    idx = torch.argmax(score, dim=-1)
    val = score.gather(-1, idx[..., None])[..., 0]
    found = val > -BIG
    return val, torch.where(found, idx, -1).to(torch.int32)


def kernel_floats(*tensors):
    """The cost tensors as the kernels read them: bfloat16 ones cast to
    float32 (the reference's boundary cast), every other dtype as given
    (`check_inputs` then refuses anything but float32)."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t
                 for t in tensors)


def check_inputs(kernel: str, floats, bools) -> None:
    """The wrappers' shared checks: every tensor on one device, `floats`
    float32 and `bools` bool (None entries skipped), all contiguous, and
    2..MAX_R resource columns in the first float tensor."""
    bools = [t for t in bools if t is not None]
    tensors = [*floats, *bools]
    r = floats[0].shape[-1]
    if not 2 <= r <= MAX_R:
        raise ValueError(f"{kernel} takes 2..{MAX_R} resource columns, "
                         f"got {r}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{kernel} inputs lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes float32 demands/capacities, "
                            f"got {t.dtype}")
    for t in bools:
        if t.dtype != torch.bool:
            raise TypeError(f"{kernel} takes bool validity/mask, "
                            f"got {t.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{kernel} inputs must be contiguous")


def best_node_reference(demands: torch.Tensor, avail: torch.Tensor,
                        totals: torch.Tensor, node_valid: torch.Tensor,
                        feasible: Optional[torch.Tensor] = None):
    """Plain PyTorch version: the full [K, N] score and a first-index
    argmax.  Returns (best_score [K] f32, best_idx [K] int32), (-BIG, -1)
    where nothing is feasible."""
    ok = fits(avail, demands) & node_valid[None, :]
    if feasible is not None:
        ok = ok & feasible
    return score_argmax(demands, avail, totals, ok)


def _check(demands, avail, totals, node_valid, feasible):
    k, r = demands.shape
    n = avail.shape[0]
    if avail.shape != (n, r) or totals.shape != (n, 2) \
            or node_valid.shape != (n,):
        raise ValueError(
            f"best_node shapes: demands {tuple(demands.shape)}, avail "
            f"{tuple(avail.shape)}, totals {tuple(totals.shape)}, "
            f"node_valid {tuple(node_valid.shape)}")
    if feasible is not None and feasible.shape != (k, n):
        raise ValueError(f"best_node mask {tuple(feasible.shape)} != {(k, n)}")
    check_inputs("best_node", (demands, avail, totals),
                 (node_valid, feasible))


def _launch(demands, avail, totals, node_valid, feasible):
    global launches
    from cook_tpu_torch import build

    launch = build.launcher("best_node", 8, 3)
    k, r = demands.shape
    n = avail.shape[0]
    with torch.cuda.device(demands.device):
        val = torch.empty(k, dtype=torch.float32, device=demands.device)
        idx = torch.empty(k, dtype=torch.int32, device=demands.device)
        # scratch for the node tiles' packed keys (csrc/node_tile.cuh),
        # zeroed by the launch itself when it splits the node axis
        keys = torch.empty(2 * k, dtype=torch.int64, device=demands.device)
        launch(demands.data_ptr(), avail.data_ptr(), totals.data_ptr(),
               node_valid.data_ptr(),
               feasible.data_ptr() if feasible is not None else None,
               val.data_ptr(), idx.data_ptr(), keys.data_ptr(), k, n, r,
               torch.cuda.current_stream(demands.device).cuda_stream)
    launches += 1
    return val, idx


def best_node(demands: torch.Tensor, avail: torch.Tensor,
              totals: torch.Tensor, node_valid: torch.Tensor,
              feasible: Optional[torch.Tensor] = None):
    """Per-job best feasible node: (best_score [K] f32, best_idx [K] int32);
    best_idx is -1 (and score -BIG) when no node is feasible.

    demands [K, R], avail [N, R], totals [N, 2] float32 (bfloat16 is
    cast to float32 here); node_valid [N] and the optional constraint
    mask feasible [K, N] bool; all contiguous and on one device.  All R
    columns must fit (2 <= R <= 8)."""
    demands, avail, totals = kernel_floats(demands, avail, totals)
    _check(demands, avail, totals, node_valid, feasible)
    if demands.device.type == "cuda":
        return _launch(demands, avail, totals, node_valid, feasible)
    return best_node_reference(demands, avail, totals, node_valid, feasible)
