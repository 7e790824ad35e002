"""One hierarchical coarse pass in one launch: every chunk, every candidate
pass (`best_block`'s scoring) and every single-candidate conflict round.

Port of the reference's `_coarse_pallas` (`cook_tpu/ops/hierarchical.py`
:233), a `lax.scan` over chunks around the Pallas `best_block` kernel
(`cook_tpu/ops/pallas_match.py` :218) and `conflict_round`.  On a CUDA
tensor `coarse_pass` launches the hand-written Hopper kernel in
`csrc/coarse_pass.cu`; on a CPU tensor it runs `coarse_pass_reference`,
the same loop on `best_block_reference` and `conflict_round`, which is
also what the kernel is held against on the card.  Nothing falls back: a
CUDA call that cannot launch raises.

The kernel sums each block's contending demand in its own order (per
warp, then across warps and CTAs); where demands and capacities are
exact in float32 (the simulator's MB in multiples of 512, cpus in
halves) every order gives the same sums, and the kernel's results are
identical to the plain version's.

The kernel keeps each CTA's [B, R] block state in shared memory while it
fits the card's 227 KB (`smem_bytes`); past that the same kernel pages it
to a device-memory workspace the wrapper allocates (`workspace_floats`),
so any block count runs on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

from cook_tpu_torch.ops.best_block import best_block_reference
from cook_tpu_torch.ops.best_node import MAX_R, check_inputs, kernel_floats
from cook_tpu_torch.ops.common import BIG
from cook_tpu_torch.ops.match import conflict_round

# kernel launches since the last reset (see ops/best_node.launches)
launches = 0
# csrc/coarse_pass.cu's launch shape (COARSE_PASS_CLUSTER CTAs of
# COARSE_PASS_THREADS threads), mirrored for smem_bytes and
# workspace_floats; chip_smoke.py holds both to the kernel's own counts
_CLUSTER = 8
_THREADS = 512
# the shared memory one CTA may take on an H100 (the 227 KB opt-in)
SMEM_LIMIT = 227 * 1024


def _words(b: int, r: int, chunk: int) -> tuple[int, int]:
    """(block state, small region) words of a CTA (coarse_pass.cu
    `layout`): 9 [B, R] arrays (availability, block table, carry and base,
    the cluster exchange and accepted demand, two each), the warps' [W, B,
    R] partials and 3 [B, 2] pairs; then one flag a warp, 4 accept flags
    and one state word a slot."""
    warps = _THREADS // 32
    slots = -(-chunk // (_CLUSTER * _THREADS)) * _THREADS
    return (9 + warps) * b * r + 6 * b, warps + 4 + slots


def paged(b: int, r: int, chunk: int) -> bool:
    """Whether the kernel keeps the block state for (B, R, chunk) in a
    device-memory workspace: it does not fit in shared memory with the
    rest (past 279 blocks at R 8, 543 at R 4, 1028 at R 2, chunk 4096)."""
    return 4 * sum(_words(b, r, chunk)) > SMEM_LIMIT


def smem_bytes(b: int, r: int, chunk: int) -> int:
    """The shared memory a CTA of the kernel takes for B blocks, R
    resources and `chunk`: the whole layout, or, paged, the small region
    alone."""
    block, small = _words(b, r, chunk)
    return 4 * (small if paged(b, r, chunk) else block + small)


def workspace_floats(b: int, r: int, chunk: int) -> int:
    """The float32 workspace the kernel pages its block state to: one
    stretch of block state a CTA, 0 when it fits in shared memory."""
    return _CLUSTER * _words(b, r, chunk)[0] if paged(b, r, chunk) else 0


def check_fits(b: int, r: int, chunk: int) -> None:
    """Raises ValueError for shapes the kernel cannot take at all: R
    outside 2..8, or a chunk whose job slots alone are over the card's
    shared memory.  Any block count runs (`paged`)."""
    if not 2 <= r <= MAX_R:
        raise ValueError(f"coarse_pass takes 2..{MAX_R} resource columns, "
                         f"got {r}")
    need = smem_bytes(b, r, chunk)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"coarse_pass keeps a CTA's {chunk}-job chunk slots in shared "
            f"memory: {need} bytes, over the card's {SMEM_LIMIT}; take a "
            f"smaller coarse_chunk")


def coarse_pass_reference(demands, active, block_avail, block_max,
                          block_totals, block_valid, chunk: int,
                          passes: int, rounds: int, *,
                          scored: Optional[list] = None):
    """Plain PyTorch version: per chunk of `chunk` jobs and per pass, each
    active unplaced job's best block (`best_block_reference` with placed
    and inactive rows marked 2*BIG), then `rounds` single-candidate
    conflict rounds against the carried availability.  Returns
    (assignment [J] int32, -1 where unrouted; the final availability
    [B, R]).  With `scored`, the number of live jobs each candidate pass
    scores is appended to it (the work the data asks for)."""
    j = demands.shape[0]
    b = block_avail.shape[0]
    avail = block_avail
    out = []
    for c0 in range(0, j, chunk):
        d = demands[c0:c0 + chunk]
        ok = active[c0:c0 + chunk]
        assignment = torch.full((d.shape[0],), -1, dtype=torch.int32,
                                device=d.device)
        for _ in range(passes):
            d_eff = torch.where((ok & (assignment < 0))[:, None], d, 2 * BIG)
            if scored is not None:
                scored.append(int((d_eff[:, 0] < BIG).sum()))
            val, idx = best_block_reference(d_eff, avail, block_max,
                                            block_totals, block_valid)
            cand_val, cand_idx = val[:, None], idx.clamp_min(0)[:, None]
            for _ in range(rounds):
                avail, assignment = conflict_round(avail, assignment,
                                                   cand_val, cand_idx, d, b)
        out.append(assignment)
    return torch.cat(out), avail


def _check(demands, active, block_avail, block_max, block_totals,
           block_valid, chunk, passes, rounds):
    j, r = demands.shape
    b = block_avail.shape[0]
    if active.shape != (j,) or block_avail.shape != (b, r) \
            or block_max.shape != (b, r) or block_totals.shape != (b, 2) \
            or block_valid.shape != (b,):
        raise ValueError(
            f"coarse_pass shapes: demands {tuple(demands.shape)}, active "
            f"{tuple(active.shape)}, block_avail {tuple(block_avail.shape)}, "
            f"block_max {tuple(block_max.shape)}, block_totals "
            f"{tuple(block_totals.shape)}, block_valid "
            f"{tuple(block_valid.shape)}")
    if chunk < 1 or j % chunk or passes < 0 or rounds < 0:
        raise ValueError(f"coarse_pass takes a chunk (>= 1) dividing the "
                         f"{j} jobs and passes, rounds >= 0; got chunk "
                         f"{chunk}, passes {passes}, rounds {rounds}")
    check_inputs("coarse_pass", (demands, block_avail, block_max,
                                 block_totals), (active, block_valid))


def _launch(demands, active, block_avail, block_max, block_totals,
            block_valid, chunk, passes, rounds):
    global launches
    from cook_tpu_torch import build

    launch = build.launcher("coarse_pass", 9, 6)
    j, r = demands.shape
    b = block_avail.shape[0]
    with torch.cuda.device(demands.device):
        assignment = torch.empty(j, dtype=torch.int32, device=demands.device)
        avail = torch.empty_like(block_avail)
        # past shared memory the block state pages to this workspace
        floats = workspace_floats(b, r, chunk)
        workspace = (torch.empty(floats, dtype=torch.float32,
                                 device=demands.device) if floats else None)
        launch(demands.data_ptr(), active.data_ptr(), block_avail.data_ptr(),
               block_max.data_ptr(), block_totals.data_ptr(),
               block_valid.data_ptr(), assignment.data_ptr(),
               avail.data_ptr(),
               None if workspace is None else workspace.data_ptr(),
               j, b, r, chunk, passes, rounds,
               torch.cuda.current_stream(demands.device).cuda_stream)
    launches += 1
    return assignment, avail


def coarse_pass(demands: torch.Tensor, active: torch.Tensor,
                block_avail: torch.Tensor, block_max: torch.Tensor,
                block_totals: torch.Tensor, block_valid: torch.Tensor,
                chunk: int, passes: int, rounds: int):
    """The coarse jobs x blocks assignment: (assignment [J] int32, the
    block index or -1 where unrouted; the final availability [B, R]).

    demands [J, R] float32 (non-negative, 2 <= R <= 8) and active [J]
    bool; block_avail (the starting summed free capacity) and block_max
    (the per-resource max single node, fixed for the pass) [B, R],
    block_totals [B, 2] float32, block_valid [B] bool; all contiguous and
    on one device (bfloat16 cost tensors are cast to float32 here).
    `chunk` divides J; the availability carries across passes and chunks.
    On the card any B runs: past the shared memory the kernel pages its
    block state to device memory (`paged`)."""
    demands, block_avail, block_max, block_totals = kernel_floats(
        demands, block_avail, block_max, block_totals)
    _check(demands, active, block_avail, block_max, block_totals,
           block_valid, chunk, passes, rounds)
    if demands.device.type == "cuda":
        check_fits(block_avail.shape[0], demands.shape[1], chunk)
        return _launch(demands, active, block_avail, block_max,
                       block_totals, block_valid, chunk, passes, rounds)
    return coarse_pass_reference(demands, active, block_avail, block_max,
                                 block_totals, block_valid, chunk, passes,
                                 rounds)
