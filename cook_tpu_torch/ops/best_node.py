"""Fused feasibility + binpacking fitness + argmax: each job's best node.

Port of `best_node` in `cook_tpu/ops/pallas_match.py` (:135).  On a CUDA
tensor `best_node` launches the hand-written Hopper kernel in
`csrc/best_node.cu`; on a CPU tensor it runs `best_node_reference`, the
plain PyTorch version of the same function, which is also what the kernel
is held against on the card.  Nothing falls back: a CUDA call that cannot
launch raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from cook_tpu_torch.ops.common import BIG

MAX_R = 8

# kernel launches since the last reset; the main path's proof that it ran
# through the kernel (a launch made to compare the kernel with its plain
# version counts here too, so callers reset it before the run they read)
launches = 0


def best_node_reference(demands: torch.Tensor, avail: torch.Tensor,
                        totals: torch.Tensor, node_valid: torch.Tensor,
                        feasible: Optional[torch.Tensor] = None):
    """Plain PyTorch version: the full [K, N] score and a first-index
    argmax (`torch.argmax` returns the first maximal index).  Returns
    (best_score [K] f32, best_idx [K] int32), (-BIG, -1) where nothing
    is feasible."""
    fits = (avail[None, :, :] >= demands[:, None, :]).all(-1)
    ok = fits & node_valid[None, :]
    if feasible is not None:
        ok = ok & feasible
    denom = totals.clamp_min(1e-30)
    used = totals - avail[:, :2]
    fit = ((used[None, :, 0] + demands[:, 0:1]) / denom[None, :, 0]
           + (used[None, :, 1] + demands[:, 1:2]) / denom[None, :, 1]) * 0.5
    score = torch.where(ok, fit, torch.full_like(fit, -BIG))
    idx = torch.argmax(score, dim=1)
    val = score.gather(1, idx[:, None])[:, 0]
    found = val > -BIG
    return val, torch.where(found, idx, -1).to(torch.int32)


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
    if not 2 <= r <= MAX_R:
        raise ValueError(f"best_node takes 2..{MAX_R} resource columns, "
                         f"got {r}")
    tensors = [demands, avail, totals, node_valid] + (
        [feasible] if feasible is not None else [])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("best_node inputs lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")
    for t in (demands, avail, totals):
        if t.dtype != torch.float32:
            raise TypeError(f"best_node takes float32 demands/avail/totals, "
                            f"got {t.dtype}")
    for t in tensors[3:]:
        if t.dtype != torch.bool:
            raise TypeError(f"best_node takes bool node_valid/mask, "
                            f"got {t.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("best_node inputs must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The compiled kernel (built at first use), its C signatures set."""
    from cook_tpu_torch import build

    lib = build.load("best_node")
    # every pointer and the stream as c_void_p: a plain int would be cut
    # to 32 bits
    lib.best_node_launch.argtypes = ([ctypes.c_void_p] * 7
                                     + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.best_node_launch.restype = ctypes.c_int
    lib.best_node_error_string.argtypes = [ctypes.c_int]
    lib.best_node_error_string.restype = ctypes.c_char_p
    return lib


def _launch(demands, avail, totals, node_valid, feasible):
    global launches
    lib = _lib()
    k, r = demands.shape
    n = avail.shape[0]
    with torch.cuda.device(demands.device):
        val = torch.empty(k, dtype=torch.float32, device=demands.device)
        idx = torch.empty(k, dtype=torch.int32, device=demands.device)
        stream = torch.cuda.current_stream(demands.device).cuda_stream
        err = lib.best_node_launch(
            demands.data_ptr(), avail.data_ptr(), totals.data_ptr(),
            node_valid.data_ptr(),
            feasible.data_ptr() if feasible is not None else None,
            val.data_ptr(), idx.data_ptr(), k, n, r, stream)
    if err != 0:
        raise RuntimeError("best_node kernel launch failed: "
                           + lib.best_node_error_string(err).decode())
    launches += 1
    return val, idx


def best_node(demands: torch.Tensor, avail: torch.Tensor,
              totals: torch.Tensor, node_valid: torch.Tensor,
              feasible: Optional[torch.Tensor] = None):
    """Per-job best feasible node: (best_score [K] f32, best_idx [K] int32);
    best_idx is -1 (and score -BIG) when no node is feasible.

    demands [K, R], avail [N, R], totals [N, 2] float32; node_valid [N]
    and the optional constraint mask feasible [K, N] bool; all contiguous
    and on one device.  All R columns must fit (2 <= R <= 8)."""
    _check(demands, avail, totals, node_valid, feasible)
    if demands.device.type == "cuda":
        return _launch(demands, avail, totals, node_valid, feasible)
    return best_node_reference(demands, avail, totals, node_valid, feasible)
