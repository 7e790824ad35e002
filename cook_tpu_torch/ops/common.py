"""Shared kernel utilities: padding/bucketing and multi-key sorting helpers.

Port of `cook_tpu/ops/common.py`.  The padded power-of-two buckets stay:
they keep the problem shapes the reference solves, so the two packages
see identical tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cook_tpu_torch.obs import data_plane

# A value larger than any real DRU/score; used instead of +inf so arithmetic
# on padded lanes stays finite.
BIG = 1e30


def fetch_result(tree):
    """Materialize a device result (a tensor, or a tuple/list of them) as
    host numpy.

    This is THE definition of "the solve finished": PyTorch returns before
    the card does, and the device-to-host copy is what waits for it.  Every
    timed solve ends in this call so a timing means the same thing
    everywhere.  Being THE completion observation also makes it THE D2H
    accounting site: the result's logical bytes land in the data-plane
    ledger (obs/data_plane.py) under the ambient tensor family.  A
    bfloat16 tensor (a quantized cost tensor) crosses as its 2 bytes an
    element and comes back as float32 numpy, which holds its values
    exactly (numpy has no bfloat16)."""
    data_plane.note_d2h(_nbytes(tree))
    return _to_host(tree)


def _to_host(tree):
    if isinstance(tree, torch.Tensor):
        if tree.dtype == torch.bfloat16:
            tree = tree.float()
        return tree.cpu().numpy()
    items = [_to_host(t) for t in tree]
    # a NamedTuple takes its fields positionally, a list/tuple an iterable
    return type(tree)(*items) if hasattr(tree, "_fields") \
        else type(tree)(items)


def _nbytes(tree) -> int:
    if isinstance(tree, (np.ndarray, torch.Tensor)):
        return int(tree.nbytes)
    return sum(_nbytes(t) for t in tree)


def host_cast(arr: np.ndarray, dtype: torch.dtype):
    """float32 rows as the host array that crosses the bus in `dtype`: the
    numpy array itself for float32, a CPU tensor for bfloat16 (the
    quantized cost tensors; numpy has no bfloat16), so that the put
    counts the dtype's bytes and the card receives the rounded values.
    The rounding is round-to-nearest-even, as numpy's (ml_dtypes)
    `astype(bfloat16)` in the reference."""
    if dtype == torch.float32:
        return np.ascontiguousarray(arr, dtype=np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)) \
        .to(dtype)


class PendingResult:
    """Handle to a dispatched device computation (one tensor or a tuple
    of them); `fetch()` is the one completion observation (same semantics
    as `fetch_result`)."""

    __slots__ = ("_tree", "_host", "_done")

    def __init__(self, tree):
        self._tree = tree
        self._host = None
        self._done = None

    def copy_to_host_async(self, stream) -> None:
        """Queue the device-to-host copy now, on CUDA `stream`, into pinned
        host memory behind a recorded event (the pipelined pass: the copy
        follows the solve on the stage's stream, and `fetch()` then waits
        for the event alone).  A no-op for a result on the CPU."""
        if not isinstance(self._tree, torch.Tensor) or \
                self._tree.device.type != "cuda":
            return
        host = torch.empty(self._tree.shape, dtype=self._tree.dtype,
                           pin_memory=True)
        host.copy_(self._tree, non_blocking=True)
        self._done = torch.cuda.Event()
        self._done.record(stream)
        self._host = host

    def fetch(self):
        """Block until the device result is materialized host-side."""
        if self._done is None:
            return fetch_result(self._tree)
        self._done.synchronize()
        out = self._host.numpy()
        data_plane.note_d2h(int(out.nbytes))
        return out


def dispatch(fn, *args, **kwargs) -> PendingResult:
    """Run a kernel entry point and wrap its (still in-flight) device
    output without observing completion."""
    return PendingResult(fn(*args, **kwargs))


def binpack_fitness(used0, used1, d0, d1, denom0, denom1):
    """cpuMemBinPacker fitness (Fenzo's default, config.clj:108): mean
    post-placement utilization across mem and cpus.  Plain arithmetic so
    the ONE definition serves the torch kernels' plain versions and the
    numpy host-side top-up — callers broadcast shapes."""
    return ((used0 + d0) / denom0 + (used1 + d1) / denom1) * 0.5


def bucket_size(n: int, minimum: int = 64) -> int:
    """Round n up to the next power-of-two bucket (>= minimum)."""
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))


def pad_to(arr: np.ndarray, size: int, fill=0) -> np.ndarray:
    """Pad axis 0 of arr to `size` with `fill`."""
    n = arr.shape[0]
    if n == size:
        return arr
    if n > size:
        raise ValueError(f"cannot pad {n} down to {size}")
    pad_width = [(0, size - n)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=fill)


def lexsort_perm(*keys: torch.Tensor) -> torch.Tensor:
    """Permutation (int64) sorting rows ascending by keys, keys[0] MOST
    significant.  The reference runs one fused multi-key `lax.sort`; here
    it is chained stable sorts, least-significant key first, which gives
    the same permutation."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def segment_starts(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Boolean mask of positions where a new segment begins in a sorted id
    vector."""
    prev = torch.cat([sorted_ids[:1] - 1, sorted_ids[:-1]])
    return sorted_ids != prev


def segment_first(starts: torch.Tensor) -> torch.Tensor:
    """Index of each row's segment start (0 before the first start): the
    running max of the start indices (`lax.cummax` in the reference),
    found as each row's segment number (a count of the starts so far)
    looking up where that segment starts.  CUDA runs a 1-D `cummax` as
    one block stepping along the row, but a 1-D count as a device-wide
    scan."""
    n = starts.shape[0]
    idx = torch.arange(n, device=starts.device)
    seg = torch.cumsum(starts, dim=0) - 1
    # each segment's start row writes its index; every other row writes
    # into the spare last slot, which is never read
    first = torch.zeros(n + 1, dtype=idx.dtype, device=starts.device)
    first.scatter_(0, torch.where(starts, seg, n), idx)
    return torch.where(seg >= 0, first[seg.clamp_min(0)], 0)


def segmented_cumsum(values: torch.Tensor,
                     sorted_ids: torch.Tensor) -> torch.Tensor:
    """Cumulative sum of `values` restarting at each new id in `sorted_ids`
    (which must be sorted): plain cumsum minus the running total at each
    segment start.  A [T, R] input is scanned column by column: CUDA
    runs a 1-D cumsum as a device-wide scan, but scans a leading axis with
    one thread per column stepping through all T rows (a rebalance
    decision at T 131072 x R 4 took 13.26 ms that way on an NVIDIA H100
    80GB HBM3, 700.00 W, in chip_smoke.py's rebalance cases).  The CPU
    sums each column in order either way."""
    if values.ndim > 1:
        flat = values.reshape(values.shape[0], -1)
        total = torch.stack([torch.cumsum(flat[:, c].contiguous(), dim=0)
                             for c in range(flat.shape[1])],
                            dim=1).reshape(values.shape)
    else:
        total = torch.cumsum(values, dim=0)
    seg_first = segment_first(segment_starts(sorted_ids))
    base = total.index_select(0, (seg_first - 1).clamp_min(0))
    nonzero = seg_first > 0
    if values.ndim > 1:
        nonzero = nonzero.reshape((-1,) + (1,) * (values.ndim - 1))
    base = torch.where(nonzero, base, torch.zeros_like(base))
    return total - base


def inverse_permutation(perm: torch.Tensor) -> torch.Tensor:
    """inv[perm[i]] = i."""
    n = perm.shape[0]
    inv = torch.empty_like(perm)
    inv[perm.long()] = torch.arange(n, dtype=perm.dtype, device=perm.device)
    return inv
