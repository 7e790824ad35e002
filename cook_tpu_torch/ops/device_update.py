"""In-place O(delta) row updaters for device-resident match state.

Port of `cook_tpu/ops/device_update.py`.  The device mirror
(scheduler/device_state.py) keeps per-pool encode tensors resident across
match cycles; what changes between cycles is a handful of rows (new jobs,
invalidated feasibility rows).  These updaters turn those deltas into
device scatters:

  * the reference donates the resident buffer to a jitted `.at[].set`;
    torch has no donation, and its counterpart is the in-place
    `index_copy_` into the preallocated buffer: a delta cycle allocates
    and transfers only the delta rows, never the full buffer;
  * the delta row count is padded to a power-of-two bucket
    (`update_bucket`) by REPEATING the last (index, row) pair.  Duplicate
    indices carry identical payloads, so the buffer comes out the same
    whichever duplicate lands last (`index_copy_` fixes no order among
    duplicates on CUDA).  The compile observatory keys the updaters by
    (buffer shape, update bucket), never by the raw delta size, as the
    reference's one XLA program per bucket;
  * `gather_rows` is an `index_select`, which returns a FRESH tensor: the
    mirror's buffers change in place on the next delta cycle, so the
    problem tensors handed to a solver must never alias them.

On CUDA each use of a resident buffer is recorded on the current stream
(`record_stream`): the pipelined pass (scheduler/pipeline.py) builds each
pool on a stream of its own, so a buffer allocated on one stage's stream
is read and written on later stages' streams, and the caching allocator
must not hand its memory out again while those streams still use it.
The order of those uses is the pipeline's: each stage's stream waits for
the driving stream at its start, and the driving stream waits for the
stage's stream at its fetch.

Transfers are accounted through `obs/data_plane.h2d`; callers pass the
tensor family so delta traffic lands in the ledger columns the full
rebuild would.
"""
from __future__ import annotations

import numpy as np
import torch

from cook_tpu_torch.obs import data_plane
from cook_tpu_torch.ops.common import bucket_size

# the smallest update bucket: single-row deltas (the steady-state case)
# share one program with anything up to this many rows
UPDATE_BUCKET_MIN = 8


def update_bucket(k: int) -> int:
    """Padded row count of a k-row delta update."""
    return bucket_size(max(int(k), 1), minimum=UPDATE_BUCKET_MIN)


def pad_update(idx: np.ndarray, rows):
    """Pad a delta to its bucket by repeating the last (index, row) pair
    (idempotent: duplicates carry identical payloads).  `rows` is a numpy
    array or a CPU tensor (bfloat16 rows)."""
    k = idx.shape[0]
    kb = update_bucket(k)
    if kb == k:
        return idx, rows
    idx = np.concatenate([idx, np.full(kb - k, idx[-1], dtype=idx.dtype)])
    if isinstance(rows, torch.Tensor):
        rows = torch.cat([rows, rows[-1:].expand(kb - k, *rows.shape[1:])])
    else:
        rows = np.concatenate([rows, np.repeat(rows[-1:], kb - k, axis=0)])
    return idx, rows


def mark_use(buf: torch.Tensor) -> None:
    """Record a CUDA buffer's use on the current stream (see the module
    docstring); nothing on the CPU."""
    if buf.is_cuda:
        buf.record_stream(torch.cuda.current_stream(buf.device))


def scatter_rows(buf: torch.Tensor, idx: np.ndarray, rows, *,
                 family: str = None, observatory=None,
                 op: str = "device_update") -> torch.Tensor:
    """Write `rows` into the resident `buf` at `idx`, in place, and return
    `buf` (the reference returns the updated donated buffer; callers keep
    the same assignment).  Only the bucket-padded delta crosses the bus.
    `rows` is a numpy array or a CPU tensor of `buf`'s dtype."""
    if not isinstance(rows, torch.Tensor):
        rows = np.ascontiguousarray(rows)
    idx, rows = pad_update(np.asarray(idx, dtype=np.int32), rows)
    idx_dev = data_plane.h2d(idx, family=family, device=buf.device)
    rows_dev = data_plane.h2d(rows, family=family, device=buf.device)
    mark_use(buf)
    buf.index_copy_(0, idx_dev.long(), rows_dev)
    if observatory is not None:
        observatory.observe_solve(
            op, tuple(buf.shape) + (idx.shape[0],), "xla")
    return buf


def gather_rows(buf: torch.Tensor, perm: torch.Tensor, *, observatory=None,
                op: str = "device_gather") -> torch.Tensor:
    """Device-side gather of the resident buffer's rows into schedule
    order.  Returns a FRESH tensor (see the module docstring)."""
    mark_use(buf)
    out = buf.index_select(0, perm)
    if observatory is not None:
        observatory.observe_solve(
            op, tuple(buf.shape) + (int(perm.shape[0]),), "xla")
    return out
