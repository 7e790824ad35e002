"""The two precisions the reference computes in: float32, which the
configurations state, and bfloat16, the control's precision (the float32
values rounded to the nearest bfloat16, ties to even)."""
from __future__ import annotations

import numpy as np


def f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def bf16(x) -> np.ndarray:
    """float32 values rounded to bfloat16 (kept in float32 storage)."""
    a = np.ascontiguousarray(np.asarray(x, dtype=np.float32))
    u = a.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).reshape(a.shape)


ROUNDING = {"float32": f32, "bfloat16": bf16}
