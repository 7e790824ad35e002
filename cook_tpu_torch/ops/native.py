"""ctypes bindings for the C++ host-side solvers (native/cook_native.cc).

Port of `cook_tpu/ops/native.py`.  The library is built at first use
(`build.load_native`: `g++` with `native/Makefile`'s flags into
`_build/libcook_native.so`).  Its solvers make the same decisions as the
numpy oracles of `ops/cpu_reference.py` at native speed: the CPU baseline
that device times are set against.  `available()` says whether the
library builds and loads, for a caller that falls back to the numpy
implementations; the solvers themselves raise, with the compiler's
output, when it does not.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np

from cook_tpu_torch import build

_lib: Optional[ctypes.CDLL] = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = build.load_native()
    d = ctypes.POINTER(ctypes.c_double)
    i64 = ctypes.POINTER(ctypes.c_int64)
    i32 = ctypes.POINTER(ctypes.c_int32)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.greedy_match.argtypes = [d, ctypes.c_int64, d, d, ctypes.c_int64,
                                 u8, i64]
    lib.greedy_match.restype = None
    lib.dru_rank.argtypes = [i32, d, d, d, d, ctypes.c_int64, d, d, d,
                             ctypes.c_int64, ctypes.c_int32, d, i64]
    lib.dru_rank.restype = None
    lib.find_preemption.argtypes = [i32, d, d, u8, ctypes.c_int64, d, u8,
                                    ctypes.c_int64, d, ctypes.c_double,
                                    ctypes.c_double, ctypes.c_double,
                                    i64, i64]
    lib.find_preemption.restype = ctypes.c_int64
    _lib = lib
    return _lib


def available() -> bool:
    try:
        _load()
    except (OSError, RuntimeError):
        return False
    return True


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def greedy_match(demands: np.ndarray, avail: np.ndarray, totals: np.ndarray,
                 feasible: Optional[np.ndarray] = None) -> np.ndarray:
    """Sequential greedy placement (`cpu_reference.ref_greedy_match`):
    demands [J, 3], avail [N, 3], totals [N, 2], an optional [J, N]
    feasibility mask; returns [J] int64 node indices, -1 unplaced."""
    lib = _load()
    j, n = len(demands), len(avail)
    demands = np.ascontiguousarray(demands, dtype=np.float64)
    avail = np.ascontiguousarray(avail, dtype=np.float64)
    totals = np.ascontiguousarray(totals, dtype=np.float64)
    out = np.empty(j, dtype=np.int64)
    feas_ptr = None
    if feasible is not None:
        feasible = np.ascontiguousarray(feasible, dtype=np.uint8)
        feas_ptr = _ptr(feasible, ctypes.c_uint8)
    lib.greedy_match(
        _ptr(demands, ctypes.c_double), j,
        _ptr(avail, ctypes.c_double),
        _ptr(totals, ctypes.c_double), n,
        feas_ptr, _ptr(out, ctypes.c_int64),
    )
    return out


def dru_rank(user: np.ndarray, mem: np.ndarray, cpus: np.ndarray,
             gpus: np.ndarray, order_key: np.ndarray,
             mem_div: np.ndarray, cpu_div: np.ndarray, gpu_div: np.ndarray,
             gpu_mode: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative DRU per task and the global fair-share order
    (`cpu_reference.ref_dru_order`): (dru [T] float64, order [T] int64)."""
    lib = _load()
    t, u = len(user), len(mem_div)
    user = np.ascontiguousarray(user, dtype=np.int32)
    arrays = [np.ascontiguousarray(a, dtype=np.float64)
              for a in (mem, cpus, gpus, order_key, mem_div, cpu_div,
                        gpu_div)]
    out_dru = np.empty(t, dtype=np.float64)
    out_order = np.empty(t, dtype=np.int64)
    lib.dru_rank(
        _ptr(user, ctypes.c_int32),
        *[_ptr(a, ctypes.c_double) for a in arrays[:4]],
        t,
        *[_ptr(a, ctypes.c_double) for a in arrays[4:]],
        u, int(gpu_mode),
        _ptr(out_dru, ctypes.c_double), _ptr(out_order, ctypes.c_int64),
    )
    return out_dru, out_order


def find_preemption(task_host, task_dru, task_res, eligible, spare, host_ok,
                    demand, pending_dru, safe_dru_threshold, min_dru_diff):
    """The victim search (`cpu_reference.ref_preemption_decision`):
    (host, [task indices]) or None."""
    lib = _load()
    t, h = len(task_host), len(spare)
    task_host = np.ascontiguousarray(task_host, dtype=np.int32)
    task_dru = np.ascontiguousarray(task_dru, dtype=np.float64)
    task_res = np.ascontiguousarray(task_res, dtype=np.float64)
    eligible = np.ascontiguousarray(eligible, dtype=np.uint8)
    spare = np.ascontiguousarray(spare, dtype=np.float64)
    host_ok = np.ascontiguousarray(host_ok, dtype=np.uint8)
    demand = np.ascontiguousarray(demand, dtype=np.float64)
    out_tasks = np.empty(t, dtype=np.int64)
    out_n = np.zeros(1, dtype=np.int64)
    host = lib.find_preemption(
        _ptr(task_host, ctypes.c_int32), _ptr(task_dru, ctypes.c_double),
        _ptr(task_res, ctypes.c_double), _ptr(eligible, ctypes.c_uint8), t,
        _ptr(spare, ctypes.c_double), _ptr(host_ok, ctypes.c_uint8), h,
        _ptr(demand, ctypes.c_double), float(pending_dru),
        float(safe_dru_threshold), float(min_dru_diff),
        _ptr(out_tasks, ctypes.c_int64), _ptr(out_n, ctypes.c_int64),
    )
    if host < 0:
        return None
    return int(host), out_tasks[: out_n[0]].tolist()
