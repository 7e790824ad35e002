"""Compile observatory: first-seen solve accounting per (op, shape, backend).

A copy of `cook_tpu/obs/compile_observatory.py`, with the same keying and
the same storm window, minus the XLA roofline cost cache (the port has no
`cost_analysis`; its kernels' bounds are computed from their code).

What a "compile" is on the port: XLA compiles one program per padded
shape, but the port's hand kernels are built once per process by
`cook_tpu_torch/build.py` (one `nvcc` per source, any shape) and its torch
code compiles nothing.  A first-seen `(op, shape_signature, backend)` key
is still the event worth counting: it is a new padded bucket reaching the
card — new allocator sizes, new launch geometry, and on the card the first
launch that pays the kernel build — and a window full of them is the
padding-bucket churn this module exists to flag.  So the counts and the
storm detector keep the reference's semantics exactly.

The observatory mirrors the jit-cache keying host-side: every device
solve reports `(op, shape_signature, backend)`; a first-seen key counts
once (the process-lifetime set holds every key it ever saw).  Counts are
exported per (op, shape, backend) at `/metrics`, and a sliding window per
op flags a **recompile storm** — `storm_threshold`+ new keys within the
last `window` solves.

Label cardinality: shapes are padded-bucket strings ("131072x16384"), so
the label set is bounded by the bucket lattice, not the workload.
"""
from __future__ import annotations

import collections
import threading
from typing import Iterable, Optional

from cook_tpu_torch.utils.metrics import global_registry


def shape_signature(dims: Iterable) -> str:
    """Canonical shape-signature string for a padded solve, e.g. a
    131072-job x 16384-node match renders "131072x16384"."""
    return "x".join(str(int(d)) for d in dims)


class CompileObservatory:
    """Process-lifetime compile accounting + sliding-window storm flag.

    Thread-safe: match cycles, rank triggers, and the rebalancer all
    report solves, potentially from different threads.
    """

    def __init__(self, window: int = 32, storm_threshold: int = 4,
                 warmup_solves: Optional[int] = None):
        # a storm = >= storm_threshold first-seen (shape, backend) keys
        # within the op's last `window` solves.  The op's first
        # `warmup_solves` solves (default: one full window) never feed
        # the storm trigger: a fresh process compiles every shape once
        # by construction, and paging "recompile-storm" on every deploy/
        # failover would train operators to ignore the real signal.
        # Compile COUNTS still include warmup (the accounting is honest);
        # only the storm edge gets the grace.
        self.window = window
        self.storm_threshold = storm_threshold
        self.warmup_solves = window if warmup_solves is None else \
            warmup_solves
        self._seen: set[tuple[str, str, str]] = set()
        self._recent: dict[str, collections.deque] = {}
        self._solve_totals: dict[str, int] = {}
        self._storming: dict[str, bool] = {}
        self._lock = threading.Lock()
        self._compile_counter = global_registry.counter(
            "obs.compile.count",
            "JIT compilations (first-seen solve keys) per op/shape/backend")
        self._solve_counter = global_registry.counter(
            "obs.solve.count", "device solves observed per op/backend")
        self._storm_counter = global_registry.counter(
            "obs.compile.storms",
            "recompile-storm onsets (window compile count crossed the "
            "threshold) per op")
        self._storm_gauge = global_registry.gauge(
            "obs.compile.storm_active",
            "1 while the op's recent-solve window holds a recompile storm")
        self._programs_gauge = global_registry.gauge(
            "obs.compile.programs",
            "distinct compiled programs (op-wide jit cache size)")

    def observe_solve(self, op: str, shape, backend: str) -> bool:
        """Report one device solve; returns True when this (op, shape,
        backend) key was first seen — i.e. the solve paid a compile."""
        sig = shape if isinstance(shape, str) else shape_signature(shape)
        key = (op, sig, backend)
        with self._lock:
            compiled = key not in self._seen
            if compiled:
                self._seen.add(key)
            total = self._solve_totals.get(op, 0) + 1
            self._solve_totals[op] = total
            recent = self._recent.setdefault(
                op, collections.deque(maxlen=self.window))
            # warmup compiles are expected and excluded from the storm
            # window (they still hit the compile counters below)
            recent.append(compiled and total > self.warmup_solves)
            storming = sum(recent) >= self.storm_threshold
            storm_onset = storming and not self._storming.get(op, False)
            self._storming[op] = storming
            programs = sum(1 for k in self._seen if k[0] == op)
        self._solve_counter.inc(labels={"op": op, "backend": backend})
        if compiled:
            self._compile_counter.inc(
                labels={"op": op, "shape": sig, "backend": backend})
        if storm_onset:
            self._storm_counter.inc(labels={"op": op})
        self._storm_gauge.set(1.0 if storming else 0.0, {"op": op})
        self._programs_gauge.set(programs, {"op": op})
        return compiled

    def storming_ops(self) -> dict[str, dict]:
        """Ops whose recent-solve window currently holds a storm, with
        the window evidence (for the health verdict's detail)."""
        with self._lock:
            out = {}
            for op, storming in self._storming.items():
                if not storming:
                    continue
                recent = self._recent.get(op, ())
                out[op] = {
                    "window": len(recent),
                    "compiles_in_window": sum(recent),
                    "threshold": self.storm_threshold,
                }
            return out

    def stats(self) -> dict:
        """Snapshot for the health verdict: per-op program counts and
        window compile pressure."""
        with self._lock:
            per_op: dict[str, dict] = {}
            for op, recent in self._recent.items():
                per_op[op] = {
                    "programs": sum(1 for k in self._seen if k[0] == op),
                    "solves_in_window": len(recent),
                    "compiles_in_window": sum(recent),
                    "storming": self._storming.get(op, False),
                }
            return per_op
