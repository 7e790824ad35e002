#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port (`cook_tpu_torch`) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

  1. device     — a CUDA card is present; its name and power limit as
                  `nvidia-smi` reports them.
  2. build      — the four kernels compile from cook_tpu_torch/csrc/
                  (`best_node.cu`, `best_block.cu`, `best_node_batched.cu`,
                  `coarse_pass.cu`, sharing `score_tile.cuh`; the first and
                  third also `node_tile.cuh`, the second and fourth
                  `block_score.cuh`) into cook_tpu_torch/_build/, one
                  `nvcc` each, all started together.
  3. kernel     — each kernel on the card against its plain PyTorch
                  version (`*_reference`) on the same inputs: identical
                  indices (assignments) and bit-identical scores (final
                  availability), at the cases listed in KERNEL_CASES,
                  BLOCK_CASES, BATCHED_CASES and COARSE_CASES; CUDA-event
                  times (median of 20) of the kernel with the L2 cache
                  evicted before each run (cold) and without (warm), of the
                  plain version (cold, replayed from a CUDA graph so that
                  its host dispatch stays out), beside the bound.
  3a. device update — the device-residency updaters
                  (`ops/device_update.py`) on the card: padded scatters
                  (repeated last (index, row) pairs, which `index_copy_`
                  lands in any order) into bool, bfloat16 and float32
                  buffers and their gathers, 20 times each, equal to the
                  CPU's; a gather on one CUDA stream ordered before a
                  scatter on another that waits for it.
  4. slice      — the flat path, through the simulator's CLI: a synthetic
                  trace of 100,000 jobs x 10,000 hosts replayed for 3
                  cycles with the chunked matcher on the `best_node`
                  backend, with the launch count reset just before and read
                  just after.  The arguments of every `best_node` call the
                  matcher makes are kept.
  5. launches   — every kept `best_node` launch rerun and held against the
                  plain version; the one with the most live jobs run 5
                  times, bit-identical each time; the kernel line's times
                  are those of that one.
  6. hier slice — the hierarchical path on the same trace: the simulator
                  with `default_match_config(...)` routing every solve to
                  the two-level matcher with both backends `pallas` (each
                  coarse pass one `coarse_pass` launch, fine on
                  `best_node_batched`), 3 cycles, counts reset just before
                  and read just after (`best_block` must count none: its
                  scoring runs inside `coarse_pass`); every kernel call
                  kept, and the solves' coarse / fine / refine walls summed.
  7. hier launches — every kept `coarse_pass` / `best_node_batched` launch
                  rerun and held against its plain version, bit for bit,
                  and the one with the most live rows run 5 times; the
                  standalone `best_block` on the first scoring step of the
                  busiest coarse pass (the call the plain version makes).
  7a. resident slice — device residency (scheduler/device_state.py):
                  the flat slice through `sim.cli run --resident`, its run
                  trace equal to the slice's; per cycle the device_state
                  stats (rebuild, reason, delta rows, resident rows and
                  bytes), H2D bytes by family and encode wall beside the
                  classic slice's, and both submit walls.
  7b. quantized slice — the flat slice with `quantized` (bfloat16 cost
                  tensors) and residency: placements, the packing ratio
                  against the float32 slice, the demoted pools.
  7c. unchanged-pool rig — 16,384 jobs of 60 GB / 30 cpus on 10,000 hosts
                  of 64 GB / 32 cpus, all submitted at t 0 and running past
                  the run, 3 cycles, residency on: cycle 1 rebuilds
                  `cold`, cycles 2-3 report no rebuild and 0 delta rows and
                  move <= 0.1x cycle 1's node-encode + feasibility H2D.
  7d. resident hier slice — the hierarchical slice with residency on: run
                  trace equal to the classic hierarchical run's.
                  Every `best_node`, `coarse_pass` and `best_node_batched`
                  launch of 7a-7d is held against its plain version.
  8. agreement  — small traces replayed on the card and on the CPU, flat
                  and hierarchical, whose run traces must agree.
  9. gang slice — the same 100k x 10k trace with every tenth job a gang
                  member (gangs of 2, 4, 8, 16 in submit order, ~1,335
                  gangs), 3 cycles on the flat route (chunked `best_node`,
                  the one-block rule bound to 1024 hosts) and on the
                  hierarchical one (its coarse pass forced to `xla` by the
                  gangs, fine on `best_node_batched`): after every cycle
                  no gang partly launched, each on distinct hosts of one
                  block, no host over capacity; placements, gangs
                  considered / placed / blocked by reason and the phase
                  walls printed; every kernel launch of both runs held
                  against the plain version, and `ops/gang`'s torch code
                  (every `gang_filter` / `release_assignments` call of the
                  hierarchical run, and a fuzz of it and
                  `block_free_hosts`) against its numpy twins.
 10. gang agreement — the gang mix on the small trace (flat and
                  hierarchical) and `gang_topology_trace` (4 blocks of 8,
                  60 cycles) on the card and on the CPU: run traces and
                  `gang_stats` identical.
 11. gang admission — a 64-host fleet in blocks of 8 full of one user's
                  tasks and a waiting gang of 8: the rebalance cycle's
                  admission kills one block's tasks and reserves it
                  `gang:<group>`, the match places the gang whole there;
                  card = CPU.
 11a. multipool — the multi-pool slice (BASELINE configurations 3 and
                  5): 8 pools, 100,000 jobs x 10,000 hosts in all (pool
                  `alpha` 30,000 x 3,000, seven of 10,000 x 1,000, the last
                  in DruMode.GPU; a tenth of the jobs ask for 1-3 gpus, a
                  fifth of the hosts carry 8), 3 cycles on each of three
                  routes at the default SchedulerConfig: serial (the
                  Simulator), batched (`SimConfig.batched_match`: flat
                  pools stacked into one `chunked_match_pools` solve on
                  `xla`) and pipelined (`Scheduler.match_cycle_pipelined`
                  on the same store, clusters and clock steps: each pool on
                  its own CUDA stream, `best_node` for the flat pools,
                  async launches).  `alpha` takes the two-level path
                  (`coarse_pass`, `best_node_batched`) once its padded
                  problem reaches the 2^25 threshold, the other pools stay
                  flat.  Capacity checked after every match; pipelined
                  placements equal serial ones cycle by cycle; every
                  batched stacked solve re-solved lane by lane with
                  `chunked_match` on `xla`, identical; no `solve-failed`
                  skip; per cycle the rank, encode, solve and launch walls,
                  the flat solves (serial sum vs the batched shared wall),
                  the pipelined pass's wall and overlap fraction, and H2D
                  bytes per family printed.  Counts reset just before each
                  route and read just after.
 11b. multipool launches — every kept `best_node`, `coarse_pass` and
                  `best_node_batched` launch of the three routes against
                  its plain version, bit for bit.
 11c. multipool exact — one cycle at chunk 0 on the seven flat pools (all
                  jobs submitted at t 0): the batched `greedy_match_pools`
                  against a serial `greedy_match` per pool, identical run
                  traces, both solve walls printed.
 11d. multipool agreement — 4 pools x 300 jobs x 30 hosts (one in
                  DruMode.GPU), batched and pipelined, on the card and on
                  the CPU: identical run traces (and pipelined = serial).
 11e. resident multipool — the serial and pipelined routes of 11a again
                  with residency on: both run traces equal the classic
                  serial route's; every launch held against its plain
                  version.
 11f. resident streams — the unchanged-pool rig as 8 pools with 64 late
                  jobs a pool at 30 s and 60 s: every warm cycle a 64-row
                  delta written in place on one pipelined stage's stream
                  into buffers another stage read; resident serial,
                  resident pipelined and classic serial run traces equal.
 12. coarse_pass paged — `coarse_pass` past its shared memory (B 1024 at
                  R 4 and R 8, B 512 at R 8, and both sides of the edge at
                  R 8): identical to the plain version, bit-identical over
                  5 runs, timed cold and warm against the bound.
 13. rebalance cases — the victim search alone (`ops/rebalance.py`, torch
                  code: no hand kernel runs in it) at 131072 task rows x
                  16384 hosts, on the card against the same functions on
                  the CPU: the exact search and the sort-once pair,
                  identical host, score, preempt mask and freed, over the
                  victims / spare tie / none / quota kinds; CUDA-event
                  times of one decision of each kind, cold and warm, and
                  the sort's share.
 14. rebalance slice — the full-size rebalance path through the port's
                  Simulator: `preemption_heavy_trace` at 100,000 jobs x
                  10,000 hosts, 6 cycles of rank -> exact greedy match ->
                  rebalance on the card; capacity checked after every
                  match and rebalance; the padded axes checked; each
                  cycle's first and busiest search rerun on the CPU port,
                  identical.
 15. rebalance agreement — two small rebalance replays on the card and on
                  the CPU (run traces, fairness ledgers and host
                  reservations after every cycle equal): one on the flat
                  `pallas` matcher, whose `best_node` launches are counted
                  and each held against the plain version, and one whose
                  decisions take two victims and reserve the host; each
                  again with the rebalancer's resident row mirror
                  (`RebalancerParams.resident`) on the card and on the
                  CPU, equal to the replay without it.
 16. report     — a `{"kernels": [...]}` line, then the last line
                  `{"ok": true, "device": {...}}`.

Every replay runs the port's default `SchedulerConfig`, the reference's
default configuration: the columnar rank (`models/columnar.py`,
`scheduler/ranking_columnar.py`), the host-encode cache
(`scheduler/encode_cache.py`), the flight recorder and the device
telemetry.  The flat, hierarchical and gang slices print, per cycle, the
rank and encode walls, the cache's node hits and row hits and misses,
the rebuild fraction, the per-family H2D / D2H bytes and the columnar
index's upkeep (its store watcher, timed), then their totals with the
submit step's wall.  Two phases follow the agreement phase (8):

  8a. default-config agreement — the small trace at the default
                  `SchedulerConfig` with a shadow solve every solvable
                  cycle and a health verdict every cycle, on the card and
                  on the CPU, on the flat `pallas` route (the CPU parity
                  tests' knobs), the hierarchical route and the flat route
                  at the slices' knobs: run traces and every cycle
                  record's decision fields equal, shadow solves on both
                  devices, no verdict ever `device-degraded`, the final
                  verdict `ok` (at the slices' flat knobs: equal to the
                  CPU's, printed).
  8b. cache neutrality — on the card, the flat replay with the encode
                  cache on, off and on again: identical run traces.
  8c. resident default-config agreement — the small trace at the default
                  configuration with residency and `quantized` on, on the
                  card and on the CPU: run traces and cycle records (the
                  device_state stats among them) equal, and the run trace
                  equal to the card's replay with `quantized` alone.
After the launches phase (5), `encode cache on / off` replays the flat
slice twice more, with the cache off and on: run traces identical to the
slice's, the encode walls per cycle, and a host profile (cProfile) of the
last cycle's `prepare_pool_problem` in each.

Imports nothing of JAX and nothing of `cook_tpu`.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12

# name -> (module, source, the TPU kernel it replaces)
KERNELS = {
    "best_node": ("cook_tpu_torch.ops.best_node",
                  "cook_tpu_torch/csrc/best_node.cu",
                  "cook_tpu/ops/pallas_match.py:135"),
    "best_block": ("cook_tpu_torch.ops.best_block",
                   "cook_tpu_torch/csrc/best_block.cu",
                   "cook_tpu/ops/pallas_match.py:218"),
    "best_node_batched": ("cook_tpu_torch.ops.best_node_batched",
                          "cook_tpu_torch/csrc/best_node_batched.cu",
                          "cook_tpu/ops/pallas_match.py:316"),
    # best_block with the scan of cook_tpu/ops/hierarchical.py:233 around it
    "coarse_pass": ("cook_tpu_torch.ops.coarse_pass",
                    "cook_tpu_torch/csrc/coarse_pass.cu",
                    "cook_tpu/ops/pallas_match.py:218"),
}

# best_node: (label, K jobs, N nodes, kind), with the simulator's R = 4
# resource columns (mem, cpus, gpus, disk; matcher.encode_problem_arrays)
# unless the kind says otherwise:
#   bench      bench.make_problem's jobs and hosts 20-100% free, no mask
#   mixed      the same plus gpu and disk columns in use, about half the
#              mask set
#   fleet      the slice's own fleet at a cycle's start: 10,000 identical
#              empty hosts padded to 16384, every real host feasible, so
#              every score ties and the first-index rule decides
#   placed     mixed, with half the jobs marked placed (a 2 BIG demand, as
#              the chunked matcher marks them), which the kernel answers
#              without scoring
#   infeasible demands no node can hold
#   last_tile  mixed, with only the last node in the mask: the one
#              feasible node sits in the last node tile
#   tile_tie   identical hosts, the mask set only at TILE_EDGES (those
#              under N), job k from edge pair k mod (pairs) on: equal best
#              scores in two or more node tiles, where the earliest index
#              must win
#   r2, r8     mixed with R = 2 (mem, cpus) and R = 8 (four more columns)
# K 1025 and N 2049 / 4097 are one past any power-of-two job or node tile.
KERNEL_CASES = [
    ("bench 16384x2048", 16384, 2048, "bench"),
    ("mixed 1024x16384 masked", 1024, 16384, "mixed"),
    ("fleet 1024x16384 masked", 1024, 16384, "fleet"),
    ("prime 1021x2039 masked", 1021, 2039, "mixed"),
    ("placed 1024x16384 masked", 1024, 16384, "placed"),
    ("infeasible 1024x2048", 1024, 2048, "infeasible"),
    ("last tile 1025x4097 masked", 1025, 4097, "last_tile"),
    ("tile tie 1025x8192 masked", 1025, 8192, "tile_tie"),
    ("r2 1025x2049 masked", 1025, 2049, "r2"),
    ("r8 1025x16384 masked", 1025, 16384, "r8"),
]
# the last and first node of node tiles of 1024, 2048 and 4096 nodes
TILE_EDGES = (1023, 1024, 2047, 2048, 4095, 4096)
TILE_KINDS = ("last_tile", "tile_tie", "r2", "r8")
FLEET_HOSTS = 10_000
# best_block: (label, K jobs, B blocks, kind), at the coarse pass's shape
# on the slice (coarse chunk 4096 x 16 blocks of 1024 hosts):
#   bench      tests/test_hierarchical.py:140's draw with R = 4 (aggregate
#              fit, max-node gate, ~20% invalid blocks)
#   fleet      16 identical full blocks: every score ties, index 0 wins
#   padded     10 real blocks partly used, 6 padded as the coarse pass pads
#              them (max node -1, totals 1, invalid)
#   placed     bench, with half the jobs marked placed
#   infeasible demands no block can hold
BLOCK_CASES = [
    ("bench 4096x16", 4096, 16, "bench"),
    ("fleet 4096x16", 4096, 16, "fleet"),
    ("padded 4096x16", 4096, 16, "padded"),
    ("placed 4096x16", 4096, 16, "placed"),
    ("infeasible 4096x16", 4096, 16, "infeasible"),
]
# best_node_batched: (label, B blocks, S slots, N nodes per block, kind):
#   mixed      the slice's fine shape, gpu/disk columns, half the mask set
#   fleet      the slice's fine shape on its own fleet: 10,000 identical
#              empty hosts over 16 blocks of 1024, node validity in the
#              mask as the fine pass passes it
#   bench      bench.py bench_match_xl's fine shape (32 blocks of 512 over
#              10,000 of 16384 hosts, 8192 slots, R = 3), no mask
#   placed     mixed, with 7 of 8 slots marked placed or empty, the share
#              of the slice's full-cycle fine launches
#   infeasible demands no node can hold
#   last_tile, tile_tie, r2, r8   as for best_node, per block; N 2500 and
#              4097 span several node tiles, S 1025 is one past a slot tile
# plus prime slot and node counts
BATCHED_CASES = [
    ("mixed 16x2048x1024 masked", 16, 2048, 1024, "mixed"),
    ("fleet 16x2048x1024 masked", 16, 2048, 1024, "fleet"),
    ("bench 32x8192x512", 32, 8192, 512, "bench"),
    ("prime 7x1021x509 masked", 7, 1021, 509, "mixed"),
    ("placed 16x2048x1024 masked", 16, 2048, 1024, "placed"),
    ("infeasible 16x2048x1024", 16, 2048, 1024, "infeasible"),
    ("last tile 3x257x2500 masked", 3, 257, 2500, "last_tile"),
    ("tile tie 2x1025x4097 masked", 2, 1025, 4097, "tile_tie"),
    ("r2 4x1025x1024 masked", 4, 1025, 1024, "r2"),
    ("r8 4x1025x1024 masked", 4, 1025, 1024, "r8"),
]
# coarse_pass: (label, J jobs, B blocks, chunk, passes, rounds, kind), all
# exact-sum (MB in multiples of 512, cpus in halves, whole gpus and disk),
# so every order of summing gives the same float32 sums:
#   fleet      the slice's blocks at a cycle's start: 1024 identical empty
#              hosts each, so every score ties
#   mixed      16-64 hosts a block, partly used, gpu and disk columns, the
#              max-node gate below the sums; contention fills blocks and
#              later passes and rounds place the rest
#   ties       mixed capacities repeated over groups of 4 identical blocks
#   slice      the slice's shape: 10 real blocks of 1024 hosts partly
#              used, 6 padded, every job active
#   padded     mixed with the blocks past 10 (past 98 at B 128, the 100k
#              node pad) padded as the coarse pass pads them
#   inactive   mixed with half the jobs not active (a refine round's mask)
#   infeasible demands no block can hold
#   r2, r8     mixed with R = 2 and R = 8; at chunk 32768 x R 8 x B 128
#              each CTA runs 8 tiles of the chunk (4096 job slots)
COARSE_CASES = [
    ("fleet 16384x16", 16384, 16, 4096, 8, 2, "fleet"),
    ("mixed 16384x16", 16384, 16, 4096, 8, 2, "mixed"),
    ("ties 16384x16", 16384, 16, 4096, 8, 2, "ties"),
    ("infeasible 4096x16", 4096, 16, 4096, 8, 2, "infeasible"),
    ("padded 16384x16", 16384, 16, 4096, 8, 2, "padded"),
    ("one chunk 4096x16", 4096, 16, 4096, 8, 2, "mixed"),
    ("slice 4x4096x16", 16384, 16, 4096, 8, 2, "slice"),
    ("chunk 1 64x16", 64, 16, 1, 8, 2, "mixed"),
    ("rounds 1 4096x16", 4096, 16, 1024, 8, 1, "mixed"),
    ("rounds 3 4096x16", 4096, 16, 1024, 8, 3, "mixed"),
    ("B 128 16384x128", 16384, 128, 4096, 8, 2, "padded"),
    ("inactive 16384x16", 16384, 16, 4096, 8, 2, "inactive"),
    ("r2 4096x16", 4096, 16, 1024, 8, 2, "r2"),
    ("r8 4096x16", 4096, 16, 1024, 8, 2, "r8"),
    ("r8 32768x128", 32768, 128, 32768, 4, 2, "r8"),
]
COARSE_KINDS = ("fleet", "mixed", "ties", "slice", "padded", "inactive",
                "infeasible", "r2", "r8")
# coarse_pass past its shared memory: the block state of B 1024 (R 4 and
# R 8) and B 512 (R 8) pages to device memory, as does one block past the
# largest B that fits at R 8 (`edge`), which itself runs in shared memory;
# the slice's J and chunk.  "edge" rows take B from ops/coarse_pass.paged
PAGED_CASES = [
    ("paged B1024 R4 16384x1024", 16384, 1024, 4096, 8, 2, "mixed"),
    ("paged B1024 R8 16384x1024", 16384, 1024, 4096, 8, 2, "r8"),
    ("paged B512 R8 16384x512", 16384, 512, 4096, 8, 2, "r8"),
    ("edge R8 16384x{b}", 16384, "edge", 4096, 8, 2, "r8"),
    ("edge+1 R8 16384x{b}", 16384, "edge+1", 4096, 8, 2, "r8"),
]

# the slices' trace: 100,000 jobs x 10,000 hosts (sim.cli synth)
SYNTH_ARGS = ["--jobs", "100000", "--hosts", "10000", "--users", "50",
              "--submit-span-ms", "60000"]
SLICE_ARGS = ["--considerable", "16384", "--chunk", "1024",
              "--backend", "pallas", "--max-cycles", "3",
              "--cycle-ms", "30000"]
# the hierarchical slice's matcher: the flat slice's knobs plus the
# two-level path for every solve, both of its backends on the kernels;
# the rest (nodes per block auto -> 1024, coarse chunk 4096, 8 coarse
# passes, 16 fine passes, 2 refine rounds) are the defaults
HIER_MATCH = dict(max_jobs_considered=16384, chunk=1024, backend="pallas",
                  hierarchical_threshold=1,
                  hierarchical_coarse_backend="pallas",
                  hierarchical_fine_backend="pallas")

# the gang slice's traffic on the slices' trace: every GANG_EVERY-th job
# (index = 0 mod 10, 10,000 of the 100,000) is a gang member, grouped in
# submit order into gangs whose sizes cycle GANG_SIZES; every other job
# stays scalar (synth_trace's users are Zipf-skewed, so they do not pick
# the members)
GANG_EVERY = 10
GANG_SIZES = (2, 4, 8, 16)
# the flat gang run: the flat slice's knobs, with the one-block rule bound
# to blocks of 1024 hosts
GANG_FLAT_MATCH = dict(max_jobs_considered=16384, chunk=1024,
                       backend="pallas", topology_block_hosts=1024)


def gang_mix(jobs, every=GANG_EVERY, sizes=GANG_SIZES):
    """`jobs` (either package's TraceJob list) with every `every`-th job
    tagged a gang member: the members, in submit order, form gangs whose
    sizes cycle through `sizes`; a last group short of its size is a gang
    of what is left (a single member stays scalar)."""
    import dataclasses

    members = sorted(jobs[::every], key=lambda j: (j.submit_time_ms,
                                                   j.uuid))
    tag = {}
    start, g = 0, 0
    while len(members) - start >= 2:
        size = sizes[g % len(sizes)]
        for j in members[start:start + size]:
            tag[j.uuid] = f"gang-{g:05d}"
        start += size
        g += 1
    return [dataclasses.replace(j, gang=tag[j.uuid]) if j.uuid in tag
            else j for j in jobs]


def phase(name):
    print(f"== {name}", flush=True)


def device_phase():
    import torch

    phase("device")
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    return card


def build_phase():
    from cook_tpu_torch import build

    phase("build")
    t0 = time.perf_counter()
    build.load_all(KERNELS)
    print(f"{', '.join(KERNELS)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def _slice_demands(rng, k):
    """The simulator's job shapes (synth_trace): mem, cpus, no gpus/disk."""
    import numpy as np

    mem = rng.choice([512, 1024, 2048, 4096, 8192], k).astype(np.float32)
    cpus = rng.choice([0.5, 1, 2, 4], k).astype(np.float32)
    zeros_k = np.zeros(k, dtype=np.float32)
    return np.stack([mem, cpus, zeros_k, zeros_k], axis=-1)


def _place(rng, demands, share):
    """Mark about `share` of the rows placed, as the matchers mark placed
    and empty rows: a 2 BIG first demand."""
    from cook_tpu_torch.ops.common import BIG

    demands[rng.uniform(size=demands.shape[:-1]) < share, 0] = 2 * BIG


def _put(arrays, device):
    import torch

    return tuple(None if a is None else torch.as_tensor(a, device=device)
                 for a in arrays)


def _tile_kind(rng, kind, demands, avail, totals, mask):
    """The node-tile kinds (KERNEL_CASES), made from a `mixed` draw of
    either kernel: [..., K, R] demands, [..., N, R] avail, [..., N, 2]
    totals, [..., K, N] mask."""
    import numpy as np

    k, n = mask.shape[-2:]
    roomy = np.float32([65536, 32, 8, 100_000])
    if kind == "last_tile":
        avail[..., -1, :] = roomy
        mask[...] = False
        mask[..., -1] = True
    elif kind == "tile_tie":
        totals[...] = roomy[:2]
        avail[...] = roomy
        mask[...] = False
        for j, first in enumerate(tile_tie_first(k, n)):
            mask[..., j, [e for e in TILE_EDGES if first <= e < n]] = True
    elif kind == "r2":
        demands, avail = demands[..., :2].copy(), avail[..., :2].copy()
    elif kind == "r8":
        more = rng.integers(0, 100, (*avail.shape[:-1], 4))
        want = np.where(rng.uniform(size=(*demands.shape[:-1], 4)) < 0.3,
                        rng.integers(1, 50, (*demands.shape[:-1], 4)), 0)
        demands = np.concatenate([demands, want], -1).astype(np.float32)
        avail = np.concatenate([avail, more], -1).astype(np.float32)
    return demands, avail, totals, mask


def tile_tie_first(k, n):
    """[k] int: the node each job of a `tile_tie` case must take."""
    import numpy as np

    edges = [e for e in TILE_EDGES if e < n]
    return np.array([edges[2 * (j % (len(edges) // 2))] for j in range(k)])


def make_inputs(k, n, kind, device, seed=0):
    """(demands, avail, totals, node_valid, mask) for one KERNEL_CASES
    kind; node_valid is all set, as chunked_match passes it when a mask
    carries node validity."""
    import numpy as np

    rng = np.random.default_rng(seed)
    demands = _slice_demands(rng, k)
    totals = np.stack([np.full(n, 65536.0, dtype=np.float32),
                       np.full(n, 32.0, dtype=np.float32)], axis=-1)
    frac = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    avail = np.concatenate([totals * frac, np.zeros((n, 2), np.float32)],
                           axis=-1)
    mask = None
    if kind == "infeasible":
        demands[:, 0] = 1e9
    elif kind in ("mixed", "placed", *TILE_KINDS):
        # one host in 8 carries 0-8 free gpus, every host 0-100 GB of free
        # disk; one job in 16 wants 1-2 gpus and half want 1-10 GB of disk
        gpu_host = rng.uniform(size=n) < 0.125
        avail[:, 2] = np.where(gpu_host, rng.integers(0, 9, n), 0)
        avail[:, 3] = rng.integers(0, 100_000, n)
        demands[:, 2] = np.where(rng.uniform(size=k) < 0.0625,
                                 rng.integers(1, 3, k), 0)
        demands[:, 3] = np.where(rng.uniform(size=k) < 0.5,
                                 rng.integers(1_000, 10_000, k), 0)
        mask = rng.uniform(size=(k, n)) < 0.5
        if kind == "placed":
            _place(rng, demands, 0.5)
        demands, avail, totals, mask = _tile_kind(rng, kind, demands, avail,
                                                  totals, mask)
    elif kind == "fleet":
        real = np.arange(n) < FLEET_HOSTS
        totals[~real] = 0.0
        avail = np.concatenate([totals, np.zeros((n, 2), np.float32)],
                               axis=-1)
        mask = np.broadcast_to(real, (k, n)).copy()
    valid = np.ones(n, dtype=bool)
    return _put((demands, avail, totals, valid, mask), device)


def make_block_inputs(k, b, kind, device, seed=0):
    """(demands, block_avail, block_max, block_totals, block_valid) for one
    BLOCK_CASES kind."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if kind in ("bench", "placed"):
        demands = rng.uniform(10, 500, (k, 4)).astype(np.float32)
        bsum = rng.uniform(100, 2000, (b, 4)).astype(np.float32)
        bmax = (bsum * rng.uniform(0.1, 1.0, (b, 4))).astype(np.float32)
        btot = (bsum[:, :2] * 1.5).astype(np.float32)
        valid = rng.uniform(size=b) > 0.2
        if kind == "placed":
            _place(rng, demands, 0.5)
        return _put((demands, bsum, bmax, btot, valid), device)
    demands = _slice_demands(rng, k)
    host = np.float32([64000, 32, 0, 0])
    bsum = np.tile(host * 1024, (b, 1))
    bmax = np.tile(host, (b, 1))
    btot = bsum[:, :2].copy()
    valid = np.ones(b, dtype=bool)
    if kind == "infeasible":
        demands[:, 0] = 1e9
    elif kind == "padded":
        real = min(10, b)
        # each real block has 0-1024 of its hosts' memory and cpus in use
        bsum[:real, :2] -= (rng.integers(0, 1024, (real, 2))
                            * np.float32([8192, 4]))
        bsum[real:] = 0.0
        bmax[real:] = -1.0
        btot[real:] = 1.0
        valid[real:] = False
    return _put((demands, bsum, bmax, btot, valid), device)


def make_batched_inputs(b, s, n, kind, device, seed=0):
    """(demands, avail, totals, node_valid, mask) for one BATCHED_CASES
    kind; with a mask, node_valid is all set and the mask carries node
    validity, as the fused fine pass passes them."""
    import numpy as np

    rng = np.random.default_rng(seed)
    demands = _slice_demands(rng, b * s).reshape(b, s, 4)
    totals = np.tile(np.float32([65536.0, 32.0]), (b, n, 1))
    frac = rng.uniform(0.2, 1.0, (b, n, 1)).astype(np.float32)
    avail = np.concatenate([totals * frac, np.zeros((b, n, 2), np.float32)],
                           axis=-1)
    valid = np.ones((b, n), dtype=bool)
    mask = None
    if kind == "infeasible":
        demands[..., 0] = 1e9
    elif kind in ("mixed", "placed", *TILE_KINDS):
        gpu_host = rng.uniform(size=(b, n)) < 0.125
        avail[..., 2] = np.where(gpu_host, rng.integers(0, 9, (b, n)), 0)
        avail[..., 3] = rng.integers(0, 100_000, (b, n))
        demands[..., 2] = np.where(rng.uniform(size=(b, s)) < 0.0625,
                                   rng.integers(1, 3, (b, s)), 0)
        demands[..., 3] = np.where(rng.uniform(size=(b, s)) < 0.5,
                                   rng.integers(1_000, 10_000, (b, s)), 0)
        mask = rng.uniform(size=(b, s, n)) < 0.5
        if kind == "placed":
            _place(rng, demands, 0.875)
        demands, avail, totals, mask = _tile_kind(rng, kind, demands, avail,
                                                  totals, mask)
    elif kind == "fleet":
        # the slice's 10,000 of 16384 hosts real, at this batch's size
        real = (np.arange(b * n) < b * n * FLEET_HOSTS // 16384) \
            .reshape(b, n)
        totals = np.where(real[..., None], np.float32([64000, 32]),
                          np.float32(0))
        avail = np.concatenate([totals, np.zeros((b, n, 2), np.float32)],
                               axis=-1)
        mask = np.broadcast_to(real[:, None, :], (b, s, n)).copy()
    elif kind == "bench":
        # bench_match_xl: R = 3, the first 10,000 of 16384 hosts valid
        demands = demands[..., :3].copy()
        avail = avail[..., :3].copy()
        valid = (np.arange(b * n) < b * n * FLEET_HOSTS // 16384) \
            .reshape(b, n)
    return _put((demands, avail, totals, valid, mask), device)


def make_coarse_inputs(j, b, kind, device, seed=0):
    """(demands, active, block_avail, block_max, block_totals, block_valid)
    for one COARSE_CASES kind, exact in float32.  A host holds 64000 MB,
    32 cpus, 8 gpus and 1000 GB of disk; a block's sums, max single node
    and totals are those of its hosts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    demands = _slice_demands(rng, j)
    active = np.ones(j, dtype=bool)
    host = np.float32([64000, 32, 8, 1000])
    real = b if kind in ("fleet", "mixed", "ties", "inactive", "r2", "r8",
                         "infeasible") else min(b, 10 if b <= 16 else 98)
    if kind in ("fleet", "slice"):
        hosts = np.full(b, 1024)
    else:
        hosts = rng.integers(16, 65, b)
    if kind == "ties":
        hosts = np.repeat(hosts[::4], 4)[:b]
    full = hosts[:, None] * host
    # used capacity in whole units: 512 MB, half cpus, gpus, GB of disk
    units = np.float32([512, 0.5, 1, 1])
    used = (rng.uniform(0, 0.9, (b, 4)) * full / units).astype(np.int64) \
        * units
    if kind == "fleet":
        used[:] = 0
    if kind == "ties":
        used = np.repeat(used[::4], 4, axis=0)[:b]
    bsum = (full - used).astype(np.float32)
    # the freest single node: at most a host, at most the block's sum
    node = (rng.uniform(0.2, 1.0, (b, 4)) * host / units).astype(np.int64) \
        * units
    if kind in ("fleet", "slice"):
        node = np.tile(host, (b, 1))
    if kind == "ties":
        node = np.repeat(node[::4], 4, axis=0)[:b]
    bmax = np.minimum(bsum, node).astype(np.float32)
    btot = full[:, :2].astype(np.float32)
    valid = np.ones(b, dtype=bool)
    if kind in ("fleet", "slice"):
        # the slice's jobs ask for no gpus and no disk, and its hosts have
        # none
        bsum[:, 2:] = bmax[:, 2:] = 0.0
    else:
        demands[:, 2] = np.where(rng.uniform(size=j) < 0.0625,
                                 rng.integers(1, 3, j), 0)
        demands[:, 3] = np.where(rng.uniform(size=j) < 0.5,
                                 rng.integers(1, 100, j), 0)
    if real < b:
        bsum[real:] = 0.0
        bmax[real:] = -1.0
        btot[real:] = 1.0
        valid[real:] = False
    if kind == "infeasible":
        demands[:, 0] = 1e9
    elif kind == "inactive":
        active = rng.uniform(size=j) < 0.5
    elif kind == "r2":
        demands, bsum, bmax = demands[:, :2], bsum[:, :2], bmax[:, :2]
    elif kind == "r8":
        more = rng.integers(0, 100, (b, 4)) * hosts[:, None]
        want = np.where(rng.uniform(size=(j, 4)) < 0.3,
                        rng.integers(1, 50, (j, 4)), 0)
        demands = np.concatenate([demands, want], -1)
        bsum = np.concatenate([bsum, more], -1)
        bmax = np.concatenate([bmax, np.minimum(more, 100)], -1)
    f32 = [np.ascontiguousarray(a, dtype=np.float32)
           for a in (demands, bsum, bmax, btot)]
    return _put((f32[0], active, f32[1], f32[2], f32[3], valid), device)


# bytes written before each cold timing: well over the card's 50 MB L2, so
# the timed call finds none of its inputs there
SCRUB_BYTES = 256 << 20
_scrub = []


def evict_l2():
    """Write SCRUB_BYTES of device memory, pushing every earlier line out
    of the L2 cache."""
    import torch

    if not _scrub:
        _scrub.append(torch.empty(SCRUB_BYTES, dtype=torch.uint8,
                                  device="cuda"))
    _scrub[0].fill_(1)


def cuda_ms(fn, reps=20, spin_cycles=2_000_000, cold=False):
    """Median of `reps` CUDA-event timings of fn()'s device work (after
    one warm-up).  Each timing is queued behind a spin of the card
    (`torch.cuda._sleep`, ~1 ms at first), so the host has issued all of
    fn's launches before the card reaches the start event: the two events
    then hold the device work alone, not the host's dispatch (the
    wrapper's checks, its allocations, the ctypes call).  A timing counts
    only if the card was still short of the start event when the host
    had queued the end one; otherwise the spin is lengthened and the
    timings taken again.  With `cold`, the L2 cache is evicted before each
    timing (ahead of the spin, outside the events), so fn reads its inputs
    from device memory, as the bytes bound assumes; without, fn finds the
    inputs its previous run left in L2."""
    import torch

    fn()
    while True:
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if cold:
                evict_l2()
            torch.cuda._sleep(spin_cycles)
            start.record()
            fn()
            end.record()
            queued = not start.query()
            end.synchronize()
            if queued:
                times.append(start.elapsed_time(end))
        if len(times) == reps:
            return sorted(times)[reps // 2]
        if spin_cycles >= 2_000_000_000:
            raise RuntimeError("cuda_ms: the host never queued the timed "
                               "work ahead of the card")
        spin_cycles *= 4


def wall_ms(fn, reps=5):
    """Median of `reps` host-clock timings of fn() ending in a
    synchronize (after one warm-up), host dispatch included."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def _bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the float32 operations over the float32 peak."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _live(demands):
    """[..., K] bool: the rows a kernel scores, those whose first demand
    is under BIG (score_tile.cuh `live`).  The matchers mark placed and
    empty rows with a 2 BIG demand; their answer is (-BIG, -1) whatever
    the mask says, so the work of a call is that of its live rows."""
    from cook_tpu_torch.ops.common import BIG

    return demands[..., 0] < BIG


def best_node_bound(demands, avail, totals, valid, mask):
    """Each input read once and each output written once, but only the
    mask rows of live jobs, against the float32 operations of the (live
    job, node) pairs the kernel scores — those the mask and node_valid let
    through — at ~(R + 8) each (R fit compares; two subtracts, two adds,
    two divides, a multiply and the running max)."""
    k, r = demands.shape
    n = avail.shape[0]
    live = _live(demands)
    k_live = int(live.sum())
    nbytes = (k * r * 4 + n * r * 4 + n * 2 * 4 + n
              + (k_live * n if mask is not None else 0) + k * 8)
    pairs = (int((mask[live] & valid[None, :]).sum()) if mask is not None
             else k_live * int(valid.sum()))
    return _bound(nbytes, pairs * (r + 8))


def best_block_bound(demands, block_avail, block_max, block_totals,
                     block_valid):
    """As best_node_bound, with two [B, R] capacity inputs and ~(2R + 8)
    operations per (live job, valid block) pair (the aggregate and the
    max-node fit)."""
    k, r = demands.shape
    b = block_avail.shape[0]
    nbytes = k * r * 4 + 2 * b * r * 4 + b * 2 * 4 + b + k * 8
    return _bound(nbytes, int(_live(demands).sum())
                  * int(block_valid.sum()) * (2 * r + 8))


def best_node_batched_bound(demands, avail, totals, valid, mask):
    """best_node_bound over the batch: the mask rows of the live slots
    are the stream that grows with the problem."""
    b, s, r = demands.shape
    n = avail.shape[1]
    live = _live(demands)
    nbytes = (b * s * r * 4 + b * n * r * 4 + b * n * 2 * 4 + b * n
              + (int(live.sum()) * n if mask is not None else 0)
              + b * s * 8)
    pairs = (int((mask & valid[:, None, :])[live].sum())
             if mask is not None
             else int((live.sum(1) * valid.sum(1)).sum()))
    return _bound(nbytes, pairs * (r + 8))


def coarse_pass_bound(demands, active, block_avail, block_max,
                      block_totals, block_valid, chunk, passes, rounds):
    """Each input read once and each output written once, against ~(2R +
    8) float32 operations per (live job, valid block) pair of every
    candidate pass, counting only the jobs still unplaced at that pass
    (the plain version reports them: the work depends on the data)."""
    from cook_tpu_torch.ops.coarse_pass import coarse_pass_reference

    j, r = demands.shape
    b = block_avail.shape[0]
    scored = []
    coarse_pass_reference(demands, active, block_avail, block_max,
                          block_totals, block_valid, chunk, passes, rounds,
                          scored=scored)
    nbytes = j * r * 4 + j + 2 * b * r * 4 + b * 2 * 4 + b + j * 4 \
        + b * r * 4
    return _bound(nbytes, sum(scored) * int(block_valid.sum()) * (2 * r + 8))


BOUNDS = {"best_node": best_node_bound, "best_block": best_block_bound,
          "best_node_batched": best_node_batched_bound,
          "coarse_pass": coarse_pass_bound}


def graph_ms(fn, cold=False):
    """cuda_ms of fn()'s work captured once in a CUDA graph and replayed:
    the device time of every op fn queues, whatever its host dispatch
    costs (the plain coarse pass queues ~7k small ops, more than the
    card's launch queue holds ahead of cuda_ms's spin)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # the warm-up capture asks for, on a side stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    try:
        return cuda_ms(graph.replay, cold=cold)
    finally:
        del graph


def _module(name):
    return importlib.import_module(KERNELS[name][0])


def check_identical(name, label, args):
    """Kernel and plain version on the same arguments: identical integer
    outputs (indices, assignments) and bit-identical float ones (scores,
    availability).  Returns (outputs, max_abs_err), the error over the
    float outputs."""
    import torch

    mod = _module(name)
    outs = getattr(mod, name)(*args)
    # the wrapper casts bfloat16 cost tensors to float32 at its boundary
    # (MatchConfig.quantized); the plain version takes them so cast
    refs = getattr(mod, f"{name}_reference")(*(
        a.float() if isinstance(a, torch.Tensor)
        and a.dtype == torch.bfloat16 else a for a in args))
    torch.cuda.synchronize()
    err = 0.0
    for got, want in zip(outs, refs):
        if not got.is_floating_point():
            if not torch.equal(got, want):
                bad = int((got != want).sum())
                raise AssertionError(f"{name} {label}: {bad}/{got.numel()} "
                                     "indices differ from the plain version")
            continue
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name} {label}: float outputs not "
                                 "bit-identical to the plain version")
        if got.numel():
            err = max(err, float((got.double() - want.double()).abs().max()))
    return outs, err


def time_case(name, args):
    """Cold and warm kernel times, the plain version's (cold, its device
    work alone) and the bound; raises if the cold time reads under the bound, which only a
    failed L2 eviction could give."""
    mod = _module(name)
    kernel = getattr(mod, name)
    plain = getattr(mod, f"{name}_reference")
    ms = cuda_ms(lambda: kernel(*args), cold=True)
    warm_ms = cuda_ms(lambda: kernel(*args))
    plain_ms = graph_ms(lambda: plain(*args), cold=True)
    bound_ms, bound_by = BOUNDS[name](*args)
    if ms < bound_ms:
        raise AssertionError(f"{name}: cold time {ms:.4g} ms under its "
                             f"bound {bound_ms:.4g} ms: L2 not evicted")
    return dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def _print_row(name, label, row, extra=""):
    print(f"{name} {label}: {extra}kernel {row['ms']:.4f} ms cold "
          f"{row['warm_ms']:.4f} ms warm  plain {row['plain_ms']:.4f} ms  "
          f"bound {row['bound_ms']:.4g} ms ({row['bound_by']})", flush=True)


def _kernel_cases(name, cases, make):
    """Check and time every case of one kernel; returns the max error."""
    import torch

    dev = torch.device("cuda")
    max_err = 0.0
    for label, *shape, kind in cases:
        args = make(*shape, kind, dev)
        (_, idx), err = check_identical(name, label, args)
        max_err = max(max_err, err)
        if kind == "infeasible" and not bool((idx == -1).all()):
            raise AssertionError(f"{name} infeasible case placed a job")
        if kind == "fleet":
            # identical hosts (or blocks): each job takes the first one
            first = idx if idx.dim() == 1 else idx[:FLEET_HOSTS
                                                   // shape[-1]]
            if not bool((first == 0).all()):
                raise AssertionError(f"{name} fleet case: on identical "
                                     "hosts every job must take the first")
        want = {"last_tile": lambda k, n: torch.full((k,), n - 1),
                "tile_tie": lambda k, n: torch.as_tensor(
                    tile_tie_first(k, n))}.get(kind)
        if want is not None and not bool(
                (idx.cpu() == want(*shape[-2:]).to(idx.dtype)).all()):
            raise AssertionError(f"{name} {label}: a job missed the node "
                                 "the case leaves it")
        _print_row(name, label, time_case(name, args),
                   f"identical (found {int((idx >= 0).sum())}/"
                   f"{idx.numel()})  ")
        del args
    return max_err


def _coarse_cases(cases=COARSE_CASES):
    """Every case of `cases` against the plain version (identical
    assignment, bit-identical final availability) and timed; the kernel's
    capacity rule checked on the assignment.  Returns ({label: timing
    row}, the max error)."""
    import torch

    from cook_tpu_torch.ops.common import BIG

    dev = torch.device("cuda")
    max_err = 0.0
    rows = {}
    for label, j, b, chunk, passes, rounds, kind in cases:
        args = (*make_coarse_inputs(j, b, kind, dev), chunk, passes, rounds)
        (assignment, avail), err = check_identical("coarse_pass", label, args)
        max_err = max(max_err, err)
        demands, active, bsum, _, _, valid = args[:6]
        routed = assignment >= 0
        if kind == "infeasible" and bool(routed.any()):
            raise AssertionError(f"coarse_pass {label}: a job was routed")
        if bool((routed & ~active).any()) or bool(
                (~valid[assignment[routed].long()]).any()):
            raise AssertionError(f"coarse_pass {label}: an inactive job or "
                                 "an invalid block was routed")
        # what was taken is what the routed jobs ask for, and no block went
        # below zero
        taken = torch.zeros_like(bsum).index_add_(
            0, assignment[routed].long(), demands[routed])
        if not torch.equal(bsum - taken, avail) or bool((avail < 0).any()):
            raise AssertionError(f"coarse_pass {label}: the availability "
                                 "does not account for the routed jobs")
        live = int((active & (demands[:, 0] < BIG)).sum())
        rows[label] = time_case("coarse_pass", args)
        _print_row("coarse_pass", label, rows[label],
                   f"identical (routed {int(routed.sum())}/{live})  ")
        del args
    return rows, max_err


def paged_coarse_phase():
    """coarse_pass past its shared memory (PAGED_CASES): each launch
    identical to the plain version, run 5 times bit-identical, timed cold
    and warm against its bound; the cases at the edge straddle it (the
    largest B that fits in shared memory, and one more, which pages).
    Returns ({label: row}, max error)."""
    import torch

    from cook_tpu_torch.ops import coarse_pass as cp

    phase("coarse_pass paged")
    edge = max(b for b in range(1, 2048) if not cp.paged(b, 8, 4096))
    cases = []
    for label, j, b, chunk, passes, rounds, kind in PAGED_CASES:
        b = {"edge": edge, "edge+1": edge + 1}.get(b, b)
        r = 8 if kind == "r8" else 4
        cases.append((label.format(b=b), j, b, chunk, passes, rounds, kind))
        print(f"{cases[-1][0]}: {'paged' if cp.paged(b, r, chunk) else 'in shared memory'}, "
              f"{cp.smem_bytes(b, r, chunk)} bytes of shared memory a CTA, "
              f"workspace {4 * cp.workspace_floats(b, r, chunk)} bytes",
              flush=True)
        if cp.paged(b, r, chunk) != (b != edge):
            raise AssertionError(f"{cases[-1][0]}: paged is "
                                 f"{cp.paged(b, r, chunk)}")
    rows, err = _coarse_cases(cases)
    dev = torch.device("cuda")
    for label, j, b, chunk, passes, rounds, kind in cases:
        check_deterministic("coarse_pass", (
            *make_coarse_inputs(j, b, kind, dev), chunk, passes, rounds))
    print(f"coarse_pass paged: {len(cases)} cases identical to the plain "
          f"version, each bit-identical over {DETERMINISM_RUNS} runs",
          flush=True)
    return rows, err


def check_smem_mirror():
    """ops/coarse_pass.smem_bytes and workspace_floats, which size a
    launch (shared memory, and the device-memory workspace the block state
    pages to past it), equal the kernel's own counts
    (coarse_pass_smem_bytes, coarse_pass_workspace_floats) on a grid of
    shapes across the card's limit."""
    import ctypes

    from cook_tpu_torch import build
    from cook_tpu_torch.ops import coarse_pass as cp

    lib = build.load("coarse_pass")
    count = lib.coarse_pass_smem_bytes
    count.argtypes = [ctypes.c_int] * 3
    count.restype = ctypes.c_int
    floats = lib.coarse_pass_workspace_floats
    floats.argtypes = [ctypes.c_int] * 3
    floats.restype = ctypes.c_longlong
    for b in (1, 16, 128, 256, 279, 280, 300, 543, 544, 1024, 1028, 1029):
        for r in (2, 4, 8):
            for chunk in (1, 64, 4096, 32768):
                got = (count(b, r, chunk), floats(b, r, chunk))
                want = (cp.smem_bytes(b, r, chunk),
                        cp.workspace_floats(b, r, chunk))
                if got != want:
                    raise AssertionError(
                        f"coarse_pass (smem_bytes, workspace_floats)({b}, "
                        f"{r}, {chunk}) = {want}, the kernel counts {got}")
    print("coarse_pass shared-memory and workspace counts mirrored by "
          "ops/coarse_pass.py", flush=True)


def kernel_phase():
    """Every kernel case; returns {kernel: max_abs_err}."""
    import torch

    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import best_node as bn

    phase("kernel")
    errs = {"best_node": _kernel_cases("best_node", KERNEL_CASES,
                                       make_inputs),
            "best_block": _kernel_cases("best_block", BLOCK_CASES,
                                        make_block_inputs),
            "best_node_batched": _kernel_cases(
                "best_node_batched", BATCHED_CASES, make_batched_inputs),
            "coarse_pass": _coarse_cases()[1]}
    check_smem_mirror()
    # the batched kernel is best_node run block by block
    # (tests/test_device_state.py:577)
    args = make_batched_inputs(16, 2048, 1024, "mixed",
                               torch.device("cuda"), seed=1)
    val, idx = bnb.best_node_batched(*args)
    for k in range(args[0].shape[0]):
        v1, i1 = bn.best_node(*(a[k] for a in args))
        if not (torch.equal(idx[k], i1)
                and torch.equal(val[k].view(torch.int32),
                                v1.view(torch.int32))):
            raise AssertionError(f"best_node_batched block {k} differs "
                                 "from best_node on that block")
    print("best_node_batched equals best_node run per block on "
          f"{args[0].shape[0]} blocks", flush=True)
    return errs


def check_capacity(sim):
    """No host's running demand exceeds its capacity."""
    used = {}
    for rt in sim.cluster.running.values():
        u = used.setdefault(rt.spec.node_id, [0.0, 0.0, 0.0])
        u[0] += rt.spec.mem
        u[1] += rt.spec.cpus
        u[2] += rt.spec.gpus
    for node_id, (mem, cpus, gpus) in used.items():
        h = sim.cluster.hosts[node_id]
        if mem > h.mem or cpus > h.cpus or gpus > h.gpus:
            raise AssertionError(
                f"host {node_id} oversubscribed: running ({mem}, {cpus}, "
                f"{gpus}) > capacity ({h.mem}, {h.cpus}, {h.gpus})")
    return len(used)


@contextlib.contextmanager
def kept_calls(module, name, calls):
    """Append the arguments of every call of `module.name` while the block
    runs.  The matchers build fresh tensors for each kernel call and never
    write them in place, so keeping references keeps the exact inputs of
    each launch."""
    original = getattr(module, name)

    def keep(*args):
        calls.append(args)
        return original(*args)

    setattr(module, name, keep)
    try:
        yield calls
    finally:
        setattr(module, name, original)


class CycleProbe:
    """What a slice's default configuration does each match cycle, beside
    its cycle records: the encode cache's node hits and misses and row
    hits and misses (its counters, read before and after each match
    cycle), and the columnar index's upkeep (its store watcher, timed in
    total: the index grows in the store's event fan-out — submits,
    launches, completions — not in the rank cycle)."""

    def __init__(self, sim):
        from cook_tpu_torch.utils.metrics import global_registry

        self.rows = global_registry.counter("match.encode_cache.rows")
        self.nodes = global_registry.counter("match.encode_cache.nodes")
        self.upkeep_s = 0.0
        self.cycles = []
        scheduler = sim.scheduler
        index = scheduler.columnar
        if index is not None:
            watchers = sim.store._watchers
            on_event = index._on_event
            slot = watchers.index(on_event)

            def timed(event):
                t0 = time.perf_counter()
                on_event(event)
                self.upkeep_s += time.perf_counter() - t0

            watchers[slot] = timed
        match_cycle = scheduler.match_cycle
        self._upkeep_seen = 0.0

        def probed(pool):
            before = self._counts()
            out = match_cycle(pool)
            after = self._counts()
            node_hits, node_misses, row_hits, row_misses = (
                a - b for a, b in zip(after, before))
            self.cycles.append(dict(
                node_hits=node_hits, node_misses=node_misses,
                row_hits=row_hits, row_misses=row_misses,
                index_upkeep_s=self.upkeep_s - self._upkeep_seen))
            self._upkeep_seen = self.upkeep_s
            return out

        scheduler.match_cycle = probed

    def _counts(self):
        return (int(self.nodes.value({"result": "hit"})),
                int(self.nodes.value({"result": "miss"})),
                int(self.rows.value({"result": "hit"})),
                int(self.rows.value({"result": "miss"})))


def report_cycles(label, result, probe):
    """Per cycle: the rank and encode walls (the cycle record's `rank` and
    `tensor_build` phases), the cache's hits and misses, the rebuild
    fraction, the per-family H2D / D2H bytes and the index upkeep since
    the previous cycle; then the totals, the submit step's wall (the
    store's event fan-out) among them."""
    records = result.cycle_records
    if len(records) != len(probe.cycles):
        raise AssertionError(f"{label}: {len(records)} cycle records, "
                             f"{len(probe.cycles)} probed match cycles")
    for rec, cyc in zip(records, probe.cycles):
        fams = rec["data_plane"]
        print(f"{label} cycle {rec['cycle']} " + json.dumps(dict(
            rank_s=round(rec["phases"].get("rank", 0.0), 4),
            encode_s=round(rec["phases"].get("tensor_build", 0.0), 4),
            solve_s=round(rec["phases"].get("solve", 0.0), 4),
            launch_s=round(rec["phases"].get("launch", 0.0), 4),
            **cyc, rebuild_fraction=rec["rebuild_fraction"],
            h2d_bytes={f: v["h2d_bytes"] for f, v in fams.items()
                       if v["h2d_bytes"]},
            d2h_bytes={f: v["d2h_bytes"] for f, v in fams.items()
                       if v["d2h_bytes"]},
            considered=rec["considered"], matched=len(rec["matched"]),
            backend=rec["backend"], solve_shape=rec["solve_shape"])),
            flush=True)
    totals = dict(
        rank_s=sum(r["phases"].get("rank", 0.0) for r in records),
        # the simulator's own clock around rank_cycle, beside the records'
        phase_wall_rank_s=result.phase_wall_s.get("rank", 0.0),
        encode_s=sum(r["phases"].get("tensor_build", 0.0)
                     for r in records),
        submit_s=result.phase_wall_s.get("submit", 0.0),
        index_upkeep_s=probe.upkeep_s,
        node_hits=sum(c["node_hits"] for c in probe.cycles),
        row_hits=sum(c["row_hits"] for c in probe.cycles),
        row_misses=sum(c["row_misses"] for c in probe.cycles),
        health=result.health.get("status"),
        health_reasons=result.health.get("reasons"),
        data_plane={k: v for k, v in result.data_plane.items()
                    if k != "families"})
    print(f"{label} totals " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in totals.items()}), flush=True)
    return totals


def _slice_summary(label, sim, hosts, result, wall, launches,
                   device="cuda"):
    from cook_tpu_torch.sim import cli

    summary = cli.run_summary(result, sim.trace_jobs, hosts)
    matched = n_placed(result.rows)
    summary.update(matched=matched, launches=launches,
                   replay_wall_s=round(wall, 2),
                   cycle_wall_ms=[round(s * 1e3, 1)
                                  for s in result.cycle_wall_s])
    print(f"{label} " + json.dumps(summary), flush=True)
    if sim.scheduler.device.type != device:
        raise AssertionError(f"the {label} solved on "
                             f"{sim.scheduler.device}")
    if matched <= 0:
        raise AssertionError(f"the {label} placed no job")
    print(f"capacity ok on {check_capacity(sim)} busy hosts", flush=True)


def slice_phase(trace, workdir):
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import match
    from cook_tpu_torch.sim import cli

    phase("slice")
    args = cli.build_parser().parse_args(
        ["run", "--trace", trace, "--out", os.path.join(workdir, "run.csv"),
         "--device", "cuda", *SLICE_ARGS])
    probe = []
    start = []

    def attach(sim):
        # the default configuration's probe, and the replay's clock
        probe.append(CycleProbe(sim))
        start.append(time.perf_counter())

    calls = []
    with kept_calls(match, "best_node", calls):
        bn.launches = 0
        sim, hosts, result = cli.replay(args, on_sim=attach)
        wall = time.perf_counter() - start[0]
        launches = bn.launches
    # best_node counts only launches on CUDA tensors, so launches > 0 also
    # shows the solve's tensors were on the card
    _slice_summary("slice", sim, hosts, result, wall,
                   {"best_node": launches})
    totals = report_cycles("slice", result, probe[0])
    if launches <= 0 or len(calls) != launches:
        raise AssertionError(f"kept {len(calls)} best_node calls but the "
                             f"kernel counted {launches} launches")
    return launches, calls, _resident_view(result, totals)


PROFILE_TOP = 10


def _profile_rows(prof):
    """A cProfile's top PROFILE_TOP entries by cumulative time."""
    import io
    import pstats

    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(
        PROFILE_TOP)
    return [line.strip().replace(ROOT + os.sep, "")
            for line in out.getvalue().splitlines()
            if "(" in line and ":" in line]


def _profile_last(target, name, cycles, prof):
    """Swap `target.name` for a wrapper that runs its `cycles`-th call
    (the replay's last cycle) under `prof`; returns the original."""
    original = getattr(target, name)
    seen = []

    def profiled(*a, **kw):
        seen.append(None)
        if len(seen) < cycles:
            return original(*a, **kw)
        prof.enable()
        try:
            return original(*a, **kw)
        finally:
            prof.disable()

    setattr(target, name, profiled)
    return original


# the walls phase's replays of the flat slice: (label, SchedulerConfig
# changes, profiled).  A profiled pair first (cache off, then on: the
# last cycle's host profiles), then unprofiled runs for the walls: the
# cache off and on and the defaults with the flight recorder and the
# telemetry off (the data-plane accounting runs in the record's scope, so
# it goes too), twice each, interleaved, so host noise shows beside the
# differences (twice: the multi-pool phases need the time)
CACHE_OFF = dict(use_encode_cache=False)
RECORDER_OFF = dict(flight_recorder_capacity=0, device_telemetry=False)
WALL_RUNS = (("cache off", CACHE_OFF, True), ("cache on", {}, True),
             *((("cache off", CACHE_OFF, False), ("cache on", {}, False),
                ("recorder off", RECORDER_OFF, False)) * 2))
WALL_PHASES = ("rank", "encode", "solve", "launch")


def walls_phase(trace, workdir, device="cuda"):
    """Where the flat slice's walls go: the slice's replay again per
    WALL_RUNS, each run trace identical to the slice's (neither the cache
    nor the recorder changes a decision).  Per run: the simulator's phase
    walls, the cycle p50 and the encode wall per cycle.  The profiled
    runs print host profiles (cProfile) of the last cycle's
    `prepare_pool_problem` (cache off and on) and of the last
    `rank_cycle`, `finalize_pool_match` (the launch phase) and the flight
    recorder's `commit` (in the cycle wall, outside the phases; cache
    on);
    their walls carry the profiler's overhead, and the summary leaves
    them out.  Outside the slice's own run, so the profiler touches no
    wall reported for the main path."""
    import cProfile
    import dataclasses

    from cook_tpu_torch.scheduler import matcher
    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.sim.simulator import Simulator, load_trace

    phase("walls: encode cache on / off, recorder off")
    args = cli.build_parser().parse_args(
        ["run", "--trace", trace, "--device", device, *SLICE_ARGS])
    jobs, hosts = load_trace(trace)
    # newline="": the CSV's own \r\n line ends, as to_csv() gives them
    with open(os.path.join(workdir, "run.csv"), newline="") as f:
        want = f.read()
    walls = {}
    for label, changes, profile in WALL_RUNS:
        cfg = cli.sim_config(args)
        cfg.scheduler = dataclasses.replace(cfg.scheduler, **changes)
        sim = Simulator(jobs, hosts, cfg, device=args.device)
        targets = []
        if profile:
            targets.append((matcher, "prepare_pool_problem"))
            if label == "cache on":
                targets += [(sim.scheduler, "rank_cycle"),
                            (matcher, "finalize_pool_match"),
                            (sim.scheduler.recorder, "commit")]
        profs = []
        for target, name in targets:
            prof = cProfile.Profile()
            profs.append((target, name, prof, _profile_last(
                target, name, cfg.max_cycles, prof)))
        try:
            result = sim.run()
        finally:
            for target, name, _, original in profs:
                setattr(target, name, original)
        if result.to_csv() != want:
            raise AssertionError(f"{label}: the run trace differs from "
                                 "the slice's")
        row = {k: round(result.phase_wall_s.get(k, 0.0), 4)
               for k in WALL_PHASES}
        row["cycle_p50_ms"] = round(1e3 * sorted(
            result.cycle_wall_s)[len(result.cycle_wall_s) // 2], 2)
        row["cycle_ms"] = [round(1e3 * w, 1) for w in result.cycle_wall_s]
        row["encode_per_cycle"] = [
            round(r["phases"].get("tensor_build", 0.0), 4)
            for r in result.cycle_records]
        if not profile:
            walls.setdefault(label, []).append(row)
        print(f"walls {label}{' (profiled)' if profile else ''}: run "
              "trace = the slice's; " + json.dumps(row), flush=True)
        for _, name, prof, _ in profs:
            print(f"  {label}: the last cycle's {name} under cProfile "
                  f"(cumulative s, top {PROFILE_TOP}):", flush=True)
            for line in _profile_rows(prof):
                print(f"  {label} {name} | {line}", flush=True)
    print("walls summary (unprofiled runs) " + json.dumps({
        label: {k: [r[k] for r in rows]
                for k in (*WALL_PHASES, "cycle_p50_ms")}
        for label, rows in walls.items()}), flush=True)


def hier_slice_phase(trace, resident=False, quantized=False,
                     label="hier slice", device="cuda", match_args=None):
    """The hierarchical path on the flat slice's trace: every solve goes
    coarse (one coarse_pass launch) -> scatter -> fine (best_node_batched)
    -> refine; with `resident`, the problems come from the device-resident
    mirror (SimConfig.resident), and with `quantized` the cost tensors are
    bfloat16.  No host ends the run over its capacity (_slice_summary).
    Returns ({kernel:
    launches}, {kernel: kept calls}, the run's result, the simulator)."""
    from cook_tpu_torch.ops import best_block as bb
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp
    from cook_tpu_torch.ops import hierarchical
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator, load_trace
    from cook_tpu_torch.utils.config import default_match_config

    phase(label)
    jobs, hosts = load_trace(trace)
    match = default_match_config(**(match_args or HIER_MATCH),
                                 quantized=quantized)
    sim = Simulator(jobs, hosts, SimConfig(
        cycle_ms=30_000, max_cycles=3, resident=resident,
        scheduler=SchedulerConfig(match=match)), device=device)
    probe = CycleProbe(sim)
    calls = {"coarse_pass": [], "best_node_batched": []}
    solves = []
    solve = hierarchical.hierarchical_match

    def keep_stats(*args, **kwargs):
        out = solve(*args, **kwargs)
        solves.append(out[1])
        return out

    with kept_calls(hierarchical, "coarse_pass", calls["coarse_pass"]), \
            kept_calls(hierarchical, "best_node_batched",
                       calls["best_node_batched"]):
        hierarchical.hierarchical_match = keep_stats
        try:
            bn.launches = bb.launches = bnb.launches = cp.launches = 0
            t0 = time.perf_counter()
            result = sim.run()
            wall = time.perf_counter() - t0
            launches = {"best_node": bn.launches,
                        "best_block": bb.launches,
                        "best_node_batched": bnb.launches,
                        "coarse_pass": cp.launches}
        finally:
            hierarchical.hierarchical_match = solve
    _slice_summary(label, sim, hosts, result, wall, launches, device)
    report_cycles(label, result, probe)
    last = {k: solves[-1][k] for k in (
        "blocks", "block_pad", "nodes_per_block", "jobs_per_block",
        "fine_shape", "coarse_shape", "spilled", "refine_rounds",
        "refine_placed", "placed", "backend", "coarse_backend", "coarse_s",
        "fine_s", "refine_s")}
    print(f"{label}: {len(solves)} hierarchical solves; the last "
          + json.dumps(last), flush=True)
    walls = {k: sum(st[k] for st in solves)
             for k in ("coarse_s", "fine_s", "refine_s", "total_s")}
    print(f"{label}: solve walls summed over the solves (s) "
          + json.dumps(walls), flush=True)
    if len(solves) != result.cycles:
        raise AssertionError(f"{len(solves)} hierarchical solves in "
                             f"{result.cycles} cycles")
    # the coarse scoring runs inside coarse_pass: no best_block launch
    if launches["best_block"]:
        raise AssertionError(f"{launches['best_block']} best_block launches "
                             "on the hierarchical path")
    for name, kept in calls.items():
        if device == "cuda" and (launches[name] <= 0
                                 or len(kept) != launches[name]):
            raise AssertionError(f"kept {len(kept)} {name} calls but the "
                                 f"kernel counted {launches[name]} "
                                 "launches")
    return launches, calls, result, sim


DETERMINISM_RUNS = 5


def check_deterministic(name, args):
    """DETERMINISM_RUNS runs of the kernel on one launch's arguments must
    give bit-identical outputs: thread blocks finish in any order, and
    the combine must not depend on it."""
    import torch

    kernel = getattr(_module(name), name)
    first = [t.view(torch.int32) for t in kernel(*args)]
    for run in range(1, DETERMINISM_RUNS):
        again = [t.view(torch.int32) for t in kernel(*args)]
        if not all(torch.equal(a, b) for a, b in zip(first, again)):
            raise AssertionError(f"{name}: run {run} differs from run 0 "
                                 "on the same inputs")


def launch_phase(name, calls, active):
    """Every kept launch of `name` against the plain version; the times
    of the launch with the most jobs still unplaced (latest first).
    `active(args)` counts a call's unplaced jobs."""
    import torch

    phase(f"{name} launches")
    max_err = 0.0
    shapes = set()
    for i, args in enumerate(calls):
        _, err = check_identical(name, f"slice launch {i}", args)
        max_err = max(max_err, err)
        shapes.add(tuple(tuple(a.shape) for a in args
                         if isinstance(a, torch.Tensor)))
    counts = [active(a) for a in calls]
    pick = max(range(len(calls)), key=lambda i: (counts[i], i))
    torch.cuda.synchronize()
    check_deterministic(name, calls[pick])
    row = time_case(name, calls[pick])
    print(f"{name} slice launches: {len(calls)}/{len(calls)} identical "
          f"to the plain version; input shapes {sorted(shapes)}; launch "
          f"{pick} bit-identical over {DETERMINISM_RUNS} runs", flush=True)
    _print_row(name, f"slice launch {pick} ({counts[pick]} jobs unplaced)",
               row)
    return row, max_err, calls[pick]


def _coarse_live(args):
    """Jobs a coarse_pass call may route: active with a live row."""
    return int((_live(args[0]) & args[1]).sum())


def block_step_phase(args):
    """The standalone best_block on the first scoring step of a coarse
    pass (its first chunk's active rows, the others marked 2 BIG, against
    the starting availability: the call the plain version makes), held
    against its plain version, run 5 times bit-identical and timed."""
    import torch

    from cook_tpu_torch.ops.common import BIG

    phase("best_block step")
    demands, active, bsum, bmax, btot, valid, chunk = args[:7]
    d_eff = torch.where(active[:chunk, None], demands[:chunk], 2 * BIG)
    step = (d_eff.contiguous(), bsum, bmax, btot, valid)
    _, err = check_identical("best_block", "coarse step", step)
    check_deterministic("best_block", step)
    row = time_case("best_block", step)
    _print_row("best_block", f"first scoring step of the busiest coarse "
               f"pass ({_unplaced(step)} jobs live)", row)
    return row, err


def _unplaced(args):
    """Jobs a kernel call still scores: its live rows."""
    return int(_live(args[0]).sum())


def _replay_rows(trace, out, device, match, cycles):
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator, load_trace

    jobs, hosts = load_trace(trace)
    result = Simulator(jobs, hosts, SimConfig(
        max_cycles=cycles, scheduler=SchedulerConfig(match=match)),
        device=device).run()
    with open(out, "w") as f:
        f.write(result.to_csv())
    return cli.load_rows(out)


def agreement_phase(workdir, n_jobs=3000, n_hosts=300):
    """A small trace replayed on the card and on the CPU (whose path the
    CPU tests hold against the JAX reference) must give the same run
    trace, on the flat path and on the hierarchical path."""
    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.utils.config import default_match_config

    phase("agreement")
    trace = os.path.join(workdir, "small.json")
    cli.main(["synth", "--jobs", str(n_jobs), "--hosts", str(n_hosts),
              "--users", "50", "--submit-span-ms", "60000",
              "--out", trace])
    configs = {
        "flat": (dict(max_jobs_considered=16384, chunk=1024,
                      backend="pallas"), 6),
        "hier": ({**HIER_MATCH, "hierarchical_nodes_per_block": 64}, 6),
    }
    for label, (overrides, cycles) in configs.items():
        rows = {device: _replay_rows(
                    trace, os.path.join(workdir, f"{label}-{device}.csv"),
                    device, default_match_config(**overrides), cycles)
                for device in ("cuda", "cpu")}
        ok, diffs = cli.traces_equivalent(rows["cuda"], rows["cpu"])
        if not ok:
            raise AssertionError(f"{label}: card and CPU run traces "
                                 "differ:\n" + "\n".join(diffs))
        placed = sum(1 for r in rows["cuda"] if r["start_ms"])
        print(f"{label}: card and CPU traces equivalent ({placed} "
              "placements)", flush=True)


# ------------------------------------------------------- device residency

# the unchanged-pool rig: jobs that fill a host each (60 GB / 30 cpus on 64
# GB / 32 cpu hosts), all submitted at t 0 and running past the run, so
# every cycle after the first sees the same pool and the same waiting rows
RIG_JOBS = 16_384
RIG_HOSTS = 10_000
RIG_JOB = dict(mem=61_440.0, cpus=30.0, runtime_ms=10**9)
RIG_HOST = dict(mem=65_536.0, cpus=32.0)
RESIDENT_CYCLES = 3
# the encode families the mirror keeps resident (obs/data_plane.py)
ENCODE_FAMILIES = ("node-encode", "job-feasibility")


def n_placed(rows) -> int:
    """Jobs of a run's trace rows that started (at any time, t 0 too)."""
    return sum(1 for r in rows if r["start_ms"] is not None)


def _resident_view(result, totals):
    """What the resident phases compare a classic replay with: its run
    trace, placed jobs, per-cycle encode walls and H2D bytes by family,
    and its submit and encode totals."""
    return dict(
        csv=result.to_csv(),
        placed=[r["job_uuid"] for r in result.rows
                if r["start_ms"] is not None],
        encode=[r["phases"].get("tensor_build", 0.0)
                for r in result.cycle_records],
        h2d=[{f: v["h2d_bytes"] for f, v in r["data_plane"].items()
              if v["h2d_bytes"]} for r in result.cycle_records],
        submit_s=totals["submit_s"], encode_s=totals["encode_s"])


def _encode_h2d(record) -> int:
    """A cycle record's node-encode + job-feasibility H2D bytes."""
    fams = record["data_plane"]
    return sum(fams.get(f, {}).get("h2d_bytes", 0) for f in ENCODE_FAMILIES)


def _device_states(result):
    """Each cycle record's device_state, its wall rounded."""
    out = []
    for rec in result.cycle_records:
        ds = dict(rec.get("device_state") or {})
        if "update_s" in ds:
            ds["update_s"] = round(ds["update_s"], 4)
        out.append(ds)
    return out


def packing_weight(placed, jobs) -> float:
    """The placed jobs' demand weight, each resource over the trace's mean
    demand (the quality monitor's weighting): the packing ratio of two
    runs of one trace is the ratio of their weights."""
    by_uuid = {j.uuid: j for j in jobs}
    mem = sum(j.mem for j in jobs) / len(jobs)
    cpus = sum(j.cpus for j in jobs) / len(jobs)
    return sum(by_uuid[u].mem / mem + by_uuid[u].cpus / cpus
               for u in placed)


def hold_launches(name, calls, label):
    """Every kept launch of kernel `name` against its plain version, bit
    for bit.  Returns the max error."""
    err = 0.0
    for i, args in enumerate(calls):
        _, e = check_identical(name, f"{label} launch {i}", args)
        err = max(err, e)
    print(f"{label}: {len(calls)} {name} launches identical to the plain "
          "version", flush=True)
    return err


def _kept_best_node(run):
    """run() with every best_node call of the flat matcher kept and the
    launch count reset just before and read just after: (run's value,
    launches, calls)."""
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import match

    calls = []
    with kept_calls(match, "best_node", calls):
        bn.launches = 0
        out = run()
        launches = bn.launches
    return out, launches, calls


def _check_launches(label, launches, calls, device):
    """On the card: the kernel launched, once per kept call (the count
    proves the solve's tensors were on the card)."""
    if device == "cuda" and (launches <= 0 or len(calls) != launches):
        raise AssertionError(f"{label}: kept {len(calls)} best_node calls "
                             f"but the kernel counted {launches} launches")


def resident_slice_phase(trace, workdir, classic, device="cuda",
                         slice_args=SLICE_ARGS):
    """(a) The flat slice again with device residency on
    (`sim.cli run --resident`, SimConfig.resident): its run trace must be
    the classic replay's, the first cycle rebuilds `cold`; per cycle the
    device_state stats, the H2D bytes by family and the encode wall beside
    the classic run's, and the submit walls of both.  Returns (best_node
    launches, kept calls)."""
    from cook_tpu_torch.sim import cli

    phase("resident slice")
    args = cli.build_parser().parse_args(
        ["run", "--trace", trace, "--out",
         os.path.join(workdir, "resident.csv"), "--device", device,
         *slice_args, "--resident"])
    probe = []
    (sim, hosts, result), launches, calls = _kept_best_node(
        lambda: cli.replay(args, on_sim=lambda sim: probe.append(
            CycleProbe(sim))))
    if sim.scheduler.device_state is None or \
            sim.scheduler.device.type != device:
        raise AssertionError("resident slice: no resident state on the "
                             f"{device}")
    totals = report_cycles("resident slice", result, probe[0])
    if result.to_csv() != classic["csv"]:
        raise AssertionError("resident slice: the run trace differs from "
                             "the classic slice's")
    states = _device_states(result)
    built = [ds for ds in states if ds]
    if not built or built[0].get("reason") != "cold":
        raise AssertionError(f"resident slice: first build {built[:1]}")
    for i, (ds, rec) in enumerate(zip(states, result.cycle_records)):
        print("resident slice cycle " + json.dumps(dict(
            cycle=rec["cycle"], device_state=ds,
            h2d_bytes={f: v["h2d_bytes"] for f, v in
                       rec["data_plane"].items() if v["h2d_bytes"]},
            classic_h2d_bytes=classic["h2d"][i],
            encode_s=round(rec["phases"].get("tensor_build", 0.0), 4),
            classic_encode_s=round(classic["encode"][i], 4))), flush=True)
    print("resident slice: run trace = the classic slice's; " + json.dumps(
        dict(placed=n_placed(result.rows),
             launches=launches,
             submit_s=round(totals["submit_s"], 4),
             classic_submit_s=round(classic["submit_s"], 4),
             encode_s=round(totals["encode_s"], 4),
             classic_encode_s=round(classic["encode_s"], 4),
             device_state=result.data_plane["device_state"])), flush=True)
    _check_launches("resident slice", launches, calls, device)
    return launches, calls


def rig_trace(n_jobs=RIG_JOBS, n_hosts=RIG_HOSTS, pool="default",
              late=0):
    """The unchanged-pool rig's jobs and hosts (TraceJob / TraceHost of
    the port), all jobs submitted at t 0; `late` more at each of 30 s
    and 60 s."""
    from cook_tpu_torch.sim.simulator import TraceHost, TraceJob

    jobs = [TraceJob(uuid=f"{pool}-rig-{i:05d}", user=f"user{i % 50}",
                     submit_time_ms=0, pool=pool, **RIG_JOB)
            for i in range(n_jobs)]
    jobs += [TraceJob(uuid=f"{pool}-late-{t}-{i:03d}", user=f"user{i % 50}",
                      submit_time_ms=t, pool=pool, **RIG_JOB)
             for t in (30_000, 60_000) for i in range(late)]
    hosts = [TraceHost(node_id=f"{pool}-node-{i:05d}",
                       hostname=f"{pool}-host-{i:05d}", pool=pool,
                       **RIG_HOST) for i in range(n_hosts)]
    return jobs, hosts


def unchanged_pool_phase(device="cuda", n_jobs=RIG_JOBS, n_hosts=RIG_HOSTS,
                         match_overrides=None):
    """(b) The unchanged-pool rig at full width with residency on: 16,384
    jobs that fill a host each, 10,000 hosts, all submitted at t 0 and
    running past the run, 3 cycles on the slices' flat knobs.  Cycle 1
    rebuilds `cold`; cycles 2-3 report `rebuild` false and `delta_rows`
    0, and move <= 0.1x cycle 1's node-encode + feasibility H2D bytes.
    The rig again without residency: the same run trace, and its encode
    walls and bytes beside.  Returns (best_node launches, kept calls)."""
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator
    from cook_tpu_torch.utils.config import default_match_config

    phase("unchanged-pool rig")
    jobs, hosts = rig_trace(n_jobs, n_hosts)
    match = default_match_config(**{
        "max_jobs_considered": n_jobs, "chunk": 1024, "backend": "pallas",
        **(match_overrides or {})})

    def rig(resident):
        return Simulator(jobs, hosts, SimConfig(
            cycle_ms=30_000, max_cycles=RESIDENT_CYCLES, resident=resident,
            scheduler=SchedulerConfig(match=match)), device=device)

    sim = rig(True)
    t0 = time.perf_counter()
    result, launches, calls = _kept_best_node(sim.run)
    wall = time.perf_counter() - t0
    check_capacity(sim)
    classic = rig(False).run()
    if classic.to_csv() != result.to_csv():
        raise AssertionError("unchanged-pool rig: the resident run trace "
                             "differs from the classic one")
    states = _device_states(result)
    encode = [_encode_h2d(r) for r in result.cycle_records]
    for rec, ds, nbytes, crec in zip(result.cycle_records, states, encode,
                                     classic.cycle_records):
        print("unchanged-pool rig cycle " + json.dumps(dict(
            cycle=rec["cycle"], considered=rec["considered"],
            matched=len(rec["matched"]), device_state=ds,
            encode_h2d_bytes=nbytes, classic_encode_h2d_bytes=_encode_h2d(
                crec),
            h2d_bytes={f: v["h2d_bytes"] for f, v in
                       rec["data_plane"].items() if v["h2d_bytes"]},
            encode_s=round(rec["phases"].get("tensor_build", 0.0), 4),
            classic_encode_s=round(crec["phases"].get("tensor_build", 0.0),
                                   4))), flush=True)
    if len(states) != RESIDENT_CYCLES or states[0].get("reason") != "cold":
        raise AssertionError(f"unchanged-pool rig: {states}")
    for ds in states[1:]:
        if ds.get("rebuild") is not False or ds.get("delta_rows") != 0:
            raise AssertionError(f"unchanged-pool rig: warm cycle {ds}")
    ratios = [round(e / encode[0], 6) for e in encode[1:]]
    if any(r > 0.1 for r in ratios):
        raise AssertionError(f"unchanged-pool rig: warm / cold encode H2D "
                             f"{ratios} over 0.1")
    print(f"unchanged-pool rig: {n_jobs} jobs x {n_hosts} hosts, run trace "
          f"= the classic rig's; cycle 1 cold, cycles 2-3 warm with 0 delta "
          f"rows; warm / cold "
          f"node-encode + feasibility H2D {ratios}; "
          f"{n_placed(result.rows)} placed, "
          f"best_node launches {launches}, replay {wall:.1f} s", flush=True)
    _check_launches("unchanged-pool rig", launches, calls, device)
    return launches, calls


def quantized_slice_phase(trace, classic, device="cuda",
                          slice_args=SLICE_ARGS):
    """(c) The flat slice with `quantized` (bfloat16 cost tensors) and
    residency on: placements, the packing ratio against the float32 slice
    (the classic run), the demoted pools and each cycle's device_state.
    Returns (best_node launches, kept calls)."""
    import dataclasses

    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.sim.simulator import Simulator, load_trace

    phase("quantized slice")
    args = cli.build_parser().parse_args(
        ["run", "--trace", trace, "--device", device, *slice_args,
         "--resident"])
    cfg = cli.sim_config(args)
    cfg.scheduler = dataclasses.replace(
        cfg.scheduler, match=dataclasses.replace(cfg.scheduler.match,
                                                 quantized=True))
    jobs, hosts = load_trace(trace)
    sim = Simulator(jobs, hosts, cfg, device=device)
    t0 = time.perf_counter()
    result, launches, calls = _kept_best_node(sim.run)
    wall = time.perf_counter() - t0
    check_capacity(sim)
    states = _device_states(result)
    built = [ds for ds in states if ds]
    if not built or built[0].get("quantized") is not True:
        raise AssertionError(f"quantized slice: first build {built[:1]}")
    placed = [r["job_uuid"] for r in result.rows
              if r["start_ms"] is not None]
    ratio = packing_weight(placed, jobs) / packing_weight(classic["placed"],
                                                          jobs)
    print("quantized slice " + json.dumps(dict(
        placed=len(placed), f32_placed=len(classic["placed"]),
        packing_ratio_vs_f32=round(ratio, 6),
        trace_equals_f32=result.to_csv() == classic["csv"],
        demoted_pools=sim.scheduler.device_state.demoted_pools(),
        device_state=states, launches=launches,
        replay_s=round(wall, 1))), flush=True)
    _check_launches("quantized slice", launches, calls, device)
    return launches, calls


def resident_hier_phase(trace, classic_csv, classic_placed):
    """(c) The hierarchical slice with residency on: its run trace must be
    the classic hierarchical run's.  Returns ({kernel: launches},
    {kernel: kept calls})."""
    from cook_tpu_torch.sim.simulator import load_trace

    launches, calls, result, _ = hier_slice_phase(
        trace, resident=True, label="resident hier slice")
    if result.to_csv() != classic_csv:
        raise AssertionError("resident hier slice: the run trace differs "
                             "from the classic hierarchical run's")
    jobs, _ = load_trace(trace)
    placed = [r["job_uuid"] for r in result.rows
              if r["start_ms"] is not None]
    print("resident hier slice: run trace = the classic hierarchical "
          "run's; " + json.dumps(dict(
              placed=len(placed),
              packing_ratio_vs_classic=round(
                  packing_weight(placed, jobs)
                  / packing_weight(classic_placed, jobs), 6),
              device_state=_device_states(result))), flush=True)
    return launches, calls


def bf16_launches(calls) -> int:
    """Kept launches that took at least one bfloat16 tensor."""
    import torch

    return sum(1 for args in calls if any(
        isinstance(a, torch.Tensor) and a.dtype == torch.bfloat16
        for a in args))


def quantized_hier_phase(trace, classic_csv, classic_placed, device="cuda",
                         match_args=None):
    """(c) The hierarchical slice with residency and `quantized` on: its
    placements, the packing ratio against the float32 hierarchical run
    (the classic one), the demoted pools and each cycle's device_state;
    no host over its capacity (hier_slice_phase); bfloat16 cost tensors
    reach both kernels (the wrappers cast them at their boundary).
    Returns ({kernel: launches}, {kernel: kept calls})."""
    from cook_tpu_torch.sim.simulator import load_trace

    label = "quantized hier slice"
    launches, calls, result, sim = hier_slice_phase(
        trace, resident=True, quantized=True, label=label, device=device,
        match_args=match_args)
    states = _device_states(result)
    built = [ds for ds in states if ds]
    if not built or built[0].get("quantized") is not True:
        raise AssertionError(f"{label}: first build {built[:1]}")
    bf16 = {name: bf16_launches(kept) for name, kept in calls.items()}
    if not all(bf16.values()):
        raise AssertionError(f"{label}: launches with bfloat16 arguments "
                             f"{bf16}")
    jobs, _ = load_trace(trace)
    placed = [r["job_uuid"] for r in result.rows
              if r["start_ms"] is not None]
    print(f"{label} " + json.dumps(dict(
        placed=len(placed), f32_placed=len(classic_placed),
        packing_ratio_vs_f32=round(
            packing_weight(placed, jobs)
            / packing_weight(classic_placed, jobs), 6),
        trace_equals_f32=result.to_csv() == classic_csv,
        demoted_pools=sim.scheduler.device_state.demoted_pools(),
        device_state=states, launches=launches,
        bf16_launches=bf16)), flush=True)
    return launches, calls


def resident_default_agreement_phase(workdir, devices=("cuda", "cpu")):
    """(d) The 3,000 x 300 default-config replay with residency and
    `quantized` on, on the card and on the CPU: run traces and every
    cycle record's decision fields (the device_state stats among them,
    their wall aside) equal; and the run trace equal to the card's replay
    with `quantized` alone (no residency)."""
    import dataclasses

    from cook_tpu_torch.sim.simulator import load_trace
    from cook_tpu_torch.utils.config import default_match_config

    phase("resident default-config agreement")
    jobs, hosts = load_trace(os.path.join(workdir, "small.json"))
    quantized = default_match_config(**DEFAULT_AGREEMENT["flat"][0],
                                     quantized=True)
    resident = dataclasses.replace(quantized, device_residency=True)

    def decisions(result):
        out = []
        for rec in result.cycle_records:
            rec = record_decisions(rec)
            rec["device_state"] = {k: v for k, v in
                                   rec["device_state"].items()
                                   if k != "update_s"}
            out.append(rec)
        return out

    runs = {}
    for device in devices:
        sim, result = default_replay(jobs, hosts, resident, device)
        runs[device] = (result, sim.scheduler.device_state.demoted_pools())
    (card, card_demoted), (cpu, cpu_demoted) = (runs[d] for d in devices)
    if card.to_csv() != cpu.to_csv() or decisions(card) != decisions(cpu):
        raise AssertionError("resident default agreement: card and CPU "
                             "differ (run trace or cycle records)")
    if card_demoted != cpu_demoted:
        raise AssertionError(f"resident default agreement: demoted pools "
                             f"card {card_demoted} CPU {cpu_demoted}")
    _, classic = default_replay(jobs, hosts, quantized, devices[0])
    if classic.to_csv() != card.to_csv():
        raise AssertionError("resident default agreement: the resident "
                             "replay's run trace differs from the replay "
                             "without residency")
    print("resident default agreement: card = CPU (run trace, "
          f"{len(card.cycle_records)} cycle records) = the replay without "
          "residency; " + json.dumps(dict(
              placed=n_placed(card.rows),
              demoted_pools=card_demoted,
              device_state=card.data_plane["device_state"],
              reasons=[r["device_state"].get("reason")
                       for r in card.cycle_records],
              quantized=[r["device_state"].get("quantized")
                         for r in card.cycle_records])), flush=True)


# ------------------------------------------------ the default configuration

# the default-config agreement replays: the small trace, 6 cycles, the
# default SchedulerConfig with a shadow solve every solvable cycle and a
# health verdict every cycle
DEFAULT_CYCLES = 6
DEFAULT_AGREEMENT = {
    # label: (matcher overrides, the final verdict's reasons).  The flat
    # `pallas` route at the CPU parity tests' knobs
    # (tests/test_torch_sim.py CONFIGS["pallas"]): its shadow solves hold
    # the reference's packing, so the verdict is ok
    "flat": (dict(max_jobs_considered=16384, chunk=16, backend="pallas",
                  chunk_rounds=2, chunk_passes=12), []),
    "hier": ({**HIER_MATCH, "hierarchical_nodes_per_block": 64}, []),
    # the slices' flat knobs (chunk 1024, the tuned rounds and passes):
    # the reference drifts below its parity floor on this trace too
    # (tests/test_torch_sim.py::test_slices_flat_knobs_drift_in_the_
    # reference_too), so the verdict is quality-drift
    "flat-tuned": (dict(max_jobs_considered=16384, chunk=1024,
                        backend="pallas"), ["quality-drift"]),
}
# wall-clock fields of a cycle record: compared for presence only
RECORD_WALLS = ("wall_time", "device_s", "host_s", "total_s")


def record_decisions(record):
    """A cycle record without its walls: every decision field (counts,
    skips, matches, backend, padded shape, gang and hierarchical
    accounting, data-plane bytes), and the phase names."""
    out = {k: v for k, v in record.items()
           if k not in RECORD_WALLS and k not in ("phases", "hier_phases")}
    out["phases"] = sorted(record["phases"])
    out["hier_phases"] = sorted(record["hier_phases"])
    return out


def default_replay(jobs, hosts, match, device, **scheduler_kw):
    """A replay of `jobs` at the default SchedulerConfig (plus
    `scheduler_kw`), a shadow solve every solvable cycle and a health
    verdict every cycle.  Returns (simulator, result)."""
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(jobs, hosts, SimConfig(
        max_cycles=DEFAULT_CYCLES, health_every=1,
        scheduler=SchedulerConfig(match=match, quality_sample_every=1,
                                  **scheduler_kw)), device=device)
    return sim, sim.run()


def default_agreement_phase(workdir, devices=("cuda", "cpu")):
    """The small trace at the port's default SchedulerConfig on the card
    and on the CPU, on the flat `pallas` and the hierarchical routes (and
    the flat route at the slices' knobs): run traces equal, every cycle
    record's decision fields equal, at least one shadow solve on each
    device, no verdict ever `device-degraded`, and the final verdict's
    reasons the reference's (DEFAULT_AGREEMENT)."""
    from cook_tpu_torch.obs.health import DEVICE_DEGRADED
    from cook_tpu_torch.sim.simulator import load_trace
    from cook_tpu_torch.utils.config import default_match_config

    phase("default-config agreement")
    jobs, hosts = load_trace(os.path.join(workdir, "small.json"))
    for label, (overrides, reasons) in DEFAULT_AGREEMENT.items():
        runs = {}
        for device in devices:
            t0 = time.perf_counter()
            sim, result = default_replay(
                jobs, hosts, default_match_config(**overrides), device)
            quality = sim.scheduler.telemetry.quality.stats().get(
                "default", {})
            runs[device] = (result, quality, time.perf_counter() - t0)
        (card, card_q, card_s), (cpu, cpu_q, cpu_s) = (
            runs[d] for d in devices)
        if card.to_csv() != cpu.to_csv():
            raise AssertionError(f"default agreement {label}: card and "
                                 "CPU run traces differ")
        if [record_decisions(r) for r in card.cycle_records] != [
                record_decisions(r) for r in cpu.cycle_records]:
            raise AssertionError(f"default agreement {label}: card and "
                                 "CPU cycle records differ")
        for name, result, quality in (("card", card, card_q),
                                      ("CPU", cpu, cpu_q)):
            if quality.get("samples", 0) < 1:
                raise AssertionError(f"default agreement {label}: no "
                                     f"shadow solve on the {name}")
            verdicts = [c["reasons"] for c in result.health_checks]
            if any(DEVICE_DEGRADED in r for r in verdicts
                   + [result.health["reasons"]]):
                raise AssertionError(f"default agreement {label}: "
                                     f"{DEVICE_DEGRADED} on the {name}")
        if not card.health["reasons"] == cpu.health["reasons"] == reasons:
            raise AssertionError(
                f"default agreement {label}: verdicts card "
                f"{card.health['reasons']} CPU {cpu.health['reasons']}")
        print(f"default agreement {label}: card = CPU (run trace, "
              f"{len(card.cycle_records)} cycle records); shadow solves "
              f"card {card_q['samples']} / CPU {cpu_q['samples']}, last "
              f"efficiency {card_q['last']}; final verdict "
              f"{card.health['status']} {card.health['reasons']}, in-run "
              f"reasons {[c['reasons'] for c in card.health_checks]}; "
              f"placements {n_placed(card.rows)}; "
              f"replay walls card {card_s:.1f} s, CPU {cpu_s:.1f} s",
              flush=True)


def cache_neutrality_phase(workdir, device="cuda"):
    """On the card, the flat default-agreement replay with the encode
    cache on, off and on again: three identical run traces (the cache
    changes no decision, and a run with it is repeatable)."""
    from cook_tpu_torch.sim.simulator import load_trace
    from cook_tpu_torch.utils.config import default_match_config

    phase("cache neutrality")
    jobs, hosts = load_trace(os.path.join(workdir, "small.json"))
    match = default_match_config(**DEFAULT_AGREEMENT["flat"][0])
    csvs = []
    for use in (True, False, True):
        sim, result = default_replay(jobs, hosts, match, device,
                                     use_encode_cache=use)
        if use != (sim.scheduler.encode_cache is not None):
            raise AssertionError("cache neutrality: the cache setting did "
                                 "not reach the scheduler")
        csvs.append(result.to_csv())
    if len(set(csvs)) != 1:
        raise AssertionError("cache neutrality: run traces differ with "
                             "the encode cache on / off / on again")
    print(f"cache neutrality: cache on, off, on again: identical run "
          f"traces ({csvs[0].count(chr(10)) - 1} rows)", flush=True)


# ----------------------------------------------------------------- gangs

GANG_CYCLES = 3
GANG_REASONS = ("members-missing", "no-block-capacity", "transact-failed")


def gang_counts():
    """The `gang.*` counters of the default pool: considered, placed, and
    blocked by reason (deltas around a run are that run's)."""
    from cook_tpu_torch.utils.metrics import global_registry

    pool = {"pool": "default"}
    out = {"considered": global_registry.counter("gang.considered")
           .value(pool),
           "placed": global_registry.counter("gang.placed").value(pool)}
    for reason in GANG_REASONS:
        out["blocked " + reason] = global_registry.counter(
            "gang.blocked").value({**pool, "reason": reason})
    return out


def check_gangs(sim, npb):
    """Every gang in the store launched whole or not at all: all members'
    first runs started in one cycle, on distinct hosts, inside one block of
    `npb` hosts (the sorted hostnames, the matcher's node order).  Raises
    on a violation; returns (gangs launched, gangs not launched)."""
    index = {h: i for i, h in enumerate(sorted(
        host.hostname for host in sim.cluster.hosts.values()))}
    members: dict[str, list] = {}
    for job in sim.store.jobs.values():
        if job.gang_size >= 2 and job.group_uuid:
            members.setdefault(job.group_uuid, []).append(job)
    launched = waiting = 0
    for group, jobs in members.items():
        firsts = [min(insts, key=lambda i: i.start_time_ms)
                  for insts in (sim.store.job_instances(j.uuid)
                                for j in jobs) if insts]
        if not firsts:
            waiting += 1
            continue
        hosts = [i.hostname for i in firsts]
        k = jobs[0].gang_size
        if (len(jobs) != k or len(firsts) != k
                or len({i.start_time_ms for i in firsts}) != 1
                or len(set(hosts)) != k
                or len({index[h] // npb for h in hosts}) != 1):
            raise AssertionError(
                f"gang {group} (size {k}, {len(jobs)} members) launched "
                f"{len(firsts)} members at {sorted({i.start_time_ms for i in firsts})} "
                f"on {sorted(hosts)}")
        launched += 1
    return launched, waiting


def gang_sim(jobs, hosts, match, device, cycles, npb, **sim_kw):
    """A Simulator on the gang trace whose every match cycle is followed
    by check_gangs and check_capacity.  Returns (simulator, checks: per
    cycle (gangs launched, not launched))."""
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(jobs, hosts, SimConfig(
        cycle_ms=30_000, max_cycles=cycles, **sim_kw,
        scheduler=SchedulerConfig(match=match)), device=device)
    checks = []
    s = sim.scheduler
    match_cycle = s.match_cycle

    def checked(pool):
        out = match_cycle(pool)
        checks.append(check_gangs(sim, npb))
        check_capacity(sim)
        return out

    s.match_cycle = checked
    return sim, checks


def gang_slice_phase(trace, device="cuda"):
    """The gang slice at full width: the slices' 100k x 10k trace with
    every tenth job a gang member (gang_mix), 3 cycles on the card on the
    flat route (chunked `best_node`, blocks of 1024 hosts bound) and on the
    hierarchical one (HIER_MATCH: the gangs force its coarse pass to
    `xla`, fine passes on `best_node_batched`).  After every cycle no
    gang is partly launched, each launched gang sits on distinct hosts in
    one block, no host is over capacity; counts reset just before each run
    and read just after; every kernel call kept.  Returns {run: ({kernel:
    launches}, {kernel: kept calls})}.  The tests run it on the CPU at a
    small `trace` (where the wrappers launch nothing)."""
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp
    from cook_tpu_torch.ops import hierarchical, match
    from cook_tpu_torch.sim.simulator import load_trace
    from cook_tpu_torch.utils.config import default_match_config

    phase("gang slice")
    t0 = time.perf_counter()
    jobs, hosts = load_trace(trace)
    jobs = gang_mix(jobs)
    gangs = len({j.gang for j in jobs if j.gang})
    print(f"gang slice: {len(jobs)} jobs x {len(hosts)} hosts, "
          f"{sum(1 for j in jobs if j.gang)} members in {gangs} gangs "
          f"(sizes {GANG_SIZES}) in {time.perf_counter() - t0:.1f} s",
          flush=True)
    runs = {"flat": (default_match_config(**GANG_FLAT_MATCH),
                     GANG_FLAT_MATCH["topology_block_hosts"],
                     (match, "best_node")),
            "hier": (default_match_config(**HIER_MATCH), 1024,
                     (hierarchical, "best_node_batched"))}
    out = {}
    filters, releases = [], []
    for label, (cfg, npb, (module, name)) in runs.items():
        sim, checks = gang_sim(jobs, hosts, cfg, device, GANG_CYCLES, npb)
        probe = CycleProbe(sim)
        calls = []
        solves = []
        solve = hierarchical.hierarchical_match

        def keep_stats(*args, **kwargs):
            res = solve(*args, **kwargs)
            solves.append(res[1])
            return res

        before = gang_counts()
        with kept_calls(module, name, calls), \
                kept_kw_calls(hierarchical, "gang_filter", filters), \
                kept_kw_calls(hierarchical, "release_assignments", releases):
            hierarchical.hierarchical_match = keep_stats
            try:
                bn.launches = bnb.launches = cp.launches = 0
                t0 = time.perf_counter()
                result = sim.run()
                wall = time.perf_counter() - t0
                launches = {"best_node": bn.launches,
                            "best_node_batched": bnb.launches,
                            "coarse_pass": cp.launches}
            finally:
                hierarchical.hierarchical_match = solve
        counts = {k: v - before[k] for k, v in gang_counts().items()}
        placed = n_placed(result.rows)
        summary = dict(
            placements=placed, gangs_launched_per_cycle=[c[0] for c in checks],
            gang_counts=counts, launches=launches, replay_wall_s=round(wall, 2),
            phase_wall_s={k: round(v, 4)
                          for k, v in result.phase_wall_s.items()},
            cycle_wall_ms=[round(w * 1e3, 1) for w in result.cycle_wall_s])
        if solves:
            summary["hier_gangs"] = [st.get("gangs") for st in solves]
            summary["coarse_backend"] = sorted({st["coarse_backend"]
                                                for st in solves})
        print(f"gang slice {label} " + json.dumps(summary), flush=True)
        report_cycles(f"gang slice {label}", result, probe)
        if sim.scheduler.device.type != device or placed <= 0:
            raise AssertionError(f"gang slice {label}: solved on "
                                 f"{sim.scheduler.device}, {placed} placed")
        if len(checks) != GANG_CYCLES or checks[-1][0] <= 0:
            raise AssertionError(f"gang slice {label}: gangs launched per "
                                 f"cycle {checks}")
        if counts["considered"] <= 0 or counts["placed"] != checks[-1][0]:
            raise AssertionError(f"gang slice {label}: gang counters "
                                 f"{counts} against {checks}")
        # the wrappers count launches on the card only
        if device == "cuda" and (launches[name] <= 0
                                 or len(calls) != launches[name]):
            raise AssertionError(f"gang slice {label}: kept {len(calls)} "
                                 f"{name} calls, {launches[name]} launches")
        # a cycle whose window holds gangs runs its coarse passes on xla
        # (a cycle before any gang arrives keeps the coarse_pass kernel)
        with_gangs = [st for st in solves if "gangs" in st]
        if label == "hier" and (
                len(solves) != result.cycles or not with_gangs
                or {st["coarse_backend"] for st in with_gangs} != {"xla"}):
            raise AssertionError("gang slice hier: the gangs must force "
                                 "the coarse pass to xla")
        out[label] = (launches, {name: calls}, summary)
        del sim, result
    if not filters or not releases:
        raise AssertionError(f"gang slice: {len(filters)} gang_filter and "
                             f"{len(releases)} release calls kept")
    out["ops"] = (filters, releases)
    return out


@contextlib.contextmanager
def kept_kw_calls(module, name, calls):
    """kept_calls for a function called with keywords: (args, kwargs) of
    every call of `module.name` while the block runs."""
    original = getattr(module, name)

    def keep(*args, **kwargs):
        calls.append((args, kwargs))
        return original(*args, **kwargs)

    setattr(module, name, keep)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def gang_ops_phase(filters, releases, device="cuda"):
    """ops/gang's torch code on the card against its numpy twins: every
    `gang_filter` and `release_assignments` call the hierarchical gang run
    made (`filters`, `releases`: kept (args, kwargs)), and a fuzz of all
    three functions, `block_free_hosts` included.  Identical results (the
    released sums are exact)."""
    import numpy as np
    import torch

    from cook_tpu_torch.ops import gang

    phase("gang ops")

    def check_filter(args, kwargs, label):
        got_a, got_s = gang.gang_filter(*args, **kwargs)
        want_a, want_s = gang.np_gang_filter(
            *(a.cpu().numpy() for a in args), kwargs["nodes_per_block"])
        if not (np.array_equal(got_a.cpu().numpy(), want_a)
                and np.array_equal(got_s.cpu().numpy(), want_s)):
            raise AssertionError(f"gang_filter {label} differs from "
                                 "np_gang_filter")

    def check_release(args, label):
        avail, demands, asg, mask = (a.cpu().numpy() for a in args)
        want = avail.copy()
        np.add.at(want, asg[mask], demands[mask])
        got = gang.release_assignments(*args).cpu().numpy()
        if not np.array_equal(got, want):
            raise AssertionError(f"release_assignments {label} differs "
                                 "from its numpy sum")

    for i, (args, kwargs) in enumerate(filters):
        check_filter(args, kwargs, f"slice call {i}")
    for i, (args, _) in enumerate(releases):
        check_release(args, f"slice call {i}")
    rng = np.random.default_rng(7)
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    for t in range(50):
        j, n, g = 4096, 2048, 256
        gang_id = rng.integers(-1, g, j).astype(np.int32)
        need = np.where(gang_id >= 0, rng.integers(2, 17, j), 0) \
            .astype(np.int32)
        asg = np.where(rng.uniform(size=j) < 0.8, rng.integers(0, n, j),
                       -1).astype(np.int32)
        npb = (0, 64, 256, 1024)[t % 4]
        check_filter((put(asg), put(gang_id), put(need)),
                     dict(num_gangs=g, num_nodes=n, nodes_per_block=npb),
                     f"fuzz {t}")
        avail = (rng.integers(0, 128, (n, 4)) * 512.0).astype(np.float32)
        demands = (rng.integers(1, 16, (j, 4)) * 0.5).astype(np.float32)
        check_release((put(avail), put(demands), put(asg),
                       put((asg >= 0) & (rng.uniform(size=j) < 0.5))),
                      f"fuzz {t}")
        valid = rng.uniform(size=n) < 0.9
        member = demands[t]
        got = gang.block_free_hosts(put(avail), put(valid), put(member),
                                    nodes_per_block=max(npb, 64))
        want = gang.np_block_free_hosts(avail, valid, member, max(npb, 64))
        if not np.array_equal(got.cpu().numpy(), want):
            raise AssertionError(f"block_free_hosts fuzz {t} differs")
    print(f"gang ops: {len(filters)} gang_filter and {len(releases)} "
          "release_assignments calls of the hierarchical gang run, and 50 "
          "fuzz draws of each function, identical to the numpy twins",
          flush=True)


def gang_launches_phase(label, calls):
    """Every kept launch of a gang run held against the plain version."""
    phase(f"gang {label} launches")
    max_err = 0.0
    for name, kept in calls.items():
        for i, args in enumerate(kept):
            _, err = check_identical(name, f"gang {label} launch {i}", args)
            max_err = max(max_err, err)
        print(f"gang slice {label}: {len(kept)}/{len(kept)} {name} launches "
              "identical to the plain version", flush=True)
    return max_err


def gang_agreement_phase(workdir, n_jobs=3000, n_hosts=300,
                         devices=("cuda", "cpu")):
    """The gang mix on the small agreement trace, flat and hierarchical,
    and `gang_topology_trace(n_blocks=4, block_hosts=8, ...)` for 60
    cycles, each on the card and on the CPU: run traces and gang_stats
    identical, every cycle checked as in the gang slice."""
    from cook_tpu_torch.scheduler.matcher import MatchConfig
    from cook_tpu_torch.sim.loadgen import gang_topology_trace
    from cook_tpu_torch.sim.simulator import load_trace
    from cook_tpu_torch.utils.config import default_match_config

    phase("gang agreement")
    trace = os.path.join(workdir, "small.json")
    if not os.path.exists(trace):
        from cook_tpu_torch.sim import cli

        cli.main(["synth", "--jobs", str(n_jobs), "--hosts", str(n_hosts),
                  "--users", "50", "--submit-span-ms", "60000",
                  "--out", trace])
    small_jobs, small_hosts = load_trace(trace)
    small_jobs = gang_mix(small_jobs)
    topo = gang_topology_trace(n_blocks=4, block_hosts=8,
                               gang_sizes=(8, 8, 4, 4, 2, 2))
    cases = {
        "flat": (small_jobs, small_hosts, default_match_config(
            **{**GANG_FLAT_MATCH, "topology_block_hosts": 64}), 6, 64),
        "hier": (small_jobs, small_hosts, default_match_config(
            **{**HIER_MATCH, "hierarchical_nodes_per_block": 64}), 6, 64),
        "topology": (*topo, MatchConfig(topology_block_hosts=8,
                                        topology_weight=0.5), 60, 8),
    }
    for label, (jobs, hosts, match, cycles, npb) in cases.items():
        card, cpu = (gang_sim(jobs, hosts, match, device, cycles, npb)
                     for device in devices)
        got = [(sim.run(), checks) for sim, checks in (card, cpu)]
        if got[0][0].to_csv() != got[1][0].to_csv():
            raise AssertionError(f"gang agreement {label}: card and CPU "
                                 "run traces differ")
        stats = got[0][0].gang_stats(jobs, hosts, nodes_per_block=npb)
        if stats != got[1][0].gang_stats(jobs, hosts, nodes_per_block=npb):
            raise AssertionError(f"gang agreement {label}: gang_stats "
                                 "differ")
        launched = got[0][1][-1][0]
        if launched <= 0:
            raise AssertionError(f"gang agreement {label}: no gang launched")
        print(f"gang agreement {label}: card = CPU (run trace, gang_stats: "
              f"{stats['gangs']} gangs, {stats['assembled']} assembled, "
              f"wait p50 {stats['wait_ms_p50']} ms, mean block spread "
              f"{stats['mean_block_spread']}); {launched} gangs launched",
              flush=True)


def gang_admission_replay(device, n_hosts=64, block_hosts=8, gang_size=8):
    """tests/test_gang.py:346's fleet rig scaled up: occupants of the
    gang's own user fill every one of `n_hosts` hosts (so the DRU
    rebalancer stays quiet), a gang of `gang_size` whole hosts waits; one
    rebalance cycle (admission), then one match.  Returns what admission
    did: its decisions, the instances' states and reasons, and the host
    reservations after the rebalance and after the match, with the
    gang's hosts."""
    from cook_tpu_torch.cluster.mock import MockCluster, MockHost
    from cook_tpu_torch.models import entities as e
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
    from cook_tpu_torch.scheduler.matcher import MatchConfig

    now = [1_000_000]

    def clock():
        return now[0]

    store = JobStore(clock=clock)
    store.set_pool(e.Pool(name="default"))
    names = [f"h{i:03d}" for i in range(n_hosts)]
    cluster = MockCluster("m", [
        MockHost(node_id=h, hostname=h, mem=1000.0, cpus=8.0,
                 attributes=(("slot", h),)) for h in names], clock=clock)
    sched = Scheduler(store, [cluster], SchedulerConfig(match=MatchConfig(
        topology_block_hosts=block_hosts)), device=device)
    pool = store.pools["default"]
    store.submit_jobs([e.Job(
        uuid=f"occ-{h}", user="ganguser", pool="default", priority=100,
        command="true", expected_runtime_ms=60_000,
        resources=e.Resources(mem=900.0, cpus=1.0),
        constraints=(e.JobConstraint("slot", e.ConstraintOperator.EQUALS,
                                     h),)) for h in names])
    sched.rank_cycle(pool)
    if len(sched.match_cycle(pool).matched) != n_hosts:
        raise AssertionError("admission rig: the occupants did not start")
    now[0] += 30_000
    store.submit_jobs(
        [e.Job(uuid=f"gang-m{i}", user="ganguser", pool="default",
               command="true", resources=e.Resources(mem=900.0, cpus=1.0),
               group_uuid="g-adm", gang_size=gang_size)
         for i in range(gang_size)],
        [e.Group(uuid="g-adm", host_placement=e.HostPlacement(
            type=e.GroupPlacementType.UNIQUE))])
    sched.rank_cycle(pool)
    sched.rebalance_cycle(pool)
    view = {"admissions": sched.last_gang_admissions,
            "reservations_after_rebalance": sorted(
                sched.host_reservations.items())}
    sched.rank_cycle(pool)
    sched.match_cycle(pool)
    view["reservations_after_match"] = sorted(sched.host_reservations.items())
    view["instances"] = sorted((i.task_id, i.hostname, i.status.value,
                                i.reason_code)
                               for i in store.instances.values())
    view["gang_hosts"] = sorted(
        i.hostname for j in store.groups["g-adm"].job_uuids
        for i in store.job_instances(j))
    return view


def gang_admission_phase(devices=("cuda", "cpu")):
    """The admission replay on the card and on the CPU: admissions, kills
    and gang: reservations identical; one block's hosts freed, reserved
    and taken by the whole gang, the reservations then released."""
    phase("gang admission")
    card, cpu = (gang_admission_replay(d) for d in devices)
    if card != cpu:
        raise AssertionError("gang admission: card and CPU differ")
    [adm] = card["admissions"]
    hosts = card["gang_hosts"]
    killed = [i for i in card["instances"]
              if i[3] is not None and i[2] == "failed"]
    if (adm["mode"] != "preempt" or len(hosts) != 8 or len(set(hosts)) != 8
            or len({int(h[1:]) // 8 for h in hosts}) != 1
            or card["reservations_after_match"]
            or {t for _, t in card["reservations_after_rebalance"]}
            != {"gang:g-adm"}):
        raise AssertionError(f"gang admission: {json.dumps(card)}")
    print(f"gang admission: card = CPU; {adm['mode']} block {adm['block']}, "
          f"{len(adm['victims'])} victims killed ({len(killed)} failed "
          f"instances), {len(card['reservations_after_rebalance'])} hosts "
          f"reserved gang:g-adm, gang placed whole on {hosts}, reservations "
          "released", flush=True)


# ------------------------------------------------------------ multi-pool

# the multi-pool slice, BASELINE configurations 3 ("multi-pool bin-packing,
# cpu+mem+gpu constraints") and 5 ("8-pool batched solve ... 100k x 10k"):
# 8 pools, 100,000 jobs x 10,000 hosts in all, each pool its own
# synth_trace (own seed, 50 users, 64 GB / 32 cpu hosts, submits over
# 60 s): (name, jobs, hosts, DRU mode)
MP_POOLS = (("alpha", 30_000, 3_000, "default"),) + tuple(
    (f"pool{k}", 10_000, 1_000, "gpu" if k == 7 else "default")
    for k in range(1, 8))
# the GPU column (bench.py:532-545): a tenth of the jobs ask for 1-3 gpus,
# a fifth of the hosts carry 8, drawn from MP_GPU_SEED
MP_GPU_SEED = 5
MP_CYCLES = 3
# the slices' knobs (chunk 1024, tuned rounds / passes / kc, `pallas`,
# 16,384 considerable jobs); the hierarchical threshold 2^25 lies between
# the small pools' padded 16384 x 1024 (2^24) and alpha's 16384 x 4096
# (2^26), so alpha takes the two-level path (both backends `pallas`,
# blocks of 1024 hosts) once its window passes 8192 jobs, and the small
# pools stay flat
MP_MATCH = dict(max_jobs_considered=16384, chunk=1024, backend="pallas",
                hierarchical_threshold=1 << 25,
                hierarchical_coarse_backend="pallas",
                hierarchical_fine_backend="pallas",
                hierarchical_nodes_per_block=1024)
MP_ROUTES = ("serial", "batched", "pipelined")
MP_KERNELS = {"best_node": ("match", "best_node"),
              "coarse_pass": ("hierarchical", "coarse_pass"),
              "best_node_batched": ("hierarchical", "best_node_batched")}
# the multi-pool agreement replays: 4 pools x 300 jobs x 30 hosts, the
# last in DruMode.GPU, 6 cycles
MP_AGREE_POOLS = tuple((f"pool{k}", 300, 30, "gpu" if k == 3 else "default")
                       for k in range(4))
MP_AGREE_CYCLES = 6


def multipool_trace(pools=MP_POOLS):
    """(jobs, hosts, SimConfig pools) of the multi-pool slice: one
    synth_trace per pool (seed = its index), uuids and node ids made unique
    across pools (tests/test_multipool.py:260-290), and the GPU column."""
    import numpy as np

    from cook_tpu_torch.sim.simulator import synth_trace

    rng = np.random.default_rng(MP_GPU_SEED)
    jobs, hosts = [], []
    for k, (name, n_jobs, n_hosts, _) in enumerate(pools):
        pjobs, phosts = synth_trace(n_jobs, n_hosts, n_users=50, seed=k,
                                    submit_span_ms=60_000, pool=name)
        gpu_job = rng.uniform(size=n_jobs) < 0.1
        gpus = rng.integers(1, 4, n_jobs)
        gpu_host = rng.uniform(size=n_hosts) < 0.2
        for i, j in enumerate(pjobs):
            j.uuid = f"{name}-{j.uuid}"
            if gpu_job[i]:
                j.gpus = float(gpus[i])
        for i, h in enumerate(phosts):
            h.node_id = f"{name}-{h.node_id}"
            h.hostname = f"{name}-{h.hostname}"
            if gpu_host[i]:
                h.gpus = 8.0
        jobs += pjobs
        hosts += phosts
    return jobs, hosts, tuple((name, mode) for name, _, _, mode in pools)


class RouteProbe:
    """Per cycle of a multi-pool replay: the rank wall, the match
    passes' walls (the outcomes' encode / solve / launch: on the batched
    pass the shared stack and solve count once, on the pipelined pass
    each pool's solve spans its overlap) and a capacity check after every
    match call (each pool's on the serial route, each pass on the
    others)."""

    def __init__(self, sim):
        self.sim = sim
        self.cycles = {}
        s = sim.scheduler
        rank, match, match_all = (s.rank_cycle, s.match_cycle,
                                  s.match_cycle_all_pools)

        def cycle():
            return self.cycles.setdefault(sim.now_ms, dict(
                rank_s=0.0, encode_s=0.0, solve_s=0.0, launch_s=0.0,
                match_s=0.0))

        def note(outcomes, wall):
            c = cycle()
            c["match_s"] += wall
            for out in outcomes:
                for key in ("encode", "solve", "launch"):
                    c[f"{key}_s"] += out.phase_wall_s.get(key, 0.0)
            check_capacity(sim)

        def ranked(pool):
            t0 = time.perf_counter()
            out = rank(pool)
            cycle()["rank_s"] += time.perf_counter() - t0
            return out

        def matched(pool):
            t0 = time.perf_counter()
            out = match(pool)
            note([out], time.perf_counter() - t0)
            return out

        def matched_all():
            t0 = time.perf_counter()
            out = match_all()
            note(out.values(), time.perf_counter() - t0)
            return out

        s.rank_cycle, s.match_cycle = ranked, matched
        s.match_cycle_all_pools = matched_all


@contextlib.contextmanager
def kept_results(module, name, calls):
    """kept_kw_calls that also keeps each call's result: (args, kwargs,
    result)."""
    original = getattr(module, name)

    def keep(*args, **kwargs):
        out = original(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    setattr(module, name, keep)
    try:
        yield calls
    finally:
        setattr(module, name, original)


def multipool_sim(jobs, hosts, pools, match, device, route, cycles,
                  resident=False):
    """A Simulator on the multi-pool trace driving `route`: the serial
    per-pool loop, the pool-batched pass (`SimConfig.batched_match`), or
    the pipelined pass on the same store, clusters and clock steps (the
    Simulator's batched loop, its pass swapped for
    `Scheduler.match_cycle_pipelined`: the reference's Simulator has no
    pipelined knob, and bench.py:576-657 drives it so); `resident` turns
    device residency on (SimConfig.resident)."""
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(jobs, hosts, SimConfig(
        cycle_ms=30_000, max_cycles=cycles, pools=pools,
        batched_match=route != "serial", resident=resident,
        scheduler=SchedulerConfig(match=match)), device=device)
    if route == "pipelined":
        sim.scheduler.match_cycle_all_pools = \
            sim.scheduler.match_cycle_pipelined
    return sim, RouteProbe(sim)


def _records_by_cycle(records):
    out = {}
    for rec in records:
        out.setdefault(rec["t_ms"], []).append(rec)
    return [out[t] for t in sorted(out)]


def _solve_shape(rec):
    return tuple(int(x) for x in rec["solve_shape"].split("x"))


def check_multipool_records(label, result, threshold, big="alpha"):
    """No `solve-failed` skip; every flat pool's padded problem under the
    threshold; `big` on the two-level path whenever its padded problem
    reaches it (at least once).  Returns the cycles in which `big` went
    two-level."""
    hier_cycles = 0
    for rec in result.cycle_records:
        failed = [s for s in rec["skipped"] if s["code"] == "solve-failed"]
        if failed:
            raise AssertionError(f"{label}: {len(failed)} solve-failed "
                                 f"skips in pool {rec['pool']}")
        if not rec["solve_shape"]:
            continue
        hier = rec["backend"].startswith("hier-")
        if rec["pool"] == big:
            hier_cycles += hier
        elif hier:
            raise AssertionError(f"{label}: pool {rec['pool']} took the "
                                 "two-level path")
    if big is not None and not hier_cycles:
        raise AssertionError(f"{label}: {big} never took the two-level "
                             "path")
    return hier_cycles


def multipool_phase(device="cuda", pools=MP_POOLS, cycles=MP_CYCLES,
                    match_overrides=None, serial_csv=None):
    """The multi-pool slice at full width (8 pools, 100k x 10k): routes
    serial, batched and pipelined, `cycles` cycles each at the default
    SchedulerConfig, counts reset just before each route and read just
    after, every kernel call kept.  Checks: capacity after every match;
    pipelined placements equal the serial ones cycle by cycle; no
    solve-failed skip; alpha two-level on every route once its window
    reaches the threshold, the other pools flat; each batched stacked flat
    problem solved again lane by lane with `chunked_match` on `xla`,
    identical.  Returns ({kernel: launches over the routes}, {kernel:
    kept calls}, (jobs, hosts, SimConfig pools) of the trace), and appends
    the serial route's run trace to `serial_csv` when given.  The tests
    run it on the CPU at small `pools`."""
    import torch

    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp
    from cook_tpu_torch.ops import hierarchical, match as match_ops
    from cook_tpu_torch.scheduler import matcher
    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.utils.config import default_match_config

    phase("multipool")
    t0 = time.perf_counter()
    jobs, hosts, sim_pools = multipool_trace(pools)
    print(f"multipool: {len(jobs)} jobs x {len(hosts)} hosts in "
          f"{len(pools)} pools " + json.dumps(
              {name: [n_jobs, n_hosts, mode]
               for name, n_jobs, n_hosts, mode in pools})
          + f", {sum(1 for j in jobs if j.gpus)} gpu jobs, "
          f"{sum(1 for h in hosts if h.gpus)} gpu hosts, built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    overrides = {**MP_MATCH, **(match_overrides or {})}
    cfg = default_match_config(**overrides)
    modules = {"match": match_ops, "hierarchical": hierarchical}
    launches = {name: 0 for name in MP_KERNELS}
    calls = {name: [] for name in MP_KERNELS}
    results, stacked = {}, []
    for route in MP_ROUTES:
        sim, probe = multipool_sim(jobs, hosts, sim_pools, cfg, device,
                                   route, cycles)
        with contextlib.ExitStack() as stack:
            for name, (mod, fn) in MP_KERNELS.items():
                stack.enter_context(kept_calls(modules[mod], fn,
                                               calls[name]))
            if route == "batched":
                stack.enter_context(kept_results(
                    matcher, "chunked_match_pools", stacked))
            bn.launches = bnb.launches = cp.launches = 0
            t0 = time.perf_counter()
            result = sim.run()
            wall = time.perf_counter() - t0
            counts = {"best_node": bn.launches,
                      "best_node_batched": bnb.launches,
                      "coarse_pass": cp.launches}
        for name in launches:
            launches[name] += counts[name]
        placed = n_placed(result.rows)
        hier_cycles = check_multipool_records(
            f"multipool {route}", result, overrides["hierarchical_threshold"])
        by_cycle = _records_by_cycle(result.cycle_records)
        summary = dict(
            placements=placed, launches=counts,
            replay_wall_s=round(wall, 2), alpha_two_level_cycles=hier_cycles,
            phase_wall_s={k: round(v, 4)
                          for k, v in result.phase_wall_s.items()},
            cycle_wall_ms=[round(w * 1e3, 1) for w in result.cycle_wall_s],
            h2d_bytes={f: v["h2d_bytes"]
                       for f, v in result.data_plane["families"].items()
                       if v["h2d_bytes"]})
        print(f"multipool {route} " + json.dumps(summary), flush=True)
        for k, (t_ms, walls) in enumerate(sorted(probe.cycles.items())):
            recs = by_cycle[k]
            line = {key: round(v, 4) for key, v in walls.items()}
            line["placed"] = sum(len(r["matched"]) for r in recs)
            line["backends"] = {r["pool"]: r["backend"] for r in recs}
            flat = [r for r in recs if r["solve_shape"]
                    and not r["backend"].startswith("hier-")]
            # the flat solves: the serial route's sum over pools, the
            # batched route's one shared wall
            line["flat_solve_s"] = round(
                max((r["phases"].get("solve", 0.0) for r in flat),
                    default=0.0) if route == "batched"
                else sum(r["phases"].get("solve", 0.0) for r in flat), 4)
            if route == "pipelined":
                line["pipeline_wall_s"] = round(recs[0]["pipeline_wall_s"],
                                                4)
                line["overlap_fraction"] = round(
                    recs[0]["overlap_fraction"], 4)
            print(f"multipool {route} cycle {k + 1} (t {t_ms} ms) "
                  + json.dumps(line), flush=True)
        if sim.scheduler.device.type != device or placed <= 0:
            raise AssertionError(f"multipool {route}: solved on "
                                 f"{sim.scheduler.device}, {placed} placed")
        if len(probe.cycles) != cycles:
            raise AssertionError(f"multipool {route}: {len(probe.cycles)} "
                                 f"probed cycles of {cycles}")
        results[route] = result
        del sim, probe
    # pipelined placements equal serial ones, cycle by cycle (start_ms is
    # the cycle's clock)
    ok, diffs = cli.traces_equivalent(results["serial"].rows,
                                      results["pipelined"].rows)
    if not ok or results["serial"].to_csv() != results["pipelined"].to_csv():
        raise AssertionError("multipool: pipelined run trace differs from "
                             "the serial one:\n" + "\n".join(diffs))
    print("multipool: pipelined run trace identical to the serial one",
          flush=True)
    if serial_csv is not None:
        serial_csv.append(results["serial"].to_csv())
    # the batched pass's flat lanes against the per-pool xla solve
    if not stacked or any(kw.get("use_pallas") for _, kw, _ in stacked):
        raise AssertionError(f"multipool: {len(stacked)} batched solves "
                             "kept, or one on the best_node backend")
    lanes = 0
    for i, (args, kwargs, out) in enumerate(stacked):
        problem = args[0]
        for p in range(problem.demands.shape[0]):
            lane = match_ops.chunked_match(match_ops.MatchProblem(
                *(None if t is None else t[p] for t in problem)), **kwargs)
            if not (torch.equal(lane.assignment, out.assignment[p])
                    and torch.equal(lane.new_avail.view(torch.int32),
                                    out.new_avail[p].view(torch.int32))):
                raise AssertionError(f"multipool batched solve {i} lane {p}"
                                     " differs from its per-pool solve")
            lanes += 1
    print(f"multipool batched: {lanes} lanes of {len(stacked)} stacked "
          "solves identical to the per-pool xla chunked_match", flush=True)
    if device == "cuda":
        for name in MP_KERNELS:
            if launches[name] <= 0 or len(calls[name]) != launches[name]:
                raise AssertionError(f"multipool: kept {len(calls[name])} "
                                     f"{name} calls, {launches[name]} "
                                     "launches")
    print("multipool launches " + json.dumps(launches), flush=True)
    return launches, calls, (jobs, hosts, sim_pools)


def resident_multipool_phase(jobs, hosts, pools, serial_csv,
                             device="cuda", cycles=MP_CYCLES,
                             match_overrides=None):
    """The multi-pool slice's serial and pipelined routes again with
    device residency on: each pool's mirror is written in place on one
    pipelined stage's CUDA stream and read on a later one's, so the
    pipelined run trace must equal the resident serial one, and both the
    classic serial one (`serial_csv`).  Counts reset just before each
    route and read just after, every kernel call kept.  Returns ({kernel:
    launches over the two routes}, {kernel: kept calls})."""
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp
    from cook_tpu_torch.ops import hierarchical, match as match_ops
    from cook_tpu_torch.utils.config import default_match_config

    phase("resident multipool")
    cfg = default_match_config(**{**MP_MATCH, **(match_overrides or {})})
    modules = {"match": match_ops, "hierarchical": hierarchical}
    launches = {name: 0 for name in MP_KERNELS}
    calls = {name: [] for name in MP_KERNELS}
    csvs = {}
    for route in ("serial", "pipelined"):
        sim, _ = multipool_sim(jobs, hosts, pools, cfg, device, route,
                               cycles, resident=True)
        with contextlib.ExitStack() as stack:
            for name, (mod, fn) in MP_KERNELS.items():
                stack.enter_context(kept_calls(modules[mod], fn,
                                               calls[name]))
            bn.launches = bnb.launches = cp.launches = 0
            t0 = time.perf_counter()
            result = sim.run()
            wall = time.perf_counter() - t0
        counts = {"best_node": bn.launches,
                  "best_node_batched": bnb.launches,
                  "coarse_pass": cp.launches}
        for name in launches:
            launches[name] += counts[name]
        if sim.scheduler.device_state is None:
            raise AssertionError(f"resident multipool {route}: no "
                                 "resident state")
        csvs[route] = result.to_csv()
        states = {}
        for rec in result.cycle_records:
            ds = rec.get("device_state") or {}
            states.setdefault(rec["pool"], []).append(
                (ds.get("reason"), ds.get("delta_rows")) if ds else None)
        print(f"resident multipool {route} " + json.dumps(dict(
            placements=n_placed(result.rows),
            launches=counts, replay_wall_s=round(wall, 2),
            phase_wall_s={k: round(v, 4)
                          for k, v in result.phase_wall_s.items()},
            device_state=result.data_plane["device_state"],
            per_pool=states)), flush=True)
        del sim
    if not csvs["serial"] == csvs["pipelined"] == serial_csv:
        raise AssertionError("resident multipool: the resident serial, "
                             "resident pipelined and classic serial run "
                             "traces differ")
    if device == "cuda":
        for name in MP_KERNELS:
            if launches[name] <= 0 or len(calls[name]) != launches[name]:
                raise AssertionError(f"resident multipool: kept "
                                     f"{len(calls[name])} {name} calls, "
                                     f"{launches[name]} launches")
    print("resident multipool: pipelined = serial = the classic serial run "
          "trace; launches " + json.dumps(launches), flush=True)
    return launches, calls


def resident_streams_phase(device="cuda", n_pools=8, jobs_per_pool=1900,
                           hosts_per_pool=1250, late=64):
    """Delta scatters across pipelined streams: the unchanged-pool rig as
    8 pools (1,900 jobs x 1,250 hosts each, 10,000 hosts in all), with 64
    more jobs a pool at 30 s and at 60 s, so every pool's cycles 2-3 are
    warm delta updates (no rebuild, 64 new rows) written in place on one
    stage's CUDA stream into buffers the previous cycle's stage read on
    another.  Serial and pipelined routes with residency on, and serial
    without: equal run traces.  Returns (best_node launches, kept
    calls)."""
    from cook_tpu_torch.utils.config import default_match_config

    phase("resident streams")
    jobs, hosts = [], []
    for p in range(n_pools):
        j, h = rig_trace(jobs_per_pool, hosts_per_pool, pool=f"rig{p}",
                         late=late)
        jobs += j
        hosts += h
    pools = tuple((f"rig{p}", "default") for p in range(n_pools))
    match = default_match_config(max_jobs_considered=16384, chunk=1024,
                                 backend="pallas")
    csvs, launches, calls = {}, 0, []
    for route, resident in (("serial", False), ("serial", True),
                            ("pipelined", True)):
        sim, _ = multipool_sim(jobs, hosts, pools, match, device, route,
                               RESIDENT_CYCLES, resident=resident)
        result, n, kept = _kept_best_node(sim.run)
        check_capacity(sim)
        csvs[route, resident] = result.to_csv()
        if not resident:
            continue
        launches += n
        calls += kept
        states = [r["device_state"] for r in result.cycle_records]
        warm = [ds for ds in states if ds and not ds["rebuild"]]
        if len(warm) != (RESIDENT_CYCLES - 1) * n_pools or any(
                ds["delta_rows"] != late for ds in warm):
            raise AssertionError(f"resident streams {route}: warm cycles "
                                 f"{warm}")
        print(f"resident streams {route}: " + json.dumps(dict(
            placed=n_placed(result.rows),
            launches=n, device_state=result.data_plane["device_state"])),
            flush=True)
    if len(set(csvs.values())) != 1:
        raise AssertionError("resident streams: run traces differ between "
                             "the resident serial, resident pipelined and "
                             "classic serial routes")
    print(f"resident streams: {n_pools} pools, every warm cycle a "
          f"{late}-row delta on each route; pipelined = serial = the "
          "classic serial run trace", flush=True)
    _check_launches("resident streams", launches, calls, device)
    return launches, calls


def device_update_phase(device="cuda", reps=20):
    """The in-place updaters on the card against the CPU: a padded delta
    (5 rows, padded to the 8-row bucket by repeating the last pair, which
    `index_copy_` may land in any order) into bool, bfloat16 and float32
    buffers, and the gathers, `reps` times each, equal to the CPU's; and
    a gather queued on one stream, then a scatter on a second stream that
    waits for it, reads the buffer as it was before the scatter."""
    import numpy as np
    import torch

    from cook_tpu_torch.ops import device_update as du

    phase("device update")
    rng = np.random.default_rng(0)
    idx = np.array([3, 9, 1, 12, 7], dtype=np.int32)
    cases = {
        "feasibility": (torch.bool, rng.uniform(size=(5, 16384)) > 0.5),
        "bf16 demands": (torch.bfloat16, rng.uniform(0, 9e3, (5, 4))),
        "f32 demands": (torch.float32, rng.uniform(0, 9e3, (5, 4))),
    }
    perm = torch.tensor([12, 3, 16, 9, 0, 16, 7, 1], dtype=torch.int32)
    for label, (dtype, rows) in cases.items():
        host = torch.as_tensor(rows).to(dtype)
        want = torch.zeros((17,) + host.shape[1:], dtype=dtype)
        du.scatter_rows(want, idx, host)
        want_g = du.gather_rows(want, perm)
        for _ in range(reps):
            buf = torch.zeros_like(want, device=device)
            du.scatter_rows(buf, idx, host)
            got_g = du.gather_rows(buf, perm.to(device))
            if not (torch.equal(buf.cpu(), want)
                    and torch.equal(got_g.cpu(), want_g)):
                raise AssertionError(f"device update {label}: the card's "
                                     "buffer differs from the CPU's")
    if device == "cuda":
        buf = torch.zeros((17, 16384), dtype=torch.bool, device=device)
        first, second = torch.cuda.Stream(), torch.cuda.Stream()
        first.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(first):
            before = du.gather_rows(buf, perm.to(device))
        second.wait_stream(first)
        with torch.cuda.stream(second):
            du.scatter_rows(buf, idx, np.ones((5, 16384), dtype=bool))
        torch.cuda.current_stream().wait_stream(second)
        if bool(before.any()) or not bool(buf[idx.tolist()].all()):
            raise AssertionError("device update: the cross-stream order "
                                 "did not hold")
    print(f"device update: padded scatters and gathers on the {device} "
          f"equal the CPU's over {reps} repeats (bool, bfloat16, float32)"
          "; a gather on one stream ordered before a scatter on another",
          flush=True)


def multipool_exact_phase(jobs, hosts, pools, device="cuda", big="alpha"):
    """(d): one cycle at chunk 0 (the exact greedy) on the flat pools
    (every pool but `big`), their jobs all submitted at t 0 so that the
    cycle holds a full window: the batched pass (`greedy_match_pools`,
    one step places a job row of every pool) against the serial route (a
    `greedy_match` per pool).  Run traces identical; both solve walls
    printed."""
    import dataclasses

    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.utils.config import default_match_config

    phase("multipool exact")
    flat_jobs = [dataclasses.replace(j, submit_time_ms=0) for j in jobs
                 if j.pool != big]
    flat_hosts = [h for h in hosts if h.pool != big]
    flat_pools = tuple(p for p in pools if p[0] != big)
    cfg = default_match_config(**{**MP_MATCH, "chunk": 0})
    rows, walls = {}, {}
    for route in ("serial", "batched"):
        sim, probe = multipool_sim(flat_jobs, flat_hosts, flat_pools, cfg,
                                   device, route, 1)
        t0 = time.perf_counter()
        result = sim.run()
        wall = time.perf_counter() - t0
        check_multipool_records(f"multipool exact {route}", result, 1 << 62,
                                big=None)
        [walls[route]] = probe.cycles.values()
        walls[route]["replay_s"] = wall
        rows[route] = result.rows
        shapes = sorted({r["solve_shape"] for r in result.cycle_records})
        print(f"multipool exact {route} " + json.dumps(dict(
            placements=sum(1 for r in result.rows
                           if r["start_ms"] is not None),
            solve_shapes=shapes,
            **{k: round(v, 4) for k, v in walls[route].items()})),
            flush=True)
        del sim, probe
    ok, diffs = cli.traces_equivalent(rows["serial"], rows["batched"])
    if not ok:
        raise AssertionError("multipool exact: batched differs from "
                             "serial:\n" + "\n".join(diffs))
    print(f"multipool exact: batched solve {walls['batched']['solve_s']:.4f}"
          f" s against the serial solves' {walls['serial']['solve_s']:.4f} s"
          f" ({len(flat_pools)} pools), run traces identical", flush=True)
    return walls


def multipool_launches_phase(calls):
    """Every kernel launch of the multi-pool routes held against its plain
    version, bit for bit."""
    phase("multipool launches")
    max_err = {}
    for name, kept in calls.items():
        err = 0.0
        for i, args in enumerate(kept):
            _, e = check_identical(name, f"multipool launch {i}", args)
            err = max(err, e)
        max_err[name] = err
        print(f"multipool: {len(kept)}/{len(kept)} {name} launches "
              "identical to the plain version", flush=True)
    return max_err


def multipool_agreement_phase(devices=("cuda", "cpu"),
                              pools=MP_AGREE_POOLS, cycles=MP_AGREE_CYCLES):
    """The small multi-pool trace (4 pools x 300 jobs x 30 hosts, one in
    DruMode.GPU) on the batched and pipelined routes, on the card and on
    the CPU: run traces identical, and pipelined = serial on the CPU."""
    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.utils.config import default_match_config

    phase("multipool agreement")
    jobs, hosts, sim_pools = multipool_trace(pools)
    cfg = default_match_config(**MP_MATCH)
    rows = {}
    for route in ("batched", "pipelined", "serial"):
        for device in devices if route != "serial" else devices[-1:]:
            sim, _ = multipool_sim(jobs, hosts, sim_pools, cfg, device,
                                   route, cycles)
            result = sim.run()
            check_multipool_records(f"multipool agreement {route}", result,
                                    1 << 62, big=None)
            rows[route, device] = result.rows
    for route in ("batched", "pipelined"):
        ok, diffs = cli.traces_equivalent(rows[route, devices[0]],
                                          rows[route, devices[-1]])
        if not ok:
            raise AssertionError(f"multipool agreement {route}: card and "
                                 "CPU differ:\n" + "\n".join(diffs))
        placed = sum(1 for r in rows[route, devices[0]]
                     if r["start_ms"] is not None)
        print(f"multipool agreement {route}: {devices[0]} and "
              f"{devices[-1]} run traces identical ({placed} placements)",
              flush=True)
    ok, diffs = cli.traces_equivalent(rows["pipelined", devices[-1]],
                                      rows["serial", devices[-1]])
    if not ok:
        raise AssertionError("multipool agreement: pipelined differs from "
                             "serial:\n" + "\n".join(diffs))


# ------------------------------------------------------------- rebalance

# the victim search at the rebalance slice's padded shape, had every job
# of the 100k x 10k trace been running: bucket_size(100,000 tasks + 100
# slack rows) x bucket_size(10,000 hosts), R 4 (mem, cpus, gpus, disk)
REB_T, REB_H = 131072, 16384
REB_TASKS, REB_HOSTS = 100_000, 10_000
# kinds of make_rebalance_inputs:
#   victims    no host's spare covers the demand: the decision takes a
#              prefix of one host's tasks (often several)
#   spare tie  every 7th host's spare covers it: those hosts all score BIG,
#              and the first of them must win
#   none       a demand no spare and no prefix covers: host -1
#   quota      eligibility cut to 10% of the rows, as an over-quota user's
#              own tasks cut it
REBALANCE_CASES = ("victims", "spare tie", "none", "quota")
# the rebalance slice: sim.loadgen.preemption_heavy_trace at 100,000 jobs
# x 10,000 hosts (the hog's 20,000 half-host jobs fill the fleet at t=0;
# 80,000 late jobs of 49 users arrive at 60 s), the default share 1/500 of
# the fleet, RebalancerParams() defaults, the exact greedy (chunk 0) over
# 16384 considerable jobs, a rebalance after every match, 6 cycles of 30 s
REB_TRACE = dict(hosts=10_000, host_mem=65_536, host_cpus=32,
                 hog_jobs=20_000, late_jobs=80_000, n_late_users=49,
                 runtime_ms=600_000, late_arrival_ms=60_000, seed=0)
REB_CYCLES = 6
# the rebalance agreement's flat `pallas` matcher (tests/test_torch_sim.py
# CONFIGS["pallas"]): chunks of 16 fill a uniform fleet in one cycle
REB_PALLAS = dict(max_jobs_considered=16384, chunk=16, backend="pallas",
                  chunk_rounds=2, chunk_passes=12)


def make_rebalance_inputs(t, h, kind, device, seed=0):
    """(RebalanceState, demand, pending_dru, safe_dru_threshold,
    min_dru_diff) for one REBALANCE_CASES kind at T task rows x H hosts:
    the slice's share of live rows (100,000 of 131072) on its share of real
    hosts (10,000 of 16384), the rest padded as RebalanceCycle pads them
    (host -1, ineligible; zero spare, host_ok False).  Exact-sum: MB in
    multiples of 512, cpus in halves, whole gpus, so every order of
    summing gives the same float32 prefix sums."""
    import numpy as np
    import torch

    from cook_tpu_torch.ops.rebalance import RebalanceState, as_scalar

    rng = np.random.default_rng(seed)
    tasks = max(1, t * REB_TASKS // REB_T)
    hosts = max(1, h * REB_HOSTS // REB_H)
    host = np.full(t, -1, np.int32)
    host[:tasks] = rng.integers(0, hosts, tasks)
    res = np.zeros((t, 4), np.float32)
    res[:tasks, 0] = rng.integers(1, 17, tasks) * 512
    res[:tasks, 1] = rng.integers(1, 17, tasks) * 0.5
    res[:tasks, 2] = rng.uniform(size=tasks) < 0.0625
    dru = np.zeros(t, np.float32)
    dru[:tasks] = rng.uniform(0.0, 5.0, tasks)
    elig = np.zeros(t, bool)
    elig[:tasks] = rng.uniform(size=tasks) > 0.1
    spare = np.zeros((h, 4), np.float32)
    spare[:hosts, 0] = rng.integers(0, 16, hosts) * 512
    spare[:hosts, 1] = rng.integers(0, 8, hosts) * 0.5
    host_ok = np.zeros(h, bool)
    host_ok[:hosts] = rng.uniform(size=hosts) > 0.05
    demand = np.float32([16384, 8, 0, 0])
    if kind == "spare tie":
        spare[:hosts:7] = [65536, 32, 8, 100_000]
    elif kind == "none":
        demand[0] = 1e9
    elif kind == "quota":
        elig &= rng.uniform(size=t) < 0.1
    state = RebalanceState(*_put((host, dru, res, elig, spare, host_ok),
                                 device))
    return (state, torch.as_tensor(demand, device=device),
            as_scalar(0.4, device), as_scalar(1.0, device),
            as_scalar(0.5, device))


def decide_sorted(state, demand, pending_dru, safe_dru_threshold,
                  min_dru_diff):
    """The fast cycle's decision on the same inputs: sort once
    (sort_rebalance_state), decide in sorted space (decide_from_sorted),
    and map the preempt mask back to row order."""
    import torch

    from cook_tpu_torch.ops.rebalance import (decide_from_sorted,
                                              sort_rebalance_state)

    ss = sort_rebalance_state(state.task_host, state.task_dru,
                              state.task_res, state.task_eligible)
    d = decide_from_sorted(ss, state.task_eligible[ss.perm],
                           state.task_dru[ss.perm], state.spare,
                           state.host_ok, demand, pending_dru,
                           safe_dru_threshold, min_dru_diff)
    mask = torch.zeros_like(d.preempt_mask)
    mask[ss.perm] = d.preempt_mask
    return d._replace(preempt_mask=mask)


def _to_device(args, device):
    """A decision's arguments (a RebalanceState, then tensors) moved to
    `device`."""
    state = type(args[0])(*(t.to(device) for t in args[0]))
    return (state, *(a.to(device) for a in args[1:]))


def same_decision(label, got, want):
    """Two fetched PreemptionDecisions: host, score (bitwise), mask and
    freed (bitwise) identical, or raise."""
    import numpy as np

    for field in ("host", "score", "preempt_mask", "freed"):
        a, b = getattr(got, field), getattr(want, field)
        if a.dtype.kind == "f":
            a, b = a.view(np.int32), b.view(np.int32)
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"rebalance {label}: {field} differs "
                                 f"({getattr(got, field)!r:.200} vs "
                                 f"{getattr(want, field)!r:.200})")


def rebalance_bound(state, demand, *_scalars):
    """(bound_ms, bound_by) of one decision: its inputs read once and the
    preempt mask written once, against ~(8 + 3R) operations a row (the
    mask, the sort keys, the prefix sums and their test) with the sort's
    compares not counted."""
    t, r = state.task_res.shape
    h = state.spare.shape[0]
    nbytes = t * (4 + 4 + 4 * r + 1) + h * (4 * r + 1) + t
    return _bound(nbytes, t * (8 + 3 * r))


def rebalance_case_phase():
    """Every REBALANCE_CASES kind at REB_T x REB_H, on the card against
    the same port functions on the CPU, for the exact search and the
    sort-once pair; the sort-once pair equals the exact search there; times
    of one decision of each kind, cold and warm, and of the sort."""
    import numpy as np
    import torch

    from cook_tpu_torch.ops.common import BIG, fetch_result
    from cook_tpu_torch.ops.rebalance import (decide_from_sorted,
                                              find_preemption_decision,
                                              sort_rebalance_state)

    phase("rebalance cases")
    cuda = torch.device("cuda")
    big = np.float32(BIG)
    rows = {}
    for kind in REBALANCE_CASES:
        args = make_rebalance_inputs(REB_T, REB_H, kind, cuda)
        cpu_args = _to_device(args, "cpu")
        found = {}
        for name, fn in (("exact", find_preemption_decision),
                         ("sorted", decide_sorted)):
            got = fetch_result(fn(*args))
            same_decision(f"{kind} {name} card vs CPU", got,
                          fetch_result(fn(*cpu_args)))
            found[name] = got
        same_decision(f"{kind} sorted vs exact", found["sorted"],
                      found["exact"])
        d = found["exact"]
        host, mask = int(d.host), d.preempt_mask
        state = fetch_result(args[0])
        demand = fetch_result(args[1])
        ok_fit = state.host_ok & (state.spare >= demand).all(-1)
        if kind == "spare tie":
            # the first index among the BIG ties, as jnp.argmax picks it
            if host != int(np.argmax(ok_fit)) or d.score != big or mask.any():
                raise AssertionError(f"rebalance spare tie: host {host} "
                                     f"score {d.score}, expected the first "
                                     f"spare-fitting host {np.argmax(ok_fit)}")
        elif kind == "none":
            if host != -1 or mask.any():
                raise AssertionError("rebalance none: a decision was found")
        elif host < 0 or not mask.any() or ok_fit.any():
            raise AssertionError(f"rebalance {kind}: expected victims, got "
                                 f"host {host}, {int(mask.sum())} victims")
        if mask.any() and not (state.task_eligible[mask].all()
                               and (state.task_host[mask] == host).all()):
            raise AssertionError(f"rebalance {kind}: a victim is "
                                 "ineligible or on another host")
        exact_ms = cuda_ms(lambda: find_preemption_decision(*args), cold=True)
        exact_warm = cuda_ms(lambda: find_preemption_decision(*args))
        st = args[0]
        sort_ms = cuda_ms(lambda: sort_rebalance_state(
            st.task_host, st.task_dru, st.task_res, st.task_eligible),
            cold=True)
        ss = sort_rebalance_state(st.task_host, st.task_dru, st.task_res,
                                  st.task_eligible)
        row_ok, dru_s = st.task_eligible[ss.perm], st.task_dru[ss.perm]

        def fast():
            return decide_from_sorted(ss, row_ok, dru_s, st.spare,
                                      st.host_ok, *args[1:])

        fast_ms = cuda_ms(fast, cold=True)
        fast_warm = cuda_ms(fast)
        bound_ms, bound_by = rebalance_bound(*args)
        rows[kind] = dict(host=host, victims=int(mask.sum()),
                          exact_ms=exact_ms, exact_warm_ms=exact_warm,
                          sort_ms=sort_ms, decide_sorted_ms=fast_ms,
                          decide_sorted_warm_ms=fast_warm,
                          bound_ms=bound_ms, bound_by=bound_by)
        print(f"rebalance {kind} {REB_T}x{REB_H}: card = CPU (exact and "
              f"sorted; sorted = exact), host {host}, "
              f"{int(mask.sum())} victims; find_preemption_decision "
              f"{exact_ms:.4f} ms cold {exact_warm:.4f} ms warm; "
              f"decide_from_sorted {fast_ms:.4f} ms cold {fast_warm:.4f} "
              f"ms warm; bound {bound_ms:.4g} ms ({bound_by})", flush=True)
        print(f"rebalance {kind}: the sort (sort_rebalance_state) "
              f"{sort_ms:.4f} ms cold, {sort_ms / exact_ms:.1%} of one "
              "exact decision", flush=True)
        del args, cpu_args, ss
    print("rebalance cases " + json.dumps(rows), flush=True)
    return rows


def set_default_share(sim, hosts, fraction=500):
    """The default user's share: 1/`fraction` of the fleet's memory and
    cpus (a finite share makes DRU, and so preemption, meaningful; the
    store's default is unbounded)."""
    from cook_tpu_torch.models.entities import DEFAULT_USER, Resources, Share

    sim.store.set_share(Share(
        user=DEFAULT_USER, pool="default",
        resources=Resources(mem=sum(h.mem for h in hosts) / fraction,
                            cpus=sum(h.cpus for h in hosts) / fraction)))


class RebalanceLog:
    """Watches a simulator's scheduler: the host reservations after every
    match and every rebalance cycle, each rebalance cycle's decisions,
    reservations made and released, and capacity after every match and
    every rebalance (check_capacity raises on an over-committed host),
    and each rebalance cycle's host-clock wall."""

    def __init__(self, sim):
        self.reservations = []  # (phase, sorted reservation items)
        self.cycles = []        # per rebalance cycle: decisions summary
        self.released = 0
        self.placed_on_reserved = 0
        s = self.scheduler = sim.scheduler
        match, rebalance = s.match_cycle, s.rebalance_cycle

        def match_cycle(pool):
            before = dict(s.host_reservations)
            out = match(pool)
            placed = {j.uuid: o.hostname for j, o in out.matched}
            for host, uuid in before.items():
                if s.host_reservations.get(host) != uuid:
                    self.released += 1
                    self.placed_on_reserved += placed.get(uuid) == host
            self.reservations.append(
                ("match", sorted(s.host_reservations.items())))
            check_capacity(sim)
            return out

        def rebalance_cycle(pool):
            t0 = time.perf_counter()
            decisions = rebalance(pool)
            wall = time.perf_counter() - t0
            self.cycles.append(dict(
                wall_s=wall, decisions=len(decisions),
                victims=sum(len(d.task_ids) for d in decisions),
                reserved=sum(len(d.task_ids) > 1 for d in decisions)))
            self.reservations.append(
                ("rebalance", sorted(s.host_reservations.items())))
            check_capacity(sim)
            return decisions

        s.match_cycle, s.rebalance_cycle = match_cycle, rebalance_cycle


def ledger_view(result):
    """The fairness ledger's decision fields, run by run comparable."""
    return [{k: e[k] for k in ("t_ms", "preemptor_job", "hostname", "block",
                               "min_preempted_dru", "victims", "wasted_s")}
            for e in result.fairness["pools"]["default"]["ledger"]]


def rebalance_slice_phase(trace=REB_TRACE, device="cuda"):
    """The full-size rebalance path through the port's Simulator (the
    REB_TRACE replay on the card); the first and the last victim search
    of each cycle, and the one with the most victims, rerun on the CPU
    port, identical.  The last search reads the device state after the
    in-place updates of all the cycle's earlier decisions.  The tests run
    it on the CPU at a small `trace`."""
    from cook_tpu_torch.ops.common import bucket_size, fetch_result
    from cook_tpu_torch.ops.rebalance import RebalanceState
    from cook_tpu_torch.scheduler import rebalancer as rb
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.scheduler.matcher import MatchConfig
    from cook_tpu_torch.sim.loadgen import preemption_heavy_trace
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator

    phase("rebalance slice")
    t0 = time.perf_counter()
    jobs, hosts = preemption_heavy_trace(**trace)
    sim = Simulator(jobs, hosts, SimConfig(
        cycle_ms=30_000, max_cycles=REB_CYCLES, rebalance_every=1,
        scheduler=SchedulerConfig(
            match=MatchConfig(max_jobs_considered=16384))), device=device)
    set_default_share(sim, hosts)
    log = RebalanceLog(sim)
    print(f"rebalance slice: {len(jobs)} jobs x {len(hosts)} hosts built "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    search = rb.find_preemption_decision
    picks = {}       # rebalance cycle -> {"first", "last", "most victims"}
    shapes, devices = set(), set()
    # per rebalance cycle: [searches, search wall (dispatch + device +
    # fetch), this phase's own bookkeeping wall]
    spent = {}

    def keep(*args):
        t0 = time.perf_counter()
        # the cycle writes its tensors in place after each decision: keep
        # copies of what this search read
        args = (RebalanceState(*(a.clone() for a in args[0])),
                *(a.clone() for a in args[1:]))
        t1 = time.perf_counter()
        out = search(*args)
        got = fetch_result(out)
        t2 = time.perf_counter()
        state = args[0]
        shapes.add((state.task_host.shape[0], state.spare.shape[0]))
        devices.add(state.task_host.device.type)
        cyc = spent.setdefault(len(log.cycles), [0, 0.0, 0.0])
        slot = picks.setdefault(len(log.cycles), {})
        kept = (cyc[0], args, got)  # this search's number in its cycle
        slot.setdefault("first", kept)
        slot["last"] = kept
        # ties go to the later search, which reads more in-place updates
        most = slot.get("most victims")
        if most is None or (int(got.preempt_mask.sum())
                            >= int(most[2].preempt_mask.sum())):
            slot["most victims"] = kept
        cyc[0] += 1
        cyc[1] += t2 - t1
        cyc[2] += (t1 - t0) + (time.perf_counter() - t2)
        return out

    rb.find_preemption_decision = keep
    try:
        t0 = time.perf_counter()
        result = sim.run()
        wall = time.perf_counter() - t0
    finally:
        rb.find_preemption_decision = search
    if devices != {sim.scheduler.device.type}:
        raise AssertionError(f"victim searches ran on {devices}")
    # every hog task running (its fleet full) plus max_preemption slack
    # rows: 20,100 rows bucketed to 32768 x 10,000 hosts to 16384 at full
    # size
    padded = (bucket_size(trace["hog_jobs"] + 100),
              bucket_size(trace["hosts"]))
    if shapes != {padded}:
        raise AssertionError(f"padded (task rows, hosts) {shapes}, "
                             f"expected {padded}")
    rows = result.rows
    placed = {"hog": 0, "late": 0}
    for r in rows:
        if r["start_ms"] is not None:
            placed["hog" if r["user"] == "hog" else "late"] += 1
    fair = result.fairness["pools"]["default"]
    walls = result.cycle_wall_s
    summary = dict(
        cycles=result.cycles, replay_wall_s=round(wall, 3),
        decisions=[c["decisions"] for c in log.cycles],
        victims=[c["victims"] for c in log.cycles],
        rebalance_wall_ms=[round(c["wall_s"] * 1e3, 1) for c in log.cycles],
        # per cycle: the searches, their wall from dispatch to the fetched
        # result, and what keeping their inputs here cost (inside the
        # rebalance wall); the rest of the wall is the host's bookkeeping
        search_wall_ms=[round(spent.get(i, (0, 0.0))[1] * 1e3, 1)
                        for i in range(len(log.cycles))],
        capture_wall_ms=[round(spent.get(i, (0, 0.0, 0.0))[2] * 1e3, 1)
                         for i in range(len(log.cycles))],
        reservations_made=sum(c["reserved"] for c in log.cycles),
        reservations_released=log.released,
        tasks_preempted=fair["rollups"]["tasks_preempted"],
        wasted_s=fair["rollups"]["wasted_s"],
        placements=placed,
        phase_wall_s={k: round(v, 4) for k, v in
                      result.phase_wall_s.items()},
        cycle_wall_ms=[round(s * 1e3, 1) for s in walls],
        cycle_wall_p50_ms=round(sorted(walls)[len(walls) // 2] * 1e3, 2),
        searches=[spent.get(i, (0,))[0] for i in range(len(log.cycles))],
        padded_shape=sorted(shapes)[0])
    print("rebalance slice " + json.dumps(summary), flush=True)
    if sum(c["victims"] for c in log.cycles) <= 0:
        raise AssertionError("the rebalance slice preempted nothing")
    if fair["rollups"]["tasks_preempted"] != sum(c["victims"]
                                                 for c in log.cycles):
        raise AssertionError("the ledger's tasks_preempted does not count "
                             "the decisions' victims")
    checked = 0
    for cyc, slot in sorted(picks.items()):
        done = set()  # search numbers of this cycle already rerun
        for which in ("first", "last", "most victims"):
            n, args, want = slot[which]
            if n in done:
                continue
            done.add(n)
            got = fetch_result(search(*_to_device(args, "cpu")))
            same_decision(f"slice cycle {cyc + 1} {which} (card vs CPU)",
                          got, want)
            checked += 1
            print(f"rebalance slice cycle {cyc + 1} {which} search ("
                  f"{n + 1} of {spent[cyc][0]}): host {int(want.host)}, {int(want.preempt_mask.sum())} "
                  "victims, identical on the CPU", flush=True)
    summary["searches_checked"] = checked
    print(f"rebalance slice: {checked} distinct searches of "
          f"{sum(c[0] for c in spent.values())} identical on the "
          f"CPU; capacity ok on {check_capacity(sim)} busy hosts",
          flush=True)
    return summary


def whole_host_trace(trace_job, trace_host, hosts=64, host_mem=65_536.0,
                     host_cpus=32.0):
    """A hog fills every host with two half-host jobs at t=0; at 30 s four
    users submit whole-host jobs for half the hosts.  Each decision must
    take both of a host's tasks (two victims), so it reserves the host for
    its job, and the next match must send that job there.  Returns (jobs,
    hosts) of the given TraceJob / TraceHost classes (either package's)."""
    jobs = [trace_job(uuid=f"hog-{i:05d}", user="hog", submit_time_ms=0,
                      runtime_ms=600_000, mem=host_mem / 2,
                      cpus=host_cpus / 2) for i in range(2 * hosts)]
    jobs += [trace_job(uuid=f"whole-{i:05d}", user=f"whole{i % 4}",
                       submit_time_ms=30_000, runtime_ms=150_000,
                       mem=host_mem, cpus=host_cpus)
             for i in range(hosts // 2)]
    return jobs, [trace_host(node_id=f"h{i:03d}", hostname=f"h{i:03d}",
                             mem=host_mem, cpus=host_cpus)
                  for i in range(hosts)]


def _rebalance_replay(jobs, hosts, match, device, resident=False):
    """(result, RebalanceLog) of a 6-cycle replay with a rebalance after
    every match and the default share 1/500 of the fleet; `resident`
    serves the rebalancer's victim tensors from its resident row mirror
    (RebalancerParams.resident)."""
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.scheduler.rebalancer import RebalancerParams
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(jobs, hosts, SimConfig(
        cycle_ms=30_000, max_cycles=REB_CYCLES, rebalance_every=1,
        scheduler=SchedulerConfig(
            match=match, rebalancer=RebalancerParams(resident=resident))),
        device=device)
    set_default_share(sim, hosts)
    log = RebalanceLog(sim)
    return sim.run(), log


def rebalance_agreement_phase():
    """Two small rebalance replays on the card and on the CPU: run traces,
    fairness ledgers and reservations after every cycle equal.  The first
    on the flat `pallas` matcher, each of its `best_node` launches held
    against the plain version; the second with multi-victim decisions and
    host reservations.  Each is replayed again with the rebalancer's
    resident row mirror (RebalancerParams.resident) on the card and on the
    CPU: equal to each other and to the replay without it.  Returns the
    first replay's best_node launches."""
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import match as match_mod
    from cook_tpu_torch.scheduler.matcher import MatchConfig
    from cook_tpu_torch.sim import simulator as sim_mod
    from cook_tpu_torch.sim.loadgen import preemption_heavy_trace

    phase("rebalance agreement")
    traces = {
        "flat pallas": (preemption_heavy_trace(
            hosts=200, host_mem=65_536, host_cpus=32, hog_jobs=400,
            late_jobs=600, n_late_users=9, seed=1),
            MatchConfig(**REB_PALLAS)),
        "whole host": (whole_host_trace(sim_mod.TraceJob,
                                        sim_mod.TraceHost),
                       MatchConfig(max_jobs_considered=16384)),
    }
    launches = 0
    for label, ((jobs, hosts), match) in traces.items():
        calls = []
        with kept_calls(match_mod, "best_node", calls):
            bn.launches = 0
            card, card_log = _rebalance_replay(jobs, hosts, match, "cuda")
            n = bn.launches
        cpu, cpu_log = _rebalance_replay(jobs, hosts, match, "cpu")
        if card.to_csv() != cpu.to_csv():
            raise AssertionError(f"rebalance agreement {label}: card and "
                                 "CPU run traces differ")
        if ledger_view(card) != ledger_view(cpu):
            raise AssertionError(f"rebalance agreement {label}: fairness "
                                 "ledgers differ")
        if card_log.reservations != cpu_log.reservations:
            raise AssertionError(f"rebalance agreement {label}: host "
                                 "reservations differ")
        victims = [c["victims"] for c in card_log.cycles]
        if sum(victims) <= 0:
            raise AssertionError(f"rebalance agreement {label}: nothing "
                                 "preempted")
        reserved = sum(c["reserved"] for c in card_log.cycles)
        if label == "whole host" and not (
                reserved and card_log.placed_on_reserved == reserved):
            raise AssertionError(
                f"whole host: {reserved} reservations made, "
                f"{card_log.placed_on_reserved} of them taken by their job")
        if label == "flat pallas":
            if n <= 0 or len(calls) != n:
                raise AssertionError(f"kept {len(calls)} best_node calls "
                                     f"but the kernel counted {n}")
            for i, args in enumerate(calls):
                check_identical("best_node", f"rebalance replay launch {i}",
                                args)
            launches = n
        for device in ("cuda", "cpu"):
            res, res_log = _rebalance_replay(jobs, hosts, match, device,
                                             resident=True)
            if (res.to_csv() != card.to_csv()
                    or ledger_view(res) != ledger_view(card)
                    or res_log.reservations != card_log.reservations):
                raise AssertionError(
                    f"rebalance agreement {label}: the resident mirror's "
                    f"replay on {device} differs from the replay without "
                    "it")
            mirror = res_log.scheduler._rebalance_mirrors["default"]
            print(f"rebalance agreement {label}: resident mirror on "
                  f"{device}: run trace, ledger and reservations = the "
                  f"replay without it; last build "
                  + json.dumps(mirror.last), flush=True)
        placed = n_placed(card.rows)
        print(f"rebalance agreement {label}: card = CPU (run trace, "
              f"ledger, reservations after every cycle); victims per "
              f"cycle {victims}, reservations made {reserved}, released "
              f"{card_log.released} ({card_log.placed_on_reserved} taken "
              f"by their job), {placed} placements, best_node launches "
              f"{n}" + (" each identical to the plain version"
                        if n else ""), flush=True)
    return launches


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "cook_tpu_torch")):
        print("chip_smoke.py: cook_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import torch

    from cook_tpu_torch.sim import cli

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = device_phase()
    build_phase()
    errs = kernel_phase()
    device_update_phase()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="cook-smoke-") as workdir:
        trace = os.path.join(workdir, "trace.json")
        t0 = time.perf_counter()
        cli.main(["synth", *SYNTH_ARGS, "--out", trace])
        print(f"synth {time.perf_counter() - t0:.1f} s", flush=True)
        flat_launches, calls, classic = slice_phase(trace, workdir)
        launches = {"best_node": flat_launches}
        rows["best_node"], err, _ = launch_phase("best_node", calls,
                                                 _unplaced)
        errs["best_node"] = max(errs["best_node"], err)
        del calls
        walls_phase(trace, workdir)
        hier_launches, hier_calls, hier_result, _ = hier_slice_phase(
            trace)
        hier_csv = hier_result.to_csv()
        hier_placed = [r["job_uuid"] for r in hier_result.rows
                       if r["start_ms"] is not None]
        del hier_result
        for name in ("best_block", "best_node_batched", "coarse_pass"):
            launches[name] = hier_launches[name]
        rows["best_node_batched"], err, _ = launch_phase(
            "best_node_batched", hier_calls.pop("best_node_batched"),
            _unplaced)
        errs["best_node_batched"] = max(errs["best_node_batched"], err)
        rows["coarse_pass"], err, busiest = launch_phase(
            "coarse_pass", hier_calls.pop("coarse_pass"), _coarse_live)
        errs["coarse_pass"] = max(errs["coarse_pass"], err)
        plain_wall = wall_ms(lambda: _module("coarse_pass")
                             .coarse_pass_reference(*busiest))
        print(f"coarse_pass plain version on that launch, host clock with "
              f"its dispatch: {plain_wall:.4f} ms (median of 5)", flush=True)
        rows["best_block"], err = block_step_phase(busiest)
        errs["best_block"] = max(errs["best_block"], err)
        del busiest
        # device residency: (a) the flat slice resident, (c) quantized
        # and the hierarchical slice resident, (b) the unchanged-pool rig
        for label, run in (
                ("resident slice",
                 lambda: resident_slice_phase(trace, workdir, classic)),
                ("quantized slice",
                 lambda: quantized_slice_phase(trace, classic)),
                ("unchanged-pool rig", unchanged_pool_phase)):
            n, res_calls = run()
            launches["best_node"] += n
            errs["best_node"] = max(errs["best_node"], hold_launches(
                "best_node", res_calls, label))
            del res_calls
        for label, run in (
                ("resident hier slice", resident_hier_phase),
                ("quantized hier slice", quantized_hier_phase)):
            res_launches, res_calls = run(trace, hier_csv, hier_placed)
            for name, kept in res_calls.items():
                launches[name] += res_launches[name]
                errs[name] = max(errs[name], hold_launches(
                    name, kept, label))
            del res_calls
        del classic
        agreement_phase(workdir)
        default_agreement_phase(workdir)
        resident_default_agreement_phase(workdir)
        cache_neutrality_phase(workdir)
        gang_runs = gang_slice_phase(trace)
        gang_ops_phase(*gang_runs.pop("ops"))
        for label, (gang_launches, gang_calls, _) in gang_runs.items():
            err = gang_launches_phase(label, gang_calls)
            for name in gang_calls:
                errs[name] = max(errs[name], err)
            print(f"gang {label} launches: " + json.dumps(gang_launches),
                  flush=True)
        del gang_runs, gang_calls
        gang_agreement_phase(workdir)
    gang_admission_phase()
    mp_serial = []
    mp_launches, mp_calls, mp_trace = multipool_phase(serial_csv=mp_serial)
    for name, err in multipool_launches_phase(mp_calls).items():
        errs[name] = max(errs[name], err)
        launches[name] += mp_launches[name]
    del mp_calls
    multipool_exact_phase(*mp_trace)
    mp_launches, mp_calls = resident_multipool_phase(*mp_trace,
                                                     mp_serial[0])
    for name, kept in mp_calls.items():
        launches[name] += mp_launches[name]
        errs[name] = max(errs[name], hold_launches(
            name, kept, "resident multipool"))
    del mp_trace, mp_calls, mp_serial
    n, res_calls = resident_streams_phase()
    launches["best_node"] += n
    errs["best_node"] = max(errs["best_node"], hold_launches(
        "best_node", res_calls, "resident streams"))
    del res_calls
    multipool_agreement_phase()
    paged_rows, err = paged_coarse_phase()
    errs["coarse_pass"] = max(errs["coarse_pass"], err)
    print("coarse_pass paged " + json.dumps(paged_rows), flush=True)
    rebalance_case_phase()
    rebalance_slice_phase()
    reb_launches = rebalance_agreement_phase()
    print(f"best_node launches inside the flat rebalance replay: "
          f"{reb_launches}", flush=True)
    # the card's name and power limit again, beside the numbers above
    print(card)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": rows[name]["ms"],
        "warm_ms": rows[name]["warm_ms"],
        "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"],
        "bound_by": rows[name]["bound_by"],
        # no single PyTorch call computes a gated fit-and-argmax
        "library_ms": None,
    } for name, (_, source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
