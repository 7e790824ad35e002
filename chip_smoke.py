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
                  gangs), 2 cycles on the flat route (chunked `best_node`,
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
                  fifth of the hosts carry 8), 2 cycles on each of three
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
 11c. multipool exact — one cycle at chunk 0 on two of the flat pools
                  (pool1 and the DruMode.GPU one, all jobs submitted at t
                  0): the batched `greedy_match_pools`
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
                  10,000 hosts, 3 cycles of rank -> exact greedy match ->
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
  8c. resident default-config agreement — the small trace at the default
                  configuration with residency and `quantized` on, on the
                  card and on the CPU: run traces and cycle records (the
                  device_state stats among them) equal, and the run trace
                  equal to the card's replay with `quantized` alone.
After the launches phase (5), `walls` replays the flat slice twice more
(the cache off, then the recorder off): run traces identical to the
slice's (which also holds the encode cache neutral and a run repeatable
at the slice's shape), the walls per cycle beside the slice's own.

Speculation (scheduler/prediction.py), after the residency phases (7d):

  S1. speculation wave — `completion_heavy_trace` at 100,000 jobs x
                  10,000 hosts of 64 GB / 32 cpus (one job a host, 30 s,
                  one user), 5 cycles on the exact greedy (16,384
                  considerable), speculation off and on: identical run
                  traces, hit fraction >= 0.2, a lower pre-launch p50 on,
                  no `solve-error`, no H2D byte on a hit cycle; the
                  dispatch walls (and their greedy's enqueue), the hit
                  cycles' commit walls and bytes printed.
  S2. speculation on the kernels — the wave on the flat slice's `pallas`
                  knobs and on `HIER_MATCH`, 3 cycles each, off and on:
                  identical traces, hits on both; the flat slice (its
                  trace and knobs, 3 cycles) speculating: run trace = the
                  classic slice's, hits and drops by reason printed.
                  Every `best_node`, `coarse_pass` and `best_node_batched`
                  launch of the speculative solves kept and held against
                  its plain version; every launch of these runs counted.
  S3. pipelined speculation — 4 pools, each the wave at 12,500 x 1,250,
                  `match_cycle_pipelined` for 3 passes at the default
                  SchedulerConfig, off and on: identical placements, every
                  pool a hit on pass 3.
  S4. speculation agreement — the reference's scenarios at small size on
                  the card and on the CPU (the 3-user columnar wave: 1 hit,
                  7 `queue-shifted`, 1 `epoch-stale`; the estimated-
                  completion constraint: nothing dispatched; residency with
                  an epoch bump mid-flight: `epoch-stale`): equal run
                  traces, cycle records' speculation fields and stats.

Elastic capacity plane (ops/elastic.py, elastic/), after the rebalance
agreement (15) and before the report (16):

 17. elastic solve — `weighted_demand` + `solve_capacity_plan` (torch
                  code: no hand kernel runs in them) on the card at
                  [8, 32768] (the multi-pool slice's padded shape) and
                  [8, 131072] (one pool holding the 100,000-job backlog),
                  six live pools and two padded, live loans with a full
                  reclaim, a partial one and none, headroom 0.1: against
                  the port on the CPU and the numpy oracles, amounts
                  within rtol 1e-4, atol 1e-2 (shortage 1e-1),
                  holds_borrowed / can_lend and the move sets after
                  MIN_MOVE identical, the full reclaim the loan bit for
                  bit; CUDA-event times of one plan (median of 20, cold
                  and warm), its host-clock wall, its kernel launches
                  (torch.profiler) and the bytes it reads.
 18. elastic multipool — the multi-pool slice (11a's trace and knobs) on
                  the serial route for 2 cycles with `elastic_every=1`:
                  after every match, plan and reclaim no host over
                  capacity (the `elastic@pool` hosts too), the ledger
                  non-negative and equal to the running sum of the
                  committed moves, the nets summing to zero; every plan's
                  inputs solved again on the CPU port (the same moves);
                  every `best_node`, `coarse_pass` and `best_node_batched`
                  launch held against its plain version; per cycle the
                  elastic wall and inside it the solve, `_demand_inputs`,
                  the commit and `reconcile`, the elastic-plan H2D bytes
                  and the placements beside 11a's serial route.
 19. elastic residency — 18's final queues planned 3 times with
                  `ElasticParams.resident` off and on: equal plans, warm
                  plans <= 0.1x the cold plan's elastic-plan H2D bytes.
 20. elastic agreement — the two-pool loan, the reclaim before
                  preemption across a failover (journal in a temporary
                  directory: the control victim search picks task-bob,
                  the real cycle reclaims and picks nobody) and the
                  imbalanced A/B at 24 jobs, on the card and on the CPU:
                  identical run traces, plans and ledgers; then on the
                  card the A/B at 1,000 busy jobs on 10 hosts against
                  1,240 idle ones (its elastic run under 18's checks): the
                  p50 queued wait lower with elastic_every 1 than 0.

The superblock layer and the default path's last hooks, the gang
agreement (10) and the quality audit after the speculation kernels (S2)
inside the slices' block, 22 and 24 after the elastic agreement (20):

 21. superblock slice — the hierarchical slice's trace and `HIER_MATCH`
                  with superblocks of 4,096 hosts (3 superblocks of 4
                  blocks of 1,024), 3 cycles: every solve and cycle record
                  shows >= 2 superblocks and a super-coarse wall, no
                  `coarse_pass` launch (both coarse levels are torch
                  code), every `best_node_batched` launch held against its
                  plain version; the per-level walls (super-coarse,
                  coarse, fine, refine), placements and cycle p50 beside
                  the classic hierarchical slice's.  On the first full
                  window's problem (cycle 2) the exact greedy on the card
                  against the superblock solve (the slice's knobs, and the
                  reference's default fine backend) and the classic
                  two-level one, printed; the reference's 0.95 packing
                  floor held on the card where its tests hold it
                  (tests/test_superblocks.py's problems and knobs).
 22. superblock at scale — `hierarchical_match` alone on a 1,048,576
                  x 100,000 problem in bench.make_problem's shape family
                  (R 4, no mask), once with superblocks of 16,384 hosts
                  (one refine round, which the layer doubles), then cold
                  and warm with none (the classic
                  `coarse_pass`; the warm assignment equal to the cold
                  one): per-level walls, launches by kernel, placed,
                  device memory peak; the busiest
                  `best_node_batched` (the plain version run 8 blocks at a
                  time) and `coarse_pass` launches held against their plain
                  versions; an 8,192 x 1,024 superblock solve on the card
                  and the CPU, identical.
 23. quality audit — the flat slice again with `quality_audit_every` 2:
                  the audit replays cycle 2's solve through the plain exact
                  greedy on CPU copies, on its thread, while cycle 3 runs;
                  run trace = the slice's, the `match.quality_audit`
                  gauge set and equal to the same audit recomputed on this
                  thread; cycle walls with the audit on beside the slice's.
 24. faults, incidents, admission — a small scheduler on the card: an
                  armed `device.solve` error raises out of `match_cycle`
                  and out of the batched pass, and skips its pool with
                  `solve-failed` on the pipelined one; a `device.solve`
                  delay drives health ok -> degraded and captures exactly
                  one incident bundle whose automatic `torch.profiler`
                  capture holds CUDA kernel events, then recovers; under an
                  overload signal the admission clamp shrinks the
                  considerable window x0.95 a cycle to its floor, then
                  resets.
 25. service    — the scheduler service on the card (`components.py`,
                  the REST layer on the standard library), the flat
                  slice's fleet and knobs: (a) in this process,
                  `read_config` of a mock cluster of 10,000 hosts (64 GB /
                  32 cpus, as `sim.cli synth --hosts 10000` makes them),
                  one pool, `max_jobs_considered 16384, chunk 1024,
                  backend "pallas"`, a journal in a temporary data_dir,
                  0.5 s rank and match intervals; `build_process` and
                  `start_leader_duties(block=False)`, counts reset just
                  before, load shedding off (on a slower host the
                  submits beside the match loop can pass the 1 s
                  commit-ack SLO, and the node would answer the heavy
                  reads 429 for the SLO's 300 s fast window); 20,000 jobs
                  of the synth trace's shapes POSTed to /jobs over
                  http.client in 20 batches of 1,000, one user
                  each; 3 match cycles with a window after the last submit
                  (/debug/cycles); then GET /jobs/{uuid} for 200 of them,
                  /queue, /running, /unscheduled_jobs?job=, /usage,
                  /metrics, /debug, /debug/device and /debug/cycles, each
                  with its expected status; the loops stopped, the counts
                  read: `best_node` launched and every kept launch
                  identical to its plain version, no host over-committed,
                  the sampled /jobs statuses equal to the store's, no
                  `solve-failed` skip.  Prints the submit wall per batch,
                  per-route request latency p50 / p99 on the host clock,
                  the match cycle walls, placements and launches.  (b)
                  `python3 -m cook_tpu_torch --config ...` as a subprocess
                  on the same fleet and a free port: /debug healthy and
                  leader, 1,000 jobs submitted, one running, SIGTERM and a
                  clean exit; a second process on the same data_dir reads
                  back every acknowledged job.
 26. failover   — the replicated control plane on phase 25's fleet and
                  knobs: `python3 -m cook_tpu_torch.control.lease_server`
                  and leader A (`python3 -m cook_tpu_torch`, TTL 3 s,
                  `replication_sync_ack` with one durable ack, its own
                  data_dir) as subprocesses; standby B in this process
                  (`build_process`, `start_leader_duties` on a thread, a
                  data_dir of its own), so that its launches are counted
                  and kept, built while A boots.  One admin write to A (a
                  share for a user who submits nothing) wakes B's first
                  long-poll and must come back replicated; once A leads
                  and B's follower has synced, 10,000 jobs of the synth trace's shapes POSTed to A in 10
                  batches of 1,000 (one user each), every 201 replicated;
                  B's staleness sampled meanwhile; a match cycle with
                  placements on A; a GET /jobs/{uuid} on B served with
                  X-Cook-Staleness-Ms.  Counts reset, A SIGKILLed: B leads
                  within 2 x TTL + 5 s and runs 3 match cycles with a
                  window.  Fails unless every acked job reads back from B
                  through GET /jobs?uuid=... in batches of 500 (200 of
                  them through /jobs/{uuid} too, each saying what its
                  batch said), B holds no job A never acked, B
                  launched `best_node` and every kept launch is identical
                  to its plain version, no host of B's mock cluster is
                  over-committed, no job skips `solve-failed`, and B's
                  columnar index is consistent with its store.  Prints the
                  submit wall per batch with its sync-ack wait, B's lag
                  (staleness p50 / max), SIGKILL to promotion, B's cycle
                  walls, placements and launches, beside the card.
 27. sharded failover — phase 26 on the sharded store (`shard/`): the
                  same fleet split host by host into two pools of 5,000,
                  named by `ShardRouter(2).pools_for_distinct_shards()`
                  so that each shard owns one; leader A (a subprocess)
                  and standby B (this process) both with `"shards": 2`
                  and data_dirs of their own, A with sync acks (one
                  durable ack) and no load shedding (its jobs are read
                  back over GET /jobs after the bulk submits).  One admin
                  POST of a job in each pool wakes both shard followers'
                  first long-polls and must come back replicated; 10,000
                  jobs in 10 POSTs of 1,000 (one user each): the
                  even-numbered POSTs each to one pool, the odd-numbered
                  ones half in each (cross-shard commits), every 201
                  replicated; then up to 100 waiting jobs of each pool
                  from the last POST moved to the other pool over POST
                  /pool-move (each move a cross-shard commit), each 201
                  replicated; B's per-shard staleness sampled
                  throughout; a match cycle with placements on A in each
                  pool; a GET /jobs/{uuid} on B whose
                  X-Cook-Shard-Staleness names both shards.  Counts
                  reset, A SIGKILLed: B leads within 2 x TTL + 5 s and
                  runs 3 match cycles with a window in each pool.  Fails
                  unless every acked job reads back from B in its
                  acknowledged pool (a moved job in its new one) and lies
                  on exactly one of B's shards, the one that owns its
                  pool; B holds no job A never acked; B launched
                  `best_node` in both pools and every kept launch is
                  identical to its plain version; no host is
                  over-committed, no job skips `solve-failed`, B's
                  columnar index is consistent with its store; and once B
                  stops, its data_dir recovers through `recover_sharded`
                  to B's per-shard state.  Prints the submit wall per
                  POST with each shard's sync-ack wait (from
                  X-Cook-Hop-Walls), the moves, per-shard staleness p50 /
                  max, SIGKILL to promotion, B's cycle walls per pool,
                  placements and launches per pool, beside the card.

Order and processes: 1-7 (with the walls replays) run in this process,
which times the kernel rows.  Then three worker processes run the rest
at once, each its own part (PARTS), each resetting and reading the
counts around the paths it drives: `speculation` S1-S4, 12 and 11;
`multipool` 11a-11f, 17-20, 7a-7d and 23; `agreement` 8-8c, 9-10, 21,
13-15, 22 and 24.  Their output is printed once all three have ended
(their phase lines count from this process's start, so they overlap),
and their launches and errors join this process's.  25, 26 and 27 run
last, in this process, with nothing beside them.

Imports nothing of JAX and nothing of `cook_tpu`.
"""
from __future__ import annotations

import contextlib
import importlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import threading
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


_T0 = time.perf_counter()
# the wall clock at _T0, from which each part's phase lines count
_EPOCH = time.time()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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


# the walls phase's replays of the flat slice: (label, SchedulerConfig
# changes): the cache off, and the defaults with the flight recorder and
# the telemetry off (the data-plane accounting runs in the record's
# scope, so it goes too), once each.  The cache-on run is the slice
# itself.  (Until the service phase needed the time, a cProfile'd cache-on
# replay printed the last cycle's host profiles here too.)
CACHE_OFF = dict(use_encode_cache=False)
RECORDER_OFF = dict(flight_recorder_capacity=0, device_telemetry=False)
WALL_RUNS = (("cache off", CACHE_OFF), ("recorder off", RECORDER_OFF))
WALL_PHASES = ("rank", "encode", "solve", "launch")


def _wall_row(phase_wall_s, cycle_wall_s, encode_per_cycle):
    """A walls-phase row: the phase walls, the cycle p50, every cycle's
    wall and encode wall."""
    return dict(
        **{k: round(phase_wall_s.get(k, 0.0), 4) for k in WALL_PHASES},
        cycle_p50_ms=round(1e3 * sorted(cycle_wall_s)[
            len(cycle_wall_s) // 2], 2),
        cycle_ms=[round(1e3 * w, 1) for w in cycle_wall_s],
        encode_per_cycle=[round(e, 4) for e in encode_per_cycle])


def walls_phase(trace, workdir, classic, device="cuda"):
    """Where the flat slice's walls go: the slice's replay again per
    WALL_RUNS, each run trace identical to the slice's (neither the cache
    nor the recorder changes a decision), beside the slice's own walls
    (`classic`: the cache-on run).  Per run: the simulator's phase walls,
    the cycle p50 and the encode wall per cycle."""
    import dataclasses

    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.sim.simulator import Simulator, load_trace

    phase("walls: encode cache on / off, recorder off")
    args = cli.build_parser().parse_args(
        ["run", "--trace", trace, "--device", device, *SLICE_ARGS])
    jobs, hosts = load_trace(trace)
    # newline="": the CSV's own \r\n line ends, as to_csv() gives them
    with open(os.path.join(workdir, "run.csv"), newline="") as f:
        want = f.read()
    walls = {"cache on": _wall_row(classic["phase_wall_s"],
                                   classic["walls"], classic["encode"])}
    for label, changes in WALL_RUNS:
        cfg = cli.sim_config(args)
        cfg.scheduler = dataclasses.replace(cfg.scheduler, **changes)
        result = Simulator(jobs, hosts, cfg, device=args.device).run()
        if result.to_csv() != want:
            raise AssertionError(f"{label}: the run trace differs from "
                                 "the slice's")
        walls[label] = _wall_row(result.phase_wall_s, result.cycle_wall_s,
                                 [r["phases"].get("tensor_build", 0.0)
                                  for r in result.cycle_records])
        print(f"walls {label}: run trace = the slice's; "
              + json.dumps(walls[label]), flush=True)
    print("walls summary " + json.dumps({
        label: {k: row[k] for k in (*WALL_PHASES, "cycle_p50_ms")}
        for label, row in walls.items()}), flush=True)


def hier_slice_phase(trace, resident=False, quantized=False,
                     label="hier slice", device="cuda", match_args=None,
                     superblocks=False, solves=None):
    """The hierarchical path on the flat slice's trace: every solve goes
    coarse (one coarse_pass launch) -> scatter -> fine (best_node_batched)
    -> refine; with `resident`, the problems come from the device-resident
    mirror (SimConfig.resident), and with `quantized` the cost tensors are
    bfloat16.  With `superblocks` (match_args carrying
    `hierarchical_superblock_nodes`) the coarse level is the two-level
    superblock routing on the masked torch code (no coarse_pass launch),
    every solve and record must show >= 2 superblocks and a
    super-coarse wall, and the walls are summed per level.  No host ends
    the run over its capacity (_slice_summary).  `solves`, if given,
    receives each solve's (problem, params, stats).  Returns ({kernel:
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
    kept = [] if solves is None else solves
    solve = hierarchical.hierarchical_match

    def keep_stats(*args, **kwargs):
        out = solve(*args, **kwargs)
        kept.append((args[0], kwargs["params"], out[1]))
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
    stats = [st for _, _, st in kept]
    keys = ["blocks", "block_pad", "nodes_per_block", "jobs_per_block",
            "fine_shape", "coarse_shape", "spilled", "refine_rounds",
            "refine_placed", "placed", "backend", "coarse_backend",
            "coarse_s", "fine_s", "refine_s"]
    levels = ["coarse_s", "fine_s", "refine_s", "total_s"]
    if superblocks:
        keys += ["superblocks", "superblock_pad", "superblock_blocks",
                 "jobs_per_superblock", "superblock_spilled", "super_shape",
                 "super_coarse_s"]
        levels.insert(0, "super_coarse_s")
    print(f"{label}: {len(stats)} hierarchical solves; the last "
          + json.dumps({k: stats[-1][k] for k in keys}), flush=True)
    walls = {k: sum(st[k] for st in stats) for k in levels}
    print(f"{label}: solve walls summed over the solves (s) "
          + json.dumps(walls), flush=True)
    if len(stats) != result.cycles:
        raise AssertionError(f"{len(stats)} hierarchical solves in "
                             f"{result.cycles} cycles")
    # the coarse scoring runs inside coarse_pass: no best_block launch
    if launches["best_block"]:
        raise AssertionError(f"{launches['best_block']} best_block launches "
                             "on the hierarchical path")
    if superblocks:
        # both coarse levels are the masked torch code: no coarse_pass
        if launches["coarse_pass"]:
            raise AssertionError(f"{label}: {launches['coarse_pass']} "
                                 "coarse_pass launches")
        del calls["coarse_pass"]
        records = [r for r in result.cycle_records if r["hierarchical"]]
        if len(records) != result.cycles or any(
                r["hier_superblocks"] < 2
                or "super_coarse_solve" not in r["hier_phases"]
                for r in records) or any(st["superblocks"] < 2
                                         or st["super_coarse_s"] <= 0
                                         for st in stats):
            raise AssertionError(f"{label}: records without the "
                                 "superblock layer")
    for name, kept_calls_ in calls.items():
        if device == "cuda" and (launches[name] <= 0
                                 or len(kept_calls_) != launches[name]):
            raise AssertionError(f"kept {len(kept_calls_)} {name} calls but "
                                 f"the kernel counted {launches[name]} "
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
        submit_s=totals["submit_s"], encode_s=totals["encode_s"],
        walls=list(result.cycle_wall_s),
        phase_wall_s=dict(result.phase_wall_s))


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


# ----------------------------------------------------------------- gangs

# 2 cycles: the first cycle holds the few jobs submitted at t 0, the
# second the full window (3 before the superblock phases needed the time)
GANG_CYCLES = 2
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
# 2 cycles: cycle 1 holds the few jobs submitted at t 0, cycle 2 the
# full windows with alpha on the two-level path (3 before the superblock
# phases needed the time)
MP_CYCLES = 2
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


# the exact cycle's flat pools: the first and the DruMode.GPU one (it ran
# all seven before the superblock phases needed the time; each pool keeps
# its 10,000 x 1,000 shape)
MP_EXACT_POOLS = 2


def multipool_exact_phase(jobs, hosts, pools, device="cuda", big="alpha"):
    """(d): one cycle at chunk 0 (the exact greedy) on MP_EXACT_POOLS of
    the flat pools (pools but `big`), their jobs all submitted at t 0 so
    that the cycle holds a full window: the batched pass
    (`greedy_match_pools`, one step places a job row of every pool)
    against the serial route (a `greedy_match` per pool).  Run traces
    identical; both solve walls printed."""
    import dataclasses

    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.utils.config import default_match_config

    phase("multipool exact")
    flat_pools = tuple(p for p in pools if p[0] != big)
    flat_pools = (flat_pools[:MP_EXACT_POOLS - 1]
                  + flat_pools[-1:])
    names = {p[0] for p in flat_pools}
    flat_jobs = [dataclasses.replace(j, submit_time_ms=0) for j in jobs
                 if j.pool in names]
    flat_hosts = [h for h in hosts if h.pool in names]
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
# 16384 considerable jobs, a rebalance after every match, cycles of 30 s
REB_TRACE = dict(hosts=10_000, host_mem=65_536, host_cpus=32,
                 hog_jobs=20_000, late_jobs=80_000, n_late_users=49,
                 runtime_ms=600_000, late_arrival_ms=60_000, seed=0)
REB_CYCLES = 6
# the slice's depth: 3 cycles (decisions from cycle 3 on; it ran 6, then
# 4, before the elastic and superblock phases needed the time); the victim
# search at the slice's padded shapes is also held by the rebalance cases
# (13)
REB_SLICE_CYCLES = 3
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


def rebalance_slice_phase(trace=REB_TRACE, device="cuda",
                          cycles=REB_SLICE_CYCLES):
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
        cycle_ms=30_000, max_cycles=cycles, rebalance_every=1,
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


# ------------------------------------------------------------- speculation

# the speculation wave (sim/loadgen.completion_heavy_trace) at the slices'
# width and host shape: 100,000 jobs x 10,000 hosts of 64 GB / 32 cpus,
# each job the size of a host and 30 s long, one user, all at t 0 — every
# cycle completes one wave and places the next
SPEC_WAVE = dict(jobs=100_000, hosts=10_000, runtime_ms=30_000,
                 host_mem=65_536.0, host_cpus=32.0, n_users=1)
# 5 cycles (hits on cycles 3-5; it ran 6 before the elastic phases needed
# the time): the pre-launch p50 then reads a hit cycle (at 4 or 3 cycles
# it reads a fresh one, and the comparison is noise); speculation at these
# shapes is also held by S2's kernel-knob waves
SPEC_CYCLES = 5
# the exact greedy (chunk 0) at the slices' window: the reference's own
# A/B scenario (tests/test_prediction.py:411)
SPEC_EXACT = dict(max_jobs_considered=16_384, chunk=0)
# the flat slice's kernel knobs, and the hierarchical slice's
SPEC_PALLAS = dict(max_jobs_considered=16_384, chunk=1024, backend="pallas",
                   chunk_rounds=3, chunk_passes=3, chunk_kc=64)
# 3 cycles (a hit on cycle 3; it ran 4 before the superblock phases
# needed the time)
SPEC_KERNEL_CYCLES = 3
# tests/test_prediction.py:422's bar
SPEC_HIT_FRACTION = 0.2
# the pipelined speculation rig: 4 pools, each the wave at 12,500 x 1,250
# (8 before the superblock phases needed the time; each pool's shape is
# unchanged)
SPEC_POOLS = 4
SPEC_POOL_WAVE = dict(SPEC_WAVE, jobs=12_500, hosts=1_250)
# 3 passes (pass 3 hits; it ran 4 before the elastic phases needed the
# time): the pipelined pass's placements are also held against the
# serial route at the multi-pool slice's shapes (11a)
SPEC_PIPELINED_CYCLES = 3
SPEC_KERNELS = {"best_node": ("match", "best_node"),
                "coarse_pass": ("hierarchical", "coarse_pass"),
                "best_node_batched": ("hierarchical", "best_node_batched")}


def wave_trace(wave=None, prefix="", pool="default"):
    """The speculation wave (`wave`, default SPEC_WAVE: the arguments of
    completion_heavy_trace); with `prefix`, its uuids and hosts renamed
    into pool `pool`."""
    from cook_tpu_torch.sim.loadgen import completion_heavy_trace

    jobs, hosts = completion_heavy_trace(**(wave or SPEC_WAVE))
    if prefix:
        for j in jobs:
            j.uuid, j.pool = f"{prefix}-{j.uuid}", pool
        for h in hosts:
            h.node_id = h.hostname = f"{prefix}-{h.hostname}"
            h.pool = pool
    return jobs, hosts


class SpecProbe:
    """A speculating scheduler's speculator, watched: every dispatch that
    put a solve in flight timed whole (the predicted rank, prepare and
    solve dispatch) and its solve's enqueue alone (the host's hold while
    `dispatch_pool_solve` queues the kernels); under `watching()`, the
    arguments of every hand-kernel call made while the speculator runs
    (the dispatch's, and the hierarchical solve that runs at the commit's
    fetch) kept under kept[kernel], and the fresh solves' not."""

    def __init__(self, scheduler, kept=None):
        self.active = False
        self.dispatch_s = []
        self.enqueue_s = []
        self.kept = kept
        spec = scheduler.speculator
        dispatch, commit = spec.dispatch, spec.try_commit

        def dispatched(*args, **kwargs):
            self.active = True
            t0 = time.perf_counter()
            try:
                ok = dispatch(*args, **kwargs)
            finally:
                self.active = False
            if ok:
                self.dispatch_s.append(time.perf_counter() - t0)
            return ok

        def committed(*args, **kwargs):
            self.active = True
            try:
                return commit(*args, **kwargs)
            finally:
                self.active = False

        spec.dispatch, spec.try_commit = dispatched, committed

    @contextlib.contextmanager
    def watching(self):
        from cook_tpu_torch.scheduler import prediction

        patched = []

        def patch(module, attr, wrapper):
            original = getattr(module, attr)
            patched.append((module, attr, original))
            setattr(module, attr, wrapper(original))

        def timed(enqueue):
            def enqueued(*args, **kwargs):
                t0 = time.perf_counter()
                out = enqueue(*args, **kwargs)
                self.enqueue_s.append(time.perf_counter() - t0)
                return out
            return enqueued

        def keeping(name):
            def wrap(kernel):
                def keep(*args):
                    if self.active:
                        self.kept[name].append(args)
                    return kernel(*args)
                return keep
            return wrap

        patch(prediction, "dispatch_pool_solve", timed)
        if self.kept is not None:
            for name, (mod_name, attr) in SPEC_KERNELS.items():
                patch(importlib.import_module(
                    f"cook_tpu_torch.ops.{mod_name}"), attr, keeping(name))
        try:
            yield self
        finally:
            for module, attr, original in reversed(patched):
                setattr(module, attr, original)


def _launch_counts():
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp

    return {"best_node": bn.launches, "coarse_pass": cp.launches,
            "best_node_batched": bnb.launches}


def _reset_launches():
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp

    bn.launches = bnb.launches = cp.launches = 0


def spec_records(result):
    """Each cycle record's speculation outcome: (pool, cycle, status,
    reason, backend)."""
    return [(r["pool"], r["cycle"], r["speculation"],
             r["speculation_drop"], r["backend"])
            for r in result.cycle_records]


def check_speculation(label, result, scheduler):
    """No speculation dropped (or skipped) as `solve-error`: a kernel fault
    must not hide behind a fresh solve.  Returns the drop reasons
    counted."""
    from cook_tpu_torch.scheduler.prediction import DROP_SOLVE_ERROR

    errors = [r for r in spec_records(result) if r[3] == DROP_SOLVE_ERROR]
    stats = scheduler.speculator.stats_json()
    if errors or DROP_SOLVE_ERROR in stats["drop_reasons"]:
        raise AssertionError(f"{label}: speculative solves failed "
                             f"({errors}, {stats['drop_reasons']})")
    reasons = {}
    for *_, status, reason, _backend in spec_records(result):
        if status == "dropped" or reason:
            reasons[reason] = reasons.get(reason, 0) + 1
    return reasons


def spec_replay(jobs, hosts, match, cycles, speculate, device="cuda",
                pools=(("default", "default"),), pipelined=False,
                resident=False, on_sim=None, kept=None, **scheduler_kw):
    """One replay at the default SchedulerConfig (with `match` and
    `scheduler_kw`), speculation on or off; `pipelined` drives the
    pipelined pass (the Simulator's batched loop, its pass swapped);
    `on_sim(sim)` runs just before the replay; `kept` takes the
    speculative solves' kernel calls (SpecProbe).  Returns (simulator,
    result, wall, SpecProbe or None)."""
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator

    sim = Simulator(jobs, hosts, SimConfig(
        cycle_ms=30_000, max_cycles=cycles, pools=pools,
        batched_match=pipelined, resident=resident, speculate=speculate,
        scheduler=SchedulerConfig(match=match, **scheduler_kw)),
        device=device)
    if pipelined:
        sim.scheduler.match_cycle_all_pools = \
            sim.scheduler.match_cycle_pipelined
    probe = SpecProbe(sim.scheduler, kept) if speculate else None
    if on_sim is not None:
        on_sim(sim)
    t0 = time.perf_counter()
    with (probe.watching() if probe else contextlib.nullcontext()):
        result = sim.run()
    return sim, result, time.perf_counter() - t0, probe


def _spec_cycle_line(rec):
    phases = rec["phases"]
    return dict(
        speculation=rec["speculation"], drop=rec["speculation_drop"],
        backend=rec["backend"], considered=rec["considered"],
        matched=len(rec["matched"]),
        **{f"{k}_s": round(phases[k], 4) for k in (
            "rank", "speculation_commit", "tensor_build", "solve", "launch")
           if k in phases},
        h2d_bytes=rec["h2d_bytes"], d2h_bytes=rec["d2h_bytes"])


def spec_pair(label, jobs, hosts, match, cycles, kept, **replay_kw):
    """The replay with speculation off, then on (the hand-kernel calls of
    its speculative solves kept into `kept`): identical run traces, no
    `solve-error`, capacity held.  Prints each run's speculation stats,
    the on-run's cycles and its dispatch and enqueue walls.  Returns (off
    result, on result, on probe, {kernel: launches in both runs})."""
    runs = {}
    launches = {k: 0 for k in SPEC_KERNELS}
    for speculate in (False, True):
        _reset_launches()
        sim, result, wall, probe = spec_replay(
            jobs, hosts, match, cycles, speculate, kept=kept, **replay_kw)
        counted = _launch_counts()
        for k, v in counted.items():
            launches[k] += v
        check_capacity(sim)
        print(f"{label} speculation {'on' if speculate else 'off'}: "
              + json.dumps(dict(result.speculation_stats(),
                                placed=n_placed(result.rows),
                                replay_wall_s=round(wall, 2),
                                launches=counted)), flush=True)
        runs[speculate] = (sim, result, probe)
    (_, off, _), (sim, on, probe) = runs[False], runs[True]
    if on.to_csv() != off.to_csv():
        raise AssertionError(f"{label}: run traces differ with "
                             "speculation on and off")
    reasons = check_speculation(label, on, sim.scheduler)
    for rec in on.cycle_records:
        print(f"{label} on, cycle {rec['cycle']} pool {rec['pool']} "
              + json.dumps(_spec_cycle_line(rec)), flush=True)
    print(f"{label}: run traces identical; speculator "
          + json.dumps(sim.scheduler.speculator.stats_json())
          + f"; drops / skips by reason {json.dumps(reasons)}; dispatch "
          f"walls (s) {[round(s, 4) for s in probe.dispatch_s]}, their "
          f"solve enqueue (s) {[round(s, 4) for s in probe.enqueue_s]}",
          flush=True)
    return off, on, probe, launches


def speculation_wave_phase(device="cuda", wave=None, cycles=SPEC_CYCLES):
    """The speculation wave on the exact greedy (16,384 considerable),
    `cycles` cycles with speculation off, then on: identical run traces,
    hit fraction >= 0.2, a lower pre-launch p50 with speculation on, no
    `solve-error`, and no H2D byte on a hit cycle's record (only the
    assignment's fetch remains).  Prints the dispatch walls (and their
    greedy's enqueue), the hit cycles' commit walls and bytes."""
    from cook_tpu_torch.utils.config import default_match_config

    phase("speculation wave")
    jobs, hosts = wave_trace(wave)
    kept = {k: [] for k in SPEC_KERNELS}
    off, on, probe, _ = spec_pair(
        "speculation wave", jobs, hosts, default_match_config(**SPEC_EXACT),
        cycles, kept, device=device)
    s_off, s_on = off.speculation_stats(), on.speculation_stats()
    if s_on["hit_fraction"] < SPEC_HIT_FRACTION:
        raise AssertionError(f"speculation wave: hit fraction "
                             f"{s_on['hit_fraction']} < {SPEC_HIT_FRACTION}")
    if not s_on["pre_launch_p50_ms"] < s_off["pre_launch_p50_ms"]:
        raise AssertionError(
            f"speculation wave: pre-launch p50 {s_on['pre_launch_p50_ms']} "
            f"ms on, not below {s_off['pre_launch_p50_ms']} ms off")
    hits = [r for r in on.cycle_records if r["speculation"] == "hit"]
    moved = [r["cycle"] for r in hits if r["h2d_bytes"]]
    if moved:
        raise AssertionError(f"speculation wave: hit cycles {moved} moved "
                             "H2D bytes")
    print("speculation wave: " + json.dumps(dict(
        hit_fraction_on=s_on["hit_fraction"],
        pre_launch_p50_ms_on=s_on["pre_launch_p50_ms"],
        pre_launch_p50_ms_off=s_off["pre_launch_p50_ms"],
        dispatch_s=probe.dispatch_s, enqueue_s=probe.enqueue_s,
        hit_commit_s=[r["phases"]["speculation_commit"] for r in hits],
        hit_h2d_bytes=[r["h2d_bytes"] for r in hits],
        hit_d2h_bytes=[r["d2h_bytes"] for r in hits],
        off_solve_s=[r["phases"].get("solve", 0.0)
                     for r in off.cycle_records])), flush=True)
    return s_on


def speculation_kernels_phase(trace, classic_csv, device="cuda", wave=None,
                              cycles=SPEC_KERNEL_CYCLES):
    """The speculation wave on the flat slice's `pallas` knobs and on the
    hierarchical slice's, `cycles` cycles each, off and on: identical run
    traces, hits on both; then the flat slice (the 50-user `synth_trace`,
    its knobs, 3 cycles) with speculation on: its run trace the classic
    slice's (`classic_csv`), its hits and drops by reason printed.
    Returns ({kernel: launches over the runs}, {kernel: the speculative
    solves' kept calls})."""
    from cook_tpu_torch.sim.simulator import load_trace
    from cook_tpu_torch.utils.config import default_match_config

    phase("speculation on the kernels")
    jobs, hosts = wave_trace(wave)
    kept = {k: [] for k in SPEC_KERNELS}
    launches = {k: 0 for k in SPEC_KERNELS}
    for label, overrides in (("speculation wave pallas", SPEC_PALLAS),
                             ("speculation wave hier", HIER_MATCH)):
        _, on, _, counted = spec_pair(
            label, jobs, hosts, default_match_config(**overrides), cycles,
            kept, device=device)
        if on.speculation_stats()["hits"] <= 0:
            raise AssertionError(f"{label}: no speculation hit")
        for k, v in counted.items():
            launches[k] += v
    jobs, hosts = load_trace(trace)
    match = default_match_config(max_jobs_considered=16_384, chunk=1024,
                                 backend="pallas")
    _reset_launches()
    sim, result, wall, probe = spec_replay(jobs, hosts, match, 3, True,
                                           device=device, kept=kept)
    for k, v in _launch_counts().items():
        launches[k] += v
    if result.to_csv() != classic_csv:
        raise AssertionError("flat slice with speculation: the run trace "
                             "differs from the classic slice's")
    reasons = check_speculation("flat slice speculating", result,
                                sim.scheduler)
    print("flat slice speculating: run trace = the classic slice's; "
          + json.dumps(dict(result.speculation_stats(),
                            speculator=sim.scheduler.speculator.stats_json(),
                            by_reason=reasons, replay_wall_s=round(wall, 2),
                            dispatch_s=probe.dispatch_s,
                            records=spec_records(result))), flush=True)
    print("speculative solves' kernel calls kept: "
          + json.dumps({k: len(v) for k, v in kept.items()}), flush=True)
    missing = [k for k, v in kept.items() if not v]
    if missing:
        raise AssertionError(f"no speculative {missing} call kept")
    return launches, kept


def speculation_pipelined_phase(device="cuda", n_pools=SPEC_POOLS,
                                pool_wave=SPEC_POOL_WAVE,
                                cycles=SPEC_PIPELINED_CYCLES):
    """`n_pools` pools, each the wave at `pool_wave`, through
    `Scheduler.match_cycle_pipelined` at the default SchedulerConfig, off
    and on: identical placements, and once the predictor is warm (from
    the third pass) every pool's cycle a hit."""
    from cook_tpu_torch.scheduler.matcher import MatchConfig

    phase("pipelined speculation")
    jobs, hosts, pools = [], [], []
    for k in range(n_pools):
        name = f"spec{k}"
        pjobs, phosts = wave_trace(pool_wave, prefix=name, pool=name)
        jobs += pjobs
        hosts += phosts
        pools.append((name, "default"))
    kept = {k: [] for k in SPEC_KERNELS}
    _, on, _, _ = spec_pair("pipelined speculation", jobs, hosts,
                            MatchConfig(), cycles, kept, device=device,
                            pools=tuple(pools), pipelined=True)
    by_pool = {}
    for rec in on.cycle_records:
        if not rec["pipelined"]:
            raise AssertionError("pipelined speculation: a record not "
                                 "pipelined")
        by_pool.setdefault(rec["pool"], []).append(rec)
    for name, _mode in pools:
        recs = sorted(by_pool.get(name, []), key=lambda r: r["t_ms"])
        warm = [r["speculation"] for r in recs[2:]]
        if len(recs) != cycles or warm != ["hit"] * (cycles - 2):
            raise AssertionError(f"pipelined speculation: pool {name}'s "
                                 f"cycles {[r['speculation'] for r in recs]}")
    print(f"pipelined speculation: {n_pools} pools hit on every warm pass "
          f"(passes 3-{cycles})", flush=True)


# the agreement replays (the reference test scenarios at small size):
# (the wave's arguments, MatchConfig overrides, replay overrides, the
# expected hits and drops by reason, or None to compare card and CPU only)
SPEC_AGREEMENT = {
    "3-user columnar wave": (dict(jobs=48, hosts=4, n_users=3, seed=1), {},
                             {}, (1, {"queue-shifted": 7,
                                      "epoch-stale": 1})),
    "completion constraint": (dict(jobs=24, hosts=4),
                              dict(completion_multiplier=1.5,
                                   host_lifetime_mins=60.0), {}, None),
    "resident": (dict(jobs=24, hosts=4), {}, dict(resident=True), None),
}
# the resident replay drops its resident state after this match cycle
SPEC_INVALIDATE_AFTER = 3


def _invalidate_after(n):
    """on_sim hook: drop the scheduler's resident state (an epoch bump)
    right after its `n`th match cycle, while a speculation is in flight."""
    def hook(sim):
        scheduler = sim.scheduler
        match_cycle = scheduler.match_cycle
        count = [0]

        def matched(pool):
            out = match_cycle(pool)
            count[0] += 1
            if count[0] == n:
                scheduler.device_state.invalidate()
            return out

        scheduler.match_cycle = matched
    return hook


def speculation_agreement_phase(devices=("cuda", "cpu")):
    """The reference test scenarios at small size on the card and on the
    CPU: equal run traces, equal `speculation` / `speculation_drop` on
    every cycle record, equal speculator stats.  The 3-user columnar wave
    drops 7 `queue-shifted` (the two rank paths' tie orders); the
    estimated-completion constraint dispatches no speculation; residency
    with an epoch bump mid-flight drops `epoch-stale`."""
    from cook_tpu_torch.scheduler.matcher import MatchConfig
    from cook_tpu_torch.sim.loadgen import completion_heavy_trace

    phase("speculation agreement")
    for label, (wave, overrides, replay_kw, expect) in \
            SPEC_AGREEMENT.items():
        runs = {}
        for device in devices:
            jobs, hosts = completion_heavy_trace(**wave)
            on_sim = (_invalidate_after(SPEC_INVALIDATE_AFTER)
                      if replay_kw.get("resident") else None)
            sim, result, _, _ = spec_replay(
                jobs, hosts, MatchConfig(**overrides), 40, True,
                device=device, device_telemetry=False, on_sim=on_sim,
                **replay_kw)
            reasons = check_speculation(f"agreement {label}", result,
                                        sim.scheduler)
            runs[device] = (result.to_csv(), spec_records(result),
                            sim.scheduler.speculator.stats_json(), reasons,
                            result.speculation_stats()["hits"])
        card, cpu = (runs[d] for d in devices)
        if card[:3] != cpu[:3]:
            raise AssertionError(f"speculation agreement {label}: card and "
                                 "CPU differ")
        stats, reasons, hits = card[2:]
        if expect is not None and (hits, {k: v for k, v in reasons.items()
                                          if k != "predictor-cold"}) \
                != expect:
            raise AssertionError(f"speculation agreement {label}: hits "
                                 f"{hits}, reasons {reasons}, expected "
                                 f"{expect}")
        if "constraint" in label and stats["dispatched"]:
            raise AssertionError(f"speculation agreement {label}: "
                                 f"{stats['dispatched']} dispatched")
        if replay_kw.get("resident") and "epoch-stale" not in reasons:
            raise AssertionError(f"speculation agreement {label}: no "
                                 f"epoch-stale drop ({reasons})")
        print(f"speculation agreement {label}: card = CPU; hits {hits}, "
              f"speculator {json.dumps(stats)}, by reason "
              f"{json.dumps(reasons)}", flush=True)


# --------------------------------------------------------------- elastic

# the plan's two shapes: the multi-pool slice's padded [8, 32768] (alpha's
# 30,000 jobs) and one pool holding BASELINE's 100,000-job backlog
ELASTIC_SHAPES = ((8, 32_768), (8, 131_072))
ELASTIC_LIVE = 6          # live pools of the 8; the last two padded
ELASTIC_HEADROOM = 0.1
ELASTIC_HALF_LIFE = 64.0  # ElasticParams.rank_half_life
# the amounts' tolerances of tests/test_elastic.py:71, :83-85
EL_RTOL, EL_ATOL, EL_SHORT_ATOL = 1e-4, 1e-2, 1e-1
# the imbalanced A/B on the card (the test's own size, 24 jobs on 2 + 4
# hosts, runs card against CPU): 1,000 busy jobs on 10 busy hosts against
# 1,240 idle ones.  The busy hosts (64 GB / 32 cpus) run 4 jobs of 8 GB /
# 8 cpus each and strand 32 GB apiece: from 23 busy hosts on, the pool's
# scalar spare memory covers the rank-weighted demand's (~92 jobs, 736
# GB), the plan then loans cpus alone and the elastic host places nothing
# (ROADMAP Queue C reference item 9), so the A/B keeps the busy pool small.
EL_AB = dict(busy_jobs=1_000, busy_hosts=10, idle_hosts=1_240)
EL_AB_CYCLES = 60
EL_AB_SMALL = dict(busy_jobs=24)
EL_AB_SMALL_CYCLES = 60


def elastic_inputs(p, j, live=ELASTIC_LIVE, seed=0):
    """numpy inputs of one plan at [p, j]: `live` pools with queues of
    the simulator's job shapes (pool 0's the whole j, the others random
    lengths), the rest padded; three live loans: 0 -> 1 with pool 0 short
    by twice it (a full reclaim), 2 -> 3 with pool 2 short by half of it
    (a partial one), 4 -> 5 with pool 4 not short (none).  Returns (res,
    valid, supply, outstanding, pool_valid, oracle demand)."""
    import numpy as np

    from cook_tpu_torch.ops import cpu_reference

    rng = np.random.default_rng(seed)
    res = np.zeros((p, j, 3), np.float32)
    valid = np.zeros((p, j), bool)
    lengths = [j] + [int(n) for n in rng.integers(j // 8, j, live - 1)]
    for i, n in enumerate(lengths):
        res[i, :n, 0] = rng.integers(1, 64, n) * 512.0
        res[i, :n, 1] = rng.integers(1, 32, n) * 0.5
        res[i, :n, 2] = (rng.uniform(size=n) < 0.1) * rng.integers(1, 4, n)
        valid[i, :n] = True
    demand = cpu_reference.ref_weighted_demand(res, valid,
                                               ELASTIC_HALF_LIFE)
    dem = demand.astype(np.float32)
    supply = (rng.uniform(0.0, 2.0, (p, 3)) * dem.mean(axis=0)).astype(
        np.float32)
    outstanding = np.zeros((p, p, 3), np.float32)
    outstanding[0, 1] = np.round(0.2 * dem[0])
    supply[0] = np.maximum(dem[0] - 2.0 * outstanding[0, 1], 0.0)
    outstanding[2, 3] = np.round(0.4 * dem[2])
    supply[2] = np.maximum(dem[2] - 0.5 * outstanding[2, 3], 0.0)
    outstanding[4, 5] = np.round(0.1 * dem[5])
    supply[4] = 2.0 * dem[4]
    for borrower, lender in ((1, 0), (3, 2)):
        supply[borrower] = 10.0 * outstanding[lender, borrower] + 1.0
    supply[live:] = 0.0
    pool_valid = np.arange(p) < live
    return res, valid, supply, outstanding, pool_valid, demand


def elastic_move_set(reclaim, loan, n_pools):
    """{(kind, from, to)} of the moves the planner would commit (any
    dimension at or over its MIN_MOVE)."""
    from cook_tpu_torch.elastic.planner import MIN_MOVE
    from cook_tpu_torch.ops.elastic import ELASTIC_RESOURCE_DIMS

    out = set()
    for kind, matrix in (("reclaim", reclaim), ("loan", loan)):
        for li in range(n_pools):
            for bi in range(n_pools):
                if li != bi and any(
                        matrix[li, bi, d] >= MIN_MOVE[dim]
                        for d, dim in enumerate(ELASTIC_RESOURCE_DIMS)):
                    out.add((kind, li, bi))
    return out


def elastic_solve(res, valid, supply, outstanding, pool_valid, device,
                  half_life=ELASTIC_HALF_LIFE, headroom=ELASTIC_HEADROOM):
    """One plan on `device` from numpy or tensor inputs: (demand, plan,
    holds_borrowed), all numpy."""
    import torch

    from cook_tpu_torch.ops import elastic

    def put(a):
        return torch.as_tensor(a).to(device)

    demand = elastic.weighted_demand(put(res), put(valid), half_life)
    problem = elastic.ElasticProblem(demand, put(supply), put(outstanding),
                                     put(pool_valid))
    plan = elastic.solve_capacity_plan(problem, headroom)
    held = elastic.holds_borrowed(problem, plan)
    return (demand.cpu().numpy(), type(plan)(*(t.cpu().numpy()
                                                for t in plan)),
            held.cpu().numpy())


def check_elastic_plan(label, got, want, n_pools):
    """Two (demand, plan, holds_borrowed) triples agree: amounts within
    the tolerances, holds_borrowed (and so can_lend) and the move sets
    identical.  Shortages and loans are differences of demand and supply:
    where those run to millions of MB, one float32 rounding of the
    operands is 0.125 MB, over the absolute tolerance of a difference
    that should be 0.  So each resource's absolute tolerance is at least
    16 float32 epsilons of its largest demand (3 MB at a demand of 1.5
    million MB, 0.004 cpus at 1,500 cpus)."""
    import numpy as np

    (d1, p1, h1), (d2, p2, h2) = got, want
    floor = 16 * float(np.finfo(np.float32).eps) * np.abs(d2).max(axis=0)

    def close(name, a, b, atol):
        # atol per resource (the last axis), broadcast over pools
        bad = np.abs(a - b) > np.maximum(atol, floor) + EL_RTOL * np.abs(b)
        if bad.any():
            i = tuple(np.argwhere(bad)[0])
            raise AssertionError(f"{label}: {name}{list(i)} {a[i]} != "
                                 f"{b[i]} ({int(bad.sum())} elements)")

    close("demand", d1, d2, EL_ATOL)
    for name, atol in (("reclaim", EL_ATOL), ("loan", EL_ATOL),
                       ("shortage", EL_SHORT_ATOL)):
        close(name, getattr(p1, name), getattr(p2, name), atol)
    if not np.array_equal(h1, h2):
        raise AssertionError(f"{label}: holds_borrowed {h1} != {h2}")
    m1 = elastic_move_set(p1.reclaim, p1.loan, n_pools)
    m2 = elastic_move_set(p2.reclaim, p2.loan, n_pools)
    if m1 != m2:
        raise AssertionError(f"{label}: move sets differ: {sorted(m1 ^ m2)}")
    return float(max(np.abs(p1.reclaim - p2.reclaim).max(),
                     np.abs(p1.loan - p2.loan).max()))


def _profiled_launches(fn):
    """Device kernels one call of fn() launched, by torch.profiler: (count,
    names), or (None, []) where the profiler saw no device event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (len(kernels), sorted(set(kernels))) if kernels else (None, [])


def elastic_solve_phase(device="cuda", shapes=ELASTIC_SHAPES):
    """17. The plan solve (`ops/elastic.py`, torch code: no hand kernel
    runs in it) on the card at the slice's two shapes, against the port
    on the CPU and the numpy oracles: amounts within tolerance,
    holds_borrowed / can_lend and the move sets identical, the full
    reclaim exact.  CUDA-event times of one plan, cold and warm, its
    launches (torch.profiler) and the bytes it reads."""
    import numpy as np
    import torch

    from cook_tpu_torch.ops import cpu_reference, elastic

    phase("elastic solve")
    rows = {}
    for p, j in shapes:
        label = f"elastic {p}x{j}"
        res, valid, supply, outstanding, pool_valid, demand = \
            elastic_inputs(p, j)
        oracle = cpu_reference.ref_capacity_plan(
            demand, supply, outstanding, pool_valid, ELASTIC_HEADROOM)
        oracle_held = (outstanding - oracle[0]).sum(axis=(0, 2)) > 0
        want = (demand, elastic.ElasticPlan(*oracle), oracle_held)
        cpu = elastic_solve(res, valid, supply, outstanding, pool_valid,
                            "cpu")
        check_elastic_plan(f"{label} cpu vs oracle", cpu, want, p)
        card = elastic_solve(res, valid, supply, outstanding, pool_valid,
                             device)
        err = max(check_elastic_plan(f"{label} card vs cpu", card, cpu, p),
                  check_elastic_plan(f"{label} card vs oracle", card, want,
                                     p))
        plan = card[1]
        # the pinned cases: the full reclaim returns the loan whole, its
        # borrower may lend; the partial and unreclaimed borrowers may not
        if not np.array_equal(plan.reclaim[0, 1], outstanding[0, 1]):
            raise AssertionError(f"{label}: the full reclaim is not the "
                                 "loan bit for bit")
        if list(card[2][[1, 3, 5]]) != [False, True, True]:
            raise AssertionError(f"{label}: holds_borrowed {card[2]}")
        if not 0 < plan.reclaim[2, 3, 0] < outstanding[2, 3, 0]:
            raise AssertionError(f"{label}: the partial reclaim is "
                                 f"{plan.reclaim[2, 3]}")
        moves = sorted(elastic_move_set(plan.reclaim, plan.loan, p))
        row = dict(moves=len(moves), max_abs_err=err,
                   can_lend=[bool(x) for x in pool_valid & ~card[2]])
        if device == "cuda":
            dev = [torch.as_tensor(a).to(device)
                   for a in (res, valid, supply, outstanding, pool_valid)]

            def one_plan():
                d = elastic.weighted_demand(dev[0], dev[1],
                                            ELASTIC_HALF_LIFE)
                return elastic.solve_capacity_plan(elastic.ElasticProblem(
                    d, dev[2], dev[3], dev[4]), ELASTIC_HEADROOM)

            nbytes = sum(int(a.nbytes) for a in (res, valid, supply,
                                                 outstanding, pool_valid))
            row.update(ms=cuda_ms(one_plan, cold=True),
                       warm_ms=cuda_ms(one_plan),
                       wall_ms=wall_ms(one_plan), bytes_read=nbytes,
                       bound_ms=nbytes / PEAK_BYTES_S * 1e3,
                       bound_by="bytes")
            launches, names = _profiled_launches(one_plan)
            row["launches"] = ("not measured (no device events)"
                               if launches is None else launches)
            row["kernels"] = len(names)
        rows[label] = row
        print(f"{label}: card = CPU = oracle, moves {moves} "
              + json.dumps(row), flush=True)
    return rows


def _apply_moves(ledger, moves):
    """The store's ledger arithmetic (apply_capacity_moves), kept apart
    as the running sum of the committed moves."""
    for move in moves:
        key = (move["from"], move["to"])
        entry = ledger.get(key, {d: 0.0 for d in ("mem", "cpus", "gpus")})
        for dim in entry:
            amount = float(move.get(dim, 0.0))
            entry[dim] = (max(entry[dim] - amount, 0.0)
                          if move["kind"] == "reclaim"
                          else entry[dim] + amount)
        if any(v > 1e-6 for v in entry.values()):
            ledger[key] = entry
        else:
            ledger.pop(key, None)


class ElasticProbe:
    """Per cycle of an elastic replay: the elastic phase's wall and,
    inside it, the solve (the record's duration), `_demand_inputs`, the
    commit (with its reconcile) and `reconcile`; the elastic-plan H2D
    bytes; and after every match, plan and reclaim: capacity (the
    `elastic@pool` hosts too), a non-negative ledger equal to the running
    sum of the committed moves, and nets summing to zero across pools."""

    def __init__(self, sim):
        from cook_tpu_torch.obs import data_plane

        self.sim = sim
        self.cycles = {}
        self.ledger = {}
        self.checks = 0
        s, planner = sim.scheduler, sim.scheduler.elastic

        def cycle():
            return self.cycles.setdefault(sim.now_ms, dict(
                elastic_s=0.0, solve_s=0.0, demand_inputs_s=0.0,
                commit_s=0.0, reconcile_s=0.0, h2d_bytes=0, plans=0,
                moves=0, placed=0))

        def timed(obj, name, key):
            original = getattr(obj, name)

            def run(*args, **kwargs):
                t0 = time.perf_counter()
                out = original(*args, **kwargs)
                cycle()[key] += time.perf_counter() - t0
                return out
            setattr(obj, name, run)

        def fam_h2d():
            return data_plane.LEDGER.family_totals().get(
                data_plane.FAM_ELASTIC, {}).get("h2d_bytes", 0)

        match, plan, reclaim, elastic_cycle = (
            s.match_cycle, planner.plan_cycle, planner.reclaim_for,
            s.elastic_cycle)

        def matched(pool):
            out = match(pool)
            cycle()["placed"] += len(out.matched)
            self.check()
            return out

        def planned(queues):
            record = plan(queues)
            if record is not None:
                c = cycle()
                c["solve_s"] += record.duration_s
                c["plans"] += 1
                c["moves"] += len(record.moves)
                if record.txn_id:
                    _apply_moves(self.ledger, record.moves)
            self.check()
            return record

        def reclaimed(pool, pending, host_spare):
            out = reclaim(pool, pending, host_spare)
            if out is not None:
                _apply_moves(self.ledger, planner.recorder.records_json(
                    limit=1)[-1]["moves"])
            self.check()
            return out

        def elastic_timed():
            b0 = fam_h2d()
            t0 = time.perf_counter()
            out = elastic_cycle()
            c = cycle()
            c["elastic_s"] += time.perf_counter() - t0
            c["h2d_bytes"] += fam_h2d() - b0
            return out

        s.match_cycle = matched
        planner.plan_cycle = planned
        planner.reclaim_for = reclaimed
        s.elastic_cycle = elastic_timed
        timed(planner, "_demand_inputs", "demand_inputs_s")
        timed(planner, "_commit", "commit_s")
        timed(planner, "reconcile", "reconcile_s")

    def check(self):
        sim = self.sim
        check_capacity(sim)
        store = sim.store
        if store.capacity_ledger != self.ledger:
            raise AssertionError(
                f"ledger {store.encoded_capacity_ledger()} is not the "
                f"running sum of the committed moves {self.ledger}")
        if any(v < 0 for entry in store.capacity_ledger.values()
               for v in entry.values()):
            raise AssertionError(f"negative ledger "
                                 f"{store.encoded_capacity_ledger()}")
        for dim in ("mem", "cpus", "gpus"):
            net = sum(store.net_capacity_adjustment(p)[dim]
                      for p in store.pools)
            scale = 1.0 + sum(e[dim] for e in
                              store.capacity_ledger.values())
            if abs(net) > 1e-9 * scale:
                raise AssertionError(f"nets sum to {net} {dim}")
        self.checks += 1


def elastic_replan_check(label, plans, device):
    """Each kept plan (weighted_demand's and solve_capacity_plan's
    arguments on `device`) solved again on the CPU port: the same moves,
    amounts within the tolerances.  Returns the max error."""
    import torch

    from cook_tpu_torch.ops import elastic

    err = 0.0
    for i, ((wd_args, _, demand), (sp_args, _, plan)) in enumerate(plans):
        res, valid, half_life = wd_args
        problem, headroom = sp_args
        held = elastic.holds_borrowed(problem, plan)
        card = (demand.cpu().numpy(),
                type(plan)(*(t.cpu().numpy() for t in plan)),
                held.cpu().numpy())
        cpu = elastic_solve(res.cpu(), valid.cpu(),
                            problem.supply.cpu(), problem.outstanding.cpu(),
                            problem.pool_valid.cpu(), "cpu",
                            half_life=half_life, headroom=headroom)
        n_pools = int(torch.as_tensor(problem.pool_valid).sum())
        err = max(err, check_elastic_plan(f"{label} plan {i}", card, cpu,
                                          n_pools))
    print(f"{label}: {len(plans)} plans solved again on the CPU port, the "
          f"same moves, max abs error {err:.3g}", flush=True)
    return err


def elastic_slice_phase(device="cuda", pools=MP_POOLS, cycles=MP_CYCLES,
                        match_overrides=None, classic_placed=None):
    """18. The multi-pool slice (8 pools, 100k x 10k) on the serial route
    with the elastic plane planning every cycle (`elastic_every=1`) at the
    default SchedulerConfig: ElasticProbe's checks after every match,
    plan and reclaim; every plan's inputs kept and solved again on the CPU
    port; every `best_node`, `coarse_pass` and `best_node_batched` launch
    kept and held against its plain version.  Per cycle the elastic walls,
    the elastic-plan H2D bytes and the placements beside the classic
    serial route's (`classic_placed`, per cycle, from phase 11a).  Returns
    ({kernel: launches}, {kernel: max error}, the scheduler's final
    queues, (jobs, hosts, SimConfig pools))."""
    from cook_tpu_torch.elastic import planner as planner_mod
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp
    from cook_tpu_torch.ops import hierarchical, match as match_ops
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator
    from cook_tpu_torch.utils.config import default_match_config

    phase("elastic multipool")
    jobs, hosts, sim_pools = multipool_trace(pools)
    cfg = default_match_config(**{**MP_MATCH, **(match_overrides or {})})
    sim = Simulator(jobs, hosts, SimConfig(
        cycle_ms=30_000, max_cycles=cycles, pools=sim_pools,
        elastic_every=1, scheduler=SchedulerConfig(match=cfg)),
        device=device)
    probe = ElasticProbe(sim)
    modules = {"match": match_ops, "hierarchical": hierarchical}
    calls = {name: [] for name in MP_KERNELS}
    demands, plans = [], []
    with contextlib.ExitStack() as stack:
        for name, (mod, fn) in MP_KERNELS.items():
            stack.enter_context(kept_calls(modules[mod], fn, calls[name]))
        stack.enter_context(kept_results(planner_mod, "weighted_demand",
                                         demands))
        stack.enter_context(kept_results(planner_mod,
                                         "solve_capacity_plan", plans))
        bn.launches = bnb.launches = cp.launches = 0
        t0 = time.perf_counter()
        result = sim.run()
        wall = time.perf_counter() - t0
        launches = {"best_node": bn.launches,
                    "best_node_batched": bnb.launches,
                    "coarse_pass": cp.launches}
    placed = n_placed(result.rows)
    committed = [p for p in result.elastic_plans if p["txn_id"]]
    summary = dict(placements=placed, launches=launches,
                   replay_wall_s=round(wall, 2), plans=len(
                       result.elastic_plans), committed=len(committed),
                   checks=probe.checks,
                   phase_wall_s={k: round(v, 4) for k, v in
                                 result.phase_wall_s.items()},
                   ledger=result.capacity_ledger)
    print("elastic multipool " + json.dumps(summary), flush=True)
    for k, (t_ms, c) in enumerate(sorted(probe.cycles.items())):
        line = {key: (round(v, 4) if isinstance(v, float) else v)
                for key, v in c.items()}
        if classic_placed is not None:
            line["classic_placed"] = classic_placed[k]
        print(f"elastic multipool cycle {k + 1} (t {t_ms} ms) "
              + json.dumps(line), flush=True)
    if sim.scheduler.device.type != device or placed <= 0:
        raise AssertionError(f"elastic multipool: solved on "
                             f"{sim.scheduler.device}, {placed} placed")
    if len(plans) != len(result.elastic_plans) or not plans:
        raise AssertionError(f"elastic multipool: {len(plans)} solves "
                             f"kept, {len(result.elastic_plans)} plans")
    errs = {"elastic": elastic_replan_check(
        "elastic multipool", list(zip(demands, plans)), device)}
    if device == "cuda":
        for name in MP_KERNELS:
            if launches[name] <= 0 or len(calls[name]) != launches[name]:
                raise AssertionError(f"elastic multipool: kept "
                                     f"{len(calls[name])} {name} calls, "
                                     f"{launches[name]} launches")
            errs[name] = hold_launches(name, calls[name],
                                       "elastic multipool")
    elif not all(calls.values()):
        raise AssertionError("elastic multipool: a kernel was never called")
    queues = dict(sim.scheduler.pool_queues)
    return launches, errs, queues, (jobs, hosts, sim_pools)


def elastic_residency_phase(queues, trace, device="cuda", plans=3):
    """19. Phase 18's final queues planned by `CapacityPlanner.plan_cycle`
    with `resident` off and on, each on a fresh store and mock cluster of
    the slice's pools and hosts, `plans` times: the plans equal, and every
    warm plan of the unchanged queues moves <= 0.1x the cold plan's
    elastic-plan H2D bytes (tests/test_resident_mirrors.py:179-195)."""
    from cook_tpu_torch.cluster.mock import MockCluster, MockHost
    from cook_tpu_torch.elastic import CapacityPlanner, ElasticParams
    from cook_tpu_torch.models.entities import DruMode, Pool
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.obs import data_plane
    from cook_tpu_torch.txn import TransactionLog

    phase("elastic residency")
    _, hosts, sim_pools = trace

    def fam_h2d():
        return data_plane.LEDGER.family_totals().get(
            data_plane.FAM_ELASTIC, {}).get("h2d_bytes", 0)

    runs = {}
    for resident in (False, True):
        store = JobStore(clock=lambda: 0)
        for name, mode in sim_pools:
            store.set_pool(Pool(name=name, dru_mode=DruMode(mode)))
        cluster = MockCluster("sim", [MockHost(
            node_id=h.node_id, hostname=h.hostname, mem=h.mem, cpus=h.cpus,
            gpus=h.gpus, pool=h.pool) for h in hosts], clock=store.clock)
        planner = CapacityPlanner(
            store, [cluster], TransactionLog(store),
            ElasticParams(enabled=True, resident=resident), device=device)
        out, moved = [], []
        for _ in range(plans):
            b0 = fam_h2d()
            record = planner.plan_cycle(queues)
            moved.append(fam_h2d() - b0)
            out.append((record.demand, record.moves, record.unmet))
            if resident:
                stats = planner._resident.last
                moved[-1] = (moved[-1], stats["reason"]
                             if stats["rebuild"] else "warm")
        runs[resident] = (out, moved)
    if runs[True][0] != runs[False][0]:
        raise AssertionError("elastic residency: plans differ with the "
                             "mirror on")
    (cold, reason), warm = runs[True][1][0], runs[True][1][1:]
    if reason != "cold" or any(kind != "warm" or b > 0.1 * cold
                               for b, kind in warm):
        raise AssertionError(f"elastic residency: cold {cold} ({reason}), "
                             f"warm {warm}")
    print("elastic residency: plans equal with the mirror off and on; "
          "elastic-plan H2D bytes " + json.dumps({
              "classic": runs[False][1], "cold": cold,
              "warm": [b for b, _ in warm],
              "warm_over_cold": [round(b / cold, 6) for b, _ in warm]}),
          flush=True)
    return cold, [b for b, _ in warm]


def _el_job(uuid, user, pool, mem, cpus):
    from cook_tpu_torch.models.entities import Job, Resources

    return Job(uuid=uuid, user=user, pool=pool, priority=50, max_retries=1,
               resources=Resources(mem=mem, cpus=cpus), command="true")


def _el_two_pool(device, clock, data_dir=None):
    """tests/test_elastic.py's two-pool rig: pools lender and borrower, one
    16-cpu lender host, the elastic plane on, a journal in `data_dir`."""
    from cook_tpu_torch.cluster.mock import MockCluster, MockHost
    from cook_tpu_torch.elastic import ElasticParams
    from cook_tpu_torch.models import persistence
    from cook_tpu_torch.models.entities import Pool
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
    from cook_tpu_torch.txn import TransactionLog

    store = JobStore(clock=clock)
    journal = (persistence.attach_journal(
        store, os.path.join(data_dir, "journal.jsonl"))
        if data_dir is not None else None)
    store.set_pool(Pool(name="lender"))
    store.set_pool(Pool(name="borrower"))
    cluster = MockCluster("m", [MockHost(node_id="l0", hostname="l0",
                                         mem=16000, cpus=16,
                                         pool="lender")], clock=clock)
    scheduler = Scheduler(
        store, [cluster],
        SchedulerConfig(elastic=ElasticParams(enabled=True)),
        txn=TransactionLog(store, journal=journal), device=device)
    return store, cluster, scheduler, journal


class _Clock:
    def __init__(self, now_ms=1_000_000):
        self.now_ms = now_ms

    def __call__(self):
        return self.now_ms


def elastic_loan_replay(device):
    """tests/test_elastic.py:340: borrower demand pulls a loan out of the
    idle lender; the next match places on the elastic host."""
    store, cluster, scheduler, _ = _el_two_pool(device, _Clock())
    for i in range(6):
        store.submit_jobs([_el_job(f"j{i}", "alice", "borrower", 2000, 2)])
    record = scheduler.elastic_cycle()
    if not record or not record.moves or record.moves[0]["kind"] != "loan":
        raise AssertionError(f"elastic loan ({device}): {record}")
    borrower = store.pools["borrower"]
    scheduler.rank_cycle(borrower)
    outcome = scheduler.match_cycle(borrower)
    cycle = scheduler.recorder.records_json(pool="borrower")[-1]
    if cycle["elastic_plan"] != record.plan_id:
        raise AssertionError("elastic loan: the cycle record's plan id")
    return dict(plans=scheduler.elastic.recorder.records_json(),
                ledger=store.encoded_capacity_ledger(),
                placed=sorted((j.uuid, o.hostname)
                              for j, o in outcome.matched))


def elastic_failover_replay(device, data_dir):
    """tests/test_elastic.py:437: the lender loans to the borrower; the
    leader dies; the recovered leader (journal-replayed ledger) sees the
    lender's demand return and reclaims before its victim search picks
    anyone.  The control search without the reclaimer picks task-bob."""
    from cook_tpu_torch.cluster.mock import MockCluster, MockHost
    from cook_tpu_torch.elastic import ElasticParams
    from cook_tpu_torch.models import persistence
    from cook_tpu_torch.models.entities import InstanceStatus, Resources, Share
    from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
    from cook_tpu_torch.scheduler.rebalancer import (
        RebalancerParams,
        rebalance_pool,
    )
    from cook_tpu_torch.txn import TransactionLog

    clock = _Clock()
    store, _, scheduler, journal = _el_two_pool(device, clock, data_dir)
    for i in range(4):
        store.submit_jobs([_el_job(f"c{i}", "carol", "borrower", 3000, 3)])
    loan = scheduler.elastic_cycle()
    journal.close()
    store2 = persistence.recover(data_dir)
    if store2.capacity_ledger != store.capacity_ledger:
        raise AssertionError("elastic failover: the recovered ledger")
    cluster2 = MockCluster("m", [MockHost(node_id="l0", hostname="l0",
                                          mem=16000, cpus=16,
                                          pool="lender")], clock=clock)
    scheduler2 = Scheduler(
        store2, [cluster2],
        SchedulerConfig(elastic=ElasticParams(enabled=True)),
        txn=TransactionLog(store2), device=device)
    scheduler2.elastic.reconcile()
    store2.set_share(Share(user="bob", pool="lender",
                           resources=Resources(mem=100.0, cpus=1.0)))
    store2.submit_jobs([_el_job("bob", "bob", "lender", 8000, 8)])
    store2.create_instance("bob", "task-bob", hostname="l0", node_id="l0",
                           compute_cluster="m")
    store2.update_instance_state("task-bob", InstanceStatus.RUNNING, None)
    store2.submit_jobs([_el_job("alice", "alice", "lender", 8000, 8)])
    lender = store2.pools["lender"]
    scheduler2.rank_cycle(lender)
    scheduler2.match_cycle(lender)
    control = rebalance_pool(
        store2, lender, scheduler2.pool_queues["lender"].jobs,
        scheduler2.last_unmatched_offers["lender"], RebalancerParams(),
        device=device)
    decisions = scheduler2.rebalance_cycle(lender)
    if (not control or "task-bob" not in control[0].task_ids
            or decisions or store2.outstanding_loans_from("lender")
            or store2.instances["task-bob"].status.terminal):
        raise AssertionError(
            f"elastic failover ({device}): control "
            f"{[d.task_ids for d in control]}, real {decisions}, ledger "
            f"{store2.encoded_capacity_ledger()}")
    scheduler2.rank_cycle(lender)
    outcome = scheduler2.match_cycle(lender)
    plans = scheduler2.elastic.recorder.records_json()
    if "reclaim-on-demand" not in [p["kind"] for p in plans]:
        raise AssertionError("elastic failover: no reclaim-on-demand")
    return dict(plans=[*loan.to_json()["moves"], *plans[-1]["moves"]],
                kinds=[p["kind"] for p in plans],
                control=[d.task_ids for d in control],
                ledger=store2.encoded_capacity_ledger(),
                placed=sorted((j.uuid, o.hostname)
                              for j, o in outcome.matched))


def elastic_ab(device, trace_kw, cycles):
    """The imbalanced A/B: `imbalanced_pool_trace(**trace_kw)` replayed
    with elastic_every 0 and 1, the second under ElasticProbe's checks.
    Returns {every: SimResult}."""
    from cook_tpu_torch.scheduler.core import SchedulerConfig
    from cook_tpu_torch.sim.loadgen import imbalanced_pool_trace
    from cook_tpu_torch.sim.simulator import SimConfig, Simulator

    jobs, hosts = imbalanced_pool_trace(runtime_ms=60_000, **trace_kw)
    out = {}
    for every in (0, 1):
        sim = Simulator(jobs, hosts, SimConfig(
            cycle_ms=30_000, max_cycles=cycles, elastic_every=every,
            pools=(("busy", "default"), ("idle", "default")),
            scheduler=SchedulerConfig(flight_recorder_capacity=64)),
            device=device)
        probe = ElasticProbe(sim) if every else None
        out[every] = sim.run()
        if probe is not None and not probe.checks:
            raise AssertionError("elastic A/B: nothing checked")
    return out


def placements_by_cycle(csv_text, cycles, cycle_ms=30_000):
    """Placements per cycle of a run trace's CSV (start_ms is the cycle's
    clock)."""
    import csv
    import io

    out = [0] * cycles
    for row in csv.DictReader(io.StringIO(csv_text)):
        if row["start_ms"] not in ("", "None"):
            out[int(row["start_ms"]) // cycle_ms] += 1
    return out


def _p50(result):
    import numpy as np

    return float(np.percentile(result.queued_wait_ms(), 50))


def _same_moves(label, a, b):
    key = [(m["kind"], m["from"], m["to"]) for m in a]
    if key != [(m["kind"], m["from"], m["to"]) for m in b]:
        raise AssertionError(f"{label}: moves {a} != {b}")
    for x, y in zip(a, b):
        for dim in ("mem", "cpus", "gpus"):
            if abs(x[dim] - y[dim]) > EL_ATOL + EL_RTOL * abs(y[dim]):
                raise AssertionError(f"{label}: {dim} {x} != {y}")


def _same_plans(label, a, b):
    if [p["kind"] for p in a] != [p["kind"] for p in b]:
        raise AssertionError(f"{label}: plan kinds differ")
    for x, y in zip(a, b):
        _same_moves(label, x["moves"], y["moves"])


def elastic_agreement_phase(devices=("cuda", "cpu"), ab=EL_AB,
                            ab_cycles=EL_AB_CYCLES):
    """20. The reference's elastic scenarios on the card and on the CPU:
    the two-pool loan, the reclaim before preemption across a failover
    (persistence in a temporary directory) and the imbalanced A/B at the
    test's size: run traces identical, ledgers and plan records agreeing
    (moves exactly, amounts within tolerance), the control victim search
    picking task-bob while the real cycle reclaims and picks nobody.  Then
    on devices[0] the A/B at `ab` (the p50 queued wait lower with
    elastic_every 1 than 0; both p50s and the walls printed)."""
    phase("elastic agreement")
    got = {}
    for device in devices:
        with tempfile.TemporaryDirectory(prefix="cook-elastic-") as d:
            got[device] = dict(loan=elastic_loan_replay(device),
                               failover=elastic_failover_replay(device, d),
                               ab=elastic_ab(device, EL_AB_SMALL,
                                             EL_AB_SMALL_CYCLES))
    card, cpu = got[devices[0]], got[devices[-1]]
    for name in ("loan", "failover"):
        a, b = card[name], cpu[name]
        if name == "loan":
            _same_plans(name, a["plans"], b["plans"])
        else:
            _same_moves(name, a["plans"], b["plans"])
            if a["kinds"] != b["kinds"] or a["control"] != b["control"]:
                raise AssertionError(f"elastic {name}: card {a} CPU {b}")
        _same_moves(name, [dict(r, kind="row") for r in a["ledger"]],
                    [dict(r, kind="row") for r in b["ledger"]])
        if a["placed"] != b["placed"]:
            raise AssertionError(f"elastic {name}: placements differ")
    for every in (0, 1):
        a, b = card["ab"][every], cpu["ab"][every]
        if a.to_csv() != b.to_csv():
            raise AssertionError(f"elastic A/B every {every}: run traces "
                                 "differ")
        _same_plans(f"A/B every {every}", a.elastic_plans, b.elastic_plans)
    small = {every: _p50(card["ab"][every]) for every in (0, 1)}
    if not small[1] < small[0]:
        raise AssertionError(f"elastic A/B: p50 {small}")
    print(f"elastic agreement: loan, failover (control victim "
          f"{card['failover']['control']}, real cycle none, reclaim "
          f"{card['failover']['plans'][-1]}) and the A/B at 24 jobs: "
          f"{devices[0]} = {devices[-1]}; p50 queued wait static "
          f"{small[0]} ms, elastic {small[1]} ms", flush=True)
    t0 = time.perf_counter()
    big = elastic_ab(devices[0], ab, ab_cycles)
    wall = time.perf_counter() - t0
    p50 = {every: _p50(big[every]) for every in (0, 1)}
    loans = [m for p in big[1].elastic_plans for m in p["moves"]]
    print("elastic A/B " + json.dumps(dict(
        ab, devices=devices[0], p50_static_ms=p50[0],
        p50_elastic_ms=p50[1], wall_s=round(wall, 2),
        placed={e: n_placed(r.rows) for e, r in big.items()},
        cycles={e: r.cycles for e, r in big.items()},
        committed_plans=sum(1 for p in big[1].elastic_plans if p["moves"]),
        loaned_mem=sum(m["mem"] for m in loans),
        loaned_cpus=sum(m["cpus"] for m in loans),
        on_elastic_hosts=sum(1 for r in big[1].rows
                             if r["host"].startswith("elastic@")),
        elastic_wall_s=round(big[1].phase_wall_s.get("elastic", 0.0), 4))),
        flush=True)
    if not p50[1] < p50[0]:
        raise AssertionError(f"elastic A/B at {ab}: p50 {p50}")
    return p50


# ------------------------------------------------ the superblock slice

# the superblock slice's matcher: HIER_MATCH with superblocks of 4096
# hosts (4 blocks of 1024), which splits the 10,000 hosts into 3
# superblocks (the node axis padded to 12,288)
SB_SLICE_NODES = 4096
SB_MATCH = dict(HIER_MATCH, hierarchical_superblock_nodes=SB_SLICE_NODES)
# the reference's packing floor against the exact greedy
# (tests/test_hierarchical.py HIER_EFF_TOLERANCE), held where its tests
# hold it: tests/test_superblocks.py's problems and knobs (SB_PARAMS)
HIER_EFF_FLOOR = 0.95
SB_TEST_PARAMS = dict(nodes_per_block=32, superblock_nodes=64, chunk=64,
                      kc=32)
SB_TEST_WIDTHS = (320, 384, 448)


def dense_problem(j, n, seed):
    """tests/test_hierarchical.py's `dense_problem`, written here: seeded
    demands of 512-4096 MB and 0.5-4 cpus (R 3), hosts of 64 GB / 32 cpus
    with a uniform 0.2-1.0 fraction free."""
    import numpy as np

    rng = np.random.default_rng(seed)
    demands = np.stack([
        rng.choice([512.0, 1024.0, 2048.0, 4096.0], j),
        rng.choice([0.5, 1.0, 2.0, 4.0], j),
        np.zeros(j)], axis=-1).astype(np.float32)
    totals = np.stack([np.full(n, 65536.0), np.full(n, 32.0)],
                      axis=-1).astype(np.float32)
    frac = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    avail = np.concatenate([totals * frac, np.zeros((n, 1), np.float32)],
                           axis=-1)
    return demands, avail, totals


def cpus_placed(demands, assignment) -> float:
    """The cpus a schedule places (the reference tests' packing measure,
    ops/cpu_reference.packing_quality)."""
    placed = assignment >= 0
    return float(demands[placed, 1].sum())


def superblock_slice_phase(trace, classic_p50_ms):
    """21. The superblock slice (see the docstring); returns the
    best_node_batched launches and their kept calls."""
    import dataclasses

    import numpy as np

    from cook_tpu_torch.ops import hierarchical
    from cook_tpu_torch.ops.match import from_numpy, greedy_match

    solves = []
    launches, calls, result, _ = hier_slice_phase(
        trace, label="superblock slice", match_args=SB_MATCH,
        superblocks=True, solves=solves)
    walls = [{k: round(st[k], 4) for k in (
        "super_coarse_s", "coarse_s", "fine_s", "refine_s", "total_s")}
        for _, _, st in solves]
    walls_ms = sorted(result.cycle_wall_s)
    p50 = walls_ms[len(walls_ms) // 2] * 1e3
    print("superblock slice: per-solve level walls (s) " + json.dumps(walls)
          + "; " + json.dumps(dict(
              placed=n_placed(result.rows),
              cycle_p50_ms=round(p50, 2),
              classic_hier_cycle_p50_ms=round(classic_p50_ms, 2),
              superblocks=[st["superblocks"] for _, _, st in solves],
              superblock_spilled=[st["superblock_spilled"]
                                  for _, _, st in solves])), flush=True)
    # the first full window's problem (cycle 1 holds the few jobs
    # submitted at t 0): the exact greedy on the card against the
    # superblock solve with the slice's knobs (single-candidate fine
    # passes on the kernel), with the reference's default fine backend
    # (candidate lists), and the classic two-level solve
    cycle = max(range(len(solves)),
                key=lambda i: (int(solves[i][0].job_valid.sum()), -i))
    problem, params, _ = solves[cycle]
    n = int(problem.job_valid.sum())
    demands = problem.demands[:n].float().cpu().numpy()
    t0 = time.perf_counter()
    exact = greedy_match(problem).assignment[:n].cpu().numpy()
    greedy_s = time.perf_counter() - t0
    ref_cpus = cpus_placed(demands, exact)
    effs = {}
    for name, knobs in (("superblock", {}),
                        ("superblock, xla fine", {"fine_backend": "xla"}),
                        ("classic", {"superblock_nodes": 0})):
        res, _ = hierarchical.hierarchical_match(
            problem, params=dataclasses.replace(params, **knobs))
        asg = res.assignment[:n].cpu().numpy()
        effs[name] = round(cpus_placed(demands, asg) / ref_cpus, 6)
    print(f"superblock slice, cycle {cycle + 1} packing vs the exact greedy "
          "on the card " + json.dumps(dict(
              jobs=n, greedy_placed=int((exact >= 0).sum()),
              greedy_s=round(greedy_s, 3), efficiency=effs)), flush=True)
    del solves, problem
    # the floor where the reference's tests hold it, on the card
    floor = {}
    for n in SB_TEST_WIDTHS:
        demands, avail, totals = dense_problem(512, n, seed=n)
        small = from_numpy(demands, np.ones(512, bool), avail, totals,
                           np.ones(n, bool), device="cuda")
        res, st = hierarchical.hierarchical_match(
            small, params=hierarchical.HierParams(**SB_TEST_PARAMS))
        exact = greedy_match(small).assignment.cpu().numpy()
        floor[n] = round(cpus_placed(demands,
                                     res.assignment.cpu().numpy())
                         / cpus_placed(demands, exact), 6)
        if st["superblocks"] != n // 64 or floor[n] < HIER_EFF_FLOOR:
            raise AssertionError(f"superblock slice: the reference tests' "
                                 f"problem at {n} hosts packs {floor[n]} "
                                 f"({st['superblocks']} superblocks)")
    print("superblock slice: tests/test_superblocks.py's problems on the "
          "card, packing vs the exact greedy " + json.dumps(floor)
          + f" (floor {HIER_EFF_FLOOR})", flush=True)
    return launches["best_node_batched"], calls["best_node_batched"]


# the superblock layer at the scale it exists for (docs/architecture.md
# :136-172): 1M jobs x 100k hosts, superblocks of 16,384 hosts
MEGA = dict(jobs=1 << 20, hosts=100_000, superblock_nodes=16_384, seed=0,
            refine_rounds=1)
# the card-vs-CPU solve: the slice knobs at 8,192 x 1,024, superblocks of
# 256 hosts (blocks of 128: 4 superblocks)
MID = dict(jobs=8_192, hosts=1_024, superblock_nodes=256, seed=1)


def bench_problem(j, n, seed, exact_sums=False):
    """bench.make_problem's shape family (bench.py:39-56), written here:
    demands of 512-8192 MB and 0.5-4 cpus (no gpus, no disk: R 4), every
    host 64 GB / 32 cpus with a uniform 0.2-1.0 fraction free.  With
    `exact_sums` the free amounts round down to whole 512 MB and 0.5 cpu,
    so block sums are exact whatever order a device adds in."""
    import numpy as np

    rng = np.random.default_rng(seed)
    demands = np.zeros((j, 4), np.float32)
    demands[:, 0] = rng.choice([512, 1024, 2048, 4096, 8192], j)
    demands[:, 1] = rng.choice([0.5, 1, 2, 4], j)
    totals = np.stack([np.full(n, 65536.0), np.full(n, 32.0)],
                      -1).astype(np.float32)
    frac = rng.uniform(0.2, 1.0, (n, 1)).astype(np.float32)
    avail = np.zeros((n, 4), np.float32)
    avail[:, :2] = totals * frac
    if exact_sums:
        avail[:, 0] = np.floor(avail[:, 0] / 512.0) * 512.0
        avail[:, 1] = np.floor(avail[:, 1] * 2.0) / 2.0
    return demands, avail, totals


def _mega_params(superblock_nodes, refine_rounds=None):
    import dataclasses

    from cook_tpu_torch.scheduler.matcher import hier_params_from_config
    from cook_tpu_torch.utils.config import default_match_config

    params = dataclasses.replace(
        hier_params_from_config(default_match_config(**HIER_MATCH)),
        superblock_nodes=superblock_nodes)
    if refine_rounds is not None:
        params = dataclasses.replace(params, refine_rounds=refine_rounds)
    return params


def mega_solve(label, problem, params):
    """One hierarchical_match alone, its kernel calls kept and counted,
    the device memory peak read: (result, stats, {kernel: calls})."""
    import torch

    from cook_tpu_torch.ops import best_node_batched as bnb
    from cook_tpu_torch.ops import coarse_pass as cp
    from cook_tpu_torch.ops import hierarchical

    calls = {"coarse_pass": [], "best_node_batched": []}
    with kept_calls(hierarchical, "coarse_pass", calls["coarse_pass"]), \
            kept_calls(hierarchical, "best_node_batched",
                       calls["best_node_batched"]):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        bnb.launches = cp.launches = 0
        t0 = time.perf_counter()
        result, stats = hierarchical.hierarchical_match(problem,
                                                        params=params)
        wall = time.perf_counter() - t0
        launches = {"best_node_batched": bnb.launches,
                    "coarse_pass": cp.launches}
    peak = torch.cuda.max_memory_allocated()
    for name, kept in calls.items():
        if len(kept) != launches[name]:
            raise AssertionError(f"{label}: kept {len(kept)} {name} calls, "
                                 f"counted {launches[name]}")
    print(f"{label} " + json.dumps(dict(
        wall_s=round(wall, 3),
        **{k: round(stats[k], 4) for k in ("super_coarse_s", "coarse_s",
                                           "fine_s", "refine_s")},
        placed=stats["placed"], launches=launches,
        device_peak_gb=round(peak / 2**30, 3),
        superblocks=stats["superblocks"], blocks=stats["blocks"],
        super_shape=stats["super_shape"],
        coarse_shape=stats["coarse_shape"], fine_shape=stats["fine_shape"],
        refine_rounds=stats["refine_rounds"],
        superblock_spilled=stats["superblock_spilled"],
        spilled=stats["spilled"])), flush=True)
    return result, stats, calls


def hold_batched_by_blocks(label, args, step=8):
    """best_node_batched on one launch's arguments against its plain
    version, bit for bit, the plain version run `step` blocks at a time
    (its [B, S, N] score would not fit the card whole; the blocks are
    independent problems)."""
    import torch

    from cook_tpu_torch.ops import best_node_batched as bnb

    val, idx = bnb.best_node_batched(*args)
    demands, avail, totals, valid, mask = args
    for b0 in range(0, demands.shape[0], step):
        sl = slice(b0, b0 + step)
        want_val, want_idx = bnb.best_node_batched_reference(
            demands[sl], avail[sl], totals[sl], valid[sl],
            None if mask is None else mask[sl])
        if not (torch.equal(idx[sl], want_idx) and torch.equal(
                val[sl].view(torch.int32), want_val.view(torch.int32))):
            raise AssertionError(f"{label}: best_node_batched blocks "
                                 f"{b0}-{b0 + step} differ from the plain "
                                 "version")


def superblock_mega_phase(mega=MEGA, mid=MID):
    """22. The superblock layer at 1M x 100k (see the docstring)."""
    import numpy as np
    import torch

    from cook_tpu_torch.ops import hierarchical
    from cook_tpu_torch.ops.match import from_numpy

    phase("superblock at scale")
    t0 = time.perf_counter()
    demands, avail, totals = bench_problem(mega["jobs"], mega["hosts"],
                                           mega["seed"])
    problem = from_numpy(demands, np.ones(mega["jobs"], bool), avail,
                         totals, np.ones(mega["hosts"], bool),
                         device="cuda")
    print(f"superblock at scale: {mega['jobs']} jobs x {mega['hosts']} "
          f"hosts built in {time.perf_counter() - t0:.2f} s", flush=True)
    busiest = {}
    for sbn in (mega["superblock_nodes"], 0):
        label = f"superblock at scale, superblock_nodes {sbn}"
        # the superblock solve at one refine round (the layer doubles it
        # to two): each round re-runs both coarse levels over the 1M rows,
        # 28-48 s of a 35-58 s solve at the default's four
        params = _mega_params(sbn, mega["refine_rounds"] if sbn else None)
        result, stats, calls = mega_solve(f"{label} cold", problem, params)
        cold = result.assignment.cpu().numpy()
        for name, kept in calls.items():
            if kept:
                i = max(range(len(kept)),
                        key=lambda k: (_unplaced(kept[k]), -k))
                busiest[(sbn, name)] = kept[i]
        del calls, result
        if sbn:
            if stats["superblocks"] < 2:
                raise AssertionError(f"{label}: the layer stood down")
            # one solve: nothing compiles in the port (on one H100 a warm
            # superblock solve took 61.49 s against the cold 58.41 s)
            continue
        result, _, _ = mega_solve(f"{label} warm", problem, params)
        if not np.array_equal(result.assignment.cpu().numpy(), cold):
            raise AssertionError(f"{label}: the warm solve differs from "
                                 "the cold one")
        del result
    # every solve's kernels on the card: the superblock path runs no
    # coarse_pass, the classic one does
    if (mega["superblock_nodes"], "coarse_pass") in busiest \
            or (0, "coarse_pass") not in busiest:
        raise AssertionError("superblock at scale: coarse_pass launches "
                             f"{sorted(busiest)}")
    for (sbn, name), args in busiest.items():
        label = f"superblock at scale (superblock_nodes {sbn}) busiest {name}"
        bound = {}
        if name == "best_node_batched":
            hold_batched_by_blocks(label, args)
            bound = dict(zip(("bound_ms", "bound_by"),
                             best_node_batched_bound(*args)))
        else:
            check_identical(name, label, args)
        row = dict(ms=cuda_ms(lambda: getattr(_module(name), name)(*args),
                              reps=5, cold=True),
                   warm_ms=cuda_ms(lambda: getattr(_module(name),
                                                   name)(*args), reps=5),
                   live=_unplaced(args), **bound,
                   shapes=[list(a.shape) for a in args
                           if isinstance(a, torch.Tensor)])
        print(f"{label}: identical to the plain version; "
              + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in row.items()}), flush=True)
    del busiest, problem
    # the card-vs-CPU solve at 8,192 x 1,024 (exact-sum free capacity)
    demands, avail, totals = bench_problem(mid["jobs"], mid["hosts"],
                                           mid["seed"], exact_sums=True)
    params = _mega_params(mid["superblock_nodes"])
    out = {}
    for device in ("cuda", "cpu"):
        small = from_numpy(demands, np.ones(mid["jobs"], bool), avail,
                           totals, np.ones(mid["hosts"], bool),
                           device=device)
        t0 = time.perf_counter()
        result, stats = hierarchical.hierarchical_match(small, params=params)
        out[device] = (result.assignment.cpu().numpy(),
                       result.new_avail.cpu().numpy(), stats,
                       time.perf_counter() - t0)
    if not (np.array_equal(out["cuda"][0], out["cpu"][0])
            and np.array_equal(out["cuda"][1], out["cpu"][1])):
        raise AssertionError("superblock at scale: the 8,192 x 1,024 solve "
                             "differs between the card and the CPU")
    stats = out["cuda"][2]
    print(f"superblock at scale: {mid['jobs']} x {mid['hosts']} card = CPU "
          "(assignment, availability); " + json.dumps(dict(
              superblocks=stats["superblocks"], placed=stats["placed"],
              card_s=round(out["cuda"][3], 3),
              cpu_s=round(out["cpu"][3], 3))), flush=True)


def quality_audit_phase(trace, classic_csv, classic_walls):
    """23. The quality audit on the flat slice (see the docstring)."""
    from cook_tpu_torch.scheduler import matcher
    from cook_tpu_torch.sim import cli
    from cook_tpu_torch.sim.simulator import Simulator, load_trace
    from cook_tpu_torch.utils.metrics import global_registry

    phase("quality audit")
    gauge = global_registry.gauge("match.quality_audit")
    gauge.set(-1.0, labels={"pool": "default"})
    audits = []
    audit = matcher.audit_match_quality

    def timed(problem, n, assignment, pool):
        t0 = time.perf_counter()
        ratio = audit(problem, n, assignment, pool)
        audits.append((problem, n, assignment, ratio,
                       time.perf_counter() - t0,
                       threading.current_thread().name))
        return ratio

    args = cli.build_parser().parse_args(
        ["run", "--trace", trace, "--out", os.devnull, "--device", "cuda",
         *SLICE_ARGS])
    config = cli.sim_config(args)
    # the audit replays cycle 2's solve while cycles 2-3 run on
    config.scheduler.match.quality_audit_every = 2
    matcher.audit_match_quality = timed
    try:
        sim = Simulator(*load_trace(trace), config, device="cuda")
        t0 = time.perf_counter()
        result = sim.run()
        wall = time.perf_counter() - t0
        thread = matcher.last_audit_thread
        thread.join(timeout=600)
    finally:
        matcher.audit_match_quality = audit
    if thread.is_alive() or len(audits) != 1:
        raise AssertionError(f"quality audit: {len(audits)} audits, "
                             f"thread alive {thread.is_alive()}")
    if result.to_csv() != classic_csv:
        raise AssertionError("quality audit: the run trace differs from the "
                             "flat slice's (the audit must only observe)")
    problem, n, assignment, ratio, audit_s, thread_name = audits[0]
    value = gauge.value(labels={"pool": "default"})
    # the CPU port on the same problem and assignment, on this thread
    again = audit(problem, n, assignment, "default-recheck")
    if value != ratio or again != ratio or not 0.0 < ratio:
        raise AssertionError(f"quality audit: gauge {value}, thread "
                             f"{ratio}, recomputed {again}")
    print("quality audit " + json.dumps(dict(
        ratio=ratio, jobs=n, thread=thread_name,
        audit_s=round(audit_s, 3), replay_s=round(wall, 2),
        cycle_wall_ms_audit_on=[round(w * 1e3, 1)
                                for w in result.cycle_wall_s],
        cycle_wall_ms_audit_off=[round(w * 1e3, 1)
                                 for w in classic_walls])), flush=True)


def _fault_rig(device, pools=("default",), hosts_per_pool=4, jobs=6):
    """A small scheduler on `device`: 4000 MB / 8 cpu hosts per pool, 200
    MB / 1 cpu jobs (tests/test_faults.py's rig)."""
    from cook_tpu_torch.cluster.mock import MockCluster, MockHost
    from cook_tpu_torch.models.entities import Job, Pool, Resources
    from cook_tpu_torch.models.store import JobStore
    from cook_tpu_torch.scheduler.core import Scheduler, SchedulerConfig
    from cook_tpu_torch.scheduler.matcher import MatchConfig

    clock = _Clock()
    store = JobStore(clock=clock)
    for name in pools:
        store.set_pool(Pool(name=name))
    cluster = MockCluster("mock", [
        MockHost(node_id=f"{p}-h{i}", hostname=f"{p}-h{i}", mem=4000,
                 cpus=8, pool=p)
        for p in pools for i in range(hosts_per_pool)], clock=clock)
    scheduler = Scheduler(store, [cluster], SchedulerConfig(
        match=MatchConfig(chunk=0)), device=device)
    store.submit_jobs([
        Job(uuid=f"{p}-j{i}", user=f"u{i % 3}", pool=p, priority=50,
            max_retries=5, command="true",
            resources=Resources(mem=200, cpus=1))
        for p in pools for i in range(jobs)])
    return clock, store, cluster, scheduler


def faults_phase(device="cuda"):
    """24. Faults, incidents, admission (see the docstring)."""
    from cook_tpu_torch import faults
    from cook_tpu_torch.obs import profiling
    from cook_tpu_torch.obs.telemetry import DeviceTelemetry
    from cook_tpu_torch.scheduler import flight_recorder as codes

    phase("faults, incidents, admission")
    error = {"point": "device.solve", "times": 1}
    # serial: the injected error raises out of match_cycle
    clock, store, _, scheduler = _fault_rig(device)
    pool = store.pools["default"]
    scheduler.rank_cycle(pool)
    with faults.injected(error):
        try:
            scheduler.match_cycle(pool)
        except OSError:
            pass
        else:
            raise AssertionError("faults: a device.solve error did not "
                                 "surface from match_cycle")
    if store.instances:
        raise AssertionError("faults: a failed serial solve launched")
    if len(scheduler.match_cycle(pool).matched) != 6:
        raise AssertionError("faults: the next serial cycle did not place")
    # batched: the shared solve raises out of match_cycle_all_pools
    pools = ("p0", "p1", "p2")
    clock, store, _, scheduler = _fault_rig(device, pools=pools,
                                            hosts_per_pool=1, jobs=3)
    with faults.injected(error):
        try:
            scheduler.match_cycle_all_pools()
        except OSError:
            pass
        else:
            raise AssertionError("faults: a device.solve error did not "
                                 "surface from the batched pass")
    # pipelined: the pool's jobs skip with solve-failed, the others place
    clock, store, _, scheduler = _fault_rig(device, pools=pools,
                                            hosts_per_pool=1, jobs=3)
    for p in store.pools.values():
        scheduler.rank_cycle(p)
    with faults.injected(dict(error, match={"pool": "p1"})):
        outcomes = scheduler.match_cycle_pipelined()
    scheduler.drain_launches()
    skipped = [scheduler.recorder.job_reason(f"p1-j{i}")[1]
               for i in range(3)]
    if outcomes["p1"].matched or skipped != [codes.SOLVE_FAILED] * 3 \
            or len(outcomes["p0"].matched) != 3 \
            or len(outcomes["p2"].matched) != 3:
        raise AssertionError(f"faults: pipelined outcomes {skipped}")
    print("faults: device.solve raised out of the serial and batched "
          "passes; the pipelined pass skipped pool p1 with solve-failed "
          "(3 jobs), p0 and p2 placed 3 each", flush=True)
    # a delay fault drives health ok -> degraded: one incident bundle,
    # with a torch.profiler capture holding CUDA kernel events
    with tempfile.TemporaryDirectory(prefix="cook-profile-") as pdir:
        clock, store, _, scheduler = _fault_rig(device, jobs=0)
        scheduler.incidents.cooldown_s = 0.0
        scheduler.telemetry = DeviceTelemetry(
            latency_window=16, latency_recent=2, latency_min_samples=3,
            latency_rel_floor=5.0, update_memory_gauges=False)
        scheduler.telemetry.health_observer = scheduler.incidents.observe
        scheduler.profiler = profiling.ProfileCapturer(
            base_dir=pdir, default_duration_s=2.0, cooldown_s=0.0)
        scheduler.incidents.profiler = scheduler.profiler
        scheduler.incidents.auto_profile = True
        seq = [0]

        def cycle():
            from cook_tpu_torch.models.entities import Job, Resources

            store.submit_jobs([Job(
                uuid=f"d{seq[0]}-{i}", user=f"u{i}", pool="default",
                priority=50, max_retries=5, command="true",
                resources=Resources(mem=100, cpus=0.5)) for i in range(2)])
            seq[0] += 1
            p = store.pools["default"]
            scheduler.rank_cycle(p)
            scheduler.match_cycle(p)
            clock.now_ms += 1000

        for _ in range(6):
            cycle()
        if scheduler.telemetry.health()["status"] != "ok":
            raise AssertionError("faults: health not ok before the fault")
        with faults.injected({"point": "device.solve", "mode": "delay",
                              "delay_s": 0.25}):
            for _ in range(4):
                cycle()
            verdict = scheduler.telemetry.health()
        bundles = scheduler.incidents.bundles()
        if verdict["status"] != "degraded" or len(bundles) != 1:
            raise AssertionError(f"faults: verdict {verdict['reasons']}, "
                                 f"{len(bundles)} bundles")
        bundle = scheduler.incidents.get(bundles[0]["id"])
        capture = bundle.get("profile") or {}
        if not capture.get("started"):
            raise AssertionError(f"faults: no profile capture {capture}")
        while scheduler.profiler.status()["active"] is not None:
            cycle()  # kernels on the card while the capture is open
        path = os.path.join(capture["log_dir"], profiling.TRACE_FILE)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = sum(1 for e in events if e.get("cat") == "kernel")
        if kernels < 1:
            raise AssertionError("faults: the profile holds no CUDA kernel "
                                 f"event ({len(events)} events)")
        for _ in range(40):
            cycle()
            if scheduler.telemetry.health()["status"] == "ok":
                break
        summary = scheduler.incidents.bundles()
        if len(summary) != 1 or summary[0]["recovered_time"] is None:
            raise AssertionError(f"faults: after recovery {summary}")
        print("faults: delay -> " + json.dumps(dict(
            reasons=verdict["reasons"], bundles=len(summary),
            evidence=sorted(bundle), profile_events=len(events),
            cuda_kernel_events=kernels,
            recovered=summary[0]["recovered_time"] is not None)),
            flush=True)
    # admission: x0.95 a cycle down to a tenth of the window, then reset
    clock, store, _, scheduler = _fault_rig(device, jobs=2)
    overloaded = {"v": True}
    scheduler.admission.overload_fn = lambda: overloaded["v"]
    caps = []
    p = store.pools["default"]
    for _ in range(50):
        scheduler.rank_cycle(p)
        scheduler.match_cycle(p)
        caps.append(scheduler.admission.cap("default"))
    overloaded["v"] = False
    scheduler.match_cycle(p)
    steps, cap = [], 1000
    for _ in range(50):
        cap = max(100, int(cap * 0.95))
        steps.append(cap)
    if caps != steps or scheduler.admission.cap("default") != 1000:
        raise AssertionError(f"admission caps {caps[:5]}...{caps[-3:]}")
    print("admission: caps " + json.dumps(caps[:4] + ["..."] + caps[-2:])
          + ", reset to 1000 when the overload cleared", flush=True)


# the service phase (25): the flat slice's fleet and knobs behind the REST
# service; SERVICE_JOBS submitted in SERVICE_BATCHES POSTs, one user each
SERVICE_HOSTS = 10_000
SERVICE_JOBS = 20_000
SERVICE_BATCHES = 20
SERVICE_MATCH = dict(max_jobs_considered=16_384, chunk=1024,
                     backend="pallas")
# match cycles with a considerable window that must run after the last
# submit, and the wall the phase gives them
SERVICE_CYCLES = 3
SERVICE_DEADLINE_S = 240.0
# jobs read back one by one, and jobs submitted to the subprocess
SERVICE_SAMPLE = 200
SERVICE_RESTART_JOBS = 1_000
# every request's timeout: a hung handler fails the phase
HTTP_TIMEOUT_S = 60.0


def http(method, url, body=None, user="alice", timeout=HTTP_TIMEOUT_S):
    """One request on the standard library that follows no redirect (a
    standby's 307 to its leader is an answer): (status, parsed body, wall
    s, headers).  The reference's clients use `requests`; the card's
    machine has none."""
    from http.client import HTTPConnection
    from urllib.parse import urlsplit

    parts = urlsplit(url)
    path = parts.path + (f"?{parts.query}" if parts.query else "")
    data = None if body is None else json.dumps(body).encode()
    conn = HTTPConnection(parts.hostname, parts.port, timeout=timeout)
    t0 = time.perf_counter()
    try:
        conn.request(method, path, body=data, headers={
            "X-Cook-Requesting-User": user,
            "Content-Type": "application/json"})
        resp = conn.getresponse()
        status, raw = resp.status, resp.read()
        headers = dict(resp.getheaders())
    finally:
        conn.close()
    wall = time.perf_counter() - t0
    try:
        return status, json.loads(raw), wall, headers
    except ValueError:
        return status, raw.decode(), wall, headers


class RouteClock:
    """Host-clock request latency per route template."""

    def __init__(self):
        self.walls: dict[str, list] = {}

    def call(self, route, method, url, want, **kw):
        status, body, wall, _ = http(method, url, **kw)
        self.walls.setdefault(route, []).append(wall)
        if status != want:
            raise AssertionError(f"service: {method} {url} answered "
                                 f"{status}, not {want}: {str(body)[:300]}")
        return body

    def summary(self):
        out = {}
        for route, walls in self.walls.items():
            walls = sorted(walls)
            out[route] = dict(
                n=len(walls),
                p50_ms=round(1e3 * walls[len(walls) // 2], 3),
                p99_ms=round(1e3 * walls[min(len(walls) - 1,
                                             int(0.99 * len(walls)))], 3))
        return out


def service_fleet(n_hosts=SERVICE_HOSTS, n_jobs=SERVICE_JOBS):
    """The mock cluster's hosts and the jobs' shapes, as `sim.cli synth
    --hosts 10000` makes them (64 GB / 32 cpu hosts)."""
    from cook_tpu_torch.sim.simulator import synth_trace

    jobs, hosts = synth_trace(n_jobs, n_hosts, n_users=SERVICE_BATCHES,
                              seed=0)
    return ([{"node_id": h.node_id, "hostname": h.hostname, "mem": h.mem,
              "cpus": h.cpus} for h in hosts],
            [{"command": f"work {j.uuid}", "mem": j.mem, "cpus": j.cpus,
              "priority": j.priority} for j in jobs])


def service_config(port, data_dir, hosts, device="cuda"):
    """The node's config: the fleet in one mock cluster whose tasks run
    far past the phase (no host frees up mid-check), one pool, the flat
    slice's matcher, a journal in `data_dir`, short loop intervals; the
    platform "" (the card) unless `device` is "cpu"."""
    return {"port": port, "pools": [{"name": "default"}],
            "platform": "" if device == "cuda" else device,
            "match": dict(SERVICE_MATCH), "data_dir": data_dir,
            "rank_interval_s": 0.5, "match_interval_s": 0.5,
            "clusters": [{"kind": "mock", "name": "fleet",
                          "default_runtime_ms": 3_600_000,
                          "hosts": hosts}]}


def check_cluster_capacity(cluster):
    """No host of a mock cluster runs more than it holds."""
    used = {}
    for rt in list(cluster.running.values()):
        u = used.setdefault(rt.spec.node_id, [0.0, 0.0, 0.0])
        u[0] += rt.spec.mem
        u[1] += rt.spec.cpus
        u[2] += rt.spec.gpus
    for node_id, (mem, cpus, gpus) in used.items():
        h = cluster.hosts[node_id]
        if mem > h.mem or cpus > h.cpus or gpus > h.gpus:
            raise AssertionError(
                f"service: host {node_id} over-committed: ({mem}, {cpus}, "
                f"{gpus}) > ({h.mem}, {h.cpus}, {h.gpus})")
    return len(used)


def service_inprocess(hosts, specs, workdir, device="cuda"):
    """(a) The node in this process: `build_process` + the leader loops;
    the backlog over REST; the reads; the checks.  Returns (best_node
    launches, the kept best_node calls of the matcher)."""
    from cook_tpu_torch.components import (build_process, shutdown,
                                           start_leader_duties)
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import match
    from cook_tpu_torch.rest.server import free_port
    from cook_tpu_torch.utils.config import read_config

    port = free_port()
    cfg = os.path.join(workdir, "service.json")
    with open(cfg, "w") as f:
        # no load shedding: on a slower host some of the 1,000-job submits
        # beside the running match loop pass the 1 s commit-ack SLO, and
        # the node then answers the heavy reads below 429 (as designed;
        # the CPU tests hold the shedder) until the burn leaves the SLO's
        # 300 s fast window, so a retry after Retry-After serves nothing
        # within the phase
        json.dump(dict(service_config(port, os.path.join(workdir, "data-a"),
                                      hosts, device), load_shedding=False),
                  f)
    settings = read_config(cfg)
    url = f"http://127.0.0.1:{port}"
    clock = RouteClock()
    calls = []
    process = None
    try:
        with kept_calls(match, "best_node", calls):
            _reset_launches()
            process = build_process(settings)
            if process.scheduler.device.type != device:
                raise AssertionError(f"service: the scheduler runs on "
                                     f"{process.scheduler.device}")
            start_leader_duties(process, block=False)
            debug = clock.call("/debug", "GET", f"{url}/debug", 200)
            if debug != {"healthy": True, "leader": True}:
                raise AssertionError(f"service: /debug says {debug}")
            acked, batch_walls = [], []
            per = len(specs) // SERVICE_BATCHES
            for b in range(SERVICE_BATCHES):
                t0 = time.perf_counter()
                body = clock.call("/jobs", "POST", f"{url}/jobs", 201,
                                  body={"jobs": specs[b * per:(b + 1) * per]},
                                  user=f"user{b}")
                batch_walls.append(round(time.perf_counter() - t0, 4))
                acked += body["jobs"]
            print(f"service submit: {len(acked)} jobs in {SERVICE_BATCHES} "
                  f"POSTs of {per}, wall per batch (s) {batch_walls}",
                  flush=True)
            recorder = process.scheduler.recorder
            last = max([r["cycle"] for r in recorder.records_json(limit=1)]
                       or [0])
            deadline = time.monotonic() + SERVICE_DEADLINE_S
            while True:
                body = clock.call("/debug/cycles", "GET",
                                  f"{url}/debug/cycles?since={last}&limit=50",
                                  200)
                full = [r for r in body["cycles"] if r["considered"] > 0]
                if len(full) >= SERVICE_CYCLES:
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"service: {len(full)} match cycles with a window "
                        f"in {SERVICE_DEADLINE_S} s")
                time.sleep(0.5)
            # the reads while the loops run
            sample = acked[::len(acked) // SERVICE_SAMPLE][:SERVICE_SAMPLE]
            for uuid in sample:
                clock.call("/jobs/{uuid}", "GET", f"{url}/jobs/{uuid}", 200)
            clock.call("/queue", "GET", f"{url}/queue", 200)
            running = clock.call("/running", "GET", f"{url}/running", 200)
            for uuid in sample[:20]:
                clock.call("/unscheduled_jobs", "GET",
                           f"{url}/unscheduled_jobs?job={uuid}", 200)
            for b in range(0, SERVICE_BATCHES, 5):
                clock.call("/usage", "GET", f"{url}/usage?user=user{b}", 200)
            metrics = clock.call("/metrics", "GET", f"{url}/metrics", 200)
            clock.call("/debug", "GET", f"{url}/debug", 200)
            device = clock.call("/debug/device", "GET", f"{url}/debug/device",
                                200, user="admin")
            cycles = clock.call("/debug/cycles", "GET",
                                f"{url}/debug/cycles?since={last}&limit=50",
                                200)["cycles"]
            # stop the loops (and the cycle in flight) but not the server
            for loop in process.loops:
                loop.stop()
            for loop in process.loops:
                loop.join(60)
            launches = bn.launches
        if "cook_jobs_submitted" not in metrics or not running:
            raise AssertionError("service: /metrics or /running empty")
        if "device_state" not in device:
            raise AssertionError("service: /debug/device lacks device_state")
        # what the REST layer says equals the store, loops at rest
        store = process.store
        for uuid in sample:
            got = http("GET", f"{url}/jobs/{uuid}")[1]["status"]
            if got != store.jobs[uuid].state.value:
                raise AssertionError(f"service: /jobs/{uuid} says {got}, "
                                     f"the store {store.jobs[uuid].state}")
        skipped = [s for r in recorder.records_json(limit=10_000)
                   for s in r["skipped"] if s["code"] == "solve-failed"]
        if skipped:
            raise AssertionError(f"service: {len(skipped)} solve-failed "
                                 "skips")
        busy = check_cluster_capacity(process.clusters[0])
        placed = sum(1 for j in store.jobs.values()
                     if j.state.value != "waiting")
    finally:
        if process is not None:
            shutdown(process)
    walls = [round(r["total_s"], 4) for r in cycles
             if r["considered"] > 0]
    print("service " + json.dumps(dict(
        placed=placed, busy_hosts=busy, best_node_launches=launches,
        cycles_after_submit=len(walls), cycle_walls_s=walls,
        considered=[r["considered"] for r in cycles if r["considered"]],
        matched=[r["matched_count"] for r in cycles if r["considered"]],
        backends=sorted({r["backend"] for r in cycles if r["considered"]}),
        capacity="ok")), flush=True)
    print("service request latency (host clock) "
          + json.dumps(clock.summary()), flush=True)
    return launches, calls


def _service_process(cfg, log):
    """`python3 -m cook_tpu_torch --config cfg` from the checkout's root."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with open(log, "ab") as out:
        return subprocess.Popen(
            [sys.executable, "-m", "cook_tpu_torch", "--config", cfg],
            cwd=ROOT, env=env, stdout=out, stderr=out)


def _healthy(url, proc, deadline_s=120.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"service process exited {proc.returncode} "
                                 "while booting")
        try:
            status, body, *_ = http("GET", f"{url}/debug", timeout=5)
            if status == 200:
                return body
        except OSError:
            pass
        time.sleep(0.25)
    raise AssertionError("service process: /debug never answered")


def _terminate(proc, label):
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=90)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=30)
        raise AssertionError(f"{label}: no exit within 90 s of SIGTERM")
    if rc != 0:
        raise AssertionError(f"{label}: exit code {rc} after SIGTERM")


def service_restart(hosts, specs, workdir, device="cuda"):
    """(b) `python -m cook_tpu_torch` as a subprocess on the same fleet:
    boot, SERVICE_RESTART_JOBS submitted, one running, SIGTERM; then a
    second process on the same data_dir reads back every acked job."""
    from cook_tpu_torch.rest.server import free_port

    port = free_port()
    cfg = os.path.join(workdir, "service-main.json")
    with open(cfg, "w") as f:
        json.dump(service_config(port, os.path.join(workdir, "data-b"),
                                 hosts, device), f)
    url = f"http://127.0.0.1:{port}"
    log = os.path.join(workdir, "service-main.log")
    walls = {}
    t0 = time.perf_counter()
    proc = _service_process(cfg, log)
    try:
        if _healthy(url, proc) != {"healthy": True, "leader": True}:
            raise AssertionError("service process: not the leader")
        walls["boot_s"] = time.perf_counter() - t0
        status, body, wall, _ = http("POST", f"{url}/jobs", body={
            "jobs": specs[:SERVICE_RESTART_JOBS]})
        if status != 201:
            raise AssertionError(f"service process: submit {status}")
        acked = body["jobs"]
        walls["submit_s"] = wall
        deadline = time.monotonic() + 120
        while not any(http("GET", f"{url}/jobs/{u}")[1]["status"]
                      == "running" for u in acked[:8]):
            if time.monotonic() > deadline:
                raise AssertionError("service process: nothing running")
            time.sleep(0.25)
        walls["first_running_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        _terminate(proc, "service process")
        walls["sigterm_exit_s"] = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    t0 = time.perf_counter()
    proc = _service_process(cfg, log)
    try:
        _healthy(url, proc)
        walls["reboot_s"] = time.perf_counter() - t0
        states = {}
        for uuid in acked:
            status, body, *_ = http("GET", f"{url}/jobs/{uuid}")
            if status != 200:
                raise AssertionError(f"service restart: acked job {uuid} "
                                     f"reads {status} after the restart")
            states[body["status"]] = states.get(body["status"], 0) + 1
        _terminate(proc, "restarted service process")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    print("service restart " + json.dumps(dict(
        acked=len(acked), read_back=sum(states.values()), states=states,
        **{k: round(v, 3) for k, v in walls.items()})), flush=True)


def service_phase():
    """25. The service (see the docstring)."""
    phase("service")
    hosts, specs = service_fleet()
    with tempfile.TemporaryDirectory(prefix="cook-service-") as workdir:
        launches, calls = service_inprocess(hosts, specs, workdir)
        # best_node counts only launches on CUDA tensors
        if launches <= 0 or len(calls) != launches:
            raise AssertionError(f"service: kept {len(calls)} best_node "
                                 f"calls, counted {launches} launches")
        max_err = hold_launches("best_node", calls, "service")
        del calls
        service_restart(hosts, specs, workdir)
    return launches, max_err


# the failover phase (26): phase 25's fleet and knobs behind a lease
# service, a sync-acking leader A (a subprocess) and a standby B (this
# process, so that its launches are counted and kept)
FAILOVER_JOBS = 10_000
FAILOVER_BATCHES = 10
FAILOVER_TTL_S = 3.0
FAILOVER_CYCLES = 3
# a sync-ack submit commits either way; the phase fails on any 201 that
# says "replicated": false, so the bound is generous
FAILOVER_ACK_TIMEOUT_S = 30.0
# every acked job is read back from B through GET /jobs?uuid=... this
# many at a time, and SERVICE_SAMPLE of them through GET /jobs/{uuid}
FAILOVER_READ_BATCH = 500


def _hop_wall(headers, key):
    """One phase wall of a response's X-Cook-Hop-Walls (`k=v;...`)."""
    for part in (headers.get("X-Cook-Hop-Walls") or "").split(";"):
        name, _, value = part.partition("=")
        if name == key:
            return float(value)
    return 0.0


def jobs_of(url, uuids, batch=FAILOVER_READ_BATCH):
    """uuid -> job, every uuid through GET /jobs?uuid=... `batch` at a
    time.  Fails on any answer but 200."""
    from urllib.parse import urlencode

    jobs = {}
    for i in range(0, len(uuids), batch):
        chunk = uuids[i:i + batch]
        status, body, *_ = http(
            "GET", f"{url}/jobs?" + urlencode([("uuid", u) for u in chunk]))
        if status != 200 or [j["uuid"] for j in body] != chunk:
            raise AssertionError(f"failover: GET /jobs of acked jobs "
                                 f"{i}-{i + len(chunk)} answered {status} "
                                 f"{str(body)[:300]}")
        jobs.update((j["uuid"], j) for j in body)
    return jobs


def read_back(url, uuids, batch=FAILOVER_READ_BATCH, sample=SERVICE_SAMPLE):
    """Every uuid through GET /jobs?uuid=... `batch` at a time, and every
    len(uuids) // sample-th through GET /jobs/{uuid}, which must say what
    the batch said (the node's loops at rest).  Fails on any answer but
    200.  Returns uuid -> the batch's job."""
    jobs = jobs_of(url, uuids, batch)
    for uuid in uuids[::max(1, len(uuids) // sample)]:
        status, body, *_ = http("GET", f"{url}/jobs/{uuid}")
        if status != 200 or body["status"] != jobs[uuid]["status"]:
            raise AssertionError(f"failover: GET /jobs/{uuid} answered "
                                 f"{status} {str(body)[:300]}, the batch "
                                 f"{jobs[uuid]['status']}")
    return jobs


def failover_config(port, data_dir, hosts, lease_url, device="cuda",
                    **extra):
    """Phase 25's node config on the lease service at `lease_url`."""
    conf = service_config(port, data_dir, hosts, device)
    conf.update(leader_endpoint=lease_url, leader_ttl_s=FAILOVER_TTL_S,
                **extra)
    return conf


def _lease_service(log):
    """`python3 -m cook_tpu_torch.control.lease_server` on a free port:
    (process, url)."""
    from cook_tpu_torch.rest.server import free_port

    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    with open(log, "ab") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "cook_tpu_torch.control.lease_server",
             "--host", "127.0.0.1", "--port", str(port)],
            cwd=ROOT, env=env, stdout=out, stderr=out)
    url = f"http://127.0.0.1:{port}"
    deadline = time.monotonic() + 60
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"lease service exited {proc.returncode}")
        try:
            if http("GET", f"{url}/healthz", timeout=5)[0] == 200:
                return proc, url
        except OSError:
            pass
        if time.monotonic() > deadline:
            raise AssertionError("lease service: /healthz never answered")
        time.sleep(0.1)


def _until(what, deadline_s, probe, every_s=0.1):
    """Poll `probe()` until it returns a true value, which is returned."""
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            got = probe()
        except OSError:
            got = None
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError(f"failover: {what} not within "
                                 f"{deadline_s} s")
        time.sleep(every_s)


def failover_run(hosts, specs, workdir, device="cuda"):
    """26. A lease service and leader A as subprocesses, standby B in this
    process; the backlog to A with sync acks; SIGKILL A; B promotes and
    schedules.  Returns (B's best_node launches, the kept calls)."""
    from cook_tpu_torch.components import (build_process, shutdown,
                                           start_leader_duties)
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import match
    from cook_tpu_torch.rest.server import free_port
    from cook_tpu_torch.utils.config import read_config

    procs, calls = [], []
    standby = thread = None
    logs = {name: os.path.join(workdir, f"failover-{name}.log")
            for name in ("lease", "a")}
    try:
        lease_proc, lease_url = _lease_service(logs["lease"])
        procs.append(lease_proc)
        configs, urls = {}, {}
        for name, extra in (
                ("a", dict(replication_sync_ack=True,
                           replication_min_acks=1,
                           replication_ack_timeout_s=FAILOVER_ACK_TIMEOUT_S)),
                ("b", {})):
            port = free_port()
            configs[name] = os.path.join(workdir, f"failover-{name}.json")
            with open(configs[name], "w") as f:
                json.dump(failover_config(
                    port, os.path.join(workdir, f"failover-data-{name}"),
                    hosts, lease_url, device, **extra), f)
            urls[name] = f"http://127.0.0.1:{port}"
        a_url, b_url = urls["a"], urls["b"]
        t0 = time.perf_counter()
        leader = _service_process(configs["a"], logs["a"])
        procs.append(leader)
        with kept_calls(match, "best_node", calls):
            # B's node is built while A boots; B bids for the lease only
            # once its duties start, after A leads
            standby = build_process(read_config(configs["b"]))
            _healthy(a_url, leader)
            _until("A leading", 120, lambda: http(
                "GET", f"{a_url}/debug", timeout=5)[1]["leader"])
            boot_s = time.perf_counter() - t0
            # 1. B stands by and its follower has proved the leader's head.
            # One write to A first, an admin share for a user who submits
            # nothing: it wakes the follower's first long-poll (on an idle
            # leader that poll parks its whole 8 s), and its 201 waits for
            # B's durable ack
            probe = {}
            writer = threading.Thread(target=lambda: probe.update(
                answer=http("POST", f"{a_url}/share", user="admin", body={
                    "user": "failover-probe", "pool": "default",
                    "share": {"mem": 1.0, "cpus": 1.0}})), daemon=True)
            writer.start()
            t0 = time.perf_counter()
            thread = threading.Thread(
                target=start_leader_duties, args=(standby,),
                kwargs={"block": False, "on_loss": lambda: None},
                daemon=True, name="failover-standby")
            thread.start()
            _until("B's first sync", 60, lambda: http(
                "GET", f"{b_url}/debug/replica", user="admin", timeout=5
            )[1]["shards"].get("0", {}).get("staleness_ms") is not None)
            synced_s = time.perf_counter() - t0
            writer.join(FAILOVER_ACK_TIMEOUT_S + HTTP_TIMEOUT_S)
            status, body = probe.get("answer", (None, None))[:2]
            if status != 201 or body.get("replicated") is False:
                raise AssertionError(f"failover: the first write to A "
                                     f"answered {status} {str(body)[:300]}")
            if http("GET", f"{b_url}/debug")[1]["leader"]:
                raise AssertionError("failover: B leads beside A")
            # 2. the backlog to A, B's staleness sampled meanwhile
            lag, sampling = [], threading.Event()

            def sample():
                while not sampling.wait(0.05):
                    lag.append(standby.follower.staleness_ms())

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            acked, walls, ack_walls = [], [], []
            per = len(specs) // FAILOVER_BATCHES
            try:
                for b in range(FAILOVER_BATCHES):
                    status, body, wall, headers = http(
                        "POST", f"{a_url}/jobs",
                        body={"jobs": specs[b * per:(b + 1) * per]},
                        user=f"user{b}")
                    if status != 201 or body.get("replicated") is False:
                        raise AssertionError(
                            f"failover: batch {b} answered {status} "
                            f"{str(body)[:300]}")
                    acked += body["jobs"]
                    walls.append(round(wall, 4))
                    ack_walls.append(round(_hop_wall(
                        headers, "replication_ack"), 4))
            finally:
                sampling.set()
                sampler.join(timeout=10)
            # 3. A has placed in a match cycle
            _until("a cycle with placements on A", SERVICE_DEADLINE_S,
                   lambda: any(r["matched_count"] > 0 for r in http(
                       "GET", f"{a_url}/debug/cycles?limit=50",
                       timeout=10)[1]["cycles"]), every_s=0.5)
            # 4. a replica read on B, stamped with its staleness
            status, body, _, headers = http(
                "GET", f"{b_url}/jobs/{acked[len(acked) // 2]}")
            if status != 200 or "X-Cook-Staleness-Ms" not in headers:
                raise AssertionError(f"failover: replica read on B "
                                     f"answered {status} {headers}")
            read_staleness = headers["X-Cook-Staleness-Ms"]
            # 5. counts reset, then A dies without releasing its lease
            _reset_launches()
            calls.clear()
            t_kill = time.monotonic()
            leader.send_signal(signal.SIGKILL)
            leader.wait(timeout=30)
            # 6. B promotes within its lease bound
            bound_s = 2 * FAILOVER_TTL_S + 5
            _until("B's promotion", bound_s, lambda: http(
                "GET", f"{b_url}/debug", timeout=5)[1]["leader"],
                every_s=0.05)
            promote_s = time.monotonic() - t_kill
            thread.join(timeout=60)
            # 7. B's match cycles with a window

            def full_cycles():
                body = http("GET", f"{b_url}/debug/cycles?limit=50",
                            timeout=10)[1]
                full = [r for r in body["cycles"] if r["considered"] > 0]
                return full if len(full) >= FAILOVER_CYCLES else None

            cycles = _until(f"{FAILOVER_CYCLES} cycles on B",
                            SERVICE_DEADLINE_S, full_cycles, every_s=0.5)
            for loop in standby.loops:
                loop.stop()
            for loop in standby.loops:
                loop.join(60)
            launches = bn.launches
        # every acked job reads back from B, and B holds nothing else
        t0 = time.perf_counter()
        read_back(b_url, acked)
        read_s = time.perf_counter() - t0
        store = standby.store
        extra = set(store.jobs) - set(acked)
        if extra:
            raise AssertionError(f"failover: B holds {len(extra)} jobs A "
                                 "never acked")
        if not standby.scheduler.columnar.consistent_with_store():
            raise AssertionError("failover: B's columnar index is not "
                                 "consistent with its store")
        skipped = [s for r in standby.scheduler.recorder.records_json(
                   limit=10_000) for s in r["skipped"]
                   if s["code"] == "solve-failed"]
        if skipped:
            raise AssertionError(f"failover: {len(skipped)} solve-failed "
                                 "skips on B")
        busy = check_cluster_capacity(standby.clusters[0])
        placed = sum(1 for j in store.jobs.values()
                     if j.state.value != "waiting")
    except BaseException:
        for name, log in logs.items():
            if os.path.exists(log):
                with open(log, errors="replace") as f:
                    print(f"failover {name} log tail:\n{f.read()[-3000:]}",
                          file=sys.stderr, flush=True)
        raise
    finally:
        if standby is not None:
            shutdown(standby)
        if thread is not None:
            thread.join(timeout=60)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
    lag = sorted(x for x in lag if x != float("inf"))
    print(f"failover submit: {len(acked)} jobs in {FAILOVER_BATCHES} "
          f"sync-acked POSTs of {per}, wall per batch (s) {walls}, of "
          f"which the sync-ack wait (s) {ack_walls}", flush=True)
    print("failover " + json.dumps(dict(
        leader_boot_s=round(boot_s, 3), standby_first_sync_s=round(
            synced_s, 3),
        lag_ms=dict(n=len(lag),
                    p50=round(lag[len(lag) // 2], 3) if lag else None,
                    max=round(lag[-1], 3) if lag else None),
        replica_read_staleness_ms=read_staleness,
        sigkill_to_promotion_s=round(promote_s, 3), bound_s=bound_s,
        standby_cycle_walls_s=[round(r["total_s"], 4)
                               for r in cycles[:FAILOVER_CYCLES]],
        considered=[r["considered"] for r in cycles],
        matched=[r["matched_count"] for r in cycles],
        placed=placed, busy_hosts=busy, best_node_launches=launches,
        read_back=len(acked), read_back_s=round(read_s, 3),
        capacity="ok")), flush=True)
    return launches, calls


def failover_phase(card):
    """26. Failover (see the docstring)."""
    phase("failover")
    hosts, specs = service_fleet(n_jobs=FAILOVER_JOBS)
    with tempfile.TemporaryDirectory(prefix="cook-failover-") as workdir:
        launches, calls = failover_run(hosts, specs, workdir)
    if launches <= 0 or len(calls) != launches:
        raise AssertionError(f"failover: kept {len(calls)} best_node "
                             f"calls, counted {launches} launches")
    max_err = hold_launches("best_node", calls, "failover")
    print(f"failover on {card}", flush=True)
    return launches, max_err


# the sharded failover phase (27): phase 26 on a 2-shard store, its fleet
# split into two pools that `ShardRouter(2)` puts on different shards
SHARDED_SHARDS = 2
# waiting jobs moved to the other pool (each move a cross-shard commit)
SHARDED_MOVES = 200
# A's match loop interval (phase 25's is 0.5 s): B's windows are the
# backlog A leaves at the SIGKILL, and A's cycles must not drain both
# pools during the submits (at the CPU test's 100 hosts a pool they take
# ~0.1 s each)
SHARDED_LEADER_MATCH_INTERVAL_S = 4.0


def sharded_pools():
    """One pool per shard, named as the router finds them."""
    from cook_tpu_torch.shard import ShardRouter

    return ShardRouter(SHARDED_SHARDS).pools_for_distinct_shards()


def sharded_batches(specs, pools, n_batches=FAILOVER_BATCHES):
    """The POSTs: the even-numbered ones each to one pool (alternately),
    the odd-numbered ones half in each pool, so each of those is a
    cross-shard commit."""
    per = len(specs) // n_batches
    batches = []
    for b in range(n_batches):
        chunk = specs[b * per:(b + 1) * per]
        if b % 2 == 0:
            batches.append([dict(spec, pool=pools[(b // 2) % len(pools)])
                            for spec in chunk])
        else:
            batches.append([dict(spec, pool=pools[i * len(pools) // per])
                            for i, spec in enumerate(chunk)])
    return batches


def sharded_config(port, data_dir, hosts, lease_url, pools, device="cuda",
                   **extra):
    """Phase 26's node config with `shards` 2 and the fleet split between
    the pools, host by host."""
    conf = failover_config(
        port, data_dir, [dict(h, pool=pools[i % len(pools)])
                         for i, h in enumerate(hosts)],
        lease_url, device, shards=len(pools), **extra)
    conf["pools"] = [{"name": pool} for pool in pools]
    return conf


@contextlib.contextmanager
def calls_per_pool(calls, per_pool):
    """While the block runs, count in `per_pool` the calls kept in
    `calls` that each pool's `match_pool` made (the match loop runs one
    pool at a time)."""
    from cook_tpu_torch.scheduler import core

    match_pool = core.match_pool

    def counted(store, pool, *args, **kw):
        before = len(calls)
        try:
            return match_pool(store, pool, *args, **kw)
        finally:
            per_pool[pool.name] = (per_pool.get(pool.name, 0)
                                   + len(calls) - before)

    core.match_pool = counted
    try:
        yield per_pool
    finally:
        core.match_pool = match_pool


def _shard_states(store):
    """Per-shard `snapshot_state`, through JSON."""
    from cook_tpu_torch.models import persistence

    return [json.loads(json.dumps(persistence.snapshot_state(shard)))
            for shard in store.shards]


def _pool_cycles(url, pools, n):
    """The node's match cycles with a window, per pool, once every pool
    has `n` (else None)."""
    body = http("GET", f"{url}/debug/cycles?limit=100", timeout=10)[1]
    full = {pool: [r for r in body["cycles"]
                   if r["pool"] == pool and r["considered"] > 0]
            for pool in pools}
    return full if all(len(c) >= n for c in full.values()) else None


def sharded_failover_run(hosts, specs, workdir, device="cuda"):
    """27. Phase 26 on two shards: a lease service and leader A
    (`python -m cook_tpu_torch`, `shards` 2, sync acks) as subprocesses,
    standby B (`shards` 2) in this process; cross-shard submits and pool
    moves to A; SIGKILL A; B promotes and schedules both pools.  Returns
    B's best_node launches, the kept calls' arguments and their count per
    pool."""
    from cook_tpu_torch.components import (build_process, shutdown,
                                           start_leader_duties)
    from cook_tpu_torch.ops import best_node as bn
    from cook_tpu_torch.ops import match
    from cook_tpu_torch.rest.server import free_port
    from cook_tpu_torch.shard import journal as shard_journal
    from cook_tpu_torch.utils.config import read_config

    pools = sharded_pools()
    procs, calls, per_pool = [], [], {}
    standby = thread = None
    logs = {name: os.path.join(workdir, f"sharded-{name}.log")
            for name in ("lease", "a")}
    try:
        lease_proc, lease_url = _lease_service(logs["lease"])
        procs.append(lease_proc)
        configs, urls, dirs = {}, {}, {}
        for name, extra in (
                # no load shedding on A: its waiting jobs are read over
                # GET /jobs after the bulk submits, which it would shed
                # (phase 25's reason)
                ("a", dict(replication_sync_ack=True,
                           replication_min_acks=1,
                           replication_ack_timeout_s=FAILOVER_ACK_TIMEOUT_S,
                           load_shedding=False,
                           match_interval_s=(
                               SHARDED_LEADER_MATCH_INTERVAL_S))),
                ("b", {})):
            port = free_port()
            configs[name] = os.path.join(workdir, f"sharded-{name}.json")
            dirs[name] = os.path.join(workdir, f"sharded-data-{name}")
            with open(configs[name], "w") as f:
                json.dump(sharded_config(port, dirs[name], hosts, lease_url,
                                         pools, device, **extra), f)
            urls[name] = f"http://127.0.0.1:{port}"
        a_url, b_url = urls["a"], urls["b"]
        t0 = time.perf_counter()
        leader = _service_process(configs["a"], logs["a"])
        procs.append(leader)
        with kept_calls(match, "best_node", calls), \
                calls_per_pool(calls, per_pool):
            standby = build_process(read_config(configs["b"]))
            router = standby.store.router
            if [router.shard_for_pool(p) for p in pools] != [0, 1]:
                raise AssertionError(f"sharded: pools {pools} do not lie "
                                     "on shards 0 and 1")
            _healthy(a_url, leader)
            _until("A leading", 120, lambda: http(
                "GET", f"{a_url}/debug", timeout=5)[1]["leader"])
            boot_s = time.perf_counter() - t0
            # 1. one admin write to A that touches both shards (a job in
            # each pool) wakes each shard follower's first long-poll, and
            # its 201 waits for B's durable ack on both shards
            probe_jobs = [dict(specs[0], pool=pool) for pool in pools]
            probe = {}
            writer = threading.Thread(target=lambda: probe.update(
                answer=http("POST", f"{a_url}/jobs", user="admin",
                            body={"jobs": probe_jobs})), daemon=True)
            writer.start()
            t0 = time.perf_counter()
            thread = threading.Thread(
                target=start_leader_duties, args=(standby,),
                kwargs={"block": False, "on_loss": lambda: None},
                daemon=True, name="sharded-standby")
            thread.start()
            def synced():
                shards = http("GET", f"{b_url}/debug/replica", user="admin",
                              timeout=5)[1]["shards"]
                return len(shards) == SHARDED_SHARDS and all(
                    row.get("staleness_ms") is not None
                    for row in shards.values())

            _until("B's first sync on both shards", 60, synced)
            synced_s = time.perf_counter() - t0
            writer.join(FAILOVER_ACK_TIMEOUT_S + HTTP_TIMEOUT_S)
            status, body = probe.get("answer", (None, None))[:2]
            if status != 201 or body.get("replicated") is False:
                raise AssertionError(f"sharded: the first write to A "
                                     f"answered {status} {str(body)[:300]}")
            acked = {u: pools[i] for i, u in enumerate(body["jobs"])}
            if http("GET", f"{b_url}/debug")[1]["leader"]:
                raise AssertionError("sharded: B leads beside A")
            # 2. the backlog to A, B's per-shard staleness sampled
            # meanwhile (and through the moves and the first cycles)
            lag = {i: [] for i in range(SHARDED_SHARDS)}
            sampling = threading.Event()

            def sample():
                while not sampling.wait(0.05):
                    for i, row in standby.follower.staleness_view().items():
                        lag[i].append(row["staleness_ms"])

            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            walls, ack_walls = [], {i: [] for i in range(SHARDED_SHARDS)}
            try:
                for b, batch in enumerate(sharded_batches(specs, pools)):
                    status, body, wall, headers = http(
                        "POST", f"{a_url}/jobs", body={"jobs": batch},
                        user=f"user{b}")
                    if status != 201 or body.get("replicated") is False:
                        raise AssertionError(
                            f"sharded: batch {b} answered {status} "
                            f"{str(body)[:300]}")
                    acked.update(zip(body["jobs"],
                                     [spec["pool"] for spec in batch]))
                    walls.append(round(wall, 4))
                    for i in range(SHARDED_SHARDS):
                        ack_walls[i].append(round(_hop_wall(
                            headers, f"replication_ack_s{i}"), 4))
                # 3. waiting jobs of the last POST (half in each pool)
                # moved to the other pool: each move is a cross-shard
                # commit, and each POST's 201 waits for B's ack on both
                # shards
                recent = list(acked)[-len(batch):]
                waiting = [j["uuid"] for j in jobs_of(a_url, recent)
                           .values() if j["status"] == "waiting"]
                # to the other pool: pools[1] for a pools[0] job, and
                # the other way round
                to_pool = {}
                for src, dst in zip(pools, pools[::-1]):
                    to_pool.update((u, dst) for u in [
                        u for u in waiting if acked[u] == src][
                            -SHARDED_MOVES // len(pools):])
                moves = {}
                for pool in pools:
                    mine = [u for u, dst in to_pool.items() if dst == pool]
                    if not mine:
                        continue
                    status, body, wall, _ = http(
                        "POST", f"{a_url}/pool-move", user="admin",
                        body={"jobs": mine, "pool": pool})
                    if status != 201 or body.get("replicated") is False:
                        raise AssertionError(
                            f"sharded: pool-move to {pool} answered "
                            f"{status} {str(body)[:300]}")
                    moves[pool] = dict(asked=len(mine),
                                       moved=len(body["moved"]),
                                       skipped=len(body["skipped"]),
                                       wall_s=round(wall, 4))
                    acked.update((u, pool) for u in body["moved"])
                if not any(m["moved"] for m in moves.values()):
                    raise AssertionError(f"sharded: no job moved {moves}")
                # 4. A has placed in a match cycle in each pool
                _until("a cycle with placements on A in each pool",
                       SERVICE_DEADLINE_S, lambda: all(
                           any(r["pool"] == pool and r["matched_count"] > 0
                               for r in http("GET",
                                             f"{a_url}/debug/cycles?limit=100",
                                             timeout=10)[1]["cycles"])
                           for pool in pools), every_s=0.5)
            finally:
                sampling.set()
                sampler.join(timeout=10)
            # 5. a replica read on B, stamped with both shards' staleness
            read_uuid = next(u for u, p in acked.items() if p == pools[1])
            status, body, _, headers = http("GET",
                                            f"{b_url}/jobs/{read_uuid}")
            per_shard = json.loads(headers.get("X-Cook-Shard-Staleness",
                                               "{}"))
            if status != 200 or set(per_shard) != {"0", "1"}:
                raise AssertionError(f"sharded: replica read on B answered "
                                     f"{status} {headers}")
            # 6. counts reset, then A dies without releasing its lease
            _reset_launches()
            calls.clear()
            per_pool.clear()
            t_kill = time.monotonic()
            leader.send_signal(signal.SIGKILL)
            leader.wait(timeout=30)
            # 7. B promotes within its lease bound, then cycles each pool
            bound_s = 2 * FAILOVER_TTL_S + 5
            _until("B's promotion", bound_s, lambda: http(
                "GET", f"{b_url}/debug", timeout=5)[1]["leader"],
                every_s=0.05)
            promote_s = time.monotonic() - t_kill
            thread.join(timeout=60)
            cycles = _until(f"{FAILOVER_CYCLES} cycles on B in each pool",
                            SERVICE_DEADLINE_S,
                            lambda: _pool_cycles(b_url, pools,
                                                 FAILOVER_CYCLES),
                            every_s=0.5)
            for loop in standby.loops:
                loop.stop()
            for loop in standby.loops:
                loop.join(60)
            launches = bn.launches
        if device == "cuda" and not all(per_pool.get(pool)
                                        for pool in pools):
            raise AssertionError(f"sharded: B's best_node launches per "
                                 f"pool {per_pool}")
        # every acked job reads back from B in its acknowledged pool, on
        # the one shard that owns that pool, and B holds nothing else
        t0 = time.perf_counter()
        jobs = read_back(b_url, list(acked))
        read_s = time.perf_counter() - t0
        wrong = {u: j["pool"] for u, j in jobs.items()
                 if j["pool"] != acked[u]}
        if wrong:
            raise AssertionError(f"sharded: {len(wrong)} jobs read back in "
                                 f"another pool than acked: "
                                 f"{list(wrong.items())[:5]}")
        store = standby.store
        for uuid, pool in acked.items():
            owners = [i for i, shard in enumerate(store.shards)
                      if uuid in shard.jobs]
            if owners != [router.shard_for_pool(pool)]:
                raise AssertionError(f"sharded: job {uuid} of {pool} lies "
                                     f"on shards {owners}")
        extra = set(store.jobs) - set(acked)
        if extra:
            raise AssertionError(f"sharded: B holds {len(extra)} jobs A "
                                 "never acked")
        if not standby.scheduler.columnar.consistent_with_store():
            raise AssertionError("sharded: B's columnar index is not "
                                 "consistent with its store")
        skipped = [s for r in standby.scheduler.recorder.records_json(
                   limit=10_000) for s in r["skipped"]
                   if s["code"] == "solve-failed"]
        if skipped:
            raise AssertionError(f"sharded: {len(skipped)} solve-failed "
                                 "skips on B")
        busy = check_cluster_capacity(standby.clusters[0])
        placed = {pool: sum(1 for u, p in acked.items()
                            if p == pool and jobs[u]["status"] != "waiting")
                  for pool in pools}
    except BaseException:
        for name, log in logs.items():
            if os.path.exists(log):
                with open(log, errors="replace") as f:
                    print(f"sharded {name} log tail:\n{f.read()[-3000:]}",
                          file=sys.stderr, flush=True)
        raise
    finally:
        if standby is not None:
            shutdown(standby)
        if thread is not None:
            thread.join(timeout=60)
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=30)
    # B's data_dir, B stopped, recovers shard for shard to B's state
    t0 = time.perf_counter()
    recovered = shard_journal.recover_sharded(dirs["b"], SHARDED_SHARDS)
    if _shard_states(recovered) != _shard_states(standby.store):
        raise AssertionError("sharded: B's data_dir does not recover to "
                             "B's per-shard state")
    recover_s = time.perf_counter() - t0

    def spread(samples):
        xs = sorted(x for x in samples if x != float("inf"))
        return dict(n=len(xs), p50=round(xs[len(xs) // 2], 3) if xs else None,
                    max=round(xs[-1], 3) if xs else None)

    print(f"sharded failover submit: {len(walls)} sync-acked POSTs of "
          f"{len(specs) // FAILOVER_BATCHES} (odd-numbered ones across both "
          f"shards), wall per POST (s) {walls}, of which the sync-ack wait "
          "per shard (s, shard 1's counted from shard 0's ack) "
          + json.dumps({f"s{i}": w for i, w in ack_walls.items()}),
          flush=True)
    print("sharded failover " + json.dumps(dict(
        pools={pool: router.shard_for_pool(pool) for pool in pools},
        leader_boot_s=round(boot_s, 3),
        standby_first_sync_s=round(synced_s, 3),
        lag_ms={f"s{i}": spread(v) for i, v in lag.items()},
        pool_moves=moves,
        replica_read_shard_staleness_ms=per_shard,
        sigkill_to_promotion_s=round(promote_s, 3), bound_s=bound_s,
        standby_cycle_walls_s={
            pool: [round(r["total_s"], 4) for r in c[:FAILOVER_CYCLES]]
            for pool, c in cycles.items()},
        considered={pool: [r["considered"] for r in c]
                    for pool, c in cycles.items()},
        matched={pool: [r["matched_count"] for r in c]
                 for pool, c in cycles.items()},
        placed=placed, busy_hosts=busy, best_node_launches=launches,
        launches_per_pool=per_pool, read_back=len(acked),
        read_back_s=round(read_s, 3), recover_s=round(recover_s, 3),
        capacity="ok")), flush=True)
    return launches, calls, per_pool


def sharded_failover_phase(card):
    """27. Sharded failover (see the docstring)."""
    phase("sharded failover")
    hosts, specs = service_fleet(n_jobs=FAILOVER_JOBS)
    with tempfile.TemporaryDirectory(prefix="cook-sharded-") as workdir:
        launches, calls, _ = sharded_failover_run(hosts, specs, workdir)
    if launches <= 0 or len(calls) != launches:
        raise AssertionError(f"sharded: kept {len(calls)} best_node calls, "
                             f"counted {launches} launches")
    max_err = hold_launches("best_node", calls, "sharded failover")
    print(f"sharded failover on {card}", flush=True)
    return launches, max_err


# The phases after the kernel rows run in worker processes, all at once:
# each part below is `python3 chip_smoke.py --part NAME SHARED EPOCH`,
# given the flat slice's trace and what the later phases compare with in
# the JSON file SHARED.  A part resets and reads its own counts around
# each path it drives and writes them, with its worst error per kernel,
# to SHARED's directory; its output is printed here once every part has
# ended.  The kernel rows (5, 7) are timed before any part starts, and
# the service (25) and the failovers (26, 27) run after every part has
# ended, so that nothing else shares the card or the host with their
# walls.
PARTS = ("speculation", "multipool", "agreement")
# the parts must end this long after the script started, or all are
# stopped and the script fails with what they printed
PARTS_DEADLINE_S = 960.0


class Tally:
    """A part's launches (summed) and worst errors (max) per kernel."""

    def __init__(self):
        self.launches = dict.fromkeys(KERNELS, 0)
        self.errs = dict.fromkeys(KERNELS, 0.0)

    def add(self, name, launches=0, err=0.0):
        self.launches[name] += launches
        self.errs[name] = max(self.errs[name], err)

    def merge(self, other):
        for name in KERNELS:
            self.add(name, other["launches"][name], other["errs"][name])

    def json(self):
        return {"launches": self.launches, "errs": self.errs}


def part_speculation(shared, workdir, tally):
    """S1-S4, the paged coarse pass (12) and the gang admission (11)."""
    speculation_wave_phase()
    spec_launches, spec_calls = speculation_kernels_phase(
        shared["trace"], shared["classic"]["csv"])
    for name, kept in spec_calls.items():
        tally.add(name, spec_launches[name],
                  hold_launches(name, kept, "speculative solves"))
    del spec_calls
    speculation_pipelined_phase()
    speculation_agreement_phase()
    paged_rows, err = paged_coarse_phase()
    tally.add("coarse_pass", err=err)
    print("coarse_pass paged " + json.dumps(paged_rows), flush=True)
    gang_admission_phase()


def part_multipool(shared, workdir, tally):
    """11a-11f, the elastic plane (17-20), residency (7a-7d) and the
    quality audit (23)."""
    mp_serial = []
    mp_launches, mp_calls, mp_trace = multipool_phase(serial_csv=mp_serial)
    for name, err in multipool_launches_phase(mp_calls).items():
        tally.add(name, mp_launches[name], err)
    del mp_calls
    multipool_exact_phase(*mp_trace)
    mp_classic_placed = placements_by_cycle(mp_serial[0], MP_CYCLES)
    mp_launches, mp_calls = resident_multipool_phase(*mp_trace,
                                                     mp_serial[0])
    for name, kept in mp_calls.items():
        tally.add(name, mp_launches[name], hold_launches(
            name, kept, "resident multipool"))
    del mp_trace, mp_calls, mp_serial
    n, res_calls = resident_streams_phase()
    tally.add("best_node", n, hold_launches(
        "best_node", res_calls, "resident streams"))
    del res_calls
    multipool_agreement_phase()
    # the elastic capacity plane: the solve alone, the multi-pool slice
    # planning every cycle, the resident plan mirror, the agreement replays
    elastic_solve_phase()
    el_launches, el_errs, el_queues, el_trace = elastic_slice_phase(
        classic_placed=mp_classic_placed)
    for name in MP_KERNELS:
        tally.add(name, el_launches[name], el_errs[name])
    elastic_residency_phase(el_queues, el_trace)
    del el_queues, el_trace
    elastic_agreement_phase()
    # device residency: (a) the flat slice resident, (c) quantized
    # and the hierarchical slice resident, (b) the unchanged-pool rig
    trace, classic = shared["trace"], shared["classic"]
    for label, run in (
            ("resident slice",
             lambda: resident_slice_phase(trace, workdir, classic)),
            ("quantized slice",
             lambda: quantized_slice_phase(trace, classic)),
            ("unchanged-pool rig", unchanged_pool_phase)):
        n, res_calls = run()
        tally.add("best_node", n, hold_launches("best_node", res_calls,
                                                label))
        del res_calls
    for label, run in (
            ("resident hier slice", resident_hier_phase),
            ("quantized hier slice", quantized_hier_phase)):
        res_launches, res_calls = run(trace, shared["hier_csv"],
                                      shared["hier_placed"])
        for name, kept in res_calls.items():
            tally.add(name, res_launches[name],
                      hold_launches(name, kept, label))
        del res_calls
    # the quality audit on the flat slice (23)
    quality_audit_phase(trace, classic["csv"], classic["walls"])


def part_agreement(shared, workdir, tally):
    """8-8c, the gang slice and agreement (9-10), the superblock slice
    (21), the rebalance phases (13-15), the superblock layer at 1M x 100k
    (22) and faults, incidents and admission (24)."""
    agreement_phase(workdir)
    default_agreement_phase(workdir)
    resident_default_agreement_phase(workdir)
    gang_runs = gang_slice_phase(shared["trace"])
    gang_ops_phase(*gang_runs.pop("ops"))
    for label, (gang_launches, gang_calls, _) in gang_runs.items():
        err = gang_launches_phase(label, gang_calls)
        for name in gang_calls:
            tally.add(name, err=err)
        print(f"gang {label} launches: " + json.dumps(gang_launches),
              flush=True)
    del gang_runs
    gang_agreement_phase(workdir)
    # the superblock slice (21)
    sb_launches, sb_calls = superblock_slice_phase(shared["trace"],
                                                   shared["hier_p50_ms"])
    tally.add("best_node_batched", sb_launches, hold_launches(
        "best_node_batched", sb_calls, "superblock slice"))
    del sb_calls
    rebalance_case_phase()
    rebalance_slice_phase()
    reb_launches = rebalance_agreement_phase()
    print(f"best_node launches inside the flat rebalance replay: "
          f"{reb_launches}", flush=True)
    superblock_mega_phase()
    faults_phase()


def part_main(name, shared_path, epoch) -> int:
    """One part in a worker process: its phases, then its tally."""
    global _T0
    import torch

    _T0 = time.perf_counter() - (time.time() - float(epoch))
    sys.path.insert(0, ROOT)
    _torch_setup(torch)
    # half the cores each: the parts' CPU replays seldom coincide
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // 2))
    with open(shared_path) as f:
        shared = json.load(f)
    tally = Tally()
    with tempfile.TemporaryDirectory(prefix=f"cook-part-{name}-") as workdir:
        globals()[f"part_{name}"](shared, workdir, tally)
    print(f"part {name}: device memory peak "
          f"{torch.cuda.max_memory_reserved() / 2**30:.2f} GiB reserved",
          flush=True)
    with open(os.path.join(os.path.dirname(shared_path),
                           f"part-{name}.json"), "w") as f:
        json.dump(tally.json(), f)
    return 0


def run_parts(shared, workdir):
    """Every part at once, each in its own process; their tallies merged
    once all have ended.  Raises if one fails or the deadline passes (the
    others are then stopped)."""
    phase("parts: " + ", ".join(PARTS))
    shared_path = os.path.join(workdir, "shared.json")
    with open(shared_path, "w") as f:
        json.dump(shared, f)
    procs = {}
    try:
        for name in PARTS:
            out = open(os.path.join(workdir, f"part-{name}.out"), "w+")
            err = open(os.path.join(workdir, f"part-{name}.err"), "w+")
            procs[name] = (subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--part", name,
                 shared_path, repr(_EPOCH)],
                stdout=out, stderr=err, cwd=ROOT), out, err)
        deadline = _T0 + PARTS_DEADLINE_S
        for name, (proc, _, _) in procs.items():
            try:
                proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                print(f"part {name} still running at "
                      f"{PARTS_DEADLINE_S:.0f} s: every part stopped",
                      file=sys.stderr, flush=True)
                break
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for name, (proc, out, err) in procs.items():
            print(f"== part {name} (exit {proc.returncode})", flush=True)
            for stream, dest in ((out, sys.stdout), (err, sys.stderr)):
                stream.seek(0)
                dest.write(stream.read())
                stream.close()
                dest.flush()
    failed = [name for name, (proc, _, _) in procs.items()
              if proc.returncode != 0]
    if failed:
        raise RuntimeError(f"part(s) {', '.join(failed)} failed")
    tally = Tally()
    for name in PARTS:
        with open(os.path.join(workdir, f"part-{name}.json")) as f:
            tally.merge(json.load(f))
    return tally


def _torch_setup(torch):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "cook_tpu_torch")):
        print("chip_smoke.py: cook_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--part"]:
        return part_main(*sys.argv[2:5])
    sys.path.insert(0, ROOT)
    import torch

    from cook_tpu_torch.sim import cli

    _torch_setup(torch)
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
        walls_phase(trace, workdir, classic)
        hier_launches, hier_calls, hier_result, _ = hier_slice_phase(
            trace)
        hier_walls = sorted(hier_result.cycle_wall_s)
        shared = dict(
            trace=trace, classic=classic, hier_csv=hier_result.to_csv(),
            hier_placed=[r["job_uuid"] for r in hier_result.rows
                         if r["start_ms"] is not None],
            hier_p50_ms=hier_walls[len(hier_walls) // 2] * 1e3)
        del hier_result, classic
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
        del busiest, hier_calls
        torch.cuda.empty_cache()
        tally = run_parts(shared, workdir)
    for name in KERNELS:
        launches[name] += tally.launches[name]
        errs[name] = max(errs[name], tally.errs[name])
    # the service (25): `python -m cook_tpu_torch`'s path, counts reset
    # inside just before the node starts and read once its loops stop
    n, err = service_phase()
    launches["best_node"] += n
    errs["best_node"] = max(errs["best_node"], err)
    # failover (26): B's counts reset just before A's SIGKILL and read once
    # B's loops stop
    n, err = failover_phase(card)
    launches["best_node"] += n
    errs["best_node"] = max(errs["best_node"], err)
    # sharded failover (27): B's counts reset just before A's SIGKILL and
    # read once B's loops stop
    n, err = sharded_failover_phase(card)
    launches["best_node"] += n
    errs["best_node"] = max(errs["best_node"], err)
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
