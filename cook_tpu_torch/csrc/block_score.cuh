// block_score.cuh: a job's best topology block, scored against a block
// table in shared memory.  The one block-scoring code of best_block.cu and
// coarse_pass.cu, so the standalone kernel and the fused coarse pass can
// never rank blocks by diverging rules.
//
// Counterpart of `_best_block_kernel` in cook_tpu/ops/pallas_match.py
// (:200).  A job may route to block b iff every one of its R demand
// columns fits the block's summed availability AND its per-resource max
// single node, and the block is valid; among those it takes the block of
// highest cpuMemBinPacker fitness on the summed totals and availability,
// the first index on a tie (score_tile.cuh).
//
// The table holds, per block b,
//   gate[b*R + r] = min(avail[b][r], max[b][r]), NaN where either is NaN,
//                   and NaN in column 0 where the block is invalid: one
//                   compare per column then tests both fits and validity
//                   (`a >= d && m >= d` <=> `min(a, m) >= d`; a NaN column
//                   fits nothing, as in the plain version)
//   used[2b + i]  = totals[b][i] - avail[b][i]   (i = mem, cpus)
//   den[2b + i]   = max(totals[b][i], 1e-30)
// so the fitness is score_tile::fitness_used, rounded exactly as
// score_tile::fitness rounds it.  The pointers may address shared or
// global memory.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace block_score {

using score_tile::kMaxR;

__device__ __forceinline__ float gate(float a, float m, bool valid) {
  if (!valid || m != m) return __int_as_float(0x7fc00000);  // NaN
  return a >= m ? m : a;  // a NaN gives a (NaN)
}

// gate rows from the current availability; used by threads tid, tid +
// nthreads, ... of the calling block
__device__ __forceinline__ void stage_gate(const float* avail,
                                           const float* bmax,
                                           const uint8_t* valid, int B,
                                           int R, float* gate_out, int tid,
                                           int nthreads) {
  for (int e = tid; e < B * R; e += nthreads) {
    const int b = e / R;
    gate_out[e] = gate(avail[e], bmax[e], e - b * R != 0 || valid[b]);
  }
}

__device__ __forceinline__ void stage_used(const float* totals,
                                           const float* avail, int B, int R,
                                           float* used, int tid,
                                           int nthreads) {
  for (int e = tid; e < 2 * B; e += nthreads) {
    const int b = e >> 1;
    used[e] = totals[e] - avail[b * R + (e & 1)];
  }
}

__device__ __forceinline__ void stage_den(const float* totals, int B,
                                          float* den, int tid,
                                          int nthreads) {
  for (int e = tid; e < 2 * B; e += nthreads) den[e] = fmaxf(totals[e], 1e-30f);
}

// (best, idx) over blocks 0..B-1 in order, strict `>` from the caller's
// running (best, idx): the first block of a tie wins
__device__ __forceinline__ void best_in_table(const float* gate_rows,
                                              const float* used,
                                              const float* den, int B, int R,
                                              const float (&d)[kMaxR],
                                              float& best, int& idx) {
  for (int b = 0; b < B; ++b) {
    if (!score_tile::fits(gate_rows + b * R, d, R)) continue;
    score_tile::keep_best(
        score_tile::fitness_used(used[2 * b], used[2 * b + 1], den[2 * b],
                                 den[2 * b + 1], d),
        b, best, idx);
  }
}

}  // namespace block_score
