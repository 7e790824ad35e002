// score_tile.cuh: the scoring rules every best-* kernel shares.
//
// Counterpart of `_score_tile` in cook_tpu/ops/pallas_match.py (:31): ONE
// definition of feasibility, cpuMemBinPacker fitness and the first-index
// (max, argmax) rule, so best_node, best_node_batched, best_block and
// coarse_pass (the last two through block_score.cuh) can never rank
// candidates by diverging rules.
//
//   live(d)        = d[0] < BIG: the matchers mark placed and empty rows
//                    with a 2*BIG demand, which no capacity holds, so a
//                    row that is not live is answered (-BIG, -1) at once,
//                    without reading its mask row or any node
//   fits(a, d)     = every one of the R demand columns d[r] <= a[r]
//   fitness        = ((tot0 - av0 + d0) / max(tot0, 1e-30)
//                     + (tot1 - av1 + d1) / max(tot1, 1e-30)) * 0.5
//   best           = (max fitness, first index of the max), kept by a
//                    strict `>` in index order and, across a warp, by
//                    `warp_argmax_first`; across thread blocks, by the
//                    largest packed key (`pack_key`)
//
// The kernels build with --fmad=false (cook_tpu_torch/build.py), so the
// fitness is rounded exactly as the plain PyTorch versions round it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace score_tile {

constexpr int kMaxR = 8;
constexpr float kBig = 1e30f;
constexpr int kNoIdx = 0x7fffffff;

// d[0..R) from one demand row; the columns past R are never read by `fits`
__device__ __forceinline__ void load_demand(const float* __restrict__ row,
                                            int R, float (&d)[kMaxR]) {
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) d[r] = r < R ? row[r] : 0.0f;
}

__device__ __forceinline__ bool live(const float (&d)[kMaxR]) {
  return d[0] < kBig;
}

__device__ __forceinline__ bool fits(const float* __restrict__ a,
                                     const float (&d)[kMaxR], int R) {
  bool ok = true;
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) ok = ok && (r >= R || a[r] >= d[r]);
  return ok;
}

// the fitness from used = tot - av and den = max(tot, 1e-30), for the
// kernels that stage those per node or block
__device__ __forceinline__ float fitness_used(float used0, float used1,
                                              float den0, float den1,
                                              const float (&d)[kMaxR]) {
  return ((used0 + d[0]) / den0 + (used1 + d[1]) / den1) * 0.5f;
}

__device__ __forceinline__ float fitness(float tot0, float tot1, float av0,
                                         float av1, const float (&d)[kMaxR]) {
  return fitness_used(tot0 - av0, tot1 - av1, fmaxf(tot0, 1e-30f),
                      fmaxf(tot1, 1e-30f), d);
}

// running (best, idx) over candidates visited in increasing index order:
// strict `>`, so an earlier candidate keeps a tie
__device__ __forceinline__ void keep_best(float fit, int n, float& best,
                                          int& idx) {
  if (fit > best) {
    best = fit;
    idx = n;
  }
}

// combine the 32 lanes' (best, idx): the larger value or, on a tie, the
// smaller index; every lane ends with the warp's result.  All 32 lanes
// must call it.
__device__ __forceinline__ void warp_argmax_first(float& best, int& idx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

// the kernels' output rule: (-BIG, -1) where nothing was feasible
__device__ __forceinline__ void store_best(float best, int idx,
                                           float* out_val, int32_t* out_idx) {
  const bool found = best > -kBig;
  *out_val = found ? best : -kBig;
  *out_idx = found ? idx : -1;
}

// Packed keys: the order-free combine of node tiles that thread blocks
// finish in any order.  A key is (order_key(best) << 32) | (~0u - idx), so
// the larger key is the larger score and, on a tie, the smaller index:
// exactly the first-index argmax rule, and a 64-bit atomicMax over a job's
// keys gives the same winner whatever order the blocks arrive in.  Only a
// best above -BIG is ever submitted, so the empty key 0 (below every
// submitted key) stands for "(-BIG, no index)".  tests/
// test_torch_best_node.py holds a numpy model of these three helpers
// line for line.
constexpr unsigned long long kEmptyKey = 0ull;

// float -> uint32 preserving order; -0.0 first becomes +0.0, because the
// argmax treats the two as equal and their raw bits differ
__device__ __forceinline__ uint32_t order_key(float f) {
  uint32_t u = __float_as_uint(f);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack_key(float best, int idx) {
  return ((unsigned long long)order_key(best) << 32)
         | (unsigned long long)(0xffffffffu - (uint32_t)idx);
}

__device__ __forceinline__ int key_index(unsigned long long key) {
  return (int)(0xffffffffu - (uint32_t)key);
}

}  // namespace score_tile
