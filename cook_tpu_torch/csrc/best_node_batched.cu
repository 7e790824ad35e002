// best_node_batched: `best_node` over a batch of per-block problems.
//
// Replaces the Pallas TPU kernel `best_node_batched` of
// cook_tpu/ops/pallas_match.py (entry :316, bodies _fine_kernel :290 and
// _fine_masked_kernel :303, accumulator _batched_accumulate :272, shared
// scoring _score_tile :31): the fine-pass scorer of the hierarchical
// matcher (cook_tpu/ops/hierarchical.py _fine_fused :387).  Same contract,
// for every block b and slot s:
//   feasible(b, s, n) = slot (b, s) is live (demand[0] < BIG)
//                       && every one of the R demand columns fits
//                       avail[b, n] && node_valid[b, n]
//                       && (no mask || mask[b, s, n])
//   out[b, s]         = (max fitness, first BLOCK-LOCAL index of the max),
//                       or (-BIG, -1) where no node of block b is feasible.
//
// Design.  `best_node.cu` with batch offsets: one warp owns one (block,
// slot) pair and walks that block's N nodes itself, lanes striding over
// the node axis so a warp's mask-row reads are contiguous; the lanes
// combine through the shared first-index shuffle reduction
// (score_tile.cuh).  The TPU kernel's grid owns the block axis as its
// outer dimension; here gridDim.y is the block and gridDim.x covers the
// slots, so nothing carries between thread blocks.  Ragged S (slots not a
// multiple of the warps per block) and N (not a multiple of 32) are
// masked in the kernel, so the wrapper pads nothing.
//
// A slot that is not live (the fine pass's 2*BIG mark of a placed or empty
// slot) is answered at once, so its warp reads no mask row.
//
// Bound.  The mask rows of the live slots, one byte per (slot, node), are
// the only input that grows with the problem: at most 16 x 2048 x 1024 B
// = 33.5 MB per launch at the 100k x 10k slice (~10 us at 3.35 TB/s), and
// that times the live share of the slots, which on that slice is often an
// eighth or less.  The fast shape (a TMA-fed
// shared-memory ring of mask tiles, several warps per slot) is later
// work; this version is simple and exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see cook_tpu_torch/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using score_tile::kBig;
using score_tile::kMaxR;

constexpr int kWarpsPerBlock = 8;

template <bool kMasked>
__global__ void best_node_batched_kernel(
    const float* __restrict__ demands,  // [B,S,R]
    const float* __restrict__ avail,    // [B,N,R]
    const float* __restrict__ totals,   // [B,N,2]
    const uint8_t* __restrict__ valid,  // [B,N]
    const uint8_t* __restrict__ mask,   // [B,S,N]
    float* __restrict__ out_val,        // [B,S]
    int32_t* __restrict__ out_idx,      // [B,S]
    int S, int N, int R) {
  const int lane = threadIdx.x & 31;
  const int slot = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (slot >= S) return;  // whole warp exits together: no shuffle hazard
  const int64_t b = blockIdx.y;
  const int64_t row = b * S + slot;

  float d[kMaxR];
  score_tile::load_demand(demands + row * R, R, d);
  if (!score_tile::live(d)) {  // the same row for all 32 lanes
    if (lane == 0)
      score_tile::store_best(-kBig, score_tile::kNoIdx, out_val + row,
                             out_idx + row);
    return;
  }
  const float* av = avail + b * N * R;
  const float* tot = totals + b * N * 2;
  const uint8_t* ok = valid + b * N;
  const uint8_t* mask_row = kMasked ? mask + row * N : nullptr;

  float best = -kBig;
  int idx = score_tile::kNoIdx;
  for (int n = lane; n < N; n += 32) {
    if (kMasked && !mask_row[n]) continue;
    if (!ok[n]) continue;
    const float* a = av + (int64_t)n * R;
    if (!score_tile::fits(a, d, R)) continue;
    score_tile::keep_best(
        score_tile::fitness(tot[2 * (int64_t)n], tot[2 * (int64_t)n + 1],
                            a[0], a[1], d),
        n, best, idx);
  }
  score_tile::warp_argmax_first(best, idx);
  if (lane == 0) score_tile::store_best(best, idx, out_val + row, out_idx + row);
}

}  // namespace

extern "C" {

// Launches on `stream`; `mask` may be null (the unmasked variant).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int best_node_batched_launch(const void* demands, const void* avail,
                             const void* totals, const void* valid,
                             const void* mask, void* out_val, void* out_idx,
                             int B, int S, int N, int R, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || N <= 0 || R < 2 || R > kMaxR)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((S + kWarpsPerBlock - 1) / kWarpsPerBlock, B);
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(demands);
  const float* ap = static_cast<const float*>(avail);
  const float* tp = static_cast<const float*>(totals);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  float* ov = static_cast<float*>(out_val);
  int32_t* oi = static_cast<int32_t*>(out_idx);
  if (mask != nullptr) {
    best_node_batched_kernel<true><<<grid, block, 0, s>>>(
        dp, ap, tp, vp, static_cast<const uint8_t*>(mask), ov, oi, S, N, R);
  } else {
    best_node_batched_kernel<false><<<grid, block, 0, s>>>(
        dp, ap, tp, vp, nullptr, ov, oi, S, N, R);
  }
  return (int)cudaGetLastError();
}

const char* best_node_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
