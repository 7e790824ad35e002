// best_node: each job's best feasible node by cpuMemBinPacker fitness.
//
// Replaces the Pallas TPU kernel `best_node` of cook_tpu/ops/pallas_match.py
// (entry :135, bodies _best_node_kernel :85 and _best_node_masked_kernel
// :94, shared scoring _score_tile :31).  Same contract:
//   feasible(k, n) = job k is live (demand[0] < BIG; the chunked matcher
//                    marks placed jobs 2*BIG and answers them at once)
//                    && every one of the R demand columns fits avail[n]
//                    && node_valid[n] && (no mask || mask[k, n])
//   fit(k, n)      = ((tot0 - av0 + d0) / max(tot0, 1e-30)
//                     + (tot1 - av1 + d1) / max(tot1, 1e-30)) * 0.5
//   out            = (max fit, first index of the max), or (-BIG, -1)
//                    where no node is feasible.
//
// Design.  The TPU kernel walks node tiles in a sequential grid with a
// VMEM accumulator; here one warp owns one job and loops over all nodes
// itself, so nothing carries between blocks.  Lanes stride over the node
// axis (lane l takes nodes l, l+32, ...), which makes the mask-row reads
// of a warp contiguous; each lane keeps a running (best, idx) with a
// strict `>`, so within a lane the first index of a tie wins, and the
// warp shuffle reduction keeps the larger value or, on a tie, the smaller
// index.  The ragged edges (K not a multiple of the warps per block, N
// not a multiple of 32) are masked here, so the wrapper pads nothing.
//
// Bound.  Per call the kernel must read the K x N mask (one byte per
// pair: a quarter of the int32 mask the TPU kernel streams) plus the
// small K x R and N x (R + 3) inputs; the mask is the only stream that
// grows with K x N, so the call is memory-bound on those bytes.  At the
// simulator's K = 1024 the launch overhead is of the same order.  The
// fast shape for Hopper (TMA-fed shared-memory ring of mask tiles,
// several warps per job) is later work; this version is simple and exact.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see cook_tpu_torch/build.py)
// --fmad=false keeps the fitness arithmetic rounded exactly as the plain
// PyTorch version rounds it, so the two agree bit for bit.  Feasibility,
// fitness and the first-index reduction live in score_tile.cuh, shared
// with best_block.cu and best_node_batched.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace {

using score_tile::kBig;
using score_tile::kMaxR;

constexpr int kWarpsPerBlock = 8;

template <bool kMasked>
__global__ void best_node_kernel(const float* __restrict__ demands,  // [K,R]
                                 const float* __restrict__ avail,    // [N,R]
                                 const float* __restrict__ totals,   // [N,2]
                                 const uint8_t* __restrict__ valid,  // [N]
                                 const uint8_t* __restrict__ mask,   // [K,N]
                                 float* __restrict__ out_val,        // [K]
                                 int32_t* __restrict__ out_idx,      // [K]
                                 int K, int N, int R) {
  const int lane = threadIdx.x & 31;
  const int job = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (job >= K) return;  // whole warp exits together: no shuffle hazard

  float d[kMaxR];
  score_tile::load_demand(demands + (int64_t)job * R, R, d);
  if (!score_tile::live(d)) {  // the same job for all 32 lanes
    if (lane == 0)
      score_tile::store_best(-kBig, score_tile::kNoIdx, out_val + job,
                             out_idx + job);
    return;
  }

  float best = -kBig;
  int idx = score_tile::kNoIdx;
  const uint8_t* mask_row = kMasked ? mask + (int64_t)job * N : nullptr;
  for (int n = lane; n < N; n += 32) {
    if (kMasked && !mask_row[n]) continue;
    if (!valid[n]) continue;
    const float* a = avail + (int64_t)n * R;
    if (!score_tile::fits(a, d, R)) continue;
    // strict `>` inside keep_best: this lane's earlier node keeps a tie
    score_tile::keep_best(
        score_tile::fitness(totals[2 * (int64_t)n], totals[2 * (int64_t)n + 1],
                            a[0], a[1], d),
        n, best, idx);
  }
  score_tile::warp_argmax_first(best, idx);
  if (lane == 0) score_tile::store_best(best, idx, out_val + job, out_idx + job);
}

}  // namespace

extern "C" {

// Launches on `stream`; `mask` may be null (the unmasked variant).
// Returns the cudaError_t of the launch (0 = cudaSuccess).
int best_node_launch(const void* demands, const void* avail,
                     const void* totals, const void* valid, const void* mask,
                     void* out_val, void* out_idx, int K, int N, int R,
                     void* stream) {
  if (K <= 0 || N <= 0 || R < 2 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const dim3 grid((K + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(32 * kWarpsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dp = static_cast<const float*>(demands);
  const float* ap = static_cast<const float*>(avail);
  const float* tp = static_cast<const float*>(totals);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  float* ov = static_cast<float*>(out_val);
  int32_t* oi = static_cast<int32_t*>(out_idx);
  if (mask != nullptr) {
    best_node_kernel<true><<<grid, block, 0, s>>>(
        dp, ap, tp, vp, static_cast<const uint8_t*>(mask), ov, oi, K, N, R);
  } else {
    best_node_kernel<false><<<grid, block, 0, s>>>(
        dp, ap, tp, vp, nullptr, ov, oi, K, N, R);
  }
  return (int)cudaGetLastError();
}

const char* best_node_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
