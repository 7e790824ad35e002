// best_block: each job's best feasible topology BLOCK, on block aggregates.
//
// Replaces the Pallas TPU kernel `best_block` of cook_tpu/ops/pallas_match.py
// (entry :218, body _best_block_kernel :200, shared scoring _score_tile
// :31): the coarse-pass scorer of the hierarchical matcher
// (cook_tpu/ops/hierarchical.py _coarse_pallas :233).  Same contract:
//   feasible(k, b) = job k is live (demand[0] < BIG)
//                    && every one of the R demand columns fits block_avail[b]
//                    (the block's summed free capacity)
//                    && fits block_max[b] (its per-resource max single
//                    node: some node could hold the job)
//                    && block_valid[b]
//   fit(k, b)      = cpuMemBinPacker fitness on the block's summed totals
//                    and summed availability (score_tile.cuh)
//   out            = (max fit, first index of the max), or (-BIG, -1)
//                    where no block is feasible.
// Padded blocks arrive with block_max = -1 and block_totals = 1, so they
// are never feasible and need no case of their own.
//
// On the hierarchical path this scoring runs inside coarse_pass.cu, one
// launch per coarse pass; this kernel is the standalone function, and
// both score through block_score.cuh.
//
// Design.  The block axis is short (16 blocks at the 100k x 10k slice, 32
// at bench.py's bench_match_xl), so one thread owns one job and walks the
// blocks in order with a strict `>`: the first index of a tie wins by
// construction, and no reduction across threads is needed.  Each thread
// block first stages the block table (block_score.cuh: one gate row per
// block folding both fits and validity, used and den pairs) in shared
// memory, so the walk makes no dependent global loads; 128 threads a
// block put 32 blocks in flight at K = 4096.
//
// Bound.  At K = 4096 jobs and B = 16 blocks a call reads under 0.1 MB and
// does ~1M float operations: both are far under a microsecond on the
// card, so the launch overhead (a few microseconds) bounds it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see cook_tpu_torch/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

#include "block_score.cuh"
#include "score_tile.cuh"

namespace {

using score_tile::kBig;
using score_tile::kMaxR;

constexpr int kThreadsPerBlock = 128;

// dynamic shared memory: gate [B*R], used [2B], den [2B]
__host__ __device__ inline int table_words(int B, int R) {
  return B * R + 4 * B;
}

__global__ void best_block_kernel(const float* __restrict__ demands,      // [K,R]
                                  const float* __restrict__ block_avail,  // [B,R]
                                  const float* __restrict__ block_max,    // [B,R]
                                  const float* __restrict__ block_totals, // [B,2]
                                  const uint8_t* __restrict__ block_valid,// [B]
                                  float* __restrict__ out_val,            // [K]
                                  int32_t* __restrict__ out_idx,          // [K]
                                  int K, int B, int R) {
  extern __shared__ float table[];
  float* gate = table;
  float* used = gate + B * R;
  float* den = used + 2 * B;
  block_score::stage_gate(block_avail, block_max, block_valid, B, R, gate,
                          threadIdx.x, blockDim.x);
  block_score::stage_used(block_totals, block_avail, B, R, used,
                          threadIdx.x, blockDim.x);
  block_score::stage_den(block_totals, B, den, threadIdx.x, blockDim.x);
  __syncthreads();

  const int job = blockIdx.x * kThreadsPerBlock + threadIdx.x;
  if (job >= K) return;
  float d[kMaxR];
  score_tile::load_demand(demands + (int64_t)job * R, R, d);
  float best = -kBig;
  int idx = score_tile::kNoIdx;
  if (score_tile::live(d))
    block_score::best_in_table(gate, used, den, B, R, d, best, idx);
  score_tile::store_best(best, idx, out_val + job, out_idx + job);
}

}  // namespace

extern "C" {

// Launches on `stream`.  Returns the cudaError_t of the launch
// (0 = cudaSuccess).
int best_block_launch(const void* demands, const void* block_avail,
                      const void* block_max, const void* block_totals,
                      const void* block_valid, void* out_val, void* out_idx,
                      int K, int B, int R, void* stream) {
  if (K <= 0 || B <= 0 || R < 2 || R > kMaxR) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)table_words(B, R);
  static size_t smem_set = 48 << 10;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        best_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const dim3 grid((K + kThreadsPerBlock - 1) / kThreadsPerBlock);
  best_block_kernel<<<grid, kThreadsPerBlock, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(demands),
      static_cast<const float*>(block_avail),
      static_cast<const float*>(block_max),
      static_cast<const float*>(block_totals),
      static_cast<const uint8_t*>(block_valid), static_cast<float*>(out_val),
      static_cast<int32_t*>(out_idx), K, B, R);
  return (int)cudaGetLastError();
}

const char* best_block_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
