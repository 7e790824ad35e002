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
// Design.  The batch of one of node_tile.cuh: a thread block owns a tile of
// TJ jobs x TN nodes, stages the node tile in shared memory once for its
// jobs (as the TPU kernel kept its node tile in VMEM across the job tile),
// and streams each live job's mask row as 16-byte vectors.  The node axis
// is split across thread blocks, so a job's best is the 64-bit atomicMax of
// the blocks' packed keys (score_tile.cuh): largest score, then smallest
// index, whatever order the blocks finish in; a second small kernel unpacks
// the keys and recomputes the winners' fitness.
//
// Bound.  A call must read the live jobs' K x N mask bytes plus the small
// K x R and N x (R + 3) inputs: at the flat slice's launch (K 1024 x N
// 16384, R 4) 16.8 MB, 5.1 us at 3.35 TB/s.  What bounds this design is
// not those bytes but fixed costs: per thread block the node tile's
// staging and the demands' and mask's round trips to memory, per job the
// bookkeeping around its 16 nodes a lane.  At that launch it takes ~0.038
// ms cold (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W), of which a launch
// with every job dead is ~0.009 ms and one with an empty mask ~0.030 ms
// (tile_sweep.py).  The previous design (one warp per job walking all N
// nodes with 1-byte mask loads, node data re-read from global memory per
// job: 1024 warps, ~1 block of 8 on each SM, 512 dependent steps each)
// took 0.3197 ms at that launch (same script and card).
//
// Tiles.  TJ 32 jobs x TN 512 nodes, G 1 warp a job: K 1024 x N 16384 is
// 32 x 32 = 1024 thread blocks of 8 warps, ~8 for each of the 132 SMs,
// each with (R + 4) x 544 x 4 B = 17 KB of shared memory at R 4; each warp
// scores 4 jobs, 512 nodes of each, with the next job's 16-byte chunks
// (one a lane, 512 B a warp) in flight.  Fewer jobs a tile stage the node tile more often, more
// leave SMs idle; on the flat slice's busiest launch these sizes measured
// fastest of a sweep on the card (cook_tpu_torch/tile_sweep.py), and
// BEST_NODE_TJ / _TN / _G override them for it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see cook_tpu_torch/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

#include "node_tile.cuh"

#ifndef BEST_NODE_TJ
#define BEST_NODE_TJ 32
#endif
#ifndef BEST_NODE_TN
#define BEST_NODE_TN 512
#endif
#ifndef BEST_NODE_G
#define BEST_NODE_G 1
#endif

extern "C" {

// Launches on `stream`; `mask` may be null (the unmasked variant); `keys`
// is a [2K] int64 scratch (any contents).  Returns the cudaError_t of the
// launches (0 = cudaSuccess).
int best_node_launch(const void* demands, const void* avail,
                     const void* totals, const void* valid, const void* mask,
                     void* out_val, void* out_idx, void* keys, int K, int N,
                     int R, void* stream) {
  return node_tile::launch<BEST_NODE_TJ, BEST_NODE_TN, BEST_NODE_G>(
      demands, avail, totals, valid, mask, out_val, out_idx, keys, 1, K, N, R,
      stream);
}

const char* best_node_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
