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
// Design.  node_tile.cuh with the grid's z axis on the batch: a thread
// block owns TJ slots of one block b, stages b's nodes in shared memory
// once for them, and streams each live slot's mask row as 16-byte vectors,
// G warps to a slot.  A topology block's nodes (1024 at the 100k x 10k
// slice) fit one node tile whole, so each thread block writes its slots'
// answers itself, with no cross-block combine; a wider block would split
// into node tiles and combine through the packed-key atomicMax, as
// best_node does.  A thread block whose slots are all placed or empty (the
// fine pass's 2*BIG mark) reads only their demands and writes (-BIG, -1).
//
// Bound.  The live slots' mask rows, one byte per (slot, node), are the
// stream that grows with the problem: at the hierarchical slice's launch
// ([16, 2048, 1024], 4096 of 32768 slots live) 4.2 MB, 1.6 us at 3.35
// TB/s.  The live slots sit in 2 of the 16 topology blocks there, so only
// ~512 thread blocks work, each staging its block's 1024 nodes for 8
// slots: fixed costs, not bytes, set the ~0.029 ms this design takes
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).  The previous design
// (`best_node.cu` with batch offsets: one warp per slot walking its
// block's N nodes with 1-byte mask loads, every warp re-reading the
// block's node data from global memory, 4096 thread blocks of which
// ~3,584 held only dead slots) took 0.0358 ms (same script and card).
//
// Tiles.  TJ 8 slots x TN 1024 nodes, G 2 warps a slot: the slice's 4096
// live slots make 512 working thread blocks, ~4 on each of the 132 SMs; a
// slot's 1 KB row is 64-65 uint4 chunks, one or two a lane of its 2
// warps; the node tile is (R + 4) x 1088 x 4 B = 35 KB at R 4.  The sizes
// are the fastest of a sweep on the card (cook_tpu_torch/tile_sweep.py);
// BEST_NODE_BATCHED_TJ / _TN / _G override them for that sweep.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see cook_tpu_torch/build.py)

#include <cuda_runtime.h>
#include <stdint.h>

#include "node_tile.cuh"

#ifndef BEST_NODE_BATCHED_TJ
#define BEST_NODE_BATCHED_TJ 8
#endif
#ifndef BEST_NODE_BATCHED_TN
#define BEST_NODE_BATCHED_TN 1024
#endif
#ifndef BEST_NODE_BATCHED_G
#define BEST_NODE_BATCHED_G 2
#endif

extern "C" {

// Launches on `stream`; `mask` may be null (the unmasked variant); `keys`
// is a [2*B*S] int64 scratch (any contents), used only when N exceeds one
// node tile.  Returns the cudaError_t of the launches (0 = cudaSuccess).
int best_node_batched_launch(const void* demands, const void* avail,
                             const void* totals, const void* valid,
                             const void* mask, void* out_val, void* out_idx,
                             void* keys, int B, int S, int N, int R,
                             void* stream) {
  return node_tile::launch<BEST_NODE_BATCHED_TJ, BEST_NODE_BATCHED_TN,
                           BEST_NODE_BATCHED_G>(
      demands, avail, totals, valid, mask, out_val, out_idx, keys, B, S, N, R,
      stream);
}

const char* best_node_batched_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
