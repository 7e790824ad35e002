// coarse_pass: one hierarchical coarse pass — every chunk, every candidate
// pass and every single-candidate conflict round — in ONE launch.
//
// Replaces the Pallas TPU kernel `best_block` of cook_tpu/ops/pallas_match.py
// (entry :218, body _best_block_kernel :200) together with the scan around
// it, `_coarse_pallas` of cook_tpu/ops/hierarchical.py (:233): a lax.scan
// over chunks of `chunk` jobs, per chunk `passes` candidate passes, each
// one best_block call and `rounds` conflict rounds (cook_tpu/ops/match.py
// conflict_round :161 with one candidate a job).  The plain version is
// coarse_pass_reference in cook_tpu_torch/ops/coarse_pass.py.
//
// Contract (per chunk, availability carried from pass to pass and chunk
// to chunk):
//   pass   each active, unplaced, live (demand[0] < BIG) job takes its best
//          block on the current availability (block_score.cuh); a job
//          with no feasible block has no candidate this pass
//   round  a job contends for its candidate p iff it is unplaced and
//          avail[p] >= d on all R (no tolerance); per block, in job
//          order, a contender is accepted iff the inclusive sum of the
//          contenders' demand up to it is <= avail[p] + 1e-9 (added in
//          float32) on all R; then avail[p] -= (the accepted demand) as
//          one subtraction.  Demands are non-negative, so each block's
//          accepted set is a prefix of its contenders and the accepted
//          demand is the largest accepted prefix sum.
//
// Bound and design.  The work is tiny (at the 100k x 10k slice 16384 jobs
// x 16 blocks, under a MB read and a few M operations) and a chain of
// 4 chunks x 8 passes x (1 scoring + 2 rounds) = 96 dependent steps.  On
// the host each step was ~40-220 small torch ops; here each is a few
// barriers, so the chain of barriers and shared-memory round trips bounds
// the launch, not bytes or operations.  Hence:
//   * one persistent thread-block cluster of kCluster CTAs x kThreads
//     threads runs the whole pass; each CTA holds a replica of the [B, R]
//     availability and the block table (in shared memory, or paged to
//     device memory past it: below), and its share of the chunk's
//     per-job state, in shared memory; a job's demand row is read from
//     device memory (L1/L2 after the chunk's first pass: staging the
//     chunk in shared memory was 3% slower on the slice's launch);
//   * scoring: a thread owns jobs (slot s = tile * T + tid is chunk job
//     tile * C * T + cta * T + tid) and reads the block table from shared
//     memory (block_score.cuh), no dependent global loads;
//   * prefix-accept, per tile of C x T jobs: (1) in each warp a segmented
//     inclusive scan keyed by pick: for each distinct pick in the warp (in
//     the order of its first lane), a Kogge-Stone scan of the demand with
//     other lanes' entries 0; (2) each warp's per-(block, resource) total
//     (the scan at the key's last lane) into shared memory; (3) one thread
//     per (block, resource) walks the CTA's warps in order: each warp's
//     exclusive prefix within the CTA; (4) the C CTA totals, read through
//     distributed shared memory and summed in CTA order onto the running
//     carry of earlier tiles: each CTA's base, and the next carry;
//     (5) each contender: prefix = base + exclusive + inclusive, accept,
//     and the last accepted lane of each pick in a warp raises the
//     block's accepted demand by an integer atomicMax on the float's bits
//     (non-negative floats order as their bits): order-free and
//     deterministic, no float atomics; (6) the round's accepted demand is
//     the max over the CTAs' atomicMax slots, so every replica subtracts
//     the same value.
// tests/test_torch_coarse_pass.py models this algorithm in numpy line for
// line, sums in the kernel's order, for every warp count and cluster size.
//
// Launch shape: kCluster (COARSE_PASS_CLUSTER, default 8) CTAs of kThreads
// (COARSE_PASS_THREADS, default 512) threads, both compile-time; the
// defaults were chosen on the card by `python -m cook_tpu_torch.tile_sweep
// --kernels coarse_pass`, which builds other shapes with -D overrides.
//
// Where the block state lives.  A CTA's block state is 9 B x R words of
// availability, table, carry, base and exchange, W x B x R of warp
// partials and 6 B of block pairs; with one word a job slot, a few flags
// (coarse_pass_smem_bytes) it fits the card's 227 KB of shared memory up
// to 279 blocks at R 8, 543 at R 4 and 1028 at R 2 (W = 16 warps, chunk
// 4096).  Past that the same kernel body, instantiated with kPaged, keeps
// each CTA's block state in its own stretch of a device-memory workspace
// (coarse_pass_workspace_floats, allocated by the wrapper): the accesses
// are the same, now L2 traffic, the CTAs read each other's exchange and
// accepted-demand words with L1-bypassing loads, and the cluster barrier
// is an explicit barrier.cluster arrive.release / wait.acquire, which
// orders global memory across the cluster.  Only the slots and flags stay
// in shared memory.  Paged or not, the time grows with B x R (every
// thread scans all B blocks for each of its jobs, each round walks B x R
// per warp, on one cluster): 13.29 ms at B 1024 x R 4 against 0.0768 ms
// at the slice's B 16 (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// Limits: 2 <= R <= 8; J a multiple of `chunk`; a chunk's job slots (one
// word each, 512 at chunk 4096) within the shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC   (see cook_tpu_torch/build.py)

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "block_score.cuh"
#include "score_tile.cuh"

#ifndef COARSE_PASS_CLUSTER
#define COARSE_PASS_CLUSTER 8
#endif
#ifndef COARSE_PASS_THREADS
#define COARSE_PASS_THREADS 512
#endif

namespace cg = cooperative_groups;

namespace {

using score_tile::kBig;
using score_tile::kMaxR;

constexpr int kCluster = COARSE_PASS_CLUSTER;
constexpr int kThreads = COARSE_PASS_THREADS;
constexpr int kWarps = kThreads / 32;
static_assert(kCluster >= 1 && kCluster <= 16, "1..16 CTAs a cluster");
static_assert(kThreads >= 32 && kThreads <= 1024 && kThreads % 32 == 0,
              "whole warps, at most 1024 threads");

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = -1;

// the shared memory a CTA may take on an H100 (the 227 KB opt-in); past it
// the block state pages to device memory (ops/coarse_pass.py SMEM_LIMIT)
constexpr int kSmemLimit = 227 * 1024;

// Layout, in 4-byte words.  The block state, per (block, resource), e =
// b*R+r: avail, gate, bmax, carry, base, xbuf[2] (cluster exchange),
// dmax[2] (accepted demand, float bits); per block pair: used, den, tot;
// partials part[W][B*R].  Then the small region: flags[W]; acc[4] (this
// CTA accepted a job this round, [0..1]; some CTA did, [2..3]); per slot:
// state.  In shared memory the small region follows the block state; paged,
// it alone is in shared memory.  Demands are read from device memory,
// where after a chunk's first pass they sit in L1/L2.
struct Layout {
  int avail, gate, bmax, carry, base, xbuf, dmax, used, den, tot, part,
      block_words;                   // block state
  int flags, acc, state, small_words;  // small region, from its start
};

// this CTA's slots of a chunk: one a thread per tile of C x T jobs
__host__ __device__ constexpr int slots_for(int chunk) {
  return (chunk + kCluster * kThreads - 1) / (kCluster * kThreads) * kThreads;
}

__host__ __device__ inline Layout layout(int B, int R, int chunk) {
  Layout L;
  const int br = B * R, slots = slots_for(chunk);
  int o = 0;
  L.avail = o; o += br;
  L.gate = o; o += br;
  L.bmax = o; o += br;
  L.carry = o; o += br;
  L.base = o; o += br;
  L.xbuf = o; o += 2 * br;
  L.dmax = o; o += 2 * br;
  L.used = o; o += 2 * B;
  L.den = o; o += 2 * B;
  L.tot = o; o += 2 * B;
  L.part = o; o += kWarps * br;
  L.block_words = o;
  o = 0;
  L.flags = o; o += kWarps;
  L.acc = o; o += 4;
  L.state = o; o += slots;
  L.small_words = o;
  return L;
}

// whether (B, R, chunk) pages its block state to device memory
inline bool paged_for(const Layout& L) {
  return 4LL * (L.block_words + L.small_words) > kSmemLimit;
}

// The cluster barrier.  Paged, an explicit arrive.release / wait.acquire,
// so every CTA's device-memory writes before it are visible to every CTA
// of the cluster after it.
template <bool kPaged>
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster) {
  if constexpr (kPaged) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  } else {
    cluster.sync();
  }
}

// word i of CTA c's copy of the block-state array at `mine` (this CTA's
// copy): distributed shared memory, or the peer's stretch of the
// workspace, `stride` words on, read past L1
template <bool kPaged, typename T>
__device__ __forceinline__ T peer(cg::cluster_group& cluster, T* mine, int c,
                                  int cta, int stride, int i) {
  if constexpr (kPaged)
    return __ldcg(mine + (ptrdiff_t)(c - cta) * stride + i);
  else
    return cluster.map_shared_rank(mine, c)[i];
}

// Per slot, `state` is >= 0 once placed (the block), -1 while unplaced
// with no candidate, and -2 - p while unplaced with candidate block p.
__device__ __forceinline__ int candidate(int state) { return -2 - state; }

// In-warp segmented inclusive scan of d keyed by `key` (kNone lanes take
// no part): for each distinct key, in the order of its first lane, a
// Kogge-Stone scan of d with the other lanes' entries 0.  `todo` (the
// contending lanes) is warp-uniform.
__device__ __forceinline__ void segmented_scan(int key, const float (&d)[kMaxR],
                                               int R, unsigned todo, int lane,
                                               float (&incl)[kMaxR]) {
  while (todo) {
    const int k = __shfl_sync(kFull, key, __ffs(todo) - 1);
    const bool mine = key == k;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      if (r >= R) break;
      float x = mine ? d[r] : 0.0f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x = y + x;
      }
      if (mine) incl[r] = x;
    }
    todo &= ~__ballot_sync(kFull, mine);
  }
}

// job `row`'s demand, zero past R
__device__ __forceinline__ void load_demand(const float* demands,
                                            int64_t row, int R,
                                            float (&d)[kMaxR]) {
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) d[r] = r >= R ? 0.0f : demands[row * R + r];
}

template <bool kPaged>
__global__ void __launch_bounds__(kThreads)
coarse_pass_kernel(const float* __restrict__ demands,       // [J,R]
                   const uint8_t* __restrict__ active,      // [J]
                   const float* __restrict__ block_avail,   // [B,R]
                   const float* __restrict__ block_max,     // [B,R]
                   const float* __restrict__ block_totals,  // [B,2]
                   const uint8_t* __restrict__ block_valid, // [B]
                   int32_t* __restrict__ out_assign,        // [J]
                   float* __restrict__ out_avail,           // [B,R]
                   float* workspace,  // [C, block_words] when kPaged
                   int J, int B, int R, int chunk, int passes, int rounds) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int cta = (int)cluster.block_rank();
  constexpr int span = kCluster * kThreads;  // chunk jobs per tile
  const int tiles = (chunk + span - 1) / span;
  const int br = B * R;
  const Layout L = layout(B, R, chunk);
  // this CTA's block state, and the small region
  float* blk = kPaged ? workspace + (size_t)cta * L.block_words : smem;
  float* small = kPaged ? smem : smem + L.block_words;
  float* s_avail = blk + L.avail;
  float* s_gate = blk + L.gate;
  float* s_bmax = blk + L.bmax;
  float* s_carry = blk + L.carry;
  float* s_base = blk + L.base;
  float* s_xbuf = blk + L.xbuf;
  unsigned* s_dmax = reinterpret_cast<unsigned*>(blk + L.dmax);
  float* s_used = blk + L.used;
  float* s_den = blk + L.den;
  float* s_tot = blk + L.tot;
  float* s_part = blk + L.part;
  int* s_flags = reinterpret_cast<int*>(small + L.flags);
  int* s_acc = reinterpret_cast<int*>(small + L.acc);
  int* s_state = reinterpret_cast<int*>(small + L.state);

  for (int e = tid; e < br; e += kThreads) {
    s_avail[e] = block_avail[e];
    s_bmax[e] = block_max[e];
    s_dmax[e] = 0u;
    s_dmax[br + e] = 0u;
  }
  if (tid < 4) s_acc[tid] = 0;
  for (int e = tid; e < 2 * B; e += kThreads) s_tot[e] = block_totals[e];
  block_score::stage_den(block_totals, B, s_den, tid, kThreads);
  // every CTA of the cluster is running (and its state written) before
  // any reads another's
  cluster_barrier<kPaged>(cluster);

  // without rounds a pass routes nothing (and would leave no barrier
  // between one chunk's scoring and the next chunk's table)
  if (rounds == 0) passes = 0;
  int xp = 0;  // parity of the cluster exchange buffer, one flip a tile
  int dp = 0;  // parity of the accepted-demand slots, one flip a round
  for (int c0 = 0; c0 < J; c0 += chunk) {
    for (int t = 0; t < tiles; ++t) s_state[t * kThreads + tid] = -1;
    for (int pass = 0; pass < passes; ++pass) {
      // the block table on the current availability (the block_max gate
      // and the totals are those of the whole launch)
      block_score::stage_gate(s_avail, s_bmax, block_valid, B, R, s_gate,
                              tid, kThreads);
      block_score::stage_used(s_tot, s_avail, B, R, s_used, tid, kThreads);
      __syncthreads();
      for (int t = 0; t < tiles; ++t) {
        const int s = t * kThreads + tid;
        const int job = t * span + cta * kThreads + tid;
        if (job >= chunk || s_state[s] >= 0) continue;
        float d[kMaxR];
        load_demand(demands, c0 + job, R, d);
        float best = -kBig;
        int idx = score_tile::kNoIdx;
        if (active[c0 + job] && score_tile::live(d))
          block_score::best_in_table(s_gate, s_used, s_den, B, R, d, best,
                                     idx);
        s_state[s] = best > -kBig ? -2 - idx : -1;
      }
      // A round that accepts nothing leaves availability and state as
      // they were, so every later round of the pass repeats it, and a
      // pass that accepts nothing makes every later pass of the chunk
      // repeat it: both loops end there, with the same result.
      bool changed = false;
      for (int round = 0; round < rounds; ++round) {
        for (int e = tid; e < br; e += kThreads) s_carry[e] = 0.0f;
        for (int t = 0; t < tiles; ++t, xp ^= 1) {
          const int s = t * kThreads + tid;
          const int job = t * span + cta * kThreads + tid;
          const int st = job < chunk ? s_state[s] : -1;
          float d[kMaxR] = {};
          int key = kNone;
          if (st <= -2) {
            load_demand(demands, c0 + job, R, d);
            const int p = candidate(st);
            if (score_tile::fits(s_avail + p * R, d, R)) key = p;
          }
          const unsigned contenders = __ballot_sync(kFull, key != kNone);
          const unsigned group = __match_any_sync(kFull, key);
          float incl[kMaxR];
          float* my_part = s_part + warp * br;
          if (contenders) {
            segmented_scan(key, d, R, contenders, lane, incl);
            for (int e = lane; e < br; e += 32) my_part[e] = 0.0f;
            __syncwarp();
            // the last lane of each pick holds the warp's total for it
            if (key != kNone && lane == 31 - __clz(group))
              for (int r = 0; r < R; ++r) my_part[key * R + r] = incl[r];
          }
          if (lane == 0) s_flags[warp] = contenders != 0;
          __syncthreads();
          // per (block, resource): each warp's exclusive prefix within the
          // CTA, the warps walked in order, 8 loads issued ahead of their
          // adds (a warp with no contender adds 0, which leaves the
          // non-negative run as it is)
          for (int e = tid; e < br; e += kThreads) {
            float run = 0.0f;
            for (int w0 = 0; w0 < kWarps; w0 += 8) {
              float v[8];
#pragma unroll
              for (int i = 0; i < 8; ++i)
                v[i] = w0 + i < kWarps && s_flags[w0 + i]
                           ? s_part[(w0 + i) * br + e] : 0.0f;
#pragma unroll
              for (int i = 0; i < 8; ++i) {
                if (w0 + i >= kWarps) break;
                s_part[(w0 + i) * br + e] = run;
                run = run + v[i];
              }
            }
            s_xbuf[xp * br + e] = run;
          }
          cluster_barrier<kPaged>(cluster);
          // the CTAs' totals in CTA order: this CTA's base, and the carry
          for (int e = tid; e < br; e += kThreads) {
            float run = s_carry[e];
            for (int c = 0; c < kCluster; ++c) {
              const float x = peer<kPaged>(cluster, s_xbuf, c, cta,
                                           L.block_words, xp * br + e);
              if (c == cta) s_base[e] = run;
              run = run + x;
            }
            s_carry[e] = run;
          }
          __syncthreads();
          bool accepted = false;
          float pre[kMaxR];
          if (key != kNone) {
            accepted = true;
            for (int r = 0; r < R; ++r) {
              pre[r] = s_base[key * R + r] + my_part[key * R + r] + incl[r];
              accepted = accepted && pre[r] <= s_avail[key * R + r] + 1e-9f;
            }
            if (accepted) {
              s_state[s] = key;
              s_acc[dp] = 1;
            }
          }
          // the last accepted lane of each pick holds its largest accepted
          // prefix
          const unsigned acc = __ballot_sync(kFull, accepted) & group;
          if (accepted && lane == 31 - __clz(acc))
            for (int r = 0; r < R; ++r)
              atomicMax(s_dmax + dp * br + key * R + r,
                        __float_as_uint(pre[r]));
        }
        // the round's update: avail -= accepted demand, one subtraction
        cluster_barrier<kPaged>(cluster);
        // one warp reads the CTAs' flags; the barrier below publishes
        // their OR
        if (warp == 0) {
          const int f =
              lane < kCluster ? cluster.map_shared_rank(s_acc, lane)[dp] : 0;
          const unsigned some = __ballot_sync(kFull, f != 0);
          if (lane == 0) {
            s_acc[2 + dp] = some != 0u;
            s_acc[dp ^ 1] = 0;
          }
        }
        for (int e = tid; e < br; e += kThreads) {
          unsigned m = 0u;
          for (int c = 0; c < kCluster; ++c)
            m = max(m, peer<kPaged>(cluster, s_dmax, c, cta, L.block_words,
                                    dp * br + e));
          // every CTA read the other parity's slots before this round's
          // first cluster barrier
          s_dmax[(dp ^ 1) * br + e] = 0u;
          s_avail[e] = s_avail[e] - __uint_as_float(m);
        }
        __syncthreads();
        const int any_taken = s_acc[2 + dp];
        dp ^= 1;
        if (!any_taken) break;
        changed = true;
      }
      if (!changed) break;
    }
    for (int t = 0; t < tiles; ++t) {
      const int s = t * kThreads + tid, job = t * span + cta * kThreads + tid;
      if (job < chunk) out_assign[c0 + job] = max(s_state[s], -1);
    }
  }
  if (cta == 0)
    for (int e = tid; e < br; e += kThreads) out_avail[e] = s_avail[e];
  // no CTA leaves while another may still read its state
  cluster_barrier<kPaged>(cluster);
}

int max_smem_bytes() {
  static int bytes = 0;
  if (!bytes) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                           dev);
  }
  return bytes;
}

template <bool kPaged>
cudaError_t prepare_kernel(size_t bytes) {
  static size_t allowed = 48 << 10;
  static bool wide = false;
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        coarse_pass_kernel<kPaged>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    allowed = bytes;
  }
  if constexpr (kCluster > 8) {
    if (!wide) {
      const cudaError_t err = cudaFuncSetAttribute(
          coarse_pass_kernel<kPaged>,
          cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      wide = true;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The dynamic shared-memory bytes a CTA takes for (B, R, chunk): the whole
// layout, or the small region alone when the block state pages.
int coarse_pass_smem_bytes(int B, int R, int chunk) {
  const Layout L = layout(B, R, chunk);
  return (int)sizeof(float)
         * (paged_for(L) ? L.small_words : L.block_words + L.small_words);
}

// The floats of the device-memory workspace the launch needs: 0 when the
// block state fits in shared memory, else one stretch of block state a CTA.
long long coarse_pass_workspace_floats(int B, int R, int chunk) {
  const Layout L = layout(B, R, chunk);
  return paged_for(L) ? (long long)kCluster * L.block_words : 0;
}

// Launches on `stream`; returns the cudaError_t of the launch
// (0 = cudaSuccess), cudaErrorInvalidValue for arguments the kernel does
// not take, a shared memory need over the card's, or a paged shape without
// its workspace.
int coarse_pass_launch(const void* demands, const void* active,
                       const void* block_avail, const void* block_max,
                       const void* block_totals, const void* block_valid,
                       void* out_assign, void* out_avail, void* workspace,
                       int J, int B, int R, int chunk, int passes, int rounds,
                       void* stream) {
  if (J <= 0 || B <= 0 || R < 2 || R > kMaxR || chunk <= 0 || J % chunk
      || passes < 0 || rounds < 0)
    return (int)cudaErrorInvalidValue;
  const bool paged = paged_for(layout(B, R, chunk));
  if (paged && workspace == nullptr) return (int)cudaErrorInvalidValue;
  const int bytes = coarse_pass_smem_bytes(B, R, chunk);
  if (bytes > max_smem_bytes()) return (int)cudaErrorInvalidValue;
  cudaError_t err = paged ? prepare_kernel<true>(bytes)
                          : prepare_kernel<false>(bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kCluster);
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &config, paged ? coarse_pass_kernel<true> : coarse_pass_kernel<false>,
      static_cast<const float*>(demands),
      static_cast<const uint8_t*>(active),
      static_cast<const float*>(block_avail),
      static_cast<const float*>(block_max),
      static_cast<const float*>(block_totals),
      static_cast<const uint8_t*>(block_valid),
      static_cast<int32_t*>(out_assign), static_cast<float*>(out_avail),
      static_cast<float*>(workspace), J, B, R, chunk, passes, rounds);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* coarse_pass_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
