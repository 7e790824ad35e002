// node_tile.cuh: the tiled job x node scorer that best_node.cu and
// best_node_batched.cu both instantiate (best_node is the batch of one).
//
// A thread block owns a (job tile x node tile) of one batch entry:
//   grid  = (ceil(S / TJ) job tiles, ceil(N / TN) node tiles, B)
//   block = 8 warps; G warps share each job of the tile
// and runs, in order:
//   1. its job tile's demands, into shared memory: a block with no live row
//      (score_tile::live) exits here, writing (-BIG, -1) for its rows where
//      nothing else will;
//   2. the node tile into shared memory, once for all TJ jobs: `avail` and
//      `totals` land with 4-byte `cp.async` copies straight into
//      per-resource rows (structure of arrays), node i at i + i/16, so the
//      16 consecutive nodes a lane scores sit in 16 different banks from
//      the other lanes'; one pass then stages the pairs (used0, used1) =
//      tot - av and (den0, den1) = max(tot, 1e-30) per node, folds
//      `node_valid` into avail row 0 as NaN (which no demand fits: a NaN
//      compare is false), and takes each resource's minimum over the tile;
//      a second pass marks, per 16-node group, each node whose staged rows
//      equal its predecessor's (runs of identical hosts);
//   3. per live job, the mask row as aligned 16-byte vectors (uint4: 16
//      nodes a lane, 512 a warp instruction); a warp loads its next live
//      job's chunks before it scores the current one's; a row
//      start that is not 16-byte aligned or a ragged tail is masked here,
//      byte by byte; a dead row reads no mask byte, a zero chunk is skipped;
//   4. each lane keeps (best, first idx) with a strict `>` over its nodes in
//      increasing order, skipping the fit test for a job under every
//      resource's tile minimum and every node of a run after the first it
//      scores (score_chunk); the warp combines lanes by the first-index
//      shuffle, shared memory the G warps of a job;
//   5. with one node tile the block writes (val, idx) itself; with several,
//      it submits one packed key per job with a 64-bit atomicMax
//      (score_tile.cuh), and the job tile's last node tile to finish
//      (a counter beside the keys) unpacks its jobs' keys and recomputes
//      each winner's fitness from the inputs (so -0.0 keeps its sign bit,
//      which the key folds into +0.0).
//
// Build with --fmad=false (cook_tpu_torch/build.py): the fitness is then
// rounded as the plain PyTorch versions round it, bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "score_tile.cuh"

namespace node_tile {

using score_tile::kBig;
using score_tile::kMaxR;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;

// shared-memory row pitch of a TN-node tile: node i sits at pad(i)
template <int TN>
__host__ __device__ constexpr int pitch() { return TN + TN / 16; }

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// staged: (used0, used1) and (den0, den1) as pairs [2][ld], avail rows
// [R][ld], the tile's demands [TJ][kMaxR], each 16-node group's run bits
// [TN/16], the per-resource tile minima as order keys [kMaxR], and the G
// warps' partial results per job
template <int TJ, int TN, int G>
size_t smem_bytes(int R) {
  return (size_t)(R + 4) * pitch<TN>() * sizeof(float)
         + (size_t)(TJ * kMaxR + TN / 16 + kMaxR) * sizeof(float)
         + (size_t)TJ * G * (sizeof(float) + sizeof(int));
}

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(kBytes));
}

// a lane's running best: score and node
struct Best {
  float val;
  int idx;
};

// Score staged node p for demand d.  kCheck: test the R fit columns (a job
// under every resource's tile minimum fits every node of the tile, and
// skips them).
template <bool kCheck>
__device__ __forceinline__ void score_node(const float* __restrict__ s,
                                           int ld, int R, int p, int node,
                                           const float (&d)[kMaxR],
                                           Best& b) {
  if (kCheck) {
    bool ok = true;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
      ok = ok && (r >= R || s[(4 + r) * ld + p] >= d[r]);
    if (!ok) return;
  }
  // score_tile::fitness, with tot - av and max(tot, 1e-30) staged
  const float2 u = reinterpret_cast<const float2*>(s)[p];
  const float2 e = reinterpret_cast<const float2*>(s)[ld + p];
  const float fit = ((u.x + d[0]) / e.x + (u.y + d[1]) / e.y) * 0.5f;
  if (fit > b.val) b = Best{fit, node};
}

// The set bytes of one 16-byte mask chunk, node i0 + j for byte j; where
// the row start is 16-byte aligned (kAligned) node i0 + j sits at
// 17 c + j, c = i0 / 16.  Bit j of `same` says node i0 + j's staged rows
// equal node i0 + j - 1's bit for bit (a run of identical nodes): its
// fitness and feasibility are then those of the run's earlier node, which
// cannot lose to it under the strict `>`, so only a run's first set byte
// is scored (the fleet's identical hosts).
template <bool kCheck, bool kAligned>
__device__ __forceinline__ void score_chunk(const float* __restrict__ s,
                                            int ld, int R, const uint32_t (&w)[4],
                                            uint32_t same, int i0, int n0,
                                            const float (&d)[kMaxR],
                                            Best& b) {
  bool run = false;  // a node of the current run was scored
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    run = run && ((same >> j) & 1u);
    if ((w[j >> 2] & (0xffu << (8 * (j & 3)))) && !run) {
      score_node<kCheck>(s, ld, R,
                         kAligned ? (i0 >> 4) * 17 + j : pad(i0 + j),
                         n0 + i0 + j, d, b);
      run = true;
    }
  }
}

// one chunk c of a job row: bytes outside the tile's [0, tn) cleared (the
// row's first and last chunk), then its set bytes scored; s_same holds the
// run bits of the tile's 16-node groups
template <int TN, bool kCheck>
__device__ __forceinline__ void chunk_row(const float* __restrict__ s,
                                          const uint32_t* s_same, int ld,
                                          int R, uint4 m, int c, int mis,
                                          int tn, int n0,
                                          const float (&d)[kMaxR], Best& b) {
  uint32_t w[4] = {m.x, m.y, m.z, m.w};
  if ((w[0] | w[1] | w[2] | w[3]) == 0u) return;
  const int i0 = c * 16 - mis;
  if (i0 < 0 || i0 + 16 > tn) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (i0 + j < 0 || i0 + j >= tn) w[j >> 2] &= ~(0xffu << (8 * (j & 3)));
  }
  // the chunk's nodes straddle groups c - 1 and c unless the row is aligned
  const uint32_t lo = c > 0 ? s_same[c - 1] : 0u;
  const uint32_t hi = c < TN / 16 ? s_same[c] : 0u;
  const uint32_t same = (lo | (hi << 16)) >> (16 - mis);
  if (mis == 0)  // the same for the whole row
    score_chunk<kCheck, true>(s, ld, R, w, same, i0, n0, d, b);
  else
    score_chunk<kCheck, false>(s, ld, R, w, same, i0, n0, d, b);
}

// chunks of 16 mask bytes each lane of a job's G warps loads ahead: the
// row's first TN bytes; a row start that is not 16-byte aligned spills
// into one more chunk, loaded when the row is scored
template <int TN, int G>
__host__ __device__ constexpr int ahead() { return TN / (16 * 32 * G); }

template <int TN, int G>
__device__ __forceinline__ void load_ahead(const uint8_t* mask_row, int tn,
                                           int q, int lane,
                                           uint4 (&m)[ahead<TN, G>()]) {
  const uintptr_t addr = (uintptr_t)mask_row;
  const int mis = (int)(addr & 15);
  const uint4* base = reinterpret_cast<const uint4*>(addr - mis);
  const int nch = (mis + tn + 15) >> 4;
#pragma unroll
  for (int u = 0; u < ahead<TN, G>(); ++u) {
    const int c = q * 32 + lane + u * 32 * G;
    m[u] = c < nch ? __ldg(base + c) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// one job row of the tile, on lanes of G warps: its loaded-ahead chunks
// m, then any spilled chunk (or, unmasked, its nodes); each lane's nodes
// in increasing order
template <int TN, int G, bool kMasked, bool kCheck>
__device__ __forceinline__ void score_row(const float* __restrict__ s,
                                          const uint32_t* s_same, int R,
                                          const uint8_t* mask_row,
                                          int tn, int n0, int q, int lane,
                                          const float (&d)[kMaxR],
                                          const uint4 (&m)[ahead<TN, G>()],
                                          Best& b) {
  constexpr int ld = pitch<TN>();
  if (!kMasked) {
    for (int i = q * 32 + lane; i < tn; i += 32 * G)
      score_node<kCheck>(s, ld, R, pad(i), n0 + i, d, b);
    return;
  }
  const uintptr_t addr = (uintptr_t)mask_row;
  const int mis = (int)(addr & 15);
#pragma unroll
  for (int u = 0; u < ahead<TN, G>(); ++u)
    chunk_row<TN, kCheck>(s, s_same, ld, R, m[u], q * 32 + lane + u * 32 * G,
                          mis, tn, n0, d, b);
  const uint4* base = reinterpret_cast<const uint4*>(addr - mis);
  const int nch = (mis + tn + 15) >> 4;
  for (int c = ahead<TN, G>() * 32 * G + q * 32 + lane; c < nch;
       c += 32 * G)
    chunk_row<TN, kCheck>(s, s_same, ld, R, __ldg(base + c), c, mis, tn, n0,
                          d, b);
}

// (b, s)'s answer from its packed key: the winner, with its fitness
// recomputed from the inputs; (-BIG, -1) for the empty key
__device__ __forceinline__ void finalize_key(
    int64_t row, const unsigned long long* keys, const float* demands,
    const float* avail, const float* totals, float* out_val,
    int32_t* out_idx, int S, int N, int R) {
  const unsigned long long key = __ldcg(keys + row);
  if (key == score_tile::kEmptyKey) {
    score_tile::store_best(-kBig, score_tile::kNoIdx, out_val + row,
                           out_idx + row);
    return;
  }
  const int n = score_tile::key_index(key);
  const int64_t node = (row / S) * N + n;
  float d[kMaxR];
  score_tile::load_demand(demands + row * R, R, d);
  const float* a = avail + node * R;
  out_val[row] = score_tile::fitness(totals[2 * node], totals[2 * node + 1],
                                     a[0], a[1], d);
  out_idx[row] = n;
}

template <int TJ, int TN, int G, bool kMasked, bool kSplit>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ demands,  // [B,S,R]
            const float* __restrict__ avail,    // [B,N,R]
            const float* __restrict__ totals,   // [B,N,2]
            const uint8_t* __restrict__ valid,  // [B,N]
            const uint8_t* __restrict__ mask,   // [B,S,N]
            float* __restrict__ out_val,        // [B,S]
            int32_t* __restrict__ out_idx,      // [B,S]
            unsigned long long* __restrict__ keys,  // see launch()
            int S, int N, int R) {
  static_assert(kWarps % G == 0 && TN % (16 * 32 * G) == 0
                    && TJ * G <= kThreads && TJ <= kThreads,
                "tile shape");
  constexpr int ld = pitch<TN>();
  constexpr int kStep = kWarps / G;  // jobs of the tile scored at once

  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);  // [R + 4][ld]
  float2* s_u = reinterpret_cast<float2*>(s);  // [ld] (used0, used1)
  float2* s_e = s_u + ld;                      // [ld] (den0, den1)
  float* s_av = s + 4 * ld;                    // [R][ld]
  float* s_d = s + (R + 4) * ld;               // [TJ][kMaxR]
  uint32_t* s_same = reinterpret_cast<uint32_t*>(s_d + TJ * kMaxR);  // [TN/16]
  uint32_t* s_min = s_same + TN / 16;          // [kMaxR] order keys
  float* s_pv = reinterpret_cast<float*>(s_min + kMaxR);  // [TJ][G]
  int* s_pi = reinterpret_cast<int*>(s_pv + TJ * G);
  __shared__ bool s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t b = blockIdx.z;
  const int job0 = blockIdx.x * TJ;
  const int n0 = blockIdx.y * TN;
  const int tn = min(TN, N - n0);

  // 1. the job tile's demands, into shared memory (a row past S is dead):
  // nothing live, nothing to stage
  bool mine = false;
  if (tid < TJ) {
    float d[kMaxR] = {2 * kBig};
    if (job0 + tid < S)
      score_tile::load_demand(demands + (b * S + job0 + tid) * R, R, d);
    mine = score_tile::live(d);
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) s_d[tid * kMaxR + r] = d[r];
  }
  if (!__syncthreads_or(mine)) {
    // (with several node tiles, the first answers the tile's rows)
    if ((!kSplit || blockIdx.y == 0) && tid < TJ && job0 + tid < S)
      score_tile::store_best(-kBig, score_tile::kNoIdx,
                             out_val + b * S + job0 + tid,
                             out_idx + b * S + job0 + tid);
    return;
  }
  if (tid < TJ * G) {
    s_pv[tid] = -kBig;
    s_pi[tid] = score_tile::kNoIdx;
  }
  if (tid < kMaxR) s_min[tid] = ~0u;

  // 2. the node tile, once per block: avail into its rows and the totals
  // pairs into the den pairs, then per node used = tot - av and
  // den = max(tot, 1e-30), with node_valid (loaded while the copies are in
  // flight) folded into avail row 0
  const float* av_g = avail + (b * N + n0) * R;
  for (int i = tid; i < tn; i += kThreads)
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
      if (r < R) cp_async<4>(s_av + r * ld + pad(i), av_g + i * R + r);
  const float* tot_g = totals + (b * N + n0) * 2;
  for (int e = tid; e < tn * 2; e += kThreads)
    cp_async<4>(reinterpret_cast<float*>(s_e + pad(e >> 1)) + (e & 1),
                tot_g + e);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  constexpr int kPer = (TN + kThreads - 1) / kThreads;  // nodes a thread
  bool ok[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    ok[k] = i < tn && valid[b * N + n0 + i];
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();
  // each resource's minimum over the tile, NaN (an invalid node) as -inf; a
  // job under every minimum fits every node of the tile (a -inf minimum
  // never counts: it may stand for an invalid node)
  const float inf = __int_as_float(0x7f800000);
  float mn[kMaxR];
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) mn[r] = inf;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    if (i >= tn) break;
    const int p = pad(i);
    const float2 tot = s_e[p];
    s_u[p] = make_float2(tot.x - s_av[p], tot.y - s_av[ld + p]);
    s_e[p] = make_float2(fmaxf(tot.x, 1e-30f), fmaxf(tot.y, 1e-30f));
    if (!ok[k]) s_av[p] = __int_as_float(0x7fc00000);  // NaN fits nothing
#pragma unroll
    for (int r = 0; r < kMaxR; ++r)
      if (r < R) {
        const float a = s_av[r * ld + p];
        mn[r] = fminf(mn[r], a == a ? a : -inf);
      }
  }
#pragma unroll
  for (int r = 0; r < kMaxR; ++r) {
    if (r >= R) break;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mn[r] = fminf(mn[r], __shfl_xor_sync(0xffffffffu, mn[r], off));
    if (lane == 0) atomicMin(s_min + r, score_tile::order_key(mn[r]));
  }
  __syncthreads();
  // each 16-node group's run bits: bit k set where node 16 g + k's staged
  // rows equal node 16 g + k - 1's, bit for bit (bit 0 never)
  const uint32_t* words = reinterpret_cast<const uint32_t*>(s);
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = tid + k * kThreads;
    bool same = i < tn && (i & 15) != 0;
    if (same) {
      const int p = pad(i), o = pad(i - 1);
#pragma unroll
      for (int r = 0; r < 4 + kMaxR; ++r)  // the pairs' 4 words, then avail
        if (r < 4 + R) {
          const int row = r < 4 ? (r >> 1) * 2 * ld + (r & 1) : r * ld;
          const int pp = r < 4 ? 2 * p : p, oo = r < 4 ? 2 * o : o;
          same = same && words[row + pp] == words[row + oo];
        }
    }
    const uint32_t bits = __ballot_sync(0xffffffffu, same);
    const int g = (warp * 32 + k * kThreads) >> 4;
    if (lane == 0 && g < TN / 16) {
      s_same[g] = bits & 0xffffu;
      if (g + 1 < TN / 16) s_same[g + 1] = bits >> 16;
    }
  }
  __syncthreads();

  // 3-4. G warps per job, kStep jobs at a time; a warp's next live job's
  // mask chunks load while it scores the current one (more jobs in flight
  // measured no faster: cook_tpu_torch/tile_sweep.py, PERF.md)
  const int q = warp % G;
  auto next_live = [&](int jj) {
    while (jj < TJ && !(s_d[jj * kMaxR] < kBig)) jj += kStep;
    return jj;
  };
  auto row_of = [&](int jj) {
    return kMasked ? mask + (b * S + job0 + jj) * N + n0 : nullptr;
  };
  uint4 next[ahead<TN, G>()];
  int cur = next_live(warp / G);
  if (kMasked && cur < TJ) load_ahead<TN, G>(row_of(cur), tn, q, lane, next);
  while (cur < TJ) {  // the same job for the whole warp
    uint4 m[ahead<TN, G>()];
#pragma unroll
    for (int u = 0; u < ahead<TN, G>(); ++u) m[u] = next[u];
    const int after = next_live(cur + kStep);
    if (kMasked && after < TJ)
      load_ahead<TN, G>(row_of(after), tn, q, lane, next);

    float d[kMaxR];
    bool fits_all = true;
#pragma unroll
    for (int r = 0; r < kMaxR; ++r) {
      d[r] = s_d[cur * kMaxR + r];
      if (r < R) {
        const uint32_t k = s_min[r];
        const float lo =
            __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
        fits_all = fits_all && d[r] <= lo && lo > -3.4e38f;
      }
    }
    Best best{-kBig, score_tile::kNoIdx};
    if (fits_all)  // the same for the whole warp
      score_row<TN, G, kMasked, false>(s, s_same, R, row_of(cur), tn, n0, q,
                                       lane, d, m, best);
    else
      score_row<TN, G, kMasked, true>(s, s_same, R, row_of(cur), tn, n0, q,
                                      lane, d, m, best);
    float val = best.val;
    int idx = best.idx;
    score_tile::warp_argmax_first(val, idx);
    if (lane == 0) {
      s_pv[cur * G + q] = val;
      s_pi[cur * G + q] = idx;
    }
    cur = after;
  }
  __syncthreads();

  // 5. one result per job of the tile
  if (tid < TJ && job0 + tid < S) {
    float best = s_pv[tid * G];
    int idx = s_pi[tid * G];
#pragma unroll
    for (int g = 1; g < G; ++g) {
      const float v = s_pv[tid * G + g];
      const int x = s_pi[tid * G + g];
      if (v > best || (v == best && x < idx)) {
        best = v;
        idx = x;
      }
    }
    const int64_t row = b * S + job0 + tid;
    if (!kSplit)
      score_tile::store_best(best, idx, out_val + row, out_idx + row);
    else if (best > -kBig)
      atomicMax(keys + row, score_tile::pack_key(best, idx));
  }
  if (!kSplit) return;
  // the job tile's last node tile to finish unpacks its rows' keys (the
  // counters, zeroed with the keys, follow the B*S keys)
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    unsigned* done = reinterpret_cast<unsigned*>(keys + (int64_t)gridDim.z * S)
                     + b * gridDim.x + blockIdx.x;
    s_last = atomicAdd(done, 1u) == gridDim.y - 1;
  }
  __syncthreads();
  if (s_last && tid < TJ && job0 + tid < S) {
    __threadfence();
    finalize_key(b * S + job0 + tid, keys, demands, avail, totals, out_val,
                 out_idx, S, N, R);
  }
}

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, size_t smem, cudaStream_t s,
                       const float* dp, const float* ap, const float* tp,
                       const uint8_t* vp, const uint8_t* mp, float* ov,
                       int32_t* oi, unsigned long long* keys, int S, int N,
                       int R) {
  // above 48 KB a block gets dynamic shared memory only on request; and
  // the SM's split of L1 and shared memory is asked to favour shared
  // memory, so that as many blocks fit an SM as the registers allow
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, s>>>(dp, ap, tp, vp, mp, ov, oi, keys, S, N,
                                      R);
  return cudaGetLastError();
}

// The C entry points' body.  `keys` is a [2*B*S] int64 scratch the
// wrapper allocates; used only when N spans more than one node tile, and
// then zeroed here: B*S packed keys (0 the empty key), then a uint32 count
// of finished node tiles per job tile.
template <int TJ, int TN, int G>
int launch(const void* demands, const void* avail, const void* totals,
           const void* valid, const void* mask, void* out_val, void* out_idx,
           void* keys, int B, int S, int N, int R, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || N <= 0 || R < 2 || R > kMaxR)
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (N + TN - 1) / TN;
  if (tiles_n > 65535 || (tiles_n > 1 && keys == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + TJ - 1) / TJ, tiles_n, B);
  const size_t smem = smem_bytes<TJ, TN, G>(R);
  const float* dp = static_cast<const float*>(demands);
  const float* ap = static_cast<const float*>(avail);
  const float* tp = static_cast<const float*>(totals);
  const uint8_t* vp = static_cast<const uint8_t*>(valid);
  const uint8_t* mp = static_cast<const uint8_t*>(mask);
  float* ov = static_cast<float*>(out_val);
  int32_t* oi = static_cast<int32_t*>(out_idx);
  unsigned long long* kp = static_cast<unsigned long long*>(keys);
  if (tiles_n == 1)
    return (int)(mp != nullptr
                     ? launch_one(tile_kernel<TJ, TN, G, true, false>, grid,
                                  smem, s, dp, ap, tp, vp, mp, ov, oi, kp, S,
                                  N, R)
                     : launch_one(tile_kernel<TJ, TN, G, false, false>, grid,
                                  smem, s, dp, ap, tp, vp, mp, ov, oi, kp, S,
                                  N, R));
  const size_t scratch = (size_t)B * S * sizeof(unsigned long long)
                         + (size_t)B * grid.x * sizeof(unsigned);
  const cudaError_t err = cudaMemsetAsync(kp, 0, scratch, s);
  if (err != cudaSuccess) return (int)err;
  return (int)(mp != nullptr
                   ? launch_one(tile_kernel<TJ, TN, G, true, true>, grid,
                                smem, s, dp, ap, tp, vp, mp, ov, oi, kp, S, N,
                                R)
                   : launch_one(tile_kernel<TJ, TN, G, false, true>, grid,
                                smem, s, dp, ap, tp, vp, mp, ov, oi, kp, S, N,
                                R));
}

}  // namespace node_tile
