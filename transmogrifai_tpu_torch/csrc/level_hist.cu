// K-E level_hist: the per-level gradient histograms of the tree grower.
//
// Replaces: transmogrifai_tpu/ops/trees.py::_level_histograms (the
// segment-sum build) and the light-child pass of _grow_level (:413-447):
// for every (tree t, slot s, channel ch, feature j, bin b), the sum of the
// row's channel ch over the rows whose id is s and whose bin of feature j
// is b.  A row carries C1 = c + 1 channels (2 <= C1 <= 129): the c weighted
// gradients (one for binary and regression trees, one per class for the
// multiclass forests' -onehot gradients and the softmax boosting, up to 128
// classes) and the weighted hessian last, the JAX package's ghw layout.  In
// the light-only mode the ids are the sibling-pair ids of each pair's
// lighter child; the heavy child is parent - light in float32 and the pair
// is stacked back into slot order (light left iff pair_light).
//
// The reference sums each bucket in float32, row by row in increasing row
// order (XLA's CPU segment_sum).  Two paths give those bits; the wrapper
// (ops/trees.py::hist_exact) picks one a fit from its inputs:
//
// The ordered path (level_hist_ordered_*: real-valued inputs, the boosting
// losses' gradients, the forests' -y on real targets).  The rows are first
// grouped by slot in row order, a stable counting sort of the ids
// (group_count: each tile's count of each slot; group_scan: the offsets;
// group_scatter: a warp a tile, ranks by __match_any_sync, the rows
// written to their slot's segment in order).  Then a warp takes one (tree,
// slot, group of FW features, slab of at most 8 channels, window of 32 NQ
// bins) and walks the slot's segment in row order, 64 to 256 rows at a
// time staged in shared memory (the next stage's loads in flight
// meanwhile, the row indices of the one after it too): lane l owns bins l, l + 32,
// ..., and adds each row's channels to its float32 sums in registers when
// the row's bin is one of its own (the rows read from shared memory a
// batch at a time, the next batch's while one is added), so every bucket
// is one float32 chain in row order,
// and no float value meets an atomic.  The warp writes its light sums and,
// in the light-only mode, the heavy sibling parent - light.  A level of
// fewer than 1,024 (tree, slot) pairs takes a feature a warp, so that more
// warps walk the rows; then a warp's time is the slot's rows times the few
// cycles of a row's adds.
//
// The fixed-point path (level_hist_i8 / _i32: every value an integer and
// every tree's channel sum of |values| at most 2^24, so the float32 sums
// are exact in any order: -onehot and Poisson-weighted forest gradients,
// unit hessians).  The sums are taken in 64-bit fixed point (each channel's
// value times the power of two ``scale``, 2^32, rounded to the nearest
// integer, XGBoost-GPU's trick, arXiv:1806.11248); integer addition gives
// the same total in any order, so the shared- and global-memory atomics
// below need no fixed order.  level_hist_accum: a block takes a chunk of one
// tree's rows, a group of features and a range of slots, and accumulates a
// private int64 histogram in shared memory, one thread per row; it then
// adds its non-zero cells into the level's int64 histogram in device
// memory.  Above 9 channels (level_hist_accum_slab) the channels are cut
// into slabs of at most kSlab, a grid dimension, and a slab skips a row's
// zero channels (a -onehot row has one non-zero gradient channel).
// level_hist_finish converts to float32 and does the parent - light
// assembly.
//
// Bound on the card: bytes for the fixed-point path (each row of a tree
// read once per feature group).  The ordered path is bound by its chains:
// a warp walks its slot's rows one after another (a few instructions a row
// a feature, one lane of 32 adding).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemBudget = 96 * 1024;  // two blocks an SM
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMaxChannels = 129;  // c + 1 for up to 128 classes (ops/trees.py::MAX_CHANNELS)
constexpr int kMaxFlat = 9;        // up to here one block takes all of a row's channels
constexpr int kSlab = 8;           // above, the most channels a block takes
constexpr int kGroupTile = 4096;   // rows a tile of the ordered path's grouping
constexpr int kOrdWarps = 8;       // warps a block of the ordered sums

// C1, the row's channel count, is a template parameter: the per-row
// channel loops unroll with no predication.
template <typename BinT, int C1>
__global__ void level_hist_accum(const BinT* __restrict__ Xb, const float* __restrict__ ghw,
                                 const int32_t* __restrict__ ids,
                                 unsigned long long* __restrict__ acc, int n, int d, int B,
                                 int mp, int slots_per_block, int feats_per_block,
                                 int slot_ranges, int chunk_rows, float scale) {
  extern __shared__ unsigned long long sh[];  // [slots][C1][feats][B]
  const int chunk = blockIdx.x;
  const int j0 = blockIdx.y * feats_per_block;
  const int t = blockIdx.z / slot_ranges;
  const int s0 = (blockIdx.z % slot_ranges) * slots_per_block;
  const int nf = min(feats_per_block, d - j0);
  const int ns = min(slots_per_block, mp - s0);
  const int fb = feats_per_block * B;
  const int len = ns * C1 * fb;
  for (int i = threadIdx.x; i < len; i += blockDim.x) sh[i] = 0ull;
  __syncthreads();
  const long long r0 = (long long)chunk * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const long long tn = (long long)t * n;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int id = ids[tn + r];
    if (id < s0 || id >= s0 + ns) continue;
    long long v[C1];
    const float* gr = ghw + (tn + r) * C1;
#pragma unroll
    for (int ch = 0; ch < C1; ++ch) v[ch] = __float2ll_rn(__fmul_rn(gr[ch], scale));
    unsigned long long* cell = sh + (size_t)(id - s0) * C1 * fb;
    const BinT* xr = Xb + r * d + j0;
    for (int jj = 0; jj < nf; ++jj) {
      const int b = (int)xr[jj];
      if (b < 0 || b >= B) continue;
#pragma unroll
      for (int ch = 0; ch < C1; ++ch)
        atomicAdd(cell + ch * fb + jj * B + b, (unsigned long long)v[ch]);
    }
  }
  __syncthreads();
  // acc[t, s, ch, j, b]
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const unsigned long long v = sh[i];
    if (v == 0ull) continue;
    const int b = i % B;
    const int jj = (i / B) % feats_per_block;
    const int ch = (i / fb) % C1;
    const int sl = i / (C1 * fb);
    if (jj >= nf) continue;
    const long long o = (((long long)t * mp + s0 + sl) * C1 + ch) * (long long)d * B +
                        (long long)(j0 + jj) * B + b;
    atomicAdd(acc + o, v);
  }
}

// The same over channels ch0 .. ch0 + sw - 1 (sw <= kSlab) of rows of C1
// channels: slab = blockIdx.y % slabs, feature group = blockIdx.y / slabs.
template <typename BinT>
__global__ void level_hist_accum_slab(const BinT* __restrict__ Xb,
                                      const float* __restrict__ ghw,
                                      const int32_t* __restrict__ ids,
                                      unsigned long long* __restrict__ acc, int n, int d, int B,
                                      int C1, int mp, int slots_per_block, int feats_per_block,
                                      int slot_ranges, int slabs, int chunk_rows, float scale) {
  extern __shared__ unsigned long long sh[];  // [slots][sw][feats][B]
  const int chunk = blockIdx.x;
  const int slab = blockIdx.y % slabs;
  const int j0 = (blockIdx.y / slabs) * feats_per_block;
  const int per = (C1 + slabs - 1) / slabs;
  const int ch0 = slab * per;
  const int sw = min(per, C1 - ch0);
  const int t = blockIdx.z / slot_ranges;
  const int s0 = (blockIdx.z % slot_ranges) * slots_per_block;
  const int nf = min(feats_per_block, d - j0);
  const int ns = min(slots_per_block, mp - s0);
  const int fb = feats_per_block * B;
  const int len = ns * sw * fb;
  for (int i = threadIdx.x; i < len; i += blockDim.x) sh[i] = 0ull;
  __syncthreads();
  const long long r0 = (long long)chunk * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const long long tn = (long long)t * n;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int id = ids[tn + r];
    if (id < s0 || id >= s0 + ns) continue;
    long long v[kSlab];
    const float* gr = ghw + (tn + r) * C1 + ch0;
    bool any = false;
#pragma unroll
    for (int ch = 0; ch < kSlab; ++ch) {
      v[ch] = ch < sw ? __float2ll_rn(__fmul_rn(gr[ch], scale)) : 0ll;
      any |= v[ch] != 0ll;
    }
    // a -onehot row has one non-zero gradient channel: the other slabs'
    // blocks skip it, and zeros add nothing to an integer sum
    if (!any) continue;
    unsigned long long* cell = sh + (size_t)(id - s0) * sw * fb;
    const BinT* xr = Xb + r * d + j0;
    for (int jj = 0; jj < nf; ++jj) {
      const int b = (int)xr[jj];
      if (b < 0 || b >= B) continue;
#pragma unroll
      for (int ch = 0; ch < kSlab; ++ch)
        if (v[ch] != 0ll) atomicAdd(cell + ch * fb + jj * B + b, (unsigned long long)v[ch]);
    }
  }
  __syncthreads();
  // acc[t, s, ch0 + ch, j, b]
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const unsigned long long v = sh[i];
    if (v == 0ull) continue;
    const int b = i % B;
    const int jj = (i / B) % feats_per_block;
    const int ch = (i / fb) % sw;
    const int sl = i / (sw * fb);
    if (jj >= nf) continue;
    const long long o = (((long long)t * mp + s0 + sl) * C1 + ch0 + ch) * (long long)d * B +
                        (long long)(j0 + jj) * B + b;
    atomicAdd(acc + o, v);
  }
}

// One thread per (t, pair or slot, ch, j, b) of the light (or direct)
// histogram: the float32 value of the fixed-point sum, then the assembly.
__global__ void level_hist_finish(const unsigned long long* __restrict__ acc,
                                  const float* __restrict__ parent,
                                  const int32_t* __restrict__ pair_parent,
                                  const int32_t* __restrict__ pair_light, float* __restrict__ out,
                                  int d, int B, int C1, int T, int mp, int m_prev,
                                  float inv_scale) {
  const long long cell = (long long)C1 * d * B;  // one slot's (ch, j, b) block
  const long long total = (long long)T * mp * cell;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  // one rounding: the power-of-two scale is exact
  const float light = __fmul_rn(__ll2float_rn((long long)acc[i]), inv_scale);
  if (parent == nullptr) {
    out[i] = light;
    return;
  }
  const long long e = i % cell;
  const long long tp = i / cell;  // t * mp + pair
  const int t = (int)(tp / mp);
  const int p = (int)(tp % mp);
  const int ps = pair_parent[(long long)t * mp + p];
  const float par = ps >= 0 ? parent[((long long)t * m_prev + ps) * cell + e] : 0.0f;
  const float heavy = __fsub_rn(par, light);
  const bool light_left = pair_light[(long long)t * mp + p] != 0;
  const long long left = ((long long)t * 2 * mp + 2 * p) * cell + e;
  out[left] = light_left ? light : heavy;
  out[left + cell] = light_left ? heavy : light;
}

template <typename BinT, int C1>
cudaError_t run_accum(dim3 grid, size_t smem, cudaStream_t st, const void* Xb, const void* ghw,
                      const void* ids, void* acc, int n, int d, int B, int mp, int slots,
                      int feats, int ranges, int chunk_rows, float scale) {
  static bool attr_set = false;  // the attribute takes the budget's maximum once
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_hist_accum<BinT, C1>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  level_hist_accum<BinT, C1><<<grid, kThreads, smem, st>>>(
      (const BinT*)Xb, (const float*)ghw, (const int32_t*)ids, (unsigned long long*)acc, n, d,
      B, mp, slots, feats, ranges, chunk_rows, scale);
  return cudaGetLastError();
}

template <typename BinT>
cudaError_t run_accum_slab(dim3 grid, size_t smem, cudaStream_t st, const void* Xb,
                           const void* ghw, const void* ids, void* acc, int n, int d, int B,
                           int C1, int mp, int slots, int feats, int ranges, int slabs,
                           int chunk_rows, float scale) {
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        level_hist_accum_slab<BinT>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBudget);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  level_hist_accum_slab<BinT><<<grid, kThreads, smem, st>>>(
      (const BinT*)Xb, (const float*)ghw, (const int32_t*)ids, (unsigned long long*)acc, n, d,
      B, C1, mp, slots, feats, ranges, slabs, chunk_rows, scale);
  return cudaGetLastError();
}

template <typename BinT>
int launch(const void* Xb, const void* ghw, const void* ids, const void* parent,
           const void* pair_parent, const void* pair_light, void* acc, void* out, int n,
           int d, int B, int C1, int T, int mp, int m_prev, float scale, float inv_scale,
           void* stream) {
  if (n <= 0 || mp <= 0 || d <= 0 || B <= 0 || C1 < 2 || C1 > kMaxChannels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  // past kMaxFlat channels, slabs of at most kSlab channels (a grid dimension)
  const int slabs = C1 <= kMaxFlat ? 1 : (C1 + kSlab - 1) / kSlab;
  const int per = (C1 + slabs - 1) / slabs;
  // a block holds [slots][per][feats][B] int64 cells: as many features as
  // fit with every slot, else one feature and as many slots as fit
  const int per_slot_feat = per * B * (int)sizeof(unsigned long long);
  int feats = kSmemBudget / (mp * per_slot_feat);
  int slots = mp;
  if (feats < 1) {
    feats = 1;
    slots = kSmemBudget / per_slot_feat;
    if (slots < 1) return (int)cudaErrorInvalidValue;
  }
  if (feats > d) feats = d;
  const int groups = (d + feats - 1) / feats;
  const int ranges = (mp + slots - 1) / slots;
  const long long per_chunk = (long long)groups * slabs * ranges * T;
  long long chunks = (kTargetBlocks + per_chunk - 1) / per_chunk;
  const long long max_chunks = (n + 1023) / 1024;  // at least 1024 rows a block
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const int chunk_rows = (int)((n + chunks - 1) / chunks);
  const long long total = (long long)T * mp * C1 * d * B;
  err = cudaMemsetAsync(acc, 0, (size_t)total * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)slots * feats * per_slot_feat;
  dim3 grid((unsigned)chunks, (unsigned)(groups * slabs), (unsigned)(T * ranges));
  if (slabs > 1) {
    err = run_accum_slab<BinT>(grid, smem, st, Xb, ghw, ids, acc, n, d, B, C1, mp, slots, feats,
                               ranges, slabs, chunk_rows, scale);
    if (err != cudaSuccess) return (int)err;
  } else {
#define LEVEL_HIST_ACCUM(C)                                                              \
  case C:                                                                                \
    err = run_accum<BinT, C>(grid, smem, st, Xb, ghw, ids, acc, n, d, B, mp, slots, feats, \
                             ranges, chunk_rows, scale);                                 \
    break;
    switch (C1) {
      LEVEL_HIST_ACCUM(2) LEVEL_HIST_ACCUM(3) LEVEL_HIST_ACCUM(4) LEVEL_HIST_ACCUM(5)
      LEVEL_HIST_ACCUM(6) LEVEL_HIST_ACCUM(7) LEVEL_HIST_ACCUM(8) LEVEL_HIST_ACCUM(9)
      default: return (int)cudaErrorInvalidValue;
    }
#undef LEVEL_HIST_ACCUM
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = 256;
  level_hist_finish<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const unsigned long long*)acc, (const float*)parent, (const int32_t*)pair_parent,
      (const int32_t*)pair_light, (float*)out, d, B, C1, T, mp, m_prev, inv_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The ordered path
// ---------------------------------------------------------------------------
// Grouping pass 1: each tile's count of every slot id, slot-major:
// cnt[t][s][tile].
__global__ void group_count(const int32_t* __restrict__ ids, int* __restrict__ cnt, int n,
                            int mp, int tiles) {
  extern __shared__ int cs[];  // [mp]
  const int tile = blockIdx.x, t = blockIdx.y;
  for (int i = threadIdx.x; i < mp; i += blockDim.x) cs[i] = 0;
  __syncthreads();
  const long long r0 = (long long)tile * kGroupTile;
  const long long r1 = min((long long)n, r0 + kGroupTile);
  const int32_t* it = ids + (long long)t * n;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int s = it[r];
    if (s >= 0 && s < mp) atomicAdd(&cs[s], 1);  // counts: any order
  }
  __syncthreads();
  int* out = cnt + (long long)t * mp * tiles;
  for (int i = threadIdx.x; i < mp; i += blockDim.x) out[(long long)i * tiles + tile] = cs[i];
}

// Grouping pass 2: a block a tree scans its counts in place into the offsets
// of each (slot, tile) in the grouped order, and writes each slot's segment
// start (start[t][mp] = the tree's live rows).
__global__ void group_scan(int* __restrict__ cnt, int* __restrict__ start, int mp, int tiles) {
  __shared__ int warp_sums[32];
  __shared__ int carry;
  const int t = blockIdx.x;
  int* a = cnt + (long long)t * mp * tiles;
  const long long len = (long long)mp * tiles;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (long long base = 0; base < len; base += blockDim.x) {
    const long long i = base + threadIdx.x;
    const int v = i < len ? a[i] : 0;
    int x = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += u;
    }
    if (lane == 31) warp_sums[wid] = x;
    __syncthreads();
    if (wid == 0) {
      int q = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, q, o);
        if (lane >= o) q += u;
      }
      warp_sums[lane] = q;
    }
    __syncthreads();
    const int excl = carry + (wid > 0 ? warp_sums[wid - 1] : 0) + x - v;
    if (i < len) a[i] = excl;
    __syncthreads();  // every thread has read carry
    if (threadIdx.x == blockDim.x - 1) carry = excl + v;
    __syncthreads();
  }
  for (int s = threadIdx.x; s <= mp; s += blockDim.x)
    start[(long long)t * (mp + 1) + s] = s < mp ? a[(long long)s * tiles] : carry;
}

// Grouping pass 3: a warp a tile walks its rows in order, 32 at a time; the
// lanes of one slot take consecutive places from the slot's running cursor
// in lane (row) order, so each slot's segment holds its rows in row order.
__global__ void group_scatter(const int32_t* __restrict__ ids, const int* __restrict__ cnt,
                              int32_t* __restrict__ order, int n, int mp, int tiles) {
  extern __shared__ int cur[];  // [warps][mp]
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tile = blockIdx.x * (blockDim.x >> 5) + wid;
  const int t = blockIdx.y;
  if (tile >= tiles) return;  // a whole warp
  int* my = cur + (long long)wid * mp;
  for (int s = lane; s < mp; s += 32) my[s] = cnt[((long long)t * mp + s) * tiles + tile];
  __syncwarp();
  const long long r0 = (long long)tile * kGroupTile;
  const long long r1 = min((long long)n, r0 + kGroupTile);
  const int32_t* it = ids + (long long)t * n;
  int32_t* ot = order + (long long)t * n;
  for (long long b = r0; b < r1; b += 32) {
    const long long r = b + lane;
    int s = r < r1 ? it[r] : -1;
    const bool live = s >= 0 && s < mp;
    if (!live) s = -1;
    const unsigned peers = __match_any_sync(0xffffffffu, s);
    const int rank = __popc(peers & ((1u << lane) - 1u));
    const int leader = __ffs(peers) - 1;
    int at = (live && lane == leader) ? my[s] : 0;
    at = __shfl_sync(0xffffffffu, at, leader);
    if (live) ot[at + rank] = (int32_t)r;
    __syncwarp();
    if (live && lane == leader) my[s] = at + __popc(peers);
    __syncwarp();
  }
}

// The sums: a warp a (tree, slot, feature group, channel slab, bin window),
// see the header.  SW channels a slab (sw <= SW live), NQ bins a lane, FW
// features a warp.  bw0 = the window's first bin.
template <typename BinT, int SW, int NQ, int FW>
__global__ void __launch_bounds__(kOrdWarps * 32)
level_hist_ordered(const BinT* __restrict__ Xb, const float* __restrict__ ghw,
                   const int32_t* __restrict__ order, const int* __restrict__ start,
                   const float* __restrict__ parent, const int32_t* __restrict__ pair_parent,
                   const int32_t* __restrict__ pair_light, float* __restrict__ out, int n,
                   int d, int B, int C1, int mp, int m_prev, int groups, int slabs, int per,
                   int bwins, long long warps) {
  // rows a warp stages at a time: a row's record is SW channels and FW bins
  constexpr int kStage = SW + FW <= 3 ? 256 : (SW + FW <= 6 ? 128 : 64);
  static_assert(kOrdWarps * kStage * (SW + FW) * 4 <= 48 * 1024, "the staging fits a block");
  __shared__ float sv[kOrdWarps][kStage][SW];
  __shared__ int sb[kOrdWarps][kStage][FW];
  const int wid = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long wg = (long long)blockIdx.x * (blockDim.x >> 5) + wid;
  if (wg >= warps) return;  // a whole warp
  long long q = wg;
  const int bw = (int)(q % bwins);
  q /= bwins;
  const int slab = (int)(q % slabs);
  q /= slabs;
  const int g = (int)(q % groups);
  q /= groups;
  const int s = (int)(q % mp);
  const int t = (int)(q / mp);
  const int j0 = g * FW, nf = min(FW, d - j0);
  const int ch0 = slab * per, sw = min(per, C1 - ch0);
  const int bin0 = bw * 32 * NQ;
  const long long seg0 = start[(long long)t * (mp + 1) + s];
  const long long seg1 = start[(long long)t * (mp + 1) + s + 1];
  const int32_t* ord = order + (long long)t * n;
  const float* gt = ghw + (long long)t * n * C1 + ch0;
  float acc[FW][NQ][SW];
#pragma unroll
  for (int f = 0; f < FW; ++f)
#pragma unroll
    for (int u = 0; u < NQ; ++u)
#pragma unroll
      for (int ch = 0; ch < SW; ++ch) acc[f][u][ch] = 0.0f;
  // The segment in stages of kStage rows, kStage / 32 a lane.  Software
  // pipeline: while a stage is summed from shared memory, the next stage's
  // channels and bins are in flight to registers and the row indices of the
  // one after it too, so a warp's chain is not a chain of memory latencies.
  constexpr int kPer = kStage / 32;
  constexpr int kBatch = SW * FW * NQ <= 16 ? 8 : (SW * FW * NQ <= 32 ? 4 : 2);
  int rn[kPer];       // rows of the next stage (-1: none)
  float cv[kPer][SW]; // channels of the stage to stage next
  BinT cb[kPer][FW];  // its raw bins
  int rc[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const long long e = seg0 + u * 32 + lane, e2 = e + kStage;
    rc[u] = e < seg1 ? ord[e] : -1;
    rn[u] = e2 < seg1 ? ord[e2] : -1;
  }
  auto fetch = [&](const int (&rr)[kPer]) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long r = rr[u];
#pragma unroll
      for (int ch = 0; ch < SW; ++ch) cv[u][ch] = (r >= 0 && ch < sw) ? gt[r * C1 + ch] : 0.0f;
#pragma unroll
      for (int f = 0; f < FW; ++f) cb[u][f] = (r >= 0 && f < nf) ? Xb[r * d + j0 + f] : (BinT)0;
    }
  };
  fetch(rc);
  for (long long e0 = seg0; e0 < seg1; e0 += kStage) {
    const int cnt = (int)min((long long)kStage, seg1 - e0);
#pragma unroll
    for (int u = 0; u < kPer; ++u) {  // stage the fetched rows (none: zeros, no bin)
      const int i = u * 32 + lane;
#pragma unroll
      for (int ch = 0; ch < SW; ++ch) sv[wid][i][ch] = cv[u][ch];
#pragma unroll
      for (int f = 0; f < FW; ++f)
        sb[wid][i][f] = (f < nf && rc[u] >= 0) ? (int)cb[u][f] - bin0 : -1;
      rc[u] = rn[u];
    }
    fetch(rn);  // the next stage's rows, and the indices of the one after
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const long long e = e0 + 2 * kStage + u * 32 + lane;
      rn[u] = e < seg1 ? ord[e] : -1;
    }
    __syncwarp();
    // the stage's rows in order, kBatch at a time: a batch's records read
    // from shared memory while the one before is added (a row of no lane's
    // bins, or of zeros, adds nothing to a sum that starts at +0)
    float v[kBatch][SW], nv[kBatch][SW];
    int bb[kBatch][FW], nb[kBatch][FW];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
#pragma unroll
      for (int ch = 0; ch < SW; ++ch) v[k][ch] = sv[wid][k][ch];
#pragma unroll
      for (int f = 0; f < FW; ++f) bb[k][f] = sb[wid][k][f];
    }
    for (int i0 = 0; i0 < cnt; i0 += kBatch) {
      const int i1 = min(i0 + kBatch, kStage - kBatch);  // the next batch (or this one again)
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
#pragma unroll
        for (int ch = 0; ch < SW; ++ch) nv[k][ch] = sv[wid][i1 + k][ch];
#pragma unroll
        for (int f = 0; f < FW; ++f) nb[k][f] = sb[wid][i1 + k][f];
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k)
#pragma unroll
        for (int f = 0; f < FW; ++f)
#pragma unroll
          for (int u = 0; u < NQ; ++u)
            if (bb[k][f] == lane + 32 * u) {
#pragma unroll
              for (int ch = 0; ch < SW; ++ch)
                acc[f][u][ch] = __fadd_rn(acc[f][u][ch], v[k][ch]);
            }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
#pragma unroll
        for (int ch = 0; ch < SW; ++ch) v[k][ch] = nv[k][ch];
#pragma unroll
        for (int f = 0; f < FW; ++f) bb[k][f] = nb[k][f];
      }
    }
    __syncwarp();
  }
  // out[t, slot, ch, j, b]: the light sums, and in the light-only mode the
  // heavy sibling beside them
  const long long cell = (long long)C1 * d * B;
  const bool light = parent != nullptr;
  int ps = -1;
  bool light_left = true;
  if (light) {
    ps = pair_parent[(long long)t * mp + s];
    light_left = pair_light[(long long)t * mp + s] != 0;
  }
#pragma unroll
  for (int f = 0; f < FW; ++f) {
    if (f >= nf) continue;
#pragma unroll
    for (int u = 0; u < NQ; ++u) {
      const int b = bin0 + lane + 32 * u;
      if (b >= B) continue;
#pragma unroll
      for (int ch = 0; ch < SW; ++ch) {
        if (ch >= sw) continue;
        const long long e = (long long)(ch0 + ch) * d * B + (long long)(j0 + f) * B + b;
        const float lv = acc[f][u][ch];
        if (!light) {
          out[((long long)t * mp + s) * cell + e] = lv;
          continue;
        }
        const float par = ps >= 0 ? parent[((long long)t * m_prev + ps) * cell + e] : 0.0f;
        const float hv = __fsub_rn(par, lv);
        const long long left = ((long long)t * 2 * mp + 2 * s) * cell + e;
        out[left] = light_left ? lv : hv;
        out[left + cell] = light_left ? hv : lv;
      }
    }
  }
}

template <typename BinT, int SW, int NQ>
cudaError_t run_ordered(long long warps, cudaStream_t st, const void* Xb, const void* ghw,
                        const int32_t* order, const int* start, const void* parent,
                        const void* pair_parent, const void* pair_light, void* out, int n,
                        int d, int B, int C1, int mp, int m_prev, int slabs, int per,
                        int bwins, bool wide) {
  // FW features a warp: one while the slots are few (the root's chains are
  // the rows themselves), more once the level has slots to spread over
  constexpr int FWIDE = (32 / (SW * NQ)) < 1 ? 1 : ((32 / (SW * NQ)) > 8 ? 8 : 32 / (SW * NQ));
  const int fw = wide ? FWIDE : 1;
  const int groups = (d + fw - 1) / fw;
  const long long total = warps * groups;
  // few warps: a warp a block, so that each has an SM's issue slots and
  // shared memory to itself (the root of a small tree batch)
  const int wpb = total < 8 * 132 ? 1 : kOrdWarps;
  const unsigned blocks = (unsigned)((total + wpb - 1) / wpb);
#define ORDERED_SUMS(F)                                                                      \
  level_hist_ordered<BinT, SW, NQ, F><<<blocks, wpb * 32, 0, st>>>(                          \
      (const BinT*)Xb, (const float*)ghw, order, start, (const float*)parent,                \
      (const int32_t*)pair_parent, (const int32_t*)pair_light, (float*)out, n, d, B, C1, mp, \
      m_prev, groups, slabs, per, bwins, total)
  if (wide)
    ORDERED_SUMS(FWIDE);
  else
    ORDERED_SUMS(1);
#undef ORDERED_SUMS
  return cudaGetLastError();
}

template <typename BinT, int SW>
cudaError_t run_ordered_nq(int NQ, long long warps, cudaStream_t st, const void* Xb,
                           const void* ghw, const int32_t* order, const int* start,
                           const void* parent, const void* pair_parent, const void* pair_light,
                           void* out, int n, int d, int B, int C1, int mp, int m_prev,
                           int slabs, int per, int bwins, bool wide) {
  switch (NQ) {
    case 1:
      return run_ordered<BinT, SW, 1>(warps, st, Xb, ghw, order, start, parent, pair_parent,
                                      pair_light, out, n, d, B, C1, mp, m_prev, slabs, per,
                                      bwins, wide);
    case 2:
      return run_ordered<BinT, SW, 2>(warps, st, Xb, ghw, order, start, parent, pair_parent,
                                      pair_light, out, n, d, B, C1, mp, m_prev, slabs, per,
                                      bwins, wide);
    case 4:
      return run_ordered<BinT, SW, 4>(warps, st, Xb, ghw, order, start, parent, pair_parent,
                                      pair_light, out, n, d, B, C1, mp, m_prev, slabs, per,
                                      bwins, wide);
    default:
      return run_ordered<BinT, SW, 8>(warps, st, Xb, ghw, order, start, parent, pair_parent,
                                      pair_light, out, n, d, B, C1, mp, m_prev, slabs, per,
                                      bwins, wide);
  }
}

template <typename BinT>
int launch_ordered(const void* Xb, const void* ghw, const void* ids, const void* parent,
                   const void* pair_parent, const void* pair_light, void* order, void* start,
                   void* cnt, void* out, int n, int d, int B, int C1, int T, int mp,
                   int m_prev, void* stream) {
  if (n <= 0 || mp <= 0 || d <= 0 || B <= 0 || C1 < 2 || C1 > kMaxChannels ||
      (size_t)mp * sizeof(int) > (size_t)kSmemBudget)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  const int tiles = (n + kGroupTile - 1) / kGroupTile;
  // the grouping: counts, offsets, the rows in slot order
  size_t smem = (size_t)mp * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(group_count, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  group_count<<<dim3((unsigned)tiles, (unsigned)T), 256, smem, st>>>(
      (const int32_t*)ids, (int*)cnt, n, mp, tiles);
  group_scan<<<(unsigned)T, 1024, 0, st>>>((int*)cnt, (int*)start, mp, tiles);
  int scatter_warps = 8;
  while (scatter_warps > 1 && (size_t)scatter_warps * mp * sizeof(int) > (size_t)kSmemBudget)
    scatter_warps /= 2;
  smem = (size_t)scatter_warps * mp * sizeof(int);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(group_scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  group_scatter<<<dim3((unsigned)((tiles + scatter_warps - 1) / scatter_warps), (unsigned)T),
                  scatter_warps * 32, smem, st>>>((const int32_t*)ids, (const int*)cnt,
                                                  (int32_t*)order, n, mp, tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the sums: channel slabs of at most kSlab (one slab up to 8 channels),
  // windows of at most 256 bins
  const int slabs = (C1 + kSlab - 1) / kSlab;
  const int per = (C1 + slabs - 1) / slabs;
  const int SW = per <= 2 ? 2 : (per <= 4 ? 4 : 8);
  const int NQ = B <= 32 ? 1 : (B <= 64 ? 2 : (B <= 128 ? 4 : 8));
  const int bwins = (B + 32 * NQ - 1) / (32 * NQ);
  const long long warps = (long long)T * mp * slabs * bwins;  // times the feature groups
  // few slots a level: a feature a warp, so that more warps share the chains
  const bool wide = (long long)T * mp >= 1024;
  switch (SW) {
    case 2:
      err = run_ordered_nq<BinT, 2>(NQ, warps, st, Xb, ghw, (const int32_t*)order,
                                    (const int*)start, parent, pair_parent, pair_light, out, n,
                                    d, B, C1, mp, m_prev, slabs, per, bwins, wide);
      break;
    case 4:
      err = run_ordered_nq<BinT, 4>(NQ, warps, st, Xb, ghw, (const int32_t*)order,
                                    (const int*)start, parent, pair_parent, pair_light, out, n,
                                    d, B, C1, mp, m_prev, slabs, per, bwins, wide);
      break;
    default:
      err = run_ordered_nq<BinT, 8>(NQ, warps, st, Xb, ghw, (const int32_t*)order,
                                    (const int*)start, parent, pair_parent, pair_light, out, n,
                                    d, B, C1, mp, m_prev, slabs, per, bwins, wide);
  }
  return (int)err;
}


// ---------------------------------------------------------------------------
// The root mode: the rows' sums of every channel of a tree, in the order
// XLA's CPU code reduces the reference's gw.sum(axis=0) and hw.sum() (its
// tree-reduction rewrite): windows of kRootWindow rows (half the padding to
// a multiple of it in front), each summed in order from +0, then the
// windows' sums alike, until at most kRootWindow remain, summed in order.
// A thread a (tree, window, channel).
// ---------------------------------------------------------------------------
constexpr int kRootWindow = 32;

__global__ void root_window_sums(const float* __restrict__ in, float* __restrict__ out, int T,
                                 int k, int C1, int nw, int lo) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)T * nw * C1) return;
  const int ch = (int)(i % C1);
  const int w = (int)((i / C1) % nw);
  const int t = (int)(i / ((long long)C1 * nw));
  const int st = w * kRootWindow;
  const int a = max(0, st - lo), b = min(k, st - lo + kRootWindow);
  const float* x = in + (long long)t * k * C1 + ch;
  float acc = 0.0f;
  for (int r = a; r < b; ++r) acc = __fadd_rn(acc, x[(long long)r * C1]);
  out[i] = acc;
}

}  // namespace

// root sums f32[T, C1] of ghw f32[T, n, C1]; scratch f32[2, T, ceil(n / 32),
// C1]
extern "C" int root_sums(const void* ghw, void* scratch, void* out, int T, int n, int C1,
                         void* stream) {
  if (T <= 0 || n < 0 || C1 <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* src = (const float*)ghw;
  float* buf[2] = {(float*)scratch,
                   (float*)scratch + (long long)T * ((n + kRootWindow - 1) / kRootWindow) * C1};
  int k = n, side = 0;
  while (k > kRootWindow) {
    const int nw = (k + kRootWindow - 1) / kRootWindow;
    const int lo = (nw * kRootWindow - k) / 2;
    const long long total = (long long)T * nw * C1;
    root_window_sums<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(src, buf[side], T, k, C1,
                                                                       nw, lo);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    src = buf[side];
    side ^= 1;
    k = nw;
  }
  // at most kRootWindow left: one window without padding, in order from +0
  const long long total = (long long)T * C1;
  root_window_sums<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(src, (float*)out, T, k, C1,
                                                                     1, 0);
  return (int)cudaGetLastError();
}

extern "C" int level_hist_i8(const void* Xb, const void* ghw, const void* ids,
                             const void* parent, const void* pair_parent,
                             const void* pair_light, void* acc, void* out, int n, int d, int B,
                             int C1, int T, int mp, int m_prev, float scale, float inv_scale,
                             void* stream) {
  return launch<int8_t>(Xb, ghw, ids, parent, pair_parent, pair_light, acc, out, n, d, B, C1,
                        T, mp, m_prev, scale, inv_scale, stream);
}

extern "C" int level_hist_i32(const void* Xb, const void* ghw, const void* ids,
                              const void* parent, const void* pair_parent,
                              const void* pair_light, void* acc, void* out, int n, int d,
                              int B, int C1, int T, int mp, int m_prev, float scale,
                              float inv_scale, void* stream) {
  return launch<int32_t>(Xb, ghw, ids, parent, pair_parent, pair_light, acc, out, n, d, B, C1,
                         T, mp, m_prev, scale, inv_scale, stream);
}

// The ordered path: order i32[T, n], start i32[T, mp + 1] and cnt i32[T, mp,
// ceil(n / 4096)] are the grouping's scratch.
extern "C" int level_hist_ordered_i8(const void* Xb, const void* ghw, const void* ids,
                                     const void* parent, const void* pair_parent,
                                     const void* pair_light, void* order, void* start,
                                     void* cnt, void* out, int n, int d, int B, int C1, int T,
                                     int mp, int m_prev, void* stream) {
  return launch_ordered<int8_t>(Xb, ghw, ids, parent, pair_parent, pair_light, order, start,
                                cnt, out, n, d, B, C1, T, mp, m_prev, stream);
}

extern "C" int level_hist_ordered_i32(const void* Xb, const void* ghw, const void* ids,
                                      const void* parent, const void* pair_parent,
                                      const void* pair_light, void* order, void* start,
                                      void* cnt, void* out, int n, int d, int B, int C1, int T,
                                      int mp, int m_prev, void* stream) {
  return launch_ordered<int32_t>(Xb, ghw, ids, parent, pair_parent, pair_light, order, start,
                                 cnt, out, n, d, B, C1, T, mp, m_prev, stream);
}
