// K-E level_hist: the per-level gradient histograms of the tree grower.
//
// Replaces: transmogrifai_tpu/ops/trees.py::_level_histograms (the
// segment-sum build) and the light-child pass of _grow_level (:413-447):
// for every (tree t, slot s, channel ch, feature j, bin b), the sum of the
// row's channel ch over the rows whose id is s and whose bin of feature j
// is b.  A row carries C1 = c + 1 channels (2 <= C1 <= 129): the c weighted
// gradients (one for binary and regression trees, one per class for the
// multiclass forests' -onehot gradients, up to 128 classes) and the
// weighted hessian last, the JAX package's ghw layout.  In the light-only mode the ids are the
// sibling-pair ids of each pair's lighter child; the heavy child is
// parent - light and the pair is stacked back into slot order (light left
// iff pair_light).
//
// Runs repeat bit for bit: the sums are taken in 64-bit fixed point (each
// channel's value times the power of two ``scale`` the caller passes, 2^32 in
// the port, rounded to the nearest integer, XGBoost-GPU's trick,
// arXiv:1806.11248), and integer addition gives the same total in any
// order, so the shared- and global-memory atomics below need no fixed
// order.  Values that are multiples of 1 / scale (integer-valued
// gradients, for instance) sum exactly, as float32 sums them when those
// are exact; other values are rounded once each by at most 1 / (2 scale),
// below a float32 sum's own rounding at these magnitudes.  The caller
// keeps every sum in range: row count x largest channel value below
// 2^63 / scale.
//
// Entry point 1 (level_hist_accum): a block takes a chunk of one tree's
// rows, a group of features and a range of slots, and accumulates a private
// int64 histogram in shared memory, one thread per row; it then adds its
// non-zero cells into the level's int64 histogram in device memory.  Entry
// point 2 (level_hist_finish) converts to float32 and does the parent -
// light assembly.
//
// Above 9 channels (level_hist_accum_slab) the channels are cut into slabs
// of at most kSlab, a grid dimension: a block reads only its slab's
// channels of a row (and the row's id and bins), so its shared histogram
// and its per-row registers stay those of a 9-channel block whatever the
// class count; the sums stay in fixed point, so the slabs change no bit.
// A slab skips a row's zero channels (a -onehot row has one non-zero
// gradient channel, so most slabs skip the row): at 27 channels the atomics
// a row are those of two channels, not 27.
//
// Bound on the card: bytes.  Each row of a tree is read once per feature
// group (its id, its C1 channels, its bins); the int64 histogram is written
// by atomics and read once.  A block's shared histogram holds C1 channels
// (a slab's, past 9) per (slot, feature, bin), so at C1 = 4 it takes half as
// many features or slots as at C1 = 2.  Past 9 channels the id and bins of
// a row are read once per slab.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSmemBudget = 96 * 1024;  // two blocks an SM
constexpr int kTargetBlocks = 4 * 132;
constexpr int kMaxChannels = 129;  // c + 1 for up to 128 classes (ops/trees.py::MAX_CHANNELS)
constexpr int kMaxFlat = 9;        // up to here one block takes all of a row's channels
constexpr int kSlab = 8;           // above, the most channels a block takes

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

}  // namespace

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
