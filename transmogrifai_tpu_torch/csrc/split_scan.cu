// K-F split_scan: one level's split choice, compaction and node records.
//
// Replaces: transmogrifai_tpu/ops/trees.py::_grow_level, the split scan and
// the compaction (:449-523), and the same math of _grow_level_batch
// (:767-830): per frontier slot, bin prefix sums of the c gradient channels
// G_ch and of H, the XGBoost gain
//   sum_ch GL_ch^2/(HL+l) + sum_ch GR_ch^2/(HR+l) - sum_ch GT_ch^2/(HT+l)
// with GR = GT - GL and the node totals GT, HT from feature 0's bins (c = 1
// for binary and regression trees; c = k classes for the multiclass
// forests' -onehot gradients, the gini-equivalent gain), the masks (min
// child weight on both sides, feature mask, last bin), the first argmax
// over the feature-major d*B axis, the gates gain > gamma and gain >= mig *
// HT; then, per tree, the beam cap (stable gain rank) or the count clamp,
// the cumsum that packs the children, the slot records, the children's
// leaf values -G_ch/(H+l) per channel, and the sibling pairs of the next
// level (parent slot and whether the light child, HL <= HR, is the left
// one).
//
// Design: two entry points.  split_best: one warp per (tree, slot), many
// blocks; the warp stages the slot's histogram in shared memory (up to 32
// features at a time, padded rows, all c + 1 channels), each lane runs one
// feature's prefix sums bin by bin (the order of the reference's cumsum),
// sums the squares over the channels in channel order (fused multiply-adds,
// as XLA's), and keeps its first best with the prefix sums there; a shuffle
// reduction with an index tie-break gives the slot's first argmax, written
// to a scratch array.  split_commit: one block per tree, one thread
// per slot for the gates, the rank and the records, the cumsum in one
// thread.  Every other operation is rounded as written (no FMA
// contraction), so the kernel and its plain version agree bit for bit on
// one histogram.
//
// Above 8 channels (split_best_wide, up to kMaxC) a lane cannot keep c
// running sums in registers, so the warp works on the staged tile itself:
// its rows (one a channel and feature) are turned into prefix sums in place,
// a lane a row, bin by bin (the same additions, in the same order); then
// each lane takes (feature, bin) candidates and sums the squares over the
// channels in channel order from the tile, one fused multiply-add a
// channel, and the node totals GT are feature 0's last prefix.  The winner's
// left sums GL are summed again from the histogram in bin order (a lane a
// channel), so no lane carries c values.  The tile of ft features takes
// dynamic shared memory (ft x (c + 1) x (B + 1) floats a warp).  Every sum
// is the narrow path's, so the two agree bit for bit.
//
// Bound on the card: bytes (the histograms read once, T x m x (c+1) x d x B
// floats); the ~10 + 4c operations per candidate split are below it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxC = 128;                // gradient channels (ops/trees.py::MAX_CHANNELS)
constexpr int kMaxNarrow = 8;             // up to here the running sums live in registers
constexpr int kSmemBudget = 48 * 1024;    // split_best's staging, all warps
// split_best_wide's tile a warp (at least a feature) and all warps' staging:
// small, so that several blocks share an SM (on an H100 at 64 channels 2.2x
// faster than 24 KB a warp in a 200 KB block, the same bits)
constexpr int kWideWarpBytes = 6 * 1024;
constexpr int kWideBudget = 64 * 1024;

// Should (vb, ib) replace (va, ia) in a first-argmax where NaN is largest?
__device__ __forceinline__ bool takes(float vb, int ib, float va, int ia) {
  const bool nb = isnan(vb), na = isnan(va);
  if (nb != na) return nb;
  if (nb) return ib < ia;
  if (vb != va) return vb > va;
  return ib < ia;
}

// scratch rows, each [T, m]: best gain, HL at the best split, HT, the flat
// best index j * B + b (an int), then c rows of GL at the best split and c
// rows of the node totals GT
enum { kBest = 0, kHLb, kHT, kIdx, kGLb };

// row[0] + row[1] + ... + row[len - 1], in order, each addition rounded
__device__ __forceinline__ float row_sum(const float* row, int len) {
  float a = row[0];
  for (int b = 1; b < len; ++b) a = __fadd_rn(a, row[b]);
  return a;
}

// sum_ch v[ch]^2 in channel order: v0 * v0, then a fused multiply-add per
// channel (XLA's CPU code contracts the reference's sum of squares so)
template <int C>
__device__ __forceinline__ float sum_sq(const float* v) {
  float s = __fmul_rn(v[0], v[0]);
#pragma unroll
  for (int ch = 1; ch < C; ++ch) s = __fmaf_rn(v[ch], v[ch], s);
  return s;
}

// C, the gradient channel count, is a template parameter: the per-bin
// channel loops unroll and the running sums stay in registers.
template <int C>
__global__ void split_best(const float* __restrict__ hist, const float* __restrict__ feat_mask,
                           const float* __restrict__ params, float* __restrict__ scratch,
                           int T, int m, int d, int B, int warps, int ft) {
  constexpr int c = C;
  extern __shared__ float sm[];  // per warp: [c + 1][ft][B + 1]
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.y * warps + warp;
  if (s >= m) return;  // whole warps leave; no block barrier follows
  const int pitch = B + 1;  // padded: lane j reads row j without bank conflicts
  const int C1 = c + 1;
  float* sh = sm + (size_t)warp * C1 * ft * pitch;
  const float lam = params[4 * t], mcw = params[4 * t + 2];
  const long long dB = (long long)d * B;
  const float* G = hist + ((long long)t * m + s) * C1 * dB;  // [C1][d][B]
  float GT[C], gl[C], gr[C], bgl[C];
  float HT = 0.0f, parent = 0.0f;
  float best = -INFINITY, bhl = 0.0f;
  int bi = 0x7fffffff;
  for (int f0 = 0; f0 < d; f0 += ft) {
    const int nf = min(ft, d - f0);
    __syncwarp();
    for (int i = lane; i < nf * B; i += 32) {  // coalesced tile load
      const int r = i / B, b = i % B;
#pragma unroll
      for (int ch = 0; ch <= C; ++ch)
        sh[(ch * ft + r) * pitch + b] = G[ch * dB + (long long)f0 * B + i];
    }
    __syncwarp();
    if (f0 == 0) {  // node totals: feature 0's bins, in bin order
      if (lane == 0) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) GT[ch] = row_sum(sh + ch * ft * pitch, B);
        HT = row_sum(sh + c * ft * pitch, B);
      }
#pragma unroll
      for (int ch = 0; ch < C; ++ch) GT[ch] = __shfl_sync(0xffffffffu, GT[ch], 0);
      HT = __shfl_sync(0xffffffffu, HT, 0);
      parent = __fdiv_rn(sum_sq<C>(GT), __fadd_rn(HT, lam));
    }
    if (lane < nf) {
      const int j = f0 + lane;
      const float fm = feat_mask[(long long)t * d + j];
      const float* hj = sh + (c * ft + lane) * pitch;
      float hl = 0.0f;
      for (int b = 0; b < B; ++b) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) {
          const float g = sh[(ch * ft + lane) * pitch + b];
          gl[ch] = b == 0 ? g : __fadd_rn(gl[ch], g);
          gr[ch] = __fsub_rn(GT[ch], gl[ch]);
        }
        hl = b == 0 ? hj[0] : __fadd_rn(hl, hj[b]);
        const float hr = __fsub_rn(HT, hl);
        const float sl = __fdiv_rn(sum_sq<C>(gl), __fadd_rn(hl, lam));
        const float sr = __fdiv_rn(sum_sq<C>(gr), __fadd_rn(hr, lam));
        const float gain = __fsub_rn(__fadd_rn(sl, sr), parent);
        const bool valid = hl >= mcw && hr >= mcw && fm > 0.0f && b < B - 1;
        const float v = valid ? gain : -INFINITY;
        const int idx = j * B + b;
        if (bi == 0x7fffffff || takes(v, idx, best, bi)) {
          best = v;
          bi = idx;
          bhl = hl;
#pragma unroll
          for (int ch = 0; ch < C; ++ch) bgl[ch] = gl[ch];
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const float oh = __shfl_xor_sync(0xffffffffu, bhl, off);
    float og[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) og[ch] = __shfl_xor_sync(0xffffffffu, bgl[ch], off);
    if (oi != 0x7fffffff && (bi == 0x7fffffff || takes(ov, oi, best, bi))) {
      best = ov;
      bi = oi;
      bhl = oh;
#pragma unroll
      for (int ch = 0; ch < C; ++ch) bgl[ch] = og[ch];
    }
  }
  if (lane == 0) {
    const long long o = (long long)t * m + s, plane = (long long)T * m;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      scratch[(kGLb + ch) * plane + o] = bgl[ch];
      scratch[(kGLb + c + ch) * plane + o] = GT[ch];
    }
    scratch[kHLb * plane + o] = bhl;
    scratch[kBest * plane + o] = best;
    scratch[kHT * plane + o] = HT;
    ((int*)scratch)[kIdx * plane + o] = bi;
  }
}

// Any c up to kMaxC: one warp per (tree, slot), the running sums in the
// staged tile (prefix sums in place), candidates a lane a (feature, bin).
__global__ void split_best_wide(const float* __restrict__ hist,
                                const float* __restrict__ feat_mask,
                                const float* __restrict__ params, float* __restrict__ scratch,
                                int T, int m, int c, int d, int B, int warps, int ft) {
  extern __shared__ float sm[];  // per warp: [c + 1][ft][B + 1], then GT[c]
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.y * warps + warp;
  if (s >= m) return;  // whole warps leave; no block barrier follows
  const int pitch = B + 1;
  const int C1 = c + 1;
  const size_t tile = (size_t)C1 * ft * pitch;
  float* sh = sm + (size_t)warp * (tile + c);
  float* GT = sh + tile;
  const float lam = params[4 * t], mcw = params[4 * t + 2];
  const long long dB = (long long)d * B;
  const float* G = hist + ((long long)t * m + s) * C1 * dB;  // [C1][d][B]
  float HT = 0.0f, parent = 0.0f;
  float best = -INFINITY, bhl = 0.0f;
  int bi = 0x7fffffff;
  for (int f0 = 0; f0 < d; f0 += ft) {
    const int nf = min(ft, d - f0);
    __syncwarp();
    for (int ch = 0; ch < C1; ++ch)  // coalesced tile load
      for (int i = lane; i < nf * B; i += 32)
        sh[(ch * ft + i / B) * pitch + i % B] = G[ch * dB + (long long)f0 * B + i];
    __syncwarp();
    for (int row = lane; row < C1 * nf; row += 32) {  // prefix sums, bin order
      float* rr = sh + ((row / nf) * ft + row % nf) * pitch;
      float a = rr[0];
      for (int b = 1; b < B; ++b) {
        a = __fadd_rn(a, rr[b]);
        rr[b] = a;
      }
    }
    __syncwarp();
    if (f0 == 0) {  // node totals: feature 0's last prefix, as row_sum
      for (int ch = lane; ch < c; ch += 32) GT[ch] = sh[(ch * ft) * pitch + B - 1];
      HT = sh[(c * ft) * pitch + B - 1];
      __syncwarp();
      float sq = __fmul_rn(GT[0], GT[0]);
      for (int ch = 1; ch < c; ++ch) sq = __fmaf_rn(GT[ch], GT[ch], sq);
      parent = __fdiv_rn(sq, __fadd_rn(HT, lam));
    }
    for (int q = lane; q < nf * B; q += 32) {
      const int r = q / B, b = q % B;
      const int j = f0 + r;
      const float* col = sh + r * pitch + b;  // channel ch at col[ch * ft * pitch]
      const int cs = ft * pitch;
      const float hl = col[c * cs];
      const float hr = __fsub_rn(HT, hl);
      float gl = col[0], gr = __fsub_rn(GT[0], gl);
      float ql = __fmul_rn(gl, gl), qr = __fmul_rn(gr, gr);
      for (int ch = 1; ch < c; ++ch) {
        gl = col[ch * cs];
        gr = __fsub_rn(GT[ch], gl);
        ql = __fmaf_rn(gl, gl, ql);
        qr = __fmaf_rn(gr, gr, qr);
      }
      const float sl = __fdiv_rn(ql, __fadd_rn(hl, lam));
      const float sr = __fdiv_rn(qr, __fadd_rn(hr, lam));
      const float gain = __fsub_rn(__fadd_rn(sl, sr), parent);
      const bool valid = hl >= mcw && hr >= mcw && feat_mask[(long long)t * d + j] > 0.0f &&
                         b < B - 1;
      const float v = valid ? gain : -INFINITY;
      const int idx = j * B + b;
      if (bi == 0x7fffffff || takes(v, idx, best, bi)) {
        best = v;
        bi = idx;
        bhl = hl;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const float oh = __shfl_xor_sync(0xffffffffu, bhl, off);
    if (oi != 0x7fffffff && (bi == 0x7fffffff || takes(ov, oi, best, bi))) {
      best = ov;
      bi = oi;
      bhl = oh;
    }
  }
  const long long o = (long long)t * m + s, plane = (long long)T * m;
  const int bj = bi / B, bb = bi % B;
  for (int ch = lane; ch < c; ch += 32) {  // GL at the winner, summed again in bin order
    const float* row = G + ch * dB + (long long)bj * B;
    float a = row[0];
    for (int b = 1; b <= bb; ++b) a = __fadd_rn(a, row[b]);
    scratch[(kGLb + ch) * plane + o] = a;
    scratch[(kGLb + c + ch) * plane + o] = GT[ch];
  }
  if (lane == 0) {
    scratch[kHLb * plane + o] = bhl;
    scratch[kBest * plane + o] = best;
    scratch[kHT * plane + o] = HT;
    ((int*)scratch)[kIdx * plane + o] = bi;
  }
}

template <int C>
__global__ void split_commit(const float* __restrict__ scratch,
                             const float* __restrict__ params,
                             const int32_t* __restrict__ n_active, int32_t* __restrict__ n_next,
                             int32_t* __restrict__ nodes, float* __restrict__ leaf,
                             int32_t* __restrict__ split, int32_t* __restrict__ pair_parent,
                             int32_t* __restrict__ pair_light, int T, int m, int B, int P,
                             int slot_base, int next_free, int next_cap, int flags, int c_rt) {
  const int c = C > 0 ? C : c_rt;  // C = 0: the wide path's runtime channel count
  extern __shared__ float sm[];
  float* bg = sm;                          // best gain per slot
  float* hlb = bg + m;                     // HL at the best split
  float* ht = hlb + m;                     // node totals
  int* bidx = (int*)(ht + m);              // flat best index j * B + b
  int* dos = bidx + m;                     // do_split
  int* kk = dos + m;                       // cumsum of do_split
  const int t = blockIdx.x;
  const float lam = params[4 * t], gamma = params[4 * t + 1], mig = params[4 * t + 3];
  const int cap_mode = flags & 3;
  const bool root = (flags & 4) != 0;
  const int active = n_active[t];
  const long long plane = (long long)T * m;
  for (int s = threadIdx.x; s < m; s += kThreads) {
    const long long o = (long long)t * m + s;
    bg[s] = scratch[kBest * plane + o];
    hlb[s] = scratch[kHLb * plane + o];
    ht[s] = scratch[kHT * plane + o];
    bidx[s] = ((const int*)scratch)[kIdx * plane + o];
    const float g = bg[s];
    dos[s] = (g > gamma) && (g >= __fmul_rn(mig, ht[s])) && (s < active);
  }
  __syncthreads();
  const int half = next_cap / 2;
  if (cap_mode == 2) {
    // stable rank of key = do ? -gain : +inf; keep ranks below half
    for (int s = threadIdx.x; s < m; s += kThreads) {
      const float ks = dos[s] ? -bg[s] : INFINITY;
      int rank = 0;
      for (int q = 0; q < m; ++q) {
        const float kq = dos[q] ? -bg[q] : INFINITY;
        rank += (kq < ks) || (kq == ks && q < s);
      }
      kk[s] = rank < half;  // rank kept aside: dos is read by other threads
    }
    __syncthreads();
    for (int s = threadIdx.x; s < m; s += kThreads) dos[s] = dos[s] && kk[s];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int s = 0; s < m; ++s) {
      acc += dos[s];
      kk[s] = acc;
    }
    if (cap_mode == 1) {
      for (int s = 0; s < m; ++s) {
        if (kk[s] > half) {
          dos[s] = 0;
          kk[s] = half;
        }
      }
    }
  }
  __syncthreads();

  const long long pool = (long long)t * P;
  int4* nd = (int4*)nodes;
  for (int q = threadIdx.x; q < next_cap; q += kThreads) {
    nd[pool + next_free + q] = make_int4(-1, 0, 0, 0);
#pragma unroll
    for (int ch = 0; ch < c; ++ch) leaf[(pool + next_free + q) * c + ch] = 0.0f;
  }
  for (int q = threadIdx.x; q < half; q += kThreads) {
    pair_parent[(long long)t * half + q] = -1;
    pair_light[(long long)t * half + q] = 0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < m; s += kThreads) {
    const bool dsp = dos[s] != 0;
    const int bf = bidx[s] / B, bb = bidx[s] % B;
    const int child = (kk[s] - 1) * 2;
    const int lp = next_free + child;
    nd[pool + slot_base + s] =
        dsp ? make_int4(bf, bb, lp, lp + 1) : make_int4(-1, 0, 0, 0);
    ((int4*)split)[(long long)t * m + s] = make_int4(dsp ? bf : -1, bb, child, 0);
    if (dsp) {
      const long long o = (long long)t * m + s;
      const float hrb = __fsub_rn(ht[s], hlb[s]);
#pragma unroll
      for (int ch = 0; ch < c; ++ch) {
        const float glb = scratch[(kGLb + ch) * plane + o];
        const float grb = __fsub_rn(scratch[(kGLb + c + ch) * plane + o], glb);
        leaf[(pool + lp) * c + ch] = __fdiv_rn(-glb, __fadd_rn(hlb[s], lam));
        leaf[(pool + lp + 1) * c + ch] = __fdiv_rn(-grb, __fadd_rn(hrb, lam));
      }
      pair_parent[(long long)t * half + child / 2] = s;
      pair_light[(long long)t * half + child / 2] = hlb[s] <= hrb;
    }
  }
  if (threadIdx.x == 0) {
    if (root) {
      const long long o = (long long)t * m;
#pragma unroll
      for (int ch = 0; ch < c; ++ch)
        leaf[pool * c + ch] = __fdiv_rn(-scratch[(kGLb + c + ch) * plane + o],
                                        __fadd_rn(ht[0], lam));
    }
    n_next[t] = 2 * kk[m - 1];
  }
}

// Both entry points at C gradient channels (C = 0: the wide path at c).
template <int C>
int run(cudaStream_t st, size_t smem, int warps, int ft, const void* hist, const void* feat_mask,
        const void* params, const void* n_active, void* n_next, void* nodes, void* leaf,
        void* split, void* pair_parent, void* pair_light, void* scratch, int T, int m, int c,
        int d, int B, int P, int slot_base, int next_free, int next_cap, int flags) {
  const dim3 grid(T, (m + warps - 1) / warps);
  if constexpr (C > 0) {
    split_best<C><<<grid, warps * 32, smem, st>>>(
        (const float*)hist, (const float*)feat_mask, (const float*)params, (float*)scratch, T,
        m, d, B, warps, ft);
  } else {
    static bool attr_set = false;  // the attribute takes the budget's maximum once
    if (!attr_set) {
      const cudaError_t e = cudaFuncSetAttribute(
          split_best_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, kWideBudget);
      if (e != cudaSuccess) return (int)e;
      attr_set = true;
    }
    split_best_wide<<<grid, warps * 32, smem, st>>>(
        (const float*)hist, (const float*)feat_mask, (const float*)params, (float*)scratch, T,
        m, c, d, B, warps, ft);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_commit<C><<<T, kThreads, (size_t)m * 6 * sizeof(float), st>>>(
      (const float*)scratch, (const float*)params, (const int32_t*)n_active, (int32_t*)n_next,
      (int32_t*)nodes, (float*)leaf, (int32_t*)split, (int32_t*)pair_parent,
      (int32_t*)pair_light, T, m, B, P, slot_base, next_free, next_cap, flags, c);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int split_scan(const void* hist, const void* feat_mask, const void* params,
                          const void* n_active, void* n_next, void* nodes, void* leaf,
                          void* split, void* pair_parent, void* pair_light, void* scratch,
                          int T, int m, int c, int d, int B, int P, int slot_base,
                          int next_free, int next_cap, int flags, void* stream) {
  if (T <= 0 || m <= 0 || m > 1024 || next_cap <= 0 || B <= 0 || c < 1 || c > kMaxC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (c > kMaxNarrow) {
    // a warp stages ft features (the most that fit kWideWarpBytes, at least
    // one) and GT; as many warps (up to kWarps) as fit kWideBudget
    const size_t per_feat = (size_t)(c + 1) * (B + 1) * sizeof(float);
    int ft = (int)(kWideWarpBytes / per_feat);
    ft = ft < 1 ? 1 : (ft > 32 ? 32 : ft);
    const size_t per_warp = ft * per_feat + (size_t)c * sizeof(float);
    int warps = (int)(kWideBudget / per_warp);
    if (warps > kWarps) warps = kWarps;
    if (warps < 1) return (int)cudaErrorInvalidValue;
    return run<0>(st, warps * per_warp, warps, ft, hist, feat_mask, params, n_active, n_next,
                  nodes, leaf, split, pair_parent, pair_light, scratch, T, m, c, d, B, P,
                  slot_base, next_free, next_cap, flags);
  }
  // a warp stages ft features of all c + 1 channels: 32 features with as
  // many warps as fit the budget, else one warp and fewer features
  const size_t per_feat = (size_t)(c + 1) * (B + 1) * sizeof(float);
  int warps = (int)(kSmemBudget / (32 * per_feat));
  int ft = 32;
  if (warps > kWarps) warps = kWarps;
  if (warps < 1) {
    warps = 1;
    ft = (int)(kSmemBudget / per_feat);
    if (ft < 1) return (int)cudaErrorInvalidValue;
  }
  const size_t smem = warps * ft * per_feat;
#define SPLIT_SCAN_RUN(C)                                                                  \
  case C:                                                                                  \
    return run<C>(st, smem, warps, ft, hist, feat_mask, params, n_active, n_next, nodes, leaf, \
                  split, pair_parent, pair_light, scratch, T, m, c, d, B, P, slot_base,        \
                  next_free, next_cap, flags);
  switch (c) {
    SPLIT_SCAN_RUN(1) SPLIT_SCAN_RUN(2) SPLIT_SCAN_RUN(3) SPLIT_SCAN_RUN(4)
    SPLIT_SCAN_RUN(5) SPLIT_SCAN_RUN(6) SPLIT_SCAN_RUN(7) SPLIT_SCAN_RUN(8)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SPLIT_SCAN_RUN
}
