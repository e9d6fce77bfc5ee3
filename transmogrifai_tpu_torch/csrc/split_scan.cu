// K-F split_scan: one level's split choice, compaction and node records.
//
// Replaces: transmogrifai_tpu/ops/trees.py::_grow_level, the split scan and
// the compaction (:449-523): per frontier slot, bin prefix sums of G and H,
// the XGBoost gain  GL^2/(HL+l) + GR^2/(HR+l) - GT^2/(HT+l)  with GR = GT - GL
// and the node totals GT, HT from feature 0's bins, the masks (min child
// weight on both sides, feature mask, last bin), the first argmax over the
// feature-major d*B axis, the gates gain > gamma and gain >= mig * HT; then,
// per tree, the beam cap (stable gain rank) or the count clamp, the cumsum
// that packs the children, the slot records, the children's leaf values
// -G/(H+l), and the sibling pairs of the next level (parent slot and
// whether the light child, HL <= HR, is the left one).
//
// Design: two entry points.  split_best: one warp per (tree, slot), many
// blocks; the warp stages the slot's histogram in shared memory (32
// features at a time, padded rows), each lane runs one feature's prefix sums
// bin by bin (the order of the reference's cumsum) and keeps its first
// best, and a shuffle reduction with an index tie-break gives the slot's
// first argmax, written to a scratch array.  split_commit: one block per
// tree, one thread per slot for the gates, the rank and the records, the
// cumsum in one thread.  Every operation is rounded as written (no FMA
// contraction), so the kernel and its plain version agree bit for bit on
// one histogram.
//
// Bound on the card: bytes (the histograms read once, T x m x 2 x d x B
// floats); the ~14 operations per candidate split are below it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Should (vb, ib) replace (va, ia) in a first-argmax where NaN is largest?
__device__ __forceinline__ bool takes(float vb, int ib, float va, int ia) {
  const bool nb = isnan(vb), na = isnan(va);
  if (nb != na) return nb;
  if (nb) return ib < ia;
  if (vb != va) return vb > va;
  return ib < ia;
}

// scratch rows: best gain, GL and HL at the best split, node totals GT and
// HT, and the flat best index j * B + b (an int) -- each [T, m]
enum { kBest = 0, kGLb, kHLb, kGT, kHT, kIdx, kRows };

__global__ void split_best(const float* __restrict__ hist, const float* __restrict__ feat_mask,
                           const float* __restrict__ params, float* __restrict__ scratch,
                           int T, int m, int d, int B, int warps) {
  extern __shared__ float sm[];  // per warp: [2][32][B + 1]
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.y * warps + warp;
  if (s >= m) return;  // whole warps leave; no block barrier follows
  const int pitch = B + 1;  // padded: lane j reads row j without bank conflicts
  float* shg = sm + (size_t)warp * 2 * 32 * pitch;
  float* shh = shg + 32 * pitch;
  const float lam = params[4 * t], mcw = params[4 * t + 2];
  const long long dB = (long long)d * B;
  const float* G = hist + ((long long)t * m + s) * 2 * dB;
  const float* H = G + dB;
  float GT = 0.0f, HT = 0.0f, parent = 0.0f;
  float best = -INFINITY, bgl = 0.0f, bhl = 0.0f;
  int bi = 0x7fffffff;
  for (int f0 = 0; f0 < d; f0 += 32) {
    const int nf = min(32, d - f0);
    __syncwarp();
    for (int i = lane; i < nf * B; i += 32) {  // coalesced tile load
      shg[(i / B) * pitch + i % B] = G[(long long)f0 * B + i];
      shh[(i / B) * pitch + i % B] = H[(long long)f0 * B + i];
    }
    __syncwarp();
    if (f0 == 0) {  // node totals: feature 0's bins, in bin order
      if (lane == 0) {
        GT = shg[0];
        HT = shh[0];
        for (int b = 1; b < B; ++b) {
          GT = __fadd_rn(GT, shg[b]);
          HT = __fadd_rn(HT, shh[b]);
        }
      }
      GT = __shfl_sync(0xffffffffu, GT, 0);
      HT = __shfl_sync(0xffffffffu, HT, 0);
      parent = __fdiv_rn(__fmul_rn(GT, GT), __fadd_rn(HT, lam));
    }
    if (lane < nf) {
      const int j = f0 + lane;
      const float fm = feat_mask[(long long)t * d + j];
      const float* gj = shg + lane * pitch;
      const float* hj = shh + lane * pitch;
      float gl = 0.0f, hl = 0.0f;
      for (int b = 0; b < B; ++b) {
        gl = b == 0 ? gj[0] : __fadd_rn(gl, gj[b]);
        hl = b == 0 ? hj[0] : __fadd_rn(hl, hj[b]);
        const float gr = __fsub_rn(GT, gl), hr = __fsub_rn(HT, hl);
        const float sl = __fdiv_rn(__fmul_rn(gl, gl), __fadd_rn(hl, lam));
        const float sr = __fdiv_rn(__fmul_rn(gr, gr), __fadd_rn(hr, lam));
        const float gain = __fsub_rn(__fadd_rn(sl, sr), parent);
        const bool valid = hl >= mcw && hr >= mcw && fm > 0.0f && b < B - 1;
        const float v = valid ? gain : -INFINITY;
        const int idx = j * B + b;
        if (bi == 0x7fffffff || takes(v, idx, best, bi)) {
          best = v;
          bi = idx;
          bgl = gl;
          bhl = hl;
        }
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    const float og = __shfl_xor_sync(0xffffffffu, bgl, off);
    const float oh = __shfl_xor_sync(0xffffffffu, bhl, off);
    if (oi != 0x7fffffff && (bi == 0x7fffffff || takes(ov, oi, best, bi))) {
      best = ov;
      bi = oi;
      bgl = og;
      bhl = oh;
    }
  }
  if (lane == 0) {
    const long long o = (long long)t * m + s, plane = (long long)T * m;
    scratch[kBest * plane + o] = best;
    scratch[kGLb * plane + o] = bgl;
    scratch[kHLb * plane + o] = bhl;
    scratch[kGT * plane + o] = GT;
    scratch[kHT * plane + o] = HT;
    ((int*)scratch)[kIdx * plane + o] = bi;
  }
}

__global__ void split_commit(const float* __restrict__ scratch,
                             const float* __restrict__ params,
                             const int32_t* __restrict__ n_active, int32_t* __restrict__ n_next,
                             int32_t* __restrict__ nodes, float* __restrict__ leaf,
                             int32_t* __restrict__ split, int32_t* __restrict__ pair_parent,
                             int32_t* __restrict__ pair_light, int T, int m, int B, int P,
                             int slot_base, int next_free, int next_cap, int flags) {
  extern __shared__ float sm[];
  float* bg = sm;                          // best gain per slot
  float* glb = bg + m;                     // GL at the best split
  float* hlb = glb + m;                    // HL at the best split
  float* gt = hlb + m;                     // node totals
  float* ht = gt + m;
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
    glb[s] = scratch[kGLb * plane + o];
    hlb[s] = scratch[kHLb * plane + o];
    gt[s] = scratch[kGT * plane + o];
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
    leaf[pool + next_free + q] = 0.0f;
    nd[pool + next_free + q] = make_int4(-1, 0, 0, 0);
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
      const float grb = __fsub_rn(gt[s], glb[s]);
      const float hrb = __fsub_rn(ht[s], hlb[s]);
      leaf[pool + lp] = __fdiv_rn(-glb[s], __fadd_rn(hlb[s], lam));
      leaf[pool + lp + 1] = __fdiv_rn(-grb, __fadd_rn(hrb, lam));
      pair_parent[(long long)t * half + child / 2] = s;
      pair_light[(long long)t * half + child / 2] = hlb[s] <= hrb;
    }
  }
  if (threadIdx.x == 0) {
    if (root) leaf[pool] = __fdiv_rn(-gt[0], __fadd_rn(ht[0], lam));
    n_next[t] = 2 * kk[m - 1];
  }
}

}  // namespace

extern "C" int split_scan(const void* hist, const void* feat_mask, const void* params,
                          const void* n_active, void* n_next, void* nodes, void* leaf,
                          void* split, void* pair_parent, void* pair_light, void* scratch,
                          int T, int m, int d, int B, int P, int slot_base, int next_free,
                          int next_cap, int flags, void* stream) {
  if (T <= 0 || m <= 0 || m > 1024 || next_cap <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t per_warp = (size_t)2 * 32 * (B + 1) * sizeof(float);
  int warps = (int)((48 * 1024) / per_warp);
  if (warps > kWarps) warps = kWarps;
  if (warps < 1) return (int)cudaErrorInvalidValue;
  dim3 grid(T, (m + warps - 1) / warps);
  split_best<<<grid, warps * 32, warps * per_warp, st>>>(
      (const float*)hist, (const float*)feat_mask, (const float*)params, (float*)scratch, T, m,
      d, B, warps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_commit<<<T, kThreads, (size_t)m * 8 * sizeof(float), st>>>(
      (const float*)scratch, (const float*)params, (const int32_t*)n_active, (int32_t*)n_next,
      (int32_t*)nodes, (float*)leaf, (int32_t*)split, (int32_t*)pair_parent,
      (int32_t*)pair_light, T, m, B, P, slot_base, next_free, next_cap, flags);
  return (int)cudaGetLastError();
}
