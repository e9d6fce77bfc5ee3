// K-AF predict_head: the linear families' prediction heads, one launch a head.
//
// Replaces: transmogrifai_tpu/ops/linear.py::predict_binary_logistic (:505),
// predict_softmax (:517) and predict_linear (:525), the programs that
// serve/aot.py::head_program (:53) reaches through predict_program of
// impl/classification/logistic.py:138 and impl/regression/linear.py:94, and
// that BucketScorer._head_call (serve/aot.py:308-380) compiles once per
// (shape, device) as one piece: the product, the link and the stacked
// outputs.  Modes:
//
//   0 binary   z = X w + b[0]; raw = [-z, z]; s = 1 / (1 + exp(-z))
//              (XLA's expansion of jax.nn.sigmoid); prob = [1 - s, s];
//              pred = s >= 0.5;
//   1 softmax  z = X W + b over k <= 128 classes; prob = exp(z - max) /
//              sum (jax.nn.softmax); pred = the first maximum (jnp.argmax);
//              raw = z;
//   2 linear   pred = X w + b[0].
//
// Outputs are float32: pred [n], raw and prob [n, k'] (k' = 2 binary, k
// softmax) in the layout PredictionColumn takes.
//
// Binary and linear (bound: X's bytes), two entries by p alone, so a row's
// answer never depends on the batch it came in.  Up to 32 coefficients
// ("lane groups"): a row on a power of two of lanes that holds its p values
// (all 32 while a warp a row fills no more than the card; else the fewest),
// one product a lane, a butterfly, + b[0]: the sums of a warp a row, bit
// for bit, with 32 / lanes rows a warp and up to four such row sets in
// flight, so a large batch keeps the card's memory busy (a warp a row
// waited a round trip a row) and a small one is one round trip.  (A lane a
// row, its values read by the lane or staged by the warp, lost 0.3-2 us at
// 64-1,024 rows: ten times the sector requests, or the staging.)
// Past 32 ("quarters"): a row's p coefficients are ceil(p / 4) chunks of 4,
// cut into four quarters of ceil(chunks / 4); lane l of a quarter takes its
// chunks l, l + 32, ... in turn into one float32 FMA chain, each quarter is
// summed by a butterfly over the lanes, and z = (((q0 + q1) + q2) + q3) +
// b[0].  That order is fixed, so a row's answer does not depend on how the
// launch is cut: ``head_plan`` gives a row 1, 2 or 4 warps (4, 2 or 1
// quarters each; past one warp the quarters meet in shared memory) so that a
// small batch still spreads over the card, 8 / S rows a block, the blocks at
// most 8 an SM and grid-strided past that.  A lane keeps 8 chunk loads in
// flight: 16-byte loads where X and w are 16-byte aligned and p % 4 == 0,
// else the same chunks by 4-byte loads (the same sums: the answer does not
// depend on the alignment either).  The first chunks are issued before the
// block stages w (up to 4,096 coefficients; past that w is read through the
// cache).
// Softmax: a warp a row, rows grid-strided.  Lane l owns classes l, l + 32,
// l + 64 and l + 96; the weights [p, k] pass through shared memory in slabs
// of 32 coefficient rows (16 KB at 128 classes), the row's 32 values of a
// slab are loaded one a lane and broadcast by shuffle, and the maximum, the
// exponential sum and the first arg-max are warp reductions.  Bound on the
// card: bytes at every serve shape (X read once, n (1 + 2k') floats
// written; 2 n p k operations).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlab = 32;
constexpr int kMaxClasses = 128;
constexpr int kPerLane = kMaxClasses / 32;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kQuarters = 4;
constexpr int kNarrowMax = 32;    // the lane groups' coefficients, at most
constexpr int kGroupBatches = 4;  // the lane groups' row sets in flight a warp, at most
constexpr int kBatch = 8;         // the quarters' chunk loads in flight a lane
constexpr int kStage = 4096;      // coefficients staged in shared memory, at most

// the link of a dot head's row r: binary (raw, prob, pred) or linear (pred)
__device__ __forceinline__ void dot_link(float z, long long r, int binary,
                                         float* __restrict__ pred, float* __restrict__ raw,
                                         float* __restrict__ prob) {
  if (binary) {
    const float sg = 1.0f / (1.0f + expf(-z));
    raw[2 * r] = -z;
    raw[2 * r + 1] = z;
    prob[2 * r] = 1.0f - sg;
    prob[2 * r + 1] = sg;
    pred[r] = sg >= 0.5f ? 1.0f : 0.0f;
  } else {
    pred[r] = z;
  }
}

// Binary and linear heads up to kNarrowMax coefficients: a row on L lanes
// (a power of two at or above p), lane j of its group multiplying value j
// by coefficient j (one FMA onto 0), a butterfly over the group, + b[0]; a
// warp takes 32 / L rows at a time and B (1 or kGroupBatches) such row sets
// at once.  The lanes past p hold +0, so the sums are those of a warp a
// row.  (B is a template argument: the one-set body, a warp a row's (L =
// 32) at small batches, stays as short as the code a cold launch fetches;
// fewer lanes a row always take kGroupBatches sets.)
template <int L, int B>
__global__ void __launch_bounds__(kThreads)
group_head_kernel(const float* __restrict__ X, const float* __restrict__ w,
                  const float* __restrict__ b, float* __restrict__ pred,
                  float* __restrict__ raw, float* __restrict__ prob, long long n, int p,
                  int binary) {
  constexpr int G = 32 / L;  // rows a warp at a time
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sub = lane / L, j = lane % L;
  const float wj = j < p ? __ldg(w + j) : 0.f;
  const float b0 = __ldg(b);
  const long long stride = (long long)gridDim.x * kWarps * G * B;
  for (long long r0 = ((long long)blockIdx.x * kWarps + warp) * G * B; r0 < n; r0 += stride) {
    float x[B];
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const long long r = r0 + u * G + sub;
      x[u] = (r < n && j < p) ? __ldg(X + r * p + j) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      float acc = fmaf(x[u], wj, 0.f);
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const long long r = r0 + u * G + sub;
      if (j == 0 && r < n) dot_link(acc + b0, r, binary, pred, raw, prob);
    }
  }
}

// Binary (binary = 1) and linear (binary = 0) heads: one dot product a row,
// S warps a row (the quarters above).  VEC: 16-byte chunk loads.
template <bool VEC, int S>
__global__ void __launch_bounds__(kThreads)
dot_head_kernel(const float* __restrict__ X, const float* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ pred,
                float* __restrict__ raw, float* __restrict__ prob, long long n, int p,
                int binary) {
  constexpr int nq = kQuarters / S;                  // quarters a warp
  constexpr int rows_a_block = kWarps / S;
  static_assert(kBatch % nq == 0, "a batch holds whole turns");
  __shared__ __align__(16) float ws[kStage];
  __shared__ float parts[kWarps][kQuarters];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slot = warp / S, s = warp % S;
  const int C = (p + 3) >> 2, Cq = (C + kQuarters - 1) / kQuarters;
  const int items = ((Cq + 31) >> 5) * nq;           // a lane's (chunk, quarter) turns
  const long long groups = (n + rows_a_block - 1) / rows_a_block;
  const float* wv = p <= kStage ? ws : w;
  const float b0 = __ldg(b);

  // item t: the lane's chunk lane + 32 (t / nq) of quarter s + (t % nq) S,
  // or -1 past the row
  auto chunk_of = [&](int t) -> int {
    const int cl = lane + 32 * (t / nq);
    const int m = (s + (t % nq) * S) * Cq + cl;
    return (t < items && cl < Cq && m < C) ? m : -1;
  };
  auto load = [&](float4* xb, long long r, int t0) {
    const float* x = X + (r < n ? r : 0) * (long long)p;
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int m = r < n ? chunk_of(t0 + u) : -1;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m >= 0) {
        if (VEC) {
          v = __ldg(reinterpret_cast<const float4*>(x) + m);
        } else {
          const int j = 4 * m;
          v.x = __ldg(x + j);
          if (j + 1 < p) v.y = __ldg(x + j + 1);
          if (j + 2 < p) v.z = __ldg(x + j + 2);
          if (j + 3 < p) v.w = __ldg(x + j + 3);
        }
      }
      xb[u] = v;
    }
  };

  float4 xb[kBatch];
  load(xb, (long long)blockIdx.x * rows_a_block + slot, 0);  // before the staging
  if (p <= kStage)
    for (int j = threadIdx.x; j < p; j += kThreads) ws[j] = __ldg(w + j);
  __syncthreads();
  bool loaded = true;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long r = g * rows_a_block + slot;
    float acc[kQuarters] = {0.f, 0.f, 0.f, 0.f};
    for (int t0 = 0; t0 < items; t0 += kBatch) {
      if (!loaded) load(xb, r, t0);
      loaded = false;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int m = r < n ? chunk_of(t0 + u) : -1;
        if (m < 0) continue;
        const int q = u % nq, j = 4 * m;
        float a = acc[q];
        if (VEC) {
          const float4 wq = *reinterpret_cast<const float4*>(wv + j);
          a = fmaf(xb[u].x, wq.x, a);
          a = fmaf(xb[u].y, wq.y, a);
          a = fmaf(xb[u].z, wq.z, a);
          a = fmaf(xb[u].w, wq.w, a);
        } else {
          a = fmaf(xb[u].x, wv[j], a);
          if (j + 1 < p) a = fmaf(xb[u].y, wv[j + 1], a);
          if (j + 2 < p) a = fmaf(xb[u].z, wv[j + 2], a);
          if (j + 3 < p) a = fmaf(xb[u].w, wv[j + 3], a);
        }
        acc[q] = a;
      }
    }
    float quarter[kQuarters];
#pragma unroll
    for (int q = 0; q < kQuarters; ++q) quarter[q] = q < nq ? warp_sum(acc[q]) : 0.f;
    float z = 0.f;
    bool writer = lane == 0;
    if (S == 1) {
      z = quarter[0] + quarter[1] + quarter[2] + quarter[3] + b0;
    } else {
      if (lane == 0)
        for (int q = 0; q < nq; ++q) parts[slot][s + q * S] = quarter[q];
      __syncthreads();
      z = parts[slot][0] + parts[slot][1] + parts[slot][2] + parts[slot][3] + b0;
      __syncthreads();  // parts is free for the next rows
      writer = writer && s == 0;
    }
    if (writer && r < n) dot_link(z, r, binary, pred, raw, prob);
  }
}

// Softmax head over k classes: a block's warps take kWarps rows together,
// walking the weight slabs in step.
__global__ void __launch_bounds__(kThreads)
softmax_head_kernel(const float* __restrict__ X, const float* __restrict__ W,
                    const float* __restrict__ b, float* __restrict__ pred,
                    float* __restrict__ raw, float* __restrict__ prob, long long n, int p,
                    int k) {
  __shared__ float ws[kSlab * kMaxClasses];
  const int lane = threadIdx.x & 31;
  const long long groups = (n + kWarps - 1) / kWarps;
  for (long long g = blockIdx.x; g < groups; g += gridDim.x) {
    const long long r = g * kWarps + (threadIdx.x >> 5);
    const bool live = r < n;
    const float* x = X + (live ? r : 0) * (long long)p;
    float acc[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) acc[j] = 0.f;
    for (int p0 = 0; p0 < p; p0 += kSlab) {
      const int rows = min(kSlab, p - p0);
      __syncthreads();  // every warp is done with the previous slab
      for (int i = threadIdx.x; i < rows * k; i += kThreads) ws[i] = __ldg(W + (long long)p0 * k + i);
      __syncthreads();
      const float xv = (live && lane < rows) ? __ldg(x + p0 + lane) : 0.f;
      for (int q = 0; q < rows; ++q) {
        const float xq = __shfl_sync(0xffffffffu, xv, q);
#pragma unroll
        for (int j = 0; j < kPerLane; ++j) {
          const int c = lane + 32 * j;
          if (c < k) acc[j] = fmaf(xq, ws[q * k + c], acc[j]);
        }
      }
    }
    if (!live) continue;  // uniform over the warp; every warp met the barriers
    float m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < k) {
        acc[j] += __ldg(b + c);
        m = fmaxf(m, acc[j]);
      }
    }
    m = warp_max(m);
    float e[kPerLane];
    float s = 0.f;
    int first = k;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      e[j] = 0.f;
      if (c < k) {
        e[j] = expf(acc[j] - m);
        s += e[j];
        if (acc[j] == m && c < first) first = c;
      }
    }
    s = warp_sum(s);
    first = warp_min(first);
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int c = lane + 32 * j;
      if (c < k) {
        raw[r * k + c] = acc[j];
        prob[r * k + c] = e[j] / s;
      }
    }
    if (lane == 0) pred[r] = (float)first;
  }
}

}  // namespace

extern "C" int predict_head_max_classes() { return kMaxClasses; }

// mode 0 binary, 1 softmax, 2 linear; raw and prob may be null in mode 2;
// from head_plan the entry (0 softmax, 1 lane groups, 2 quarters), its
// split (lanes a row: a power of two at or above p in the lane groups;
// warps a row, 1, 2 or 4, in the quarters; 1 softmax), the lane groups'
// row sets a warp at once (4, or 1 at 32 lanes a row; else 1) and blocks.
extern "C" int predict_head_f32(const void* X, const void* coef, const void* intercept,
                                void* pred, void* raw, void* prob, long long n, int p, int k,
                                int mode, int entry, int split, int batches, int blocks,
                                void* stream) {
  if (n < 0 || p < 0 || mode < 0 || mode > 2 || blocks < 1 ||
      (batches != 1 && (entry != 1 || batches != kGroupBatches)) ||
      (entry == 1 && split < 32 && batches != kGroupBatches))
    return (int)cudaErrorInvalidValue;
  if ((mode == 1) != (entry == 0) || entry < 0 || entry > 2 ||
      (entry == 1 && (p < 1 || p > kNarrowMax || split < p || split > 32 ||
                      (split & (split - 1)) != 0)))
    return (int)cudaErrorInvalidValue;
  if (mode == 1 && (k < 1 || k > kMaxClasses)) return (int)cudaErrorInvalidValue;
  if ((entry == 2 && split != 1 && split != 2 && split != 4) || (entry == 0 && split != 1))
    return (int)cudaErrorInvalidValue;
  if (mode != 2 && (raw == nullptr || prob == nullptr)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 1) {
    softmax_head_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)X, (const float*)coef, (const float*)intercept, (float*)pred,
        (float*)raw, (float*)prob, n, p, k);
    return (int)cudaGetLastError();
  }
  const bool vec = p % 4 == 0 && (uintptr_t)X % 16 == 0 && (uintptr_t)coef % 16 == 0;
  const int binary = mode == 0 ? 1 : 0;
  const float* Xf = (const float*)X;
  const float* w = (const float*)coef;
  const float* b = (const float*)intercept;
  float *pr = (float*)pred, *ra = (float*)raw, *pb = (float*)prob;
  if (entry == 1) {
#define GROUP_HEAD(L, B) \
  group_head_kernel<L, B><<<(unsigned)blocks, kThreads, 0, s>>>(Xf, w, b, pr, ra, pb, n, p, binary)
    switch (split) {
      case 1: GROUP_HEAD(1, kGroupBatches); break;
      case 2: GROUP_HEAD(2, kGroupBatches); break;
      case 4: GROUP_HEAD(4, kGroupBatches); break;
      case 8: GROUP_HEAD(8, kGroupBatches); break;
      case 16: GROUP_HEAD(16, kGroupBatches); break;
      default:
        if (batches == 1) GROUP_HEAD(32, 1); else GROUP_HEAD(32, kGroupBatches);
        break;
    }
#undef GROUP_HEAD
    return (int)cudaGetLastError();
  }
#define DOT_HEAD(V, S) \
  dot_head_kernel<V, S><<<(unsigned)blocks, kThreads, 0, s>>>(Xf, w, b, pr, ra, pb, n, p, binary)
  if (split == 1) {
    if (vec) DOT_HEAD(true, 1); else DOT_HEAD(false, 1);
  } else if (split == 2) {
    if (vec) DOT_HEAD(true, 2); else DOT_HEAD(false, 2);
  } else {
    if (vec) DOT_HEAD(true, 4); else DOT_HEAD(false, 4);
  }
#undef DOT_HEAD
  return (int)cudaGetLastError();
}
