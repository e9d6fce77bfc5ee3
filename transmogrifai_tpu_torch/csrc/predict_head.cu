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
// A warp a row, rows grid-strided.  Binary and linear: the lanes stride
// over the p coefficients with float32 FMAs and a butterfly shuffle sums
// them.  Softmax: lane l owns classes l, l + 32, l + 64 and l + 96; the
// weights [p, k] pass through shared memory in slabs of 32 coefficient rows
// (16 KB at 128 classes), the row's 32 values of a slab are loaded one a
// lane and broadcast by shuffle, and the maximum, the exponential sum and
// the first arg-max are warp reductions.  Bound on the card: bytes at every
// serve shape (X read once, n (1 + 2k') floats written; 2 n p k operations).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSlab = 32;
constexpr int kMaxClasses = 128;
constexpr int kPerLane = kMaxClasses / 32;
constexpr long long kMaxBlocks = 4096;

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

// Binary (binary = 1) and linear (binary = 0) heads: one dot product a row.
__global__ void __launch_bounds__(kThreads)
dot_head_kernel(const float* __restrict__ X, const float* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ pred,
                float* __restrict__ raw, float* __restrict__ prob, long long n, int p,
                int binary) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * kWarps;
  const float b0 = b[0];
  for (long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); r < n; r += stride) {
    const float* x = X + r * p;
    float acc = 0.f;
    for (int j = lane; j < p; j += 32) acc = fmaf(__ldg(x + j), __ldg(w + j), acc);
    const float z = warp_sum(acc) + b0;
    if (lane != 0) continue;
    if (binary) {
      const float s = 1.0f / (1.0f + expf(-z));
      raw[2 * r] = -z;
      raw[2 * r + 1] = z;
      prob[2 * r] = 1.0f - s;
      prob[2 * r + 1] = s;
      pred[r] = s >= 0.5f ? 1.0f : 0.0f;
    } else {
      pred[r] = z;
    }
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

// mode 0 binary, 1 softmax, 2 linear; raw and prob may be null in mode 2.
extern "C" int predict_head_f32(const void* X, const void* coef, const void* intercept,
                                void* pred, void* raw, void* prob, long long n, int p, int k,
                                int mode, void* stream) {
  if (n < 0 || p < 0 || mode < 0 || mode > 2) return (int)cudaErrorInvalidValue;
  if (mode == 1 && (k < 1 || k > kMaxClasses)) return (int)cudaErrorInvalidValue;
  if (mode != 2 && (raw == nullptr || prob == nullptr)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == 1) {
    softmax_head_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)X, (const float*)coef, (const float*)intercept, (float*)pred,
        (float*)raw, (float*)prob, n, p, k);
  } else {
    dot_head_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)X, (const float*)coef, (const float*)intercept, (float*)pred,
        (float*)raw, (float*)prob, n, p, mode == 0 ? 1 : 0);
  }
  return (int)cudaGetLastError();
}
