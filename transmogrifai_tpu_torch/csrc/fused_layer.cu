// K-Z numeric_op and column_gather: the fused layer's numeric arithmetic
// and its column gathers.
//
// numeric_op replaces the device half of transmogrifai_tpu/impl/feature/
// transformers.py::_NumericBinaryOp.jax_transform (:76), a + b, a - b,
// a * b or a / b of two numeric columns with their presence masks, and
// ::ScalarMathTransformer.jax_transform (:156), a column <op> a scalar.
// The masks follow the reference: for + and - the present side wins and
// the output is present when either input is; for the other operations
// the output is present when every input is and the value is finite; an
// absent output holds 0.  One thread a row, every operation in float32
// with round-to-nearest intrinsics (no contraction into a fused
// multiply-add), as the plain version's separate torch ops round.
//
// column_gather replaces ::VectorsCombiner.jax_transform (vectorizers.py:457),
// the concatenation of a layer's vectors, and transmogrifai_tpu/impl/
// preparators/sanity_checker.py::SanityCheckerModel.jax_transform (:507),
// the gather of the columns the checker keeps: out f32[n, W] with output
// column j read from column col[j] of source src[j].  Up to 64 sources a
// launch, their pointers and row strides passed by value; the column map
// i32[2, W] lies on the card.  A block takes 32 output columns (a warp
// writes them contiguously) and 256 rows over 8 row lanes.
//
// Both are copies or one arithmetic operation a value: bound on the card by
// bytes (each input read once, each output written once).  These two and
// K-C / K-D are what the JAX package's fused-layer program
// (workflow/dag.py:100-160) and streamed chunk program
// (workflow/stream.py:405-440) compute on the Titanic flow: the port runs
// them one launch a stage over the whole layer, not fused in chunks.
//
// numeric_scale (K-AC) replaces the scalers' device programs, one value a
// thread: FillMissingWithMeanModel.jax_transform (transformers.py:310),
// OpScalarStandardScalerModel's (scalers.py:64), ScalerTransformer's (:109,
// linear and log), DescalerTransformer's (:146, linear and exp) and
// PercentileCalibratorModel's (:187, a right-sided binary search of the
// float32 splits, staged in shared memory; NaN above every split, as XLA's
// sort order puts it).  The arithmetic rounds as XLA's CPU code compiles the
// JAX programs: slope * v + intercept is one fused multiply-add, and a
// division by a fitted constant is a product with its float32 reciprocal,
// passed in by the wrapper.
//
// column_affine (K-AD) replaces StandardScalerModel.jax_transform
// (vectorizers.py:541): (x - mean_j) * rcp_j over f32[n, d], the two
// vectors staged in shared memory (read from global memory past 4,096
// columns), a value a thread over a grid-stride loop.
//
// Both are bound by bytes: each input read once, each output written once.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the order of ops/layer.py::NUMERIC_OPS
enum Op {
  kPlus = 0, kMinus, kMultiply, kDivide, kPower, kAbs, kLog, kExp, kSqrt, kRMinus, kRDivide,
  kCeil, kFloor, kRound, kNumOps
};

constexpr int kMaxSources = 64;
constexpr int kTileCols = 32;
constexpr int kLanes = 8;
constexpr int kBlockRows = 256;

// v ** s as torch's pow with a scalar exponent computes it: the exponents
// 2, 3, 0.5, -0.5, -1 and -2 by products, square roots and quotients
__device__ __forceinline__ float scalar_pow(float v, float s) {
  if (s == 2.0f) return __fmul_rn(v, v);
  if (s == 3.0f) return __fmul_rn(__fmul_rn(v, v), v);
  if (s == 0.5f) return __fsqrt_rn(v);
  if (s == -0.5f) return __fdiv_rn(1.0f, __fsqrt_rn(v));
  if (s == -1.0f) return __fdiv_rn(1.0f, v);
  if (s == -2.0f) return __fdiv_rn(1.0f, __fmul_rn(v, v));
  return powf(v, s);
}

__device__ __forceinline__ float scalar_op(int op, float v, float s, float scale) {
  switch (op) {
    case kPlus: return __fadd_rn(v, s);
    case kMinus: return __fsub_rn(v, s);
    case kMultiply: return __fmul_rn(v, s);
    case kDivide: return __fdiv_rn(v, s);
    case kPower: return scalar_pow(v, s);
    case kAbs: return fabsf(v);
    case kLog: return logf(v);
    case kExp: return expf(v);
    case kSqrt: return __fsqrt_rn(v);
    case kRMinus: return __fsub_rn(s, v);
    case kRDivide: return __fdiv_rn(s, v);
    case kCeil: return ceilf(v);
    case kFloor: return floorf(v);
    default:  // kRound: half up at 10^s, floor(v * 10^s + 0.5) / 10^s
      return __fdiv_rn(floorf(__fadd_rn(__fmul_rn(v, scale), 0.5f)), scale);
  }
}

__device__ __forceinline__ float binary_op(int op, float a, float b) {
  switch (op) {
    case kPlus: return __fadd_rn(a, b);
    case kMinus: return __fsub_rn(a, b);
    case kMultiply: return __fmul_rn(a, b);
    default: return __fdiv_rn(a, b);
  }
}

// bv == nullptr: the scalar form
__global__ void numeric_op_kernel(const float* __restrict__ av, const uint8_t* __restrict__ am,
                                  const float* __restrict__ bv, const uint8_t* __restrict__ bm,
                                  float* __restrict__ vals, uint8_t* __restrict__ mask,
                                  long long n, int op, float s, float scale) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const float a = av[i];
    const bool pa = am[i] != 0;
    float v;
    bool present;
    if (bv == nullptr) {
      v = scalar_op(op, a, s, scale);
      present = pa && isfinite(v);
    } else {
      const float b = bv[i];
      const bool pb = bm[i] != 0;
      v = binary_op(op, a, b);
      if (op == kPlus || op == kMinus) {
        if (pa && !pb) v = a;
        if (pb && !pa) v = op == kPlus ? b : -b;
        present = pa || pb;
      } else {
        present = pa && pb && isfinite(v);
      }
    }
    vals[i] = present ? v : 0.0f;
    mask[i] = present;
  }
}

struct Sources {
  const float* ptr[kMaxSources];
  long long stride[kMaxSources];
};

__global__ void column_gather_kernel(Sources sources, int n_sources,
                                     const int32_t* __restrict__ map, float* __restrict__ out,
                                     long long n, int W) {
  const int j = blockIdx.y * kTileCols + threadIdx.x;
  if (j >= W) return;
  const int s = map[j];
  const long long c = map[W + j];
  // the source by constant indices: a dynamic index into the parameter
  // struct would copy it to local memory
  const float* p = nullptr;
  long long stride = 0;
#pragma unroll
  for (int k = 0; k < kMaxSources; ++k) {
    if (k < n_sources && k == s) {
      p = sources.ptr[k];
      stride = sources.stride[k];
    }
  }
  const long long r0 = (long long)blockIdx.x * kBlockRows;
  const long long r1 = min(n, r0 + kBlockRows);
  for (long long r = r0 + threadIdx.y; r < r1; r += kLanes) out[r * W + j] = p[r * stride + c];
}

// the order of ops/layer.py::SCALE_MODES
enum ScaleMode { kFill = 0, kStandardize, kScaleLinear, kScaleLog, kDescaleLinear, kDescaleExp,
                 kBucket, kNumModes };
constexpr int kMaxSplits = 1023;
constexpr int kAffineShared = 4096;

__global__ void numeric_scale_kernel(const float* __restrict__ v, const uint8_t* __restrict__ m,
                                     const float* __restrict__ splits, float* __restrict__ vals,
                                     uint8_t* __restrict__ mask, long long n, int mode, float a,
                                     float b, int ns) {
  __shared__ float sp[kMaxSplits];
  if (mode == kBucket) {
    for (int i = threadIdx.x; i < ns; i += blockDim.x) sp[i] = splits[i];
    __syncthreads();
  }
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
    const float x = v[i];
    const bool p = m[i] != 0;
    float out;
    bool present = true;
    switch (mode) {
      case kFill:
        out = p ? x : a;
        break;
      case kStandardize:
        out = __fmul_rn(__fsub_rn(p ? x : a, a), b);
        break;
      case kScaleLinear:
        present = p;
        out = __fmaf_rn(a, x, b);
        break;
      case kScaleLog:
        out = logf(x);
        present = p && isfinite(out);
        break;
      case kDescaleLinear:
        present = p;
        out = __fmul_rn(__fsub_rn(x, b), a);
        break;
      case kDescaleExp:
        present = p;
        out = expf(x);
        break;
      default: {  // kBucket: the count of splits <= x
        int lo = 0, hi = ns;
        if (isnan(x)) {
          lo = ns;
        } else {
          while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (sp[mid] <= x)
              lo = mid + 1;
            else
              hi = mid;
          }
        }
        out = (float)lo;
      }
    }
    if (mode != kFill && mode != kStandardize && mode != kBucket && !present) out = 0.0f;
    vals[i] = out;
    mask[i] = present;
  }
}

template <bool SHARED>
__global__ void column_affine_kernel(const float* __restrict__ x, const float* __restrict__ shift,
                                     const float* __restrict__ scale, float* __restrict__ out,
                                     long long n, int d) {
  extern __shared__ float ab[];  // [2][d] when SHARED
  if (SHARED) {
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      ab[j] = shift[j];
      ab[d + j] = scale[j];
    }
    __syncthreads();
  }
  const long long total = n * d;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const int j = (int)(i % d);
    const float s = SHARED ? ab[j] : __ldg(shift + j);
    const float r = SHARED ? ab[d + j] : __ldg(scale + j);
    out[i] = __fmul_rn(__fsub_rn(x[i], s), r);
  }
}

}  // namespace

extern "C" int numeric_op_count() { return kNumOps; }

// K-AC numeric_scale: vals f32[n], mask u8[n] from v f32[n], m u8[n]; a, b
// the mode's float32 constants, splits f32[ns] (bucket mode only)
extern "C" int numeric_scale_f32(const void* v, const void* m, const void* splits, void* vals,
                                 void* mask, long long n, int mode, float a, float b, int ns,
                                 void* stream) {
  if (n < 0 || mode < 0 || mode >= kNumModes || ns < 0 || ns > kMaxSplits ||
      (mode == kBucket && ns > 0 && splits == nullptr))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  numeric_scale_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)v, (const uint8_t*)m, (const float*)splits, (float*)vals, (uint8_t*)mask, n,
      mode, a, b, ns);
  return (int)cudaGetLastError();
}

// K-AD column_affine: out f32[n, d] = (x - shift_j) * scale_j
extern "C" int column_affine_f32(const void* x, const void* shift, const void* scale, void* out,
                                 long long n, int d, void* stream) {
  if (n < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || d == 0) return 0;
  const int threads = 256;
  const long long want = (n * d + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= kAffineShared)
    column_affine_kernel<true><<<blocks, threads, 2 * d * sizeof(float), st>>>(
        (const float*)x, (const float*)shift, (const float*)scale, (float*)out, n, d);
  else
    column_affine_kernel<false><<<blocks, threads, 0, st>>>(
        (const float*)x, (const float*)shift, (const float*)scale, (float*)out, n, d);
  return (int)cudaGetLastError();
}

// K-Z numeric_op: vals f32[n], mask u8[n] from av f32[n], am u8[n] and
// either bv f32[n], bm u8[n] (a binary op) or the scalar (bv null)
extern "C" int numeric_op_f32(const void* av, const void* am, const void* bv, const void* bm,
                              void* vals, void* mask, long long n, int op, double scalar,
                              void* stream) {
  if (n < 0 || op < 0 || op >= kNumOps || (bv != nullptr && op > kDivide))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int threads = 256;
  const long long want = (n + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  // the Python scalar as torch applies it to a float32 column: cast to
  // float32; round's 10^s in float64 first, as the plain version's
  const float scale = (float)pow(10.0, scalar);
  numeric_op_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)av, (const uint8_t*)am, (const float*)bv, (const uint8_t*)bm, (float*)vals,
      (uint8_t*)mask, n, op, (float)scalar, scale);
  return (int)cudaGetLastError();
}

// K-Z column_gather: out f32[n, W] from the n_sources row-major sources
// (host arrays of their device pointers and row strides) by the map
// i32[2, W] on the card (row 0 each column's source, row 1 its column)
extern "C" int column_gather_f32(const void* const* ptrs, const long long* strides,
                                 int n_sources, const void* map, void* out, long long n, int W,
                                 void* stream) {
  if (n < 0 || W < 0 || n_sources < 1 || n_sources > kMaxSources)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || W == 0) return 0;
  Sources src = {};
  for (int k = 0; k < n_sources; ++k) {
    src.ptr[k] = (const float*)ptrs[k];
    src.stride[k] = strides[k];
  }
  dim3 grid((unsigned)((n + kBlockRows - 1) / kBlockRows), (W + kTileCols - 1) / kTileCols);
  column_gather_kernel<<<grid, dim3(kTileCols, kLanes), 0, (cudaStream_t)stream>>>(
      src, n_sources, (const int32_t*)map, (float*)out, n, W);
  return (int)cudaGetLastError();
}

extern "C" int column_gather_max_sources() { return kMaxSources; }
