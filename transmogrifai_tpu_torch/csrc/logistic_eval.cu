// K-AE logistic_grid_error: the masked 0/1 validation error of every (fold,
// candidate) logistic fit of a grid sweep.
//
// Replaces: transmogrifai_tpu/parallel/sweep.py::eval_logistic_grid_folds
// (:77-91), which vmaps over folds and candidates
//   z = X @ coef[f, g] + intercept[f, g, 0],  pred = (z >= 0),
//   err[f, g] = sum_r val_w[f, r] [pred_r != y_r] / max(sum_r val_w[f, r], 1).
// Candidate c = f * G + g.  Each row's margin is a float32 dot product in
// feature order by fused multiply-adds, then the intercept added; XLA's CPU
// dot may sum in another order, so a row whose margin lies within float32
// rounding of 0 can fall on the other side (the tests count such rows).  A
// NaN margin predicts 0, as the reference's comparison does.
//
// Pass 1 (logistic_error_partial): a block takes a tile of kTileRows rows
// and a chunk of candidates whose coefficients and intercepts it stages in
// shared memory (at most kSharedFloats floats).  A thread forms a row's
// margin for each candidate of the chunk in turn; the warp sums the weighted
// wrong flags and the weights by shuffles in a fixed pattern, lane 0 adds
// them to the warp's slot, and the block adds its warps' slots in warp
// order into its partials.  Pass 2 (logistic_error_finish): a thread a
// candidate adds the blocks' partials in block order in float64 and divides
// once in float32.  With 0/1 weights every sum is an integer below 2^24, so
// the result is exact, and runs repeat bit for bit (no atomics).
//
// Bound on the card: bytes at the sweep's shapes (X read once, n d floats;
// y and the F weight rows; the F G results), next to 2 n d F G float32
// operations of the margins: at 2^18 x 11 x 24 candidates both are tens of
// microseconds.  X is re-read from L1 / L2 for each candidate of a chunk.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 2048;
// 48 KB of staged coefficients: no opt-in to larger shared memory needed
constexpr int kSharedFloats = 12288;

__global__ void __launch_bounds__(kThreads)
logistic_error_partial(const float* __restrict__ X, const float* __restrict__ y,
                       const float* __restrict__ val_w, const float* __restrict__ coef,
                       const float* __restrict__ intercept, float* __restrict__ part_num,
                       float* __restrict__ part_den, int n, int d, int G, int C, int chunk) {
  extern __shared__ float sh[];
  float* s_coef = sh;                                  // [chunk, d]
  float* s_b = s_coef + (size_t)chunk * d;             // [chunk]
  float* s_num = s_b + chunk;                          // [kWarps, chunk]
  float* s_den = s_num + (size_t)kWarps * chunk;       // [kWarps, chunk]
  const int c0 = blockIdx.y * chunk;
  const int cc = min(chunk, C - c0);
  for (int i = threadIdx.x; i < cc * d; i += kThreads) s_coef[i] = coef[(size_t)c0 * d + i];
  for (int i = threadIdx.x; i < cc; i += kThreads) s_b[i] = intercept[c0 + i];
  for (int i = threadIdx.x; i < kWarps * chunk; i += kThreads) {
    s_num[i] = 0.0f;
    s_den[i] = 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const long long lo = (long long)blockIdx.x * kTileRows;
  const long long hi = min((long long)n, lo + kTileRows);
  for (long long base = lo; base < hi; base += kThreads) {
    const long long r = base + threadIdx.x;
    const bool valid = r < hi;
    const float* xr = X + (valid ? r : lo) * d;
    const float yr = valid ? y[r] : 0.0f;
    for (int k = 0; k < cc; ++k) {
      const float* ck = s_coef + (size_t)k * d;
      float z = 0.0f;
      for (int j = 0; j < d; ++j) z = __fmaf_rn(xr[j], ck[j], z);
      z = __fadd_rn(z, s_b[k]);
      const float pred = z >= 0.0f ? 1.0f : 0.0f;
      const int f = (c0 + k) / G;
      const float w = valid ? val_w[(size_t)f * n + r] : 0.0f;
      float num = pred != yr ? w : 0.0f;
      float den = w;
      for (int off = 16; off > 0; off >>= 1) {
        num += __shfl_xor_sync(0xffffffffu, num, off);
        den += __shfl_xor_sync(0xffffffffu, den, off);
      }
      if (lane == 0) {
        s_num[warp * chunk + k] += num;
        s_den[warp * chunk + k] += den;
      }
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < cc; k += kThreads) {
    float num = 0.0f, den = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      num += s_num[w * chunk + k];
      den += s_den[w * chunk + k];
    }
    part_num[(size_t)blockIdx.x * C + c0 + k] = num;
    part_den[(size_t)blockIdx.x * C + c0 + k] = den;
  }
}

__global__ void logistic_error_finish(const float* __restrict__ part_num,
                                      const float* __restrict__ part_den, float* __restrict__ out,
                                      int n_blocks, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  double num = 0.0, den = 0.0;
  for (int b = 0; b < n_blocks; ++b) {
    num += (double)part_num[(size_t)b * C + c];
    den += (double)part_den[(size_t)b * C + c];
  }
  out[c] = __fdiv_rn(__double2float_rn(num), fmaxf(__double2float_rn(den), 1.0f));
}

}  // namespace

// Rows a block takes; the caller sizes the partials [ceil(n / tile), C].
extern "C" int logistic_error_tile_rows() { return kTileRows; }

// Candidates one block stages for width d (0: d too wide for one candidate).
extern "C" int logistic_error_chunk(int d) {
  const int per = d + 1 + 2 * kWarps;
  return per > kSharedFloats ? 0 : kSharedFloats / per;
}

// X f32[n, d], y f32[n], val_w f32[F, n], coef f32[C, d] and intercept f32[C]
// (candidate c = f * G + g, C = F G), partials f32[2, ceil(n / tile), C]
// scratch, out f32[C].
extern "C" int logistic_grid_error(const void* X, const void* y, const void* val_w,
                                   const void* coef, const void* intercept, void* partials,
                                   void* out, int n, int d, int G, int C, void* stream) {
  if (n <= 0 || d <= 0 || G <= 0 || C <= 0 || C % G) return (int)cudaErrorInvalidValue;
  const int chunk = logistic_error_chunk(d) < C ? logistic_error_chunk(d) : C;
  if (chunk <= 0) return (int)cudaErrorInvalidValue;
  const int n_blocks = (n + kTileRows - 1) / kTileRows;
  const size_t shmem = sizeof(float) * ((size_t)chunk * (d + 1) + 2 * (size_t)kWarps * chunk);
  float* num = (float*)partials;
  float* den = num + (size_t)n_blocks * C;
  dim3 grid(n_blocks, (C + chunk - 1) / chunk);
  logistic_error_partial<<<grid, kThreads, shmem, (cudaStream_t)stream>>>(
      (const float*)X, (const float*)y, (const float*)val_w, (const float*)coef,
      (const float*)intercept, num, den, n, d, G, C, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  logistic_error_finish<<<(C + 127) / 128, 128, 0, (cudaStream_t)stream>>>(num, den, (float*)out,
                                                                         n_blocks, C);
  return (int)cudaGetLastError();
}
