// K-V nb_tables: the naive-Bayes fits' class and feature masses, and the
// joint log-likelihoods of every (fold, smoothing) table set.
//
// Replaces: transmogrifai_tpu/impl/classification/naive_bayes.py::_nb_grid_z
// (:21-42), whose two einsums are the work:
//   mass mode  (nb_mass):  class_mass[f, c]   = sum_r w[f, r] [y_r == c]
//                          feat_mass[f, c, j] = sum_r w[f, r] [y_r == c] X[r, j]
//   score mode (nb_score): z[q, r, c] = pi[q, c] + sum_j X[r, j] theta[q, c, j]
//                                     (+ sum_j (1 - X[r, j]) tn[q, c, j], Bernoulli)
// for every table set q (fold x smoothing).  The log tables between the two
// modes are a few torch ops on [F, k, d].
//
// Mass mode: a block takes a chunk of rows of one fold and walks it in tiles
// of 32 rows staged in shared memory (the features, the label, the weight);
// each of the k (d + 1) output entries belongs to one thread, which adds the
// tile's products to its float64 sum in shared memory (a float32 times a
// float32 is exact in float64, so the sums are exact but for the final
// rounding of very long ones).  The chunks' partials are summed in chunk
// order by nb_mass_finish and rounded to float32 once: runs repeat bit for
// bit, and each mass is within a rounding of the exact sum (the reference's
// float32 sums of the real columns differ from it in the last bits).
//
// Score mode: a thread takes one row of one table set; the set's tables sit
// in shared memory; each class's dot product is summed in float64 and
// rounded once, then added to pi in float32 in the reference's order.
//
// Bound on the card: bytes.  Mass mode reads X once per fold (n d floats)
// with the fold's weights and the labels; score mode reads X once per table
// set and writes z (k floats a row and set).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kMaxFeatures = 256;
constexpr int kMaxClasses = 8;

__global__ void __launch_bounds__(kThreads)
nb_mass(const float* __restrict__ X, const float* __restrict__ y, const float* __restrict__ w,
        double* __restrict__ partial, int n, int d, int k, int chunk_rows) {
  extern __shared__ double smem[];
  const int E = k * (d + 1);
  double* acc = smem;                               // [E]
  float* xs = (float*)(acc + E);                    // [kTile, d]
  float* ws = xs + kTile * d;                       // [kTile]
  int* ys = (int*)(ws + kTile);                     // [kTile]
  const int tid = threadIdx.x;
  const int f = blockIdx.y;
  for (int e = tid; e < E; e += kThreads) acc[e] = 0.0;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long t0 = r0; t0 < r1; t0 += kTile) {
    const int rows = (int)min((long long)kTile, r1 - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < rows * d; i += kThreads) xs[i] = X[t0 * d + i];
    if (tid < rows) {
      ws[tid] = w[(long long)f * n + t0 + tid];
      ys[tid] = (int)y[t0 + tid];
    }
    __syncthreads();
    for (int e = tid; e < E; e += kThreads) {
      double s = acc[e];
      if (e < k) {
        for (int r = 0; r < rows; ++r)
          if (ys[r] == e) s += (double)ws[r];
      } else {
        const int c = (e - k) / d, j = (e - k) % d;
        for (int r = 0; r < rows; ++r)
          if (ys[r] == c) s += (double)ws[r] * (double)xs[r * d + j];
      }
      acc[e] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += kThreads)
    partial[((long long)blockIdx.x * gridDim.y + f) * E + e] = acc[e];
}

// partial [chunks, F, E] summed in chunk order, rounded once: class masses
// [F, k] and feature masses [F, k, d].
__global__ void nb_mass_finish(const double* __restrict__ partial, float* __restrict__ cls,
                               float* __restrict__ feat, int chunks, int F, int d, int k) {
  const int E = k * (d + 1);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F * E) return;
  double s = 0.0;
  for (int q = 0; q < chunks; ++q) s += partial[(long long)q * F * E + i];
  const int f = i / E, e = i % E;
  if (e < k)
    cls[f * k + e] = __double2float_rn(s);
  else
    feat[(long long)f * k * d + (e - k)] = __double2float_rn(s);
}

__global__ void __launch_bounds__(kThreads)
nb_score(const float* __restrict__ X, const float* __restrict__ pi,
         const float* __restrict__ theta, const float* __restrict__ tn, float* __restrict__ z,
         int n, int d, int k, int bernoulli) {
  __shared__ float th[kMaxClasses * kMaxFeatures];
  __shared__ float tns[kMaxClasses * kMaxFeatures];
  __shared__ float ps[kMaxClasses];
  const int tid = threadIdx.x;
  const int q = blockIdx.y;
  for (int i = tid; i < k * d; i += kThreads) {
    th[i] = theta[(long long)q * k * d + i];
    tns[i] = bernoulli ? tn[(long long)q * k * d + i] : 0.0f;
  }
  if (tid < k) ps[tid] = pi[q * k + tid];
  __syncthreads();
  const long long r = (long long)blockIdx.x * kThreads + tid;
  if (r >= n) return;
  const float* xr = X + r * d;
  double s[kMaxClasses], s2[kMaxClasses];
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) s[c] = s2[c] = 0.0;
  for (int j = 0; j < d; ++j) {
    const float x = xr[j];
    const float xn = __fsub_rn(1.0f, x);
#pragma unroll
    for (int c = 0; c < kMaxClasses; ++c) {
      if (c < k) {
        s[c] += (double)x * (double)th[c * d + j];
        if (bernoulli) s2[c] += (double)xn * (double)tns[c * d + j];
      }
    }
  }
  float* out = z + ((long long)q * n + r) * k;
#pragma unroll
  for (int c = 0; c < kMaxClasses; ++c) {
    if (c < k) {
      float v = __fadd_rn(ps[c], __double2float_rn(s[c]));
      if (bernoulli) v = __fadd_rn(v, __double2float_rn(s2[c]));
      out[c] = v;
    }
  }
}

}  // namespace

extern "C" int nb_tables_mass(const void* X, const void* y, const void* w, void* partial,
                              void* cls, void* feat, int n, int d, int k, int F, int chunks,
                              int chunk_rows, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxFeatures || k <= 0 || k > kMaxClasses || F <= 0 ||
      F > 65535 || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t E = (size_t)k * (d + 1);
  const size_t smem = E * sizeof(double) + (size_t)kTile * d * sizeof(float) +
                      kTile * sizeof(float) + kTile * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nb_mass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nb_mass<<<dim3((unsigned)chunks, (unsigned)F), kThreads, smem, st>>>(
      (const float*)X, (const float*)y, (const float*)w, (double*)partial, n, d, k, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const int total = F * (int)E;
  nb_mass_finish<<<(total + threads - 1) / threads, threads, 0, st>>>(
      (const double*)partial, (float*)cls, (float*)feat, chunks, F, d, k);
  return (int)cudaGetLastError();
}

extern "C" int nb_tables_score(const void* X, const void* pi, const void* theta,
                               const void* tn, void* z, int n, int d, int k, int Q,
                               int bernoulli, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxFeatures || k <= 0 || k > kMaxClasses || Q <= 0 ||
      Q > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  nb_score<<<dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)Q), kThreads, 0, st>>>(
      (const float*)X, (const float*)pi, (const float*)theta, (const float*)tn, (float*)z, n, d,
      k, bernoulli);
  return (int)cudaGetLastError();
}
