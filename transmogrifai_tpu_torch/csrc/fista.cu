// K-K fista_grad, K-N linear_fista_grad and K-P softmax_fista_grad: the
// gradient step of the batched elastic-net logistic, linear-regression and
// multinomial (softmax) fits.
//
// Replaces: the body of transmogrifai_tpu/ops/linear.py::fit_logistic_fista
// (:105) as fit_logistic_grid_folds_fista (:409) vmaps it (K-K), and the
// body of ::fit_linear_fista (:211) as fit_linear_grid_folds_fista (:449)
// vmaps it (K-N): for every fit c of C = F x G at once,
//   grad_c = X1^T (w_f(c) * (link(X1 z_c) - y)) / wsum_c + l2_c * z_c,
// with link the sigmoid (K-K) or the identity (K-N), X1 = [X, 1] f32[n, p]
// shared by all fits, each fit reading its fold's weight row w[f(c)] (the
// G fits of a fold share it; no [C, n] copy).  One skeleton serves both:
// the link is a template parameter.
//
// Entry point 1 (fista_partial): a block takes a chunk of rows and a tile of
// up to CT fits; each thread reads a row of X1 once, forms the CT margins,
// applies the link (the sigmoid as 1 / (1 + exp(-m)), the expansion XLA
// uses; libdevice's expf) and the weighted residuals, and accumulates
// residual x row in registers; the block reduces them (warp shuffles, then
// the warps in order) into the chunk's partial [C, p].  Entry point 2
// (fista_finish) sums the chunks' partials in chunk order, divides by the
// fit's weight sum and adds the L2 term.  No atomics, so runs repeat bit
// for bit.  Sums are float32 in another order than XLA's, so gradients
// differ from the reference's in the last bits.
//
// Bound on the card: bytes.  X1 is read once per tile of fits (tiles of 8
// fits at p <= 16, 4 at p <= 24: the Boston fits' p = 17 takes six tiles of
// four, whose later reads of X1 mostly hit L2), each fold's weight row and
// y once, the partials are small.  The tile sizes keep the accumulators
// (CT x PM floats a thread) in registers.
//
// K-P (softmax_partial) replaces the gradient of the body of
// transmogrifai_tpu/ops/linear.py::fit_softmax (:148) as
// fit_softmax_grid_folds (:432) vmaps it: for every fit c, with B_c the
// coefficient matrix f32[p, k] and Y the one-hot labels,
//   grad_c = X1^T (w_f(c) * (softmax(X1 B_c) - Y)) / wsum_c + l2_c * B_c.
// A fit carries p x k accumulators (27 for the Iris fits' p = 9, k = 3),
// so a block takes ONE fit and a slab of at most 16 coefficient rows
// (grid: row chunks x fits x slabs); a thread keeps 16 x KM accumulators
// (KM = 4 or 8 classes) in registers.  Per row it forms the k margins from
// the whole row (B_c in shared memory), the softmax as the reference writes
// it (subtract the max, exp, divide by the sum; libdevice's expf), the
// weighted residuals, and accumulates residual x row for its slab (a
// thread's few rows in float32).  The block reduction and the chunks' sum
// (softmax_finish) are float64 in a fixed order, rounded to float32 once:
// runs repeat bit for bit, and the gradient is within float32 rounding of
// the exact sum over 2^18 rows.
// Bound: operations (about 4 p k + 6 k per fit and row) over the card's
// float32 rate; X1 is read once per fit and slab, mostly from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int PM, int CT, bool LOGISTIC>
__global__ void __launch_bounds__(kThreads)
fista_partial(const float* __restrict__ X1, const float* __restrict__ y,
              const float* __restrict__ w, const int32_t* __restrict__ fold,
              const float* __restrict__ z, float* __restrict__ partial, int n, int p, int C,
              int chunk_rows) {
  __shared__ float zs[CT][PM];
  __shared__ int fs[CT];
  __shared__ float red[kWarps][CT * PM];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  for (int i = tid; i < CT * PM; i += kThreads) {
    const int c = i / PM, j = i % PM;
    zs[c][j] = (c < nc && j < p) ? z[(long long)(c0 + c) * p + j] : 0.0f;
  }
  if (tid < CT) fs[tid] = tid < nc ? fold[c0 + tid] : 0;
  __syncthreads();
  float acc[CT][PM];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int j = 0; j < PM; ++j) acc[c][j] = 0.0f;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long r = r0 + tid; r < r1; r += kThreads) {
    float x[PM];
#pragma unroll
    for (int j = 0; j < PM; ++j) x[j] = j < p ? X1[r * p + j] : 0.0f;
    const float yr = y[r];
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < nc) {
        float m = 0.0f;
#pragma unroll
        for (int j = 0; j < PM; ++j) m = __fmaf_rn(x[j], zs[c][j], m);
        const float s = LOGISTIC ? __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-m))) : m;
        const float e = __fmul_rn(w[(long long)fs[c] * n + r], __fsub_rn(s, yr));
#pragma unroll
        for (int j = 0; j < PM; ++j) acc[c][j] = __fmaf_rn(e, x[j], acc[c][j]);
      }
    }
  }
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int j = 0; j < PM; ++j) {
      float v = acc[c][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) red[warp][c * PM + j] = v;
    }
  __syncthreads();
  for (int i = tid; i < CT * PM; i += kThreads) {
    const int c = i / PM, j = i % PM;
    if (c >= nc || j >= p) continue;
    float s = 0.0f;
    for (int k = 0; k < kWarps; ++k) s = __fadd_rn(s, red[k][i]);
    partial[((long long)blockIdx.x * C + c0 + c) * p + j] = s;
  }
}

__global__ void fista_finish(const float* __restrict__ partial, const float* __restrict__ wsum,
                             const float* __restrict__ l2v, const float* __restrict__ z,
                             float* __restrict__ grad, int chunks, int C, int p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * p) return;
  float s = 0.0f;
  for (int k = 0; k < chunks; ++k) s = __fadd_rn(s, partial[(long long)k * C * p + i]);
  grad[i] = __fadd_rn(__fdiv_rn(s, wsum[i / p]), __fmul_rn(l2v[i], z[i]));
}

template <int PM, int CT, bool LOGISTIC>
int launch(const void* X1, const void* y, const void* w, const void* fold, const void* z,
           const void* wsum, const void* l2v, void* partial, void* grad, int n, int p, int C,
           int chunks, int chunk_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)((C + CT - 1) / CT));
  fista_partial<PM, CT, LOGISTIC><<<grid, kThreads, 0, st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (float*)partial, n, p, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  fista_finish<<<(C * p + threads - 1) / threads, threads, 0, st>>>(
      (const float*)partial, (const float*)wsum, (const float*)l2v, (const float*)z,
      (float*)grad, chunks, C, p);
  return (int)cudaGetLastError();
}

constexpr int kSlab = 16;   // coefficient rows a K-P block accumulates
constexpr int kMaxCoefs = 64;

template <int KM>
__global__ void __launch_bounds__(kThreads)
softmax_partial(const float* __restrict__ X1, const float* __restrict__ y,
                const float* __restrict__ w, const int32_t* __restrict__ fold,
                const float* __restrict__ z, double* __restrict__ partial, int n, int p, int k,
                int C, int chunk_rows) {
  __shared__ float zs[kMaxCoefs][KM];
  __shared__ double red[kWarps][kSlab * KM];
  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  const int i0 = blockIdx.z * kSlab;
  const int ns = min(kSlab, p - i0);
  for (int i = tid; i < kMaxCoefs * KM; i += kThreads) {
    const int a = i / KM, j = i % KM;
    zs[a][j] = (a < p && j < k) ? z[((long long)c * p + a) * k + j] : 0.0f;
  }
  __syncthreads();
  const float* wf = w + (long long)fold[c] * n;
  float acc[kSlab][KM];
#pragma unroll
  for (int a = 0; a < kSlab; ++a)
#pragma unroll
    for (int j = 0; j < KM; ++j) acc[a][j] = 0.0f;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long r = r0 + tid; r < r1; r += kThreads) {
    const float* xr = X1 + r * p;
    float m[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) m[j] = 0.0f;
    for (int a = 0; a < p; ++a) {
      const float xa = xr[a];
#pragma unroll
      for (int j = 0; j < KM; ++j) m[j] = __fmaf_rn(xa, zs[a][j], m[j]);
    }
    float mx = m[0];
#pragma unroll
    for (int j = 1; j < KM; ++j)
      if (j < k) mx = fmaxf(mx, m[j]);
    float e[KM];
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      e[j] = j < k ? expf(__fsub_rn(m[j], mx)) : 0.0f;
      if (j < k) sum = j == 0 ? e[0] : __fadd_rn(sum, e[j]);
    }
    const float wr = wf[r];
    const int label = (int)y[r];
    float res[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j)
      res[j] = __fmul_rn(wr, __fsub_rn(__fdiv_rn(e[j], sum), j == label ? 1.0f : 0.0f));
#pragma unroll
    for (int a = 0; a < kSlab; ++a) {
      if (a < ns) {
        const float xa = xr[i0 + a];
#pragma unroll
        for (int j = 0; j < KM; ++j) acc[a][j] = __fmaf_rn(res[j], xa, acc[a][j]);
      }
    }
  }
  const int lane = tid % 32, warp = tid / 32;
#pragma unroll
  for (int a = 0; a < kSlab; ++a)
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      double v = (double)acc[a][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][a * KM + j] = v;
    }
  __syncthreads();
  for (int i = tid; i < kSlab * KM; i += kThreads) {
    const int a = i / KM, j = i % KM;
    if (a >= ns || j >= k) continue;
    double s = 0.0;
    for (int q = 0; q < kWarps; ++q) s += red[q][i];
    partial[(((long long)blockIdx.x * C + c) * p + i0 + a) * k + j] = s;
  }
}

// The chunks' float64 partials summed in chunk order and rounded once, then
// divided by the fit's weight sum, plus the L2 term (as fista_finish).
__global__ void softmax_finish(const double* __restrict__ partial,
                               const float* __restrict__ wsum, const float* __restrict__ l2m,
                               const float* __restrict__ z, float* __restrict__ grad, int chunks,
                               int C, int pk) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * pk) return;
  double s = 0.0;
  for (int q = 0; q < chunks; ++q) s += partial[(long long)q * C * pk + i];
  grad[i] = __fadd_rn(__fdiv_rn(__double2float_rn(s), wsum[i / pk]), __fmul_rn(l2m[i], z[i]));
}

template <int KM>
int launch_softmax(const void* X1, const void* y, const void* w, const void* fold,
                   const void* z, const void* wsum, const void* l2m, void* partial, void* grad,
                   int n, int p, int k, int C, int chunks, int chunk_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)C, (unsigned)((p + kSlab - 1) / kSlab));
  softmax_partial<KM><<<grid, kThreads, 0, st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (double*)partial, n, p, k, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128, pk = p * k;
  softmax_finish<<<(C * pk + threads - 1) / threads, threads, 0, st>>>(
      (const double*)partial, (const float*)wsum, (const float*)l2m, (const float*)z,
      (float*)grad, chunks, C, pk);
  return (int)cudaGetLastError();
}

// p <= 16: tiles of 8 fits; p <= 24: tiles of 4; p <= 64: tiles of 2.
template <bool LOGISTIC>
int dispatch(const void* X1, const void* y, const void* w, const void* fold, const void* z,
             const void* wsum, const void* l2v, void* partial, void* grad, int n, int p, int C,
             int chunks, int chunk_rows, void* stream) {
  if (n <= 0 || p <= 0 || C <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  if (p <= 16)
    return launch<16, 8, LOGISTIC>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C,
                                   chunks, chunk_rows, stream);
  if (p <= 24)
    return launch<24, 4, LOGISTIC>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C,
                                   chunks, chunk_rows, stream);
  if (p <= 64)
    return launch<64, 2, LOGISTIC>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C,
                                   chunks, chunk_rows, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int fista_grad(const void* X1, const void* y, const void* w, const void* fold,
                          const void* z, const void* wsum, const void* l2v, void* partial,
                          void* grad, int n, int p, int C, int chunks, int chunk_rows,
                          void* stream) {
  return dispatch<true>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                        chunk_rows, stream);
}

extern "C" int linear_fista_grad(const void* X1, const void* y, const void* w,
                                 const void* fold, const void* z, const void* wsum,
                                 const void* l2v, void* partial, void* grad, int n, int p,
                                 int C, int chunks, int chunk_rows, void* stream) {
  return dispatch<false>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                         chunk_rows, stream);
}

extern "C" int softmax_fista_grad(const void* X1, const void* y, const void* w,
                                  const void* fold, const void* z, const void* wsum,
                                  const void* l2m, void* partial, void* grad, int n, int p,
                                  int k, int C, int chunks, int chunk_rows, void* stream) {
  // C fits on the grid's y axis
  if (n <= 0 || p <= 0 || p > kMaxCoefs || k <= 0 || C <= 0 || C > 65535 || chunks <= 0)
    return (int)cudaErrorInvalidValue;
  if (k <= 4)
    return launch_softmax<4>(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks,
                             chunk_rows, stream);
  if (k <= 8)
    return launch_softmax<8>(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks,
                             chunk_rows, stream);
  return (int)cudaErrorInvalidValue;
}
