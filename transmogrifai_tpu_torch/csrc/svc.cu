// K-T svc_grad: the gradient step of the batched squared-hinge linear SVC fits.
//
// Replaces: the gradient of the body of
// transmogrifai_tpu/ops/linear.py::fit_linear_svc (:254, its grad_fn) as
// fit_svc_grid_folds (:466) vmaps it: for every fit c of C = F x G at once,
//   m_r    = 1 - ypm_r (x_r . z_c),   ypm_r = 2 y_r - 1 in {-1, +1},
//   grad_c = X1^T (w_f(c) * (-2 ypm max(m, 0))) / wsum_c + l2_c * z_c,
// with X1 = [X, 1] f32[n, p] shared by all fits and each fit reading its
// fold's weight row w[f(c)] (the G fits of a fold share it).
//
// Entry point 1 (svc_partial): a block takes a chunk of rows and a tile of up
// to CT fits (4 at p <= 16, 2 at p <= 32, 1 at p <= 64: CT x PM float32
// accumulators a thread, which stay in registers where K-K's tiles of 8 at
// p <= 16 spilled); each thread reads a row of X1 once, forms the CT margins
// (a fused multiply-add chain), the hinge and the weighted residual, and
// accumulates residual x row over its few rows of the chunk in float32.  The
// block reduces the threads' sums in float64 (warp shuffles, then the warps
// in order) into the chunk's partial [C, p].  Entry point 2 (svc_finish)
// sums the chunks' float64 partials in chunk order, rounds once, divides by
// the fit's weight sum and adds the L2 term.  No atomics, so runs repeat bit
// for bit; sums are in another order than XLA's, so gradients differ from the
// reference's in the last bits.
//
// Bound on the card: bytes.  X1 is read once per tile of fits (one tile at
// Titanic's p = 11 and four fits a fold), each fold's weight row and y once;
// about 2 p + 6 operations per fit and row.
//
// Above 64 coefficients (up to 1,024) K-T takes its wide entry
// (wide_rows_partial in csrc/wide_rows.cuh, shared with K-P's), planned by
// ops/linear.py::wide_rows_plan: a block takes a chunk of rows and a group
// of fits (all 12 of the text flow's SVC grid at p = 85 and 513) over row
// tiles staged once for the group; register-blocked float32 margins in
// 32-coefficient blocks, a thread a (row, fit)'s hinge and residual, the
// gradient in float32 a tile and float64 across tiles, then its finish
// (wide_rows_finish).
#include <cuda_runtime.h>
#include <stdint.h>

#include "wide_rows.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int PM, int CT>
__global__ void __launch_bounds__(kThreads)
svc_partial(const float* __restrict__ X1, const float* __restrict__ y,
            const float* __restrict__ w, const int32_t* __restrict__ fold,
            const float* __restrict__ z, double* __restrict__ partial, int n, int p, int C,
            int chunk_rows) {
  __shared__ float zs[CT][PM];
  __shared__ int fs[CT];
  __shared__ double red[kWarps][CT * PM];
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
    const float ypm = __fsub_rn(__fmul_rn(2.0f, y[r]), 1.0f);
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      if (c < nc) {
        float m = 0.0f;
#pragma unroll
        for (int j = 0; j < PM; ++j) m = __fmaf_rn(x[j], zs[c][j], m);
        const float active = fmaxf(__fsub_rn(1.0f, __fmul_rn(ypm, m)), 0.0f);
        const float e = __fmul_rn(w[(long long)fs[c] * n + r],
                                  __fmul_rn(__fmul_rn(-2.0f, ypm), active));
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
      double v = (double)acc[c][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][c * PM + j] = v;
    }
  __syncthreads();
  for (int i = tid; i < CT * PM; i += kThreads) {
    const int c = i / PM, j = i % PM;
    if (c >= nc || j >= p) continue;
    double s = 0.0;
    for (int k = 0; k < kWarps; ++k) s += red[k][i];
    partial[((long long)blockIdx.x * C + c0 + c) * p + j] = s;
  }
}

// The chunks' float64 partials summed in chunk order and rounded once, then
// divided by the fit's weight sum, plus the L2 term.
__global__ void svc_finish(const double* __restrict__ partial, const float* __restrict__ wsum,
                           const float* __restrict__ l2v, const float* __restrict__ z,
                           float* __restrict__ grad, int chunks, int C, int p) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * p) return;
  double s = 0.0;
  for (int k = 0; k < chunks; ++k) s += partial[(long long)k * C * p + i];
  grad[i] = __fadd_rn(__fdiv_rn(__double2float_rn(s), wsum[i / p]), __fmul_rn(l2v[i], z[i]));
}

template <int PM, int CT>
int launch(const void* X1, const void* y, const void* w, const void* fold, const void* z,
           const void* wsum, const void* l2v, void* partial, void* grad, int n, int p, int C,
           int chunks, int chunk_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)((C + CT - 1) / CT));
  svc_partial<PM, CT><<<grid, kThreads, 0, st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (double*)partial, n, p, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  svc_finish<<<(C * p + threads - 1) / threads, threads, 0, st>>>(
      (const double*)partial, (const float*)wsum, (const float*)l2v, (const float*)z,
      (float*)grad, chunks, C, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int svc_grad(const void* X1, const void* y, const void* w, const void* fold,
                        const void* z, const void* wsum, const void* l2v, void* partial,
                        void* grad, int n, int p, int C, int chunks, int chunk_rows,
                        void* stream) {
  if (n <= 0 || p <= 0 || C <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  if (p <= 16)
    return launch<16, 4>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                         chunk_rows, stream);
  if (p <= 32)
    return launch<32, 2>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                         chunk_rows, stream);
  if (p <= 64)
    return launch<64, 1>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                         chunk_rows, stream);
  return (int)cudaErrorInvalidValue;
}

// K-T past 64 coefficients, by the plan of ops/linear.py::wide_rows_plan (k =
// 1): G fits a block, R rows a tile, S row splits, T threads, MR rows of a
// micro-tile, smem bytes.
extern "C" int svc_grad_wide(const void* X1, const void* y, const void* w, const void* fold,
                             const void* z, const void* wsum, const void* l2v, void* partial,
                             void* grad, int n, int p, int C, int chunks, int chunk_rows, int G,
                             int R, int S, int T, int MR, int smem, void* stream) {
  return wide_rows::launch<wide_rows::kLossHinge>(X1, y, w, fold, z, wsum, l2v, partial, grad, n,
                                                  p, 1, C, chunks, chunk_rows, G, R, S, T, MR,
                                                  smem, (cudaStream_t)stream);
}
