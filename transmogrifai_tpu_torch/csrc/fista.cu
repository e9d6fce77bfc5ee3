// K-K fista_grad: the gradient step of the batched elastic-net logistic fits.
//
// Replaces: the body of transmogrifai_tpu/ops/linear.py::fit_logistic_fista
// (:105) as fit_logistic_grid_folds_fista (:409) vmaps it over folds x grid:
// for every fit c of C = F x G at once,
//   grad_c = X1^T (w_f(c) * (sigmoid(X1 z_c) - y)) / wsum_c + l2_c * z_c,
// with X1 = [X, 1] f32[n, p] shared by all fits, each fit reading its fold's
// weight row w[f(c)] (the G fits of a fold share it; no [C, n] copy).
//
// Entry point 1 (fista_partial): a block takes a chunk of rows and a tile of
// up to CT fits; each thread reads a row of X1 once, forms the CT margins,
// sigmoids (1 / (1 + exp(-m)), the expansion XLA uses; libdevice's expf) and
// weighted residuals, and accumulates residual x row in registers; the
// block reduces them (warp shuffles, then the warps in order) into the
// chunk's partial [C, p].  Entry point 2 (fista_finish) sums the chunks'
// partials in chunk order, divides by the fit's weight sum and adds the L2
// term.  No atomics, so runs repeat bit for bit.  Sums are float32 in
// another order than XLA's, so gradients differ from the reference's in
// the last bits.
//
// Bound on the card: bytes.  X1 is read once per tile of fits (once for
// C <= 8 at p <= 16), each fold's weight row and y once, the partials are
// small.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int PM, int CT>
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
        const float s = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-m)));
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

template <int PM, int CT>
int launch(const void* X1, const void* y, const void* w, const void* fold, const void* z,
           const void* wsum, const void* l2v, void* partial, void* grad, int n, int p, int C,
           int chunks, int chunk_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)((C + CT - 1) / CT));
  fista_partial<PM, CT><<<grid, kThreads, 0, st>>>(
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

}  // namespace

// p <= 16: tiles of 8 fits; p <= 64: tiles of 2 fits.
extern "C" int fista_grad(const void* X1, const void* y, const void* w, const void* fold,
                          const void* z, const void* wsum, const void* l2v, void* partial,
                          void* grad, int n, int p, int C, int chunks, int chunk_rows,
                          void* stream) {
  if (n <= 0 || p <= 0 || C <= 0 || chunks <= 0) return (int)cudaErrorInvalidValue;
  if (p <= 16)
    return launch<16, 8>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                         chunk_rows, stream);
  if (p <= 64)
    return launch<64, 2>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                         chunk_rows, stream);
  return (int)cudaErrorInvalidValue;
}
