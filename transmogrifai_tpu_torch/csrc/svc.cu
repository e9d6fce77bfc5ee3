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
// Above 64 coefficients (up to 1,024) the wide entry (svc_partial_rows)
// takes K-K's wide design: a warp a row, lane l loading the row's
// coefficients l, l + 32, ... (coalesced), each fit's margin of a tile of
// fits formed on every lane by a butterfly, lane c taking fit c's hinge and
// residual and sharing it by a shuffle, each lane accumulating residual x
// its coefficients (VPL x CT = 32 float32 accumulators: tiles of 8 fits at
// p <= 128 down to 1 at p <= 1,024); the block's warps are summed in
// float64 in warp order into the chunk's partial, and a warp an entry sums
// the chunks (svc_finish_wide).
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int kMaxWide = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

template <int VPL, int CT>
__global__ void __launch_bounds__(kThreads)
svc_partial_rows(const float* __restrict__ X1, const float* __restrict__ y,
                 const float* __restrict__ w, const int32_t* __restrict__ fold,
                 const float* __restrict__ z, double* __restrict__ partial, int n, int p, int C,
                 int chunk_rows) {
  constexpr int PW = 32 * VPL;
  __shared__ float zs[CT][PW];
  __shared__ int fs[CT];
  __shared__ float red[kWarps][CT][PW];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  for (int i = tid; i < CT * PW; i += kThreads) {
    const int c = i / PW, j = i % PW;
    zs[c][j] = (c < nc && j < p) ? z[(long long)(c0 + c) * p + j] : 0.0f;
  }
  if (tid < CT) fs[tid] = tid < nc ? fold[c0 + tid] : 0;
  __syncthreads();
  float acc[CT][VPL];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < VPL; ++i) acc[c][i] = 0.0f;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long r = r0 + warp; r < r1; r += kWarps) {
    float x[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      const int j = lane + 32 * i;
      x[i] = j < p ? X1[r * p + j] : 0.0f;
    }
    float mine = 0.0f;
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      float m = __fmul_rn(x[0], zs[c][lane]);
#pragma unroll
      for (int i = 1; i < VPL; ++i) m = __fmaf_rn(x[i], zs[c][lane + 32 * i], m);
      m = warp_sum(m);
      if (lane == c) mine = m;
    }
    float e_lane = 0.0f;
    if (lane < nc) {
      const float ypm = __fsub_rn(__fmul_rn(2.0f, y[r]), 1.0f);
      const float active = fmaxf(__fsub_rn(1.0f, __fmul_rn(ypm, mine)), 0.0f);
      e_lane = __fmul_rn(w[(long long)fs[lane] * n + r], __fmul_rn(__fmul_rn(-2.0f, ypm), active));
    }
#pragma unroll
    for (int c = 0; c < CT; ++c) {
      const float e = __shfl_sync(0xffffffffu, e_lane, c);
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[c][i] = __fmaf_rn(e, x[i], acc[c][i]);
    }
  }
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int i = 0; i < VPL; ++i) red[warp][c][lane + 32 * i] = acc[c][i];
  __syncthreads();
  for (int i = tid; i < CT * PW; i += kThreads) {
    const int c = i / PW, j = i % PW;
    if (c >= nc || j >= p) continue;
    double s = (double)red[0][c][j];
    for (int k = 1; k < kWarps; ++k) s += (double)red[k][c][j];
    partial[((long long)blockIdx.x * C + c0 + c) * p + j] = s;
  }
}

// A warp an entry: lane l sums chunks l, l + 32, ... in float64, a fixed
// shuffle tree, one rounding, then the weight sum and the L2 term.
__global__ void svc_finish_wide(const double* __restrict__ partial, const float* __restrict__ wsum,
                                const float* __restrict__ l2v, const float* __restrict__ z,
                                float* __restrict__ grad, int chunks, int C, int p) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= (long long)C * p) return;
  double s = 0.0;
  for (int k = lane; k < chunks; k += 32) s += partial[(long long)k * C * p + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0)
    grad[i] = __fadd_rn(__fdiv_rn(__double2float_rn(s), wsum[i / p]), __fmul_rn(l2v[i], z[i]));
}

template <int VPL, int CT>
int launch_wide(const void* X1, const void* y, const void* w, const void* fold, const void* z,
                const void* wsum, const void* l2v, void* partial, void* grad, int n, int p,
                int C, int chunks, int chunk_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)((C + CT - 1) / CT));
  svc_partial_rows<VPL, CT><<<grid, kThreads, 0, st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (double*)partial, n, p, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)C * p * 32;
  svc_finish_wide<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
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
  if (p <= 128)
    return launch_wide<4, 8>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                             chunk_rows, stream);
  if (p <= 256)
    return launch_wide<8, 4>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                             chunk_rows, stream);
  if (p <= 512)
    return launch_wide<16, 2>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                              chunk_rows, stream);
  if (p <= kMaxWide)
    return launch_wide<32, 1>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C, chunks,
                              chunk_rows, stream);
  return (int)cudaErrorInvalidValue;
}
