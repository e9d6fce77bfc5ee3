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
// Above 64 coefficients (up to 1,024: a Titanic vector with Word2Vec and
// LDA features is 85 wide, the real CSV's hashed names wider) a thread's
// accumulators no longer fit a row, so the wide entry (fista_partial_rows)
// takes a warp a row: lane l loads the row's coefficients l, l + 32, ...
// (coalesced), forms its part of each fit's margin (the fits' z in shared
// memory), a butterfly sums it on every lane, lane c takes fit c's sigmoid
// and residual and shares it, and each lane accumulates residual x its
// coefficients; a block takes a chunk of rows and a tile of
// fits (VPL x CT = 32 accumulators a lane) and sums its warps' partials in
// order into the chunk's partial; a warp an entry sums the chunks
// (fista_finish_wide).  X1 is read once per tile of fits (one tile of 8 at
// the text flow's sweep calls).
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
//
// Above 64 coefficients (up to 1,024) K-P takes the wide entry
// (softmax_partial_rows), K-K's wide design: a warp a row, lane l loading
// the row's coefficients l, l + 32, ... (coalesced), each fit's k margins
// formed on every lane by k butterflies (the fits' B in dynamic shared
// memory), lane c taking fit c's softmax and residuals and sharing them by
// shuffles.  A lane accumulates residual x row for a slab of 128
// coefficients (4 a lane) and a tile of fits (2 fits of 4 classes or 1 of
// 8: 32 float32 accumulators), the grid's z axis walking the slabs; the
// block's warps are summed in float64 in warp order into the chunk's
// partial, and a warp an entry sums the chunks (softmax_finish_wide).
//
// Above 8 classes (up to 128, at any p up to 1,024) a thread can hold
// neither a row's k margins nor 16 x k accumulators, so K-P takes its tiled
// entry (softmax_partial_tiled): a block takes one fit, a chunk of rows and
// a slab of up to 4,096 of the fit's p x k outputs (the grid's z axis), and
// walks its rows in tiles of R (up to 128) rows staged in shared memory.
// Per tile: the threads form the R x k margins (a thread a margin, the fit's
// B read through L1, the row from shared memory; blocks of 32 coefficients
// summed apart, then added) into a shared [R, k] tile;
// a warp a row takes its max, exp(m - max) (libdevice's expf), their sum in
// class order and the weighted residuals in place; then each thread adds
// residual x row over the tile's rows for its 16 outputs (a float32 sum a
// tile, added into float64 accumulators).  The chunks' float64 partials are
// summed as the other entries' (softmax_finish, softmax_finish_wide).  The
// work is the 2 p k operations a row and fit that the function needs (the
// margins again for each further output slab past 4,096 outputs); the
// margins and residuals never leave shared memory.
#include <cuda_runtime.h>
#include <math.h>
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

constexpr int kMaxWide = 1024;   // the most coefficients the wide entry takes

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same (commutative) sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The wide entry: a warp a row, lane l holding the row's coefficients
// l, l + 32, ... (VPL of them: coalesced loads), CT fits a block.
template <int VPL, int CT, bool LOGISTIC>
__global__ void __launch_bounds__(kThreads)
fista_partial_rows(const float* __restrict__ X1, const float* __restrict__ y,
                   const float* __restrict__ w, const int32_t* __restrict__ fold,
                   const float* __restrict__ z, float* __restrict__ partial, int n, int p, int C,
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
    // every lane gets each fit's margin; lane c < nc then takes fit c's link
    // and residual (one lane a fit, not 32), and the warp shares them
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
      const float s = LOGISTIC ? __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-mine))) : mine;
      e_lane = __fmul_rn(w[(long long)fs[lane] * n + r], __fsub_rn(s, y[r]));
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
    float s = red[0][c][j];
    for (int k = 1; k < kWarps; ++k) s = __fadd_rn(s, red[k][c][j]);
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

// The wide entry's finish: a warp an entry, its lanes summing the chunks
// lane, lane + 32, ... and a butterfly (many chunks: a thread an entry would
// walk them in one dependent chain)
__global__ void fista_finish_wide(const float* __restrict__ partial,
                                  const float* __restrict__ wsum, const float* __restrict__ l2v,
                                  const float* __restrict__ z, float* __restrict__ grad,
                                  int chunks, int C, int p) {
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= C * p) return;
  float s = 0.0f;
  for (int k = lane; k < chunks; k += 32) s = __fadd_rn(s, partial[(long long)k * C * p + i]);
  s = warp_sum(s);
  if (lane == 0) grad[i] = __fadd_rn(__fdiv_rn(s, wsum[i / p]), __fmul_rn(l2v[i], z[i]));
}

template <int VPL, int CT, bool LOGISTIC>
int launch_wide(const void* X1, const void* y, const void* w, const void* fold, const void* z,
                const void* wsum, const void* l2v, void* partial, void* grad, int n, int p,
                int C, int chunks, int chunk_rows, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)((C + CT - 1) / CT));
  fista_partial_rows<VPL, CT, LOGISTIC><<<grid, kThreads, 0, st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (float*)partial, n, p, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int per_block = kThreads / 32;
  fista_finish_wide<<<(C * p + per_block - 1) / per_block, kThreads, 0, st>>>(
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


// ---- K-P's wide entry (p > 64) -----------------------------------------------
constexpr int kSoftSV = 4;   // coefficients a lane accumulates (a slab of 128)

template <int KM, int CT>
__global__ void __launch_bounds__(kThreads)
softmax_partial_rows(const float* __restrict__ X1, const float* __restrict__ y,
                     const float* __restrict__ w, const int32_t* __restrict__ fold,
                     const float* __restrict__ z, double* __restrict__ partial, int n, int p,
                     int k, int C, int chunk_rows) {
  extern __shared__ float zs[];   // [CT][p][KM]
  constexpr int SW = 32 * kSoftSV;
  __shared__ double sacc[CT * KM * SW];
  __shared__ int fs[CT];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.y * CT;
  const int nc = min(CT, C - c0);
  const int s0 = blockIdx.z * SW;
  for (int i = tid; i < CT * p * KM; i += kThreads) {
    const int c = i / (p * KM), a = (i / KM) % p, j = i % KM;
    zs[i] = (c < nc && j < k) ? z[((long long)(c0 + c) * p + a) * k + j] : 0.0f;
  }
  for (int i = tid; i < CT * KM * SW; i += kThreads) sacc[i] = 0.0;
  if (tid < CT) fs[tid] = tid < nc ? fold[c0 + tid] : 0;
  __syncthreads();
  float acc[CT][KM][kSoftSV];
#pragma unroll
  for (int c = 0; c < CT; ++c)
#pragma unroll
    for (int j = 0; j < KM; ++j)
#pragma unroll
      for (int v = 0; v < kSoftSV; ++v) acc[c][j][v] = 0.0f;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long r = r0 + warp; r < r1; r += kWarps) {
    const float* xr = X1 + r * p;
    float m[CT][KM];
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < KM; ++j) m[c][j] = 0.0f;
    for (int a = lane; a < p; a += 32) {
      const float xa = xr[a];
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int j = 0; j < KM; ++j) m[c][j] = __fmaf_rn(xa, zs[(c * p + a) * KM + j], m[c][j]);
    }
    // every lane ends with every margin; lane c keeps fit c's
    float mine[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) mine[j] = 0.0f;
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        const float t = warp_sum(m[c][j]);
        if (lane == c) mine[j] = t;
      }
    float res[KM];
#pragma unroll
    for (int j = 0; j < KM; ++j) res[j] = 0.0f;
    if (lane < nc) {
      float mx = mine[0];
#pragma unroll
      for (int j = 1; j < KM; ++j)
        if (j < k) mx = fmaxf(mx, mine[j]);
      float e[KM];
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        e[j] = j < k ? expf(__fsub_rn(mine[j], mx)) : 0.0f;
        if (j < k) sum = j == 0 ? e[0] : __fadd_rn(sum, e[j]);
      }
      const float wr = w[(long long)fs[lane] * n + r];
      const int label = (int)y[r];
#pragma unroll
      for (int j = 0; j < KM; ++j)
        res[j] = __fmul_rn(wr, __fsub_rn(__fdiv_rn(e[j], sum), j == label ? 1.0f : 0.0f));
    }
    float xs[kSoftSV];
#pragma unroll
    for (int v = 0; v < kSoftSV; ++v) {
      const int a = s0 + lane + 32 * v;
      xs[v] = a < p ? xr[a] : 0.0f;
    }
#pragma unroll
    for (int c = 0; c < CT; ++c)
#pragma unroll
      for (int j = 0; j < KM; ++j) {
        const float e = __shfl_sync(0xffffffffu, res[j], c);
#pragma unroll
        for (int v = 0; v < kSoftSV; ++v) acc[c][j][v] = __fmaf_rn(e, xs[v], acc[c][j][v]);
      }
  }
  // the warps' sums added in float64, in warp order
  for (int q = 0; q < kWarps; ++q) {
    if (warp == q) {
#pragma unroll
      for (int c = 0; c < CT; ++c)
#pragma unroll
        for (int j = 0; j < KM; ++j)
#pragma unroll
          for (int v = 0; v < kSoftSV; ++v)
            sacc[(c * KM + j) * SW + lane + 32 * v] += (double)acc[c][j][v];
    }
    __syncthreads();
  }
  for (int i = tid; i < CT * KM * SW; i += kThreads) {
    const int c = i / (KM * SW), j = (i / SW) % KM, a = s0 + i % SW;
    if (c >= nc || j >= k || a >= p) continue;
    partial[(((long long)blockIdx.x * C + c0 + c) * p + a) * k + j] = sacc[i];
  }
}

// A warp an entry: lane l sums chunks l, l + 32, ... in float64, a fixed
// shuffle tree, one rounding, then the weight sum and the L2 term.
__global__ void softmax_finish_wide(const double* __restrict__ partial,
                                    const float* __restrict__ wsum,
                                    const float* __restrict__ l2m, const float* __restrict__ z,
                                    float* __restrict__ grad, int chunks, int C, int pk) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (i >= (long long)C * pk) return;
  double s = 0.0;
  for (int q = lane; q < chunks; q += 32) s += partial[(long long)q * C * pk + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0)
    grad[i] = __fadd_rn(__fdiv_rn(__double2float_rn(s), wsum[i / pk]), __fmul_rn(l2m[i], z[i]));
}

template <int KM, int CT>
int launch_softmax_wide(const void* X1, const void* y, const void* w, const void* fold,
                        const void* z, const void* wsum, const void* l2m, void* partial,
                        void* grad, int n, int p, int k, int C, int chunks, int chunk_rows,
                        void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int SW = 32 * kSoftSV;
  dim3 grid((unsigned)chunks, (unsigned)((C + CT - 1) / CT), (unsigned)((p + SW - 1) / SW));
  const size_t zbytes = (size_t)CT * p * KM * sizeof(float);
  softmax_partial_rows<KM, CT><<<grid, kThreads, zbytes, st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (double*)partial, n, p, k, C, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pk = p * k;
  const long long total = (long long)C * pk * 32;
  softmax_finish_wide<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
      (const double*)partial, (const float*)wsum, (const float*)l2m, (const float*)z,
      (float*)grad, chunks, C, pk);
  return (int)cudaGetLastError();
}

// ---- K-P's tiled entry (k > 8) -------------------------------------------------
constexpr int kSoftNarrowK = 8;        // up to here the register entries
constexpr int kSoftMaxK = 128;         // ops/linear.py::SOFTMAX_MAX_CLASSES
constexpr int kTileRows = 128;         // rows a tile, at most
constexpr int kOutPer = 16;            // outputs a thread
constexpr int kOutSlab = kOutPer * kThreads;
constexpr int kTiledBudget = 96 * 1024;

__global__ void __launch_bounds__(kThreads)
softmax_partial_tiled(const float* __restrict__ X1, const float* __restrict__ y,
                      const float* __restrict__ w, const int32_t* __restrict__ fold,
                      const float* __restrict__ z, double* __restrict__ partial, int n, int p,
                      int k, int C, int chunk_rows, int R) {
  extern __shared__ float tsm[];
  float* xs = tsm;           // [R][p] the tile's rows
  float* ms = xs + R * p;    // [R][k] margins, then residuals
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = blockIdx.y;
  const int pk = p * k;
  const int o0 = blockIdx.z * kOutSlab;
  const float* zc = z + (long long)c * pk;
  const float* wf = w + (long long)fold[c] * n;
  double accd[kOutPer];
#pragma unroll
  for (int q = 0; q < kOutPer; ++q) accd[q] = 0.0;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long t0 = r0; t0 < r1; t0 += R) {
    const int nr = (int)min((long long)R, r1 - t0);
    __syncthreads();  // the previous tile is read
    for (int i = tid; i < nr * p; i += kThreads) xs[i] = X1[t0 * p + i];
    __syncthreads();
    for (int i = tid; i < nr * k; i += kThreads) {
      const int r = i / k, j = i % k;
      const float* xr = xs + r * p;
      // blocks of 32 coefficients summed apart, then the blocks' sums: the
      // rounding of a 1,024-term margin grows as 32 + p / 32 terms, not p
      float m = 0.0f;
      for (int a0 = 0; a0 < p; a0 += 32) {
        float part = 0.0f;
        const int a1 = min(p, a0 + 32);
        for (int a = a0; a < a1; ++a)
          part = __fmaf_rn(xr[a], __ldg(zc + (long long)a * k + j), part);
        m = __fadd_rn(m, part);
      }
      ms[i] = m;
    }
    __syncthreads();
    for (int r = warp; r < nr; r += kWarps) {
      float* mr = ms + r * k;
      float mx = -INFINITY;
      for (int j = lane; j < k; j += 32) mx = fmaxf(mx, mr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      for (int j = lane; j < k; j += 32) mr[j] = expf(__fsub_rn(mr[j], mx));
      __syncwarp();
      float sum = 0.0f;
      if (lane == 0) {  // in class order
        sum = mr[0];
        for (int j = 1; j < k; ++j) sum = __fadd_rn(sum, mr[j]);
      }
      sum = __shfl_sync(0xffffffffu, sum, 0);
      const float wr = wf[t0 + r];
      const int label = (int)y[t0 + r];
      for (int j = lane; j < k; j += 32)
        mr[j] = __fmul_rn(wr, __fsub_rn(__fdiv_rn(mr[j], sum), j == label ? 1.0f : 0.0f));
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kOutPer; ++q) {
      const int o = o0 + q * kThreads + tid;
      if (o < pk) {
        const int a = o / k, j = o % k;
        float sacc = 0.0f;
        for (int r = 0; r < nr; ++r) sacc = __fmaf_rn(ms[r * k + j], xs[r * p + a], sacc);
        accd[q] += (double)sacc;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kOutPer; ++q) {
    const int o = o0 + q * kThreads + tid;
    if (o < pk) partial[((long long)blockIdx.x * C + c) * pk + o] = accd[q];
  }
}

int launch_softmax_tiled(const void* X1, const void* y, const void* w, const void* fold,
                         const void* z, const void* wsum, const void* l2m, void* partial,
                         void* grad, int n, int p, int k, int C, int chunks, int chunk_rows,
                         void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  static bool attr_set = false;  // the attribute takes the budget's maximum once
  if (!attr_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        softmax_partial_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize, kTiledBudget);
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  int R = kTiledBudget / ((p + k) * (int)sizeof(float));
  if (R > kTileRows) R = kTileRows;
  const int pk = p * k;
  dim3 grid((unsigned)chunks, (unsigned)C, (unsigned)((pk + kOutSlab - 1) / kOutSlab));
  softmax_partial_tiled<<<grid, kThreads, (size_t)R * (p + k) * sizeof(float), st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (double*)partial, n, p, k, C, chunk_rows, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (p > kMaxCoefs) {
    const long long total = (long long)C * pk * 32;
    softmax_finish_wide<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads, 0, st>>>(
        (const double*)partial, (const float*)wsum, (const float*)l2m, (const float*)z,
        (float*)grad, chunks, C, pk);
  } else {
    const int threads = 128;
    softmax_finish<<<(C * pk + threads - 1) / threads, threads, 0, st>>>(
        (const double*)partial, (const float*)wsum, (const float*)l2m, (const float*)z,
        (float*)grad, chunks, C, pk);
  }
  return (int)cudaGetLastError();
}

// p <= 16: tiles of 8 fits; p <= 24: tiles of 4; p <= 64: tiles of 2;
// p <= 1024: the wide entry, VPL x CT = 32 accumulators a lane (tiles of
// 8 fits at p <= 128 down to 1 fit at p <= 1024).
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
  if (p <= 128)
    return launch_wide<4, 8, LOGISTIC>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C,
                                       chunks, chunk_rows, stream);
  if (p <= 256)
    return launch_wide<8, 4, LOGISTIC>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C,
                                       chunks, chunk_rows, stream);
  if (p <= 512)
    return launch_wide<16, 2, LOGISTIC>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C,
                                        chunks, chunk_rows, stream);
  if (p <= kMaxWide)
    return launch_wide<32, 1, LOGISTIC>(X1, y, w, fold, z, wsum, l2v, partial, grad, n, p, C,
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
  if (n <= 0 || p <= 0 || p > kMaxWide || k <= 0 || k > kSoftMaxK || C <= 0 || C > 65535 ||
      chunks <= 0)
    return (int)cudaErrorInvalidValue;
  if (k > kSoftNarrowK)
    return launch_softmax_tiled(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks,
                                chunk_rows, stream);
  if (p > kMaxCoefs) {
    if (k <= 4)
      return launch_softmax_wide<4, 2>(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C,
                                       chunks, chunk_rows, stream);
    if (k <= 8)
      return launch_softmax_wide<8, 1>(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C,
                                       chunks, chunk_rows, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (k <= 4)
    return launch_softmax<4>(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks,
                             chunk_rows, stream);
  if (k <= 8)
    return launch_softmax<8>(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks,
                             chunk_rows, stream);
  return (int)cudaErrorInvalidValue;
}
