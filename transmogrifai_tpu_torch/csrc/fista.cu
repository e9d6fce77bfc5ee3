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
// Above 64 coefficients (up to 1,024) K-P takes its wide entry at k <= 8
// (wide_rows_partial in csrc/wide_rows.cuh, shared with K-T), planned by
// ops/linear.py::wide_rows_plan: a block takes a chunk of rows and a group
// of fits whose whole gradient [p x G k] its threads hold (every fit of the
// text flow's calls), over row tiles staged once for the group; register-
// blocked float32 margins in 32-coefficient blocks, a thread a (row, fit)'s
// softmax, the gradient in float32 a tile and float64 across tiles; its
// finish (wide_rows_finish) sums the chunks.
//
// Above 8 classes (up to 128, at any p up to 1,024) a thread can hold
// neither a row's k margins nor 16 x k accumulators, so K-P takes its tiled
// entry (softmax_partial_tiled), planned by ops/linear.py::
// softmax_tiled_plan: a block takes a chunk of rows, a group of G fits (their
// N = G k columns; 8 fits at the Letter train's k = 26, p = 33) and a slab
// of output coefficient rows (all of them up to 8,192 outputs a block).  The
// fits' coefficients sit in shared memory for the whole block ([p][N]), or,
// where they do not fit, are streamed 32 coefficients at a time.  Row tiles
// of R (up to 64) rows are staged by cp.async into two buffers, the next
// tile's copies in flight during this tile's work, once for all G fits.  Per
// tile:
//   1. the margins [R x N] = rows . coefficients, a thread a 4 x 4 float32
//      micro-tile (four rows' values against a float4 of coefficients from
//      shared memory); each margin's float32 FMA blocks of 32 coefficients
//      summed apart, then added in order (the rounding of a 1,024-term margin
//      grows as 32 + p / 32 terms, not p), the order of the design before;
//   2. the softmax of each (row, fit) across S lanes, the fewest (2 to 32)
//      that leave a lane at most 8 classes (S = 4 at k = 26, 8 at 64): lane
//      l takes classes l, l + S, ...; the max by an xor butterfly; exp(m -
//      max) (libdevice's expf); the class sum as each lane's classes in
//      order, then xor butterflies at offsets S / 2, ..., 1 (every lane gets
//      the same sum); the weighted residuals in place, with the labels and
//      weights staged beside the row tile;
//   3. the gradient [p x N] += rows^T . residuals, a thread two 4 x 4 output
//      micro-tiles (a float4 of the row and one of the residuals a step, 16
//      FMAs), a float32 sum over the tile's rows added into float64.
// The chunks' float64 partials are summed as the other entries'
// (softmax_finish, softmax_finish_wide).  The margins and residuals never
// leave shared memory.
// Bound on the card: float32 operations, 4 p k a (fit, row) over the 67
// TFLOP/s of the FMA pipe (TF32 tensor cores keep too few digits for the
// 1e-6 tolerance of its card checks).  X1 is read once a fit group, each
// shared load of the products feeds four FMAs, and the softmax keeps every
// lane of a warp busy.
// ptxas (CUDA 12.9, sm_90a): softmax_partial_tiled 128 registers (launch
// bounds for two blocks an SM), 144 bytes of spill stores and loads; its
// dynamic shared memory is the plan's (103,744 bytes at k = 26, p = 33).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wide_rows.cuh"

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


// ---- K-P's tiled entry's finish past 64 coefficients (its wide entry, k <= 8,
// is csrc/wide_rows.cuh with its own) --------------------------------------------

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

// ---- K-P's tiled entry (k > 8) -------------------------------------------------
constexpr int kSoftNarrowK = 8;        // up to here the register entries
constexpr int kSoftMaxK = 128;         // ops/linear.py::SOFTMAX_MAX_CLASSES
constexpr int kOutTiles = 2;           // 4 x 4 output micro-tiles a thread (_SOFTMAX_BLOCK_OUTPUTS)
constexpr int kMarginBlock = 32;       // coefficients of a margin's float32 block
constexpr int kLaneClasses = 8;        // classes a lane of a row's softmax, at most
constexpr int kSmemMax = 232448;       // the most dynamic shared memory a block takes

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// m[i][j] += the float32 FMA chain over len coefficients of rows xr + i ld
// against columns zc[a NP + j] (a 4 x 4 micro-tile of margins).
__device__ __forceinline__ void margin_block(const float* __restrict__ xr, int ld,
                                             const float* __restrict__ zc, int NP, int len,
                                             float (&m)[16]) {
  float part[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) part[q] = 0.0f;
#pragma unroll 4
  for (int a = 0; a < len; ++a) {
    const float4 zv = *reinterpret_cast<const float4*>(zc + a * NP);
    const float zr[4] = {zv.x, zv.y, zv.z, zv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x = xr[i * ld + a];
#pragma unroll
      for (int j = 0; j < 4; ++j) part[i * 4 + j] = __fmaf_rn(x, zr[j], part[i * 4 + j]);
    }
  }
#pragma unroll
  for (int q = 0; q < 16; ++q) m[q] = __fadd_rn(m[q], part[q]);
}

// One block: row chunk blockIdx.x, the G fits of group blockIdx.y (their
// N = G k columns, padded to NP), the output coefficient rows [PA z, PA z +
// PA) of blockIdx.z.  Shared: the row tiles [2][R][PP] (cp.async, double
// buffered), the fits' coefficients zs ([p][NP] resident, or [32][NP] a
// block of coefficients at a time), the margins / residuals ms [R][NP], and
// with each row tile its labels and each fit's weights, [2][(G + 1) R].
__global__ void __launch_bounds__(kThreads, 2)
softmax_partial_tiled(const float* __restrict__ X1, const float* __restrict__ y,
                      const float* __restrict__ w, const int32_t* __restrict__ fold,
                      const float* __restrict__ z, double* __restrict__ partial, int n, int p,
                      int k, int C, int chunk_rows, int G, int R, int PA, int zres) {
  extern __shared__ __align__(16) float tsm[];
  const int PP = (p + 3) & ~3;
  const int NP = (G * k + 3) & ~3;
  float* xbuf = tsm;                          // [2][R][PP]
  float* zs = xbuf + 2 * R * PP;              // [zres ? p : 32][NP]
  float* ms = zs + (zres ? p : kMarginBlock) * NP;  // [R][NP]
  float* ybuf = ms + R * NP;                         // [2][G + 1][R]: y, then w of each fit
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.y * G;
  const int nc = min(G, C - c0);
  const int N = nc * k;
  const int oa0 = blockIdx.z * PA;
  const int NCG = NP / 4;
  const int MA = (R / 4) * NCG;                        // margin micro-tiles
  const int MC = (min(PA, PP - oa0) / 4) * NCG;        // output micro-tiles
  const long long pk = (long long)p * k;
  if (zres)
    for (int i = tid; i < p * NP; i += kThreads) {
      const int a = i / NP, col = i % NP;
      zs[i] = col < N ? z[(long long)(c0 + col / k) * pk + (long long)a * k + col % k] : 0.0f;
    }
  double acc[kOutTiles][16];
#pragma unroll
  for (int q = 0; q < kOutTiles; ++q)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[q][e] = 0.0;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int ntiles = (int)((r1 - r0 + R - 1) / R);
  // rows past the chunk are zero-filled; columns p .. PP - 1 stay unset
  // (they meet only the padded outputs, which are not written)
  auto stage = [&](int t) {
    float* buf = xbuf + (t & 1) * R * PP;
    const long long t0 = r0 + (long long)t * R;
    const int nr = (int)min((long long)R, r1 - t0);
    for (int i = tid; i < R * p; i += kThreads) {
      const int r = i / p, a = i % p;
      cp_async4(buf + r * PP + a, r < nr ? X1 + (t0 + r) * p + a : X1, r < nr);
    }
    float* yb = ybuf + (t & 1) * (G + 1) * R;
    for (int i = tid; i < (nc + 1) * R; i += kThreads) {
      const int g = i / R - 1, r = i % R;
      const float* src = g < 0 ? y + t0 + r : w + (long long)fold[c0 + g] * n + t0 + r;
      cp_async4(yb + i, r < nr ? src : y, r < nr);
    }
    cp_async_commit();
  };
  // lanes a (row, fit)'s softmax: the fewest (a power of two, at least 2)
  // that leave a lane at most kLaneClasses classes
  int S = 2;
  while (S * kLaneClasses < k) S *= 2;
  const int li = lane % S;
  stage(0);
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t staged (and zs); tile t - 1's reads are done
    if (t + 1 < ntiles) stage(t + 1);
    const float* xs = xbuf + (t & 1) * R * PP;
    const long long t0 = r0 + (long long)t * R;
    const int nr = (int)min((long long)R, r1 - t0);
    // 1. margins ms = xs . zs: a thread a 4 x 4 micro-tile; each margin's
    //    float32 blocks of 32 coefficients summed apart, then added in order
    if (zres) {
      for (int mt = tid; mt < MA; mt += kThreads) {
        const int rr = (mt / NCG) * 4, cc = (mt % NCG) * 4;
        float m[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) m[q] = 0.0f;
        for (int a0 = 0; a0 < p; a0 += kMarginBlock)
          margin_block(xs + rr * PP + a0, PP, zs + a0 * NP + cc, NP,
                       min(kMarginBlock, p - a0), m);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float4*>(ms + (rr + i) * NP + cc) =
              make_float4(m[i * 4], m[i * 4 + 1], m[i * 4 + 2], m[i * 4 + 3]);
      }
    } else {
      for (int a0 = 0; a0 < p; a0 += kMarginBlock) {
        const int len = min(kMarginBlock, p - a0);
        __syncthreads();  // the previous block of coefficients is read
        for (int i = tid; i < len * NP; i += kThreads) {
          const int a = a0 + i / NP, col = i % NP;
          zs[i] = col < N ? z[(long long)(c0 + col / k) * pk + (long long)a * k + col % k]
                          : 0.0f;
        }
        __syncthreads();
        for (int mt = tid; mt < MA; mt += kThreads) {
          const int rr = (mt / NCG) * 4, cc = (mt % NCG) * 4;
          float m[16];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 v = a0 == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                                     : *reinterpret_cast<const float4*>(ms + (rr + i) * NP + cc);
            m[i * 4] = v.x, m[i * 4 + 1] = v.y, m[i * 4 + 2] = v.z, m[i * 4 + 3] = v.w;
          }
          margin_block(xs + rr * PP + a0, PP, zs + cc, NP, len, m);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(ms + (rr + i) * NP + cc) =
                make_float4(m[i * 4], m[i * 4 + 1], m[i * 4 + 2], m[i * 4 + 3]);
        }
      }
    }
    __syncthreads();
    // 2. the softmax of each (row, fit) across S lanes (2 to 32): lane l
    //    takes classes l, l + S, ... (up to 8); the max by an xor butterfly;
    //    the class sum as each lane's classes in order, then xor butterflies
    //    at offsets S / 2, ..., 1 (every lane of the row gets the same sum);
    //    the weighted residuals in place
    const float* yb = ybuf + (t & 1) * (G + 1) * R;
    const int nseg = nr * nc;
    for (int base = warp * (32 / S); base < nseg; base += kWarps * (32 / S)) {
      const int seg = base + lane / S;
      const bool active = seg < nseg;
      const int r = active ? seg / nc : 0, g = active ? seg % nc : 0;
      float* mr = ms + r * NP + g * k;
      float e[kLaneClasses];
      float mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < kLaneClasses; ++q) {
        const int j = li + S * q;
        e[q] = active && j < k ? mr[j] : -INFINITY;
        mx = fmaxf(mx, e[q]);
      }
      for (int off = S / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, S));
#pragma unroll
      for (int q = 0; q < kLaneClasses; ++q)
        e[q] = active && li + S * q < k ? expf(__fsub_rn(e[q], mx)) : 0.0f;
      float sum = e[0];
#pragma unroll
      for (int q = 1; q < kLaneClasses; ++q) sum = __fadd_rn(sum, e[q]);
      for (int off = S / 2; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off, S));
      if (active) {
        const float wr = yb[(g + 1) * R + r];
        const int label = (int)yb[r];
#pragma unroll
        for (int q = 0; q < kLaneClasses; ++q) {
          const int j = li + S * q;
          if (j < k)
            mr[j] = __fmul_rn(wr, __fsub_rn(__fdiv_rn(e[q], sum), j == label ? 1.0f : 0.0f));
        }
      }
    }
    __syncthreads();
    // 3. the gradient: a thread's 4 x 4 output micro-tiles, residual x row
    //    over the tile's rows in float32, added into float64
#pragma unroll
    for (int q = 0; q < kOutTiles; ++q) {
      const int mc = tid + q * kThreads;
      if (mc < MC) {
        const int aa = oa0 + (mc / NCG) * 4, cc = (mc % NCG) * 4;
        float part[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) part[e] = 0.0f;
#pragma unroll 4
        for (int r = 0; r < nr; ++r) {
          const float4 xv = *reinterpret_cast<const float4*>(xs + r * PP + aa);
          const float4 rv = *reinterpret_cast<const float4*>(ms + r * NP + cc);
          const float xa[4] = {xv.x, xv.y, xv.z, xv.w}, ra[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) part[i * 4 + j] = __fmaf_rn(ra[j], xa[i], part[i * 4 + j]);
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[q][e] += (double)part[e];
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kOutTiles; ++q) {
    const int mc = tid + q * kThreads;
    if (mc >= MC) continue;
    const int aa = oa0 + (mc / NCG) * 4, cc = (mc % NCG) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int a = aa + i, col = cc + j;
        if (a < p && col < N)
          partial[((long long)blockIdx.x * C + c0 + col / k) * pk + (long long)a * k + col % k] =
              acc[q][i * 4 + j];
      }
  }
}

// K-P past 8 classes, by the plan of ops/linear.py::softmax_tiled_plan: G
// fits a block, R rows a tile, PA output coefficient rows a block, the fits'
// coefficients resident in shared memory (zres) or streamed, smem bytes.
int launch_softmax_tiled(const void* X1, const void* y, const void* w, const void* fold,
                         const void* z, const void* wsum, const void* l2m, void* partial,
                         void* grad, int n, int p, int k, int C, int chunks, int chunk_rows,
                         int G, int R, int PA, int zres, int smem, void* stream) {
  const int PP = (p + 3) & ~3, NP = (G * k + 3) & ~3;
  if (n <= 0 || p <= 0 || p > kMaxWide || k <= kSoftNarrowK || k > kSoftMaxK || C <= 0 ||
      C > 65535 || chunks <= 0 || chunk_rows <= 0 || G <= 0 || G > C || R < 4 || R % 4 ||
      PA < 4 || PA % 4 || (PA / 4) * (NP / 4) > kOutTiles * kThreads || smem <= 0 ||
      smem > kSmemMax ||
      (long long)smem != 4LL * (2LL * R * PP + (zres ? p : kMarginBlock) * (long long)NP +
                                (long long)R * NP + 2LL * (G + 1) * R))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static int attr_bytes = 0;  // the attribute raised to the largest request so far
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        softmax_partial_tiled, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  dim3 grid((unsigned)chunks, (unsigned)((C + G - 1) / G), (unsigned)((PP + PA - 1) / PA));
  softmax_partial_tiled<<<grid, kThreads, (size_t)smem, st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (double*)partial, n, p, k, C, chunk_rows, G, R, PA, zres);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int pk = p * k;
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
  if (k > kSoftNarrowK) return (int)cudaErrorInvalidValue;  // softmax_fista_grad_tiled
  if (p > kMaxCoefs) return (int)cudaErrorInvalidValue;     // softmax_fista_grad_wide
  if (k <= 4)
    return launch_softmax<4>(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks,
                             chunk_rows, stream);
  if (k <= 8)
    return launch_softmax<8>(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks,
                             chunk_rows, stream);
  return (int)cudaErrorInvalidValue;
}

// K-P at k <= 8 past 64 coefficients, by the plan of ops/linear.py::
// wide_rows_plan: G fits a block, R rows a tile, S row splits, T threads,
// MR rows of a micro-tile, smem bytes.
extern "C" int softmax_fista_grad_wide(const void* X1, const void* y, const void* w,
                                       const void* fold, const void* z, const void* wsum,
                                       const void* l2m, void* partial, void* grad, int n, int p,
                                       int k, int C, int chunks, int chunk_rows, int G, int R,
                                       int S, int T, int MR, int smem, void* stream) {
  return wide_rows::launch<wide_rows::kLossSoftmax>(
      X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks, chunk_rows, G, R, S, T,
      MR, smem, (cudaStream_t)stream);
}

extern "C" int softmax_fista_grad_tiled(const void* X1, const void* y, const void* w,
                                        const void* fold, const void* z, const void* wsum,
                                        const void* l2m, void* partial, void* grad, int n, int p,
                                        int k, int C, int chunks, int chunk_rows, int G, int R,
                                        int PA, int zres, int smem, void* stream) {
  return launch_softmax_tiled(X1, y, w, fold, z, wsum, l2m, partial, grad, n, p, k, C, chunks,
                              chunk_rows, G, R, PA, zres, smem, stream);
}
