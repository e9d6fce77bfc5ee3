// The wide entries of K-P (softmax_fista_grad, k <= 8 classes) and K-T
// (svc_grad) past 64 coefficients (up to 1,024): one kernel over staged row
// tiles, the loss a template parameter.  Included by csrc/fista.cu (the
// softmax) and csrc/svc.cu (the squared hinge).
//
// Replaces: the gradients of transmogrifai_tpu/ops/linear.py::fit_softmax
// (:148) as fit_softmax_grid_folds (:432) vmaps it, and of fit_linear_svc's
// grad_fn (:254) as fit_svc_grid_folds (:466) vmaps it, for every fit c at
// once over X1 = [X, 1] f32[n, p]:
//   softmax: grad_c = X1^T (w_f(c) * (softmax(X1 B_c) - Y)) / wsum_c + l2_c * B_c,
//   hinge:   grad_c = X1^T (w_f(c) * (-2 ypm max(1 - ypm X1 z_c, 0))) / wsum_c + l2_c * z_c.
// A fit has N = k columns (k = 1 for the hinge); G fits make a group's N = G k.
//
// The launch is planned by ops/linear.py::wide_rows_plan: a block takes a
// chunk of rows and a group of G fits whose outputs [p x N] fit its threads'
// registers (32 float64 sums a thread, up to 352 threads), so the text
// flow's 6 fits of 3 classes, 2 of 8 and 12 SVC fits each take one group at
// p = 85 and 513: every staged row tile serves every fit, and no block
// recomputes margins for a slab of coefficients.  Shared memory holds the
// fits' coefficients [PP][NP] for the whole block and a row tile [R][XS]
// (each group of MR rows skewed 4 floats into other banks).  A tile's rows
// are one contiguous span of X1, 16-byte aligned where the tile starts, so
// the next tile is staged into a packed buffer by 16-byte cp.async (the rows
// of X1 are not 16-byte aligned at p = 85 or 513, and 4-byte copies of each
// row take four times the copies), in flight during this tile's work, with
// each row's label and its fits' fold weights beside it; a tile starts by
// copying its packed rows into the strided ones.  Per tile:
//   1. the margins [R x N]: a thread an (MR x 4 micro-tile, 32-coefficient
//      block) item, float4 loads of MR rows against four coefficient rows,
//      4 MR float32 FMA chains written apart per block (thin N has few
//      micro-tiles; the blocks give every thread work);
//   2. a thread a (row, fit): the margins' blocks added in order (the
//      rounding of K-P's tiled entry), then the softmax over k <= 8 classes
//      in registers (the max, libdevice's expf(m - max), the sum in class
//      order, the weighted residuals) or the hinge and its residual, written
//      over the first block;
//   3. the gradient [p x N] += rows^T . residuals: a thread owns 8 x 4
//      outputs for the whole chunk (two 4 x 4 micro-tiles, or one 8 x 4),
//      each over a split of the tile's rows (S splits where the outputs are
//      few), a float32 sum over the split's rows of the tile added into
//      float64.
// At the chunk's end the splits' float64 sums are added in split order in
// shared memory, in the order of the chunk's partial [C][p][k] (a thread's
// micro-tile is scattered over its fits and classes), which is then written
// out coalesced; a second launch (wide_rows_finish) sums the chunks in a
// fixed order, each warp's loads coalesced.  No atomics: runs repeat bit for
// bit.
//
// Bound on the card: X1's bytes at p = 85 (44.6 MB at 2^17 rows), float32
// FMA work near it at p = 513 (2 p N products a row).  A float4 load from
// shared memory takes four of its cycles a warp, so a 4 x 4 micro-tile (two
// loads a 16 FMAs) leaves the FMA pipe half idle; where the outputs are many
// (MR = 8: p = 513 at k = 3 and 8) the micro-tiles are 8 x 4 (three loads a
// 32 FMAs), one block an SM, else 4 x 4 at two blocks an SM.
// ptxas (sm_90a): MR = 4 128 registers (two blocks an SM), 24 bytes of spill
// stores; MR = 8 168 registers, no spill (hinge) or 12 bytes (softmax);
// wide_rows_finish 32 registers.
#pragma once
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace wide_rows {
namespace {  // internal linkage: fista.cu and svc.cu each include it

constexpr int kLossSoftmax = 0;
constexpr int kLossHinge = 1;
constexpr int kOutputs = 32;       // float64 output sums a thread
constexpr int kMarginBlock = 32;   // coefficients of a margin's float32 block
constexpr int kMaxClasses = 8;
constexpr int kMaxCoefs = 1024;
constexpr int kMaxFits = 256;      // fits a group (ops/linear.py::_WIDE_MAX_FITS)
constexpr int kSmemMax = 232448;

// threads a block at most, by the micro-tile's rows (ops/linear.py::
// _WIDE_THREADS): two blocks an SM at MR = 4 (128 registers a thread), one
// at MR = 8
__host__ __device__ constexpr int max_threads(int MR) { return MR == 4 ? 256 : 352; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// p rounded up to the micro-tile's rows; a staged row's stride, that rounded
// up to 32 floats (a bank row); a row tile's floats, with room for the rows'
// skew: row r starts at r XS + skew(r), 4 more floats a micro-tile row group,
// so that the float4 loads of the row groups a quarter-warp reads (up to 8
// groups) fall in other banks.
__host__ __device__ inline int padded(int p, int MR) { return (p + MR - 1) / MR * MR; }
__host__ __device__ inline int row_stride(int p, int MR) { return (padded(p, MR) + 31) / 32 * 32; }
__host__ __device__ inline int tile_floats(int p, int MR, int R) {
  return R * row_stride(p, MR) + 4 * (R / MR);
}
template <int MR>
__device__ __forceinline__ int skew(int r) { return 4 * (r / MR); }

// The dynamic shared bytes of a block (ops/linear.py::wide_rows_smem).
inline long long smem_bytes(int p, int k, int G, int R, int MR) {
  const long long PP = padded(p, MR), NP = (G * k + 3) & ~3;
  const long long nb = (p + kMarginBlock - 1) / kMarginBlock;
  const long long b = 4LL * (tile_floats(p, MR, R) + (R * p + 3LL) / 4 * 4 + PP * NP +
                             nb * R * NP + 2LL * (G + 1) * R);
  return b > 8 * PP * NP ? b : 8 * PP * NP;
}

// One block: row chunk blockIdx.x, the fits of group blockIdx.y; blockDim.x
// threads.  Shared: xs [R][XS] (rows skewed), xp [R p] (the next tile,
// packed), zs [PP][NP], mp [nb][R][NP] (the margins' blocks; the first also
// the residuals), ybuf [2][G + 1][R] (labels, then each fit's weights); at
// the end the chunk's partial of the group [nc][p][k] (float64) over its
// start.
template <int LOSS, int MR>
__global__ void __launch_bounds__(max_threads(MR), MR == 4 ? 2 : 1)
wide_rows_partial(const float* __restrict__ X1, const float* __restrict__ y,
                  const float* __restrict__ w, const int32_t* __restrict__ fold,
                  const float* __restrict__ z, double* __restrict__ partial, int n, int p, int k,
                  int C, int chunk_rows, int G, int R, int S) {
  constexpr int Q = kOutputs / (MR * 4);  // output micro-tiles a thread
  constexpr int E = MR * 4;               // entries of a micro-tile
  extern __shared__ __align__(16) float smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32, nwarps = T / 32;
  const int PP = padded(p, MR), XS = row_stride(p, MR), NP = (G * k + 3) & ~3;
  const int XB = tile_floats(p, MR, R);
  const int nb = (p + kMarginBlock - 1) / kMarginBlock;
  __shared__ int fs[kMaxFits];  // the group's folds
  float* xs = smem;
  float* xp = xs + XB;
  float* zs = xp + (R * p + 3) / 4 * 4;
  float* mp = zs + PP * NP;
  float* ybuf = mp + nb * R * NP;
  const int c0 = blockIdx.y * G;
  const int nc = min(G, C - c0);
  const int N = nc * k;
  const int NCG = NP / 4;
  const int MT = (R / MR) * NCG;   // margin micro-tiles of a tile
  const int MC = (PP / MR) * NCG;  // output micro-tiles
  const int RS = (R + S - 1) / S;  // rows of a split
  const long long pk = (long long)p * k;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int ntiles = r1 > r0 ? (int)((r1 - r0 + R - 1) / R) : 0;
  // the fits' coefficients, a lane a column (zero past the group's columns
  // and past p), in the first tile's copy group
  for (int col = lane; col < NP; col += 32) {
    const long long base = col < N ? (c0 + col / k) * pk + col % k : 0;
    for (int a = warp; a < PP; a += nwarps)
      cp_async4(zs + a * NP + col, a < p && col < N ? z + base + (long long)a * k : z,
                a < p && col < N);
  }
  // tile t's rows, packed, by 16-byte copies (the span starts at a row that
  // is a multiple of 4: 16-byte aligned), its last floats by 4-byte ones
  auto stage = [&](int t) {
    const long long t0 = r0 + (long long)t * R;
    const int nr = (int)min((long long)R, r1 - t0);
    const float* src = X1 + t0 * p;
    const int L = nr * p;
    for (int i = tid; i < L / 4; i += T) cp_async16(xp + 4 * i, src + 4 * i);
    for (int i = L / 4 * 4 + tid; i < L; i += T) cp_async4(xp + i, src + i, true);
    float* yb = ybuf + (t & 1) * (G + 1) * R;
    for (int g = warp - 1; g < nc; g += nwarps) {
      const float* src = g < 0 ? y + t0 : w + (long long)fs[g] * n + t0;
      for (int r = lane; r < R; r += 32)
        cp_async4(yb + (g + 1) * R + r, r < nr ? src + r : y, r < nr);
    }
    cp_async_commit();
  };
  for (int g = tid; g < nc; g += T) fs[g] = fold[c0 + g];
  __syncthreads();
  if (ntiles > 0) stage(0);
  double acc[Q][E];
#pragma unroll
  for (int q = 0; q < Q; ++q)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[q][e] = 0.0;
  for (int t = 0; t < ntiles; ++t) {
    const int nr = (int)min((long long)R, r1 - (r0 + (long long)t * R));
    cp_async_wait_all();
    __syncthreads();  // tile t staged (and zs); tile t - 1's reads are done
    // the packed rows into the strided ones, a warp a row, four loads in
    // flight a lane; rows past the chunk are not copied (nothing reads
    // them), columns p .. PP - 1 are zero (they enter the last margin
    // block's chains)
    for (int r = warp; r < nr; r += nwarps) {
      float* dst = xs + r * XS + skew<MR>(r);
      const float* row = xp + r * p;
      for (int a0 = lane; a0 < PP; a0 += 128) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) v[u] = a0 + 32 * u < p ? row[a0 + 32 * u] : 0.0f;
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (a0 + 32 * u < PP) dst[a0 + 32 * u] = v[u];
      }
    }
    __syncthreads();  // the strided tile is whole; the packed buffer is free
    if (t + 1 < ntiles) stage(t + 1);
    const float* yb = ybuf + (t & 1) * (G + 1) * R;
    // 1. the margins' 32-coefficient blocks, a thread a (micro-tile, block)
    for (int it = tid; it < nb * MT; it += T) {
      const int b = it / MT, mt = it - b * MT;
      const int rr = (mt / NCG) * MR, cc = (mt % NCG) * 4;
      if (rr >= nr) continue;
      const int a0 = b * kMarginBlock, len = min(kMarginBlock, PP - a0);
      const float* xr = xs + rr * XS + skew<MR>(rr) + a0;
      const float* zc = zs + a0 * NP + cc;
      float part[E];
#pragma unroll
      for (int e = 0; e < E; ++e) part[e] = 0.0f;
#pragma unroll 2
      for (int a = 0; a < len; a += 4) {
        float zr[4][4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float4 zv = *reinterpret_cast<const float4*>(zc + (a + s) * NP);
          zr[s][0] = zv.x, zr[s][1] = zv.y, zr[s][2] = zv.z, zr[s][3] = zv.w;
        }
#pragma unroll
        for (int i = 0; i < MR; ++i) {
          const float4 xv = *reinterpret_cast<const float4*>(xr + i * XS + a);
          const float x[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int s = 0; s < 4; ++s)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              part[i * 4 + j] = __fmaf_rn(x[s], zr[s][j], part[i * 4 + j]);
        }
      }
      float* out = mp + (b * R + rr) * NP + cc;
#pragma unroll
      for (int i = 0; i < MR; ++i)
        *reinterpret_cast<float4*>(out + i * NP) =
            make_float4(part[i * 4], part[i * 4 + 1], part[i * 4 + 2], part[i * 4 + 3]);
    }
    __syncthreads();
    // 2. a thread a (row, fit): its margins, the loss, the weighted residuals
    for (int it = tid; it < nr * nc; it += T) {
      const int r = it / nc, g = it - r * nc;
      float* mr = mp + r * NP + g * k;
      const float wr = yb[(g + 1) * R + r], yr = yb[r];
      if (LOSS == kLossSoftmax) {
        float m[kMaxClasses];
#pragma unroll
        for (int j = 0; j < kMaxClasses; ++j) m[j] = j < k ? mr[j] : 0.0f;
        for (int b = 1; b < nb; ++b) {  // the blocks in order, the classes side by side
          const float* mb = mr + b * R * NP;
#pragma unroll
          for (int j = 0; j < kMaxClasses; ++j)
            if (j < k) m[j] = __fadd_rn(m[j], mb[j]);
        }
        float mx = m[0];
#pragma unroll
        for (int j = 1; j < kMaxClasses; ++j)
          if (j < k) mx = fmaxf(mx, m[j]);
        float e[kMaxClasses];
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < kMaxClasses; ++j) {
          e[j] = j < k ? expf(__fsub_rn(m[j], mx)) : 0.0f;
          if (j < k) sum = j == 0 ? e[0] : __fadd_rn(sum, e[j]);
        }
        const int label = (int)yr;
#pragma unroll
        for (int j = 0; j < kMaxClasses; ++j)
          if (j < k)
            mr[j] = __fmul_rn(wr, __fsub_rn(__fdiv_rn(e[j], sum), j == label ? 1.0f : 0.0f));
      } else {
        float m = mr[0];
        for (int b = 1; b < nb; ++b) m = __fadd_rn(m, mr[b * R * NP]);
        const float ypm = __fsub_rn(__fmul_rn(2.0f, yr), 1.0f);
        const float active = fmaxf(__fsub_rn(1.0f, __fmul_rn(ypm, m)), 0.0f);
        mr[0] = __fmul_rn(wr, __fmul_rn(__fmul_rn(-2.0f, ypm), active));
      }
    }
    __syncthreads();
    // 3. the gradient: a thread's output micro-tiles over its split's rows,
    //    float32 over the tile, added into float64
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int it = tid + q * T;
      if (it < MC * S) {
        const int s = it / MC, mc = it - s * MC;
        const int aa = (mc / NCG) * MR, cc = (mc % NCG) * 4;
        const int lo = s * RS, hi = min(lo + RS, nr);
        float part[E];
#pragma unroll
        for (int e = 0; e < E; ++e) part[e] = 0.0f;
#pragma unroll 4
        for (int r = lo; r < hi; ++r) {
          const float4 rv = *reinterpret_cast<const float4*>(mp + r * NP + cc);
          const float ra[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
          for (int h = 0; h < MR / 4; ++h) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xs + r * XS + skew<MR>(r) + aa + 4 * h);
            const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                part[(4 * h + i) * 4 + j] = __fmaf_rn(ra[j], xa[i], part[(4 * h + i) * 4 + j]);
          }
        }
#pragma unroll
        for (int e = 0; e < E; ++e) acc[q][e] += (double)part[e];
      }
    }
  }
  // the chunk's partial of the group, [nc][p][k] in the partial's order,
  // gathered in shared memory (the splits' sums added in split order; the
  // row tiles' space reused), then written out coalesced
  double* red = reinterpret_cast<double*>(smem);
  __syncthreads();
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int it = tid + q * T;
      if (it < MC * S && it / MC == s) {
        const int mc = it - s * MC, aa = (mc / NCG) * MR, cc = (mc % NCG) * 4;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const int a = aa + e / 4, col = cc + e % 4;
          if (a < p && col < N) {
            double* dst = red + ((col / k) * p + a) * k + col % k;
            *dst = s == 0 ? acc[q][e] : *dst + acc[q][e];
          }
        }
      }
    }
    __syncthreads();
  }
  double* out = partial + ((long long)blockIdx.x * C + c0) * pk;
  for (int i = tid; i < N * p; i += T) out[i] = red[i];
}

template <int LOSS, int MR>
int launch_mr(const void* X1, const void* y, const void* w, const void* fold, const void* z,
              void* partial, int n, int p, int k, int C, int chunks, int chunk_rows, int G, int R,
              int S, int T, int smem, cudaStream_t st) {
  static int attr_bytes = 0;  // the attribute raised to the largest request so far
  if (smem > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        wide_rows_partial<LOSS, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr_bytes = smem;
  }
  dim3 grid((unsigned)chunks, (unsigned)((C + G - 1) / G));
  wide_rows_partial<LOSS, MR><<<grid, T, (size_t)smem, st>>>(
      (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold, (const float*)z,
      (double*)partial, n, p, k, C, chunk_rows, G, R, S);
  return (int)cudaGetLastError();
}

// The chunks' float64 partials summed in a fixed order and rounded once, then
// divided by the fit's weight sum, plus the L2 term: a block takes 32
// consecutive entries, its warp l the chunks l, l + 16, ... (each warp's
// loads coalesced), and the 16 warps' sums are added in warp order.
constexpr int kFinishSplits = 16;
__global__ void __launch_bounds__(32 * kFinishSplits)
wide_rows_finish(const double* __restrict__ partial, const float* __restrict__ wsum,
                 const float* __restrict__ l2m, const float* __restrict__ z,
                 float* __restrict__ grad, int chunks, long long total, int pk) {
  __shared__ double red[kFinishSplits][32];
  const int e = threadIdx.x % 32, l = threadIdx.x / 32;
  const long long i = (long long)blockIdx.x * 32 + e;
  double s = 0.0;
  if (i < total)
    for (int q = l; q < chunks; q += kFinishSplits) s += partial[(long long)q * total + i];
  red[l][e] = s;
  __syncthreads();
  if (l == 0 && i < total) {
    double t = red[0][e];
    for (int j = 1; j < kFinishSplits; ++j) t += red[j][e];
    grad[i] = __fadd_rn(__fdiv_rn(__double2float_rn(t), wsum[i / pk]), __fmul_rn(l2m[i], z[i]));
  }
}

// K-P's or K-T's wide entry, by the plan of ops/linear.py::wide_rows_plan (G
// fits a block, R rows a tile, S row splits, T threads, MR rows of a
// micro-tile, smem bytes): the chunks' partials [chunks][C][p][k], then their
// sum into grad.  Returns a CUDA error code.
template <int LOSS>
int launch(const void* X1, const void* y, const void* w, const void* fold, const void* z,
           const void* wsum, const void* l2m, void* partial, void* grad, int n, int p, int k,
           int C, int chunks, int chunk_rows, int G, int R, int S, int T, int MR, int smem,
           cudaStream_t st) {
  if (MR != 4 && MR != 8) return (int)cudaErrorInvalidValue;
  const long long MC = (long long)(padded(p, MR) / MR) * (((G * k + 3) & ~3) / 4);
  if (n <= 0 || p <= 0 || p > kMaxCoefs || k <= 0 || k > kMaxClasses || (uintptr_t)X1 % 16 ||
      (LOSS == kLossHinge && k != 1) || C <= 0 || C > 65535 || chunks <= 0 || chunk_rows <= 0 ||
      G <= 0 || G > C || G > kMaxFits || R < MR || R % MR || chunk_rows % R || S < 1 || S > R ||
      T < 32 || T > max_threads(MR) || T % 32 || MC * S > (long long)(kOutputs / (MR * 4)) * T ||
      (long long)chunks * chunk_rows < n || (long long)(chunks - 1) * chunk_rows >= n ||
      smem <= 0 || smem > kSmemMax - 4 * kMaxFits ||
      (long long)smem != smem_bytes(p, k, G, R, MR))
    return (int)cudaErrorInvalidValue;
  const int rc = MR == 4 ? launch_mr<LOSS, 4>(X1, y, w, fold, z, partial, n, p, k, C, chunks,
                                              chunk_rows, G, R, S, T, smem, st)
                         : launch_mr<LOSS, 8>(X1, y, w, fold, z, partial, n, p, k, C, chunks,
                                              chunk_rows, G, R, S, T, smem, st);
  if (rc != 0) return rc;
  const long long total = (long long)C * p * k;
  wide_rows_finish<<<(unsigned)((total + 31) / 32), 32 * kFinishSplits, 0, st>>>(
      (const double*)partial, (const float*)wsum, (const float*)l2m, (const float*)z,
      (float*)grad, chunks, total, p * k);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace wide_rows
