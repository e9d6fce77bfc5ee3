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
// Mass mode: the columns are tiled.  A block takes a chunk of rows, a tile
// of TJ columns of [X | 1] (the ones column gives the class masses) and a
// group of FG folds, with RG row groups of TJ threads: a thread owns one
// column in one row group and walks the group's rows of the chunk (r = rg,
// rg + RG, ...), reading each value once and adding w[f, r] x to the float64
// sum of the row's class for each fold of the group in shared memory (a row
// adds to one class only, so a thread touches FG k sums it alone owns; a
// float32 times a float32 is exact in float64).  The row groups' sums are
// added in group order and written as the block's partial [chunk, F, k,
// d + 1]: the partials are cut by column tiles, so no block holds more than
// FG k TJ sums a group.  nb_mass_finish sums the chunks in chunk order and
// rounds once: runs repeat bit for bit, and each mass is within a rounding of
// the exact sum (the reference's float32 sums of the real columns differ from
// it in the last bits).
//
// Score mode: a tiled GEMM, [rows x d] x [d x (table sets x k)], 64 rows
// x 64 outputs a block, a thread a 4 x 4 tile of float64 dot products over
// features staged 32 at a time in shared memory (the table tiles as
// float64): each dot product summed in feature order and rounded once,
// then added to pi in float32 in the reference's order.  At up to 8
// classes (Titanic, the bag of words) a thread streams its row instead
// (nb_score_stream): no staging, no barriers, the same sums.
//
// Limits: d <= 65,536, k <= 128 (the wrapper raises ValueError beyond).
//
// Bound on the card: bytes.  Mass mode reads X once per fold (n d floats)
// with the fold's weights and the labels; score mode reads X once per table
// set (L2 shares it between the class groups and table sets in flight) and
// writes z (k floats a row and set).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFeatures = 65536;
constexpr int kMaxClasses = 128;
constexpr int kFeatTile = 32;
constexpr int kXStride = kFeatTile + 1;

__global__ void __launch_bounds__(kThreads)
nb_mass(const float* __restrict__ X, const float* __restrict__ y, const float* __restrict__ w,
        double* __restrict__ partial, int n, int d, int k, int F, int FG, int chunk_rows, int TJ,
        int RG) {
  extern __shared__ double acc[];                   // [RG, FG, k, TJ]
  const int tid = threadIdx.x;
  const int f0 = blockIdx.z * FG, fg = min(FG, F - f0);
  const int rg = tid / TJ, jl = tid % TJ;
  const int col = blockIdx.y * TJ + jl;             // a column of [X | 1]
  const bool active = rg < RG && col <= d;
  const long long group = (long long)FG * k * TJ;   // one row group's sums
  for (long long i = tid; i < RG * group; i += kThreads) acc[i] = 0.0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  if (active) {
    double* mine = acc + rg * group + jl;
    const float* wf = w + (long long)f0 * n;
    long long r = r0 + rg;
    // four rows a step, their loads issued together
    for (; r + 3 * RG < r1; r += 4 * RG) {
      float xv[4];
      int cv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long ru = r + u * RG;
        xv[u] = col < d ? X[ru * d + col] : 1.0f;
        cv[u] = (int)y[ru];
      }
      for (int g = 0; g < fg; ++g) {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          mine[((long long)g * k + cv[u]) * TJ] +=
              (double)wf[(long long)g * n + r + u * RG] * (double)xv[u];
      }
    }
    for (; r < r1; r += RG) {
      const float x = col < d ? X[r * d + col] : 1.0f;
      const int c = (int)y[r];
      for (int g = 0; g < fg; ++g)
        mine[((long long)g * k + c) * TJ] += (double)wf[(long long)g * n + r] * (double)x;
    }
  }
  __syncthreads();
  if (tid < TJ && col <= d) {
    for (int g = 0; g < fg; ++g) {
      double* out = partial + (((long long)blockIdx.x * F + f0 + g) * k) * (d + 1) + col;
      for (int c = 0; c < k; ++c) {
        const long long at = ((long long)g * k + c) * TJ + jl;
        double s = acc[at];
        for (int q = 1; q < RG; ++q) s += acc[q * group + at];
        out[(long long)c * (d + 1)] = s;
      }
    }
  }
}

// partial [chunks, F, k, d + 1] summed in chunk order, rounded once: class
// masses [F, k] (column d) and feature masses [F, k, d].
__global__ void nb_mass_finish(const double* __restrict__ partial, float* __restrict__ cls,
                               float* __restrict__ feat, int chunks, int F, int d, int k) {
  const long long E = (long long)k * (d + 1);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F * E) return;
  double s = 0.0;
  for (int q = 0; q < chunks; ++q) s += partial[(long long)q * F * E + i];
  const long long f = i / E, e = i % E;
  const int c = (int)(e / (d + 1)), j = (int)(e % (d + 1));
  if (j == d)
    cls[f * k + c] = __double2float_rn(s);
  else
    feat[(f * k + c) * d + j] = __double2float_rn(s);
}

// Score mode: a tiled GEMM, [rows x d] x [d x Q k], the outputs o = q k + c
// of all Q table sets in one axis.  A block takes kTileRows rows and
// kTileOut outputs and walks the features in tiles of kFeatTile: the rows'
// tile of X and the outputs' tile of theta (and tn, both as float64,
// converted once) staged in shared memory.  A thread keeps a 4 x 4 tile of
// float64 dot products (rows tr + 16 i, outputs tc + 16 u: a warp reads two
// rows' values and sixteen consecutive table entries a step, broadcasts and
// one wavefront), so each shared value feeds four multiply-adds.  Each dot
// product is summed in feature order and rounded once, then added to pi in
// float32 in the reference's order.
constexpr int kTileRows = 64, kTileOut = 64;

template <bool BERN>
__global__ void __launch_bounds__(kThreads)
nb_score(const float* __restrict__ X, const float* __restrict__ pi,
         const float* __restrict__ theta, const float* __restrict__ tn, float* __restrict__ z,
         int n, int d, int k, int Q) {
  __shared__ float xs[kTileRows][kFeatTile + 1];
  __shared__ double th[kFeatTile][kTileOut + 1];  // padded: the transposing stores spread
  __shared__ double tns[BERN ? kFeatTile : 1][BERN ? kTileOut + 1 : 1];
  const int tid = threadIdx.x, tr = tid / 16, tc = tid % 16;
  const long long r0 = (long long)blockIdx.x * kTileRows;
  const int o0 = blockIdx.y * kTileOut, outs = Q * k;
  double s[4][4], s2[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) s[i][u] = s2[i][u] = 0.0;
  for (int j0 = 0; j0 < d; j0 += kFeatTile) {
    const int fw = min(kFeatTile, d - j0);
    constexpr int NX = kTileRows * kFeatTile / kThreads;
    constexpr int NT = kTileOut * kFeatTile / kThreads;
    float vx[NX], vt[NT], vn[BERN ? NT : 1];
#pragma unroll
    for (int x = 0; x < NX; ++x) {  // the tiles' loads issued together
      const int e = tid + x * kThreads, rr = e / kFeatTile, jj = e % kFeatTile;
      vx[x] = (r0 + rr < n && jj < fw) ? X[(r0 + rr) * d + j0 + jj] : 0.0f;
    }
#pragma unroll
    for (int x = 0; x < NT; ++x) {
      const int e = tid + x * kThreads, oo = e / kFeatTile, jj = e % kFeatTile;
      const bool in = o0 + oo < outs && jj < fw;
      vt[x] = in ? theta[(long long)(o0 + oo) * d + j0 + jj] : 0.0f;
      if (BERN) vn[x] = in ? tn[(long long)(o0 + oo) * d + j0 + jj] : 0.0f;
    }
    __syncthreads();  // the previous tiles are consumed
#pragma unroll
    for (int x = 0; x < NX; ++x) {
      const int e = tid + x * kThreads;
      xs[e / kFeatTile][e % kFeatTile] = vx[x];
    }
#pragma unroll
    for (int x = 0; x < NT; ++x) {
      const int e = tid + x * kThreads;
      th[e % kFeatTile][e / kFeatTile] = (double)vt[x];
      if (BERN) tns[e % kFeatTile][e / kFeatTile] = (double)vn[x];
    }
    __syncthreads();
    for (int jj = 0; jj < fw; ++jj) {
      double x[4], t[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = (double)xs[tr + 16 * i][jj];
#pragma unroll
      for (int u = 0; u < 4; ++u) t[u] = th[jj][tc + 16 * u];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[i][u] = __fma_rn(x[i], t[u], s[i][u]);
      if (BERN) {
#pragma unroll
        for (int i = 0; i < 4; ++i) x[i] = (double)__fsub_rn(1.0f, xs[tr + 16 * i][jj]);
#pragma unroll
        for (int u = 0; u < 4; ++u) t[u] = tns[jj][tc + 16 * u];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int u = 0; u < 4; ++u) s2[i][u] = __fma_rn(x[i], t[u], s2[i][u]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + tr + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = o0 + tc + 16 * u;
      if (o >= outs) continue;
      float v = __fadd_rn(pi[o], __double2float_rn(s[i][u]));
      if (BERN) v = __fadd_rn(v, __double2float_rn(s2[i][u]));
      z[((long long)(o / k) * n + r) * k + o % k] = v;
    }
  }
}

// The score mode at up to 8 classes: no staging and no barriers.  A thread a row of a group of table sets
// streams its row of X from device memory (its own cache lines, which L1
// keeps for the row's next features) and the group's table rows through the
// read-only cache (the same address for every lane: broadcasts), four
// features a step; the same float64 sums in feature order, rounded once.
template <int A>
__global__ void __launch_bounds__(128)
nb_score_stream(const float* __restrict__ X, const float* __restrict__ pi,
                const float* __restrict__ theta, const float* __restrict__ tn,
                float* __restrict__ z, int n, int d, int k, int Q, int QG, int bernoulli) {
  const int groups = (Q + QG - 1) / QG;
  const int q0 = (blockIdx.x % groups) * QG, qg = min(QG, Q - q0);
  const int kq = qg * k;
  const long long r = (long long)(blockIdx.x / groups) * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const float* xr = X + r * d;
  const float* tq = theta + (long long)q0 * k * d;
  const float* nq = tn + (long long)q0 * k * d;
  double s[A], s2[A];
#pragma unroll
  for (int a = 0; a < A; ++a) s[a] = s2[a] = 0.0;
  int j = 0;
  for (; j + 4 <= d; j += 4) {
    float x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = xr[j + u];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (a < kq)
          s[a] = __fma_rn((double)x[u], (double)__ldg(tq + (long long)a * d + j + u), s[a]);
      if (bernoulli) {
        const double xn = (double)__fsub_rn(1.0f, x[u]);
#pragma unroll
        for (int a = 0; a < A; ++a)
          if (a < kq)
            s2[a] = __fma_rn(xn, (double)__ldg(nq + (long long)a * d + j + u), s2[a]);
      }
    }
  }
  for (; j < d; ++j) {
    const float x = xr[j];
#pragma unroll
    for (int a = 0; a < A; ++a)
      if (a < kq) s[a] = __fma_rn((double)x, (double)__ldg(tq + (long long)a * d + j), s[a]);
    if (bernoulli) {
      const double xn = (double)__fsub_rn(1.0f, x);
#pragma unroll
      for (int a = 0; a < A; ++a)
        if (a < kq) s2[a] = __fma_rn(xn, (double)__ldg(nq + (long long)a * d + j), s2[a]);
    }
  }
#pragma unroll
  for (int a = 0; a < A; ++a) {
    if (a >= kq) continue;
    float v = __fadd_rn(pi[(long long)q0 * k + a], __double2float_rn(s[a]));
    if (bernoulli) v = __fadd_rn(v, __double2float_rn(s2[a]));
    z[((long long)(q0 + a / k) * n + r) * k + a % k] = v;
  }
}

}  // namespace

// Mass mode: TJ columns a tile (a power of two, 32 .. 256), RG row groups
// (RG TJ <= 256 threads) and FG folds a block, chosen by the wrapper;
// partial f64[chunks, F, k, d + 1].
extern "C" int nb_tables_mass(const void* X, const void* y, const void* w, void* partial,
                              void* cls, void* feat, int n, int d, int k, int F, int FG,
                              int chunks, int chunk_rows, int TJ, int RG, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxFeatures || k <= 0 || k > kMaxClasses || F <= 0 ||
      FG < 1 || FG > F || (F + FG - 1) / FG > 65535 || chunks <= 0 || chunk_rows <= 0 ||
      TJ < 1 || RG < 1 || TJ * RG > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = (size_t)RG * FG * k * TJ * sizeof(double);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(nb_mass, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int tiles = (d + 1 + TJ - 1) / TJ;
  nb_mass<<<dim3((unsigned)chunks, (unsigned)tiles, (unsigned)((F + FG - 1) / FG)), kThreads,
            smem, st>>>((const float*)X, (const float*)y, (const float*)w, (double*)partial, n,
                        d, k, F, FG, chunk_rows, TJ, RG);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;
  const long long total = (long long)F * k * (d + 1);
  nb_mass_finish<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const double*)partial, (float*)cls, (float*)feat, chunks, F, d, k);
  return (int)cudaGetLastError();
}

extern "C" int nb_tables_score(const void* X, const void* pi, const void* theta,
                               const void* tn, void* z, int n, int d, int k, int Q,
                               int bernoulli, void* stream) {
  if (n <= 0 || d <= 0 || d > kMaxFeatures || k <= 0 || k > kMaxClasses || Q <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 8) {  // few outputs a row: stream the rows
    const int QG = max(1, min(Q, 8 / k));
    const long long blocks = (long long)((Q + QG - 1) / QG) * ((n + 127) / 128);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const int A = QG * k <= 2 ? 2 : (QG * k <= 4 ? 4 : 8);
#define NB_STREAM(AA)                                                                       \
  nb_score_stream<AA><<<(unsigned)blocks, 128, 0, st>>>((const float*)X, (const float*)pi, \
                                                        (const float*)theta,                \
                                                        (const float*)tn, (float*)z, n, d, k, \
                                                        Q, QG, bernoulli)
    if (A == 2) NB_STREAM(2);
    else if (A == 4) NB_STREAM(4);
    else NB_STREAM(8);
#undef NB_STREAM
    return (int)cudaGetLastError();
  }
  const long long row_tiles = (n + kTileRows - 1) / kTileRows;
  const long long out_tiles = ((long long)Q * k + kTileOut - 1) / kTileOut;
  if (row_tiles > 0x7fffffffLL || out_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_tiles, (unsigned)out_tiles);
  if (bernoulli)
    nb_score<true><<<grid, kThreads, 0, st>>>((const float*)X, (const float*)pi,
                                              (const float*)theta, (const float*)tn, (float*)z,
                                              n, d, k, Q);
  else
    nb_score<false><<<grid, kThreads, 0, st>>>((const float*)X, (const float*)pi,
                                               (const float*)theta, (const float*)tn, (float*)z,
                                               n, d, k, Q);
  return (int)cudaGetLastError();
}
