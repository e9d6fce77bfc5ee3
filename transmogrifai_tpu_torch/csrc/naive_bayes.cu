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
// Score mode: a block takes 256 rows, a table set and a group of KC (2, 4
// or 8) classes, and walks the features in tiles of 32: the rows' tile of X
// and the group's tile of theta (and tn) staged in shared memory, a thread a
// row with its KC float64 dot products in registers (one class group after
// another over the grid, not a fixed 8).  Each dot product is summed in
// feature order and rounded once, then added to pi in float32 in the
// reference's order.  The grid's fastest dimension is the (table set, class
// group) pair, so the blocks that share a row tile run together and read X
// from L2.
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

template <int KC>
__global__ void __launch_bounds__(kThreads)
nb_score(const float* __restrict__ X, const float* __restrict__ pi,
         const float* __restrict__ theta, const float* __restrict__ tn, float* __restrict__ z,
         int n, int d, int k, int groups, int bernoulli, long long row0) {
  __shared__ float xs[kThreads * kXStride];
  __shared__ float th[KC * kFeatTile];
  __shared__ float tns[KC * kFeatTile];
  const int tid = threadIdx.x;
  const int q = blockIdx.x / groups, c0 = (blockIdx.x % groups) * KC;
  const int kc = min(KC, k - c0);
  const long long rb = row0 + (long long)blockIdx.y * kThreads;
  const int rows = (int)min((long long)kThreads, n - rb);
  const float* tq = theta + ((long long)q * k + c0) * d;
  const float* nq = tn + ((long long)q * k + c0) * d;
  double s[KC], s2[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) s[c] = s2[c] = 0.0;
  for (int j0 = 0; j0 < d; j0 += kFeatTile) {
    const int fw = min(kFeatTile, d - j0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < kThreads * fw; i += kThreads) {   // contiguous when fw == d
      const int r = i / fw, jj = i % fw;
      xs[r * kXStride + jj] = r < rows ? X[(rb + r) * d + j0 + jj] : 0.0f;
    }
    for (int i = tid; i < KC * kFeatTile; i += kThreads) {
      const int c = i / kFeatTile, jj = i % kFeatTile;
      const bool in = c < kc && jj < fw;
      th[i] = in ? tq[(long long)c * d + j0 + jj] : 0.0f;
      tns[i] = (in && bernoulli) ? nq[(long long)c * d + j0 + jj] : 0.0f;
    }
    __syncthreads();
    const float* xr = xs + tid * kXStride;
    for (int jj = 0; jj < fw; ++jj) {
      const float x = xr[jj];
      const float xn = __fsub_rn(1.0f, x);
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        s[c] += (double)x * (double)th[c * kFeatTile + jj];
        if (bernoulli) s2[c] += (double)xn * (double)tns[c * kFeatTile + jj];
      }
    }
  }
  if (tid >= rows) return;
  float* out = z + ((long long)q * n + rb + tid) * k + c0;
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    if (c < kc) {
      float v = __fadd_rn(pi[(long long)q * k + c0 + c], __double2float_rn(s[c]));
      if (bernoulli) v = __fadd_rn(v, __double2float_rn(s2[c]));
      out[c] = v;
    }
  }
}

template <int KC>
int launch_score(const void* X, const void* pi, const void* theta, const void* tn, void* z,
                 int n, int d, int k, int Q, int bernoulli, cudaStream_t st) {
  const int groups = (k + KC - 1) / KC;
  const long long span = 65535LL * kThreads;   // rows a launch (gridDim.y <= 65535)
  for (long long row0 = 0; row0 < n; row0 += span) {
    const long long rows = min(span, (long long)n - row0);
    nb_score<KC><<<dim3((unsigned)(Q * groups), (unsigned)((rows + kThreads - 1) / kThreads)),
                   kThreads, 0, st>>>((const float*)X, (const float*)pi, (const float*)theta,
                                      (const float*)tn, (float*)z, n, d, k, groups, bernoulli,
                                      row0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
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
  if (n <= 0 || d <= 0 || d > kMaxFeatures || k <= 0 || k > kMaxClasses || Q <= 0 ||
      (long long)Q * ((k + 7) / 8) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 2) return launch_score<2>(X, pi, theta, tn, z, n, d, k, Q, bernoulli, st);
  if (k <= 4) return launch_score<4>(X, pi, theta, tn, z, n, d, k, Q, bernoulli, st);
  return launch_score<8>(X, pi, theta, tn, z, n, d, k, Q, bernoulli, st);
}
