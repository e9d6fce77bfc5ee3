// K-S weighted_gram: the weighted Gram matrix and weighted moment vector of
// the Newton logistic fits and the closed-form ridge fits.
//
// Replaces: the products inside transmogrifai_tpu/ops/linear.py::
// fit_logistic_newton (:53), as fit_logistic_grid_folds_newton (:379) vmaps
// it over (fold, grid) fits (NEWTON mode), and inside ::fit_ridge (:193), as
// fit_ridge_grid_folds (:396) vmaps it (ridge mode).  For every fit c of C
// at once, with X1 = [X, 1] f32[n, p] shared by all fits and w_f(c) the
// fit's fold weights:
//   NEWTON: mu = sigmoid(X1 beta_c), v = max(mu (1 - mu), 1e-6) w_f,
//           u = w_f (mu - y);
//   ridge:  v = w_f, u = w_f y;
//   H_c = X1^T diag(v) X1 f32[p, p] (written mirrored), g_c = X1^T u f32[p].
// The caller divides by the weight sum, adds the penalty and solves.
//
// The weights differ per fit (and per Newton step), so a library product
// would need the [C, n, p] weighted rows in memory; here they are formed in
// the kernel's prologue and never leave shared memory.  A block takes a
// chunk of rows and a tile of up to 32 fits.  Per tile of 32 rows it stages
// the rows of X1 in shared memory, forms every (fit, row)'s v and u there
// (the margin X1[r] . beta_c from shared memory; the sigmoid as 1 / (1 +
// exp(-z)), libdevice's expf), and then each thread accumulates up to 16
// output entries (an upper-triangle entry (i, j) or a gradient entry i of
// one fit) over the tile's rows in float32, adding the tile's sum to a
// float64 accumulator.  The chunks' float64 partials are summed by a second
// kernel, a warp an entry in a fixed order, and rounded to float32 once, as
// K-P and K-O do: no atomics, runs repeat bit for bit, and each entry is
// within float32 rounding of the exact weighted sum.
//
// Bound on the card: X1 read once per tile of fits (once for the Titanic
// sweep's 6 Newton fits at p = 11 and for Boston's 3 folds at p = 17), each
// fold's weights and y once; about 2 (p (p + 1) / 2 + p) + 2 p operations
// per (fit, row).  The kernel is far from that bound (PERF.md): at 167
// registers a thread one 256-thread block fits an SM, and each 32-row tile
// is a chain of dependent shared-memory FMAs between three barriers.  A
// design with more rows in flight a thread (or wgmma) is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;      // rows of a shared tile
constexpr int kMaxFits = 32;   // fits of a block's tile
constexpr int kMaxCoefs = 64;
constexpr int kMaxEnt = 16;    // output entries a thread accumulates

__device__ __forceinline__ void tri_decode(int q, int p, int* i, int* j) {
  int a = 0;
  while (q >= p - a) {
    q -= p - a;
    ++a;
  }
  *i = a;
  *j = a + q;
}

template <bool NEWTON>
__global__ void __launch_bounds__(kThreads)
gram_partial(const float* __restrict__ X1, const float* __restrict__ y,
             const float* __restrict__ w, const int32_t* __restrict__ fold,
             const float* __restrict__ beta, double* __restrict__ partial, int n, int p, int C,
             int ct, int chunk_rows) {
  __shared__ float xs[kRows][kMaxCoefs + 1];
  __shared__ float bs[kMaxFits][kMaxCoefs];
  __shared__ float vs[kMaxFits][kRows];
  __shared__ float us[kMaxFits][kRows];
  __shared__ int fs[kMaxFits];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * ct;
  const int nc = min(ct, C - c0);
  const int tri = p * (p + 1) / 2;
  const int E = tri + p;
  if (NEWTON)
    for (int i = tid; i < nc * p; i += kThreads)
      bs[i / p][i % p] = beta[(long long)(c0 + i / p) * p + i % p];
  if (tid < nc) fs[tid] = fold[c0 + tid];
  // this thread's entries: (fit, i, j + 1) packed, j + 1 = 0 for a gradient
  int ent[kMaxEnt];
  double acc[kMaxEnt];
  int ne = 0;
#pragma unroll
  for (int k = 0; k < kMaxEnt; ++k) {
    const int e = tid + k * kThreads;
    ent[k] = 0;
    acc[k] = 0.0;
    if (e < nc * E) {
      const int c = e / E, q = e % E;
      int i, j;
      if (q < tri) {
        tri_decode(q, p, &i, &j);
        ++j;
      } else {
        i = q - tri;
        j = 0;
      }
      ent[k] = c | (i << 8) | (j << 16);
      ne = k + 1;
    }
  }
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long rt = r0; rt < r1; rt += kRows) {
    const int nr = (int)min((long long)kRows, r1 - rt);
    __syncthreads();  // the previous tile is consumed (and bs, fs are in)
    for (int i = tid; i < nr * p; i += kThreads) xs[i / p][i % p] = X1[(rt + i / p) * p + i % p];
    __syncthreads();
    for (int i = tid; i < nc * kRows; i += kThreads) {
      const int c = i / kRows, r = i % kRows;
      float v = 0.0f, u = 0.0f;
      if (r < nr) {
        const long long row = rt + r;
        const float wr = w[(long long)fs[c] * n + row];
        if (NEWTON) {
          float z = 0.0f;
          for (int a = 0; a < p; ++a) z = __fmaf_rn(xs[r][a], bs[c][a], z);
          const float mu = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
          v = __fmul_rn(fmaxf(__fmul_rn(mu, __fsub_rn(1.0f, mu)), 1e-6f), wr);
          u = __fmul_rn(wr, __fsub_rn(mu, y[row]));
        } else {
          v = wr;
          u = __fmul_rn(wr, y[row]);
        }
      }
      vs[c][r] = v;
      us[c][r] = u;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kMaxEnt; ++k) {
      if (k < ne) {
        const int c = ent[k] & 0xff, i = (ent[k] >> 8) & 0xff, j = (ent[k] >> 16) - 1;
        float s = 0.0f;
        if (j >= 0) {
          for (int r = 0; r < nr; ++r) s = __fmaf_rn(__fmul_rn(vs[c][r], xs[r][i]), xs[r][j], s);
        } else {
          for (int r = 0; r < nr; ++r) s = __fmaf_rn(us[c][r], xs[r][i], s);
        }
        acc[k] += (double)s;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kMaxEnt; ++k) {
    const int e = tid + k * kThreads;
    if (k < ne) partial[((long long)blockIdx.x * C + c0) * E + e] = acc[k];
  }
}

// The chunks' float64 partials of each entry summed by one warp (lane l
// takes chunks l, l + 32, ... in order, then a fixed shuffle tree) and
// rounded once; the upper triangle written to both halves of H, the
// moments to g.
__global__ void gram_finish(const double* __restrict__ partial, float* __restrict__ H,
                            float* __restrict__ g, int chunks, int C, int p) {
  const int tri = p * (p + 1) / 2;
  const int E = tri + p;
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= (long long)C * E) return;  // the whole warp: idx is the warp's
  double s = 0.0;
  for (int k = lane; k < chunks; k += 32) s += partial[(long long)k * C * E + idx];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  const int c = (int)(idx / E), q = (int)(idx % E);
  const float f = __double2float_rn(s);
  if (q < tri) {
    int i, j;
    tri_decode(q, p, &i, &j);
    H[((long long)c * p + i) * p + j] = f;
    H[((long long)c * p + j) * p + i] = f;
  } else {
    g[(long long)c * p + (q - tri)] = f;
  }
}

}  // namespace

// newton != 0: NEWTON mode (beta f32[C, p] read); else ridge (beta unused).
// ct fits a block, with ct * (p (p + 1) / 2 + p) <= 16 * 256 and ct <= 32.
extern "C" int weighted_gram(const void* X1, const void* y, const void* w, const void* fold,
                             const void* beta, void* partial, void* H, void* g, int n, int p,
                             int C, int ct, int chunks, int chunk_rows, int newton,
                             void* stream) {
  const int E = p * (p + 1) / 2 + p;
  if (n <= 0 || p <= 0 || p > kMaxCoefs || C <= 0 || ct <= 0 || ct > kMaxFits ||
      ct * E > kMaxEnt * kThreads || chunks <= 0 || chunk_rows <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)((C + ct - 1) / ct));
  if (newton)
    gram_partial<true><<<grid, kThreads, 0, st>>>(
        (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold,
        (const float*)beta, (double*)partial, n, p, C, ct, chunk_rows);
  else
    gram_partial<false><<<grid, kThreads, 0, st>>>(
        (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold,
        (const float*)beta, (double*)partial, n, p, C, ct, chunk_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;  // four entries a block, a warp each
  const long long total = (long long)C * E * 32;
  gram_finish<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const double*)partial, (float*)H, (float*)g, chunks, C, p);
  return (int)cudaGetLastError();
}
