// K-S weighted_gram: the weighted Gram matrix and weighted moment vector of
// the Newton logistic fits, the closed-form ridge fits and the GLM's IRLS
// steps.
//
// Replaces: the products inside transmogrifai_tpu/ops/linear.py::
// fit_logistic_newton (:53), as fit_logistic_grid_folds_newton (:379) vmaps
// it over (fold, grid) fits (NEWTON mode), inside ::fit_ridge (:193), as
// fit_ridge_grid_folds (:396) vmaps it (ridge mode), and inside the step of
// ::fit_glm_irls (:326), as fit_glm_grid_folds (:539) vmaps it (GLM mode).
// For every fit c of C at once, with X1 = [X, 1] f32[n, p] shared by all
// fits and w_f(c) the fit's fold weights:
//   NEWTON: mu = sigmoid(X1 beta_c), v = max(mu (1 - mu), 1e-6) w_f,
//           u = w_f (mu - y);
//   ridge:  v = w_f, u = w_f y;
//   GLM:    eta = X1 beta_c, mu = the link's inverse of eta (clipped to
//           [1e-10, 1 - 1e-10] for binomial), g = dmu/deta,
//           z = eta + (y - mu) / (|g| < 1e-10 ? 1e-10 : g),
//           v = w_f g g / var(mu, vp_c), u = v z, with the clips of
//           _GLM_LINKS and _GLM_VARIANCE (:296-322): exp of eta clipped to
//           [-30, 30] for the log link, the 1e-10 floors, tweedie's
//           max(mu, 1e-10) ** vp_c; the family and the link are launch
//           arguments, the variance power one a fit;
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
// sweep's 6 Newton fits at p = 11, for Boston's 3 folds at p = 17 and for a
// Boston GLM group's 9 fits), each fold's weights and y once; about 2 (p (p +
// 1) / 2 + p) + 2 p operations per (fit, row), and the link's and the
// variance's few more in GLM mode.  The kernel is far from that bound (PERF.md): at 167
// registers a thread one 256-thread block fits an SM, and each 32-row tile
// is a chain of dependent shared-memory FMAs between three barriers.  A
// design with more rows in flight a thread (or wgmma) is later work.
//
// Above 64 coefficients (up to 1,024: the text flow's vector is 85 wide, a
// real CSV's hashed names wider) one fit's Gram has up to 524,800 entries,
// so a block can no longer hold a fit tile's entries in its threads.  The
// wide entry (weighted_gram_wide) takes K-I centered's tiling instead:
//   1. gram_weights_rows, the mode's prologue: a warp a row (coalesced
//      loads, lane l the coefficients l, l + 32, ...), each fit's margin of
//      a tile of 8 fits by a butterfly, lane c taking fit c's (v, u) (the
//      same float32 formulas as above) into v, u f32[C, n], once for every
//      (fit, row);
//   2. gram_tiles: a block a (row chunk, fit, 32 x 32 upper-triangle output
//      tile) over the augmented columns [X1 | moments]: per 32-row slab it
//      stages the tile's A columns (x_ri) and B columns (v_r x_rj in float64,
//      exact, or u_r for column p, the moments vector riding along) in
//      shared memory, and each thread accumulates a 1 x 4 float64 register
//      micro-tile, acc += x_ri * b_rj (one float64 rounding a term);
//      (64 x 64 tiles of 4 x 4 micro-tiles measured slower at the text
//      flow's p = 85, faster at p = 513: PERF.md, section 6);
//   3. gram_finish_wide: a warp an entry sums the chunks' float64 partials in
//      a fixed order and rounds once.
// No atomics: runs repeat bit for bit.  The partial buffer (chunks x C x E
// float64) is bounded by the wrapper (a GiB: at p = 1,024 and C = 9 fits one
// chunk is 38 MB).  Bound: float64 operations, p (p + 1) / 2 + p fused
// multiply-adds per (fit, row), over the card's float64 rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;      // rows of a shared tile
constexpr int kMaxFits = 32;   // fits of a block's tile
constexpr int kMaxCoefs = 64;
constexpr int kMaxEnt = 16;    // output entries a thread accumulates

enum Mode { RIDGE = 0, NEWTON = 1, GLM = 2 };
enum Family { GAUSSIAN = 0, BINOMIAL = 1, POISSON = 2, GAMMA = 3, TWEEDIE = 4 };
enum Link { IDENTITY = 0, LOG = 1, LOGIT = 2, INVERSE = 3, SQRT = 4 };

// One IRLS row weight pair (v, u) of the GLM at the margin eta, in float32
// operations in the reference's order (no contraction).
__device__ __forceinline__ void glm_weights(float eta, float y, float w, float vp, int family,
                                            int link, float* v, float* u) {
  float mu, g;
  switch (link) {
    case LOG:
      mu = g = expf(fminf(fmaxf(eta, -30.0f), 30.0f));
      break;
    case LOGIT:
      mu = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-eta)));
      g = __fmul_rn(mu, __fsub_rn(1.0f, mu));
      break;
    case INVERSE:
      mu = __fdiv_rn(1.0f, fmaxf(eta, 1e-10f));
      g = __fdiv_rn(-1.0f, fmaxf(__fmul_rn(eta, eta), 1e-10f));
      break;
    case SQRT:
      mu = __fmul_rn(eta, eta);
      g = __fmul_rn(2.0f, eta);
      break;
    default:  // IDENTITY
      mu = eta;
      g = 1.0f;
  }
  // the upper clip 1 - 1e-10 is 1 in float32
  if (family == BINOMIAL) mu = fminf(fmaxf(mu, 1e-10f), 1.0f);
  float var;
  switch (family) {
    case BINOMIAL:
      var = fmaxf(__fmul_rn(mu, __fsub_rn(1.0f, mu)), 1e-10f);
      break;
    case POISSON:
      var = fmaxf(mu, 1e-10f);
      break;
    case GAMMA:
      var = fmaxf(__fmul_rn(mu, mu), 1e-10f);
      break;
    case TWEEDIE:
      var = powf(fmaxf(mu, 1e-10f), vp);
      break;
    default:  // GAUSSIAN
      var = 1.0f;
  }
  const float gd = fabsf(g) < 1e-10f ? 1e-10f : g;
  const float z = __fadd_rn(eta, __fdiv_rn(__fsub_rn(y, mu), gd));
  *v = __fdiv_rn(__fmul_rn(__fmul_rn(w, g), g), var);
  *u = __fmul_rn(*v, z);
}

__device__ __forceinline__ void tri_decode(int q, int p, int* i, int* j) {
  int a = 0;
  while (q >= p - a) {
    q -= p - a;
    ++a;
  }
  *i = a;
  *j = a + q;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
gram_partial(const float* __restrict__ X1, const float* __restrict__ y,
             const float* __restrict__ w, const int32_t* __restrict__ fold,
             const float* __restrict__ beta, const float* __restrict__ vp,
             double* __restrict__ partial, int n, int p, int C, int ct, int chunk_rows,
             int family, int link) {
  __shared__ float xs[kRows][kMaxCoefs + 1];
  __shared__ float bs[kMaxFits][kMaxCoefs];
  __shared__ float vs[kMaxFits][kRows];
  __shared__ float us[kMaxFits][kRows];
  __shared__ int fs[kMaxFits];
  __shared__ float vps[kMaxFits];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * ct;
  const int nc = min(ct, C - c0);
  const int tri = p * (p + 1) / 2;
  const int E = tri + p;
  if (MODE != RIDGE)
    for (int i = tid; i < nc * p; i += kThreads)
      bs[i / p][i % p] = beta[(long long)(c0 + i / p) * p + i % p];
  if (tid < nc) {
    fs[tid] = fold[c0 + tid];
    vps[tid] = MODE == GLM ? vp[c0 + tid] : 0.0f;
  }
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
        if (MODE == NEWTON) {
          float z = 0.0f;
          for (int a = 0; a < p; ++a) z = __fmaf_rn(xs[r][a], bs[c][a], z);
          const float mu = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-z)));
          v = __fmul_rn(fmaxf(__fmul_rn(mu, __fsub_rn(1.0f, mu)), 1e-6f), wr);
          u = __fmul_rn(wr, __fsub_rn(mu, y[row]));
        } else if (MODE == GLM) {
          float eta = 0.0f;
          for (int a = 0; a < p; ++a) eta = __fmaf_rn(xs[r][a], bs[c][a], eta);
          glm_weights(eta, y[row], wr, vps[c], family, link, &v, &u);
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

// ---- the wide entry (p > 64) ------------------------------------------------

constexpr int kWarps = kThreads / 32;
constexpr int kWideFits = 8;     // fits of a prologue block's tile
constexpr int kTile = 32;        // side of an output tile (ops/linear.py's _GRAM_WIDE_TILE)
constexpr int kSlab = 32;        // rows of a shared slab
constexpr int kMaxWide = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The prologue: every (fit, row)'s (v, u) into v_out, u_out f32[C, n].
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gram_weights_rows(const float* __restrict__ X1, const float* __restrict__ y,
                  const float* __restrict__ w, const int32_t* __restrict__ fold,
                  const float* __restrict__ beta, const float* __restrict__ vp,
                  float* __restrict__ v_out, float* __restrict__ u_out, int n, int p, int C,
                  int family, int link) {
  extern __shared__ float zs[];  // [kWideFits][p]
  __shared__ int fs[kWideFits];
  __shared__ float vps[kWideFits];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c0 = blockIdx.y * kWideFits;
  const int nc = min(kWideFits, C - c0);
  if (MODE != RIDGE)
    for (int i = tid; i < nc * p; i += kThreads) zs[i] = beta[(long long)c0 * p + i];
  if (tid < nc) {
    fs[tid] = fold[c0 + tid];
    vps[tid] = MODE == GLM ? vp[c0 + tid] : 0.0f;
  }
  __syncthreads();
  for (long long r = (long long)blockIdx.x * kWarps + warp; r < n;
       r += (long long)gridDim.x * kWarps) {
    float mine = 0.0f;
    if (MODE != RIDGE) {
      float m[kWideFits];
#pragma unroll
      for (int c = 0; c < kWideFits; ++c) m[c] = 0.0f;
      for (int j = lane; j < p; j += 32) {
        const float xj = X1[r * p + j];
#pragma unroll
        for (int c = 0; c < kWideFits; ++c)
          if (c < nc) m[c] = __fmaf_rn(xj, zs[c * p + j], m[c]);
      }
#pragma unroll
      for (int c = 0; c < kWideFits; ++c) {
        const float s = warp_sum(m[c]);
        if (lane == c) mine = s;
      }
    }
    if (lane < nc) {
      const float wr = w[(long long)fs[lane] * n + r];
      float v, u;
      if (MODE == NEWTON) {
        const float mu = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-mine)));
        v = __fmul_rn(fmaxf(__fmul_rn(mu, __fsub_rn(1.0f, mu)), 1e-6f), wr);
        u = __fmul_rn(wr, __fsub_rn(mu, y[r]));
      } else if (MODE == GLM) {
        glm_weights(mine, y[r], wr, vps[lane], family, link, &v, &u);
      } else {
        v = wr;
        u = __fmul_rn(wr, y[r]);
      }
      v_out[(long long)(c0 + lane) * n + r] = v;
      u_out[(long long)(c0 + lane) * n + r] = u;
    }
  }
}

// The first entry of row i of the packed upper triangle of a p x p matrix.
__device__ __forceinline__ long long tri_offset(long long i, int p) {
  return i * p - i * (i - 1) / 2;
}

// One block: row chunk blockIdx.x, fit blockIdx.y, output tile pair
// blockIdx.z (ti <= tj over the nt tiles of the p + 1 augmented columns).
__global__ void __launch_bounds__(kThreads)
gram_tiles(const float* __restrict__ X1, const float* __restrict__ v,
           const float* __restrict__ u, double* __restrict__ partial, int n, int p, int C, int nt,
           int chunk_rows) {
  __shared__ float as[kSlab][kTile + 1];
  __shared__ double bs[kSlab][kTile + 1];
  int q = blockIdx.z, ti = 0;
  while (q >= nt - ti) {
    q -= nt - ti;
    ++ti;
  }
  const int tj = ti + q;
  const int c = blockIdx.y;
  const int i0 = ti * kTile, j0 = tj * kTile;
  const int tid = threadIdx.x, ty = tid / 8, tx = tid % 8;
  const float* vc = v + (long long)c * n;
  const float* uc = u + (long long)c * n;
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long rt = r0; rt < r1; rt += kSlab) {
    const int nr = (int)min((long long)kSlab, r1 - rt);
    __syncthreads();  // the previous slab is consumed
    for (int idx = tid; idx < kSlab * kTile; idx += kThreads) {
      const int rr = idx / kTile, cc = idx % kTile;
      float a = 0.0f;
      double b = 0.0;
      if (rr < nr) {
        const long long row = rt + rr;
        const int ia = i0 + cc, jb = j0 + cc;
        if (ia < p) a = X1[row * p + ia];
        if (jb < p)
          b = (double)vc[row] * (double)X1[row * p + jb];  // exact in float64
        else if (jb == p)
          b = (double)uc[row];
      }
      as[rr][cc] = a;
      bs[rr][cc] = b;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kSlab; ++rr) {
      const double a = (double)as[rr][ty];
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = fma(a, bs[rr][tx + 8 * k], acc[k]);
    }
  }
  const int i = i0 + ty;
  const long long tri = (long long)p * (p + 1) / 2;
  const long long E = tri + p;
  double* out = partial + ((long long)blockIdx.x * C + c) * E;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + tx + 8 * k;
    if (i >= p || j > p || j < i) continue;
    out[j < p ? tri_offset(i, p) + (j - i) : tri + i] = acc[k];
  }
}

// A warp an entry: lane l sums chunks l, l + 32, ... in order, a fixed
// shuffle tree, one rounding; the triangle's row found in closed form.
__global__ void gram_finish_wide(const double* __restrict__ partial, float* __restrict__ H,
                                 float* __restrict__ g, int chunks, int C, int p) {
  const long long tri = (long long)p * (p + 1) / 2;
  const long long E = tri + p;
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= (long long)C * E) return;  // the whole warp
  double s = 0.0;
  for (int k = lane; k < chunks; k += 32) s += partial[(long long)k * C * E + idx];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane != 0) return;
  const long long c = idx / E, q = idx % E;
  const float f = __double2float_rn(s);
  if (q < tri) {
    const double b = 2.0 * p + 1.0;
    long long i = (long long)floor((b - sqrt(b * b - 8.0 * (double)q)) / 2.0);
    if (i < 0) i = 0;
    while (i > 0 && tri_offset(i, p) > q) --i;
    while (i + 1 < p && tri_offset(i + 1, p) <= q) ++i;
    const long long j = i + (q - tri_offset(i, p));
    H[(c * p + i) * p + j] = f;
    H[(c * p + j) * p + i] = f;
  } else {
    g[c * p + (q - tri)] = f;
  }
}

}  // namespace

// mode: RIDGE (beta, vp unused), NEWTON (beta f32[C, p] read) or GLM (beta
// and the variance powers vp f32[C] read; family and link as the enums).
// ct fits a block, with ct * (p (p + 1) / 2 + p) <= 16 * 256 and ct <= 32.
extern "C" int weighted_gram(const void* X1, const void* y, const void* w, const void* fold,
                             const void* beta, const void* vp, void* partial, void* H, void* g,
                             int n, int p, int C, int ct, int chunks, int chunk_rows, int mode,
                             int family, int link, void* stream) {
  const int E = p * (p + 1) / 2 + p;
  if (n <= 0 || p <= 0 || p > kMaxCoefs || C <= 0 || ct <= 0 || ct > kMaxFits ||
      ct * E > kMaxEnt * kThreads || chunks <= 0 || chunk_rows <= 0 || mode < RIDGE ||
      mode > GLM || family < GAUSSIAN || family > TWEEDIE || link < IDENTITY || link > SQRT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid((unsigned)chunks, (unsigned)((C + ct - 1) / ct));
#define GRAM_ARGS                                                                        \
  (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold,              \
      (const float*)beta, (const float*)vp, (double*)partial, n, p, C, ct, chunk_rows, \
      family, link
  if (mode == NEWTON)
    gram_partial<NEWTON><<<grid, kThreads, 0, st>>>(GRAM_ARGS);
  else if (mode == GLM)
    gram_partial<GLM><<<grid, kThreads, 0, st>>>(GRAM_ARGS);
  else
    gram_partial<RIDGE><<<grid, kThreads, 0, st>>>(GRAM_ARGS);
#undef GRAM_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 128;  // four entries a block, a warp each
  const long long total = (long long)C * E * 32;
  gram_finish<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const double*)partial, (float*)H, (float*)g, chunks, C, p);
  return (int)cudaGetLastError();
}


// The wide entry, 64 < p <= 1024: v, u f32[C, n] scratch for the prologue,
// partial f64[chunks, C, p (p + 1) / 2 + p]; the other arguments as above.
extern "C" int weighted_gram_wide(const void* X1, const void* y, const void* w, const void* fold,
                                  const void* beta, const void* vp, void* v, void* u,
                                  void* partial, void* H, void* g, int n, int p, int C,
                                  int chunks, int chunk_rows, int mode, int family, int link,
                                  void* stream) {
  if (n <= 0 || p <= 0 || p > kMaxWide || C <= 0 || C > 65535 || chunks <= 0 ||
      chunk_rows <= 0 || mode < RIDGE || mode > GLM || family < GAUSSIAN || family > TWEEDIE ||
      link < IDENTITY || link > SQRT)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long row_blocks = min(((long long)n + kWarps - 1) / kWarps, 4096LL);
  dim3 pgrid((unsigned)row_blocks, (unsigned)((C + kWideFits - 1) / kWideFits));
  const size_t zbytes = mode == RIDGE ? 0 : (size_t)kWideFits * p * sizeof(float);
#define WEIGHT_ARGS                                                                        \
  (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold,              \
      (const float*)beta, (const float*)vp, (float*)v, (float*)u, n, p, C, family, link
  if (mode == NEWTON)
    gram_weights_rows<NEWTON><<<pgrid, kThreads, zbytes, st>>>(WEIGHT_ARGS);
  else if (mode == GLM)
    gram_weights_rows<GLM><<<pgrid, kThreads, zbytes, st>>>(WEIGHT_ARGS);
  else
    gram_weights_rows<RIDGE><<<pgrid, kThreads, zbytes, st>>>(WEIGHT_ARGS);
#undef WEIGHT_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (p + 1 + kTile - 1) / kTile;
  dim3 tgrid((unsigned)chunks, (unsigned)C, (unsigned)(nt * (nt + 1) / 2));
  gram_tiles<<<tgrid, kThreads, 0, st>>>((const float*)X1, (const float*)v, (const float*)u,
                                         (double*)partial, n, p, C, nt, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;  // eight entries a block, a warp each
  const long long total = (long long)C * ((long long)p * (p + 1) / 2 + p) * 32;
  gram_finish_wide<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const double*)partial, (float*)H, (float*)g, chunks, C, p);
  return (int)cudaGetLastError();
}
