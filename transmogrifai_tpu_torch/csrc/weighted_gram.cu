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
// wide entry (weighted_gram_wide) runs on the float64 tensor cores:
//   1. gram_weights_rows, the mode's prologue: a warp a row (coalesced
//      loads, lane l the coefficients l, l + 32, ...), each fit's margin of
//      a tile of 8 fits by a butterfly, lane c taking fit c's (v, u) (the
//      same float32 formulas as above), widened into v, u f64[C, n] once
//      for every (fit, row).  It stays a kernel of its own: a margin needs the
//      whole row, a tile block sees 128 of its columns, and forming v and u
//      in each of the nt (nt + 1) / 2 tile-pair blocks would repeat the
//      prologue's work 3 times at p = 85 and 45 times at p = 513, where the
//      round trip of v and u costs 2 C n 8 bytes (25 MB at 2^17 rows and 12
//      fits, about 8 us of the card's bandwidth);
//   2. gram_tiles: a block a (row chunk, group of up to 4 fits, 64 x 64
//      upper-triangle tile pair) over the augmented columns [X1 | moments]
//      (the tile pairs fastest in the grid, so the blocks in flight share a
//      row chunk in L2).  Per 32-row slab, cp.async stages the raw values
//      (the X1 columns of both tiles, each fit's v and u) into one of two
//      buffers, and the block widens them once into one of two float64
//      operand buffers: A = x_ri (shared by the group's fits), B = v_r x_rj
//      per fit (exact in float64), or u_r in column p, the moments riding
//      along.  Each warp issues its products of slab s first, then copies
//      slab s + 2 and converts slab s + 1 while the tensor cores work.  Each
//      of the 16 warps takes one (fit, 32 x 32 sub-tile) item: those wholly
//      past column p or below the diagonal are skipped, a diagonal sub-tile
//      is computed whole and its upper half written; where fewer than 16
//      items are left (at p = 85 the tile pairs hold 12, 8 and 4), an item's
//      8-row steps are split among 2 or 4 warps, their sums added in warp
//      order at the end.  An item is 2 x 4 m16n8k8 float64 mma.sync
//      products a step of 8 rows (each shared double feeds four or two
//      products), summed in the tensor core's fixed order;
//   3. gram_finish_wide: a thread an entry sums the chunks' float64 partials
//      in chunk order and rounds once.
// No atomics: runs repeat bit for bit.  The partial buffer (chunks x C x E
// float64) is bounded by the wrapper (a GiB: at p = 1,024 and C = 9 fits one
// chunk is 38 MB).  ops/linear.py::gram_wide_plan chooses the groups and the
// chunks.
// Bound on the card: float64 tensor-core operations, p (p + 1) / 2 + p
// fused multiply-adds per (fit, row), at 67 TFLOP/s (the m16n8k{4,8,16}
// shapes reach 66.4 TFLOP/s on the H100, m8n8k4 half of it:
// tools/dmma_shapes.cu); the 64 x 64 tiles do 6 x 1,024 of them a (fit,
// row) at p = 85 (3,740 needed) and 153 x 1,024 at p = 513 (132,354).  The
// float64 FMA pipe outside the tensor cores has half that rate.
// ptxas (CUDA 12.9, sm_90a): gram_tiles 128 registers (512 threads, one
// block an SM), no spills, 210,944 bytes of dynamic shared memory.
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
constexpr int kMaxWide = 1024;
// the tile kernel (ops/linear.py's gram_wide_plan mirrors these)
constexpr int kGT = 64;          // side of an output tile (_GRAM_WIDE_TILE)
constexpr int kGFits = 4;        // fits a block, at most (_GRAM_WIDE_FITS)
constexpr int kGSlab = 32;       // rows a staged slab (_GRAM_WIDE_SLAB)
constexpr int kGLd = kGT + 4;    // doubles a shared row: conflict-free fragment loads
constexpr int kGThreads = 512;   // a tile block's threads: a warp an item
constexpr int kGWarps = kGThreads / 32;
// a raw stage in floats: the slab's X1 columns, then each fit's v and u (doubles)
constexpr int kGRaw = kGSlab * 2 * kGT + 2 * kGFits * 2 * kGSlab;
constexpr int kGOps = (1 + kGFits) * kGSlab * kGLd;             // doubles an operand stage
constexpr int kGSmem = 2 * kGRaw * 4 + 2 * kGOps * 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The prologue: every (fit, row)'s (v, u) into v_out, u_out f64[C, n] (the
// float32 values, widened once here rather than in every tile block).
template <int MODE>
__global__ void __launch_bounds__(kThreads)
gram_weights_rows(const float* __restrict__ X1, const float* __restrict__ y,
                  const float* __restrict__ w, const int32_t* __restrict__ fold,
                  const float* __restrict__ beta, const float* __restrict__ vp,
                  double* __restrict__ v_out, double* __restrict__ u_out, int n, int p, int C,
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
      v_out[(long long)(c0 + lane) * n + r] = (double)v;
      u_out[(long long)(c0 + lane) * n + r] = (double)u;
    }
  }
}

// The first entry of row i of the packed upper triangle of a p x p matrix.
__device__ __forceinline__ long long tri_offset(long long i, int p) {
  return i * p - i * (i - 1) / 2;
}

__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const double* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}

// d += a b on the float64 tensor cores: a 16 x 8 (rows x depth) fragment, b
// 8 x 8, d 16 x 8 (lane l: g = l / 4, t = l % 4; a = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b = (t, g), (t + 4, g); d = (g, 2t), (g, 2t +
// 1), (g + 8, 2t), (g + 8, 2t + 1)).
__device__ __forceinline__ void dmma_16x8x8(double (&d)[4], const double (&a)[4],
                                            const double (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

// One block: the G fits of group blockIdx.x / pairs and output tile pair
// blockIdx.x % pairs (ti <= tj over the nt 64-column tiles of the p + 1
// augmented columns), over row chunk blockIdx.y.  Its work is up to 4 G
// items, each a (fit, 32 x 32 sub-tile): those wholly past column p or below
// the diagonal are skipped.  Each of the 16 warps takes one item; where
// fewer than 16 items are left, an item's 8-row steps are split among 2 or 4
// warps (split), whose sums are added in warp order at the end.
__global__ void __launch_bounds__(kGThreads, 1)
gram_tiles(const float* __restrict__ X1, const double* __restrict__ v,
           const double* __restrict__ u, double* __restrict__ partial, int n, int p, int C, int G,
           int nt, int chunk_rows) {
  extern __shared__ __align__(16) unsigned char gsm[];
  float* raw = reinterpret_cast<float*>(gsm);  // [2][kGRaw]
  // [2][kGOps]: A [kGSlab][kGLd], then B [kGFits][kGSlab][kGLd]
  double* ops = reinterpret_cast<double*>(gsm + 2 * kGRaw * sizeof(float));
  const int pairs = nt * (nt + 1) / 2;
  int q = blockIdx.x % pairs, ti = 0;
  while (q >= nt - ti) {
    q -= nt - ti;
    ++ti;
  }
  const int tj = ti + q;
  const bool diag = ti == tj;
  const int i0 = ti * kGT, j0 = tj * kGT;
  const int c0 = (blockIdx.x / pairs) * G;
  const int nc = min(G, C - c0);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  int items = 0;
  for (int it = 0; it < kGFits * 4; ++it) {
    const int f = it / 4, si = (it / 2) % 2, sj = it % 2;
    items += !(f >= nc || i0 + 32 * si >= p || j0 + 32 * sj > p || (diag && si > sj));
  }
  const int split = items * 4 <= kGWarps ? 4 : (items * 2 <= kGWarps ? 2 : 1);
  const int part = warp % split;
  int mine = -1;  // this warp's item
  for (int it = 0, cnt = 0; it < kGFits * 4; ++it) {
    const int f = it / 4, si = (it / 2) % 2, sj = it % 2;
    if (f >= nc || i0 + 32 * si >= p || j0 + 32 * sj > p || (diag && si > sj)) continue;
    if (cnt == warp / split) mine = it;
    ++cnt;
  }
  const int f = mine / 4, si = (mine / 2) % 2, sj = mine % 2;
  double acc[2][4][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[b][c][e] = 0.0;
  const long long r0 = (long long)blockIdx.y * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int nslabs = (int)((r1 - r0 + kGSlab - 1) / kGSlab);
  // a slab's raw floats: the X1 columns of the i tile, then of the j tile
  // (none on a diagonal tile), then v and u of each fit; rows past the chunk
  // and columns past p zero-filled
  // a thread copies one column (cc) of every fourth row of a slab
  const int cc = tid % (2 * kGT), rr0 = tid / (2 * kGT);
  const int col = cc < kGT ? i0 + cc : j0 + cc - kGT;
  const bool copies = !(diag && cc >= kGT);
  const bool col_ok = col < p;
  auto stage = [&](int s) {
    float* rb = raw + (s & 1) * kGRaw;
    const long long rt = r0 + (long long)s * kGSlab;
    const int nr = (int)min((long long)kGSlab, r1 - rt);
    if (copies) {
#pragma unroll
      for (int rr = rr0; rr < kGSlab; rr += kGThreads / (2 * kGT)) {
        const bool ok = col_ok && rr < nr;
        cp_async4(rb + rr * 2 * kGT + cc, ok ? X1 + (rt + rr) * p + col : X1, ok);
      }
    }
    for (int idx = tid; idx < kGFits * 2 * kGSlab; idx += kGThreads) {
      const int fi = idx / (2 * kGSlab), which = (idx / kGSlab) % 2, rr = idx % kGSlab;
      const bool ok = fi < nc && rr < nr;
      const double* src = (which ? u : v) + (long long)(c0 + fi) * n + rt + rr;
      cp_async8(reinterpret_cast<double*>(rb + kGSlab * 2 * kGT) + idx, ok ? src : v, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // the operands in float64 into buffer s & 1: A = x_ri (the i tile), B =
  // v_r x_rj per fit (exact), or u_r in column p; a thread one row's two
  // column pairs (16-byte stores)
  auto convert = [&](int s) {
    const float* rb = raw + (s & 1) * kGRaw;
    const double* vu = reinterpret_cast<const double*>(rb + kGSlab * 2 * kGT);
    double* As = ops + (s & 1) * kGOps;
    double* Bs = As + kGSlab * kGLd;
    const int rr = tid / 16;
    double vd[kGFits], ud[kGFits];
#pragma unroll
    for (int fi = 0; fi < kGFits; ++fi) {
      vd[fi] = vu[fi * 2 * kGSlab + rr];
      ud[fi] = vu[fi * 2 * kGSlab + kGSlab + rr];
    }
#pragma unroll
    for (int m = 0; m < kGT / 32; ++m) {
      const int c2 = 2 * (tid % 16) + 32 * m;
      const float2 xa = *reinterpret_cast<const float2*>(rb + rr * 2 * kGT + c2);
      const double2 xad = make_double2(xa.x, xa.y);
      *reinterpret_cast<double2*>(As + rr * kGLd + c2) = xad;
      double2 xb = xad;  // a diagonal tile's j columns are its i columns
      if (!diag) {
        const float2 xf = *reinterpret_cast<const float2*>(rb + rr * 2 * kGT + kGT + c2);
        xb = make_double2(xf.x, xf.y);
      }
      const int j = j0 + c2;
#pragma unroll
      for (int fi = 0; fi < kGFits; ++fi)
        if (fi < nc)
          *reinterpret_cast<double2*>(Bs + (fi * kGSlab + rr) * kGLd + c2) = make_double2(
              j < p ? vd[fi] * xb.x : (j == p ? ud[fi] : 0.0),
              j + 1 < p ? vd[fi] * xb.y : (j + 1 == p ? ud[fi] : 0.0));
    }
  };
  // two slabs in flight: slab s + 1's copies and its conversion overlap slab
  // s's products (the operands double buffered too)
  stage(0);
  if (nslabs > 1) stage(1);
  if (nslabs > 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  convert(0);
  for (int s = 0; s < nslabs; ++s) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();  // slab s converted, slab s + 1 staged; slab s - 1's products done
    // the products are issued first: the tensor cores work through them
    // while the warp copies slab s + 2 and converts slab s + 1
    const double* As = ops + (s & 1) * kGOps;
    const double* Bs = As + kGSlab * kGLd;
#pragma unroll
    for (int kk = 0; kk < kGSlab; kk += 8) {
      if (mine < 0 || (kk / 8) % split != part) continue;
      double a[2][4], b[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const double* ap = As + (kk + t) * kGLd + si * 32 + mt * 16 + g;
        a[mt][0] = ap[0];
        a[mt][1] = ap[8];
        a[mt][2] = ap[4 * kGLd];
        a[mt][3] = ap[4 * kGLd + 8];
      }
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
        const double* bp = Bs + (f * kGSlab + kk + t) * kGLd + sj * 32 + nn * 8 + g;
        b[nn][0] = bp[0];
        b[nn][1] = bp[4 * kGLd];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn) dmma_16x8x8(acc[mt][nn], a[mt], b[nn]);
    }
    if (s + 2 < nslabs) stage(s + 2);
    if (s + 1 < nslabs) convert(s + 1);
  }
  if (split > 1) {  // an item's parts added in warp order, through shared memory
    __syncthreads();  // the operands are read
    double* red = ops + warp * 32 * 32;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nn = 0; nn < 4; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) red[((mt * 4 + nn) * 4 + e) * 32 + lane] = acc[mt][nn][e];
    __syncthreads();
    if (part != 0 || mine < 0) return;
    for (int w = 1; w < split; ++w)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nn = 0; nn < 4; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nn][e] += red[w * 32 * 32 + ((mt * 4 + nn) * 4 + e) * 32 + lane];
  }
  if (mine < 0) return;
  const long long tri = (long long)p * (p + 1) / 2;
  const long long E = tri + p;
  double* out = partial + ((long long)blockIdx.y * C + c0 + f) * E;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + si * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int j = j0 + sj * 32 + nn * 8 + 2 * t + (e & 1);
        if (i >= p || j > p || j < i) continue;
        out[j < p ? tri_offset(i, p) + (j - i) : tri + i] = acc[mt][nn][e];
      }
}

// A thread an entry: the chunks' partials summed in chunk order (each load
// coalesced across the threads), one rounding; the triangle's row found in
// closed form.
__global__ void gram_finish_wide(const double* __restrict__ partial, float* __restrict__ H,
                                 float* __restrict__ g, int chunks, int C, int p) {
  const long long tri = (long long)p * (p + 1) / 2;
  const long long E = tri + p;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)C * E) return;
  double s = 0.0;
  for (int k = 0; k < chunks; ++k) s += partial[(long long)k * C * E + idx];
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


// The wide entry, 64 < p <= 1024, by the plan of ops/linear.py::
// gram_wide_plan: v, u f64[C, n] scratch for the prologue, partial
// f64[chunks, C, p (p + 1) / 2 + p], G fits a tile block, smem its dynamic
// shared bytes (kGSmem); the other arguments as above.
extern "C" int weighted_gram_wide(const void* X1, const void* y, const void* w, const void* fold,
                                  const void* beta, const void* vp, void* v, void* u,
                                  void* partial, void* H, void* g, int n, int p, int C,
                                  int chunks, int chunk_rows, int mode, int family, int link,
                                  int G, int smem, void* stream) {
  if (n <= 0 || p <= 0 || p > kMaxWide || C <= 0 || C > 65535 || chunks <= 0 ||
      chunks > 65535 || chunk_rows <= 0 || mode < RIDGE || mode > GLM || family < GAUSSIAN ||
      family > TWEEDIE || link < IDENTITY || link > SQRT || G <= 0 || G > kGFits ||
      smem != kGSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long row_blocks = min(((long long)n + kWarps - 1) / kWarps, 4096LL);
  dim3 pgrid((unsigned)row_blocks, (unsigned)((C + kWideFits - 1) / kWideFits));
  const size_t zbytes = mode == RIDGE ? 0 : (size_t)kWideFits * p * sizeof(float);
#define WEIGHT_ARGS                                                                        \
  (const float*)X1, (const float*)y, (const float*)w, (const int32_t*)fold,              \
      (const float*)beta, (const float*)vp, (double*)v, (double*)u, n, p, C, family, link
  if (mode == NEWTON)
    gram_weights_rows<NEWTON><<<pgrid, kThreads, zbytes, st>>>(WEIGHT_ARGS);
  else if (mode == GLM)
    gram_weights_rows<GLM><<<pgrid, kThreads, zbytes, st>>>(WEIGHT_ARGS);
  else
    gram_weights_rows<RIDGE><<<pgrid, kThreads, zbytes, st>>>(WEIGHT_ARGS);
#undef WEIGHT_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  static bool attr_set = false;
  if (!attr_set) {
    err = cudaFuncSetAttribute(gram_tiles, cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const int nt = (p + 1 + kGT - 1) / kGT;
  // the tile pairs fastest: the blocks in flight share a row chunk in L2
  dim3 tgrid((unsigned)(nt * (nt + 1) / 2 * ((C + G - 1) / G)), (unsigned)chunks);
  gram_tiles<<<tgrid, kGThreads, kGSmem, st>>>((const float*)X1, (const double*)v,
                                              (const double*)u, (double*)partial, n, p, C, G, nt,
                                              chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;  // an entry a thread
  const long long total = (long long)C * ((long long)p * (p + 1) / 2 + p);
  gram_finish_wide<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const double*)partial, (float*)H, (float*)g, chunks, C, p);
  return (int)cudaGetLastError();
}
