// K-I corr_gram and centered_gram, and K-J contingency_counts: the sanity
// checker's column products.
//
// Replaces: transmogrifai_tpu/utils/stats.py::_corr_matrix_kernel (:47),
// the correlation matrix Z^T Z / max(n - 1, 1) of the standardized columns
// Z f32[n, d], and ::_contingency_kernel (:137), the contingency counts
// X^T onehot(y) of the indicator columns X f32[n, d] against the label
// classes y i32[n] (the one-hot is never built: a row adds to its class).
// K-I's centered mode replaces transmogrifai_tpu/parallel/stats.py::
// _gram_step (:62) and the Gram half of ::_fused_stats_step (:190): the
// unscaled Gram Z^T Z f64[D, D] of the D = d + 1 columns Z = [X | y] - c of
// one row chunk (X f32[n, d], y f32[n], the centers c f64[D]), which holds
// the feature Gram, the label cross terms and the label's sum of squares.
//
// K-J: a block takes a chunk of rows and a 16 x 16 tile of the counts, one
// thread a cell summing its chunk in row order; a second kernel adds the
// chunks in chunk order.  Counts of indicator columns are integers and sum
// exactly in any order (below 2^24), so K-J agrees with any exact float32
// product.  Bound: bytes (the columns and classes read once).
//
// K-I, both modes, by the launch plan of ops/stats.py::gram_plan, which the
// CPU tests replay.  A block takes a row chunk and a pair of column tiles ti
// <= tj of the D output columns (the pairs fastest in the grid, so the
// blocks in flight share a row chunk in L2) and writes its cells of the
// upper triangle, as the chunk's float64 partial, to their places in the
// packed triangle; gram_finish sums the chunks' partials in a fixed order
// and writes both halves, so the result is exactly symmetric.  Two passes:
//
// - gram_narrow, on the CUDA cores: corr_gram at any d, the centered mode
//   at D <= 64.  Tiles of 64 columns.  Where D <= 64 there is one diagonal
//   tile and a 128-row tile's rows are one contiguous span of X, staged by
//   16-byte cp.async (the rows are 92 bytes at d = 23; the parent kernel's
//   4-byte loads of 16-column strips took four times the copies), three
//   tiles in flight while one is summed; past 64 columns a staged 64-row
//   tile holds the two tiles' columns, by 4-byte copies, double buffered.
//   A thread then copies one column pair of the staged rows into a strided
//   operand buffer, centered on the way in float64 with its two centers in
//   registers, (double)x - c, as the plain version centers, so that only the
//   order of the sums differs.  A thread owns a 4 x 4 micro-tile of the
//   pair's cells (on a diagonal pair only the micro-tiles on and above the
//   diagonal: the triangle, not the square) over a split of the tile's rows:
//   two 16-byte loads (four for float64) feed 16 FMAs.  corr_gram sums in
//   float32 within a row tile and in float64 across tiles, as K-P does; the
//   splits are added in split order.  Chunks: one or two waves of 256-thread
//   blocks (two an SM).
// - gram_wide, on the float64 tensor cores: the centered mode past 64
//   columns.  K-S's wide design (csrc/weighted_gram.cu) without its per-fit
//   operand, so its tiles are larger for more reuse of a staged double:
//   128 x 128 tile pairs of the d feature columns, 16 warps each taking one
//   32 x 32 sub-tile item (those wholly past column d - 1 or below the
//   diagonal are skipped; where fewer than 16 are left, an item's 8-row
//   steps are split among 2 or 4 warps, their sums added in warp order).
//   The label's column is no tile's (at d = 512 it alone would make a fifth
//   tile and five more pairs a chunk): a diagonal pair's
//   warps left without an item (at least 4) take it, one a 32-column
//   sub-block, as an m16n8k8 product with the centered labels as column 0
//   of the B operand; tile 0's diagonal block also sums the labels'
//   squares.  Per 32-row slab, cp.async
//   stages the raw floats of both tiles (16-byte copies where d % 4 == 0)
//   and the labels into one of two buffers, and the block centers them once
//   into one of two float64 operand buffers, a thread a column pair with its
//   centers in registers.  Each warp issues slab s's products a step of 8
//   rows at a time (2 x 4 m16n8k8 float64 mma.sync, summed in the tensor
//   core's fixed order), and after each step a quarter of slab s + 1's
//   conversion, and after the first, slab s + 2's copies.  A diagonal
//   sub-tile is computed whole and its upper half written.
// - gram_finish: ``lanes`` threads a cell (a power of two, at most 32: a
//   warp a cell where the cells are few and the chunks many, as at D = 25;
//   a thread a cell where the cells are many) add the chunks' partials in
//   chunk order, then a fixed shuffle tree; corr_gram's float64 total is
//   rounded to float32 and divided by max(n - 1, 1) in float32, as the
//   reference divides.  (The tile kernel's last-arriving blocks summing the
//   partials under integer counters measured slower on the H100 at D = 23
//   to 25: their latency chain lay exposed at the end of the launch.)
// No atomics: runs repeat bit for bit.
//
// Bound on the card: bytes at few columns (X read once, the output written
// once), float64 operations past about 160 columns: the triangle's D (D +
// 1) / 2 multiply-adds a row, at 67 TFLOP/s on the tensor cores.  Where the
// time goes (PERF.md, PR 19, builds with one phase left out): at D = 25
// the float64 FMAs and the conversion of each tile run as two serial FP64
// phases of similar length; at D = 513 the conversions' float64
// subtractions share the FP64 pipe with the mma.sync steps, and a slab's
// staging and conversion do not hide behind its products.
// ptxas (sm_90a): gram_narrow 101-126 registers; gram_wide 128, 72 bytes of
// spill stores (no change in time when the B fragments were loaded one at
// a time to save registers).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ---- K-J contingency_counts -------------------------------------------------
constexpr int kTile = 16;
constexpr int kRows = 32;  // rows staged in shared memory per step
constexpr int kTargetBlocks = 4 * 132;

// partial[chunk, j, k] = sum over the chunk's rows r of A[r, j] * (cls[r] == k)
__global__ void contingency_partial(const float* __restrict__ A, const int32_t* __restrict__ cls,
                                    float* __restrict__ partial, int n, int da, int db,
                                    int chunk_rows) {
  __shared__ float sa[kRows][kTile + 1];
  __shared__ float sb[kRows][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;  // tx: column k of B, ty: column j of A
  const int tid = ty * kTile + tx;
  const int j0 = blockIdx.x * kTile, k0 = blockIdx.y * kTile;
  const long long r0 = (long long)blockIdx.z * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  float acc = 0.0f;
  for (long long rb = r0; rb < r1; rb += kRows) {
    for (int e = tid; e < kRows * kTile; e += kTile * kTile) {
      const int rr = e / kTile, cc = e % kTile;
      const long long r = rb + rr;
      const bool row = r < r1;
      sa[rr][cc] = (row && j0 + cc < da) ? A[r * da + j0 + cc] : 0.0f;
      sb[rr][cc] = (row && k0 + cc < db && cls[r] == k0 + cc) ? 1.0f : 0.0f;
    }
    __syncthreads();
    const int steps = (int)min((long long)kRows, r1 - rb);
    for (int rr = 0; rr < steps; ++rr) acc = __fmaf_rn(sa[rr][ty], sb[rr][tx], acc);
    __syncthreads();
  }
  if (j0 + ty < da && k0 + tx < db)
    partial[((long long)blockIdx.z * da + j0 + ty) * db + k0 + tx] = acc;
}

// out[i] = the sum over chunks c, in order, of partial[c, i]
__global__ void contingency_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                   int chunks, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, partial[(long long)c * total + i]);
  out[i] = s;
}

// the chunk count for this shape: about kTargetBlocks blocks, at least
// 256 rows a chunk; rows per chunk a multiple of kRows
int chunk_rows_for(int n, int da, int db) {
  const long long tiles = (long long)((da + kTile - 1) / kTile) * ((db + kTile - 1) / kTile);
  long long chunks = (kTargetBlocks + tiles - 1) / tiles;
  const long long max_chunks = (n + 255) / 256;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  long long rows = (n + chunks - 1) / chunks;
  rows = (rows + kRows - 1) / kRows * kRows;
  return (int)rows;
}

// ---- K-I: shared pieces ------------------------------------------------------
// (ops/stats.py mirrors these constants)
constexpr int kNarrowTile = 64;     // the CUDA-core pass's tile side (_NARROW_TILE)
constexpr int kNarrowThreads = 256; // its threads a block, at most (_NARROW_THREADS)
constexpr int kWT = 128;            // the tensor-core pass's tile side (_WIDE_TILE)
constexpr int kWSlab = 32;          // its rows a staged slab (_WIDE_SLAB)
constexpr int kWThreads = 512;      // its threads a block (_WIDE_THREADS)
constexpr int kWWarps = kWThreads / 32;
constexpr int kWLd = kWT + 4;       // doubles an operand row: conflict-free fragment loads
constexpr int kWRaw = kWSlab * 2 * kWT + kWSlab;  // floats a raw stage: both tiles, labels
constexpr int kWOps = 2 * kWSlab * kWLd;          // doubles an operand stage: A, then B
constexpr int kWSmem = 2 * kWRaw * 4 + 2 * kWOps * 8;
constexpr int kSmemMax = 232448;

__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
// 16 bytes, or 16 zero bytes where !valid
__device__ __forceinline__ void cp_async16(void* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// The first entry of row i of the packed upper triangle of a D x D matrix.
__host__ __device__ __forceinline__ long long tri_offset(long long i, long long D) {
  return i * D - i * (i - 1) / 2;
}

// The tile pair (ti <= tj, row-major over the upper triangle of nt tiles) of
// pair index q.
__device__ __forceinline__ void pair_decode(int q, int nt, int* ti, int* tj) {
  int a = 0;
  while (q >= nt - a) {
    q -= nt - a;
    ++a;
  }
  *ti = a;
  *tj = a + q;
}

// The finish: out = the chunks' partials f64[chunks, D (D + 1) / 2] summed,
// ``lanes`` lanes a cell (a power of two up to 32: lane l takes chunks l, l +
// lanes, ... in order, then a fixed shuffle tree), both halves written.
// CORR: out f32, the float32 total over denom; else out f64, the total.
template <bool CORR>
__global__ void gram_finish(const double* __restrict__ partial, void* __restrict__ out, int D,
                            int chunks, int lanes, float denom) {
  const long long CT = (long long)D * (D + 1) / 2;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long q = gid / lanes;
  const int l = (int)(gid % lanes);
  double s = 0.0;
  if (q < CT && l < chunks) {
    s = partial[(long long)l * CT + q];
#pragma unroll 4
    for (int c = l + lanes; c < chunks; c += lanes)
      s = __dadd_rn(s, partial[(long long)c * CT + q]);
  }
  for (int off = lanes / 2; off > 0; off /= 2)
    s = __dadd_rn(s, __shfl_down_sync(0xffffffffu, s, off, lanes));
  if (l != 0 || q >= CT) return;
  const double b = 2.0 * D + 1.0;  // the row of q in closed form, then corrected
  long long i = (long long)floor((b - sqrt(b * b - 8.0 * (double)q)) / 2.0);
  if (i < 0) i = 0;
  while (i > 0 && tri_offset(i, D) > q) --i;
  while (i + 1 < D && tri_offset(i + 1, D) <= q) ++i;
  const long long j = i + (q - tri_offset(i, D));
  if (CORR) {
    const float f = __fdiv_rn(__double2float_rn(s), denom);
    float* o = reinterpret_cast<float*>(out);
    o[i * D + j] = f;
    o[j * D + i] = f;
  } else {
    double* o = reinterpret_cast<double*>(out);
    o[i * D + j] = s;
    o[j * D + i] = s;
  }
}

// ---- K-I: the CUDA-core pass --------------------------------------------------
// The staged layout (ops/stats.py::_narrow_smem mirrors it).  SPAN: one
// diagonal tile (D <= 64), a row tile's rows packed as they lie in X, then
// the labels, four stages; else each staged row holds the two tiles'
// columns, two stages.  The operand rows hold the tile's columns (SPAN) or
// the i tile's then the j tile's, 4 elements of skew apart; after the last
// row tile the splits' sums take their place.
__host__ __device__ constexpr int narrow_stages(bool span) { return span ? 4 : 2; }
__host__ __device__ inline int narrow_width(int D, bool span) {
  return span ? (D + 3) / 4 * 4 : 2 * kNarrowTile;
}
__host__ __device__ inline long long narrow_raw_floats(int d, int R, bool span, bool centered) {
  return span ? ((long long)R * d + 3) / 4 * 4 + (centered ? R : 0)
              : (long long)R * 2 * kNarrowTile;
}
__host__ __device__ inline long long narrow_union_bytes(int D, int R, int threads, bool span,
                                                       int esize) {
  const long long op = (long long)R * (narrow_width(D, span) + 4) * esize;
  const long long red = (long long)threads * 16 * 8;
  return ((op > red ? op : red) + 15) / 16 * 16;
}
inline long long narrow_smem(int d, int D, int R, int threads, bool span, int esize,
                             bool centered) {
  return narrow_union_bytes(D, R, threads, span, esize) +
         narrow_stages(span) * narrow_raw_floats(d, R, span, centered) * 4;
}

// micro-tile m of a tile pair: (a, b) in units of 4 columns; on a diagonal
// pair the upper triangle's micro-tiles, row-major
__device__ __forceinline__ void micro_decode(int m, bool diag, int ma, int mb, int* a, int* b) {
  if (!diag) {
    *a = m / mb;
    *b = m % mb;
    return;
  }
  int r = 0;
  while (m >= ma - r) {
    m -= ma - r;
    ++r;
  }
  *a = r;
  *b = r + m;
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = *reinterpret_cast<const float4*>(p);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = f.z;
  v[3] = f.w;
}
__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
  const double2 f = *reinterpret_cast<const double2*>(p);
  const double2 g = *reinterpret_cast<const double2*>(p + 2);
  v[0] = f.x;
  v[1] = f.y;
  v[2] = g.x;
  v[3] = g.y;
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(double* p, double a, double b) {
  *reinterpret_cast<double2*>(p) = make_double2(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// One block: tile pair blockIdx.x of the nt 64-column tiles, row chunk
// blockIdx.y; R rows a staged tile.  T (float: corr_gram, double: the
// centered mode) is the type of the operands and of a tile's sums.  Writes
// the pair's cells of the chunk's partial f64[chunks, D (D + 1) / 2].
template <typename T, bool CENTERED, bool SPAN>
__global__ void __launch_bounds__(kNarrowThreads)
gram_narrow(const float* __restrict__ X, const float* __restrict__ y,
            const double* __restrict__ c, double* __restrict__ partial, int n, int d, int nt,
            int chunk_rows, int R) {
  constexpr int NS = narrow_stages(SPAN);  // raw stages: NS - 1 row tiles in flight
  extern __shared__ __align__(16) unsigned char nsm[];
  const int D = CENTERED ? d + 1 : d;
  const int tid = threadIdx.x, nthr = blockDim.x;
  int ti, tj;
  pair_decode(blockIdx.x, nt, &ti, &tj);
  const bool diag = ti == tj;
  const int i0 = ti * kNarrowTile, j0 = tj * kNarrowTile;
  const int w = SPAN ? narrow_width(D, true) : (diag ? kNarrowTile : 2 * kNarrowTile);
  const int LD = narrow_width(D, SPAN) + 4;
  const int boff = diag ? 0 : kNarrowTile;  // the j tile's columns in an operand row
  T* op = reinterpret_cast<T*>(nsm);
  double* red = reinterpret_cast<double*>(nsm);
  const long long ub = narrow_union_bytes(D, R, nthr, SPAN, (int)sizeof(T));
  float* raw = reinterpret_cast<float*>(nsm + ub);
  const long long RAWF = narrow_raw_floats(d, R, SPAN, CENTERED);
  const long long yoff = ((long long)R * d + 3) / 4 * 4;  // SPAN: the labels in a stage
  // this thread's micro-tile and split of the rows
  const int ma = (min(kNarrowTile, D - i0) + 3) / 4, mb = (min(kNarrowTile, D - j0) + 3) / 4;
  const int MT = diag ? ma * (ma + 1) / 2 : ma * mb;
  const int S = max(1, min(nthr / MT, R / 4));
  const int RS = (R + S - 1) / S;
  const bool active = tid < MT * S;
  const int micro = tid % MT, split = tid / MT;
  int a, b;
  micro_decode(micro, diag, ma, mb, &a, &b);
  // this thread's column pair of the operand rows (every rstep-th row), its
  // columns' centers in registers
  const int wp = w / 2, cpair = tid % wp, rgrp = tid / wp, rstep = nthr / wp;
  const int cc0 = 2 * cpair;
  const int col0 = SPAN ? cc0 : (cc0 < kNarrowTile ? i0 + cc0 : j0 + cc0 - kNarrowTile);
  const double c0 = (CENTERED && col0 < D) ? c[col0] : 0.0;
  const double c1 = (CENTERED && col0 + 1 < D) ? c[col0 + 1] : 0.0;
  const long long r0 = (long long)blockIdx.y * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int ntiles = (int)((r1 - r0 + R - 1) / R);
  const int wshift = diag ? 6 : 7;  // COLS: log2 of the staged columns
  auto stage = [&](int t) {  // one copy group, empty past the chunk
    if (t >= ntiles) {
      cp_async_commit();
      return;
    }
    float* rb = raw + (t % NS) * RAWF;
    const long long rt = r0 + (long long)t * R;
    const int nr = (int)min((long long)R, r1 - rt);
    if (SPAN) {  // rt is a multiple of 4 rows: the span starts 16-byte aligned
      const float* src = X + rt * d;
      const int L = nr * d;
      for (int i = tid; i < L / 4; i += nthr) cp_async16(rb + 4 * i, src + 4 * i, true);
      for (int i = L / 4 * 4 + tid; i < L; i += nthr) cp_async4(rb + i, src + i, true);
      if (CENTERED)
        for (int i = tid; i < nr; i += nthr) cp_async4(rb + yoff + i, y + rt + i, true);
    } else {
      for (int i = tid; i < (nr << wshift); i += nthr) {
        const int r = i >> wshift, cc = i & ((1 << wshift) - 1);
        const int col = cc < kNarrowTile ? i0 + cc : j0 + cc - kNarrowTile;
        const bool ok = col < D;
        const float* src = !ok ? X : (col < d ? X + (rt + r) * d + col : y + rt + r);
        cp_async4(rb + r * 2 * kNarrowTile + cc, src, ok);
      }
    }
    cp_async_commit();
  };
  // the staged rows of tile t into the operands (rows past the chunk are not
  // read), centered in float64; zero past column D - 1
  auto convert = [&](int t) {
    const float* rb = raw + (t % NS) * RAWF;
    const int nr = (int)min((long long)R, r1 - (r0 + (long long)t * R));
    if (rgrp >= rstep) return;
#pragma unroll 2
    for (int r = rgrp; r < nr; r += rstep) {
      float v0, v1;
      if (SPAN) {
        const float* row = rb + r * d;
        v0 = col0 < d ? row[col0] : (CENTERED && col0 == d ? rb[yoff + r] : 0.0f);
        v1 = col0 + 1 < d ? row[col0 + 1] : (CENTERED && col0 + 1 == d ? rb[yoff + r] : 0.0f);
      } else {
        const float2 v = *reinterpret_cast<const float2*>(rb + r * 2 * kNarrowTile + cc0);
        v0 = v.x;
        v1 = v.y;
      }
      T e0 = (T)0, e1 = (T)0;
      if (col0 < D) e0 = CENTERED ? (T)__dsub_rn((double)v0, c0) : (T)v0;
      if (col0 + 1 < D) e1 = CENTERED ? (T)__dsub_rn((double)v1, c1) : (T)v1;
      store2(op + r * LD + cc0, e0, e1);
    }
  };
  double acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.0;
  const T* pa = op + 4 * a;
  const T* pb = op + boff + 4 * b;
  for (int t = 0; t < NS - 1; ++t) stage(t);
  for (int t = 0; t < ntiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(NS - 2));
    __syncthreads();  // tile t staged; tile t - 1's sums and conversion done
    stage(t + NS - 1);  // into the stage tile t - 1 left
    convert(t);
    __syncthreads();
    if (active) {
      const int nr = (int)min((long long)R, r1 - (r0 + (long long)t * R));
      const int ra = split * RS, rz = min(nr, ra + RS);
      T s[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = (T)0;
#pragma unroll 2
      for (int r = ra; r < rz; ++r) {
        T va[4], vb[4];
        load4(pa + r * LD, va);
        load4(pb + r * LD, vb);
#pragma unroll
        for (int k = 0; k < 4; ++k)
#pragma unroll
          for (int l = 0; l < 4; ++l) s[4 * k + l] = fma_rn(va[k], vb[l], s[4 * k + l]);
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = __dadd_rn(acc[e], (double)s[e]);
    }
  }
  // the splits' sums added in split order; the pair's cells of the chunk's
  // partial written
  __syncthreads();  // the operands are read (red takes their place)
  if (active)
#pragma unroll
    for (int e = 0; e < 16; ++e) red[(long long)e * MT * S + split * MT + micro] = acc[e];
  __syncthreads();
  double* P = partial + (long long)blockIdx.y * ((long long)D * (D + 1) / 2);
  for (int k = tid; k < MT * 16; k += nthr) {
    const int e = k / MT, m = k % MT;
    double s = red[(long long)e * MT * S + m];
    for (int sp = 1; sp < S; ++sp) s = __dadd_rn(s, red[(long long)e * MT * S + sp * MT + m]);
    int ka, kb;
    micro_decode(m, diag, ma, mb, &ka, &kb);
    const int i = i0 + 4 * ka + e / 4, j = j0 + 4 * kb + e % 4;
    if (i < D && j < D && (!diag || i <= j)) P[tri_offset(i, D) + (j - i)] = s;
  }
}

// ---- K-I: the tensor-core pass -------------------------------------------------
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

__device__ __forceinline__ bool wide_item(int it, int i0, int j0, int d, bool diag) {
  const int si = it / 4, sj = it % 4;
  return !(i0 + 32 * si >= d || j0 + 32 * sj >= d || (diag && si > sj));
}

// One block: tile pair blockIdx.x of the nt 128-column tiles of the d
// feature columns, row chunk blockIdx.y.  The label's column (D - 1 = d) is
// no tile's: on a diagonal pair the warps left without an item take it,
// one a 32-column sub-block of the tile (an m16n8k8 product of the tile's
// operand and the centered labels, column 0 of the 8), and the diagonal
// block of tile 0 also sums the labels' squares.  VEC: 16-byte copies (d %
// 4 == 0 and X 16-byte aligned).  Writes the pair's cells of the chunk's
// partial.
template <bool VEC>
__global__ void __launch_bounds__(kWThreads, 1)
gram_wide(const float* __restrict__ X, const float* __restrict__ y, const double* __restrict__ c,
          double* __restrict__ partial, int n, int d, int nt, int chunk_rows) {
  extern __shared__ __align__(16) unsigned char wsm[];
  __shared__ double yy;  // the labels' squares (tile 0's diagonal block)
  __shared__ __align__(16) double cs[2 * kWT];  // the staged columns' centers
  float* raw = reinterpret_cast<float*>(wsm);  // [2][kWRaw]
  double* ops = reinterpret_cast<double*>(wsm + 2 * kWRaw * sizeof(float));  // [2][kWOps]
  const int D = d + 1;
  int ti, tj;
  pair_decode(blockIdx.x, nt, &ti, &tj);
  const bool diag = ti == tj;
  const int i0 = ti * kWT, j0 = tj * kWT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g = lane / 4, t = lane % 4;
  if (tid == 0) yy = 0.0;
  for (int k = tid; k < 2 * kWT; k += kWThreads) {
    const int col = k < kWT ? i0 + k : j0 + k - kWT;
    cs[k] = col < d ? c[col] : 0.0;
  }
  int items = 0;
  for (int it = 0; it < 16; ++it) items += wide_item(it, i0, j0, d, diag);
  const int split = items * 4 <= kWWarps ? 4 : (items * 2 <= kWWarps ? 2 : 1);
  const int part = warp % split;
  int mine = -1;  // this warp's item
  for (int it = 0, cnt = 0; it < 16; ++it) {
    if (!wide_item(it, i0, j0, d, diag)) continue;
    if (cnt == warp / split) mine = it;
    ++cnt;
  }
  // a warp without an item on a diagonal pair: the label's sub-block it takes
  const int li = warp - items * split;
  const int lsub = diag && li >= 0 && li < kWT / 32 && i0 + 32 * li < d ? li : -1;
  const bool squares = diag && ti == 0 && li == 0 && lane == 0;  // the labels' squares
  const int si = mine >= 0 ? mine / 4 : (lsub >= 0 ? lsub : 0), sj = mine >= 0 ? mine % 4 : 0;
  double acc[2][4][4];  // a label warp's sums in acc[mt][0]
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][q][e] = 0.0;
  const long long r0 = (long long)blockIdx.y * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int nslabs = (int)((r1 - r0 + kWSlab - 1) / kWSlab);
  // staged columns: both tiles' 256, or a diagonal pair's 128 (its j tile is
  // its i tile)
  const int wshift = diag ? 7 : 8;
  // a slab's raw floats: the columns of the i tile, then of the j tile, then
  // the labels; rows past the chunk and columns past d - 1 zero-filled
  auto stage = [&](int s) {
    float* rb = raw + (s & 1) * kWRaw;
    const long long rt = r0 + (long long)s * kWSlab;
    const int nr = (int)min((long long)kWSlab, r1 - rt);
    if (VEC) {
      const int gshift = wshift - 2;  // groups of 4 columns a row
#pragma unroll
      for (int k = tid; k < (kWSlab << gshift); k += kWThreads) {
        const int rr = k >> gshift, cc = 4 * (k & ((1 << gshift) - 1));
        const int col = cc < kWT ? i0 + cc : j0 + cc - kWT;
        const bool ok = rr < nr && col < d;  // d % 4 == 0: a group is wholly in or out
        cp_async16(rb + rr * 2 * kWT + cc, ok ? X + (rt + rr) * d + col : X, ok);
      }
    } else {
      for (int k = tid; k < (kWSlab << wshift); k += kWThreads) {
        const int rr = k >> wshift, cc = k & ((1 << wshift) - 1);
        const int col = cc < kWT ? i0 + cc : j0 + cc - kWT;
        const bool ok = rr < nr && col < d;
        cp_async4(rb + rr * 2 * kWT + cc, ok ? X + (rt + rr) * d + col : X, ok);
      }
    }
    if (tid < kWSlab) cp_async4(rb + kWSlab * 2 * kWT + tid, tid < nr ? y + rt + tid : y,
                                tid < nr);
    cp_async_commit();
  };
  // the operands of slab s, centered in float64, into buffer s & 1: A = the
  // i tile's columns, then the centered labels in column kWT of A's rows, B
  // = the j tile's (none on a diagonal pair); zero past the chunk's rows and
  // column d - 1.  A thread converts one column pair over every rstep-th row
  // (8 rows, or 4 on a diagonal pair), the threads of column pair 0 the
  // labels too; quarter q of them a call.
  const int cpairs = 1 << (wshift - 1);
  const int cp = tid % cpairs, rg = tid / cpairs, rstep = kWThreads / cpairs;
  const int per = kWSlab / rstep / 4;  // rows a quarter
  const int h = cp >= kWT / 2;      // a column pair of the j tile
  const int c2 = 2 * cp - h * kWT;  // its first column within its tile
  const int col = (h ? j0 : i0) + c2;
  auto convert = [&](int s, int quarter) {
    const float* rb = raw + (s & 1) * kWRaw + h * kWT + c2;
    const float* ys = raw + (s & 1) * kWRaw + kWSlab * 2 * kWT;
    double* As = ops + (s & 1) * kWOps;
    double* dst = As + h * kWSlab * kWLd + c2;
    const int nr = (int)min((long long)kWSlab, r1 - (r0 + (long long)s * kWSlab));
    const double2 cc = *reinterpret_cast<const double2*>(cs + h * kWT + c2);
    for (int k = 0; k < per; ++k) {
      const int rr = rg + rstep * (quarter * per + k);
      const float2 xv = *reinterpret_cast<const float2*>(rb + rr * 2 * kWT);
      const bool row = rr < nr;
      double2 v;
      v.x = (row && col < d) ? __dsub_rn((double)xv.x, cc.x) : 0.0;
      v.y = (row && col + 1 < d) ? __dsub_rn((double)xv.y, cc.y) : 0.0;
      *reinterpret_cast<double2*>(dst + rr * kWLd) = v;
      if (cp == 0) As[rr * kWLd + kWT] = row ? __dsub_rn((double)ys[rr], __ldg(c + d)) : 0.0;
    }
  };
  // two slabs in flight: slab s + 1's copies and its conversion overlap slab
  // s's products, a quarter of the conversion after each step's products
  // (the operands double buffered too)
  if (nslabs > 0) stage(0);
  if (nslabs > 1) stage(1);
  if (nslabs > 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    cp_async_wait_all();
  __syncthreads();
  if (nslabs > 0)
    for (int q = 0; q < 4; ++q) convert(0, q);
  for (int s = 0; s < nslabs; ++s) {
    cp_async_wait_all();
    __syncthreads();  // slab s converted, slab s + 1 staged; slab s - 1's products done
    const double* As = ops + (s & 1) * kWOps;
    const double* Bs = diag ? As : As + kWSlab * kWLd;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int kk = 8 * q;
      if ((mine >= 0 && q % split == part) || lsub >= 0) {
        double fa[2][4], fb[2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const double* ap = As + (kk + t) * kWLd + si * 32 + mt * 16 + g;
          fa[mt][0] = ap[0];
          fa[mt][1] = ap[8];
          fa[mt][2] = ap[4 * kWLd];
          fa[mt][3] = ap[4 * kWLd + 8];
        }
        if (mine >= 0) {
#pragma unroll
          for (int nn = 0; nn < 4; ++nn) {
            const double* bp = Bs + (kk + t) * kWLd + sj * 32 + nn * 8 + g;
            fb[0] = bp[0];
            fb[1] = bp[4 * kWLd];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) dmma_16x8x8(acc[mt][nn], fa[mt], fb);
          }
        } else {  // the labels as column 0 of an 8-column operand
          fb[0] = g == 0 ? As[(kk + t) * kWLd + kWT] : 0.0;
          fb[1] = g == 0 ? As[(kk + t + 4) * kWLd + kWT] : 0.0;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) dmma_16x8x8(acc[mt][0], fa[mt], fb);
        }
      }
      if (q == 0 && s + 2 < nslabs) stage(s + 2);
      if (s + 1 < nslabs) convert(s + 1, q);
    }
    if (squares) {
      double v2 = yy;
      for (int rr = 0; rr < kWSlab; ++rr) {
        const double v = As[rr * kWLd + kWT];
        v2 = __fma_rn(v, v, v2);
      }
      yy = v2;
    }
  }
  double* P = partial + (long long)blockIdx.y * ((long long)D * (D + 1) / 2);
  if (lsub >= 0 && t == 0)  // lanes of column 0: rows g and g + 8 of each 16
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int i = i0 + 32 * lsub + 16 * mt + g + (e ? 8 : 0);
        if (i < d) P[tri_offset(i, D) + (d - i)] = acc[mt][0][e];
      }
  if (squares) P[tri_offset(d, D)] = yy;
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
            acc[mt][nn][e] = __dadd_rn(acc[mt][nn][e],
                                       red[w * 32 * 32 + ((mt * 4 + nn) * 4 + e) * 32 + lane]);
  }
  if (mine < 0) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nn = 0; nn < 4; ++nn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + si * 32 + mt * 16 + g + (e >= 2 ? 8 : 0);
        const int j = j0 + sj * 32 + nn * 8 + 2 * t + (e & 1);
        if (i < d && j < d && i <= j) P[tri_offset(i, D) + (j - i)] = acc[mt][nn][e];
      }
}

// The launch arguments of K-I as ops/stats.py::gram_plan gives them, checked
// against the shape: 0, or cudaErrorInvalidValue.
int check_plan(long long n, int d, int D, int tile, int nt, int chunk_rows, int chunks,
               int lanes, int rows) {
  if (n <= 0 || d < 0 || D <= 0 || nt != (D + tile - 1) / tile || rows <= 0 || rows % 4 != 0 ||
      chunk_rows <= 0 || chunk_rows % rows != 0 || chunks <= 0 || chunks > 65535 ||
      chunks != (n + chunk_rows - 1) / chunk_rows || lanes < 1 || lanes > 32 ||
      (lanes & (lanes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

template <bool CORR>
int launch_finish(const void* partial, void* out, int D, int chunks, int lanes, float denom,
                  cudaStream_t st) {
  const long long threads = (long long)D * (D + 1) / 2 * lanes;
  gram_finish<CORR><<<(unsigned)((threads + 255) / 256), 256, 0, st>>>(
      (const double*)partial, out, D, chunks, lanes, denom);
  return (int)cudaGetLastError();
}

template <typename T, bool CENTERED>
int launch_narrow(const void* X, const void* y, const void* centers, void* partial, void* out,
                  int n, int d, int nt, int chunk_rows, int chunks, int lanes, int threads,
                  int rows, int smem, float denom, cudaStream_t st) {
  const int D = CENTERED ? d + 1 : d;
  const bool span = nt == 1;
  int rc = check_plan(n, d, D, kNarrowTile, nt, chunk_rows, chunks, lanes, rows);
  if (rc) return rc;
  const int m = (min(D, kNarrowTile) + 3) / 4;
  const int w = span ? (D + 3) / 4 * 4 : kNarrowTile;  // the fewest operand columns a pair
  if (threads < 32 || threads > kNarrowThreads || threads % 32 != 0 ||
      threads < (span ? m * (m + 1) / 2 : kNarrowThreads) || threads < w / 2 ||
      smem != narrow_smem(d, D, rows, threads, span, (int)sizeof(T), CENTERED) ||
      smem > kSmemMax - 2048 || (span && ((uintptr_t)X % 16 != 0)) || (CENTERED && !span))
    return (int)cudaErrorInvalidValue;
  // the shared-memory limit raised once an instantiation, to the most a
  // plan asks (a call of cudaFuncSetAttribute each launch cost its time)
  static bool raised[2] = {false, false};
  if (!raised[span]) {
    cudaError_t err = cudaFuncSetAttribute(
        span ? (const void*)gram_narrow<T, CENTERED, true>
             : (const void*)gram_narrow<T, CENTERED, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax - 2048);
    if (err != cudaSuccess) return (int)err;
    raised[span] = true;
  }
  dim3 grid((unsigned)(nt * (nt + 1) / 2), (unsigned)chunks);
#define NARROW_ARGS                                                                      \
  (const float*)X, (const float*)y, (const double*)centers, (double*)partial, n, d, nt, \
      chunk_rows, rows
  if (span)
    gram_narrow<T, CENTERED, true><<<grid, threads, smem, st>>>(NARROW_ARGS);
  else
    gram_narrow<T, CENTERED, false><<<grid, threads, smem, st>>>(NARROW_ARGS);
#undef NARROW_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_finish<!CENTERED>(partial, out, D, chunks, lanes, denom, st);
}

}  // namespace

// the number of row chunks of K-J, so the caller can size ``partial``
extern "C" int col_products_chunks(int n, int da, int db) {
  if (n <= 0 || da <= 0 || db <= 0) return 0;
  const int rows = chunk_rows_for(n, da, db);
  return (n + rows - 1) / rows;
}

// K-J: out f32[d, c] = X^T onehot(cls, c); partial f32[chunks, d, c]
extern "C" int contingency_counts_f32(const void* X, const void* cls, void* partial, void* out,
                                      int n, int d, int c, void* stream) {
  if (n <= 0 || d <= 0 || c <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = chunk_rows_for(n, d, c);
  const int chunks = (n + rows - 1) / rows;
  dim3 grid((d + kTile - 1) / kTile, (c + kTile - 1) / kTile, chunks);
  contingency_partial<<<grid, dim3(kTile, kTile), 0, st>>>(
      (const float*)X, (const int32_t*)cls, (float*)partial, n, d, c, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = d * c;
  contingency_reduce<<<(total + 255) / 256, 256, 0, st>>>((const float*)partial, (float*)out,
                                                          chunks, total);
  return (int)cudaGetLastError();
}

// K-I: out f32[d, d] = Z^T Z / denom (Z f32[n, d], 16-byte aligned where d <=
// 64) by the plan of ops/stats.py::gram_plan(n, d, "corr"): nt 64-column
// tiles, row chunks of chunk_rows, the finish's lanes a cell, threads a
// block, rows a staged tile, smem its dynamic shared bytes; partial
// f64[chunks, d (d + 1) / 2].
extern "C" int corr_gram_f32(const void* Z, void* partial, void* out, int n, int d, int nt,
                             int chunk_rows, int chunks, int lanes, int threads, int rows,
                             int smem, float denom, void* stream) {
  return launch_narrow<float, false>(Z, nullptr, nullptr, partial, out, n, d, nt, chunk_rows,
                                     chunks, lanes, threads, rows, smem, denom,
                                     (cudaStream_t)stream);
}

// K-I centered mode: out f64[D, D] = Z^T Z, Z = [X | y] - centers, D = d + 1
// (X f32[n, d] and y f32[n] 16-byte aligned, centers f64[D]) by the plan of
// ops/stats.py::gram_plan(n, d, "centered"): wide = 0 the CUDA-core pass (D
// <= 64: one tile), 1 the tensor-core pass (128-column tiles, 32-row slabs,
// 512 threads); the other arguments as corr_gram_f32's.
extern "C" int centered_gram_f64(const void* X, const void* y, const void* centers,
                                 void* partial, void* out, int n, int d, int wide, int nt,
                                 int chunk_rows, int chunks, int lanes, int threads, int rows,
                                 int smem, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (!wide)
    return launch_narrow<double, true>(X, y, centers, partial, out, n, d, nt, chunk_rows,
                                       chunks, lanes, threads, rows, smem, 1.0f, st);
  const int D = d + 1;
  int rc = check_plan(n, d, d, kWT, nt, chunk_rows, chunks, lanes, rows);  // tiles of d
  if (rc) return rc;
  if (D <= kNarrowTile || threads != kWThreads || rows != kWSlab || smem != kWSmem)
    return (int)cudaErrorInvalidValue;
  const bool vec = d % 4 == 0 && (uintptr_t)X % 16 == 0;
  static bool raised[2] = {false, false};
  if (!raised[vec]) {
    cudaError_t err = cudaFuncSetAttribute(
        vec ? (const void*)gram_wide<true> : (const void*)gram_wide<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kWSmem);
    if (err != cudaSuccess) return (int)err;
    raised[vec] = true;
  }
  dim3 grid((unsigned)(nt * (nt + 1) / 2), (unsigned)chunks);
#define WIDE_ARGS \
  (const float*)X, (const float*)y, (const double*)centers, (double*)partial, n, d, nt, chunk_rows
  if (vec)
    gram_wide<true><<<grid, kWThreads, kWSmem, st>>>(WIDE_ARGS);
  else
    gram_wide<false><<<grid, kWThreads, kWSmem, st>>>(WIDE_ARGS);
#undef WIDE_ARGS
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return launch_finish<false>(partial, out, D, chunks, lanes, 1.0f, st);
}
