// K-I corr_gram and centered_gram, and K-J contingency_counts: the sanity
// checker's column products.
//
// Replaces: transmogrifai_tpu/utils/stats.py::_corr_matrix_kernel (:47),
// the correlation matrix Z^T Z / max(n - 1, 1) of the standardized columns
// Z f32[n, d], and ::_contingency_kernel (:137), the contingency counts
// X^T onehot(y) of the indicator columns X f32[n, d] against the label
// classes y i32[n] (the one-hot is never built: a row adds to its class).
//
// Runs repeat bit for bit: a block takes a chunk of rows and a 16 x 16 tile
// of the output, one thread per output cell, and sums its chunk in row
// order; a second kernel adds the chunks' partial sums in chunk order and
// divides.  No atomics.  Counts of indicator columns are integers and sum
// exactly in any order (below 2^24), so K-J agrees with any exact float32
// product; K-I's sums differ from another order's in the last bits.
//
// Bound on the card: bytes for K-J (the columns and classes read once);
// K-I does 2 n d^2 operations over n d 4 bytes, near the card's balance.
//
// K-I's centered mode replaces transmogrifai_tpu/parallel/stats.py::
// _gram_step (:62) and the Gram half of ::_fused_stats_step (:190): the
// unscaled Gram Z^T Z f64[D, D] of the D = d + 1 columns Z = [X | y] - c of
// one row chunk (X f32[n, d], y f32[n], the centers c f64[D]), which holds
// the feature Gram, the label cross terms and the label's sum of squares.
// It has its own tiling (the float32 modes' 16 x 16 tiles, one cell a
// thread and two shared-memory loads a float64 FMA, ran 13x slower than
// torch.mm at 2^18 x 513 on the H100): a block takes a 32 x 32 output tile
// of the upper triangle and a chunk of rows; a thread keeps a 4 x 4
// micro-tile of float64 sums in registers, so 8 loads feed 16 FMAs.  Four
// row groups of 64 threads each stage the chunk in 16-row slabs, centered
// in float64 on the store, a thread fetching the next slab into registers
// while its group sums the current one; the groups merge in group order.
// (64 x 64 tiles of 256 threads ran no faster at 2^18 x 513 and slower at
// 65 to 129 columns on the H100.)  The lower triangle is the upper's
// mirror, so the Gram is exactly symmetric; a reduce kernel adds the
// chunks' partials in a fixed order (8 lanes a cell, then lane order).  No
// atomics: runs repeat bit for bit.  Bound on the card: float64 operations
// at large D, bytes at small.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 16;
constexpr int kRows = 32;  // rows staged in shared memory per step
constexpr int kTargetBlocks = 4 * 132;

// partial[chunk, j, k] = sum over the chunk's rows r of A[r, j] * B[r, k],
// with B[r, k] = (cls[r] == k) when ONEHOT, else Bm[r, k]
template <bool ONEHOT>
__global__ void col_products_partial(const float* __restrict__ A, const float* __restrict__ Bm,
                                     const int32_t* __restrict__ cls,
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
      if (ONEHOT) {
        sb[rr][cc] = (row && k0 + cc < db && cls[r] == k0 + cc) ? 1.0f : 0.0f;
      } else {
        sb[rr][cc] = (row && k0 + cc < db) ? Bm[r * db + k0 + cc] : 0.0f;
      }
    }
    __syncthreads();
    const int steps = (int)min((long long)kRows, r1 - rb);
    for (int rr = 0; rr < steps; ++rr) acc = __fmaf_rn(sa[rr][ty], sb[rr][tx], acc);
    __syncthreads();
  }
  if (j0 + ty < da && k0 + tx < db)
    partial[((long long)blockIdx.z * da + j0 + ty) * db + k0 + tx] = acc;
}

// out[i] = (sum over chunks c, in order, of partial[c, i]) / denom
__global__ void col_products_reduce(const float* __restrict__ partial, float* __restrict__ out,
                                    int chunks, int total, float denom) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  float s = 0.0f;
  for (int c = 0; c < chunks; ++c) s = __fadd_rn(s, partial[(long long)c * total + i]);
  out[i] = __fdiv_rn(s, denom);
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

template <bool ONEHOT>
int launch(const void* A, const void* Bm, const void* cls, void* partial, void* out, int n,
           int da, int db, float denom, void* stream) {
  if (n <= 0 || da <= 0 || db <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = chunk_rows_for(n, da, db);
  const int chunks = (n + rows - 1) / rows;
  dim3 grid((da + kTile - 1) / kTile, (db + kTile - 1) / kTile, chunks);
  col_products_partial<ONEHOT><<<grid, dim3(kTile, kTile), 0, st>>>(
      (const float*)A, (const float*)Bm, (const int32_t*)cls, (float*)partial, n, da, db,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = da * db;
  col_products_reduce<<<(total + 255) / 256, 256, 0, st>>>((const float*)partial, (float*)out,
                                                           chunks, total, denom);
  return (int)cudaGetLastError();
}

// ---- K-I centered mode ------------------------------------------------------
constexpr int kGramTile = 32;  // output tile side
constexpr int kGroups = 4;     // row groups a block
constexpr int kSlab = 16;      // rows a group stages a step
constexpr int kMinChunkRows = 256;

// partial[chunk, j, k] (and [k, j]) for the block's upper-triangle tile
// pair and row chunk; kGramTile / 4 threads a side in each of kGroups row
// groups.  A thread stages one column of the tile: it fetches the next
// slab's values into registers while the block sums the current one
__global__ void __launch_bounds__((kGramTile / 4) * (kGramTile / 4) * kGroups)
centered_gram_partial(const float* __restrict__ X, const float* __restrict__ y,
                      const double* __restrict__ c, double* __restrict__ partial, int n, int d,
                      int tiles, int chunk_rows) {
  constexpr int kSide = kGramTile / 4;
  constexpr int kGroup = kSide * kSide;
  constexpr int kStage = kGroups * kSlab * kGramTile;  // one operand's slabs
  constexpr int kRowStep = kGroup / kGramTile;       // a thread's staged rows are this far apart
  constexpr int kPer = kSlab / kRowStep;         // values a thread stages a slab, per operand
  static_assert(kGroup % kGramTile == 0 && kSlab % kRowStep == 0, "staging layout");
  static_assert(2 * kStage >= kGroups * kGroup * 16, "the group merge reuses the slabs");
  __shared__ double smem[2 * kStage];
  const int D = d + 1;
  int ti = 0, rest = blockIdx.x;  // the tile pair ti <= tj, row-major
  while (rest >= tiles - ti) {
    rest -= tiles - ti;
    ++ti;
  }
  const int tj = ti + rest;
  const bool diag = ti == tj;
  const int j0 = ti * kGramTile, k0 = tj * kGramTile;
  const int g = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int tx = t % kSide, ty = t / kSide;
  double* sa = smem + g * kSlab * kGramTile;
  double* sb = diag ? sa : smem + kStage + g * kSlab * kGramTile;
  const long long r0 = (long long)blockIdx.y * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  const int slabs = (int)((r1 - r0 + kSlab - 1) / kSlab);
  // the staged column of each operand (column d is the label), its center
  const int cc = t % kGramTile, rr0 = t / kGramTile;
  const int ja = j0 + cc, jb = k0 + cc;
  const double ca = ja <= d ? c[ja] : 0.0, cb = jb <= d ? c[jb] : 0.0;
  float va[kPer], vb[kPer];
  auto fetch = [&](int slab) {
    const long long rs = r0 + (long long)slab * kSlab + rr0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const long long r = rs + (long long)q * kRowStep;
      const bool row = r < r1;
      va[q] = (row && ja <= d) ? (ja < d ? X[r * d + ja] : y[r]) : 0.0f;
      if (!diag) vb[q] = (row && jb <= d) ? (jb < d ? X[r * d + jb] : y[r]) : 0.0f;
    }
  };
  double acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = 0.0;
  fetch(g);
  for (int base = 0; base < slabs; base += kGroups) {
    const long long rs = r0 + (long long)(base + g) * kSlab + rr0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {  // centered in float64; 0 outside the chunk
      const bool row = rs + (long long)q * kRowStep < r1;
      const int e = (rr0 + q * kRowStep) * kGramTile + cc;
      sa[e] = (row && ja <= d) ? (double)va[q] - ca : 0.0;
      if (!diag) sb[e] = (row && jb <= d) ? (double)vb[q] - cb : 0.0;
    }
    __syncthreads();
    if (base + kGroups < slabs) fetch(base + kGroups + g);
#pragma unroll 4
    for (int rr = 0; rr < kSlab; ++rr) {
      double a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = sa[rr * kGramTile + ty + i * kSide];
        b[i] = sb[rr * kGramTile + tx + i * kSide];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[i][k] = __fma_rn(a[i], b[k], acc[i][k]);
    }
    __syncthreads();
  }
  // merge the row groups in group order
#pragma unroll
  for (int q = 0; q < 16; ++q) smem[(g * 16 + q) * kGroup + t] = acc[q / 4][q % 4];
  __syncthreads();
  if (g != 0) return;
  for (int gg = 1; gg < kGroups; ++gg)
#pragma unroll
    for (int q = 0; q < 16; ++q)
      acc[q / 4][q % 4] = __dadd_rn(acc[q / 4][q % 4], smem[(gg * 16 + q) * kGroup + t]);
  double* P = partial + (long long)blockIdx.y * D * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = j0 + ty + i * kSide;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int kk = k0 + tx + k * kSide;
      if (j < D && kk < D) {
        P[(long long)j * D + kk] = acc[i][k];
        if (!diag) P[(long long)kk * D + j] = acc[i][k];
      }
    }
  }
}

// out[i] = the sum over chunks of partial[c, i]: lane l of 8 sums the
// chunks l, l + 8, ... in order, then the lanes add in lane order
__global__ void centered_gram_reduce(const double* __restrict__ partial, double* __restrict__ out,
                                     int chunks, int total) {
  __shared__ double s[8][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  double v = 0.0;
  if (i < total)
    for (int ch = threadIdx.y; ch < chunks; ch += 8)
      v = __dadd_rn(v, partial[(long long)ch * total + i]);
  s[threadIdx.y][threadIdx.x] = v;
  __syncthreads();
  if (threadIdx.y != 0 || i >= total) return;
  double sum = s[0][threadIdx.x];
  for (int l = 1; l < 8; ++l) sum = __dadd_rn(sum, s[l][threadIdx.x]);
  out[i] = sum;
}

// (rows a chunk, chunks) for D columns: about kTargetBlocks blocks
void centered_chunking(int n, int D, int* rows_out, int* chunks_out) {
  const int tiles = (D + kGramTile - 1) / kGramTile;
  const long long pairs = (long long)tiles * (tiles + 1) / 2;
  long long chunks = (kTargetBlocks + pairs - 1) / pairs;
  const long long max_chunks = (n + kMinChunkRows - 1) / kMinChunkRows;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  long long rows = (n + chunks - 1) / chunks;
  rows = (rows + kSlab - 1) / kSlab * kSlab;
  *rows_out = (int)rows;
  *chunks_out = (int)((n + rows - 1) / rows);
}

}  // namespace

// the number of row chunks, so the caller can size ``partial``
extern "C" int col_products_chunks(int n, int da, int db) {
  if (n <= 0 || da <= 0 || db <= 0) return 0;
  const int rows = chunk_rows_for(n, da, db);
  return (n + rows - 1) / rows;
}

// K-I: out f32[d, d] = Z^T Z / denom; partial f32[chunks, d, d]
extern "C" int corr_gram_f32(const void* Z, void* partial, void* out, int n, int d, float denom,
                             void* stream) {
  return launch<false>(Z, Z, nullptr, partial, out, n, d, d, denom, stream);
}

// K-J: out f32[d, c] = X^T onehot(cls, c); partial f32[chunks, d, c]
extern "C" int contingency_counts_f32(const void* X, const void* cls, void* partial, void* out,
                                      int n, int d, int c, void* stream) {
  return launch<true>(X, nullptr, cls, partial, out, n, d, c, 1.0f, stream);
}

// the row chunks of K-I's centered mode, so the caller can size ``partial``
extern "C" int centered_gram_chunks(int n, int d) {
  if (n <= 0 || d < 0) return 0;
  int rows, chunks;
  centered_chunking(n, d + 1, &rows, &chunks);
  return chunks;
}

// K-I centered mode: out f64[d + 1, d + 1] = Z^T Z, Z = [X | y] - centers
// (X f32[n, d], y f32[n], centers f64[d + 1]); partial f64[chunks, d + 1, d + 1]
extern "C" int centered_gram_f64(const void* X, const void* y, const void* centers,
                                 void* partial, void* out, int n, int d, void* stream) {
  if (n <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int D = d + 1;
  int rows, chunks;
  centered_chunking(n, D, &rows, &chunks);
  const int tiles = (D + kGramTile - 1) / kGramTile;
  dim3 grid(tiles * (tiles + 1) / 2, chunks);
  centered_gram_partial<<<grid, (kGramTile / 4) * (kGramTile / 4) * kGroups, 0, st>>>(
      (const float*)X, (const float*)y, (const double*)centers, (double*)partial, n, d, tiles,
      rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int total = D * D;
  centered_gram_reduce<<<(total + 31) / 32, dim3(32, 8), 0, st>>>((const double*)partial,
                                                                  (double*)out, chunks, total);
  return (int)cudaGetLastError();
}
