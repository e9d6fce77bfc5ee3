// K-I corr_gram and K-J contingency_counts: the sanity checker's two column
// products.
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
