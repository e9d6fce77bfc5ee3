// K-X chunk_moments and K-Y midranks: the streamed sanity checker's column
// moments of one row chunk, and the per-column midranks of Spearman's rank
// transform.
//
// K-X replaces transmogrifai_tpu/parallel/stats.py::_moments_step (:48), the
// raw carry (sum x, sum x^2, min, max) of a chunk X f32[rows, d], and the
// moment half of ::_fused_stats_step (:190) and ::_chan_moments_step (:230):
// the chunk's mean, centered sum of squares M2, min and max, which the
// caller merges into its carry by Chan's pairwise rule.  The chunk is the
// columns [X | y] when a label y f32[rows] is given (its column last).  The
// reference's mask marks the padding rows of a sharded chunk; one device
// pads nothing, so every row counts and the count is the chunk's rows.
//
// Design: columns across threads (32 a block), rows across 8 lanes of a
// block and across blocks (row chunks, as K-I tiles rows).  A thread keeps
// float64 sums (raw) or a float64 Welford mean and M2 (Chan) of its rows;
// the block merges its 8 lanes in lane order and writes a partial; a
// second kernel merges the partials, one block a column, in a fixed tree
// order (a serial merge of ~500 partials a column took 0.28 ms on the H100).
// The mean is never taken from raw sums in Chan mode, no atomics: runs
// repeat bit for bit.
// Bound on the card: bytes (X read once; 4 d float64 written).
//
// K-Y replaces ::_midrank_cols (:487) beyond its sort: for each column of
// a block sorted by torch.sort (values ss [k, n], their rows order [k, n]),
// the average-tie midrank (lo + hi + 1) / 2 of every position, lo the first
// and hi one past the last position of its tie run, scattered back through
// the permutation into out f32[n, k].  That is the reference's two
// searchsorteds and its .at[order].set.  One block a segment of 2,048
// positions of one column (many blocks a column, so a few columns of a
// million rows fill the card), not one block a column: a first kernel finds
// each segment's first and last run start, a second scans run starts inside
// its segment (a block max-scan for lo, a reverse min-scan for hi) and looks
// back and ahead across segments through the first kernel's results, so a
// run that crosses a segment boundary (a tie-heavy column has runs of
// 65,536) costs no more than any other.  Float32 out, as the reference's:
// (float)(lo + hi + 1) * 0.5 rounds as its int-to-float32 cast does, exact
// below 2^23 rows.  Bound on the card: bytes (the sort's reads and the
// scatter).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns a block (threadIdx.x)
constexpr int kLanes = 8;   // row lanes a block (threadIdx.y)
constexpr int kTargetBlocks = 4 * 132;
constexpr int kSegThreads = 256;
constexpr int kPerThread = 8;
constexpr int kSeg = kSegThreads * kPerThread;  // positions a K-Y segment

// min / max that keep a NaN once seen, as jnp.minimum / jnp.maximum
__device__ __forceinline__ float nan_min(float a, float b) { return (b < a || isnan(b)) ? b : a; }
__device__ __forceinline__ float nan_max(float a, float b) { return (b > a || isnan(b)) ? b : a; }

__device__ __forceinline__ float column_value(const float* X, const float* y, long long r, int j,
                                              int d) {
  return j < d ? X[r * d + j] : y[r];
}

// the rows of lane ``lane`` in [r0, r1) with kLanes lanes
__device__ __forceinline__ long long lane_rows(long long r0, long long r1, int lane) {
  const long long span = r1 - r0 - lane;
  return span > 0 ? (span + kLanes - 1) / kLanes : 0;
}

// Chan's pairwise merge of (na, ma, qa) with (nb, mb, qb): mean and M2
__device__ __forceinline__ void chan_merge(double& na, double& ma, double& qa, double nb,
                                           double mb, double qb) {
  if (nb <= 0.0) return;
  if (na <= 0.0) {
    na = nb; ma = mb; qa = qb;
    return;
  }
  const double nt = na + nb;
  const double dx = mb - ma;
  qa = qa + qb + dx * dx * (na * nb / nt);
  ma = ma + dx * (nb / nt);
  na = nt;
}

// partial[4, chunks, dc]: (sum or mean, sum of squares or M2, min, max) of
// each column over the chunk's rows
template <bool CHAN>
__global__ void moments_partial(const float* __restrict__ X, const float* __restrict__ y,
                                double* __restrict__ partial, int n, int d, int dc,
                                int chunk_rows, int chunks) {
  __shared__ double sa[kLanes][kCols], sb[kLanes][kCols];
  __shared__ float smn[kLanes][kCols], smx[kLanes][kCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int j = blockIdx.x * kCols + tx;
  const int c = blockIdx.y;
  const long long r0 = (long long)c * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  double a = 0.0, b = 0.0, k = 0.0;
  float mn = INFINITY, mx = -INFINITY;
  if (j < dc) {
    for (long long r = r0 + ty; r < r1; r += kLanes) {
      const float xf = column_value(X, y, r, j, d);
      const double x = (double)xf;
      if (CHAN) {
        k += 1.0;
        const double delta = x - a;
        a += delta / k;
        b = fma(delta, x - a, b);
      } else {
        a += x;
        b = fma(x, x, b);
      }
      mn = nan_min(mn, xf);
      mx = nan_max(mx, xf);
    }
  }
  sa[ty][tx] = a; sb[ty][tx] = b; smn[ty][tx] = mn; smx[ty][tx] = mx;
  __syncthreads();
  if (ty != 0 || j >= dc) return;
  double na = (double)lane_rows(r0, r1, 0);
  for (int l = 1; l < kLanes; ++l) {
    if (CHAN) {
      chan_merge(na, a, b, (double)lane_rows(r0, r1, l), sa[l][tx], sb[l][tx]);
    } else {
      a += sa[l][tx];
      b += sb[l][tx];
    }
    mn = nan_min(mn, smn[l][tx]);
    mx = nan_max(mx, smx[l][tx]);
  }
  const long long plane = (long long)chunks * dc;
  const long long at = (long long)c * dc + j;
  partial[at] = a;
  partial[plane + at] = b;
  partial[2 * plane + at] = (double)mn;
  partial[3 * plane + at] = (double)mx;
}

// out[4, dc]: the partials merged by one block a column in a fixed order:
// thread t merges chunks t, t + kMergeThreads, ... in turn, then the block's
// threads merge pairwise (t with t + s, s = 128, 64, ..., 1)
constexpr int kMergeThreads = 256;

template <bool CHAN>
__global__ void moments_reduce(const double* __restrict__ partial, double* __restrict__ out,
                               int n, int dc, int chunk_rows, int chunks) {
  __shared__ double sn[kMergeThreads], sa[kMergeThreads], sb[kMergeThreads];
  __shared__ float smn[kMergeThreads], smx[kMergeThreads];
  const int j = blockIdx.x, t = threadIdx.x;
  const long long plane = (long long)chunks * dc;
  double na = 0.0, a = 0.0, b = 0.0;
  float mn = INFINITY, mx = -INFINITY;
  for (int c = t; c < chunks; c += kMergeThreads) {
    const long long at = (long long)c * dc + j;
    const double pa = partial[at], pb = partial[plane + at];
    const long long r0 = (long long)c * chunk_rows;
    const double nc = (double)(min((long long)n, r0 + chunk_rows) - r0);
    if (CHAN) {
      chan_merge(na, a, b, nc, pa, pb);
    } else {
      na += nc;
      a += pa;
      b += pb;
    }
    mn = nan_min(mn, (float)partial[2 * plane + at]);
    mx = nan_max(mx, (float)partial[3 * plane + at]);
  }
  sn[t] = na; sa[t] = a; sb[t] = b; smn[t] = mn; smx[t] = mx;
  __syncthreads();
  for (int s = kMergeThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
      if (CHAN) {
        chan_merge(na, a, b, sn[t + s], sa[t + s], sb[t + s]);
      } else {
        na += sn[t + s];
        a += sa[t + s];
        b += sb[t + s];
      }
      mn = nan_min(mn, smn[t + s]);
      mx = nan_max(mx, smx[t + s]);
      sn[t] = na; sa[t] = a; sb[t] = b; smn[t] = mn; smx[t] = mx;
    }
    __syncthreads();
  }
  if (t == 0) {
    out[j] = a;
    out[dc + j] = b;
    out[2 * dc + j] = (double)mn;
    out[3 * dc + j] = (double)mx;
  }
}

// rows a chunk: about kTargetBlocks blocks, at least 256 rows a chunk, a
// multiple of kLanes
int moment_chunk_rows(int n, int dc) {
  const long long tiles = (dc + kCols - 1) / kCols;
  long long chunks = (kTargetBlocks + tiles - 1) / tiles;
  const long long max_chunks = (n + 255) / 256;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  long long rows = (n + chunks - 1) / chunks;
  rows = (rows + kLanes - 1) / kLanes * kLanes;
  return (int)rows;
}

// ---------------------------------------------------------------------------
// K-Y
// ---------------------------------------------------------------------------
struct MaxOp {
  static __device__ __forceinline__ int apply(int a, int b) { return a > b ? a : b; }
};
struct MinOp {
  static __device__ __forceinline__ int apply(int a, int b) { return a < b ? a : b; }
};

// the exclusive scan of v over the block's threads, in thread order
// (REVERSE: from the last thread down), with identity ``id``; ``sh`` holds
// kSegThreads / 32 ints
template <typename Op, bool REVERSE>
__device__ int block_exclusive_scan(int v, int id, int* sh) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int kWarps = kSegThreads / 32;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int u = REVERSE ? __shfl_down_sync(full, incl, o) : __shfl_up_sync(full, incl, o);
    if (REVERSE ? lane + o < 32 : lane >= o) incl = Op::apply(incl, u);
  }
  if (lane == (REVERSE ? 0 : 31)) sh[w] = incl;  // the warp's total
  __syncthreads();
  int before = id;  // the totals of the warps before this one in scan order
  for (int q = 0; q < kWarps; ++q)
    if (REVERSE ? q > w : q < w) before = Op::apply(before, sh[q]);
  int excl = REVERSE ? __shfl_down_sync(full, incl, 1) : __shfl_up_sync(full, incl, 1);
  if (lane == (REVERSE ? 31 : 0)) excl = id;
  __syncthreads();  // sh is free again
  return Op::apply(excl, before);
}

template <typename Op>
__device__ int block_reduce(int v, int id, int* sh) {
  const int excl = block_exclusive_scan<Op, false>(v, id, sh);
  __shared__ int total;
  if (threadIdx.x == kSegThreads - 1) total = Op::apply(excl, v);
  __syncthreads();
  const int out = total;
  __syncthreads();
  return out;
}

// seg_first / seg_last [k, nseg]: the first and last run start of each
// segment (n and -1 where it holds none; position 0 always starts a run)
template <typename T>
__global__ void midrank_segments(const T* __restrict__ ss, int* __restrict__ seg_first,
                                 int* __restrict__ seg_last, int n, int nseg) {
  __shared__ int sh[kSegThreads / 32];
  const int s = blockIdx.x, c = blockIdx.y;
  const T* col = ss + (long long)c * n;
  const int p0 = s * kSeg + threadIdx.x * kPerThread;
  int first = n, last = -1;
  for (int e = 0; e < kPerThread; ++e) {
    const int p = p0 + e;
    if (p < n && (p == 0 || col[p] != col[p - 1])) {
      first = min(first, p);
      last = max(last, p);
    }
  }
  first = block_reduce<MinOp>(first, n, sh);
  last = block_reduce<MaxOp>(last, -1, sh);
  if (threadIdx.x == 0) {
    seg_first[(long long)c * nseg + s] = first;
    seg_last[(long long)c * nseg + s] = last;
  }
}

// out[order[c, p], c] = the midrank of position p of column c
template <typename T>
__global__ void midrank_scatter(const T* __restrict__ ss, const int64_t* __restrict__ order,
                                const int* __restrict__ seg_first,
                                const int* __restrict__ seg_last, float* __restrict__ out, int n,
                                int k, int nseg) {
  __shared__ int sh[kSegThreads / 32];
  const int s = blockIdx.x, c = blockIdx.y;
  const T* col = ss + (long long)c * n;
  // look back and ahead across segments: the last run start before this
  // segment, the first after it
  int back = -1, ahead = n;
  for (int t = threadIdx.x; t < nseg; t += kSegThreads) {
    if (t < s) back = max(back, seg_last[(long long)c * nseg + t]);
    if (t > s) ahead = min(ahead, seg_first[(long long)c * nseg + t]);
  }
  back = block_reduce<MaxOp>(back, -1, sh);
  ahead = block_reduce<MinOp>(ahead, n, sh);
  const int p0 = s * kSeg + threadIdx.x * kPerThread;
  bool start[kPerThread];
  for (int e = 0; e < kPerThread; ++e) {
    const int p = p0 + e;
    start[e] = p < n && (p == 0 || col[p] != col[p - 1]);
  }
  int lo[kPerThread], hi[kPerThread];
  int run = -1;  // the last run start at or before p in this thread's positions
  for (int e = 0; e < kPerThread; ++e) {
    if (start[e]) run = p0 + e;
    lo[e] = run;
  }
  const int lo_before = block_exclusive_scan<MaxOp, false>(run, -1, sh);
  int next = n;  // the first run start after p in this thread's positions
  for (int e = kPerThread - 1; e >= 0; --e) {
    hi[e] = next;
    if (start[e]) next = p0 + e;
  }
  const int hi_after = block_exclusive_scan<MinOp, true>(next, n, sh);
  for (int e = 0; e < kPerThread; ++e) {
    const int p = p0 + e;
    if (p >= n) break;
    const int l = max(lo[e], max(lo_before, back));
    const int h = min(hi[e], min(hi_after, ahead));
    const float mid = (float)(l + h + 1) * 0.5f;
    out[order[(long long)c * n + p] * k + c] = mid;
  }
}

template <typename T>
int launch_midranks(const void* ss, const void* order, void* seg_first, void* seg_last, void* out,
                    int n, int k, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nseg = (n + kSeg - 1) / kSeg;
  const dim3 grid(nseg, k);
  midrank_segments<T><<<grid, kSegThreads, 0, st>>>((const T*)ss, (int*)seg_first,
                                                     (int*)seg_last, n, nseg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  midrank_scatter<T><<<grid, kSegThreads, 0, st>>>((const T*)ss, (const int64_t*)order,
                                                    (const int*)seg_first,
                                                    (const int*)seg_last, (float*)out, n, k,
                                                    nseg);
  return (int)cudaGetLastError();
}

}  // namespace

// the row chunks of K-X for this shape, so the caller can size ``partial``
extern "C" int chunk_moments_chunks(int n, int dc) {
  if (n <= 0 || dc <= 0) return 0;
  const int rows = moment_chunk_rows(n, dc);
  return (n + rows - 1) / rows;
}

// K-X: out f64[4, dc] of the chunk [X | y] (y may be null: dc = d); chan 0
// raw (sum, sum of squares, min, max), 1 Chan (mean, M2, min, max);
// partial f64[4, chunks, dc]
extern "C" int chunk_moments_f64(const void* X, const void* y, void* partial, void* out, int n,
                                 int d, int dc, int chan, void* stream) {
  if (n <= 0 || dc <= 0 || dc < d || dc > d + 1 || (dc > d && y == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int rows = moment_chunk_rows(n, dc);
  const int chunks = (n + rows - 1) / rows;
  const dim3 grid((dc + kCols - 1) / kCols, chunks), block(kCols, kLanes);
  if (chan) {
    moments_partial<true><<<grid, block, 0, st>>>((const float*)X, (const float*)y,
                                                  (double*)partial, n, d, dc, rows, chunks);
  } else {
    moments_partial<false><<<grid, block, 0, st>>>((const float*)X, (const float*)y,
                                                   (double*)partial, n, d, dc, rows, chunks);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (chan) {
    moments_reduce<true><<<dc, kMergeThreads, 0, st>>>((const double*)partial, (double*)out, n,
                                                        dc, rows, chunks);
  } else {
    moments_reduce<false><<<dc, kMergeThreads, 0, st>>>((const double*)partial, (double*)out, n,
                                                         dc, rows, chunks);
  }
  return (int)cudaGetLastError();
}

// the segments a K-Y column takes, so the caller can size the scratch
extern "C" int midrank_segments_count(int n) { return n <= 0 ? 0 : (n + kSeg - 1) / kSeg; }

// K-Y over float32 / float64 values: ss [k, n] sorted rows, order i64[k, n],
// seg_first / seg_last i32[k, nseg] scratch, out f32[n, k]
extern "C" int midranks_f32(const void* ss, const void* order, void* seg_first, void* seg_last,
                            void* out, int n, int k, void* stream) {
  return launch_midranks<float>(ss, order, seg_first, seg_last, out, n, k, stream);
}

extern "C" int midranks_f64(const void* ss, const void* order, void* seg_first, void* seg_last,
                            void* out, int n, int k, void* stream) {
  return launch_midranks<double>(ss, order, seg_first, seg_last, out, n, k, stream);
}
