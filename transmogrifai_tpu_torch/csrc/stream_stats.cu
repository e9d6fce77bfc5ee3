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
// a block sorted by torch.sort (values ss [k, n], their rows order i64[k,
// n]), the average-tie midrank (lo + hi + 1) / 2 of every position, lo the
// first and hi one past the last position of its tie run, written through
// the permutation to out f32[n, ld] (column c at out[r * ld + c], ld >= k).
// That is the reference's two searchsorteds and its .at[order].set.
// Bound on the card: bytes (ss, the int64 order and the rank: 16 bytes a
// float32 position).  Design: a warp takes 32 consecutive positions a step,
// its lanes on consecutive positions (ss and order read coalesced, streamed
// past L2 with evict-first loads, order as the int64 the sort gives).  A
// step's run starts are one ballot; lo and hi of a position are bit scans
// of its ballot and carries across steps (and warps); the runs through a
// block's (or warp's) two ends come from a 32-way warp search of the sorted
// column (at most four probes a side at 2^20 rows), so one launch finds
// every run, however long.  The ranks go one of two routes
// (``midrank_plan``).  "direct": a block a segment of 2,048 positions of a
// column, a warp 256 of them, writing out[order * ld + c]: random 4-byte
// writes, which merge in L2 while the output is small and reach DRAM as
// partial sectors once it is not.  "partition", for the wide outputs up to
// 2^21 rows: a block takes 1,024 positions of each column of an 8-column
// group (a warp a column), sorts its 8-byte items (lo + hi + 1, the row in
// its bucket, the column, the bucket) by 2,048-row bucket in shared memory
// and appends each bucket's items as one run to the bucket's region (one
// global atomic a bucket); a second kernel places each (group, bucket)'s
// items in a [2,048][8] shared tile and writes the rows' 8 columns as whole
// 32-byte sectors.  Past 2^21 rows the direct route takes every shape.
// Float32 out, as the reference's: (float)(lo + hi + 1) * 0.5 rounds as its
// int-to-float32 cast does, exact below 2^23 rows.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns a block (threadIdx.x)
constexpr int kLanes = 8;   // row lanes a block (threadIdx.y)
constexpr int kTargetBlocks = 4 * 132;

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
constexpr int kRankWarps = 8;
constexpr int kRankThreads = kRankWarps * 32;
constexpr int kRankSteps = 8;                          // 32-position steps a warp
constexpr int kRankSeg = kRankWarps * 32 * kRankSteps; // positions a block
// the partition route: a block takes 1,024 positions of each column of an
// 8-column group, a warp a column; rows fall in buckets of 2,048
constexpr int kGroupCols = 8;
constexpr int kPartSteps = 32;
constexpr int kPartSpan = 32 * kPartSteps;
constexpr int kPartItems = kGroupCols * kPartSpan;
constexpr int kBucketShift = 11;
constexpr int kBucketRows = 1 << kBucketShift;
constexpr int kBucketCap = kBucketRows * kGroupCols;   // items a (group, bucket)
constexpr int kMaxBuckets = 1024;
constexpr int kPartSmem = kPartItems * (8 + 4) + 3 * kMaxBuckets * 4 + 16;
constexpr int kPlaceSmem = kBucketRows * kGroupCols * 4;
constexpr unsigned kFull = 0xffffffffu;

// the first q in [a, b) whose value fails the test (b if none), the test
// holding on a prefix of [a, b): ``col[q] == v`` (EQUAL) or ``col[q] < v``.
// The whole warp calls it with the same a, b, v; each round probes 32
// evenly spaced positions and keeps the span between the last passing and
// the first failing probe.
template <typename T, bool EQUAL>
__device__ int warp_partition(const T* __restrict__ col, int a, int b, T v) {
  const int lane = threadIdx.x & 31;
  while (b - a > 32) {
    const int step = (b - a + 31) >> 5;
    const int q = a + lane * step;
    bool pass = false;
    if (q < b) {
      const T x = col[q];
      pass = EQUAL ? x == v : x < v;
    }
    const int m = __popc(__ballot_sync(kFull, pass));
    if (m == 0) return a;
    const int hi = min(b, a + m * step);
    a += (m - 1) * step + 1;
    b = hi;
  }
  const int q = a + lane;
  bool pass = false;
  if (q < b) {
    const T x = col[q];
    pass = EQUAL ? x == v : x < v;
  }
  return a + __popc(__ballot_sync(kFull, pass));
}

// The run starts of a warp's 32 STEPS positions from base (p == 0 or
// ss[p] != ss[p - 1]), one ballot a step, from its values v.
template <typename T, int STEPS>
__device__ __forceinline__ void warp_starts(const T* __restrict__ col, int n, int base,
                                            const T (&v)[STEPS], unsigned (&starts)[STEPS]) {
  const int lane = threadIdx.x & 31;
  T before = (base > 0 && base <= n) ? col[base - 1] : T(0);
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int p = base + 32 * j + lane;
    const T up = __shfl_up_sync(kFull, v[j], 1);
    const T prev = lane == 0 ? before : up;
    before = __shfl_sync(kFull, v[j], 31);
    starts[j] = __ballot_sync(kFull, p < n && (p == 0 || prev != v[j]));
  }
}

// emit(p, lo + hi + 1, step) for each position p < n of the warp: lo the
// last run start at or before p (lo_run where the warp has none), hi the
// first after it (hi_run where none), bit scans of the steps' ballots.
template <int STEPS, typename Emit>
__device__ __forceinline__ void warp_emit(int n, int base, const unsigned (&starts)[STEPS],
                                          int lo_run, int hi_run, Emit emit) {
  const int lane = threadIdx.x & 31;
  int lo[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const unsigned upto = starts[j] & (kFull >> (31 - lane));  // starts at lanes <= this
    lo[j] = upto ? base + 32 * j + 31 - __clz(upto) : lo_run;
    if (starts[j]) lo_run = base + 32 * j + 31 - __clz(starts[j]);
  }
#pragma unroll
  for (int j = STEPS - 1; j >= 0; --j) {
    const int p = base + 32 * j + lane;
    const unsigned after = starts[j] & (0xfffffffeu << lane);  // starts at lanes > this
    const int hi = after ? base + 32 * j + __ffs(after) - 1 : hi_run;
    if (starts[j]) hi_run = base + 32 * j + __ffs(starts[j]) - 1;
    if (p < n) emit(p, lo[j] + hi + 1, j);
  }
}

// The midranks of the block's 2,048 positions of a sorted column from seg0
// (a warp 256 of them): for each position p < n, emit(p, lo + hi + 1,
// order[p]).  The warps' run carries meet in shared memory; warps 0 and 1
// search the runs through the segment's two ends.  The whole block calls it.
template <typename T, typename Emit>
__device__ void segment_midranks(const T* __restrict__ col, const int64_t* __restrict__ ord,
                                 int n, int seg0, Emit emit) {
  __shared__ int s_first[kRankWarps], s_last[kRankWarps];
  __shared__ int s_back, s_ahead;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int seg1 = min(n, seg0 + kRankSeg);
  const int base = seg0 + warp * 32 * kRankSteps;
  T v[kRankSteps];
  long long o[kRankSteps];
#pragma unroll
  for (int j = 0; j < kRankSteps; ++j) {
    const int p = base + 32 * j + lane;
    v[j] = T(0);
    o[j] = 0;
    if (p < n) {
      v[j] = __ldcs(col + p);
      o[j] = __ldcs(reinterpret_cast<const long long*>(ord) + p);
    }
  }
  // the run through the segment's first position starts at s_back; the
  // first run start past its last position is s_ahead
  if (warp == 0) {
    int back = seg0;
    if (seg0 > 0) {
      const T first = col[seg0];
      if (col[seg0 - 1] == first) back = warp_partition<T, false>(col, 0, seg0, first);
    }
    if (lane == 0) s_back = back;
  } else if (warp == 1) {
    int ahead = seg1;
    if (seg1 < n) {
      const T last = col[seg1 - 1];
      if (col[seg1] == last) ahead = warp_partition<T, true>(col, seg1 + 1, n, last);
    }
    if (lane == 0) s_ahead = ahead;
  }
  unsigned starts[kRankSteps];
  warp_starts<T, kRankSteps>(col, n, base, v, starts);
  int first = n, last = -1;
#pragma unroll
  for (int j = 0; j < kRankSteps; ++j) {
    if (starts[j]) {
      first = min(first, base + 32 * j + __ffs(starts[j]) - 1);
      last = max(last, base + 32 * j + 31 - __clz(starts[j]));
    }
  }
  if (lane == 0) {
    s_first[warp] = first;
    s_last[warp] = last;
  }
  __syncthreads();
  int lo_run = s_back, hi_run = s_ahead;
  for (int w = 0; w < kRankWarps; ++w) {
    if (w < warp) lo_run = max(lo_run, s_last[w]);
    if (w > warp) hi_run = min(hi_run, s_first[w]);
  }
  warp_emit<kRankSteps>(n, base, starts, lo_run, hi_run,
                        [&](int p, int lohi1, int j) { emit(p, lohi1, o[j]); });
}

// The midranks of one warp's 32 STEPS positions of a sorted column from
// base (< n), the warp alone: emit(p, lo + hi + 1) for each p < n.  The
// warp searches the runs through its own two ends.
template <typename T, int STEPS, typename Emit>
__device__ void warp_midranks(const T* __restrict__ col, int n, int base, Emit emit) {
  const int lane = threadIdx.x & 31;
  T v[STEPS];
#pragma unroll
  for (int j = 0; j < STEPS; ++j) {
    const int p = base + 32 * j + lane;
    v[j] = p < n ? __ldcs(col + p) : T(0);
  }
  const int end = min(n, base + 32 * STEPS);
  int back = base, ahead = end;
  if (base > 0) {
    const T first = col[base];
    if (col[base - 1] == first) back = warp_partition<T, false>(col, 0, base, first);
  }
  if (end < n) {
    const T last = col[end - 1];
    if (col[end] == last) ahead = warp_partition<T, true>(col, end + 1, n, last);
  }
  unsigned starts[STEPS];
  warp_starts<T, STEPS>(col, n, base, v, starts);
  warp_emit<STEPS>(n, base, starts, back, ahead,
                   [&](int p, int lohi1, int) { emit(p, lohi1); });
}

// the midrank of lo + hi + 1, as the reference's int-to-float32 cast
__device__ __forceinline__ float midrank_of(int lohi1) { return (float)lohi1 * 0.5f; }

// the direct route: segment blockIdx.x of column blockIdx.y, written to
// out[order * ld + c]
template <typename T>
__global__ void __launch_bounds__(kRankThreads)
midrank_ranks(const T* __restrict__ ss, const int64_t* __restrict__ order,
              float* __restrict__ out, int n, long long ld) {
  const int c = blockIdx.y;
  segment_midranks<T>(ss + (long long)c * n, order + (long long)c * n, n, blockIdx.x * kRankSeg,
                      [&](int, int lohi1, long long o) { out[o * ld + c] = midrank_of(lohi1); });
}

// a partition item: lo + hi + 1 (31 bits), the row within its bucket (11),
// the column within its group (3) and the bucket (10)
__device__ __forceinline__ unsigned long long pack_item(int lohi1, int row, int cl, int bucket) {
  return (unsigned long long)lohi1 | ((unsigned long long)(row & (kBucketRows - 1)) << 31) |
         ((unsigned long long)cl << 42) | ((unsigned long long)bucket << 45);
}

// The partition route's first pass: block (s, g) ranks positions [s * 1,024,
// ...) of the group's columns (a warp a column: no barrier among the
// columns' latencies), sorts its items by row bucket in shared memory
// (counts, an exclusive scan, a cursor a bucket) and appends each
// bucket's items as one run to the bucket's region of buf (its place from
// one atomic a bucket: the order within a region is free, the second pass
// places every item by its row).
template <typename T>
__global__ void __launch_bounds__(kRankThreads, 2)
midrank_partition(const T* __restrict__ ss, const int64_t* __restrict__ order,
                  unsigned long long* __restrict__ buf, int* __restrict__ cursors, int n, int k,
                  int buckets) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* items = reinterpret_cast<unsigned long long*>(smem);
  unsigned* rows = reinterpret_cast<unsigned*>(items + kPartItems);
  int* start = reinterpret_cast<int*>(rows + kPartItems);  // buckets + 1
  int* cursor = start + kMaxBuckets + 1;
  int* base = cursor + kMaxBuckets;
  const int g = blockIdx.y, c0 = g * kGroupCols, gc = min(kGroupCols, k - c0);
  const int seg0 = blockIdx.x * kPartSpan, span = min(kPartSpan, n - seg0);
  for (int b = threadIdx.x; b <= buckets; b += kRankThreads) start[b] = 0;
  __syncthreads();
  {  // the block's rows: every load issued before the first is used
    constexpr int kPer = kPartSpan / kRankThreads;
    const long long* ord = reinterpret_cast<const long long*>(order) + (long long)c0 * n + seg0;
    unsigned r[kGroupCols][kPer];
#pragma unroll
    for (int cl = 0; cl < kGroupCols; ++cl)
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = threadIdx.x + kRankThreads * e;
        r[cl][e] = (cl < gc && i < span) ? (unsigned)__ldcs(ord + (long long)cl * n + i) : 0u;
      }
#pragma unroll
    for (int cl = 0; cl < kGroupCols; ++cl)
#pragma unroll
      for (int e = 0; e < kPer; ++e) {
        const int i = threadIdx.x + kRankThreads * e;
        if (cl < gc && i < span) {
          rows[cl * kPartSpan + i] = r[cl][e];
          atomicAdd(&start[r[cl][e] >> kBucketShift], 1);
        }
      }
  }
  __syncthreads();
  // exclusive scan of the counts, 4 buckets a thread (kMaxBuckets = 1,024)
  {
    __shared__ int warp_sums[kRankWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, b0 = 4 * threadIdx.x;
    int cnt[4], sum = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      cnt[e] = b0 + e < buckets ? start[b0 + e] : 0;
      sum += cnt[e];
    }
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = incl - sum;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (b0 + e < buckets) {
        start[b0 + e] = before;
        cursor[b0 + e] = before;
      }
      before += cnt[e];
    }
    if (threadIdx.x == kRankThreads - 1) start[buckets] = before;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < buckets; b += kRankThreads) {
    const int cnt = start[b + 1] - start[b];
    base[b] = cnt ? atomicAdd(&cursors[g * buckets + b], cnt) : 0;
  }
  const int cl = threadIdx.x >> 5;  // a warp a column of the group
  if (cl < gc) {
    warp_midranks<T, kPartSteps>(ss + (long long)(c0 + cl) * n, n, seg0, [&](int p, int lohi1) {
      const int row = (int)rows[cl * kPartSpan + p - seg0];
      const int b = row >> kBucketShift;
      items[atomicAdd(&cursor[b], 1)] = pack_item(lohi1, row, cl, b);
    });
  }
  __syncthreads();
  const int total = start[buckets];
  for (int i = threadIdx.x; i < total; i += kRankThreads) {
    const unsigned long long it = items[i];
    const int b = (int)(it >> 45);
    buf[(long long)(g * buckets + b) * kBucketCap + base[b] + (i - start[b])] = it;
  }
}

// The partition route's second pass: block (b, g) places its bucket's items
// in a [2,048][8] shared tile and writes the rows' 8 columns (one 32-byte
// sector each where ld is a multiple of 8).
__global__ void __launch_bounds__(kRankThreads)
midrank_place(const unsigned long long* __restrict__ buf, float* __restrict__ out, int n, int k,
              long long ld, int buckets) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tile = reinterpret_cast<float*>(smem);
  const int b = blockIdx.x, g = blockIdx.y, c0 = g * kGroupCols, gc = min(kGroupCols, k - c0);
  const int r0 = b * kBucketRows, rows = min(kBucketRows, n - r0);
  const unsigned long long* src = buf + (long long)(g * buckets + b) * kBucketCap;
  for (int i = threadIdx.x; i < rows * gc; i += kRankThreads) {
    const unsigned long long it = __ldcs(src + i);
    const int row = (int)((it >> 31) & (kBucketRows - 1)), cl = (int)((it >> 42) & 7);
    tile[row * kGroupCols + cl] = midrank_of((int)(it & 0x7fffffffULL));
  }
  __syncthreads();
  for (int f = threadIdx.x; f < rows * kGroupCols; f += kRankThreads) {
    const int r = f / kGroupCols, cl = f % kGroupCols;
    if (cl < gc) out[(long long)(r0 + r) * ld + c0 + cl] = tile[f];
  }
}

// route 0 direct, 1 partition
template <typename T>
int launch_midranks(const void* ss, const void* order, void* scratch, void* cursors, void* out,
                    int n, int k, long long ld, int route, void* stream) {
  if (n <= 0 || k <= 0 || ld < k || k > 65535 || route < 0 || route > 1 ||
      (route == 1 && (scratch == nullptr || cursors == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (route == 0) {
    const dim3 grid((n + kRankSeg - 1) / kRankSeg, k);
    midrank_ranks<T><<<grid, kRankThreads, 0, st>>>((const T*)ss, (const int64_t*)order,
                                                    (float*)out, n, ld);
    return (int)cudaGetLastError();
  }
  const int buckets = (n + kBucketRows - 1) / kBucketRows, groups = (k + kGroupCols - 1) / kGroupCols;
  if (buckets > kMaxBuckets || groups > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(midrank_partition<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kPartSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(midrank_place, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPlaceSmem);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(cursors, 0, (size_t)groups * buckets * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  midrank_partition<T><<<dim3((n + kPartSpan - 1) / kPartSpan, groups), kRankThreads, kPartSmem,
                         st>>>((const T*)ss, (const int64_t*)order,
                               (unsigned long long*)scratch, (int*)cursors, n, k, buckets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  midrank_place<<<dim3(buckets, groups), kRankThreads, kPlaceSmem, st>>>(
      (const unsigned long long*)scratch, (float*)out, n, k, ld, buckets);
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

// K-Y over float32 / float64 values: ss [k, n] sorted rows, order i64[k, n],
// out f32[n, ld]; route 0 direct, 1 partition (scratch u64[groups, buckets,
// 16,384], cursors i32[groups, buckets])
extern "C" int midranks_f32(const void* ss, const void* order, void* scratch, void* cursors,
                            void* out, int n, int k, long long ld, int route, void* stream) {
  return launch_midranks<float>(ss, order, scratch, cursors, out, n, k, ld, route, stream);
}

extern "C" int midranks_f64(const void* ss, const void* order, void* scratch, void* cursors,
                            void* out, int n, int k, long long ld, int route, void* stream) {
  return launch_midranks<double>(ss, order, scratch, cursors, out, n, k, ld, route, stream);
}
