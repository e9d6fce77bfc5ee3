// K-L binary_metrics: the sweep's validation metrics, one (fold, candidate)
// row per block, after a stable sort of the row's masked scores.
//
// Replaces: transmogrifai_tpu/ops/metrics.py::_binary_one (:57) as
// _binary_grid_metrics (:121) vmaps it: for each row r = (f, c) of the
// [F, C, n] scores, with the rows outside fold f's validation mask set to
// -inf and sorted ascending (the wrapper's torch.sort; this kernel gets the
// sorted scores and the sort's permutation), it writes [AuROC, AuPR, Error,
// Precision, Recall, F1] in ops/metrics.BINARY_METRICS order.
//
// The tie-aware pass after the sort: tie groups are runs of equal sorted
// scores (the reference's two searchsorted calls give each row its group's
// [lo, hi)).  A group is closed where the next one starts: its positives
// add (lo + hi + 1 - 2 n_excluded) to twice the midrank sum of AuROC, and,
// if its score is finite, its AuPR step prec(lo) * (rec(lo) - rec(hi)) is
// added (one step per distinct threshold, rec(n) = 0), where prec and rec
// at a position are the float32 ratios of the counts of positives and
// negatives at or above it.  The labels and the validation weights are 0/1
// (the wrapper checks), so every count is an integer and is kept exact in
// int64; the midrank sum is summed exactly (twice it is an integer) and
// rounded to float32 once; the AuPR steps are added in 64-bit fixed point
// (2^62 scale: each step is below 1 and the steps sum to at most 1), so
// the total is the same in any order and rounded once.  The reference sums
// both in float32 in XLA's order.  The thresholded class decision (score >
// 0.5 when the candidate's strict flag is set, >= 0.5 otherwise) is
// counted in the same pass.  NaN scores (sorted last, as XLA's sort puts
// them) form one tie group, as the reference's searchsorted orders them; it
// adds no AuPR step, and the top non-NaN group's step starts from recall 0
// (the reference's previous distinct threshold skips the NaN group, so its
// positives count in that step).  The scan of each 1024-row tile is a block
// scan (warp shuffles, then the warps); no atomics, so runs repeat bit for
// bit.
//
// Bound on the card: bytes.  Each row's sorted scores, permutation and the
// gathered labels and weights are read once (twice: a count pass, then the
// scan), six floats written.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr double kFixedScale = 4611686018427387904.0;  // 2^62

struct Counts {
  long long pos, neg, tp, fp, fn;
};

__device__ long long block_sum(long long v, long long* sh) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  long long s = 0;
  for (int k = 0; k < kWarps; ++k) s += sh[k];
  return s;
}

// Exclusive block scan of an int; returns the block total in *total.
__device__ int block_excl_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  __syncthreads();
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = sh[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += y;
    }
    sh[lane] = s;  // inclusive over warps
  }
  __syncthreads();
  *total = sh[kWarps - 1];
  return x - v + (warp > 0 ? sh[warp - 1] : 0);
}

// Inclusive block max-scan of an int.
__device__ int block_max_scan(int v, int* sh) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x = max(x, y);
  }
  __syncthreads();
  if (lane == 31) sh[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = sh[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s = max(s, y);
    }
    sh[lane] = s;
  }
  __syncthreads();
  return warp > 0 ? max(x, sh[warp - 1]) : x;
}

__device__ __forceinline__ float ratio(long long a, long long b) {
  // float32(a) / max(float32(a) + float32(b), 1), as the reference rounds it
  const float fa = (float)a;
  return __fdiv_rn(fa, fmaxf(__fadd_rn(fa, (float)b), 1.0f));
}

// The contribution of the closed tie group [lo, hi): (twice its positives'
// midrank sum, its AuPR step in fixed point).
__device__ __forceinline__ void close_group(int lo, int hi, float score, long long P_lo,
                                            long long N_lo, long long P_hi, long long P_tot,
                                            long long N_tot, float rec_den, long long n_exc,
                                            int nan_lo, long long* r2, long long* pr) {
  *r2 += (P_hi - P_lo) * ((long long)lo + hi + 1 - 2 * n_exc);
  if (score > -INFINITY) {  // false for NaN
    const long long A = P_tot - P_lo, B = N_tot - N_lo, Ah = hi == nan_lo ? 0 : P_tot - P_hi;
    const float prec = ratio(A, B);
    const float rec_lo = __fdiv_rn((float)A, rec_den);
    const float rec_hi = __fdiv_rn((float)Ah, rec_den);
    const float step = __fmul_rn(prec, __fsub_rn(rec_lo, rec_hi));
    *pr += __double2ll_rn((double)step * kFixedScale);
  }
}

__global__ void __launch_bounds__(kThreads)
binary_metrics_kernel(const float* __restrict__ ss, const int64_t* __restrict__ order,
                      const float* __restrict__ y, const float* __restrict__ vm,
                      const int32_t* __restrict__ strict, float* __restrict__ out, int n, int C) {
  __shared__ long long shl[kWarps];
  __shared__ int shi[kWarps];
  __shared__ int s_lo[kThreads];
  __shared__ long long s_P[kThreads], s_N[kThreads];
  const int row = blockIdx.x;
  const int f = row / C, c = row % C;
  const float* srow = ss + (long long)row * n;
  const int64_t* orow = order + (long long)row * n;
  const float* vrow = vm + (long long)f * n;
  const bool strict_c = strict[c] != 0;
  const int tid = threadIdx.x;

  // pass 1: class totals and the thresholded counts
  long long pos = 0, neg = 0, tp = 0, fp = 0, fn = 0, nans = 0;
  for (int a = tid; a < n; a += kThreads) {
    nans += isnan(srow[a]);
    const long long i = orow[a];
    if (vrow[i] == 0.0f) continue;
    const bool yp = y[i] != 0.0f;
    const float s = srow[a];
    const bool p1 = strict_c ? (s > 0.5f) : (s >= 0.5f);
    pos += yp;
    neg += !yp;
    tp += yp && p1;
    fp += !yp && p1;
    fn += yp && !p1;
  }
  const long long P_tot = block_sum(pos, shl);
  const long long N_tot = block_sum(neg, shl);
  const long long TPc = block_sum(tp, shl);
  const long long FPc = block_sum(fp, shl);
  const long long FNc = block_sum(fn, shl);
  const int nan_lo = n - (int)block_sum(nans, shl);  // the NaN group's start
  const long long n_exc = (long long)n - P_tot - N_tot;
  const float npos = (float)P_tot, nneg = (float)N_tot;
  const float rec_den = fmaxf(npos, 1.0f);

  // pass 2: the tie groups, closed where the next one starts
  long long r2 = 0, pr = 0;
  int carry_lo = -1;              // the open group's start (from earlier tiles)
  long long carry_P = 0, carry_N = 0;
  long long run_P = 0, run_N = 0;  // counts before this tile
  for (int t0 = 0; t0 < n; t0 += kThreads) {
    const int a = t0 + tid;
    const bool in = a < n;
    float s = 0.0f, s_prev = 0.0f;
    int yp = 0, yn = 0;
    if (in) {
      s = srow[a];
      const long long i = orow[a];
      if (vrow[i] != 0.0f) {
        yp = y[i] != 0.0f;
        yn = !yp;
      }
      if (a > 0) s_prev = srow[a - 1];
    }
    const bool start = in && (a == 0 || (s != s_prev && !(isnan(s) && isnan(s_prev))));
    int tot_p, tot_n;
    const int ep = block_excl_scan(yp, shi, &tot_p);
    const int en = block_excl_scan(yn, shi, &tot_n);
    const long long P_a = run_P + ep, N_a = run_N + en;
    s_P[tid] = P_a;
    s_N[tid] = N_a;
    const int last_start = block_max_scan(start ? a : -1, shi);
    s_lo[tid] = last_start;
    __syncthreads();
    if (start && a > 0) {
      // the group before a: its start is the last start before a
      const int prev = tid > 0 ? s_lo[tid - 1] : -1;
      int lo;
      long long P_lo, N_lo;
      if (prev >= 0) {
        lo = prev;
        P_lo = s_P[prev - t0];
        N_lo = s_N[prev - t0];
      } else {
        lo = carry_lo;
        P_lo = carry_P;
        N_lo = carry_N;
      }
      close_group(lo, a, s_prev, P_lo, N_lo, P_a, P_tot, N_tot, rec_den, n_exc, nan_lo, &r2,
                  &pr);
    }
    // carry the open group to the next tile
    const int tile_last = min(kThreads, n - t0) - 1;
    const int open = s_lo[tile_last];
    if (open >= 0) {
      carry_lo = open;
      carry_P = s_P[open - t0];
      carry_N = s_N[open - t0];
    }
    run_P += tot_p;
    run_N += tot_n;
    __syncthreads();
  }
  if (tid == 0 && n > 0)
    close_group(carry_lo, n, srow[n - 1], carry_P, carry_N, P_tot, P_tot, N_tot, rec_den,
                n_exc, nan_lo, &r2, &pr);
  const long long R2 = block_sum(r2, shl);
  const long long PR = block_sum(pr, shl);
  if (tid != 0) return;

  // the reference's float32 formulas
  const float r_pos = (float)((double)R2 * 0.5);
  float auroc = 0.0f;
  if (P_tot > 0 && N_tot > 0)
    auroc = __fdiv_rn(__fsub_rn(r_pos, __fmul_rn(__fmul_rn(npos, __fadd_rn(npos, 1.0f)), 0.5f)),
                      fmaxf(__fmul_rn(npos, nneg), 1.0f));
  const float aupr = P_tot > 0 ? (float)((double)PR * (1.0 / kFixedScale)) : 0.0f;
  const float tpf = (float)TPc, fpf = (float)FPc, fnf = (float)FNc;
  const float nv = fmaxf(__fadd_rn(npos, nneg), 1.0f);
  const float err = __fdiv_rn(__fadd_rn(fpf, fnf), nv);
  const float pd = __fadd_rn(tpf, fpf), rd = __fadd_rn(tpf, fnf);
  const float precision = pd > 0.0f ? __fdiv_rn(tpf, fmaxf(pd, 1.0f)) : 0.0f;
  const float recall = rd > 0.0f ? __fdiv_rn(tpf, fmaxf(rd, 1.0f)) : 0.0f;
  const float pr_sum = __fadd_rn(precision, recall);
  const float f1 = pr_sum > 0.0f
                       ? __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, precision), recall),
                                   fmaxf(pr_sum, 1e-30f))
                       : 0.0f;
  float* o = out + (long long)row * 6;
  o[0] = auroc;
  o[1] = aupr;
  o[2] = err;
  o[3] = precision;
  o[4] = recall;
  o[5] = f1;
}

}  // namespace

extern "C" int binary_metrics(const void* ss, const void* order, const void* y, const void* vm,
                              const void* strict, void* out, int rows, int n, int C,
                              void* stream) {
  if (rows <= 0 || C <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  binary_metrics_kernel<<<rows, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)ss, (const int64_t*)order, (const float*)y, (const float*)vm,
      (const int32_t*)strict, (float*)out, n, C);
  return (int)cudaGetLastError();
}
