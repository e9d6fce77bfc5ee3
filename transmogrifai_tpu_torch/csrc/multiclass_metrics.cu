// K-Q multiclass_metrics: the sweep's validation metrics of a multiclass
// problem, per (fold, candidate) row of class probabilities.
//
// Replaces: transmogrifai_tpu/ops/metrics.py::_multiclass_one (:162) as
// _multiclass_grid_metrics (:187) vmaps it: for each row r = (f, c) of the
// [F, C, n, k] probabilities, over fold f's 0/1 validation mask vm[f], it
// writes [F1, Precision, Recall, Error] in ops/metrics.MULTICLASS_METRICS
// order (Spark MulticlassMetrics' class-frequency-weighted averages):
//   pred = first argmax over the k classes (ties to the lower class, as
//   jnp.argmax), and per class tp, fp, fn and the class count n_c;
//   nv = max(sum vm, 1), wgt = n_c / nv,
//   p = tp / max(tp + fp, 1) where tp + fp > 0 (else 0), r likewise,
//   f = 2 p r / max(p + r, 1e-30) where p + r > 0 (else 0),
//   F1 = sum_c f wgt, Precision = sum_c p wgt, Recall = sum_c r wgt
//   (up to 10 classes summed in class order, each step a fused multiply-add:
//   XLA's CPU code contracts the reference's sums so), Error = 1 - sum_c tp
//   / nv.
// The mask and labels are 0/1 and integers, so the counts are exact
// integers (the reference's float32 sums of 0/1 terms are exact too below
// 2^24 rows): they are counted in integers, each converted to float32 once,
// and the reference's float32 formulas, rounded as written, finish the
// row.  Error ties decide the selector's winner,
// so the result is bit-equal to the reference's, not merely close.
//
// Entry point 1 (multiclass_counts): grid (row chunks, R rows); each thread
// takes rows of its chunk, finds each row's argmax and adds its class
// counts in registers; warps reduce them (__reduce_add_sync) and the block
// adds them into the row's int64 counters with atomics (integer sums: any
// order gives the same total).  Above 8 classes (multiclass_counts_shared,
// up to kMaxK) a thread cannot hold 4k counters in registers, so each row
// adds its three or four counts straight into the block's 4k + 1 counters
// in shared memory with integer atomics (order-free, exact), and the block
// adds them into the row's int64 counters as above.  Entry point 2
// (multiclass_finish): one thread per row for the float32 formulas.  The
// reference's CPU code vectorizes the class sums from 11 classes on, in an
// order that depends on the host and the grid's shape (PERF.md), so there
// the finish sums in float64 in class order (exact products) and rounds
// once: F1, Precision and Recall agree with the reference's within a few
// ulps, and Error exactly.
//
// Bound on the card: bytes.  The probabilities are read once (R x n x k
// floats: 221 MB for the Iris sweep at 2^18 rows); the labels and the
// fold's mask are read by every row of the fold, from L2 after the first.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 128;  // ops/metrics.py::MULTICLASS_MAX_CLASSES
constexpr int kMaxRegK = 8;  // above, the shared-memory counters
constexpr int kFmaK = 10;    // ops/metrics.py::MULTICLASS_FMA_CLASSES
constexpr int kTargetBlocks = 8 * 132;
// counters of a row: tp[k], fp[k], fn[k], n_c[k], nv
__host__ __device__ constexpr int n_counts(int k) { return 4 * k + 1; }

template <int KM>
__global__ void __launch_bounds__(kThreads)
multiclass_counts(const float* __restrict__ probs, const float* __restrict__ y,
                  const float* __restrict__ vm, unsigned long long* __restrict__ counts, int n,
                  int k, int C, int chunk_rows) {
  __shared__ unsigned int sh[n_counts(kMaxRegK)];
  const int r = blockIdx.y;
  const int nc = n_counts(k);
  for (int i = threadIdx.x; i < nc; i += kThreads) sh[i] = 0u;
  __syncthreads();
  const float* pr = probs + (long long)r * n * k;
  const float* v = vm + (long long)(r / C) * n;
  unsigned int tp[KM], fp[KM], fn[KM], cn[KM], nv = 0u;
#pragma unroll
  for (int j = 0; j < KM; ++j) tp[j] = fp[j] = fn[j] = cn[j] = 0u;
  const long long i0 = (long long)blockIdx.x * chunk_rows;
  const long long i1 = min((long long)n, i0 + chunk_rows);
  for (long long i = i0 + threadIdx.x; i < i1; i += kThreads) {
    if (v[i] == 0.0f) continue;
    const float* pi = pr + i * k;
    float best = pi[0];
    int arg = 0;
#pragma unroll
    for (int j = 1; j < KM; ++j) {
      if (j < k) {
        const float q = pi[j];
        // first max; NaN counts as largest (jnp.argmax)
        if (!isnan(best) && (isnan(q) || q > best)) {
          best = q;
          arg = j;
        }
      }
    }
    const int lab = (int)y[i];
    nv += 1u;
#pragma unroll
    for (int j = 0; j < KM; ++j) {
      const bool is_lab = j == lab, is_pred = j == arg;
      tp[j] += is_lab && is_pred;
      fp[j] += !is_lab && is_pred;
      fn[j] += is_lab && !is_pred;
      cn[j] += is_lab;
    }
  }
  const unsigned int full = 0xffffffffu;
  const bool lane0 = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
      const unsigned int a = __reduce_add_sync(full, tp[j]);
      const unsigned int b = __reduce_add_sync(full, fp[j]);
      const unsigned int c = __reduce_add_sync(full, fn[j]);
      const unsigned int d = __reduce_add_sync(full, cn[j]);
      if (lane0) {
        atomicAdd(sh + j, a);
        atomicAdd(sh + k + j, b);
        atomicAdd(sh + 2 * k + j, c);
        atomicAdd(sh + 3 * k + j, d);
      }
    }
  }
  const unsigned int tot = __reduce_add_sync(full, nv);
  if (lane0) atomicAdd(sh + 4 * k, tot);
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += kThreads)
    if (sh[i]) atomicAdd(counts + (long long)r * nc + i, (unsigned long long)sh[i]);
}

// Any k up to kMaxK: the counters in shared memory, one atomic a count.
__global__ void __launch_bounds__(kThreads)
multiclass_counts_shared(const float* __restrict__ probs, const float* __restrict__ y,
                         const float* __restrict__ vm, unsigned long long* __restrict__ counts,
                         int n, int k, int C, int chunk_rows) {
  __shared__ unsigned int sh[n_counts(kMaxK)];
  const int r = blockIdx.y;
  const int nc = n_counts(k);
  for (int i = threadIdx.x; i < nc; i += kThreads) sh[i] = 0u;
  __syncthreads();
  const float* pr = probs + (long long)r * n * k;
  const float* v = vm + (long long)(r / C) * n;
  unsigned int nv = 0u;
  const long long i0 = (long long)blockIdx.x * chunk_rows;
  const long long i1 = min((long long)n, i0 + chunk_rows);
  for (long long i = i0 + threadIdx.x; i < i1; i += kThreads) {
    if (v[i] == 0.0f) continue;
    const float* pi = pr + i * k;
    float best = pi[0];
    int arg = 0;
    for (int j = 1; j < k; ++j) {
      const float q = pi[j];
      // first max; NaN counts as largest (jnp.argmax)
      if (!isnan(best) && (isnan(q) || q > best)) {
        best = q;
        arg = j;
      }
    }
    const int lab = (int)y[i];
    nv += 1u;
    if (arg == lab) {
      atomicAdd(sh + lab, 1u);
    } else {
      atomicAdd(sh + k + arg, 1u);
      atomicAdd(sh + 2 * k + lab, 1u);
    }
    atomicAdd(sh + 3 * k + lab, 1u);
  }
  const unsigned int tot = __reduce_add_sync(0xffffffffu, nv);
  if ((threadIdx.x & 31) == 0) atomicAdd(sh + 4 * k, tot);
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += kThreads)
    if (sh[i]) atomicAdd(counts + (long long)r * nc + i, (unsigned long long)sh[i]);
}

__global__ void multiclass_finish(const unsigned long long* __restrict__ counts,
                                  float* __restrict__ out, int R, int k) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const unsigned long long* cr = counts + (long long)r * n_counts(k);
  const float nv = fmaxf((float)cr[4 * k], 1.0f);
  float f1 = 0.0f, prec = 0.0f, rec = 0.0f;  // the class sums, fused as XLA's
  double f1d = 0.0, precd = 0.0, recd = 0.0;  // past kFmaK: float64, rounded once
  const bool fused = k <= kFmaK;
  unsigned long long tp_all = 0ull;
  for (int j = 0; j < k; ++j) {
    const float tp = (float)cr[j], fp = (float)cr[k + j], fn = (float)cr[2 * k + j];
    const float wgt = __fdiv_rn((float)cr[3 * k + j], nv);
    tp_all += cr[j];
    const float pd = __fadd_rn(tp, fp), rd = __fadd_rn(tp, fn);
    const float p = pd > 0.0f ? __fdiv_rn(tp, fmaxf(pd, 1.0f)) : 0.0f;
    const float q = rd > 0.0f ? __fdiv_rn(tp, fmaxf(rd, 1.0f)) : 0.0f;
    const float s = __fadd_rn(p, q);
    const float f = s > 0.0f ? __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, p), q), fmaxf(s, 1e-30f))
                             : 0.0f;
    if (fused) {
      f1 = __fmaf_rn(f, wgt, f1);
      prec = __fmaf_rn(p, wgt, prec);
      rec = __fmaf_rn(q, wgt, rec);
    } else {
      const double wd = (double)wgt;
      f1d = __dadd_rn(f1d, __dmul_rn((double)f, wd));
      precd = __dadd_rn(precd, __dmul_rn((double)p, wd));
      recd = __dadd_rn(recd, __dmul_rn((double)q, wd));
    }
  }
  out[4 * r] = fused ? f1 : __double2float_rn(f1d);
  out[4 * r + 1] = fused ? prec : __double2float_rn(precd);
  out[4 * r + 2] = fused ? rec : __double2float_rn(recd);
  out[4 * r + 3] = __fsub_rn(1.0f, __fdiv_rn((float)tp_all, nv));
}

}  // namespace

extern "C" int multiclass_metrics(const void* probs, const void* y, const void* vm,
                                  void* counts, void* out, int R, int n, int k, int C,
                                  void* stream) {
  // R rows on the grid's y axis
  if (R <= 0 || R > 65535 || n <= 0 || k < 2 || k > kMaxK || C <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      counts, 0, (size_t)R * n_counts(k) * sizeof(unsigned long long), st);
  if (err != cudaSuccess) return (int)err;
  long long chunks = (kTargetBlocks + R - 1) / R;
  const long long max_chunks = (n + 2047) / 2048;  // at least 2048 rows a block
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks < 1) chunks = 1;
  const int chunk_rows = (int)((n + chunks - 1) / chunks);
  dim3 grid((unsigned)chunks, (unsigned)R);
  if (k <= 4)
    multiclass_counts<4><<<grid, kThreads, 0, st>>>(
        (const float*)probs, (const float*)y, (const float*)vm, (unsigned long long*)counts, n,
        k, C, chunk_rows);
  else if (k <= kMaxRegK)
    multiclass_counts<kMaxRegK><<<grid, kThreads, 0, st>>>(
        (const float*)probs, (const float*)y, (const float*)vm, (unsigned long long*)counts, n,
        k, C, chunk_rows);
  else
    multiclass_counts_shared<<<grid, kThreads, 0, st>>>(
        (const float*)probs, (const float*)y, (const float*)vm, (unsigned long long*)counts, n,
        k, C, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  multiclass_finish<<<(R + 127) / 128, 128, 0, st>>>((const unsigned long long*)counts,
                                                    (float*)out, R, k);
  return (int)cudaGetLastError();
}
