// K-O regression_metrics: the sweep's validation metrics of a regression
// problem, one (fold, candidate) row per block.
//
// Replaces: transmogrifai_tpu/ops/metrics.py::_regression_one (:136) as
// _regression_grid_metrics (:148) vmaps it: for each row r = (f, c) of the
// [F, C, n] predictions, over fold f's validation weights vm[f], it writes
// [RMSE, MSE, R2, MAE] in ops/metrics.REGRESSION_METRICS order:
//   nv = max(sum vm, 1), err = (p - y) vm, mse = sum err^2 / nv,
//   mae = sum |err| / nv, ybar = sum y vm / nv,
//   ss_tot = sum (y - ybar)^2 vm, r2 = 1 - sum err^2 / max(ss_tot, 1e-30)
//   where ss_tot > 0 (else 0), rmse = sqrt(mse).
// Every elementwise term is the reference's float32 operation, rounded to
// nearest (no FMA contraction); the five sums are accumulated in float64
// and each rounded to float32 once, then the reference's float32 formulas
// finish the row.  XLA sums in float32, so its metrics differ from these by
// its own rounding (about sqrt(n) ulps).
//
// A block makes two passes over its row: the sums of vm, y vm, err^2 and
// |err|, then, with ybar, the sum of (y - ybar)^2 vm.  Each thread sums a
// strided slice in row order; the block reduces by warp shuffles and then
// the warps in order, so runs repeat bit for bit.
//
// Bound on the card: bytes.  Each prediction is read once; y and the fold's
// mask are read by every row of the fold (twice each), from L2 after the
// first; four floats a row are written.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// The block's sum of v, in a fixed order; every thread gets it.
__device__ double block_sum(double v, double* sh) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  __syncthreads();
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int k = 0; k < kWarps; ++k) s += sh[k];
  return s;
}

__global__ void __launch_bounds__(kThreads)
regression_metrics_kernel(const float* __restrict__ preds, const float* __restrict__ y,
                          const float* __restrict__ vm, float* __restrict__ out, int n, int C) {
  __shared__ double sh[kWarps];
  const long long r = blockIdx.x;
  const float* p = preds + r * n;
  const float* v = vm + (r / C) * (long long)n;
  double s_vm = 0.0, s_yv = 0.0, s_e2 = 0.0, s_ae = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float vi = v[i], yi = y[i];
    const float err = __fmul_rn(__fsub_rn(p[i], yi), vi);
    s_vm += (double)vi;
    s_yv += (double)__fmul_rn(yi, vi);
    s_e2 += (double)__fmul_rn(err, err);
    s_ae += (double)fabsf(err);
  }
  const float nv = fmaxf(__double2float_rn(block_sum(s_vm, sh)), 1.0f);
  const float sy = __double2float_rn(block_sum(s_yv, sh));
  const float se = __double2float_rn(block_sum(s_e2, sh));
  const float sa = __double2float_rn(block_sum(s_ae, sh));
  const float ybar = __fdiv_rn(sy, nv);
  double s_ss = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float dy = __fsub_rn(y[i], ybar);
    s_ss += (double)__fmul_rn(__fmul_rn(dy, dy), v[i]);
  }
  const float ss = __double2float_rn(block_sum(s_ss, sh));
  if (threadIdx.x == 0) {
    const float mse = __fdiv_rn(se, nv);
    out[r * 4 + 0] = __fsqrt_rn(mse);
    out[r * 4 + 1] = mse;
    out[r * 4 + 2] = ss > 0.0f ? __fsub_rn(1.0f, __fdiv_rn(se, fmaxf(ss, 1e-30f))) : 0.0f;
    out[r * 4 + 3] = __fdiv_rn(sa, nv);
  }
}

}  // namespace

// preds f32[R, n] (row r = fold r / C, candidate r % C), y f32[n], vm
// f32[R / C, n], out f32[R, 4].
extern "C" int regression_metrics(const void* preds, const void* y, const void* vm, void* out,
                                  int R, int n, int C, void* stream) {
  if (R <= 0 || n < 0 || C <= 0 || R % C) return (int)cudaErrorInvalidValue;
  regression_metrics_kernel<<<R, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)preds, (const float*)y, (const float*)vm, (float*)out, n, C);
  return (int)cudaGetLastError();
}
