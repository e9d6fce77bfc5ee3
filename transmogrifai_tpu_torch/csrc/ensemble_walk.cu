// K-B ensemble_walk: score binned rows through a tree ensemble.
//
// Replaces: transmogrifai_tpu/ops/trees.py::predict_tree under predict_gbt
// (base + eta * sum over trees) and predict_forest (mean over trees): a
// max_depth-step pointer walk per (row, tree) over the flat node pool, where
// a row goes right iff its bin > split_bin and a leaf (split_feat == -1)
// keeps the row where it is.
//
// Bound on the card: the bytes of the call are small (n*d bins in, n*c
// floats out; the 4 MB pool of the Titanic model stays in L2), so the walk
// is bound by the latency of its dependent loads: each step reads the node,
// then the row's bin, then the child, one after the other.  Design: one
// thread per row loops over the T trees, so each thread keeps many trees'
// walks in flight only through the warp scheduler (32 rows a warp, many
// warps an SM).  A row's walk stops at its leaf: a leaf maps to itself in
// the reference's walk, so stopping early gives the same leaf.  The sum over
// trees runs in registers in tree order, with no atomics, so the result is
// the same on every run.  Channels are summed four at a time; the wrapper
// launches once per group of four when c > 4.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 4;

template <typename BinT>
__global__ void ensemble_walk_kernel(const BinT* __restrict__ Xb,
                                     const int32_t* __restrict__ split_feat,
                                     const int32_t* __restrict__ split_bin,
                                     const int32_t* __restrict__ left,
                                     const int32_t* __restrict__ right,
                                     const float* __restrict__ leaf_val,
                                     float* __restrict__ out,
                                     int32_t* __restrict__ leaves, long long n, int d,
                                     int n_trees, int pool, int c, int ch0, int nch,
                                     int max_depth, int mode, float eta, float base) {
  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const BinT* xr = Xb + row * d;
  float acc[kChannels];
#pragma unroll
  for (int k = 0; k < kChannels; ++k) acc[k] = 0.0f;
  for (int t = 0; t < n_trees; ++t) {
    const long long off = (long long)t * pool;
    int node = 0;
    for (int s = 0; s < max_depth; ++s) {
      const int nf = __ldg(split_feat + off + node);
      if (nf < 0) break;
      const int b = (int)xr[nf];
      node = b > __ldg(split_bin + off + node) ? __ldg(right + off + node)
                                               : __ldg(left + off + node);
    }
    if (leaves != nullptr) leaves[row * n_trees + t] = node;
    const float* lv = leaf_val + (off + node) * c + ch0;
#pragma unroll
    for (int k = 0; k < kChannels; ++k)
      if (k < nch) acc[k] += __ldg(lv + k);
  }
#pragma unroll
  for (int k = 0; k < kChannels; ++k) {
    if (k < nch) {
      // two roundings, as the reference computes base + eta * sum (no FMA)
      const float v = mode == 0 ? __fadd_rn(base, __fmul_rn(eta, acc[k]))
                                : __fdiv_rn(acc[k], (float)n_trees);
      out[row * c + ch0 + k] = v;
    }
  }
}

template <typename BinT>
int launch(const void* Xb, const void* sf, const void* sb, const void* l, const void* r,
           const void* lv, void* out, void* leaves, long long n, int d, int n_trees,
           int pool, int c, int ch0, int nch, int max_depth, int mode, float eta,
           float base, void* stream) {
  if (nch < 1 || nch > kChannels) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  ensemble_walk_kernel<BinT><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const BinT*)Xb, (const int32_t*)sf, (const int32_t*)sb, (const int32_t*)l,
      (const int32_t*)r, (const float*)lv, (float*)out, (int32_t*)leaves, n, d, n_trees,
      pool, c, ch0, nch, max_depth, mode, eta, base);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ensemble_walk_i8(const void* Xb, const void* sf, const void* sb, const void* l,
                                const void* r, const void* lv, void* out, void* leaves,
                                long long n, int d, int n_trees, int pool, int c, int ch0,
                                int nch, int max_depth, int mode, float eta, float base,
                                void* stream) {
  return launch<int8_t>(Xb, sf, sb, l, r, lv, out, leaves, n, d, n_trees, pool, c, ch0, nch,
                        max_depth, mode, eta, base, stream);
}

extern "C" int ensemble_walk_i32(const void* Xb, const void* sf, const void* sb, const void* l,
                                 const void* r, const void* lv, void* out, void* leaves,
                                 long long n, int d, int n_trees, int pool, int c, int ch0,
                                 int nch, int max_depth, int mode, float eta, float base,
                                 void* stream) {
  return launch<int32_t>(Xb, sf, sb, l, r, lv, out, leaves, n, d, n_trees, pool, c, ch0,
                         nch, max_depth, mode, eta, base, stream);
}
