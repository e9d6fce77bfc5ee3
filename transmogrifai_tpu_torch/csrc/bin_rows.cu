// K-A bin_rows: quantile binning of a float32 feature matrix.
//
// Replaces: transmogrifai_tpu/ops/trees.py::_bin_chunk (via bin_with_edges),
// a vmapped jnp.searchsorted(edges[f], X[:, f], side="left").
//
// Semantics, held bit for bit: JAX's default "scan" searchsorted runs a fixed
// ceil(log2(E + 1)) halving steps with low = 0, high = E, mid = (low+high)/2,
// and goes left iff key(x) <= key(edges[mid]) under the sort comparator's
// total order (-inf < ... < -0 == +0 < ... < inf < NaN, all NaNs equal).
// The answer is high.  So NaN lands in bin E (the last) and -inf in bin 0,
// and a value equal to an edge lands on that edge's own bin.
//
// Bound on the card: bytes.  Each (row, feature) reads 4 bytes and writes 1
// (int8) or 4 (int32); the log2(B) compares run from shared memory.
// Design: one thread per (row, feature) over a flat index, so consecutive
// threads read consecutive floats and write consecutive bins (coalesced).
// The block stages edges f32[d, E] in shared memory once (1.2 KB for the
// Titanic model) and every search runs there; when edges do not fit the
// per-block limit the search reads them through the L1 cache instead.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int32_t total_order_key(float v) {
  // canonicalise as the JAX comparator does: -0 -> +0, every NaN -> +NaN
  if (v == 0.0f) v = 0.0f;
  int32_t bits = __float_as_int(v);
  if (v != v) bits = 0x7fc00000;
  // negative floats: flip the magnitude so integer order is float order
  return bits >= 0 ? bits : (bits ^ 0x7fffffff);
}

template <typename OutT>
__global__ void bin_rows_kernel(const float* __restrict__ X,
                                const float* __restrict__ edges,
                                OutT* __restrict__ out, long long n, int d,
                                int n_edges, int n_levels, int stage_edges) {
  extern __shared__ float sh_edges[];
  const float* E = edges;
  if (stage_edges) {
    for (int i = threadIdx.x; i < d * n_edges; i += blockDim.x) sh_edges[i] = edges[i];
    __syncthreads();
    E = sh_edges;
  }
  const long long total = n * (long long)d;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += stride) {
    const int f = (int)(idx % d);
    const int32_t q = total_order_key(X[idx]);
    const float* e = E + (long long)f * n_edges;
    uint32_t low = 0, high = (uint32_t)n_edges;
    for (int s = 0; s < n_levels; ++s) {
      const uint32_t mid = (low + high) >> 1;
      if (q <= total_order_key(e[mid])) high = mid; else low = mid;
    }
    out[idx] = (OutT)high;
  }
}

template <typename OutT>
int launch(const void* X, const void* edges, void* out, long long n, int d, int n_edges,
           int n_levels, void* stream) {
  const int threads = 256;
  long long blocks = (n * (long long)d + threads - 1) / threads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;  // grid-stride beyond 64 blocks/SM
  if (blocks < 1) blocks = 1;
  size_t smem = (size_t)d * n_edges * sizeof(float);
  int stage = 0;
  if (smem <= 48 * 1024) {
    stage = 1;
  } else if (smem <= 227 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(bin_rows_kernel<OutT>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    stage = 1;
  }
  bin_rows_kernel<OutT><<<(unsigned)blocks, threads, stage ? smem : 0,
                          (cudaStream_t)stream>>>(
      (const float*)X, (const float*)edges, (OutT*)out, n, d, n_edges, n_levels, stage);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bin_rows_i8(const void* X, const void* edges, void* out, long long n, int d,
                           int n_edges, int n_levels, void* stream) {
  return launch<int8_t>(X, edges, out, n, d, n_edges, n_levels, stream);
}

extern "C" int bin_rows_i32(const void* X, const void* edges, void* out, long long n, int d,
                            int n_edges, int n_levels, void* stream) {
  return launch<int32_t>(X, edges, out, n, d, n_edges, n_levels, stream);
}
