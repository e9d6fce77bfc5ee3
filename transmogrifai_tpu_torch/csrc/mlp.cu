// K-U mlp_grad: the multilayer perceptron fits' loss gradient (backward) and
// their forward pass, for a batch of fits at once.
//
// Replaces: the jax.grad(loss_fn) of transmogrifai_tpu/ops/mlp.py::fit_mlp
// (:56-62) as fit_mlp_grid_folds (:90) vmaps it, and forward / predict_mlp_grid
// (:32, :108).  A network of L = 1..3 weight layers with sizes
// dims[0] = d (features), dims[1..L-1] (sigmoid hidden layers), dims[L] = k
// (classes, a linear output layer and a softmax):
//   gradient mode (mlp_grad):  for each fit c, with dz = w (softmax(z) - Y) / wsum
//     per row (w the row's weight in the fit's fold, Y the one-hot label),
//     the gradient of every weight and bias, backward through every layer
//     (the hidden layers' delta times h (1 - h));
//   forward mode (mlp_forward): the logits z and the probabilities
//     softmax(z) (exp(z - max) over its sum) of every fit on every row.
// A fit's parameters are one flat float32 vector: for each layer l its
// weight matrix W_l [dims[l-1], dims[l]] row-major, then its bias [dims[l]].
//
// A block takes one fit and a chunk of rows, with the fit's parameters in
// shared memory.  It walks the chunk in tiles of 32 rows: the tile's
// features, then each layer's activations, then (gradient mode) the deltas
// of every layer are staged in shared memory, each phase spread over the
// block's threads (a thread an output, a dot product over its inputs as a
// fused multiply-add chain) between barriers.  Each weight's and bias's
// gradient belongs to one thread, which adds the tile's 32 products to its
// float64 sum in shared memory (a float32 times a float32 is exact in
// float64).  The chunks' float64 partials are summed in chunk order and
// rounded to float32 once by mlp_finish: no atomics, runs repeat bit for bit.
// The sigmoid is 1 / (1 + exp(-x)) with libdevice's expf.
//
// Limits: at most 3 weight layers (2 hidden), d <= 128, hidden widths <= 64,
// k <= 8 (the wrapper raises NotImplementedError beyond).
//
// Bound on the card: operations at these widths (about 6 multiply-adds a
// weight a row, forward and backward) against the bytes of X read once per
// fit; at Titanic's (10, 10, 2) network both are a few microseconds a step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;
constexpr int kMaxLayers = 3;

struct Net {
  int L;
  int dims[kMaxLayers + 1];
  int woff[kMaxLayers];
  int boff[kMaxLayers];
  int E;
};

__device__ __forceinline__ Net make_net(int L, int d, int h1, int h2, int k) {
  Net net;
  net.L = L;
  net.dims[0] = d;
  if (L == 1) {
    net.dims[1] = k;
  } else if (L == 2) {
    net.dims[1] = h1;
    net.dims[2] = k;
  } else {
    net.dims[1] = h1;
    net.dims[2] = h2;
    net.dims[3] = k;
  }
  int off = 0;
  for (int l = 0; l < L; ++l) {
    net.woff[l] = off;
    off += net.dims[l] * net.dims[l + 1];
    net.boff[l] = off;
    off += net.dims[l + 1];
  }
  net.E = off;
  return net;
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// GRAD: gradient mode (accumulators, partial out), else forward mode (z, prob out).
template <bool GRAD>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const float* __restrict__ X, const float* __restrict__ y,
           const float* __restrict__ w, const int32_t* __restrict__ fold,
           const float* __restrict__ wsum, const float* __restrict__ params,
           double* __restrict__ partial, float* __restrict__ z_out, float* __restrict__ p_out,
           int n, int C, int chunk_rows, int L, int d, int h1, int h2, int k) {
  extern __shared__ double smem[];
  const Net net = make_net(L, d, h1, h2, k);
  const int E = net.E;
  double* acc = smem;                                    // [E]          (GRAD)
  float* P = (float*)(acc + (GRAD ? E : 0));             // [E]
  float* A[kMaxLayers + 1];                              // [kRows, dims[l]]
  float* D[kMaxLayers + 1];                              // [kRows, dims[l]], l >= 1
  float* cur = P + E;
  for (int l = 0; l <= L; ++l) {
    A[l] = cur;
    cur += kRows * net.dims[l];
  }
  for (int l = 1; l <= L; ++l) {
    D[l] = cur;
    cur += GRAD ? kRows * net.dims[l] : 0;
  }
  float* wr = cur;                                       // [kRows]
  int* yr = (int*)(wr + kRows);                          // [kRows]

  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  for (int e = tid; e < E; e += kThreads) {
    P[e] = params[(long long)c * E + e];
    if (GRAD) acc[e] = 0.0;
  }
  const int f = GRAD ? fold[c] : 0;
  const float ws = GRAD ? wsum[c] : 1.0f;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long t0 = r0; t0 < r1; t0 += kRows) {
    const int rows = (int)min((long long)kRows, r1 - t0);
    __syncthreads();  // the previous tile is consumed (and P / acc are set)
    for (int i = tid; i < kRows * d; i += kThreads) {
      const int r = i / d;
      A[0][i] = r < rows ? X[(t0 + r) * d + (i % d)] : 0.0f;
    }
    if (tid < kRows) {
      wr[tid] = (GRAD && tid < rows) ? w[(long long)f * n + t0 + tid] : 0.0f;
      yr[tid] = tid < rows ? (int)y[t0 + tid] : 0;
    }
    __syncthreads();
    // forward: each layer's outputs, a thread an output
    for (int l = 1; l <= L; ++l) {
      const int q = net.dims[l - 1], m = net.dims[l];
      const float* W = P + net.woff[l - 1];
      const float* b = P + net.boff[l - 1];
      for (int i = tid; i < kRows * m; i += kThreads) {
        const int r = i / m, j = i % m;
        const float* a = A[l - 1] + r * q;
        float s = 0.0f;
        for (int t = 0; t < q; ++t) s = __fmaf_rn(a[t], W[t * m + j], s);
        s = __fadd_rn(s, b[j]);
        A[l][i] = l < L ? sigmoid(s) : s;
      }
      __syncthreads();
    }
    // the softmax of each row's logits: dz (GRAD) or z and the probabilities
    if (tid < rows) {
      const float* zr = A[L] + tid * k;
      float mx = zr[0];
      for (int j = 1; j < k; ++j) mx = fmaxf(mx, zr[j]);
      float e[8];
      float sum = 0.0f;
      for (int j = 0; j < k; ++j) {
        e[j] = expf(__fsub_rn(zr[j], mx));
        sum = j == 0 ? e[0] : __fadd_rn(sum, e[j]);
      }
      if (GRAD) {
        for (int j = 0; j < k; ++j) {
          const float pj = __fdiv_rn(e[j], sum);
          D[L][tid * k + j] = __fdiv_rn(
              __fmul_rn(wr[tid], __fsub_rn(pj, j == yr[tid] ? 1.0f : 0.0f)), ws);
        }
      } else {
        const long long o = ((long long)c * n + t0 + tid) * k;
        for (int j = 0; j < k; ++j) {
          z_out[o + j] = zr[j];
          p_out[o + j] = __fdiv_rn(e[j], sum);
        }
      }
    } else if (GRAD && tid < kRows) {
      for (int j = 0; j < k; ++j) D[L][tid * k + j] = 0.0f;
    }
    if (!GRAD) continue;
    __syncthreads();
    // backward: each layer's weight and bias gradients, then the deltas below
    for (int l = L; l >= 1; --l) {
      const int q = net.dims[l - 1], m = net.dims[l];
      const float* Al = A[l - 1];
      const float* Dl = D[l];
      for (int e = tid; e < q * m + m; e += kThreads) {
        double s = 0.0;
        if (e < q * m) {
          const int a = e / m, j = e % m;
          for (int r = 0; r < kRows; ++r) s += (double)Al[r * q + a] * (double)Dl[r * m + j];
          acc[net.woff[l - 1] + e] += s;
        } else {
          const int j = e - q * m;
          for (int r = 0; r < kRows; ++r) s += (double)Dl[r * m + j];
          acc[net.boff[l - 1] + j] += s;
        }
      }
      if (l > 1) {
        const float* W = P + net.woff[l - 1];
        for (int i = tid; i < kRows * q; i += kThreads) {
          const int r = i / q, a = i % q;
          float s = 0.0f;
          for (int j = 0; j < m; ++j) s = __fmaf_rn(Dl[r * m + j], W[a * m + j], s);
          const float h = Al[i];
          D[l - 1][i] = __fmul_rn(s, __fmul_rn(h, __fsub_rn(1.0f, h)));
        }
        __syncthreads();
      }
    }
  }
  if (!GRAD) return;
  __syncthreads();
  for (int e = tid; e < E; e += kThreads)
    partial[((long long)blockIdx.x * C + c) * E + e] = acc[e];
}

__global__ void mlp_finish(const double* __restrict__ partial, float* __restrict__ grad,
                           int chunks, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  double s = 0.0;
  for (int q = 0; q < chunks; ++q) s += partial[(long long)q * total + i];
  grad[i] = __double2float_rn(s);
}

size_t smem_bytes(bool grad, int L, int d, int h1, int h2, int k, int* E_out) {
  int dims[kMaxLayers + 1] = {d, 0, 0, 0};
  if (L == 1) {
    dims[1] = k;
  } else if (L == 2) {
    dims[1] = h1;
    dims[2] = k;
  } else {
    dims[1] = h1;
    dims[2] = h2;
    dims[3] = k;
  }
  int E = 0, act = 0, del = 0;
  for (int l = 0; l < L; ++l) E += dims[l] * dims[l + 1] + dims[l + 1];
  for (int l = 0; l <= L; ++l) act += dims[l];
  for (int l = 1; l <= L; ++l) del += dims[l];
  *E_out = E;
  return (grad ? (size_t)E * sizeof(double) : 0) + (size_t)E * sizeof(float) +
         (size_t)kRows * (act + (grad ? del : 0)) * sizeof(float) + kRows * 2 * sizeof(float);
}

bool dims_ok(int L, int d, int h1, int h2, int k) {
  if (L < 1 || L > kMaxLayers || d <= 0 || d > 128 || k < 2 || k > 8) return false;
  if (L >= 2 && (h1 <= 0 || h1 > 64)) return false;
  if (L == 3 && (h2 <= 0 || h2 > 64)) return false;
  return true;
}

template <bool GRAD>
int launch(const void* X, const void* y, const void* w, const void* fold, const void* wsum,
           const void* params, void* partial, void* z, void* prob, int n, int C, int chunks,
           int chunk_rows, int L, int d, int h1, int h2, int k, cudaStream_t st) {
  int E = 0;
  const size_t smem = smem_bytes(GRAD, L, d, h1, h2, k, &E);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mlp_kernel<GRAD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mlp_kernel<GRAD><<<dim3((unsigned)chunks, (unsigned)C), kThreads, smem, st>>>(
      (const float*)X, (const float*)y, (const float*)w, (const int32_t*)fold,
      (const float*)wsum, (const float*)params, (double*)partial, (float*)z, (float*)prob, n,
      C, chunk_rows, L, d, h1, h2, k);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !GRAD) return (int)err;
  const int threads = 128, total = C * E;
  mlp_finish<<<(total + threads - 1) / threads, threads, 0, st>>>(
      (const double*)partial, (float*)z, chunks, total);
  return (int)cudaGetLastError();
}

}  // namespace

// Gradient mode: grad f32[C, E] (passed as ``grad``), partial f64[chunks, C, E].
extern "C" int mlp_grad(const void* X, const void* y, const void* w, const void* fold,
                        const void* wsum, const void* params, void* partial, void* grad, int n,
                        int C, int chunks, int chunk_rows, int L, int d, int h1, int h2, int k,
                        void* stream) {
  if (n <= 0 || C <= 0 || C > 65535 || chunks <= 0 || chunk_rows % kRows != 0 ||
      !dims_ok(L, d, h1, h2, k))
    return (int)cudaErrorInvalidValue;
  return launch<true>(X, y, w, fold, wsum, params, partial, grad, nullptr, n, C, chunks,
                      chunk_rows, L, d, h1, h2, k, (cudaStream_t)stream);
}

// Forward mode: z and prob f32[C, n, k].
extern "C" int mlp_forward(const void* X, const void* params, void* z, void* prob, int n,
                           int C, int chunks, int chunk_rows, int L, int d, int h1, int h2,
                           int k, void* stream) {
  if (n <= 0 || C <= 0 || C > 65535 || chunks <= 0 || chunk_rows % kRows != 0 ||
      !dims_ok(L, d, h1, h2, k))
    return (int)cudaErrorInvalidValue;
  return launch<false>(X, X, X, nullptr, nullptr, params, nullptr, z, prob, n, C, chunks,
                       chunk_rows, L, d, h1, h2, k, (cudaStream_t)stream);
}
