// K-U mlp_grad: the multilayer perceptron fits' loss gradient (backward) and
// their forward pass, for a batch of fits at once.
//
// Replaces: the jax.grad(loss_fn) of transmogrifai_tpu/ops/mlp.py::fit_mlp
// (:56-62) as fit_mlp_grid_folds (:90) vmaps it, and forward / predict_mlp_grid
// (:32, :108).  A network of L = 1..9 weight layers with sizes
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
// A block takes one fit and a chunk of rows and walks the chunk in tiles of
// R rows (R = 32 where the tile fits, down to 1 at the widest networks; the
// wrapper picks it).  Every hidden layer's activations and the logits of the
// tile sit in shared memory, with two delta buffers (gradient mode); the
// tile's features are read from device memory (L1 and L2 keep them for the
// tile's passes), so a wide input costs no shared memory.  The weights never
// sit there whole: a layer's product (forward: the tile's activations times
// W_l; backward: the deltas times W_l^T) streams W_l through shared memory
// in slabs of 32 inputs x (16 | 32 | 64) outputs, one pass a slab, each
// thread holding up to 8 (row, output) sums; a layer of at most 2,048
// weights is read straight from device memory instead (no slab barriers).
// Every output is one fused multiply-add chain over its inputs in order.
// Each weight's and bias's gradient belongs to one thread in a tile, which
// sums the tile's rows' products in float64 (a float32 times a float32 is
// exact in float64) and adds that to the weight's float64 accumulator: in
// shared memory while a fit's E accumulators fit beside the tile in half of
// it (two blocks an SM), else in
// the block's own slice of the partial buffer in device memory (read ahead
// four at a time, added, written back by the same thread: no atomics).
// The chunks' float64 partials are summed in chunk order and rounded to
// float32 once by mlp_finish: runs repeat bit for bit.  The sigmoid is
// 1 / (1 + exp(-x)) with libdevice's expf.
//
// Limits: at most 9 weight layers (8 hidden), d and hidden widths <= 4,096,
// 2 <= k <= 128 (the wrapper raises ValueError beyond).
//
// Bound on the card: operations (about 6 multiply-adds a weight a row,
// forward and backward, the gradient's in float64) against the bytes of X
// read once per fit.  The device-memory accumulators add 16 bytes a weight
// a tile of R rows: at E = 68,130 and R = 32 that is as many bytes as
// multiply-adds / 12.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 9;
constexpr int kMaxWidth = 4096;
constexpr int kMaxClasses = 128;
constexpr int kSlab = 32;          // inputs a slab of weights
constexpr int kCols = 64;          // the most outputs a slab
constexpr int kSlabStride = kCols + 1;
constexpr int kMaxRows = 32;       // rows a tile
constexpr int kPerThread = 8;      // (row, output) sums a thread in a product
constexpr int kDirect = 2048;      // the most weights a layer read without slabs
constexpr int kAhead = 4;          // accumulators a thread reads ahead

struct Net {
  int L;
  int dims[kMaxLayers + 1];
  long long woff[kMaxLayers];
  long long boff[kMaxLayers];
  long long E;
};

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// the epilogue of an output: FWD (bias given: b[j] added, the sigmoid unless
// LAST) or the backward delta (times h (1 - h), h = hb[r][j])
__device__ __forceinline__ float finish(float s, int r, int j, int outer,
                                        const float* __restrict__ bias, const float* hb,
                                        bool last) {
  if (bias != nullptr) {
    const float v = __fadd_rn(s, bias[j]);
    return last ? v : sigmoid(v);
  }
  const float h = hb[r * outer + j];
  return __fmul_rn(s, __fmul_rn(h, __fsub_rn(1.0f, h)));
}

// out[r][j] for r < R, j < outer: sum over t < inner of in[r][t] W(t, j) in
// input order, one FMA chain each, then ``finish``; W(t, j) = Wg[t outer + j]
// (a layer's [inner, outer] matrix) or, TRANS, Wg[j inner + t] (its
// transpose).  ``in`` is the tile's rows (row stride inner) in shared memory,
// or for the first layer the features in device memory; the rows from
// ``rows`` on are written as 0.  A layer of at most kDirect weights is read
// straight from device memory (L1 keeps it), a thread an output; a larger
// one streams through shared memory in slabs of kSlab inputs x (16 | 32 |
// 64) outputs, each thread holding up to kPerThread (row, output) sums.
// Every thread of the block calls it; it ends with a barrier.
template <bool TRANS>
__device__ void product(const float* in, int R, int rows, int inner, int outer,
                        const float* __restrict__ Wg, const float* __restrict__ bias,
                        const float* hb, bool last, float* slab, float* out) {
  const int tid = threadIdx.x;
  if ((long long)inner * outer <= kDirect) {
    for (int i = tid; i < R * outer; i += kThreads) {
      const int r = i / outer, j = i % outer;
      float v = 0.0f;
      if (r < rows) {
        float s = 0.0f;
        for (int t = 0; t < inner; ++t)
          s = __fmaf_rn(in[r * inner + t],
                        __ldg(TRANS ? Wg + (long long)j * inner + t
                                    : Wg + (long long)t * outer + j), s);
        v = finish(s, r, j, outer, bias, hb, last);
      }
      out[i] = v;
    }
    __syncthreads();
    return;
  }
  const int cols = outer > 32 ? 64 : (outer > 16 ? 32 : 16);
  const int groups = kThreads / cols;
  const int jj = tid % cols, rg = tid / cols;
  for (int j0 = 0; j0 < outer; j0 += cols) {
    float acc[kPerThread];
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) acc[i] = 0.0f;
    for (int t0 = 0; t0 < inner; t0 += kSlab) {
      const int ts = min(kSlab, inner - t0);
      __syncthreads();  // the slab is free
      for (int i = tid; i < kSlab * cols; i += kThreads) {
        int tt, jc;
        if (TRANS) {
          jc = i / kSlab;
          tt = i % kSlab;
        } else {
          tt = i / cols;
          jc = i % cols;
        }
        float v = 0.0f;
        if (tt < ts && j0 + jc < outer)
          v = TRANS ? Wg[(long long)(j0 + jc) * inner + t0 + tt]
                    : Wg[(long long)(t0 + tt) * outer + j0 + jc];
        slab[tt * kSlabStride + jc] = v;
      }
      __syncthreads();
      if (j0 + jj < outer) {
        for (int tt = 0; tt < ts; ++tt) {
          const float wv = slab[tt * kSlabStride + jj];
#pragma unroll
          for (int i = 0; i < kPerThread; ++i) {
            const int r = rg + groups * i;
            if (r < rows) acc[i] = __fmaf_rn(in[r * inner + t0 + tt], wv, acc[i]);
          }
        }
      }
    }
    const int j = j0 + jj;
    if (j < outer) {
#pragma unroll
      for (int i = 0; i < kPerThread; ++i) {
        const int r = rg + groups * i;
        if (r < R) out[r * outer + j] = r < rows ? finish(acc[i], r, j, outer, bias, hb, last)
                                                 : 0.0f;
      }
    }
  }
  __syncthreads();
}

// GRAD: gradient mode (accumulators, partial out), else forward mode (z, prob
// out).  SMEM_ACC: the E float64 accumulators in shared memory (else in the
// block's slice of partial).
template <bool GRAD, bool SMEM_ACC>
__global__ void __launch_bounds__(kThreads)
mlp_kernel(const float* __restrict__ X, const float* __restrict__ y,
           const float* __restrict__ w, const int32_t* __restrict__ fold,
           const float* __restrict__ wsum, const float* __restrict__ params,
           double* __restrict__ partial, float* __restrict__ z_out, float* __restrict__ p_out,
           int n, int C, int chunk_rows, int R, const Net net) {
  extern __shared__ double smem[];
  const int L = net.L, d = net.dims[0], k = net.dims[L];
  const long long E = net.E;
  double* acc = SMEM_ACC ? smem : partial + ((long long)blockIdx.x * C + blockIdx.y) * E;
  float* A[kMaxLayers + 1];                              // [R, dims[l]], l >= 1
  float* cur = (float*)(smem + (SMEM_ACC ? E : 0));
  int maxd = 0;
  for (int l = 1; l <= L; ++l) {
    A[l] = cur;
    cur += R * net.dims[l];
    maxd = max(maxd, net.dims[l]);
  }
  float* Dbuf[2] = {cur, cur + (GRAD ? R * maxd : 0)};   // deltas, ping-pong
  cur += GRAD ? 2 * R * maxd : 0;
  float* slab = cur;                                     // [kSlab, kSlabStride]
  cur += kSlab * kSlabStride;
  float* wr = cur;                                       // [R]
  int* yr = (int*)(wr + kMaxRows);                       // [R]

  const int tid = threadIdx.x;
  const int c = blockIdx.y;
  const float* P = params + (long long)c * E;
  if (SMEM_ACC)
    for (long long e = tid; e < E; e += kThreads) acc[e] = 0.0;
  const int f = GRAD ? fold[c] : 0;
  const float ws = GRAD ? wsum[c] : 1.0f;
  const long long r0 = (long long)blockIdx.x * chunk_rows;
  const long long r1 = min((long long)n, r0 + chunk_rows);
  for (long long t0 = r0; t0 < r1; t0 += R) {
    const int rows = (int)min((long long)R, r1 - t0);
    const bool first = !SMEM_ACC && t0 == r0;
    __syncthreads();  // the previous tile is consumed (and acc is set)
    const float* X0 = X + t0 * d;   // the tile's features, read from device memory
    if (tid < R) {
      wr[tid] = (GRAD && tid < rows) ? w[(long long)f * n + t0 + tid] : 0.0f;
      yr[tid] = tid < rows ? (int)y[t0 + tid] : 0;
    }
    // forward: each layer's outputs, the weights streamed in slabs
    for (int l = 1; l <= L; ++l)
      product<false>(l == 1 ? X0 : A[l - 1], R, rows, net.dims[l - 1], net.dims[l],
                     P + net.woff[l - 1], P + net.boff[l - 1], nullptr, l == L, slab, A[l]);
    // the softmax of each row's logits: dz (GRAD) or z and the probabilities
    float* DL = Dbuf[0];
    if (tid < rows) {
      const float* zr = A[L] + tid * k;
      float mx = zr[0];
      for (int j = 1; j < k; ++j) mx = fmaxf(mx, zr[j]);
      float sum = 0.0f;
      for (int j = 0; j < k; ++j) {
        const float e = expf(__fsub_rn(zr[j], mx));
        sum = j == 0 ? e : __fadd_rn(sum, e);
      }
      if (GRAD) {
        for (int j = 0; j < k; ++j) {
          const float pj = __fdiv_rn(expf(__fsub_rn(zr[j], mx)), sum);
          DL[tid * k + j] = __fdiv_rn(
              __fmul_rn(wr[tid], __fsub_rn(pj, j == yr[tid] ? 1.0f : 0.0f)), ws);
        }
      } else {
        const long long o = ((long long)c * n + t0 + tid) * k;
        for (int j = 0; j < k; ++j) {
          z_out[o + j] = zr[j];
          p_out[o + j] = __fdiv_rn(expf(__fsub_rn(zr[j], mx)), sum);
        }
      }
    } else if (GRAD && tid < R) {
      for (int j = 0; j < k; ++j) DL[tid * k + j] = 0.0f;
    }
    if (!GRAD) continue;
    __syncthreads();
    // backward: each layer's weight and bias gradients (the accumulators of
    // kAhead entries a thread read before their sums, so their loads overlap),
    // then the deltas below
    int side = 0;
    for (int l = L; l >= 1; --l) {
      const int q = net.dims[l - 1], m = net.dims[l];
      const float* Al = l == 1 ? X0 : A[l - 1];
      const float* Dl = Dbuf[side];
      const long long qm = (long long)q * m, total = qm + m;
      for (long long e0 = tid; e0 < total; e0 += kAhead * kThreads) {
        long long at[kAhead];
        double old[kAhead];
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const long long e = e0 + (long long)u * kThreads;
          at[u] = e < qm ? net.woff[l - 1] + e : net.boff[l - 1] + (e - qm);
          old[u] = (!first && e < total) ? acc[at[u]] : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
          const long long e = e0 + (long long)u * kThreads;
          if (e >= total) continue;
          double s = 0.0;
          if (e < qm) {
            const int a = (int)(e / m), j = (int)(e % m);
            for (int r = 0; r < rows; ++r) s += (double)Al[r * q + a] * (double)Dl[r * m + j];
          } else {
            const int j = (int)(e - qm);
            for (int r = 0; r < rows; ++r) s += (double)Dl[r * m + j];
          }
          acc[at[u]] = old[u] + s;
        }
      }
      if (l > 1) {
        product<true>(Dl, R, rows, m, q, P + net.woff[l - 1], nullptr, Al, false, slab,
                      Dbuf[side ^ 1]);
        side ^= 1;
      }
    }
  }
  if (!GRAD || !SMEM_ACC) return;
  __syncthreads();
  double* out = partial + ((long long)blockIdx.x * C + c) * E;
  for (long long e = tid; e < E; e += kThreads) out[e] = acc[e];
}

__global__ void mlp_finish(const double* __restrict__ partial, float* __restrict__ grad,
                           int chunks, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  double s = 0.0;
  for (int q = 0; q < chunks; ++q) s += partial[(long long)q * total + i];
  grad[i] = __double2float_rn(s);
}

constexpr size_t kSmemMax = 232448;  // a block's shared memory on the H100

bool make_net(int L, const int* dims, Net* net) {
  if (L < 1 || L > kMaxLayers) return false;
  net->L = L;
  long long off = 0;
  for (int l = 0; l <= L; ++l) {
    const int v = dims[l];
    if (v <= 0 || v > kMaxWidth) return false;
    net->dims[l] = v;
  }
  if (dims[L] < 2 || dims[L] > kMaxClasses) return false;
  for (int l = 0; l < L; ++l) {
    net->woff[l] = off;
    off += (long long)dims[l] * dims[l + 1];
    net->boff[l] = off;
    off += dims[l + 1];
  }
  net->E = off;
  return true;
}

// shared memory of a tile of R rows, without the accumulators
size_t tile_bytes(bool grad, const Net& net, int R) {
  size_t act = 0;
  int maxd = 0;
  for (int l = 1; l <= net.L; ++l) {
    act += net.dims[l];
    maxd = max(maxd, net.dims[l]);
  }
  return ((size_t)R * act + (grad ? 2 * (size_t)R * maxd : 0) + kSlab * kSlabStride +
          2 * kMaxRows) * sizeof(float);
}

template <bool GRAD, bool SMEM_ACC>
int launch_kernel(const void* X, const void* y, const void* w, const void* fold,
                  const void* wsum, const void* params, void* partial, void* z, void* prob,
                  int n, int C, int chunks, int chunk_rows, int R, const Net& net,
                  size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mlp_kernel<GRAD, SMEM_ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mlp_kernel<GRAD, SMEM_ACC><<<dim3((unsigned)chunks, (unsigned)C), kThreads, smem, st>>>(
      (const float*)X, (const float*)y, (const float*)w, (const int32_t*)fold,
      (const float*)wsum, (const float*)params, (double*)partial, (float*)z, (float*)prob, n,
      C, chunk_rows, R, net);
  return (int)cudaGetLastError();
}

bool args_ok(int n, int C, int chunks, int chunk_rows, int R) {
  return n > 0 && C > 0 && C <= 65535 && chunks > 0 && R >= 1 && R <= kMaxRows &&
         chunk_rows > 0 && chunk_rows % R == 0;
}

}  // namespace

// The tile rows R (32, 16, ..., 1) the wrapper should use for this network,
// and whether its accumulators fit in shared memory (*smem_acc); 0 when no
// tile fits.
extern "C" int mlp_plan(int grad, int L, const int* dims, int* smem_acc) {
  Net net;
  if (!make_net(L, dims, &net)) return 0;
  for (int R = kMaxRows; R >= 1; R /= 2) {
    const size_t t = tile_bytes(grad != 0, net, R);
    if (t > kSmemMax) continue;
    // accumulators in shared memory only while two blocks still fit an SM:
    // one block an SM hides their latency worse than device memory does
    // (tools/mlp_accumulators.py on an NVIDIA H100 80GB HBM3 at 700 W: 3.46
    // against 5.14 ms at (32, 128, 64, 26), 7.94 against 14.1 at (2110, 10,
    // 2); shared memory 0.741 against 0.769 at (21, 10, 2))
    *smem_acc = grad && R == kMaxRows && t + (size_t)net.E * sizeof(double) <= kSmemMax / 2;
    return R;
  }
  return 0;
}

// Gradient mode: grad f32[C, E], partial f64[chunks, C, E]; dims i32[L + 1]
// on the host.
extern "C" int mlp_grad(const void* X, const void* y, const void* w, const void* fold,
                        const void* wsum, const void* params, void* partial, void* grad, int n,
                        int C, int chunks, int chunk_rows, int R, int smem_acc, int L,
                        const int* dims, void* stream) {
  Net net;
  if (!args_ok(n, C, chunks, chunk_rows, R) || !make_net(L, dims, &net))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t tile = tile_bytes(true, net, R);
  int err;
  if (smem_acc) {
    const size_t smem = tile + (size_t)net.E * sizeof(double);
    if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
    err = launch_kernel<true, true>(X, y, w, fold, wsum, params, partial, nullptr, nullptr,
                                    n, C, chunks, chunk_rows, R, net, smem, st);
  } else {
    if (tile > kSmemMax) return (int)cudaErrorInvalidValue;
    err = launch_kernel<true, false>(X, y, w, fold, wsum, params, partial, nullptr, nullptr,
                                     n, C, chunks, chunk_rows, R, net, tile, st);
  }
  if (err != 0) return err;
  const int threads = 128;
  const long long total = (long long)C * net.E;
  mlp_finish<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const double*)partial, (float*)grad, chunks, total);
  return (int)cudaGetLastError();
}

// Forward mode: z and prob f32[C, n, k].
extern "C" int mlp_forward(const void* X, const void* params, void* z, void* prob, int n,
                           int C, int chunks, int chunk_rows, int R, int L, const int* dims,
                           void* stream) {
  Net net;
  if (!args_ok(n, C, chunks, chunk_rows, R) || !make_net(L, dims, &net))
    return (int)cudaErrorInvalidValue;
  const size_t tile = tile_bytes(false, net, R);
  if (tile > kSmemMax) return (int)cudaErrorInvalidValue;
  return launch_kernel<false, false>(X, X, X, nullptr, nullptr, params, nullptr, z, prob, n, C,
                                     chunks, chunk_rows, R, net, tile, (cudaStream_t)stream);
}
