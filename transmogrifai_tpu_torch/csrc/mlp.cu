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

// ---------------------------------------------------------------------------
// The GEMM-shaped entry (networks of more than 16,384 parameters a fit,
// ops/mlp.py::MLP_BLOCK_PARAMS: the wide text flows' inputs).  A pass of up to RP rows runs layer by layer over
// the C fits, each product one launch; the activations [RP, dims[l]] of
// every layer and two delta buffers [RP, max width] a fit live in device
// memory (the caller's workspace):
//   mlp_gemm (forward: act_l = sigmoid(act_{l-1} W_l + b_l), the logits
//     without the sigmoid; backward: D_{l-1} = (D_l W_l^T) h (1 - h)):
//     64 x 64 output tiles (128 x 16 for at most 16 outputs), the inputs in
//     slabs of kGemmK staged in shared memory, 4 x 4 (4 x 2) float32
//     outputs a thread (rows and columns strided so that a warp's shared
//     reads are broadcasts or consecutive), each one fused multiply-add
//     chain over its inputs in order (no TF32: the plain version and the
//     reference are float32);
//   mlp_softmax: a thread a (row, fit): the softmax of its logits and the
//     output delta w (p - Y) / wsum, or the logits and probabilities;
//   mlp_wgrad: the weight and bias gradients of a layer as BT x BJ float64
//     tiles of [dims[l-1] + 1, dims[l]] (the bias as an input of ones),
//     over the rows of one of S row splits, staged kWgradRows rows at a
//     time as float64: a thread's TT x TJ sums walk the split's rows in
//     order in registers (a float32 times a float32 is exact in float64)
//     and are added once a pass to the split's own slice
//     of the float64 partials [S, C, E], by the one thread that owns them:
//     no atomics.  mlp_finish sums the splits in order and rounds once.
// ---------------------------------------------------------------------------
constexpr int kGemmK = 32;           // inputs a slab of mlp_gemm
constexpr int kWgradRows = 16;       // rows a slab of mlp_wgrad

// MODE 0: a hidden layer's forward (bias, sigmoid); 1: the output layer's
// (bias); 2: a backward delta (times h (1 - h) of hb).  B(i, o) = W[i outer
// + o] (forward) or W[o inner + i] (backward, the transpose).
template <int BM, int BN, int TM, int TN, int MODE>
__global__ void __launch_bounds__(kThreads)
mlp_gemm(const float* __restrict__ in, long long in_cs, int in_ld,
         const float* __restrict__ params, long long E, long long woff, long long boff,
         const float* __restrict__ hb, long long h_cs, float* __restrict__ out, long long out_cs,
         int rows, int inner, int outer) {
  static_assert((BM / TM) * (BN / TN) == kThreads, "one output tile a block");
  __shared__ float As[BM][kGemmK + 1];
  __shared__ float Bs[kGemmK][BN + 1];
  const int tid = threadIdx.x, c = blockIdx.z;
  const int tx = tid % (BN / TN), ty = tid / (BN / TN);
  const long long r0 = (long long)blockIdx.x * BM;
  const int o0 = blockIdx.y * BN;
  const float* A = in + (long long)c * in_cs;
  const float* W = params + (long long)c * E + woff;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int u = 0; u < TN; ++u) acc[i][u] = 0.0f;
  for (int i0 = 0; i0 < inner; i0 += kGemmK) {
    const int kw = min(kGemmK, inner - i0);
    // the slab's loads all issued before any is stored (their latencies
    // overlap), then stored to shared memory
    constexpr int NA = BM * kGemmK / kThreads, NB = (kGemmK * BN + kThreads - 1) / kThreads;
    float va[NA], vb[NB];
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const int e = tid + x * kThreads, rr = e / kGemmK, ii = e % kGemmK;
      va[x] = (r0 + rr < rows && ii < kw) ? A[(r0 + rr) * in_ld + i0 + ii] : 0.0f;
    }
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      const int e = tid + x * kThreads;
      int ii, oo;
      if (MODE == 2) {  // W[o inner + i]: consecutive threads, consecutive i
        oo = e / kGemmK;
        ii = e % kGemmK;
      } else {          // W[i outer + o]: consecutive threads, consecutive o
        ii = e / BN;
        oo = e % BN;
      }
      float v = 0.0f;
      if (e < kGemmK * BN && ii < kw && o0 + oo < outer)
        v = MODE == 2 ? W[(long long)(o0 + oo) * inner + i0 + ii]
                      : W[(long long)(i0 + ii) * outer + o0 + oo];
      vb[x] = v;
    }
    __syncthreads();  // the previous slab is consumed
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const int e = tid + x * kThreads;
      As[e / kGemmK][e % kGemmK] = va[x];
    }
#pragma unroll
    for (int x = 0; x < NB; ++x) {
      const int e = tid + x * kThreads;
      if (e < kGemmK * BN) {
        if (MODE == 2)
          Bs[e % kGemmK][e / kGemmK] = vb[x];
        else
          Bs[e / BN][e % BN] = vb[x];
      }
    }
    __syncthreads();
    for (int ii = 0; ii < kw; ++ii) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty * TM + i][ii];
#pragma unroll
      for (int u = 0; u < TN; ++u) b[u] = Bs[ii][tx + u * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int u = 0; u < TN; ++u) acc[i][u] = __fmaf_rn(a[i], b[u], acc[i][u]);
    }
  }
  float* O = out + (long long)c * out_cs;
  const float* bias = params + (long long)c * E + boff;
  const float* H = hb + (long long)c * h_cs;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long r = r0 + ty * TM + i;
    if (r >= rows) continue;
#pragma unroll
    for (int u = 0; u < TN; ++u) {
      const int o = o0 + tx + u * (BN / TN);
      if (o >= outer) continue;
      float v;
      if (MODE == 2) {
        const float h = H[r * outer + o];
        v = __fmul_rn(acc[i][u], __fmul_rn(h, __fsub_rn(1.0f, h)));
      } else {
        v = __fadd_rn(acc[i][u], bias[o]);
        if (MODE == 0) v = sigmoid(v);
      }
      O[r * outer + o] = v;
    }
  }
}

// A thread a (row r of the pass, fit c): the softmax of the row's logits,
// then the output delta (GRAD) or the logits and probabilities.
__global__ void mlp_softmax(const float* __restrict__ logits, long long l_cs,
                            const float* __restrict__ y, const float* __restrict__ w,
                            const int32_t* __restrict__ fold, const float* __restrict__ wsum,
                            float* __restrict__ dout, long long d_cs, float* __restrict__ z_out,
                            float* __restrict__ p_out, int n, int k, int rows, long long p0,
                            int grad) {
  const int c = blockIdx.y;
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const float* zr = logits + (long long)c * l_cs + (long long)r * k;
  float mx = zr[0];
  for (int j = 1; j < k; ++j) mx = fmaxf(mx, zr[j]);
  float sum = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float e = expf(__fsub_rn(zr[j], mx));
    sum = j == 0 ? e : __fadd_rn(sum, e);
  }
  if (grad) {
    const float wr = w[(long long)fold[c] * n + p0 + r], ws = wsum[c];
    const int yr = (int)y[p0 + r];
    float* dr = dout + (long long)c * d_cs + (long long)r * k;
    for (int j = 0; j < k; ++j) {
      const float pj = __fdiv_rn(expf(__fsub_rn(zr[j], mx)), sum);
      dr[j] = __fdiv_rn(__fmul_rn(wr, __fsub_rn(pj, j == yr ? 1.0f : 0.0f)), ws);
    }
  } else {
    const long long o = ((long long)c * n + p0 + r) * k;
    for (int j = 0; j < k; ++j) {
      z_out[o + j] = zr[j];
      p_out[o + j] = __fdiv_rn(expf(__fsub_rn(zr[j], mx)), sum);
    }
  }
}

// The gradients of one layer [q + 1, m] (row q the bias) over split s =
// blockIdx.z % S of the pass's rows, added to partial[s, c, woff + t m + j].
template <int BT, int BJ, int TT, int TJ>
__global__ void __launch_bounds__(kThreads)
mlp_wgrad(const float* __restrict__ act, long long a_cs, int a_ld, const float* __restrict__ D,
          long long d_cs, double* __restrict__ partial, long long E, long long woff, int rows,
          int q, int m, int S, int C) {
  static_assert((BT / TT) * (BJ / TJ) == kThreads, "one output tile a block");
  // staged as float64 (each value converted once, not once a use)
  __shared__ double As[kWgradRows][BT + 1];
  __shared__ double Ds[kWgradRows][BJ + 1];
  const int tid = threadIdx.x;
  const int c = blockIdx.z / S, s = blockIdx.z % S;
  const int tx = tid % (BJ / TJ), ty = tid / (BJ / TJ);
  const int t0 = blockIdx.x * BT, j0 = blockIdx.y * BJ;
  const int rps = (rows + S - 1) / S;
  const long long r0 = (long long)s * rps;
  const long long r1 = min((long long)rows, r0 + rps);
  const float* A = act + (long long)c * a_cs;
  const float* Dc = D + (long long)c * d_cs;
  double acc[TT][TJ];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int u = 0; u < TJ; ++u) acc[i][u] = 0.0;
  // software pipeline: a slab's loads are issued (all together) while the
  // slab before it is summed, then stored to shared memory
  constexpr int NA = kWgradRows * BT / kThreads;
  constexpr int ND = (kWgradRows * BJ + kThreads - 1) / kThreads;
  float va[NA], vd[ND];
  auto fetch = [&](long long rb) {
    const int kr = (int)min((long long)kWgradRows, r1 - rb);
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const int e = tid + x * kThreads, rr = e / BT, t = t0 + e % BT;
      float v = 0.0f;
      if (rr < kr) v = t < q ? A[(rb + rr) * a_ld + t] : (t == q ? 1.0f : 0.0f);
      va[x] = v;
    }
#pragma unroll
    for (int x = 0; x < ND; ++x) {
      const int e = tid + x * kThreads, rr = e / BJ, jj = e % BJ;
      vd[x] = (e < kWgradRows * BJ && rr < kr && j0 + jj < m) ? Dc[(rb + rr) * m + j0 + jj]
                                                               : 0.0f;
    }
  };
  if (r0 < r1) fetch(r0);
  for (long long rb = r0; rb < r1; rb += kWgradRows) {
    const int kr = (int)min((long long)kWgradRows, r1 - rb);
    __syncthreads();  // the previous slab is consumed
#pragma unroll
    for (int x = 0; x < NA; ++x) {
      const int e = tid + x * kThreads;
      As[e / BT][e % BT] = (double)va[x];
    }
#pragma unroll
    for (int x = 0; x < ND; ++x) {
      const int e = tid + x * kThreads;
      if (e < kWgradRows * BJ) Ds[e / BJ][e % BJ] = (double)vd[x];
    }
    __syncthreads();
    if (rb + kWgradRows < r1) fetch(rb + kWgradRows);
    for (int rr = 0; rr < kr; ++rr) {
      double a[TT], dd[TJ];
#pragma unroll
      for (int i = 0; i < TT; ++i) a[i] = As[rr][ty + i * (BT / TT)];
#pragma unroll
      for (int u = 0; u < TJ; ++u) dd[u] = Ds[rr][tx + u * (BJ / TJ)];
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int u = 0; u < TJ; ++u) acc[i][u] = __fma_rn(a[i], dd[u], acc[i][u]);
    }
  }
  double* P = partial + ((long long)s * C + c) * E + woff;
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const int t = t0 + ty + i * (BT / TT);
    if (t > q) continue;
#pragma unroll
    for (int u = 0; u < TJ; ++u) {
      const int j = j0 + tx + u * (BJ / TJ);
      if (j < m) P[(long long)t * m + j] += acc[i][u];
    }
  }
}

template <int MODE>
cudaError_t run_gemm(const float* in, long long in_cs, int in_ld, const float* params,
                     long long E, long long woff, long long boff, const float* hb, long long h_cs,
                     float* out, long long out_cs, int rows, int inner, int outer, int C,
                     cudaStream_t st) {
  if (outer <= 16) {
    mlp_gemm<128, 16, 4, 2, MODE><<<dim3((unsigned)((rows + 127) / 128), 1u, (unsigned)C),
                                    kThreads, 0, st>>>(in, in_cs, in_ld, params, E, woff, boff,
                                                       hb, h_cs, out, out_cs, rows, inner,
                                                       outer);
  } else {
    mlp_gemm<64, 64, 4, 4, MODE><<<dim3((unsigned)((rows + 63) / 64),
                                        (unsigned)((outer + 63) / 64), (unsigned)C),
                                   kThreads, 0, st>>>(in, in_cs, in_ld, params, E, woff, boff,
                                                      hb, h_cs, out, out_cs, rows, inner, outer);
  }
  return cudaGetLastError();
}

cudaError_t run_wgrad(const float* act, long long a_cs, int a_ld, const float* D, long long d_cs,
                      double* partial, long long E, long long woff, int rows, int q, int m,
                      int S, int C, cudaStream_t st) {
  if (m <= 16) {
    mlp_wgrad<256, 16, 4, 4><<<dim3((unsigned)((q + 1 + 255) / 256), 1u, (unsigned)(C * S)),
                               kThreads, 0, st>>>(act, a_cs, a_ld, D, d_cs, partial, E, woff,
                                                  rows, q, m, S, C);
  } else {
    mlp_wgrad<64, 64, 4, 4><<<dim3((unsigned)((q + 1 + 63) / 64), (unsigned)((m + 63) / 64),
                                   (unsigned)(C * S)),
                              kThreads, 0, st>>>(act, a_cs, a_ld, D, d_cs, partial, E, woff,
                                                 rows, q, m, S, C);
  }
  return cudaGetLastError();
}

// Forward (and, GRAD, backward) of the C fits over the rows in passes of RP:
// act f32[C, RP * sum(dims[1..L])], dbuf f32[C, 2, RP * max width].
int run_gemm_entry(bool grad, const float* X, const float* y, const float* w,
                   const int32_t* fold, const float* wsum, const float* params, float* act,
                   float* dbuf, double* partial, float* grad_out, float* z, float* prob, int n,
                   int C, int RP, int S, const Net& net, cudaStream_t st) {
  const int L = net.L, d = net.dims[0], k = net.dims[L];
  long long widths = 0;
  int maxd = 0;
  long long aoff[kMaxLayers + 1];
  for (int l = 1; l <= L; ++l) {
    aoff[l] = (long long)RP * widths;
    widths += net.dims[l];
    maxd = max(maxd, net.dims[l]);
  }
  const long long a_cs = (long long)RP * widths;      // a fit's activations
  const long long d_cs = 2LL * RP * maxd;             // a fit's two delta buffers
  cudaError_t err;
  if (grad) {
    err = cudaMemsetAsync(partial, 0, (size_t)S * C * net.E * sizeof(double), st);
    if (err != cudaSuccess) return (int)err;
  }
  for (long long p0 = 0; p0 < n; p0 += RP) {
    const int rows = (int)min((long long)RP, n - p0);
    for (int l = 1; l <= L; ++l) {
      const bool first = l == 1;
      const float* in = first ? X + p0 * d : act + aoff[l - 1];
      const long long in_cs = first ? 0 : a_cs;
      err = l == L ? run_gemm<1>(in, in_cs, net.dims[l - 1], params, net.E, net.woff[l - 1],
                                 net.boff[l - 1], nullptr, 0, act + aoff[l], a_cs, rows,
                                 net.dims[l - 1], net.dims[l], C, st)
                   : run_gemm<0>(in, in_cs, net.dims[l - 1], params, net.E, net.woff[l - 1],
                                 net.boff[l - 1], nullptr, 0, act + aoff[l], a_cs, rows,
                                 net.dims[l - 1], net.dims[l], C, st);
      if (err != cudaSuccess) return (int)err;
    }
    mlp_softmax<<<dim3((unsigned)((rows + 127) / 128), (unsigned)C), 128, 0, st>>>(
        act + aoff[L], a_cs, y, w, fold, wsum, dbuf, d_cs, z, prob, n, k, rows, p0,
        grad ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (!grad) continue;
    int side = 0;
    for (int l = L; l >= 1; --l) {
      const int q = net.dims[l - 1], m = net.dims[l];
      const float* Dl = dbuf + (long long)side * RP * maxd;
      const bool first = l == 1;
      err = run_wgrad(first ? X + p0 * d : act + aoff[l - 1], first ? 0 : a_cs, q, Dl, d_cs,
                      partial, net.E, net.woff[l - 1], rows, q, m, S, C, st);
      if (err != cudaSuccess) return (int)err;
      if (l > 1) {
        err = run_gemm<2>(Dl, d_cs, m, params, net.E, net.woff[l - 1], net.boff[l - 1],
                          act + aoff[l - 1], a_cs, dbuf + (long long)(side ^ 1) * RP * maxd,
                          d_cs, rows, m, q, C, st);
        if (err != cudaSuccess) return (int)err;
        side ^= 1;
      }
    }
  }
  if (!grad) return 0;
  const int threads = 128;
  const long long total = (long long)C * net.E;
  mlp_finish<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      partial, grad_out, S, total);
  return (int)cudaGetLastError();
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

// The GEMM-shaped entry (the wrapper takes it past MLP_BLOCK_PARAMS
// parameters a fit): act, dbuf as run_gemm_entry's; gradient mode writes grad f32[C,
// E] through partial f64[S, C, E], forward mode z and prob f32[C, n, k].
extern "C" int mlp_grad_gemm(const void* X, const void* y, const void* w, const void* fold,
                             const void* wsum, const void* params, void* act, void* dbuf,
                             void* partial, void* grad, int n, int C, int RP, int S, int L,
                             const int* dims, void* stream) {
  Net net;
  if (n <= 0 || C <= 0 || C > 65535 || RP <= 0 || S <= 0 || (long long)C * S > 65535 ||
      !make_net(L, dims, &net))
    return (int)cudaErrorInvalidValue;
  return run_gemm_entry(true, (const float*)X, (const float*)y, (const float*)w,
                        (const int32_t*)fold, (const float*)wsum, (const float*)params,
                        (float*)act, (float*)dbuf, (double*)partial, (float*)grad, nullptr,
                        nullptr, n, C, RP, S, net, (cudaStream_t)stream);
}

extern "C" int mlp_forward_gemm(const void* X, const void* params, void* act, void* z,
                                void* prob, int n, int C, int RP, int L, const int* dims,
                                void* stream) {
  Net net;
  if (n <= 0 || C <= 0 || C > 65535 || RP <= 0 || !make_net(L, dims, &net))
    return (int)cudaErrorInvalidValue;
  return run_gemm_entry(false, (const float*)X, nullptr, nullptr, nullptr, nullptr,
                        (const float*)params, (float*)act, (float*)act, nullptr, nullptr,
                        (float*)z, (float*)prob, n, C, RP, 1, net, (cudaStream_t)stream);
}
