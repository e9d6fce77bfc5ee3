// K-AB lda: the online variational-Bayes LDA steps, in three modes.
//
// Replaces: transmogrifai_tpu/impl/feature/embeddings.py::_lda_e_step (:160;
// jitted at :181 for OpLDAModel.transform_columns, :235) and the M-step of
// OpLDA.fit_columns's em program (:204-215).  With lambda f32[k, v], the
// count matrix X [n, v] and the documents' gamma [n, k]:
//   beta:   exp_beta = exp(digamma(lambda) - digamma(sum_w lambda))   [k, v]
//   estep:  gamma = 1; n_iter times:
//             exp_theta = exp(digamma(gamma) - digamma(sum_t gamma))
//             phi_norm  = exp_theta @ exp_beta                        [n, v]
//             gamma     = alpha + exp_theta * ((X / phi_norm) @ exp_beta^T)
//   sstats: lambda' = eta + exp_beta * (exp_theta^T (X / phi_norm)) with
//             exp_theta, phi_norm from the final gamma.
// The JAX package forms the dense [n, v] products (O(n v k) an iteration).
// Only nonzero counts contribute to X / phi_norm, so the kernels walk each
// document's nonzero (term, count) list (CSR, built once a fit or a score):
// O(nnz k) an iteration.
//
// digamma: chlo.digamma's Lanczos form (g = 7, nine coefficients, Euler's
// reflection below 0.5) in float32, every operation rounded once (the _rn
// intrinsics keep nvcc from contracting), with libdevice's log1pf, cosf,
// sinf: the sequence of ops/embeddings.py::digamma, the lowering of
// jax.scipy.special.digamma.
//
// The zero phi_norm: the reference adds 1e-100 (0 in float32), so where
// exp_theta @ exp_beta underflows to 0 for ANY term, its dense X / phi_norm
// is 0/0 or x/0 and the document's gamma turns NaN.  A sparse walk never
// sees the terms the document lacks, so each iteration bounds phi_norm from
// below: phi_w >= max_t exp_theta_t exp_beta_tw >= min_t exp_theta_t *
// min_w max_t exp_beta_tw (the second factor once a launch); only if that
// product rounds to 0 does the warp compute phi_w for every term and look
// for a zero.  A document found so gets gamma NaN, as the dense form does.
//
// estep: a warp a document, 8 a block; exp_beta staged in shared memory as
// [v][k] (k v floats: 20 KB at 10 x 512), gamma in registers (each lane a
// copy of the k values), lane t < k computes topic t's digamma and the warp
// shares them by shuffles.  A lane takes the document's nonzeros lane,
// lane + 32, ...: phi (k FMAs from shared memory), x / phi, and k partial
// sums, reduced by xor butterflies (every lane the same total).  One launch
// for all n_iter iterations.
// sstats: (1) a warp a document forms exp_theta and marks the terms where
// its phi_norm is 0 (the dense X / phi_norm column is NaN there); (2) a block per 512 documents, a thread per term, sums
// exp_theta_dt x_dw / phi_dw over the block's nonzeros of that term in
// document order (the nonzeros grouped by (block, term) by a stable sort)
// into a partial [k, v]; (3) a thread per (t, w) sums the blocks' partials
// in block order and writes eta + exp_beta * sum (NaN in a marked term's
// column, and everywhere if a document's gamma was NaN, as the dense
// product makes them).  No atomics.
//
// Bound on the card: the estep by operations (about 2 k FMAs, a division
// and k more FMAs a nonzero an iteration, plus 2 k digammas a document an
// iteration); sstats by the nonzeros' reads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

// the Lanczos coefficients (676.5203681218851, -1259.1392167224028,
// 771.3234287776531, -176.6150291621406, 12.507343278686905,
// -0.13857109526572012, 9.984369578019572e-6, 1.5056327351493116e-7) as the
// float32 values torch.tensor(c, dtype=float32) gives, written exactly
__constant__ float kLanczos[8] = {0x1.52429cp+9f,  -0x1.3ac8e8p+10f, 0x1.81a966p+9f,
                                  -0x1.613ae6p+7f, 0x1.903c28p+3f,   -0x1.1bcb2ap-3f,
                                  0x1.4f0514p-17f, 0x1.435508p-23f};

__device__ float digammaf_lanczos(float x) {
  const float kBase = 1.0f;                    // 0.99999999999980993 in float32
  const float kGammaHalf = 7.5f;
  const float kLogGammaHalf = 0x1.01e858p+1f;  // log(7.5) in float32
  const float kPi = 0x1.921fb6p+1f;            // pi in float32
  const bool reflect = x < 0.5f;
  const float z = reflect ? -x : __fsub_rn(x, 1.0f);
  float a = kBase, b = 0.0f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float dz = __fadd_rn(z, (float)(i + 1));
    b = __fsub_rn(b, __fdiv_rn(kLanczos[i], __fmul_rn(dz, dz)));
    a = __fadd_rn(a, __fdiv_rn(kLanczos[i], dz));
  }
  const float t = __fadd_rn(kGammaHalf, z);
  const float log_t = __fadd_rn(kLogGammaHalf, log1pf(__fdiv_rn(z, kGammaHalf)));
  float out = __fsub_rn(__fadd_rn(log_t, __fdiv_rn(b, a)), __fdiv_rn(7.0f, t));
  if (reflect) {
    const float r = __fadd_rn(x, fabsf(floorf(__fadd_rn(x, 0.5f))));
    const float pr = __fmul_rn(kPi, r);
    out = __fsub_rn(out, __fdiv_rn(__fmul_rn(kPi, cosf(pr)), sinf(pr)));
  }
  if (x <= 0.0f && x == floorf(x)) out = __int_as_float(0x7fc00000);
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// beta: a block a topic
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
lda_beta_kernel(const float* __restrict__ lam, float* __restrict__ out, int v) {
  __shared__ float red[kThreads];
  const int t = blockIdx.x;
  const float* row = lam + (long long)t * v;
  float s = 0.0f;
  for (int w = threadIdx.x; w < v; w += kThreads) s = __fadd_rn(s, row[w]);
  red[threadIdx.x] = s;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  const float dsum = digammaf_lanczos(red[0]);
  for (int w = threadIdx.x; w < v; w += kThreads)
    out[(long long)t * v + w] = expf(__fsub_rn(digammaf_lanczos(row[w]), dsum));
}

// ---------------------------------------------------------------------------
// shared: exp_beta staged as [v][k], and min_w max_t exp_beta
// ---------------------------------------------------------------------------
__device__ float stage_beta(const float* __restrict__ exp_beta, float* eb, int k, int v,
                            float* red) {
  float cmin = INFINITY;
  for (int w = threadIdx.x; w < v; w += blockDim.x) {
    float mx = 0.0f;
    for (int t = 0; t < k; ++t) {
      const float e = exp_beta[(long long)t * v + w];
      eb[w * k + t] = e;
      mx = fmaxf(mx, e);
    }
    cmin = fminf(cmin, mx);
  }
  red[threadIdx.x] = cmin;
  __syncthreads();
  for (int h = blockDim.x / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] = fminf(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  const float out = red[0];
  __syncthreads();
  return out;
}

// exp_theta of a document from its gamma (every lane holds all k values):
// lane t < k takes topic t's digamma, the warp shares them
template <int KM>
__device__ __forceinline__ void exp_theta_of(const float (&gamma)[KM], int k, int lane,
                                             float (&et)[KM]) {
  float gsum = gamma[0];
#pragma unroll
  for (int t = 1; t < KM; ++t)
    if (t < k) gsum = __fadd_rn(gsum, gamma[t]);
  const float dsum = digammaf_lanczos(gsum);
  float mine = 0.0f;
#pragma unroll
  for (int t = 0; t < KM; ++t)
    if (t == lane) mine = gamma[t];
  const float e = lane < k ? expf(__fsub_rn(digammaf_lanczos(mine), dsum)) : 0.0f;
#pragma unroll
  for (int t = 0; t < KM; ++t) et[t] = __shfl_sync(0xffffffffu, e, t);
}

// phi_w = sum_t exp_theta_t exp_beta_tw in topic order (ebw: a term's k
// values in shared memory, or a register copy)
template <int KM, typename B>
__device__ __forceinline__ float phi_of(const float (&et)[KM], const B& ebw, int k) {
  float phi = __fmul_rn(et[0], ebw[0]);
#pragma unroll
  for (int t = 1; t < KM; ++t)
    if (t < k) phi = __fadd_rn(phi, __fmul_rn(et[t], ebw[t]));
  return phi;
}

// whether phi_norm is 0 for some term: the bound first, then every term
template <int KM>
__device__ bool zero_phi(const float (&et)[KM], int k, int v, const float* eb, float cmin,
                         int lane) {
  float etmin = et[0];
#pragma unroll
  for (int t = 1; t < KM; ++t)
    if (t < k) etmin = fminf(etmin, et[t]);
  if (__fmul_rn(etmin, cmin) > 0.0f) return false;
  bool zero = false;
  for (int w = lane; w < v; w += 32) {
    const float* ebw = eb + w * k;
    zero |= phi_of<KM>(et, ebw, k) == 0.0f;
  }
  return __any_sync(0xffffffffu, zero);
}

// ---------------------------------------------------------------------------
// estep: a warp a document, every iteration in one launch
// ---------------------------------------------------------------------------
template <int KM>
__global__ void __launch_bounds__(kThreads)
lda_estep_kernel(const float* __restrict__ exp_beta, const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ terms, const float* __restrict__ counts,
                 float* __restrict__ gamma_out, int n, int k, int v, int n_iter, float alpha) {
  extern __shared__ float eb[];
  __shared__ float red[kThreads];
  const float cmin = stage_beta(exp_beta, eb, k, v, red);
  const int lane = threadIdx.x % 32;
  for (int d = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32; d < n;
       d += gridDim.x * kWarpsPerBlock) {
    const int lo = offsets[d], hi = offsets[d + 1];
    float gamma[KM], et[KM], s[KM];
#pragma unroll
    for (int t = 0; t < KM; ++t) gamma[t] = 1.0f;
    bool dead = false;
    for (int it = 0; it < n_iter && !dead; ++it) {
      exp_theta_of<KM>(gamma, k, lane, et);
      if (zero_phi<KM>(et, k, v, eb, cmin, lane)) {
        dead = true;
        break;
      }
#pragma unroll
      for (int t = 0; t < KM; ++t) s[t] = 0.0f;
      for (int e = lo + lane; e < hi; e += 32) {
        const float* ebw = eb + terms[e] * k;
        const float ratio = __fdiv_rn(counts[e], phi_of<KM>(et, ebw, k));
#pragma unroll
        for (int t = 0; t < KM; ++t)
          if (t < k) s[t] = __fadd_rn(s[t], __fmul_rn(ratio, ebw[t]));
      }
#pragma unroll
      for (int t = 0; t < KM; ++t)
        if (t < k) gamma[t] = __fadd_rn(alpha, __fmul_rn(et[t], warp_sum(s[t])));
    }
#pragma unroll
    for (int t = 0; t < KM; ++t)
      if (t == lane && t < k)
        gamma_out[(long long)d * k + t] = dead ? __int_as_float(0x7fc00000) : gamma[t];
  }
}

// ---------------------------------------------------------------------------
// sstats: exp_theta, block partials by term, the merge
// ---------------------------------------------------------------------------
template <int KM>
__global__ void __launch_bounds__(kThreads)
lda_theta_kernel(const float* __restrict__ exp_beta, const float* __restrict__ gamma_in,
                 float* __restrict__ exp_theta, int32_t* __restrict__ zero_col, int n, int k,
                 int v) {
  extern __shared__ float eb[];
  __shared__ float red[kThreads];
  const float cmin = stage_beta(exp_beta, eb, k, v, red);
  const int lane = threadIdx.x % 32;
  for (int d = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32; d < n;
       d += gridDim.x * kWarpsPerBlock) {
    float gamma[KM], et[KM];
#pragma unroll
    for (int t = 0; t < KM; ++t) gamma[t] = t < k ? gamma_in[(long long)d * k + t] : 0.0f;
    exp_theta_of<KM>(gamma, k, lane, et);
    float etmin = et[0];
#pragma unroll
    for (int t = 1; t < KM; ++t)
      if (t < k) etmin = fminf(etmin, et[t]);
    // a zero phi_norm makes the dense X / phi_norm column NaN: mark it (a
    // plain store of the same value from any thread that finds it)
    if (!(__fmul_rn(etmin, cmin) > 0.0f))
      for (int w = lane; w < v; w += 32) {
        const float* ebw = eb + w * k;
        if (phi_of<KM>(et, ebw, k) == 0.0f) zero_col[w] = 1;
      }
#pragma unroll
    for (int t = 0; t < KM; ++t)
      if (t == lane && t < k) exp_theta[(long long)d * k + t] = et[t];
  }
}

template <int KM>
__global__ void __launch_bounds__(kThreads)
lda_partial_kernel(const float* __restrict__ exp_beta, const float* __restrict__ exp_theta,
                   const float* __restrict__ counts, const int32_t* __restrict__ key_off,
                   const int32_t* __restrict__ entry_doc, const int32_t* __restrict__ entry_pos,
                   float* __restrict__ partial, int32_t* __restrict__ flags, int n, int k, int v,
                   int docs_per_block) {
  const int b = blockIdx.x;
  int dead = 0;
  const int d0 = b * docs_per_block, d1 = min(n, d0 + docs_per_block);
  for (int d = d0 + threadIdx.x; d < d1; d += kThreads) dead |= isnan(exp_theta[(long long)d * k]);
  dead = __syncthreads_or(dead);
  if (threadIdx.x == 0) flags[b] = dead;
  for (int w = threadIdx.x; w < v; w += kThreads) {
    float ebw[KM], acc[KM], et[KM];
#pragma unroll
    for (int t = 0; t < KM; ++t) {
      ebw[t] = t < k ? exp_beta[(long long)t * v + w] : 0.0f;
      acc[t] = 0.0f;
    }
    const int e0 = key_off[(long long)b * v + w], e1 = key_off[(long long)b * v + w + 1];
    for (int e = e0; e < e1; ++e) {
      const float* etd = exp_theta + (long long)entry_doc[e] * k;
#pragma unroll
      for (int t = 0; t < KM; ++t) et[t] = t < k ? etd[t] : 0.0f;
      const float ratio = __fdiv_rn(counts[entry_pos[e]], phi_of<KM>(et, ebw, k));
#pragma unroll
      for (int t = 0; t < KM; ++t)
        if (t < k) acc[t] = __fadd_rn(acc[t], __fmul_rn(et[t], ratio));
    }
#pragma unroll
    for (int t = 0; t < KM; ++t)
      if (t < k) partial[((long long)b * k + t) * v + w] = acc[t];
  }
}

__global__ void lda_merge_kernel(const float* __restrict__ exp_beta,
                                 const float* __restrict__ partial,
                                 const int32_t* __restrict__ flags,
                                 const int32_t* __restrict__ zero_col, float* __restrict__ out,
                                 int k, int v, int blocks, float eta) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= k * v) return;
  int dead = zero_col[i % v];
  float s = 0.0f;
  for (int b = 0; b < blocks; ++b) {
    dead |= flags[b];
    s = __fadd_rn(s, partial[(long long)b * k * v + i]);
  }
  out[i] = dead ? __int_as_float(0x7fc00000) : __fadd_rn(eta, __fmul_rn(exp_beta[i], s));
}

constexpr int kDocBlocks = 2 * 132 * 4;   // estep / theta blocks (grid-stride over documents)

template <typename Kernel>
int smem_attr(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

template <int KM>
int launch_estep(const void* exp_beta, const void* offsets, const void* terms,
                 const void* counts, void* gamma, int n, int k, int v, int n_iter, float alpha,
                 cudaStream_t st) {
  const size_t bytes = (size_t)k * v * sizeof(float);
  int err = smem_attr(lda_estep_kernel<KM>, bytes);
  if (err != 0) return err;
  const int blocks = min(kDocBlocks, (n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lda_estep_kernel<KM><<<blocks, kThreads, bytes, st>>>(
      (const float*)exp_beta, (const int32_t*)offsets, (const int32_t*)terms,
      (const float*)counts, (float*)gamma, n, k, v, n_iter, alpha);
  return (int)cudaGetLastError();
}

template <int KM>
int launch_sstats(const void* exp_beta, const void* gamma, const void* counts,
                  const void* key_off, const void* entry_doc, const void* entry_pos,
                  void* exp_theta, void* partial, void* flags, void* zero_col, void* out, int n,
                  int k, int v, int blocks, int docs_per_block, float eta, cudaStream_t st) {
  const size_t bytes = (size_t)k * v * sizeof(float);
  int err = smem_attr(lda_theta_kernel<KM>, bytes);
  if (err != 0) return err;
  const int tblocks = min(kDocBlocks, (n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  lda_theta_kernel<KM><<<tblocks, kThreads, bytes, st>>>(
      (const float*)exp_beta, (const float*)gamma, (float*)exp_theta, (int32_t*)zero_col, n, k,
      v);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  lda_partial_kernel<KM><<<blocks, kThreads, 0, st>>>(
      (const float*)exp_beta, (const float*)exp_theta, (const float*)counts,
      (const int32_t*)key_off, (const int32_t*)entry_doc, (const int32_t*)entry_pos,
      (float*)partial, (int32_t*)flags, n, k, v, docs_per_block);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  lda_merge_kernel<<<(k * v + 127) / 128, 128, 0, st>>>(
      (const float*)exp_beta, (const float*)partial, (const int32_t*)flags,
      (const int32_t*)zero_col, (float*)out, k, v, blocks, eta);
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int k, int v) {
  return n <= 0 || k <= 0 || k > 32 || v <= 0 || (long long)k * v > 51200;
}

}  // namespace

extern "C" int lda_beta(const void* lam, void* out, int k, int v, void* stream) {
  if (k <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  lda_beta_kernel<<<k, kThreads, 0, (cudaStream_t)stream>>>((const float*)lam, (float*)out, v);
  return (int)cudaGetLastError();
}

extern "C" int lda_estep(const void* exp_beta, const void* offsets, const void* terms,
                         const void* counts, void* gamma, int n, int k, int v, int n_iter,
                         float alpha, void* stream) {
  if (bad_shape(n, k, v) || n_iter < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16)
    return launch_estep<16>(exp_beta, offsets, terms, counts, gamma, n, k, v, n_iter, alpha, st);
  return launch_estep<32>(exp_beta, offsets, terms, counts, gamma, n, k, v, n_iter, alpha, st);
}

extern "C" int lda_sstats(const void* exp_beta, const void* gamma, const void* counts,
                          const void* key_off, const void* entry_doc, const void* entry_pos,
                          void* exp_theta, void* partial, void* flags, void* zero_col, void* out,
                          int n, int k, int v, int blocks, int docs_per_block, float eta,
                          void* stream) {
  if (bad_shape(n, k, v) || blocks <= 0 || docs_per_block <= 0 ||
      (long long)blocks * docs_per_block < n)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 16)
    return launch_sstats<16>(exp_beta, gamma, counts, key_off, entry_doc, entry_pos, exp_theta,
                             partial, flags, zero_col, out, n, k, v, blocks, docs_per_block, eta,
                             st);
  return launch_sstats<32>(exp_beta, gamma, counts, key_off, entry_doc, entry_pos, exp_theta,
                           partial, flags, zero_col, out, n, k, v, blocks, docs_per_block, eta,
                             st);
}
