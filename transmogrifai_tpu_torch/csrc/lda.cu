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
// exp_beta's layout: every mode but beta reads it as [v][k] (a term's k
// values side by side): a prologue (lda_prep) writes that copy to device
// memory, where L2 serves it, and min_w max_t exp_beta beside it, so
// exp_beta is bounded by the card's memory alone.  (Staging it whole in
// shared memory, as the first design did up to 51,200 entries, timed the
// same: 5.97 against 6.01 ms at 10 topics over 512 terms, 2^17 documents,
// tools/kernel_turns.py on an NVIDIA H100 80GB HBM3 at 700 W.)
//
// estep to 16 topics (the narrow entry): a warp a document, 8 a block, gamma
// in registers (each lane a copy of the k values), lane t < k computes topic
// t's digamma and the warp shares them by shuffles.  A lane takes the
// document's nonzeros lane, lane + 32, ...: phi (k FMAs), x / phi, and k
// partial sums, reduced by xor butterflies (every lane the same total).
// estep past 16 topics (to 256): a warp a document with the topics across
// the lanes (topic lane + 32 i, TPL = 1, 2, 4 or 8 a lane): gamma, exp_theta
// and the k sums in registers, the nonzeros in document order, each one's
// phi a butterfly of the lanes' partials (on the H100 above, 4.3x faster
// than the narrow entry at 32 topics, 1.3x slower at 10).  One launch for
// all n_iter iterations in both.
// sstats: (1) lda_ratio, a warp a document (topics across the lanes):
// exp_theta, and x / phi_norm of each nonzero; it marks the terms where the
// document's phi_norm is 0 (the dense X / phi_norm column is NaN there) and
// a NaN gamma; (2) lda_segments, a warp a segment of at most 128 of a term's
// nonzeros (the nonzeros grouped by term in document order: a stable sort
// once a fit): the sums exp_theta_dt x_dw / phi_dw over the segment in
// document order, topics across the lanes; (3) lda_merge, a thread per (t,
// w): the term's segments in order, eta + exp_beta * sum (NaN in a marked
// term's column, and everywhere after a NaN gamma, as the dense product
// makes them).  No atomics, no sort per call.
//
// Bound on the card: the estep by operations (about 2 k FMAs, a division
// and k more FMAs a nonzero an iteration, plus k + 1 digammas a document an
// iteration); sstats by the nonzeros' reads (a count, a term and k values
// of exp_theta each).
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
    const float* ebw = eb + (long long)w * k;
    zero |= phi_of<KM>(et, ebw, k) == 0.0f;
  }
  return __any_sync(0xffffffffu, zero);
}

// ---------------------------------------------------------------------------
// estep to 16 topics: a warp a document, every iteration in one launch
// ---------------------------------------------------------------------------
template <int KM>
__global__ void __launch_bounds__(kThreads)
lda_estep_kernel(const float* __restrict__ eb, const float* __restrict__ cminp,
                 const int32_t* __restrict__ offsets, const int32_t* __restrict__ terms,
                 const float* __restrict__ counts, float* __restrict__ gamma_out, int n, int k,
                 int v, int n_iter, float alpha) {
  const float cmin = cminp[0];
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
        const float* ebw = eb + (long long)terms[e] * k;
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
// the [v][k] copy of exp_beta in device memory, and min_w max_t exp_beta
// ---------------------------------------------------------------------------
__global__ void lda_prep_kernel(const float* __restrict__ exp_beta, float* __restrict__ ebT,
                                float* __restrict__ colmax, int k, int v) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= v) return;
  float mx = 0.0f;
  for (int t = 0; t < k; ++t) {
    const float e = exp_beta[(long long)t * v + w];
    ebT[(long long)w * k + t] = e;
    mx = fmaxf(mx, e);
  }
  colmax[w] = mx;
}

__global__ void __launch_bounds__(kThreads)
lda_cmin_kernel(const float* __restrict__ colmax, float* __restrict__ cmin, int v) {
  __shared__ float red[kThreads];
  float m = INFINITY;
  for (int w = threadIdx.x; w < v; w += kThreads) m = fminf(m, colmax[w]);
  red[threadIdx.x] = m;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] = fminf(red[threadIdx.x], red[threadIdx.x + h]);
    __syncthreads();
  }
  if (threadIdx.x == 0) cmin[0] = red[0];
}

// ---------------------------------------------------------------------------
// topics across the lanes (TPL a lane: topic lane + 32 i), past 32 topics in
// the estep and at every k in sstats
// ---------------------------------------------------------------------------
template <int TPL>
__device__ __forceinline__ void exp_theta_lanes(const float (&g)[TPL], int k, int lane,
                                                float (&et)[TPL]) {
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < TPL; ++i)
    if (lane + 32 * i < k) part = i == 0 ? g[0] : __fadd_rn(part, g[i]);
  const float dsum = digammaf_lanczos(warp_sum(part));
#pragma unroll
  for (int i = 0; i < TPL; ++i)
    et[i] = lane + 32 * i < k ? expf(__fsub_rn(digammaf_lanczos(g[i]), dsum)) : 0.0f;
}

// a term's k values of the [v][k] copy, and phi_w (the lanes' partials in
// topic order, then the butterfly: every lane the same value)
template <int TPL>
__device__ __forceinline__ float phi_lanes(const float (&et)[TPL], const float* __restrict__ ebw,
                                           int k, int lane, float (&eb)[TPL]) {
  float part = 0.0f;
#pragma unroll
  for (int i = 0; i < TPL; ++i) {
    const int t = lane + 32 * i;
    eb[i] = t < k ? ebw[t] : 0.0f;
    part = i == 0 ? __fmul_rn(et[0], eb[0]) : __fadd_rn(part, __fmul_rn(et[i], eb[i]));
  }
  return warp_sum(part);
}

template <int TPL>
__device__ __forceinline__ float min_lanes(const float (&et)[TPL], int k, int lane) {
  float m = INFINITY;
#pragma unroll
  for (int i = 0; i < TPL; ++i)
    if (lane + 32 * i < k) m = fminf(m, et[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

template <int TPL>
__global__ void __launch_bounds__(kThreads)
lda_estep_wide(const float* __restrict__ ebT, const float* __restrict__ cminp,
               const int32_t* __restrict__ offsets, const int32_t* __restrict__ terms,
               const float* __restrict__ counts, float* __restrict__ gamma_out, int n, int k,
               int v, int n_iter, float alpha) {
  const float cmin = cminp[0];
  const int lane = threadIdx.x % 32;
  for (int d = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32; d < n;
       d += gridDim.x * kWarpsPerBlock) {
    const int lo = offsets[d], hi = offsets[d + 1];
    float g[TPL], et[TPL], s[TPL], eb[TPL];
#pragma unroll
    for (int i = 0; i < TPL; ++i) g[i] = 1.0f;
    bool dead = false;
    for (int it = 0; it < n_iter && !dead; ++it) {
      exp_theta_lanes<TPL>(g, k, lane, et);
      if (!(__fmul_rn(min_lanes<TPL>(et, k, lane), cmin) > 0.0f)) {
        for (int w = 0; w < v && !dead; ++w)
          dead = phi_lanes<TPL>(et, ebT + (long long)w * k, k, lane, eb) == 0.0f;
        if (dead) break;
      }
#pragma unroll
      for (int i = 0; i < TPL; ++i) s[i] = 0.0f;
      for (int e = lo; e < hi; ++e) {
        const float phi = phi_lanes<TPL>(et, ebT + (long long)terms[e] * k, k, lane, eb);
        const float ratio = __fdiv_rn(counts[e], phi);
#pragma unroll
        for (int i = 0; i < TPL; ++i) s[i] = __fadd_rn(s[i], __fmul_rn(ratio, eb[i]));
      }
#pragma unroll
      for (int i = 0; i < TPL; ++i) g[i] = __fadd_rn(alpha, __fmul_rn(et[i], s[i]));
    }
#pragma unroll
    for (int i = 0; i < TPL; ++i)
      if (lane + 32 * i < k)
        gamma_out[(long long)d * k + lane + 32 * i] = dead ? __int_as_float(0x7fc00000) : g[i];
  }
}

// ---------------------------------------------------------------------------
// sstats: (1) exp_theta and each nonzero's x / phi, (2) the term segments'
// sums, (3) the merge
// ---------------------------------------------------------------------------
template <int TPL>
__global__ void __launch_bounds__(kThreads)
lda_ratio_kernel(const float* __restrict__ ebT, const float* __restrict__ cminp,
                 const float* __restrict__ gamma_in, const int32_t* __restrict__ offsets,
                 const int32_t* __restrict__ terms, const float* __restrict__ counts,
                 float* __restrict__ exp_theta, float* __restrict__ ratio,
                 int32_t* __restrict__ dead, int32_t* __restrict__ zero_col, int n, int k,
                 int v) {
  const float cmin = cminp[0];
  const int lane = threadIdx.x % 32;
  for (int d = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32; d < n;
       d += gridDim.x * kWarpsPerBlock) {
    float g[TPL], et[TPL], eb[TPL];
#pragma unroll
    for (int i = 0; i < TPL; ++i) {
      const int t = lane + 32 * i;
      g[i] = t < k ? gamma_in[(long long)d * k + t] : 0.0f;
    }
    exp_theta_lanes<TPL>(g, k, lane, et);
#pragma unroll
    for (int i = 0; i < TPL; ++i)
      if (lane + 32 * i < k) exp_theta[(long long)d * k + lane + 32 * i] = et[i];
    // a NaN gamma makes every exp_theta of the document NaN, and the dense
    // product NaN everywhere; a zero phi_norm makes the term's column NaN
    // (plain stores of one value from any warp that finds it)
    if (lane == 0 && isnan(et[0])) dead[0] = 1;
    if (!(__fmul_rn(min_lanes<TPL>(et, k, lane), cmin) > 0.0f))
      for (int w = 0; w < v; ++w)
        if (phi_lanes<TPL>(et, ebT + (long long)w * k, k, lane, eb) == 0.0f && lane == 0)
          zero_col[w] = 1;
    const int lo = offsets[d], hi = offsets[d + 1];
    for (int e = lo; e < hi; ++e) {
      const float phi = phi_lanes<TPL>(et, ebT + (long long)terms[e] * k, k, lane, eb);
      if (lane == 0) ratio[e] = __fdiv_rn(counts[e], phi);
    }
  }
}

template <int TPL>
__global__ void __launch_bounds__(kThreads)
lda_segments(const float* __restrict__ exp_theta, const float* __restrict__ ratio,
             const int32_t* __restrict__ col_entry, const int32_t* __restrict__ col_doc,
             const int32_t* __restrict__ seg_lo, const int32_t* __restrict__ seg_hi,
             float* __restrict__ partial, int S, int k) {
  const int seg = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= S) return;
  const int lo = seg_lo[seg], hi = seg_hi[seg];
  float acc[TPL];
#pragma unroll
  for (int i = 0; i < TPL; ++i) acc[i] = 0.0f;
  constexpr int kAhead = 4;   // entries whose loads are issued together
  for (int e0 = lo; e0 < hi; e0 += kAhead) {
    float et[kAhead][TPL], r[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int e = e0 + u;
      const bool in = e < hi;
      const long long doc = in ? col_doc[e] : 0;
      r[u] = in ? ratio[col_entry[e]] : 0.0f;
#pragma unroll
      for (int i = 0; i < TPL; ++i) {
        const int t = lane + 32 * i;
        et[u][i] = (in && t < k) ? exp_theta[doc * k + t] : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (e0 + u < hi)
#pragma unroll
        for (int i = 0; i < TPL; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(et[u][i], r[u]));
  }
#pragma unroll
  for (int i = 0; i < TPL; ++i)
    if (lane + 32 * i < k) partial[(long long)seg * k + lane + 32 * i] = acc[i];
}

__global__ void lda_merge_kernel(const float* __restrict__ exp_beta,
                                 const float* __restrict__ partial,
                                 const int32_t* __restrict__ term_seg,
                                 const int32_t* __restrict__ dead,
                                 const int32_t* __restrict__ zero_col, float* __restrict__ out,
                                 int k, int v, float eta) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)k * v) return;
  const int t = (int)(i / v), w = (int)(i % v);
  float s = 0.0f;
  for (int g = term_seg[w]; g < term_seg[w + 1]; ++g)
    s = __fadd_rn(s, partial[(long long)g * k + t]);
  out[i] = (dead[0] | zero_col[w]) ? __int_as_float(0x7fc00000)
                                    : __fadd_rn(eta, __fmul_rn(exp_beta[i], s));
}

constexpr int kDocBlocks = 2 * 132 * 4;   // estep / ratio blocks (grid-stride over documents)
constexpr int kMaxTopics = 256;
// The estep's narrow entry (topics in every lane) takes up to this many
// topics.  Built with -DLDA_NARROW_TOPICS=0 the topics across the lanes take
// every k (tools/kernel_turns.py times that build as the narrow entry's
// rival).
#ifndef LDA_NARROW_TOPICS
#define LDA_NARROW_TOPICS 16
#endif
constexpr int kNarrowTopics = LDA_NARROW_TOPICS;
static_assert(kNarrowTopics <= 16, "lda_estep_kernel<16> holds at most 16 topics a lane");

int doc_blocks(int n) { return min(kDocBlocks, (n + kWarpsPerBlock - 1) / kWarpsPerBlock); }

int prep(const void* exp_beta, void* ebT, void* colmax, void* cmin, int k, int v,
         cudaStream_t st) {
  lda_prep_kernel<<<(v + 127) / 128, 128, 0, st>>>((const float*)exp_beta, (float*)ebT,
                                                   (float*)colmax, k, v);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  lda_cmin_kernel<<<1, kThreads, 0, st>>>((const float*)colmax, (float*)cmin, v);
  return (int)cudaGetLastError();
}

int launch_estep(const void* ebT, const void* cmin, const void* offsets, const void* terms,
                 const void* counts, void* gamma, int n, int k, int v, int n_iter, float alpha,
                 cudaStream_t st) {
  lda_estep_kernel<16><<<doc_blocks(n), kThreads, 0, st>>>(
      (const float*)ebT, (const float*)cmin, (const int32_t*)offsets, (const int32_t*)terms,
      (const float*)counts, (float*)gamma, n, k, v, n_iter, alpha);
  return (int)cudaGetLastError();
}

template <int TPL>
int launch_estep_wide(const void* ebT, const void* cmin, const void* offsets, const void* terms,
                      const void* counts, void* gamma, int n, int k, int v, int n_iter,
                      float alpha, cudaStream_t st) {
  lda_estep_wide<TPL><<<doc_blocks(n), kThreads, 0, st>>>(
      (const float*)ebT, (const float*)cmin, (const int32_t*)offsets, (const int32_t*)terms,
      (const float*)counts, (float*)gamma, n, k, v, n_iter, alpha);
  return (int)cudaGetLastError();
}

template <int TPL>
int launch_sstats(const void* exp_beta, const void* gamma, const void* offsets,
                  const void* terms, const void* counts, const void* col_entry,
                  const void* col_doc, const void* seg_lo, const void* seg_hi,
                  const void* term_seg, const void* ebT, const void* cmin, void* exp_theta,
                  void* ratio, void* partial, void* dead, void* zero_col, void* out, int n,
                  int k, int v, int S, float eta, cudaStream_t st) {
  lda_ratio_kernel<TPL><<<doc_blocks(n), kThreads, 0, st>>>(
      (const float*)ebT, (const float*)cmin, (const float*)gamma, (const int32_t*)offsets,
      (const int32_t*)terms, (const float*)counts, (float*)exp_theta, (float*)ratio,
      (int32_t*)dead, (int32_t*)zero_col, n, k, v);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  if (S > 0) {
    lda_segments<TPL><<<(S + kWarpsPerBlock - 1) / kWarpsPerBlock, kThreads, 0, st>>>(
        (const float*)exp_theta, (const float*)ratio, (const int32_t*)col_entry,
        (const int32_t*)col_doc, (const int32_t*)seg_lo, (const int32_t*)seg_hi,
        (float*)partial, S, k);
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  const long long kv = (long long)k * v;
  lda_merge_kernel<<<(unsigned)((kv + 127) / 128), 128, 0, st>>>(
      (const float*)exp_beta, (const float*)partial, (const int32_t*)term_seg,
      (const int32_t*)dead, (const int32_t*)zero_col, (float*)out, k, v, eta);
  return (int)cudaGetLastError();
}

bool bad_shape(int n, int k, int v) { return n <= 0 || k <= 0 || k > kMaxTopics || v <= 0; }

}  // namespace

extern "C" int lda_beta(const void* lam, void* out, int k, int v, void* stream) {
  if (k <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  lda_beta_kernel<<<k, kThreads, 0, (cudaStream_t)stream>>>((const float*)lam, (float*)out, v);
  return (int)cudaGetLastError();
}

// ebT f32[v, k], colmax f32[v], cmin f32[1]: scratch of the [v][k] copy.
// The narrow entry to kNarrowTopics topics, the topics across the lanes above.
extern "C" int lda_estep(const void* exp_beta, void* ebT, void* colmax, void* cmin,
                         const void* offsets, const void* terms, const void* counts,
                         void* gamma, int n, int k, int v, int n_iter, float alpha,
                         void* stream) {
  if (bad_shape(n, k, v) || n_iter < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = prep(exp_beta, ebT, colmax, cmin, k, v, st);
  if (err != 0) return err;
  if (k <= kNarrowTopics)
    return launch_estep(ebT, cmin, offsets, terms, counts, gamma, n, k, v, n_iter, alpha, st);
  if (k <= 32)
    return launch_estep_wide<1>(ebT, cmin, offsets, terms, counts, gamma, n, k, v, n_iter,
                                alpha, st);
  if (k <= 64)
    return launch_estep_wide<2>(ebT, cmin, offsets, terms, counts, gamma, n, k, v, n_iter,
                                alpha, st);
  if (k <= 128)
    return launch_estep_wide<4>(ebT, cmin, offsets, terms, counts, gamma, n, k, v, n_iter,
                                alpha, st);
  return launch_estep_wide<8>(ebT, cmin, offsets, terms, counts, gamma, n, k, v, n_iter, alpha,
                              st);
}

// The nonzeros by term: col_entry / col_doc i32[nnz] (each entry's CSR
// position and document), segments seg_lo / seg_hi i32[S] of at most 128,
// term_seg i32[v + 1]; scratch: ebT f32[v, k], colmax f32[v], cmin f32[1],
// exp_theta f32[n, k], ratio f32[nnz], partial f32[S, k], dead i32[1] and
// zero_col i32[v] (both zeroed by the caller).
extern "C" int lda_sstats(const void* exp_beta, const void* gamma, const void* offsets,
                          const void* terms, const void* counts, const void* col_entry,
                          const void* col_doc, const void* seg_lo, const void* seg_hi,
                          const void* term_seg, void* ebT, void* colmax, void* cmin,
                          void* exp_theta, void* ratio, void* partial, void* dead,
                          void* zero_col, void* out, int n, int k, int v, int S, float eta,
                          void* stream) {
  if (bad_shape(n, k, v) || S < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err = prep(exp_beta, ebT, colmax, cmin, k, v, st);
  if (err != 0) return err;
#define LDA_SSTATS(TPL)                                                                      \
  launch_sstats<TPL>(exp_beta, gamma, offsets, terms, counts, col_entry, col_doc, seg_lo,    \
                     seg_hi, term_seg, ebT, cmin, exp_theta, ratio, partial, dead, zero_col, \
                     out, n, k, v, S, eta, st)
  if (k <= 32) return LDA_SSTATS(1);
  if (k <= 64) return LDA_SSTATS(2);
  if (k <= 128) return LDA_SSTATS(4);
  return LDA_SSTATS(8);
#undef LDA_SSTATS
}
