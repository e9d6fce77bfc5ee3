// K-AA sgns_epoch: one full-batch skip-gram negative-sampling epoch.
//
// Replaces: transmogrifai_tpu/impl/feature/embeddings.py::_sgns_epoch (:37),
// the body of the lax.scan in OpWord2Vec.fit_columns (:107-111).  For the
// input and output embeddings W, C f32[V, d], the pairs (c_p, o_p) and the
// negatives n_pk (k < K) of P pairs,
//   pos_p = W[c_p] . C[o_p],  neg_pk = W[c_p] . C[n_pk],
//   loss  = mean_p (softplus(-pos_p) + sum_k softplus(neg_pk)),
// and the update W - lr dW, C - lr dC at the old parameters, with the
// coefficients -sigmoid(-pos_p) / P (slot 0) and sigmoid(neg_pk) / P
// (slot k + 1):
//   dW[r] = sum_{p: c_p = r} (coef_p0 C[o_p] + sum_k coef_p,k+1 C[n_pk]),
//   dC[r] = sum_{(p, s): out(p, s) = r} coef_ps W[c_p].
// The JAX package gathers every pair's rows densely and scatters the
// autodiff gradients back.  Here the pairs and negatives are fixed for a fit,
// so the wrapper builds two index lists once (stable sorts): the pairs by
// centre word (rows 0..V-1, for dW) and the (pair, slot) entries by output
// word (rows V..2V-1, for dC), each row's list cut into segments of at most
// 128 entries, so that the Zipf head's long lists spread over many warps.
//
// Launch 1 (sgns_segments): a warp a segment.  A W segment loads its row of
// W once, and for each of its pairs (in pair order) the K + 1 rows of C, the
// scores (lanes hold d / 32 values each, a butterfly sum gives every lane the
// same total), the coefficients and the loss terms; it sums coef x row of C.
// A C segment loads its row of C once and for each entry the centre's row
// of W, the score of that slot and its coefficient; it sums coef x row of W.
// Each writes its partial gradient row (and a W segment its loss sum).
// Past 256 dimensions (sgns_segments_slab, up to 1,024) a row is cut into
// slabs of 256 values, eight a lane a slab (value lane + 32 i of the row as
// before, so every lane's sum runs over its values in the same order): the
// segment's own row and its gradient sum sit in the warp's shared memory,
// the partner row and the two gradient terms in registers, and each score
// loops over the slabs before the one butterfly.
// Launch 2 (sgns_apply): a warp a vocabulary row sums its segments'
// partials in order and writes row - lr * grad into the other buffer of a
// pair (W2, C2).  The loss is reduced only when asked (sgns_loss, one warp).
// No atomics: every sum has a fixed order, so runs repeat bit for bit.
// Sums are float32 in another order than XLA's scatter, so the parameters
// differ from the reference's in the last bits.
//
// Bound on the card: operations and L2.  Each pair costs 2 (K + 1) d FMAs
// in each launch-1 half (scores and gradient rows); the rows come from W and
// C (2 x V x d floats, 1 MB at V = 2,000, d = 64; 4.8 MB at d = 300), which
// stay in the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same (commutative) sums
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float sigmoidf(float x) {
  return __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-x)));
}

// jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|))
__device__ __forceinline__ float softplusf(float x) {
  return __fadd_rn(fmaxf(x, 0.0f), log1pf(expf(-fabsf(x))));
}

template <int VPL>
__device__ __forceinline__ void load_row(const float* __restrict__ M, int r, int d, int lane,
                                         float (&x)[VPL]) {
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = lane + 32 * i;
    x[i] = j < d ? M[(long long)r * d + j] : 0.0f;
  }
}

template <int VPL>
__device__ __forceinline__ float dot(const float (&a)[VPL], const float (&b)[VPL]) {
  float s = __fmul_rn(a[0], b[0]);
#pragma unroll
  for (int i = 1; i < VPL; ++i) s = __fadd_rn(s, __fmul_rn(a[i], b[i]));
  return warp_sum(s);
}

template <int VPL>
__global__ void __launch_bounds__(kThreads)
sgns_segments(const float* __restrict__ W, const float* __restrict__ C,
              const int32_t* __restrict__ pairs, const int32_t* __restrict__ negs,
              const int32_t* __restrict__ w_pairs, const int32_t* __restrict__ c_entries,
              const int32_t* __restrict__ seg_row, const int32_t* __restrict__ seg_lo,
              const int32_t* __restrict__ seg_hi, float* __restrict__ partial,
              float* __restrict__ loss_part, int V, int d, int P, int K, int S) {
  const int seg = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= S) return;
  const int row = seg_row[seg], lo = seg_lo[seg], hi = seg_hi[seg];
  const float Pf = (float)P;
  float acc[VPL], own[VPL], part[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) acc[i] = 0.0f;
  float loss = 0.0f;
  if (row < V) {
    load_row<VPL>(W, row, d, lane, own);   // every pair of the segment has centre row
    for (int e = lo; e < hi; ++e) {
      const int p = w_pairs[e];
      load_row<VPL>(C, pairs[2 * p + 1], d, lane, part);
      const float pos = dot<VPL>(own, part);
      const float cp = -__fdiv_rn(sigmoidf(-pos), Pf);
      float t[VPL], tn[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        t[i] = __fmul_rn(cp, part[i]);
        tn[i] = 0.0f;
      }
      float nloss = 0.0f;
      for (int k = 0; k < K; ++k) {
        load_row<VPL>(C, negs[(long long)p * K + k], d, lane, part);
        const float neg = dot<VPL>(own, part);
        const float cn = __fdiv_rn(sigmoidf(neg), Pf);
#pragma unroll
        for (int i = 0; i < VPL; ++i) tn[i] = __fadd_rn(tn[i], __fmul_rn(cn, part[i]));
        nloss = __fadd_rn(nloss, softplusf(neg));
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] = __fadd_rn(acc[i], __fadd_rn(t[i], tn[i]));
      loss = __fadd_rn(loss, __fadd_rn(softplusf(-pos), nloss));
    }
  } else {
    load_row<VPL>(C, row - V, d, lane, own);   // every entry of the segment outputs row
    for (int e = lo; e < hi; ++e) {
      const int ent = c_entries[e];
      const int p = ent / (K + 1), slot = ent % (K + 1);
      load_row<VPL>(W, pairs[2 * p], d, lane, part);
      const float s = dot<VPL>(part, own);
      const float coef = slot == 0 ? -__fdiv_rn(sigmoidf(-s), Pf) : __fdiv_rn(sigmoidf(s), Pf);
#pragma unroll
      for (int i = 0; i < VPL; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(coef, part[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = lane + 32 * i;
    if (j < d) partial[(long long)seg * d + j] = acc[i];
  }
  if (lane == 0) loss_part[seg] = loss;
}

// the slab path (256 < d <= 1,024): V = 8 NS values a lane; own and acc in
// the warp's shared memory ([2][NS 256] floats a warp, each lane touching
// its own values only), part / t / tn in registers
template <int NS>
__global__ void __launch_bounds__(kThreads)
sgns_segments_slab(const float* __restrict__ W, const float* __restrict__ C,
                   const int32_t* __restrict__ pairs, const int32_t* __restrict__ negs,
                   const int32_t* __restrict__ w_pairs, const int32_t* __restrict__ c_entries,
                   const int32_t* __restrict__ seg_row, const int32_t* __restrict__ seg_lo,
                   const int32_t* __restrict__ seg_hi, float* __restrict__ partial,
                   float* __restrict__ loss_part, int V, int d, int P, int K, int S) {
  constexpr int VPL = 8 * NS;
  extern __shared__ float rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* own = rows + warp * 2 * VPL * 32;
  float* acc = own + VPL * 32;
  const int seg = blockIdx.x * kWarpsPerBlock + warp;
  if (seg >= S) return;
  const int row = seg_row[seg], lo = seg_lo[seg], hi = seg_hi[seg];
  const float Pf = (float)P;
  const float* mine = row < V ? W + (long long)row * d : C + (long long)(row - V) * d;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = lane + 32 * i;
    own[j] = j < d ? mine[j] : 0.0f;
    acc[j] = 0.0f;
  }
  // sum_i own_i part_i in value order, then the butterfly
  auto dot = [&](const float (&part)[VPL]) {
    float s = __fmul_rn(own[lane], part[0]);
#pragma unroll
    for (int i = 1; i < VPL; ++i) s = __fadd_rn(s, __fmul_rn(own[lane + 32 * i], part[i]));
    return warp_sum(s);
  };
  float part[VPL];
  float loss = 0.0f;
  if (row < V) {
    for (int e = lo; e < hi; ++e) {
      const int p = w_pairs[e];
      load_row<VPL>(C, pairs[2 * p + 1], d, lane, part);
      const float pos = dot(part);
      const float cp = -__fdiv_rn(sigmoidf(-pos), Pf);
      float t[VPL], tn[VPL];
#pragma unroll
      for (int i = 0; i < VPL; ++i) {
        t[i] = __fmul_rn(cp, part[i]);
        tn[i] = 0.0f;
      }
      float nloss = 0.0f;
      for (int k = 0; k < K; ++k) {
        load_row<VPL>(C, negs[(long long)p * K + k], d, lane, part);
        const float neg = dot(part);
        const float cn = __fdiv_rn(sigmoidf(neg), Pf);
#pragma unroll
        for (int i = 0; i < VPL; ++i) tn[i] = __fadd_rn(tn[i], __fmul_rn(cn, part[i]));
        nloss = __fadd_rn(nloss, softplusf(neg));
      }
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        acc[lane + 32 * i] = __fadd_rn(acc[lane + 32 * i], __fadd_rn(t[i], tn[i]));
      loss = __fadd_rn(loss, __fadd_rn(softplusf(-pos), nloss));
    }
  } else {
    for (int e = lo; e < hi; ++e) {
      const int ent = c_entries[e];
      const int p = ent / (K + 1), slot = ent % (K + 1);
      load_row<VPL>(W, pairs[2 * p], d, lane, part);
      const float s = dot(part);
      const float coef = slot == 0 ? -__fdiv_rn(sigmoidf(-s), Pf) : __fdiv_rn(sigmoidf(s), Pf);
#pragma unroll
      for (int i = 0; i < VPL; ++i)
        acc[lane + 32 * i] = __fadd_rn(acc[lane + 32 * i], __fmul_rn(coef, part[i]));
    }
  }
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int j = lane + 32 * i;
    if (j < d) partial[(long long)seg * d + j] = acc[j];
  }
  if (lane == 0) loss_part[seg] = loss;
}

__global__ void __launch_bounds__(kThreads)
sgns_apply(const float* __restrict__ W, const float* __restrict__ C,
           const int32_t* __restrict__ row_seg, const float* __restrict__ partial,
           float* __restrict__ W2, float* __restrict__ C2, int V, int d, float lr) {
  const int row = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= 2 * V) return;
  const int s0 = row_seg[row], s1 = row_seg[row + 1];
  const float* src = row < V ? W + (long long)row * d : C + (long long)(row - V) * d;
  float* dst = row < V ? W2 + (long long)row * d : C2 + (long long)(row - V) * d;
  for (int j = lane; j < d; j += 32) {
    float g = 0.0f;
    for (int s = s0; s < s1; ++s) g = __fadd_rn(g, partial[(long long)s * d + j]);
    dst[j] = __fsub_rn(src[j], __fmul_rn(lr, g));
  }
}

// mean of the pairs' loss terms: the segments' sums in a fixed order
__global__ void sgns_loss_kernel(const float* __restrict__ loss_part, float* __restrict__ loss,
                                 int S, int P) {
  float s = 0.0f;
  for (int i = threadIdx.x; i < S; i += 32) s = __fadd_rn(s, loss_part[i]);
  s = warp_sum(s);
  if (threadIdx.x == 0) loss[0] = __fdiv_rn(s, (float)P);
}

template <int VPL>
int launch_segments(const void* W, const void* C, const void* pairs, const void* negs,
                    const void* w_pairs, const void* c_entries, const void* seg_row,
                    const void* seg_lo, const void* seg_hi, void* partial, void* loss_part,
                    int V, int d, int P, int K, int S, cudaStream_t st) {
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgns_segments<VPL><<<blocks, kThreads, 0, st>>>(
      (const float*)W, (const float*)C, (const int32_t*)pairs, (const int32_t*)negs,
      (const int32_t*)w_pairs, (const int32_t*)c_entries, (const int32_t*)seg_row,
      (const int32_t*)seg_lo, (const int32_t*)seg_hi, (float*)partial, (float*)loss_part, V,
      d, P, K, S);
  return (int)cudaGetLastError();
}

template <int NS>
int launch_slabs(const void* W, const void* C, const void* pairs, const void* negs,
                 const void* w_pairs, const void* c_entries, const void* seg_row,
                 const void* seg_lo, const void* seg_hi, void* partial, void* loss_part,
                 int V, int d, int P, int K, int S, cudaStream_t st) {
  const size_t smem = (size_t)kWarpsPerBlock * 2 * 8 * NS * 32 * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sgns_segments_slab<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (S + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgns_segments_slab<NS><<<blocks, kThreads, smem, st>>>(
      (const float*)W, (const float*)C, (const int32_t*)pairs, (const int32_t*)negs,
      (const int32_t*)w_pairs, (const int32_t*)c_entries, (const int32_t*)seg_row,
      (const int32_t*)seg_lo, (const int32_t*)seg_hi, (float*)partial, (float*)loss_part, V,
      d, P, K, S);
  return (int)cudaGetLastError();
}

}  // namespace

// The narrow entry's widest row.  Built with -DSGNS_NARROW_MAX_DIM=0 the
// slab path takes every width (tools/kernel_turns.py times that build as the
// narrow entry's rival).
#ifndef SGNS_NARROW_MAX_DIM
#define SGNS_NARROW_MAX_DIM 256
#endif

extern "C" int sgns_epoch(const void* W, const void* C, const void* pairs, const void* negs,
                          const void* w_pairs, const void* c_entries, const void* seg_row,
                          const void* seg_lo, const void* seg_hi, const void* row_seg,
                          void* partial, void* loss_part, void* W2, void* C2, int V, int d,
                          int P, int K, int S, float lr, void* stream) {
  if (V <= 0 || d <= 0 || d > 1024 || P <= 0 || K < 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  int err;
  if (d > SGNS_NARROW_MAX_DIM && d <= 256)
    err = launch_slabs<1>(W, C, pairs, negs, w_pairs, c_entries, seg_row, seg_lo, seg_hi,
                          partial, loss_part, V, d, P, K, S, st);
  else if (d <= 32)
    err = launch_segments<1>(W, C, pairs, negs, w_pairs, c_entries, seg_row, seg_lo, seg_hi,
                             partial, loss_part, V, d, P, K, S, st);
  else if (d <= 64)
    err = launch_segments<2>(W, C, pairs, negs, w_pairs, c_entries, seg_row, seg_lo, seg_hi,
                             partial, loss_part, V, d, P, K, S, st);
  else if (d <= 128)
    err = launch_segments<4>(W, C, pairs, negs, w_pairs, c_entries, seg_row, seg_lo, seg_hi,
                             partial, loss_part, V, d, P, K, S, st);
  else if (d <= 256)
    err = launch_segments<8>(W, C, pairs, negs, w_pairs, c_entries, seg_row, seg_lo, seg_hi,
                             partial, loss_part, V, d, P, K, S, st);
  else if (d <= 512)
    err = launch_slabs<2>(W, C, pairs, negs, w_pairs, c_entries, seg_row, seg_lo, seg_hi,
                          partial, loss_part, V, d, P, K, S, st);
  else
    err = launch_slabs<4>(W, C, pairs, negs, w_pairs, c_entries, seg_row, seg_lo, seg_hi,
                          partial, loss_part, V, d, P, K, S, st);
  if (err != 0) return err;
  const int blocks = (2 * V + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgns_apply<<<blocks, kThreads, 0, st>>>((const float*)W, (const float*)C,
                                          (const int32_t*)row_seg, (const float*)partial,
                                          (float*)W2, (float*)C2, V, d, lr);
  return (int)cudaGetLastError();
}

extern "C" int sgns_loss(const void* loss_part, void* loss, int S, int P, void* stream) {
  if (S <= 0 || P <= 0) return (int)cudaErrorInvalidValue;
  sgns_loss_kernel<<<1, 32, 0, (cudaStream_t)stream>>>((const float*)loss_part, (float*)loss,
                                                       S, P);
  return (int)cudaGetLastError();
}
