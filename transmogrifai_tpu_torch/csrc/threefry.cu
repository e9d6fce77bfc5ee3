// K-W threefry_draws: the threefry-2x32 draws of the forests and the boosting
// fits (Poisson bootstraps, exactly-k feature masks, row-subsample masks) and
// jax.random's uniforms, bit for bit as ops/threefry.py replays them.
//
// Replaces: transmogrifai_tpu/ops/trees.py::bootstrap_weights (:1390),
// ::feature_masks (:1400) and ::subsample_weights (:1411), and the
// jax.random.uniform / bits draws under them and under ops/mlp.py's Glorot
// init, with jax_threefry_partitionable = True: element i of a draw of any
// shape hashes the high and low 32-bit words of its row-major index i under
// the key, and its bits are the xor of the hash's two words; a uniform is
// ((bits >> 9) | 0x3F800000) as float minus 1, clamped at 0.
//
// Modes (one launch each):
//   BITS     out u32[N]: the bits;
//   UNIFORM  out f32[N]: the uniforms;
//   BELOW    out f32[N]: 1 where the uniform is below `thresh`, else 0 (the
//            subsample masks);
//   POISSON  out f32[N]: Knuth's loop as jax.random.poisson runs it at rate
//            lam < 10: per step (rng, sub) = split(rng), a lane still live
//            (log_prod > -lam) counts the step and adds the float32 rounding
//            of log((double)uniform(sub)[i]) to log_prod; the output is the
//            count minus 1.  The log is taken in double and rounded: that is
//            what matches XLA's float32 log (ops/trees.py explains why);
//   MASKS    out f32[T, d]: 1 where a tree's uniform is at or below its k-th
//            smallest (ties included), i.e. where fewer than k of the tree's
//            uniforms are strictly smaller.
// The key chain of POISSON is the same for every lane, so a block keeps it in
// shared memory and one thread extends it a split a step, for as many steps
// as the block's slowest lane needs: no lane is truncated, and the
// whole-array loop of the plain version (a host sync a step) is one launch.
//
// Bound on the card: the hash is 72 integer operations (20 rounds of an add,
// a funnel-shift rotate and a xor; five key injections; two initial adds),
// 76 with the count words and the uniform's map, so every mode is bound by
// the SMs' instruction dispatch rate, not by the bytes it writes (a float32
// written a draw); POISSON hashes once a live step of a lane (on average
// 1 + rate steps), and a warp waits for its slowest lane.  MASKS compares
// each of a tree's d uniforms with the others in shared memory, a warp a
// tree (d is a forest's feature count).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 4;        // POISSON lanes a thread
constexpr int kMaskWarps = 4;    // MASKS trees a block
constexpr int kMaxMaskD = 2048;  // MASKS features a tree (shared memory)

enum Mode { BITS = 0, UNIFORM = 1, BELOW = 2, POISSON = 3, MASKS = 4 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

// Threefry-2x32, 20 rounds, of the count words (x0, x1) under (k0, k1).
__device__ __forceinline__ uint2 threefry(uint32_t k0, uint32_t k1, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
  return make_uint2(x0, x1);
}

#undef TF_ROUND

__device__ __forceinline__ uint32_t bits_at(uint32_t k0, uint32_t k1, long long i) {
  const uint2 h = threefry(k0, k1, (uint32_t)((unsigned long long)i >> 32), (uint32_t)i);
  return h.x ^ h.y;
}

__device__ __forceinline__ float uniform_of(uint32_t bits) {
  return fmaxf(__fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u), 1.0f), 0.0f);
}

__global__ void __launch_bounds__(kThreads)
draw_elementwise(uint32_t k0, uint32_t k1, void* __restrict__ out, long long N, int mode,
                 float thresh) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < N; i += stride) {
    const uint32_t b = bits_at(k0, k1, i);
    if (mode == BITS) {
      ((uint32_t*)out)[i] = b;
    } else {
      const float u = uniform_of(b);
      ((float*)out)[i] = mode == UNIFORM ? u : (u < thresh ? 1.0f : 0.0f);
    }
  }
}

// Knuth's Poisson loop: kLanes lanes a thread, lanes i = base + j * kThreads
// + tid; the step's subkey in shared memory, extended by thread 0 while any
// lane of the block is live.
__global__ void __launch_bounds__(kThreads)
draw_poisson(uint32_t k0, uint32_t k1, float* __restrict__ out, long long N, float lam) {
  __shared__ uint32_t rng[2];
  __shared__ uint32_t sub[2];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kThreads * kLanes;
  float log_prod[kLanes];
  int count[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    log_prod[j] = 0.0f;
    count[j] = 0;
  }
  if (tid == 0) {
    rng[0] = k0;
    rng[1] = k1;
  }
  const float neg_lam = -lam;
  while (true) {
    int live = 0;
#pragma unroll
    for (int j = 0; j < kLanes; ++j)
      live |= (base + j * kThreads + tid < N) && (log_prod[j] > neg_lam);
    // a barrier too: every thread has read the previous step's subkey
    if (!__syncthreads_or(live)) break;
    if (tid == 0) {  // split(rng): the keys of counts (0, 0) and (0, 1)
      const uint2 next = threefry(rng[0], rng[1], 0u, 0u);
      const uint2 s = threefry(rng[0], rng[1], 0u, 1u);
      rng[0] = next.x;
      rng[1] = next.y;
      sub[0] = s.x;
      sub[1] = s.y;
    }
    __syncthreads();
    const uint32_t s0 = sub[0], s1 = sub[1];
#pragma unroll
    for (int j = 0; j < kLanes; ++j) {
      const long long i = base + j * kThreads + tid;
      if (i < N && log_prod[j] > neg_lam) {
        ++count[j];
        const float u = uniform_of(bits_at(s0, s1, i));
        log_prod[j] = __fadd_rn(log_prod[j], __double2float_rn(log((double)u)));
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    const long long i = base + j * kThreads + tid;
    if (i < N) out[i] = (float)(count[j] - 1);
  }
}

// Exactly-k feature masks: a warp a tree; the tree's d uniforms in shared
// memory, then each lane counts, for its features, the uniforms strictly
// below.
__global__ void __launch_bounds__(kMaskWarps * 32)
draw_masks(uint32_t k0, uint32_t k1, float* __restrict__ out, int T, int d, int k) {
  extern __shared__ float r_all[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.x * kMaskWarps + warp;
  float* r = r_all + (long long)warp * d;
  if (t < T)
    for (int j = lane; j < d; j += 32) r[j] = uniform_of(bits_at(k0, k1, (long long)t * d + j));
  __syncwarp();
  if (t >= T) return;
  for (int j = lane; j < d; j += 32) {
    const float v = r[j];
    int below = 0;
    for (int q = 0; q < d; ++q) below += r[q] < v;
    out[(long long)t * d + j] = below < k ? 1.0f : 0.0f;
  }
}

}  // namespace

// mode: BITS, UNIFORM, BELOW (param = the threshold), POISSON (param = the
// rate, 0 < rate < 10) over N elements; MASKS over rows x cols (T trees of d
// features, k features kept, d <= 2048).  Returns the CUDA error code.
extern "C" int threefry_draws(unsigned int k0, unsigned int k1, void* out, long long N, int mode,
                              float param, int rows, int cols, int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N <= 0) return (int)cudaErrorInvalidValue;
  if (mode == POISSON) {
    if (!(param > 0.0f && param < 10.0f)) return (int)cudaErrorInvalidValue;
    const long long per_block = (long long)kThreads * kLanes;
    draw_poisson<<<(unsigned)((N + per_block - 1) / per_block), kThreads, 0, st>>>(
        k0, k1, (float*)out, N, param);
  } else if (mode == MASKS) {
    if (rows <= 0 || cols <= 0 || cols > kMaxMaskD || (long long)rows * cols != N || k < 1)
      return (int)cudaErrorInvalidValue;
    const size_t shmem = (size_t)kMaskWarps * cols * sizeof(float);
    draw_masks<<<(unsigned)((rows + kMaskWarps - 1) / kMaskWarps), kMaskWarps * 32, shmem, st>>>(
        k0, k1, (float*)out, rows, cols, k);
  } else if (mode == BITS || mode == UNIFORM || mode == BELOW) {
    const long long blocks = (N + kThreads - 1) / kThreads;
    const unsigned grid = (unsigned)(blocks < 132LL * 64 ? blocks : 132LL * 64);
    draw_elementwise<<<grid, kThreads, 0, st>>>(k0, k1, out, N, mode, param);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
