// The float64 mma.sync shapes on a Hopper card: each shape's fragment layout
// (the one csrc/weighted_gram.cu assumes for m16n8k8) checked against a host
// product, and each shape's throughput (8 independent accumulators a warp,
// 4 blocks of 256 threads an SM).  m8n8k4 builds for sm_80 and later; the
// m16n8k{4,8,16} shapes need sm_90 (PTX ISA 7.8), built with -DPROBE_SM90.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -DPROBE_SM90 \
//        -o dmma_shapes transmogrifai_tpu_torch/tools/dmma_shapes.cu && ./dmma_shapes
#include <cstdio>
#include <cstdlib>
#include <cmath>
#include <cuda_runtime.h>

#define CK(x) do { cudaError_t e = (x); if (e != cudaSuccess) { printf("CUDA %s at %d\n", cudaGetErrorString(e), __LINE__); exit(1);} } while (0)

// A row-major [M][K], B row-major [K][N], D row-major [M][N]
__global__ void k884(const double* A, const double* B, double* D) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a = A[g * 4 + t], b = B[t * 8 + g], c0 = 0, c1 = 0;
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
               : "+d"(c0), "+d"(c1) : "d"(a), "d"(b));
  D[g * 8 + 2 * t] = c0; D[g * 8 + 2 * t + 1] = c1;
}
#if defined(PROBE_SM90)
__global__ void k1684(const double* A, const double* B, double* D) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a0 = A[g * 4 + t], a1 = A[(g + 8) * 4 + t], b = B[t * 8 + g];
  double c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
               : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3) : "d"(a0), "d"(a1), "d"(b));
  D[g * 8 + 2 * t] = c0; D[g * 8 + 2 * t + 1] = c1;
  D[(g + 8) * 8 + 2 * t] = c2; D[(g + 8) * 8 + 2 * t + 1] = c3;
}
__global__ void k1688(const double* A, const double* B, double* D) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a0 = A[g * 8 + t], a1 = A[(g + 8) * 8 + t], a2 = A[g * 8 + t + 4], a3 = A[(g + 8) * 8 + t + 4];
  double b0 = B[t * 8 + g], b1 = B[(t + 4) * 8 + g];
  double c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
               : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3) : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
  D[g * 8 + 2 * t] = c0; D[g * 8 + 2 * t + 1] = c1;
  D[(g + 8) * 8 + 2 * t] = c2; D[(g + 8) * 8 + 2 * t + 1] = c3;
}
__global__ void k16816(const double* A, const double* B, double* D) {
  int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  double a[8], b[4];
  for (int i = 0; i < 8; ++i) a[i] = A[(g + 8 * (i % 2)) * 16 + t + 4 * (i / 2)];
  for (int i = 0; i < 4; ++i) b[i] = B[(t + 4 * i) * 8 + g];
  double c0 = 0, c1 = 0, c2 = 0, c3 = 0;
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
               : "+d"(c0), "+d"(c1), "+d"(c2), "+d"(c3)
               : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
                 "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
  D[g * 8 + 2 * t] = c0; D[g * 8 + 2 * t + 1] = c1;
  D[(g + 8) * 8 + 2 * t] = c2; D[(g + 8) * 8 + 2 * t + 1] = c3;
}
#endif

// throughput: 8 independent accumulator sets a warp, ITER steps
template <int SHAPE>
__global__ void tput(double* out, int iters) {
  int lane = threadIdx.x & 31;
  double a0 = 1.0 + lane * 1e-3, a1 = 2.0 - lane * 1e-3, b0 = 0.5 + lane * 1e-4;
  double b1 = 0.25 + lane * 1e-4;
  double c[8][4];
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) c[i][j] = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (SHAPE == 0) {
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0,%1}, {%2}, {%3}, {%0,%1};"
                     : "+d"(c[i][0]), "+d"(c[i][1]) : "d"(a0), "d"(i % 2 ? b1 : b0));
      }
#if defined(PROBE_SM90)
      else if (SHAPE == 1) {
        asm volatile("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};"
                     : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3]) : "d"(a0), "d"(a1), "d"(b0));
      } else if (SHAPE == 2) {
        asm volatile("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3]) : "d"(a0), "d"(a1), "d"(a0), "d"(a1), "d"(b0), "d"(b1));
      } else {
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5,%6,%7,%8,%9,%10,%11}, {%12,%13,%14,%15}, {%0,%1,%2,%3};"
                     : "+d"(c[i][0]), "+d"(c[i][1]), "+d"(c[i][2]), "+d"(c[i][3])
                     : "d"(a0), "d"(a1), "d"(a0), "d"(a1), "d"(a0), "d"(a1), "d"(a0), "d"(a1), "d"(b0), "d"(b1), "d"(b0), "d"(b1));
      }
#endif
    }
  }
  double s = 0;
  for (int i = 0; i < 8; ++i) for (int j = 0; j < 4; ++j) s += c[i][j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

static void check(const char* name, void (*kern)(const double*, const double*, double*), int M, int K) {
  const int N = 8;
  double hA[16 * 16], hB[16 * 8], hD[16 * 8], ref[16 * 8];
  for (int i = 0; i < M * K; ++i) hA[i] = (double)((i * 37) % 101) / 7.0 + 1.0 / 3.0;
  for (int i = 0; i < K * N; ++i) hB[i] = (double)((i * 53) % 97) / 11.0 - 1.0 / 7.0;
  for (int m = 0; m < M; ++m) for (int n = 0; n < N; ++n) {
    double s = 0; for (int k = 0; k < K; ++k) s += hA[m * K + k] * hB[k * N + n]; ref[m * N + n] = s;
  }
  double *dA, *dB, *dD;
  CK(cudaMalloc(&dA, sizeof hA)); CK(cudaMalloc(&dB, sizeof hB)); CK(cudaMalloc(&dD, sizeof hD));
  CK(cudaMemcpy(dA, hA, sizeof hA, cudaMemcpyHostToDevice));
  CK(cudaMemcpy(dB, hB, sizeof hB, cudaMemcpyHostToDevice));
  CK(cudaMemset(dD, 0, sizeof hD));
  kern<<<1, 32>>>(dA, dB, dD);
  CK(cudaDeviceSynchronize());
  CK(cudaMemcpy(hD, dD, sizeof hD, cudaMemcpyDeviceToHost));
  double err = 0; for (int i = 0; i < M * N; ++i) err = fmax(err, fabs(hD[i] - ref[i]) / (fabs(ref[i]) + 1e-30));
  printf("layout %s: max rel err %.3e %s\n", name, err, err < 1e-12 ? "OK" : "WRONG");
  cudaFree(dA); cudaFree(dB); cudaFree(dD);
}

template <int SHAPE>
static void bench(const char* name, double fma_per_mma) {
  int blocks = 132 * 4, threads = 256, iters = 4096;
  double* out; CK(cudaMalloc(&out, blocks * threads * sizeof(double)));
  tput<SHAPE><<<blocks, threads>>>(out, 16);
  CK(cudaDeviceSynchronize());
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  tput<SHAPE><<<blocks, threads>>>(out, iters);
  cudaEventRecord(b); CK(cudaEventSynchronize(b));
  float ms; cudaEventElapsedTime(&ms, a, b);
  double mmas = (double)blocks * (threads / 32) * iters * 8;
  printf("tput %s: %.3f ms, %.2f TFLOP/s f64\n", name, ms, 2.0 * mmas * fma_per_mma / (ms * 1e-3) / 1e12);
  cudaFree(out);
}

int main() {
  check("m8n8k4", k884, 8, 4);
#if defined(PROBE_SM90)
  check("m16n8k4", k1684, 16, 4);
  check("m16n8k8", k1688, 16, 8);
  check("m16n8k16", k16816, 16, 16);
#endif
  bench<0>("m8n8k4", 256);
#if defined(PROBE_SM90)
  bench<1>("m16n8k4", 512);
  bench<2>("m16n8k8", 1024);
  bench<3>("m16n8k16", 2048);
#endif
  return 0;
}
