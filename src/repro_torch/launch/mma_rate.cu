// The tensor cores' rate through mma.sync on the card: m16n8k8 TF32 and
// m16n8k16 bf16 products on 8 independent accumulators a warp, no loads, at
// 4, 8 and 16 warps on each of 132 blocks; and TF32 again with 4 independent
// float32 FMAs, or 2 of the flash kernel's operand splits (an add, an and, a
// subtract each), issued beside each product: whether other instructions
// issue while the tensor pipe is busy; printed in TFLOP/s and in clocks an
// instruction on a scheduler at 1.98 GHz (the SM clock under load).
// Built and run by launch/profile_flash.py --mma-rate:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_rate mma_rate.cu
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, const unsigned* b) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// KIND 0: TF32, 1: bf16, 2: TF32 with 4 FFMAs beside each product, 3: with 2 splits
template <int KIND>
__global__ void bench(float* out, int iters) {
  unsigned a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = 0x3f800000u + threadIdx.x + i;
  b[0] = 0x3f800000u; b[1] = 0x3f000000u + threadIdx.x;
  float d[8][4] = {};
  float f[8][4];
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) f[j][e] = threadIdx.x + j + e;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (KIND == 1) {
        mma_bf16(d[j], a, b);
      } else {
        mma_tf32(d[j], a, b);
      }
      if (KIND == 2) {
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = fmaf(f[j][e], 1.0001f, 0.5f);
      }
      if (KIND == 3) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const unsigned hi = (__float_as_uint(f[j][e]) + 0x1000u) & 0xFFFFE000u;
          f[j][e] = (f[j][e] - __uint_as_float(hi)) + f[j][e + 2];
        }
      }
    }
  }
  float s = 0;
  for (int j = 0; j < 8; ++j) for (int e = 0; e < 4; ++e) s += d[j][e] + f[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
int main() {
  float* out; cudaMalloc(&out, 132 * 8 * 1024 * 4);
  int iters = 20000;
  const char* names[4] = {"tf32 m16n8k8", "bf16 m16n8k16", "tf32 m16n8k8 + 4 FFMA",
                          "tf32 m16n8k8 + 2 splits"};
  for (int kind = 0; kind < 4; ++kind)
    for (int warps = 4; warps <= 16; warps *= 2) {
      cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
      auto k = kind == 0 ? bench<0> : kind == 1 ? bench<1> : kind == 2 ? bench<2> : bench<3>;
      k<<<132, 32 * warps>>>(out, 100);
      cudaEventRecord(e0);
      k<<<132, 32 * warps>>>(out, iters);
      cudaEventRecord(e1); cudaEventSynchronize(e1);
      float ms; cudaEventElapsedTime(&ms, e0, e1);
      double mmas = 132.0 * warps * iters * 8;
      double flop = mmas * (kind == 1 ? 4096.0 : 2048.0);
      printf("%s warps/SM %d: %.3f ms, %.1f TFLOP/s, %.2f clocks a mma per SM sub-partition at 1.98 GHz\n",
             names[kind], warps, ms, flop / ms / 1e9,
             ms * 1e-3 * 1.98e9 / (mmas / 132 / 4));
    }
  return 0;
}
