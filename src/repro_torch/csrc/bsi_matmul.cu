// Forward BSI, matrix form (Wu & Zou): each output value is the 64-term sum
// sum_k B[v, k] * window[tile + (l, m, n)], k = (l*4 + m)*4 + n.
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_matmul.py:bsi_matmul_pallas
// (_kernel, kron_basis, contract_window), dispatched by
// repro/kernels/ops.py:bsi_pallas(mode="matmul").
//
// What bounds it on an H100: the operations.  64 multiply-adds per output
// value: at the paper's phantom1 volume (512, 228, 385) with 3 channels that
// is 17.3 GFLOP, 0.26 ms at 67 TFLOP/s fp32; writing the 539 MB field takes
// 0.16 ms at 3.35 TB/s.
//
// What the design does about it: one thread block per block of tiles stages
// its control window and the (d^3, 64) basis (32 KB at a 5^3 tile) in
// shared memory.  A thread owns one (tile, channel): it holds the tile's 64
// control values in registers and walks the tile's d^3 voxels, reading each
// basis row as 16 float4 loads that every thread of the warp shares (all
// threads are at the same voxel offset, so the loads broadcast), and sums the
// 64 terms in the fixed order k = 0..63 with fp32 FMAs.  Only voxels inside
// (X, Y, Z) are written: dense_field's crop is fused.  The tensor cores
// (3xTF32 or bf16 mma) are later work: plain TF32 keeps 10 mantissa bits,
// about 1e-3 relative, and the port is held to 1e-5.
#include "bsi_common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads)
    bsi_matmul_kernel(const float* __restrict__ phi, const float* __restrict__ basis,
                      float* __restrict__ out, TileBlock g, int X, int Y, int Z) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int nb = basis_floats(g);
  float* s_b = smem;  // (nv, 64), 16-byte aligned rows
  float* s_win = smem + nb;
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  for (int i = threadIdx.x; i < nb; i += blockDim.x) s_b[i] = basis[i];
  stage_window(phi, g, ti0, tj0, tk0, s_win);
  __syncthreads();

  const int wy = g.by + 3, wz = g.bz + 3;
  const int items = g.bx * g.by * g.bz * g.c;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int ch = w % g.c;
    int r = w / g.c;
    const int lz = r % g.bz;
    r /= g.bz;
    const int ly = r % g.by;
    const int lx = r / g.by;
    const int x0 = (ti0 + lx) * g.dx, y0 = (tj0 + ly) * g.dy, z0 = (tk0 + lz) * g.dz;
    if (x0 >= X || y0 >= Y || z0 >= Z) continue;  // the tile is past the volume
    float p[64];
#pragma unroll
    for (int k = 0; k < 64; ++k) {
      const int l = k >> 4, m = (k >> 2) & 3, n = k & 3;
      p[k] = s_win[(((lx + l) * wy + ly + m) * wz + lz + n) * g.c + ch];
    }
    for (int a = 0; a < g.dx; ++a) {
      const int x = x0 + a;
      if (x >= X) break;
      for (int b = 0; b < g.dy; ++b) {
        const int y = y0 + b;
        if (y >= Y) break;
        for (int c = 0; c < g.dz; ++c) {
          const int z = z0 + c;
          if (z >= Z) break;
          const float4* row = smem4 + ((a * g.dy + b) * g.dz + c) * 16;
          float acc = 0.f;
#pragma unroll
          for (int q = 0; q < 16; ++q) {
            const float4 bq = row[q];
            acc = acc + bq.x * p[4 * q];
            acc = acc + bq.y * p[4 * q + 1];
            acc = acc + bq.z * p[4 * q + 2];
            acc = acc + bq.w * p[4 * q + 3];
          }
          out[(((size_t)x * Y + y) * Z + z) * g.c + ch] = acc;
        }
      }
    }
  }
}

}  // namespace repro_torch

// phi: (nx, ny, nz, c) float32, contiguous; basis: (dx*dy*dz, 64) float32
// (core/bspline.py:basis_matrix).  out: (X, Y, Z, c) float32 with
// X <= (nx - 3) * dx and so on.  Returns the launch's cudaError_t.
extern "C" int bsi_matmul_f32(const float* phi, const float* basis, float* out, int nx,
                              int ny, int nz, int c, int dx, int dy, int dz, int X,
                              int Y, int Z, int bx, int by, int bz, void* stream) {
  using namespace repro_torch;
  const TileBlock g{nx, ny, nz, c, dx, dy, dz, bx, by, bz};
  const size_t smem = sizeof(float) * (size_t)(basis_floats(g) + window_floats(g));
  cudaError_t err = allow_smem(bsi_matmul_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bsi_matmul_kernel<<<tile_grid(g, X, Y, Z), kThreads, smem, (cudaStream_t)stream>>>(
      phi, basis, out, g, X, Y, Z);
  return (int)cudaGetLastError();
}
