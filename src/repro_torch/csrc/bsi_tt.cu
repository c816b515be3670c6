// Forward BSI, TT form (thread-per-tile, paper §3.2): each output value is the
// 64-term weighted sum sum_{l,m,n} (wx[a,l] * wy[b,m]) * wz[c,n] *
// window[tile + (l, m, n)], the terms added in l, m, n order.
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_tt.py:bsi_tt_pallas
// (_kernel), dispatched by repro/kernels/ops.py:bsi_pallas(mode="tt").
//
// What bounds it on an H100: the operations.  64 multiply-adds per output
// value: at the paper's phantom1 volume (512, 228, 385) with 3 channels that
// is 17.3 GFLOP, 0.26 ms at 67 TFLOP/s fp32; writing the 539 MB field takes
// 0.16 ms at 3.35 TB/s.  Built without FMA contraction, each term costs a
// multiply for its weight, a multiply and an add.
//
// What the design does about it: the register reuse the paper credits for
// its speed-up.  One thread block per block of tiles stages its control
// window and the three (d, 4) weight LUTs in shared memory.  A thread owns one
// (tile, channel): it holds the tile's 64 control values in registers and
// walks the tile's voxels, x then y then z; per (x, y) voxel column it forms
// the 16 products wx[a,l] * wy[b,m] once, and per voxel the 64 weights
// (wx*wy)*wz from them and the z LUT row, which every thread of a warp reads
// at the same address (a broadcast).  Only voxels inside (X, Y, Z) are
// written: dense_field's crop is fused.
//
// Built with -fmad=false (kernels/build.py:SOURCE_FLAGS): every weight
// product and every acc + p * w is rounded as the plain
// repro_torch.core.interpolate.bsi_tt rounds it (which adds out + sl * w one
// term at a time), so the kernel equals its plain version bit for bit.
#include "bsi_common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads)
    bsi_tt_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                  float* __restrict__ out, TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  const int nl = lut_floats<WeightStage>(g);
  float* s_lut = smem;  // wx (dx, 4), wy (dy, 4), wz (dz, 4)
  float* s_win = smem + nl;
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  for (int i = threadIdx.x; i < nl; i += blockDim.x) s_lut[i] = luts[i];
  stage_window(phi, g, ti0, tj0, tk0, s_win);
  __syncthreads();

  const float* wx = s_lut;
  const float* wy = wx + 4 * g.dx;
  const float* wz = wy + 4 * g.dy;
  const int wyn = g.by + 3, wzn = g.bz + 3;
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
      p[k] = s_win[(((lx + l) * wyn + ly + m) * wzn + lz + n) * g.c + ch];
    }
    for (int a = 0; a < g.dx; ++a) {
      const int x = x0 + a;
      if (x >= X) break;
      for (int b = 0; b < g.dy; ++b) {
        const int y = y0 + b;
        if (y >= Y) break;
        float wxy[16];
#pragma unroll
        for (int q = 0; q < 16; ++q) wxy[q] = wx[4 * a + (q >> 2)] * wy[4 * b + (q & 3)];
        for (int c = 0; c < g.dz; ++c) {
          const int z = z0 + c;
          if (z >= Z) break;
          const float4 wzc = *reinterpret_cast<const float4*>(wz + 4 * c);
          const float wzn4[4] = {wzc.x, wzc.y, wzc.z, wzc.w};
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < 64; ++k) acc = acc + p[k] * (wxy[k >> 2] * wzn4[k & 3]);
          out[(((size_t)x * Y + y) * Z + z) * g.c + ch] = acc;
        }
      }
    }
  }
}

}  // namespace repro_torch

// phi: (nx, ny, nz, c) float32, contiguous; luts: the (d, 4) weight LUTs of
// x, then y, then z (core/bspline.py:weight_lut), row-major.  out: (X, Y, Z, c)
// float32 with X <= (nx - 3) * dx and so on.  Returns the launch's cudaError_t.
extern "C" int bsi_tt_f32(const float* phi, const float* luts, float* out, int nx,
                          int ny, int nz, int c, int dx, int dy, int dz, int X, int Y,
                          int Z, int bx, int by, int bz, void* stream) {
  using namespace repro_torch;
  const TileBlock g{nx, ny, nz, c, dx, dy, dz, bx, by, bz};
  const size_t smem =
      sizeof(float) * (size_t)(lut_floats<WeightStage>(g) + window_floats(g));
  cudaError_t err = allow_smem(bsi_tt_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bsi_tt_kernel<<<tile_grid(g, X, Y, Z), kThreads, smem, (cudaStream_t)stream>>>(
      phi, luts, out, g, X, Y, Z);
  return (int)cudaGetLastError();
}
