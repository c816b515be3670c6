// Forward BSI, TTLI form (thread-per-tile + staged lerps, paper §3.3).
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_ttli.py:bsi_ttli_pallas
// (_kernel), dispatched by repro/kernels/ops.py:bsi_pallas(mode="ttli").
//
// What bounds it on an H100: writing the dense field.  At the paper's
// phantom1 volume (512, 228, 385) with 3 channels that is 539 MB, about
// 0.16 ms at 3.35 TB/s; the control grid is 5 MB and stays in L2.  The lerp
// work, staged x -> y -> z over whole tile blocks, is about 7.5 flops per
// output value, far below the fp32 rate.
//
// What the design does about it: one thread block per block of tiles
// stages its control window in shared memory and runs the x and y stages
// there once per (x voxel, y voxel, z control point), so each output value
// costs only its three z-stage lerps.  The output loop runs channel fastest,
// then z, so a warp writes contiguous runs of the channels-last field.  Only
// voxels inside (X, Y, Z) are written: dense_field's crop is fused, and no
// padded copy of the field exists.
#include "bsi_common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads)
    bsi_ttli_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                    float* __restrict__ out, TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_xy<LerpStage>(phi, luts, g, ti0, tj0, tk0, smem);
  write_z_stage<LerpStage>(smem, g, ti0, tj0, tk0, out, X, Y, Z);
}

}  // namespace repro_torch

// phi: (nx, ny, nz, c) float32, contiguous.  out: (X, Y, Z, c) float32 with
// X <= (nx - 3) * dx and so on.  Returns the launch's cudaError_t.
extern "C" int bsi_ttli_f32(const float* phi, const float* luts, float* out, int nx,
                            int ny, int nz, int c, int dx, int dy, int dz, int X, int Y,
                            int Z, int bx, int by, int bz, void* stream) {
  using namespace repro_torch;
  const TileBlock g{nx, ny, nz, c, dx, dy, dz, bx, by, bz};
  const size_t smem = stage_smem_bytes<LerpStage>(g);
  cudaError_t err = allow_smem(bsi_ttli_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bsi_ttli_kernel<<<tile_grid(g, X, Y, Z), kThreads, smem, (cudaStream_t)stream>>>(
      phi, luts, out, g, X, Y, Z);
  return (int)cudaGetLastError();
}
