// Forward BSI, separable form: three per-axis sweeps, each output value a
// 4-term weighted sum of the previous stage against the (d, 4) weight LUT.
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_separable.py:bsi_separable_pallas
// (_kernel), dispatched by repro/kernels/ops.py:bsi_pallas(mode="separable").
//
// What bounds it on an H100: writing the dense field.  At the paper's
// phantom1 volume (512, 228, 385) with 3 channels that is 539 MB, about
// 0.16 ms at 3.35 TB/s; the control grid is 5 MB and stays in L2.  The sweeps
// are 4 + 16/d + 64/d^2 multiply-adds per output value (about 5.4 at a 5^3
// tile), far below the fp32 rate.
//
// What the design does about it: the staging of bsi_ttli.cu with the weight
// LUTs in place of the lerp LUTs (bsi_common.cuh, WeightStage).  One thread
// block per block of tiles stages its control window and the three LUTs in
// shared memory and runs the x and y sweeps there once per (x voxel, y voxel,
// z control point); each output value then costs its z sweep's 4 terms.  The
// sweeps run x, then y, then z, the order of the plain
// repro_torch.core.interpolate.bsi_separable.  The output loop runs channel
// fastest, then z, so a warp writes contiguous runs of the channels-last
// field, and only voxels inside (X, Y, Z) are written: dense_field's crop is
// fused.  Built with the default FMA contraction: each 4-term sum may round
// once per term less than the plain version's einsum (within 1e-5 relative).
#include "bsi_common.cuh"

namespace repro_torch {

__global__ void __launch_bounds__(kThreads)
    bsi_separable_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                         float* __restrict__ out, TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_xy<WeightStage>(phi, luts, g, ti0, tj0, tk0, smem);
  write_z_stage<WeightStage>(smem, g, ti0, tj0, tk0, out, X, Y, Z);
}

}  // namespace repro_torch

// phi: (nx, ny, nz, c) float32, contiguous; luts: the (d, 4) weight LUTs of
// x, then y, then z (core/bspline.py:weight_lut), row-major.  out: (X, Y, Z, c)
// float32 with X <= (nx - 3) * dx and so on.  Returns the launch's cudaError_t.
extern "C" int bsi_separable_f32(const float* phi, const float* luts, float* out,
                                 int nx, int ny, int nz, int c, int dx, int dy, int dz,
                                 int X, int Y, int Z, int bx, int by, int bz,
                                 void* stream) {
  using namespace repro_torch;
  const TileBlock g{nx, ny, nz, c, dx, dy, dz, bx, by, bz};
  const size_t smem = stage_smem_bytes<WeightStage>(g);
  cudaError_t err = allow_smem(bsi_separable_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  bsi_separable_kernel<<<tile_grid(g, X, Y, Z), kThreads, smem,
                         (cudaStream_t)stream>>>(phi, luts, out, g, X, Y, Z);
  return (int)cudaGetLastError();
}
