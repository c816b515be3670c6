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
// What the design does about it: the device code and blocks of bsi_ttli.cu
// (bsi_forward.cuh) with the weight LUTs in place of the lerp LUTs
// (WeightStage): the x and y sweeps once per (x voxel, y voxel, z control
// point) into shared memory, then each output value its z sweep's 4 terms,
// its offsets from the block's z table and its weights from the z LUT, the
// field written in whole rows, a warp store one aligned 128-byte line.  The
// sweeps run x, then y, then z, the order of the plain
// repro_torch.core.interpolate.bsi_separable, and only voxels inside
// (X, Y, Z) are written: dense_field's crop is fused.  Built with the
// default FMA contraction: each 4-term sum may round once per term less than
// the plain version's einsum (within 1e-5 relative).
//
// bsi_separable_bf16, the compute_dtype="bfloat16" variant, is the same
// code on a bf16 grid and field: bf16 operands widened, float32 sweeps, one
// rounding at the store, the Pallas kernel's own contract
// (preferred_element_type=float32 on each sweep, one cast at the store,
// repro/kernels/bsi_separable.py:37-57).  Within one bf16 step of the plain
// version (the float32 sums may differ in their last bits).  Bound at
// phantom1: 272.2 MB, 0.0812 ms at 3.35 TB/s.  bsi_separable_f16
// (compute_dtype="float16") is the same code on __half, the same bound.
#include "bsi_forward.cuh"

namespace repro_torch {

// C: the channels, 3, or 0 for any (forward_block)
template <int C>
__global__ void __launch_bounds__(kThreads)
    bsi_separable_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                         float* __restrict__ out, FwdBlock g) {
  extern __shared__ float4 smem4[];
  forward_block<WeightStage, C>(phi, luts, out, g, reinterpret_cast<float*>(smem4));
}

// The same on a bf16 grid, writing a bf16 field: float32 arithmetic, one
// rounding at the store (bsi_forward.cuh).
template <int C>
__global__ void __launch_bounds__(kThreads)
    bsi_separable_bf16_kernel(const __nv_bfloat16* __restrict__ phi,
                              const float* __restrict__ luts,
                              __nv_bfloat16* __restrict__ out, FwdBlock g) {
  extern __shared__ float4 smem4[];
  forward_block<WeightStage, C>(phi, luts, out, g, reinterpret_cast<float*>(smem4));
}

// The same on an fp16 grid, writing an fp16 field: float32 arithmetic, one
// rounding at the store (bsi_forward.cuh).
template <int C>
__global__ void __launch_bounds__(kThreads)
    bsi_separable_f16_kernel(const __half* __restrict__ phi, const float* __restrict__ luts,
                             __half* __restrict__ out, FwdBlock g) {
  extern __shared__ float4 smem4[];
  forward_block<WeightStage, C>(phi, luts, out, g, reinterpret_cast<float*>(smem4));
}

}  // namespace repro_torch

// phi: (nx, ny, nz, c) float32, contiguous; luts: the (d, 4) weight LUTs of
// x, then y, then z (core/bspline.py:weight_lut), row-major.  out: (X, Y, Z,
// c) float32 with X <= (nx - 3) * dx and so on; bz tiles along z a block
// (kernels/bsi_ttli.py:forward_blocks).  Returns the launch's cudaError_t.
extern "C" int bsi_separable_f32(const float* phi, const float* luts, float* out, int nx,
                                 int ny, int nz, int c, int dx, int dy, int dz, int X, int Y,
                                 int Z, int bz, void* stream) {
  using namespace repro_torch;
  const FwdBlock g{nx, ny, nz, c, dx, dy, dz, bz, X, Y, Z};
  return launch_forward(bsi_separable_kernel<3>, bsi_separable_kernel<0>, phi, luts, out, g,
                        stream);
}

// The same with phi and out bf16 and luts rounded to bf16 (held as floats).
extern "C" int bsi_separable_bf16(const __nv_bfloat16* phi, const float* luts,
                                  __nv_bfloat16* out, int nx, int ny, int nz, int c, int dx,
                                  int dy, int dz, int X, int Y, int Z, int bz, void* stream) {
  using namespace repro_torch;
  const FwdBlock g{nx, ny, nz, c, dx, dy, dz, bz, X, Y, Z};
  return launch_forward(bsi_separable_bf16_kernel<3>, bsi_separable_bf16_kernel<0>, phi, luts,
                        out, g, stream);
}

// The same with phi and out fp16 and luts rounded to fp16 (held as floats).
extern "C" int bsi_separable_f16(const __half* phi, const float* luts, __half* out, int nx,
                                 int ny, int nz, int c, int dx, int dy, int dz, int X, int Y,
                                 int Z, int bz, void* stream) {
  using namespace repro_torch;
  const FwdBlock g{nx, ny, nz, c, dx, dy, dz, bz, X, Y, Z};
  return launch_forward(bsi_separable_f16_kernel<3>, bsi_separable_f16_kernel<0>, phi, luts,
                        out, g, stream);
}
