// Forward BSI, TTLI form (thread-per-tile + staged lerps, paper §3.3).
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_ttli.py:bsi_ttli_pallas
// (_kernel), dispatched by repro/kernels/ops.py:bsi_pallas(mode="ttli").
//
// What bounds it on an H100: writing the dense field.  At the paper's
// phantom1 volume (512, 228, 385) with 3 channels that is 539 MB, about
// 0.16 ms at 3.35 TB/s; the control grid is 5 MB and stays in L2.  The lerp
// work, staged x -> y -> z, is about 7.5 flops per output value, far below
// the fp32 rate.  What stands between a kernel and that bound is index
// arithmetic per value (a run-time division is about 20 instructions) and
// the store pattern: rows of Z * c floats start anywhere, so a warp's 32
// floats straddle two 128-byte lines unless the lanes are shifted.
//
// What the design does about it (bsi_forward.cuh): a block owns one
// (x tile, y tile) and, at phantom1, the whole z extent, so it writes whole
// rows of the field, a y tile's rows one contiguous 23 KB run, each warp
// store one aligned 128-byte line.  The x and y stages run once per
// (x voxel, y voxel, z control point) into shared memory; a position's
// offsets come from a table the block builds once, its z lerp coefficients
// from the z LUT in shared memory, and the threads walk the block's columns
// by constant strides, so each output value costs its three z lerps, eight
// shared loads and a store, and no index is decoded in a loop over voxels.
// Only voxels inside (X, Y, Z) are written: dense_field's crop is fused, and
// no padded copy of the field exists.
//
// bsi_ttli_bf16, the compute_dtype="bfloat16" variant, replaces the same
// Pallas kernel run on a bf16 grid (its output takes phi's dtype,
// repro/kernels/bsi_ttli.py:70).  It reads the bf16 grid and the LUTs
// rounded to bf16, computes in float32 and rounds each value once at its
// store.  The Pallas kernel writes its lerps in phi's dtype, so interpreted
// on a CPU it rounds every lerp to bf16; this kernel does not, and the
// tests hold it to the JAX package's own bf16 bounds.  Bound at phantom1:
// 269.7 MB of bf16 field and 2.5 MB of grid, 0.0812 ms at 3.35 TB/s.
// bsi_ttli_f16 (compute_dtype="float16") is the same code on __half: the
// fp16 grid and LUTs, float32 lerps, one rounding to fp16 at the store
// (subnormals kept), a lane a __half2 pair; the same bound.
#include "bsi_forward.cuh"

namespace repro_torch {

// C: the channels, 3, or 0 for any (forward_block)
template <int C>
__global__ void __launch_bounds__(kThreads)
    bsi_ttli_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                    float* __restrict__ out, FwdBlock g) {
  extern __shared__ float4 smem4[];
  forward_block<LerpStage, C>(phi, luts, out, g, reinterpret_cast<float*>(smem4));
}

// The same on a bf16 grid, writing a bf16 field: float32 arithmetic, one
// rounding at the store (bsi_forward.cuh).
template <int C>
__global__ void __launch_bounds__(kThreads)
    bsi_ttli_bf16_kernel(const __nv_bfloat16* __restrict__ phi,
                         const float* __restrict__ luts, __nv_bfloat16* __restrict__ out,
                         FwdBlock g) {
  extern __shared__ float4 smem4[];
  forward_block<LerpStage, C>(phi, luts, out, g, reinterpret_cast<float*>(smem4));
}

// The same on an fp16 grid, writing an fp16 field: float32 arithmetic, one
// rounding at the store (bsi_forward.cuh).
template <int C>
__global__ void __launch_bounds__(kThreads)
    bsi_ttli_f16_kernel(const __half* __restrict__ phi,
                        const float* __restrict__ luts, __half* __restrict__ out,
                        FwdBlock g) {
  extern __shared__ float4 smem4[];
  forward_block<LerpStage, C>(phi, luts, out, g, reinterpret_cast<float*>(smem4));
}

}  // namespace repro_torch

// phi: (nx, ny, nz, c) float32, contiguous; luts: (t0, t1, s) of x, then y,
// then z.  out: (X, Y, Z, c) float32 with X <= (nx - 3) * dx and so on; bz
// tiles along z a block (kernels/bsi_ttli.py:forward_blocks).  Returns the
// launch's cudaError_t.
extern "C" int bsi_ttli_f32(const float* phi, const float* luts, float* out, int nx, int ny,
                            int nz, int c, int dx, int dy, int dz, int X, int Y, int Z, int bz,
                            void* stream) {
  using namespace repro_torch;
  const FwdBlock g{nx, ny, nz, c, dx, dy, dz, bz, X, Y, Z};
  return launch_forward(bsi_ttli_kernel<3>, bsi_ttli_kernel<0>, phi, luts, out, g, stream);
}

// The same with phi and out bf16 and luts rounded to bf16 (held as floats).
extern "C" int bsi_ttli_bf16(const __nv_bfloat16* phi, const float* luts, __nv_bfloat16* out,
                             int nx, int ny, int nz, int c, int dx, int dy, int dz, int X,
                             int Y, int Z, int bz, void* stream) {
  using namespace repro_torch;
  const FwdBlock g{nx, ny, nz, c, dx, dy, dz, bz, X, Y, Z};
  return launch_forward(bsi_ttli_bf16_kernel<3>, bsi_ttli_bf16_kernel<0>, phi, luts, out, g,
                        stream);
}

// The same with phi and out fp16 and luts rounded to fp16 (held as floats).
extern "C" int bsi_ttli_f16(const __half* phi, const float* luts, __half* out, int nx,
                            int ny, int nz, int c, int dx, int dy, int dz, int X, int Y,
                            int Z, int bz, void* stream) {
  using namespace repro_torch;
  const FwdBlock g{nx, ny, nz, c, dx, dy, dz, bz, X, Y, Z};
  return launch_forward(bsi_ttli_f16_kernel<3>, bsi_ttli_f16_kernel<0>, phi, luts, out, g,
                        stream);
}
