// Fused level step with SSD: BSI displacement -> clamped trilinear warp ->
// masked sum of squared differences, with no dense field in device memory.
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_fused.py:bsi_fused_pallas
// with sim=("ssd",) (_fused_kernel, _disp_block, _warp_block), dispatched by
// repro/kernels/ops.py:fused_similarity_loss.
//
// What bounds it on an H100: reading the fixed and moving volumes once.  At
// phantom1 (512, 228, 385) that is 2 x 180 MB, about 0.11 ms at 3.35 TB/s.
// The volumes fit neither shared memory nor the 50 MB L2, so they stay in
// device memory; the moving volume is read through the read-only cache, and
// the displaced samples of neighbouring voxels share its lines.
//
// What the design does about it: one thread block per block of tiles
// evaluates its displacement in the lerp form of bsi_ttli (bsi_common.cuh;
// the JAX kernel uses the separable form, the same function to fp32
// rounding), samples the moving volume at identity + displacement with fp32
// coordinates clamped to the volume exactly as core/ffd.py:trilinear_sample
// does, and sums (w - f)^2 over its voxels inside the volume.  The JAX
// kernel accumulates into one output block because TPU grid cells run in
// order; CUDA blocks do not, so each block writes one partial sum and a
// second launch sums the partials in a fixed order.  Both reductions are
// fixed trees: the result is deterministic and uses no float atomics.
#include "bsi_common.cuh"

namespace repro_torch {

__device__ __forceinline__ float sample_clamped(const float* __restrict__ vol, int X,
                                                int Y, int Z, float cx, float cy,
                                                float cz) {
  cx = fminf(fmaxf(cx, 0.f), (float)(X - 1));
  cy = fminf(fmaxf(cy, 0.f), (float)(Y - 1));
  cz = fminf(fmaxf(cz, 0.f), (float)(Z - 1));
  const float fx = floorf(cx), fy = floorf(cy), fz = floorf(cz);
  const float tx = cx - fx, ty = cy - fy, tz = cz - fz;
  const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
  const int x1 = min(x0 + 1, X - 1), y1 = min(y0 + 1, Y - 1), z1 = min(z0 + 1, Z - 1);
  auto at = [&](int x, int y, int z) {
    return __ldg(vol + ((size_t)x * Y + y) * Z + z);
  };
  const float c00 = at(x0, y0, z0) * (1.f - tx) + at(x1, y0, z0) * tx;
  const float c01 = at(x0, y0, z1) * (1.f - tx) + at(x1, y0, z1) * tx;
  const float c10 = at(x0, y1, z0) * (1.f - tx) + at(x1, y1, z0) * tx;
  const float c11 = at(x0, y1, z1) * (1.f - tx) + at(x1, y1, z1) * tx;
  const float c0 = c00 * (1.f - ty) + c10 * ty;
  const float c1 = c01 * (1.f - ty) + c11 * ty;
  return c0 * (1.f - tz) + c1 * tz;
}

// Fixed-order tree sum of one value per thread; thread 0 gets the total.
template <int N>
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
    __syncthreads();
  }
  return red[0];
}

__global__ void __launch_bounds__(kThreads)
    bsi_fused_ssd_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                         const float* __restrict__ mov, const float* __restrict__ fix,
                         float* __restrict__ partials, TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_xy(phi, luts, g, ti0, tj0, tk0, smem);

  const float* t0z = smem + 3 * (g.dx + g.dy);
  const float* t1z = t0z + g.dz;
  const float* sz = t1z + g.dz;
  const float* s_hy = smem + lut_floats(g) + window_floats(g);
  const int wz = g.bz + 3;
  const int BX = g.bx * g.dx, BY = g.by * g.dy, BZ = g.bz * g.dz;
  const int x0 = ti0 * g.dx, y0 = tj0 * g.dy, z0 = tk0 * g.dz;
  const int n = BX * BY * BZ;
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int zl = i % BZ;
    const int r = i / BZ;
    const int yl = r % BY;
    const int xl = r / BY;
    const int x = x0 + xl, y = y0 + yl, z = z0 + zl;
    if (x >= X || y >= Y || z >= Z) continue;
    const int tz = zl / g.dz, cz = zl - tz * g.dz;
    const float* p = s_hy + ((size_t)(xl * BY + yl) * wz + tz) * 3;
    const float u0 = lerp4(p[0], p[3], p[6], p[9], t0z[cz], t1z[cz], sz[cz]);
    const float u1 = lerp4(p[1], p[4], p[7], p[10], t0z[cz], t1z[cz], sz[cz]);
    const float u2 = lerp4(p[2], p[5], p[8], p[11], t0z[cz], t1z[cz], sz[cz]);
    const float w = sample_clamped(mov, X, Y, Z, (float)x + u0, (float)y + u1,
                                   (float)z + u2);
    const float e = w - __ldg(fix + ((size_t)x * Y + y) * Z + z);
    acc += e * e;
  }
  const float total = block_sum<kThreads>(acc, red);
  if (threadIdx.x == 0)
    partials[((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        total;
}

constexpr int kReduceThreads = 1024;

__global__ void __launch_bounds__(kReduceThreads)
    sum_partials_kernel(const float* __restrict__ partials, int n, float* out) {
  __shared__ float red[kReduceThreads];
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += partials[i];
  const float total = block_sum<kReduceThreads>(acc, red);
  if (threadIdx.x == 0) out[0] = total;
}

}  // namespace repro_torch

// phi: (nx, ny, nz, 3); mov, fix: (X, Y, Z); all float32 and contiguous.
// partials: n_partials floats, one per thread block (the caller sizes it with
// the same tile-block grid); out: 1 float, the sum of squared differences.
// Returns the first cudaError_t, or cudaErrorInvalidValue on a size mismatch.
extern "C" int bsi_fused_ssd_f32(const float* phi, const float* luts, const float* mov,
                                 const float* fix, float* partials, int n_partials,
                                 float* out, int nx, int ny, int nz, int dx, int dy,
                                 int dz, int X, int Y, int Z, int bx, int by, int bz,
                                 void* stream) {
  using namespace repro_torch;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  const dim3 grid = tile_grid(g, X, Y, Z);
  if ((long long)grid.x * grid.y * grid.z != n_partials) return (int)cudaErrorInvalidValue;
  const size_t smem = stage_smem_bytes(g);
  cudaError_t err = allow_smem(bsi_fused_ssd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  bsi_fused_ssd_kernel<<<grid, kThreads, smem, s>>>(phi, luts, mov, fix, partials, g, X,
                                                    Y, Z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kReduceThreads, 0, s>>>(partials, n_partials, out);
  return (int)cudaGetLastError();
}
