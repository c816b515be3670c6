// Shared device code of the BSI kernels: the control window, the lerp staging
// of the TTLI form and the 64-term sum of the matrix form.
//
// A thread block owns a block of (bx, by, bz) tiles and stages its
// (bx+3, by+3, bz+3, C) control window in shared memory (the counterpart of
// kernels/common.py:phi_window in the JAX package).  The lerp form also
// stages the LUTs and runs the x and y lerp stages of bsi_ttli once per
// (x voxel, y voxel, z control point) into shared memory; the z stage, per
// voxel, is left to the kernel: bsi_ttli writes the field, bsi_fused warps
// and scores it.  Every value is the same a + t*(b-a) chain as
// repro.core.interpolate.bsi_ttli, stage for stage.  The matrix form sums
// B[v, k] * window[tile + (l, m, n)] over k = (l*4 + m)*4 + n in that order.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace repro_torch {

constexpr int kThreads = 256;  // threads per block of every BSI kernel

__device__ __forceinline__ float lerp(float a, float b, float t) {
  return a + t * (b - a);
}

// lerp(lerp(p0, p1, t0), lerp(p2, p3, t1), s) == sum_l B_l * p_l
__device__ __forceinline__ float lerp4(float p0, float p1, float p2, float p3,
                                       float t0, float t1, float s) {
  return lerp(lerp(p0, p1, t0), lerp(p2, p3, t1), s);
}

struct TileBlock {
  int nx, ny, nz, c;  // stored control points per axis, channels
  int dx, dy, dz;     // tile: voxels per control interval
  int bx, by, bz;     // tiles per thread block
};

// Shared-memory layout, in floats: [LUTs | control window | y-stage values].
__host__ __device__ inline int lut_floats(const TileBlock& g) {
  return 3 * (g.dx + g.dy + g.dz);
}
__host__ __device__ inline int window_floats(const TileBlock& g) {
  return (g.bx + 3) * (g.by + 3) * (g.bz + 3) * g.c;
}
__host__ __device__ inline int hy_floats(const TileBlock& g) {
  return g.bx * g.dx * g.by * g.dy * (g.bz + 3) * g.c;
}
__host__ __device__ inline size_t stage_smem_bytes(const TileBlock& g) {
  return sizeof(float) * (size_t)(lut_floats(g) + window_floats(g) + hy_floats(g));
}

// The block's control window, (bx+3, by+3, bz+3, c) with channels fastest;
// points past the grid read 0 (only tiles outside the volume use them).
// Does not synchronise.
__device__ inline void stage_window(const float* __restrict__ phi, const TileBlock& g,
                                    int ti0, int tj0, int tk0, float* s_win) {
  const int wy = g.by + 3, wz = g.bz + 3;
  const int nwin = window_floats(g);
  for (int i = threadIdx.x; i < nwin; i += blockDim.x) {
    const int ch = i % g.c;
    int r = i / g.c;
    const int kz = r % wz;
    r /= wz;
    const int jy = r % wy;
    const int ix = r / wy;
    const int gi = ti0 + ix, gj = tj0 + jy, gk = tk0 + kz;
    float v = 0.f;
    if (gi < g.nx && gj < g.ny && gk < g.nz)
      v = phi[(((size_t)gi * g.ny + gj) * g.nz + gk) * g.c + ch];
    s_win[i] = v;
  }
}

// Matrix form: voxel offsets per tile and the (nv, 64) basis floats.
__host__ __device__ inline int tile_voxels(const TileBlock& g) {
  return g.dx * g.dy * g.dz;
}
__host__ __device__ inline int basis_floats(const TileBlock& g) {
  return 64 * tile_voxels(g);
}

// luts: (t0, t1, s) for x, then for y, then for z; 3*(dx+dy+dz) floats.
// After the call, hy(xl, yl, kz, ch) = smem[lut + window + ((xl*BY + yl)*(bz+3)
// + kz)*c + ch] with BY = by*dy, for the block's local voxels xl, yl and its
// local z control points kz.  Ends with __syncthreads().
__device__ inline void stage_xy(const float* __restrict__ phi,
                                const float* __restrict__ luts,
                                const TileBlock& g, int ti0, int tj0, int tk0,
                                float* smem) {
  float* s_lut = smem;
  float* s_win = smem + lut_floats(g);
  float* s_hy = s_win + window_floats(g);
  const int wy = g.by + 3, wz = g.bz + 3;

  for (int i = threadIdx.x; i < lut_floats(g); i += blockDim.x) s_lut[i] = luts[i];
  stage_window(phi, g, ti0, tj0, tk0, s_win);
  __syncthreads();

  const float* t0x = s_lut;
  const float* t1x = t0x + g.dx;
  const float* sx = t1x + g.dx;
  const float* t0y = sx + g.dx;
  const float* t1y = t0y + g.dy;
  const float* sy = t1y + g.dy;
  const int BY = g.by * g.dy;
  const int nhy = hy_floats(g);
  const int xstep = wy * wz * g.c;  // window stride of one x control point
  for (int i = threadIdx.x; i < nhy; i += blockDim.x) {
    const int ch = i % g.c;
    int r = i / g.c;
    const int kz = r % wz;
    r /= wz;
    const int yl = r % BY;
    const int xl = r / BY;
    const int tx = xl / g.dx, a = xl - tx * g.dx;
    const int ty = yl / g.dy, b = yl - ty * g.dy;
    float h[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const float* p = s_win + ((size_t)(tx * wy + ty + m) * wz + kz) * g.c + ch;
      h[m] = lerp4(p[0], p[xstep], p[2 * xstep], p[3 * xstep], t0x[a], t1x[a], sx[a]);
    }
    s_hy[i] = lerp4(h[0], h[1], h[2], h[3], t0y[b], t1y[b], sy[b]);
  }
  __syncthreads();
}

// Grid of thread blocks covering the tiles that hold voxels of (X, Y, Z).
inline dim3 tile_grid(const TileBlock& g, int X, int Y, int Z) {
  const int tx = (X + g.dx - 1) / g.dx, ty = (Y + g.dy - 1) / g.dy,
            tz = (Z + g.dz - 1) / g.dz;
  return dim3((tx + g.bx - 1) / g.bx, (ty + g.by - 1) / g.by, (tz + g.bz - 1) / g.bz);
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace repro_torch
