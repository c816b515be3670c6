// The staged forward BSI of bsi_ttli.cu and bsi_separable.cu: one thread
// block per (y tile, x tile, run of bz tiles along z), consecutive blocks on
// neighbouring y tiles; at phantom1 bz spans the volume's z, so a block
// writes whole (x, y) rows of the channels-last field, the rows of one x
// contiguous (kernels/bsi_ttli.py:forward_blocks picks bz).
//
// The x-y stage: a thread owns one (z control point, channel) slot q of the
// block's window, contiguous in the control grid, and reads its 16
// neighbours (l, m) straight from the grid (coalesced across the warp; the
// grid stays in L2).  It runs the x stage of each voxel offset a and the y
// stage of each (a, b) on them in registers and writes hy(a, b, q) to shared
// memory: the values and the order of operations of stage_xy in
// bsi_common.cuh, with each x stage computed once for all b.
//
// The z stage: a column's run in the block is P = bz * dz * c floats,
// position p = (z, channel).  What a position needs, its offset into the
// column's y-stage values and its voxel offset z % dz, depends on p alone;
// the block builds a table of both in shared memory (the z table, one int a
// position: offset << 16 | z % dz), each thread decoding its first position
// once and stepping to the rest with carries, and copies the z LUT beside
// it, so no loop over voxels divides.  The block walks its columns; in
// each, thread t takes the positions p = t - s, t - s + 256, ... with s the
// column's start modulo 32 floats, so every warp stores one whole aligned
// 128-byte line (a column's run starts anywhere: rows are Z * c floats,
// 4620 bytes at phantom1).
//
// The element type T of the grid and the field is float, __nv_bfloat16
// (bsi_ttli_bf16, bsi_separable_bf16) or __half (bsi_ttli_f16,
// bsi_separable_f16).  A bf16 or fp16 grid is widened as it is loaded; the
// LUTs (rounded to the grid's type on the host, passed as floats), the
// shared memory and the arithmetic stay float32, and each value is rounded
// once, to nearest even, at its store: the contract of
// core/interpolate.py, which the plain versions follow.  (The JAX package's
// TTLI kernel writes its lerps in phi's dtype, so interpreted on a CPU it
// rounds every lerp to bf16; this kernel does not copy that.)  A line of
// 2-byte values holds 64 of them, so in such a column thread t takes the
// pairs (2t - s, 2t - s + 1), (2t - s + 512, ...), s the column's start
// modulo 64 values: each pair is one aligned 4-byte store and a warp's 32
// pairs one aligned 128-byte line; a pair that straddles the run's start or
// end stores its one value inside (a run may start or end on an odd value).
//
// The fused ssd, stats and ncc kernels (bsi_fused.cu) run on the same
// blocks; in the lerp form they run the same x-y stage (fwd_xy_stage) and
// build their z table with the same stepping (fwd_z_positions, one position
// a voxel).
//
// Measurement builds (-DREPRO_FWD_SKIP=mask, launch/profile_forward.py):
// 1 leaves out the x-y stage, 2 the z stage's arithmetic and table (a
// constant is stored), 4 the stores; 8 the stores alone (1 and 2 together).
#pragma once

#include "bsi_common.cuh"

#ifndef REPRO_FWD_SKIP
#define REPRO_FWD_SKIP 0
#endif

namespace repro_torch {

struct FwdBlock {
  int nx, ny, nz, c;  // stored control points per axis, channels
  int dx, dy, dz;     // tile: voxels per control interval
  int bz;             // tiles per block along z
  int X, Y, Z;        // the volume written
};

// A column's run in a block: bz tiles of z, channels fastest.
__host__ __device__ inline int fwd_run(const FwdBlock& g) { return g.bz * g.dz * g.c; }
// y-stage values of a column: (bz + 3) z control points, channels fastest.
__host__ __device__ inline int fwd_column_floats(const FwdBlock& g) {
  return (g.bz + 3) * g.c;
}
// Shared memory, in floats: [z table (1 int a position) | z LUT (4 * dz
// floats, the most of either stage) | y-stage values of the dx * dy columns].
__host__ __device__ inline int fwd_head_floats(const FwdBlock& g) {
  return fwd_run(g) + 4 * g.dz;
}
__host__ __device__ inline size_t fwd_smem_bytes(const FwdBlock& g) {
  return sizeof(float) *
         ((size_t)fwd_head_floats(g) + (size_t)g.dx * g.dy * fwd_column_floats(g));
}

inline dim3 fwd_grid(const FwdBlock& g) {
  const int tz = (g.Z + g.dz - 1) / g.dz;
  return dim3((g.Y + g.dy - 1) / g.dy, (g.X + g.dx - 1) / g.dx, (tz + g.bz - 1) / g.bz);
}

// One output value of the z stage at position p of a column whose y-stage
// values start at h: its offset and voxel offset from the z table (offset <<
// 16 | z % dz; both fit, as the block's shared memory bounds them), its
// coefficients from the z LUT.
template <class S, int C>
__device__ __forceinline__ float z_value(const int* s_tab, const float* s_lz,
                                         const float* h, int c, int dz, int p) {
  if (C) c = C;
  const int e = s_tab[p];
  const float* hp = h + (e >> 16);
  return S::apply(s_lz, dz, e & 0xffff, hp[0], hp[c], hp[2 * c], hp[3 * c]);
}

// Each of this thread's positions of a run of P positions, c channels
// fastest, i = (z, ch) = threadIdx.x, + kThreads, ...: f(i, k, ch, r) with
// k = z / dz and r = z % dz, the first position decoded once and the rest
// stepped with carries, so no division runs in the loop.
template <typename F>
__device__ __forceinline__ void fwd_z_positions(int P, int c, int dz, F f) {
  const int zs = kThreads / c, cs = kThreads - zs * c;
  const int ks = zs / dz, rs = zs - ks * dz;
  int z = threadIdx.x / c, ch = threadIdx.x - z * c;
  int k = z / dz, r = z - k * dz;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    f(i, k, ch, r);
    ch += cs;
    const int carry = ch >= c;  // cs < c: at most one z
    ch -= carry * c;
    r += rs + carry;
    k += ks;
    if (r >= dz) r -= dz, ++k;  // rs + carry <= dz: at most one tile
  }
}

// The z table of a run of P positions, c channels fastest: position (z, ch)
// holds (z / dz * c + ch) << 16 | z % dz.  Does not synchronise.
__device__ __forceinline__ void fwd_z_table(int* s_tab, int P, int c, int dz) {
  fwd_z_positions(P, c, dz, [=](int i, int k, int ch, int r) {
    s_tab[i] = (k * c + ch) << 16 | r;
  });
}

// The x-y stage of the block on x tile ti, y tile tj and the bz tiles along
// z from tk0: slot q = (z control point tk0 + q / c, channel q % c) of
// column (a, b) to s_hy[(a * dy + b) * fwd_column_floats(g) + q], with c = C
// ? C : g.c; T the grid's element type.  The grid's x and y strides fit an
// int (the grid is small).  Does not synchronise.
template <class S, int C, typename T>
__device__ __forceinline__ void fwd_xy_stage(const T* __restrict__ phi,
                                             const float* __restrict__ luts,
                                             const FwdBlock& g, int ti, int tj, int tk0,
                                             float* s_hy) {
  const int c = C ? C : g.c;
  const int Q = fwd_column_floats(g);
  const float* lx = luts;
  const float* ly = lx + S::kLutRows * g.dx;
  const int ys = g.nz * c, xs = g.ny * ys;
  const int qmax = (g.nz - tk0) * c;  // slots inside the grid
  const T* src = phi + ((size_t)ti * g.ny + tj) * ys + (size_t)tk0 * c;
  for (int q = threadIdx.x; q < Q; q += blockDim.x) {
    float w[4][4];
#pragma unroll
    for (int l = 0; l < 4; ++l)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        w[l][m] = q < qmax ? to_float(src[l * xs + m * ys + q]) : 0.f;
    float* dst = s_hy + q;
    for (int a = 0; a < g.dx; ++a) {
      float h[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        h[m] = S::apply(lx, g.dx, a, w[0][m], w[1][m], w[2][m], w[3][m]);
      for (int b = 0; b < g.dy; ++b, dst += Q)
        *dst = S::apply(ly, g.dy, b, h[0], h[1], h[2], h[3]);
    }
  }
}

// luts: the LUTs of S for x, then y, then z, in device memory.  Needs
// fwd_smem_bytes(g) of shared memory.  C: the channels, fixed at compile
// time (3), or 0 to read g.c.  T: float, or __nv_bfloat16 or __half for a
// bf16 or fp16 grid and field.
template <class S, int C, typename T>
__device__ inline void forward_block(const T* __restrict__ phi,
                                     const float* __restrict__ luts,
                                     T* __restrict__ out, const FwdBlock& g,
                                     float* smem) {
  const int c = C ? C : g.c;
  const int tj = blockIdx.x, ti = blockIdx.y, tk0 = blockIdx.z * g.bz;
  const int P = fwd_run(g), Q = fwd_column_floats(g);
  int* s_tab = reinterpret_cast<int*>(smem);
  float* s_lz = smem + P;
  float* s_hy = smem + fwd_head_floats(g);
#if !(REPRO_FWD_SKIP & 10)
  const float* lz = luts + S::kLutRows * (g.dx + g.dy);
  fwd_z_table(s_tab, P, c, g.dz);
  for (int i = threadIdx.x; i < S::kLutRows * g.dz; i += blockDim.x) s_lz[i] = lz[i];
#endif

#if !(REPRO_FWD_SKIP & 9)
  fwd_xy_stage<S, C>(phi, luts, g, ti, tj, tk0, s_hy);
#endif
  __syncthreads();

  // z stage: the block's columns (xl, yl) inside the volume, yl fastest
  const int z0 = tk0 * g.dz;
  const int run = min(P, (g.Z - z0) * c);  // positions inside the volume
  const size_t zc = (size_t)g.Z * c;  // values of one (x, y) row of the field
  const int x0 = ti * g.dx, y0 = tj * g.dy;
  const int nxl = min(g.dx, g.X - x0), nyl = min(g.dy, g.Y - y0);
  for (int xl = 0; xl < nxl; ++xl)
    for (int yl = 0; yl < nyl; ++yl) {
      T* o = out + ((size_t)(x0 + xl) * g.Y + y0 + yl) * zc + (size_t)z0 * c;
      const float* h = s_hy + (xl * g.dy + yl) * Q;
      if constexpr (kIsFloat<T>) {
        // lanes before the column's start compute position 0 and store nothing
        const int s = (int)(reinterpret_cast<size_t>(o) / sizeof(float) & 31);
        for (int p = (int)threadIdx.x - s; p < run; p += kThreads) {
#if REPRO_FWD_SKIP & 10
          const float v = 0.f;
#else
          const float v = z_value<S, C>(s_tab, s_lz, h, c, g.dz, max(p, 0));
#endif
#if REPRO_FWD_SKIP & 4
          if (v == -1.25e-30f)  // never true here: keeps the arithmetic, drops the store
#endif
            if (p >= 0) o[p] = v;
        }
      } else {
        // bf16 or fp16: pairs of positions, a warp's pairs one aligned
        // line; a position outside the run computes a neighbour and stores
        // nothing
        const int s = (int)(reinterpret_cast<size_t>(o) / sizeof(T) & 63);
        for (int p = 2 * (int)threadIdx.x - s; p < run; p += 2 * kThreads) {
          const bool in0 = p >= 0, in1 = p + 1 >= 0 && p + 1 < run;
#if REPRO_FWD_SKIP & 10
          const float v0 = 0.f, v1 = 0.f;
#else
          const float v0 = z_value<S, C>(s_tab, s_lz, h, c, g.dz, max(p, 0));
          const float v1 = z_value<S, C>(s_tab, s_lz, h, c, g.dz, min(max(p + 1, 0), run - 1));
#endif
#if REPRO_FWD_SKIP & 4
          if (v0 == -1.25e-30f)  // never true here: keeps the arithmetic, drops the store
#endif
          {
            if (in0 && in1)
              store_pair(o + p, v0, v1);
            else if (in0)
              o[p] = store_as<T>(v0);
            else if (in1)
              o[p + 1] = store_as<T>(v1);
          }
        }
      }
    }
}

// The launch of a forward kernel of element type T, instantiated for 3 and
// any channels:
// checks the block, picks the instantiation and opts into its shared memory.
// Returns the launch's cudaError_t.
template <typename T, typename Kernel>
inline int launch_forward(Kernel c3, Kernel any, const T* phi, const float* luts, T* out,
                          const FwdBlock& g, void* stream) {
  if (g.bz < 1) return (int)cudaErrorInvalidValue;
  const Kernel kernel = g.c == 3 ? c3 : any;
  const size_t smem = fwd_smem_bytes(g);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<fwd_grid(g), kThreads, smem, (cudaStream_t)stream>>>(phi, luts, out, g);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch
