// Fused level step: BSI displacement -> clamped trilinear warp -> a similarity's
// partial sums, with no dense field and no warped volume in device memory.
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_fused.py:bsi_fused_pallas
// (_fused_kernel, _disp_block, _warp_block) in four of its variants, dispatched
// by repro/kernels/ops.py:fused_similarity_loss, in its five variants:
//   sim=("ssd",)    sum of (w - f)^2                          -> 1 lane
//   sim=("stats",)  sum, min, max and count of w              -> 4 lanes
//   sim=("ncc",)    sums of ab, aa, bb with a = w - mu_w,
//                   b = f - mu_f (the means from a device buffer) -> 3 lanes
//   sim=("nmi", bins, sigma_ratio, eps)  the (bins, bins) joint Parzen
//                   histogram sum_v wa(v) wb(v)^T            -> bins^2 lanes
//   sim=("lncc", w, eps)  sum and count of the local cc^2 over the VALID
//                   window positions                         -> 2 lanes
// Every sum runs over the voxels inside the volume only.  Each variant takes
// its displacement in either form of the JAX kernel's disp_form
// (_disp_block): the lerp form of bsi_ttli (kLerp, for "separable") or the
// Kronecker-basis sum of bsi_matmul (kMatmul, for "matmul"), a template
// parameter of every kernel.
//
// What bounds it on an H100: for ssd, stats and ncc, reading the volumes once
// (at phantom1, (512, 228, 385), 180 MB each: 0.05-0.11 ms at 3.35 TB/s).
// For nmi, the operations: the histogram is 2 bins^2 flops per voxel (2048 at
// 32 bins, 92 GFLOP at phantom1: 0.19 ms as one dense TF32 product at 495
// TFLOP/s, the least of its forms, launch/bounds.py:nmi_bound; 1.4 ms at 67
// TFLOP/s fp32; this kernel's three TF32 products take 0.56 ms) plus, per
// voxel and volume, the Gaussian weights of the bins within reach and their
// normalisation (at most 17 of 32 at the default sigma).  For lncc, the
// operations of five 3-axis box sums of w terms per voxel (9.1 GFLOP at
// window 9, 0.14 ms).  The matrix form adds 64 multiply-adds per voxel and
// channel (17.3 GFLOP, 0.26 ms).
//
// Built with -fmad=false (kernels/build.py): every multiply and add of the
// displacement and the warp rounds as in the plain version, so the warped
// samples equal it bit for bit; the NMI histogram runs on the tensor cores.
//
// What the design does about it: a thread block evaluates the displacement
// of its voxels in the lerp form of bsi_ttli (the JAX kernel uses the
// separable form, the same function to fp32 rounding) or the matrix form,
// samples the moving volume at identity + displacement with fp32
// coordinates clamped to the volume exactly as core/ffd.py:trilinear_sample
// does, and reduces its voxels to one partial row.  The JAX kernel
// accumulates into one output block because TPU grid cells run in order;
// CUDA blocks do not, so each block writes its row of K lanes and a second
// launch combines the rows lane by lane in a fixed order.  Every reduction
// is a fixed tree or a fixed loop: the results are deterministic and no
// float atomics are used.
//
// The lerp form's ssd and stats kernels (bsi_fused_walk_kernel) run on the
// blocks of the forward kernels (bsi_forward.cuh): a block owns one (x
// tile, y tile) and a run of bz tiles along z, the whole z at phantom1
// (kernels/bsi_fused.py:moment_blocks).  It stages the y-stage values of its
// dx * dy voxel columns with the forward kernels' x-y stage (fwd_xy_stage:
// each value once, no division) and a z table, one float4 a voxel of a
// column's run: its tile's offset into the column's y-stage values and the
// z LUT's three weights at z % dz (built by fwd_z_positions' stepping, no
// division).  Then it walks its columns in lines of 32 voxels: line l of
// column (a, b) is the voxels z = 32 l + lane - s, s the column's start in
// the streamed volume (the fixed one for ssd, the moving one for stats)
// modulo 32 floats, so each warp's reads of that volume are one aligned
// 128-byte line and its trilinear taps neighbours across the warp.  The
// block's lines, column after column, are dealt to its 8 warps in 8
// contiguous shares, none more than a line longer than another.  A voxel
// costs one 16-byte and twelve 4-byte shared loads and its nine z lerps,
// the clamped 8-tap sample and its sums; no loop over voxels divides.  At
// phantom1 the 8 taps' cache lines set the pace (PERF.md).  The sums'
// order: each thread folds its voxels in walk order, each warp its lanes by
// a fixed shuffle tree (lane i takes lane i + 16, then + 8, + 4, + 2, + 1),
// then thread 0 the warps in order, one barrier; stats' min, max and count
// are exact in any order.
//
// The matrix form stages the control window and the basis, transposed to
// (64, d^3) so that the threads of a warp, at consecutive voxel offsets, read
// consecutive banks; each thread sums its voxel's 64 terms per channel in the
// order k = 0..63, as kernels/bsi_matmul.py:plain does.
//
// The lncc kernel is a marching column.  A block owns a column of tiles, an
// Ey x Ez footprint in y and z and a chunk of Ex voxels along x, and marches
// along x through the Ex + w - 1 slices its windows reach, warping each y-z
// slice of (Ey + w - 1) x (Ez + w - 1) voxels once.  It marches along x, not
// z, because the volumes are stored z fastest: a y-z slice's rows are
// contiguous, so a warp's trilinear taps and fixed-volume reads coalesce,
// where an x-y slice would put every thread's taps in its own cache line.
// The warped and fixed values of the last w slices stay in a ring in shared
// memory; once w are in, each position's five moments (w, f, w^2, f^2, wf)
// are summed over the ring in x order, then over y, then over z, each a
// fold of the w terms in order (the order of
// core/similarity.py:uniform_filter), scaled by 1/w^3 into
// cc = cross^2 / (var_w var_f + eps) with the reference's formula
// (repro/kernels/bsi_fused.py:221-226); the block sums cc over its own
// positions that are VALID in the true volume.  So every position's cc is
// the float the plain version computes; only the order of the final sum
// over positions differs.  The displacement rounds as the other variants':
// the lerp form stages each slice's x stage two slices ahead and its x-y
// stage one slice ahead (double-buffered, so one barrier a slice separates
// them), the matrix form the basis and the control window.  The window of 9
// (the LNCC default) is a compile-time constant, so the sums unroll.
// kernels/bsi_fused.py:lncc_blocks sizes the column: two blocks an SM, at
// phantom1 (Ex + w - 1)(Ey + w - 1)(Ez + w - 1) / (Ex Ey Ez) = 2.2 warps
// per owned voxel (lerp; 2.7 matrix), where a cube of 10^3 owned voxels
// recomputing its halo on every axis would warp 5.8.  The matrix form's
// 64-term sum, 256 shared loads a warped voxel, is half its time.
//
// The nmi kernel: a block is two teams of 128 threads with barriers of
// their own, so that one team's weights stage can run beside the other's
// histogram stage; a team stages 64 voxels a round.  One thread per voxel
// and volume computes the voxel's normalised intensity and its Gaussian
// weights (the operation order of repro/core/similarity.py:nmi) and their
// normalisation, into bin-major shared memory, for the bins within
// kernels/bsi_fused.py:nmi_support of the nearest centre only (at most 17
// of 32 at the default sigma of half a bin).  The weights equal the
// untruncated kernel's bit for bit where two things hold.  (1) Every
// skipped weight is 0.0f: its exponent is below -104 (below -111 at a sigma
// of two bins), where a correctly rounded expf is 0.0f; tested on the CPU
// with torch's expf, and on the card it rests on CUDA's expf doing the
// same.  (2) Each of its two divisions, by markstein_div, is the true
// division's: checked, not proven (see markstein_div).  Then the team's
// warps form the round's (bins x 64) . (64 x bins) product Wa^T Wb on the
// tensor cores, mma.m16n8k8 TF32 with the 3xTF32 split (each weight as hi +
// lo tf32, the lo lo product dropped; the tf32 rounding in integer
// operations), each warp 2 of the 8 16 x 8 tiles at 32 bins, into float32
// sums per round; the teams' partial histograms are combined in a fixed
// order at the end.  The stride of the staged weights is 4 mod 32, so the
// fragment loads are free of bank conflicts.  At phantom1 the weights
// stage, the histogram stage and the warp with its staging still add up
// rather than overlap (PERF.md).
#include <math_constants.h>

#include "bsi_forward.cuh"

// REPRO_FUSED_SKIP: the parts of the lerp form's ssd and stats kernels left
// out in a measurement build (launch/profile_fused.py; the library is built
// with none): 1 the x-y stage, 2 the displacement (each voxel sampled at
// identity), 4 the gathers (the sample is the sum of the voxel's
// coordinates: the displacement stays, the moving volume is not read); 8
// all but the reduction (each thread's sums a constant).
#ifndef REPRO_FUSED_SKIP
#define REPRO_FUSED_SKIP 0
#endif

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

enum DispForm { kLerp = 0, kMatmul = 1 };

// Shared memory of the displacement stage, in bytes: the lerp staging of
// bsi_common.cuh, or the (64, d^3) transposed basis and the control window.
template <int F>
__host__ __device__ inline size_t disp_smem_bytes(const TileBlock& g) {
  if (F == kLerp) return stage_smem_bytes(g);
  return sizeof(float) * (size_t)(basis_floats(g) + window_floats(g));
}

// The (d^3, 64) basis, transposed to (64, d^3) so that the threads of a
// warp, at consecutive voxel offsets, read consecutive banks.  Does not
// synchronise.
__device__ inline void stage_basis(const float* __restrict__ tabs, const TileBlock& g,
                                   float* s_bt) {
  const int nv = tile_voxels(g);
  for (int i = threadIdx.x; i < 64 * nv; i += blockDim.x) {
    const int v = i / 64, k = i % 64;
    s_bt[k * nv + v] = tabs[i];
  }
}

// Stage what the displacement of the block's voxels needs; tabs: the lerp
// LUTs (kLerp) or the (d^3, 64) basis (kMatmul).  Ends with __syncthreads().
template <int F>
__device__ inline void stage_disp(const float* __restrict__ phi,
                                  const float* __restrict__ tabs, const TileBlock& g,
                                  int ti0, int tj0, int tk0, float* smem) {
  if (F == kLerp) {
    stage_xy(phi, tabs, g, ti0, tj0, tk0, smem);
    return;
  }
  stage_basis(tabs, g, smem);
  stage_window(phi, g, ti0, tj0, tk0, smem + basis_floats(g));
  __syncthreads();
}

// The z stage of the lerp form: the displacement at z offset cz of its tile,
// from p = hy(xl, yl, tz, 0), the 4 z control points' x-y stage values of
// the 3 channels (channels fastest).
// t0, t1, s: the z LUT's weights at the voxel's offset.
__device__ __forceinline__ void lerp_z(const float* p, float t0, float t1, float s,
                                       float* u) {
  u[0] = lerp4(p[0], p[3], p[6], p[9], t0, t1, s);
  u[1] = lerp4(p[1], p[4], p[7], p[10], t0, t1, s);
  u[2] = lerp4(p[2], p[5], p[8], p[11], t0, t1, s);
}
__device__ __forceinline__ void lerp_z(const float* p, const float* t0z, const float* t1z,
                                       const float* sz, int cz, float* u) {
  lerp_z(p, t0z[cz], t1z[cz], sz[cz], u);
}

// The matrix form's displacement of local voxel (xl, yl, zl): per channel
// the 64 terms B[v, k] * window[tile + (l, m, n)] summed in the order
// k = (l*4 + m)*4 + n, as kernels/bsi_matmul.py:plain sums them; s_bt: the
// (64, nv) basis, s_win: the (wx, wy, wz, 3) control window.
__device__ __forceinline__ void matmul_disp(const float* s_bt, const float* s_win, int nv,
                                            int wy, int wz, int dx, int dy, int dz,
                                            int xl, int yl, int zl, float* u) {
  const int tx = xl / dx, ty = yl / dy, tz = zl / dz;
  const int v = ((xl - tx * dx) * dy + yl - ty * dy) * dz + zl - tz * dz;
  const float* w0 = s_win + ((tx * wy + ty) * wz + tz) * 3;
  float u0 = 0.f, u1 = 0.f, u2 = 0.f;
#pragma unroll
  for (int k = 0; k < 64; ++k) {
    const float b = s_bt[k * nv + v];
    const float* p = w0 + (((k >> 4) * wy + ((k >> 2) & 3)) * wz + (k & 3)) * 3;
    u0 = u0 + b * p[0];
    u1 = u1 + b * p[1];
    u2 = u2 + b * p[2];
  }
  u[0] = u0;
  u[1] = u1;
  u[2] = u2;
}

// The block's voxels after stage_disp: local voxel i -> warped sample.
template <int F>
struct WarpBlock {
  const float* t0z;
  const float* t1z;
  const float* sz;
  const float* s_hy;
  const float* s_bt;   // matrix form: (64, nv) basis
  const float* s_win;  // matrix form: the control window
  int wy, wz, BX, BY, BZ, x0, y0, z0, dx, dy, dz, nv;
  int n;  // voxels of the block, inside the volume or not

  __device__ WarpBlock(const float* smem, const TileBlock& g, int ti0, int tj0,
                       int tk0) {
    t0z = smem + 3 * (g.dx + g.dy);
    t1z = t0z + g.dz;
    sz = t1z + g.dz;
    s_hy = smem + lut_floats(g) + window_floats(g);
    s_bt = smem;
    s_win = smem + basis_floats(g);
    wy = g.by + 3;
    wz = g.bz + 3;
    BX = g.bx * g.dx;
    BY = g.by * g.dy;
    BZ = g.bz * g.dz;
    x0 = ti0 * g.dx;
    y0 = tj0 * g.dy;
    z0 = tk0 * g.dz;
    dx = g.dx;
    dy = g.dy;
    dz = g.dz;
    nv = tile_voxels(g);
    n = BX * BY * BZ;
  }

  // False outside the volume; else the voxel's local coordinates and offset.
  __device__ __forceinline__ bool locate(int X, int Y, int Z, int i, int* xl, int* yl,
                                         int* zl, size_t* at) const {
    *zl = i % BZ;
    const int r = i / BZ;
    *yl = r % BY;
    *xl = r / BY;
    const int x = x0 + *xl, y = y0 + *yl, z = z0 + *zl;
    if (x >= X || y >= Y || z >= Z) return false;
    *at = ((size_t)x * Y + y) * Z + z;
    return true;
  }

  // The displacement of a local voxel.
  __device__ __forceinline__ void disp(int xl, int yl, int zl, float* u) const {
    if (F == kLerp) {
      const int tz = zl / dz, cz = zl - tz * dz;
      lerp_z(s_hy + ((size_t)(xl * BY + yl) * wz + tz) * 3, t0z, t1z, sz, cz, u);
      return;
    }
    matmul_disp(s_bt, s_win, nv, wy, wz, dx, dy, dz, xl, yl, zl, u);
  }

  // The moving volume sampled at identity + displacement of a local voxel.
  __device__ __forceinline__ float warp(const float* __restrict__ mov, int X, int Y,
                                        int Z, int xl, int yl, int zl) const {
    float u[3];
    disp(xl, yl, zl, u);
    return sample_clamped(mov, X, Y, Z, (float)(x0 + xl) + u[0], (float)(y0 + yl) + u[1],
                          (float)(z0 + zl) + u[2]);
  }

  // False outside the volume; else the warped sample and the voxel's offset.
  __device__ __forceinline__ bool sample(const float* __restrict__ mov, int X, int Y,
                                         int Z, int i, float* w, size_t* at) const {
    int xl, yl, zl;
    if (!locate(X, Y, Z, i, &xl, &yl, &zl, at)) return false;
    *w = warp(mov, X, Y, Z, xl, yl, zl);
    return true;
  }
};

struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};
struct MinOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fminf(a, b); }
};
struct MaxOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return fmaxf(a, b); }
};

// Fixed-order tree reduction of one value per thread; valid in thread 0.
template <int N, typename Op>
__device__ __forceinline__ float block_reduce(float v, float* red, Op op) {
  red[threadIdx.x] = v;
  __syncthreads();
#pragma unroll
  for (int s = N / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) red[threadIdx.x] = op(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  return red[0];
}

__device__ __forceinline__ size_t block_index() {
  return ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}

enum Moments { kSsd = 0, kStats = 1 };
constexpr int kWarps = kThreads / 32;

// The walk's shared memory: [z table (a float4 a voxel of a column's run) |
// y-stage values of the dx * dy columns (fwd_column_floats floats each)];
// g.c is 3.
__host__ __device__ inline int walk_run(const FwdBlock& g) { return g.bz * g.dz; }
__host__ __device__ inline size_t walk_smem_bytes(const FwdBlock& g) {
  return sizeof(float4) * (size_t)walk_run(g) +
         sizeof(float) * (size_t)g.dx * g.dy * fwd_column_floats(g);
}

// The lerp form's ssd (K = kSsd; partials row: the sum of (w - f)^2) and
// stats (K = kStats; row: sum, min, max, count of w) kernels on the forward
// kernels' blocks (see the header); luts: the lerp LUTs of x, then y, then z.
template <int K>
__global__ void __launch_bounds__(kThreads)
    bsi_fused_walk_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                          const float* __restrict__ mov, const float* __restrict__ fix,
                          float* __restrict__ partials, FwdBlock g) {
  extern __shared__ float4 smem4[];
  __shared__ float red[3][kWarps];
  __shared__ int redc[kWarps];
  float* smem = reinterpret_cast<float*>(smem4);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float sum = 0.f, lo = CUDART_INF_F, hi = -CUDART_INF_F;
  int cnt = 0;
#if REPRO_FUSED_SKIP & 8
  sum = lo = hi = (float)threadIdx.x;
  cnt = threadIdx.x;
#else
  const int tj = blockIdx.x, ti = blockIdx.y, tk0 = blockIdx.z * g.bz;
  const int R = walk_run(g), Q = fwd_column_floats(g);
  float* s_hy = smem + 4 * R;
  {
    // the z table: voxel z of a run -> (its tile's offset into the column's
    // y-stage values, as int bits; the z LUT's t0, t1, s at z % dz)
    const float* lz = luts + 3 * (g.dx + g.dy);
    const int dz = g.dz;
    fwd_z_positions(R, 1, dz, [=](int i, int k, int, int r) {
      smem4[i] = make_float4(__int_as_float(3 * k), lz[r], lz[dz + r], lz[2 * dz + r]);
    });
  }
#if !(REPRO_FUSED_SKIP & 1)
  fwd_xy_stage<LerpStage, 3>(phi, luts, g, ti, tj, tk0, s_hy);
#endif
  __syncthreads();

  // the block's columns (xl, yl) inside the volume, yl fastest, each L
  // lines; warp w walks lines [w * total / 8, (w + 1) * total / 8) of them
  const int x0 = ti * g.dx, y0 = tj * g.dy, z0 = tk0 * g.dz;
  const int run = min(R, g.Z - z0);  // voxels of a column inside the volume
  const int nyl = min(g.dy, g.Y - y0);
  const int L = (run + 62) / 32;  // the lines a run can touch, whatever its start
  const int total = min(g.dx, g.X - x0) * nyl * L;
  const int end = (warp + 1) * total / kWarps;
  const float* aligned = K == kSsd ? fix : mov;
  int line = warp * total / kWarps;
  int l = line % L, xl = line / L / nyl, yl = line / L % nyl;
  while (line < end) {
    const int n = min(L - l, end - line);  // lines of this column
    const size_t at = ((size_t)(x0 + xl) * g.Y + y0 + yl) * g.Z + z0;
    const float* h = s_hy + (xl * g.dy + yl) * Q;
    const int s = (int)(reinterpret_cast<size_t>(aligned + at) / sizeof(float) & 31);
    const float fx = (float)(x0 + xl), fy = (float)(y0 + yl);
    for (int p = 32 * l + lane - s, i = 0; i < n; ++i, p += 32) {
      if ((unsigned)p >= (unsigned)run) continue;  // before the start or past the end
#if REPRO_FUSED_SKIP & 2
      float u[3] = {0.f, 0.f, 0.f};
#else
      const float4 e = smem4[p];
      float u[3];
      lerp_z(h + __float_as_int(e.x), e.y, e.z, e.w, u);
#endif
      const float cx = fx + u[0], cy = fy + u[1], cz = (float)(z0 + p) + u[2];
#if REPRO_FUSED_SKIP & 4
      const float w = cx + cy + cz;
#else
      const float w = sample_clamped(mov, g.X, g.Y, g.Z, cx, cy, cz);
#endif
      if (K == kSsd) {
        const float d = w - __ldg(fix + at + p);
        sum += d * d;
      } else {
        sum += w;
        lo = fminf(lo, w);
        hi = fmaxf(hi, w);
        ++cnt;
      }
    }
    line += n;
    l = 0;
    if (++yl == nyl) yl = 0, ++xl;
  }
#endif

  // the warp's lanes by a fixed shuffle tree, then the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, o);
    if (K == kStats) {
      lo = fminf(lo, __shfl_down_sync(0xffffffffu, lo, o));
      hi = fmaxf(hi, __shfl_down_sync(0xffffffffu, hi, o));
      cnt += __shfl_down_sync(0xffffffffu, cnt, o);
    }
  }
  if (lane == 0) {
    red[0][warp] = sum;
    red[1][warp] = lo;
    red[2][warp] = hi;
    redc[warp] = cnt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    sum = red[0][0], lo = red[1][0], hi = red[2][0], cnt = redc[0];
    for (int w = 1; w < kWarps; ++w) {
      sum += red[0][w];
      lo = fminf(lo, red[1][w]);
      hi = fmaxf(hi, red[2][w]);
      cnt += redc[w];
    }
    if (K == kSsd) {
      partials[block_index()] = sum;
    } else {
      float* row = partials + 4 * block_index();
      row[0] = sum;
      row[1] = lo;
      row[2] = hi;
      row[3] = (float)cnt;  // at most a block's voxels: exact
    }
  }
}

// The matrix form's ssd kernel (the lerp form's is bsi_fused_walk_kernel).
template <int F>
__global__ void __launch_bounds__(kThreads)
    bsi_fused_ssd_kernel(const float* __restrict__ phi, const float* __restrict__ tabs,
                         const float* __restrict__ mov, const float* __restrict__ fix,
                         float* __restrict__ partials, TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_disp<F>(phi, tabs, g, ti0, tj0, tk0, smem);
  const WarpBlock<F> b(smem, g, ti0, tj0, tk0);
  float acc = 0.f;
  for (int i = threadIdx.x; i < b.n; i += blockDim.x) {
    float w;
    size_t at;
    if (!b.sample(mov, X, Y, Z, i, &w, &at)) continue;
    const float e = w - __ldg(fix + at);
    acc += e * e;
  }
  const float total = block_reduce<kThreads>(acc, red, SumOp());
  if (threadIdx.x == 0) partials[block_index()] = total;
}

// The matrix form's stats kernel (the lerp form's is bsi_fused_walk_kernel).
template <int F>
__global__ void __launch_bounds__(kThreads)
    bsi_fused_stats_kernel(const float* __restrict__ phi, const float* __restrict__ tabs,
                           const float* __restrict__ mov, float* __restrict__ partials,
                           TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_disp<F>(phi, tabs, g, ti0, tj0, tk0, smem);
  const WarpBlock<F> b(smem, g, ti0, tj0, tk0);
  float sum = 0.f, lo = CUDART_INF_F, hi = -CUDART_INF_F, cnt = 0.f;
  for (int i = threadIdx.x; i < b.n; i += blockDim.x) {
    float w;
    size_t at;
    if (!b.sample(mov, X, Y, Z, i, &w, &at)) continue;
    sum += w;
    lo = fminf(lo, w);
    hi = fmaxf(hi, w);
    cnt += 1.f;  // at most a block's voxels: exact
  }
  float* row = partials + 4 * block_index();
  const float s = block_reduce<kThreads>(sum, red, SumOp());
  if (threadIdx.x == 0) row[0] = s;
  const float mn = block_reduce<kThreads>(lo, red, MinOp());
  if (threadIdx.x == 0) row[1] = mn;
  const float mx = block_reduce<kThreads>(hi, red, MaxOp());
  if (threadIdx.x == 0) row[2] = mx;
  const float c = block_reduce<kThreads>(cnt, red, SumOp());
  if (threadIdx.x == 0) row[3] = c;
}

// scal: (mu_w, mu_f).
template <int F>
__global__ void __launch_bounds__(kThreads)
    bsi_fused_ncc_kernel(const float* __restrict__ phi, const float* __restrict__ tabs,
                         const float* __restrict__ mov, const float* __restrict__ fix,
                         const float* __restrict__ scal, float* __restrict__ partials,
                         TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_disp<F>(phi, tabs, g, ti0, tj0, tk0, smem);
  const WarpBlock<F> b(smem, g, ti0, tj0, tk0);
  const float mu_w = scal[0], mu_f = scal[1];
  float ab = 0.f, aa = 0.f, bb = 0.f;
  for (int i = threadIdx.x; i < b.n; i += blockDim.x) {
    float w;
    size_t at;
    if (!b.sample(mov, X, Y, Z, i, &w, &at)) continue;
    const float a = w - mu_w;
    const float c = __ldg(fix + at) - mu_f;
    ab += a * c;
    aa += a * a;
    bb += c * c;
  }
  float* row = partials + 3 * block_index();
  const float s0 = block_reduce<kThreads>(ab, red, SumOp());
  if (threadIdx.x == 0) row[0] = s0;
  const float s1 = block_reduce<kThreads>(aa, red, SumOp());
  if (threadIdx.x == 0) row[1] = s1;
  const float s2 = block_reduce<kThreads>(bb, red, SumOp());
  if (threadIdx.x == 0) row[2] = s2;
}

// An nmi block is two teams of kNmiTeam threads, each with its own staged
// rounds of kNmiChunk voxels and its own barriers, so that one team's
// weights stage runs beside the other's histogram stage.
constexpr int kNmiTeam = kThreads / 2;
constexpr int kNmiChunk = kNmiTeam / 2;     // voxels a team stages per round
constexpr int kNmiSteps = kNmiChunk / 8;    // mma k-steps of a round
// Row stride of the staged weights: = 4 (mod 32), so the 32 lanes of an mma
// fragment load, at rows g = lane / 4 and columns t = lane % 4, fall on 32
// distinct banks.
constexpr int kNmiStride = kNmiChunk + 4;
constexpr int kNmiMaxBins = 64;

// REPRO_NMI_STAGES: the nmi kernel's stages that run, bit 0 the Parzen
// weights (with bit 0 clear each evaluated weight is x itself: no expf, no
// division), bit 1 the histogram.  The library is built with both; only a
// measurement build (kernels/build.py:load_library(defines)) leaves one
// out, to time the other (chip_smoke.py).
#ifndef REPRO_NMI_STAGES
#define REPRO_NMI_STAGES 3
#endif

// bins padded to the mma tiles: the (BP, BP) histogram is MT x NT tiles of
// 16 x 8 cells.  Each of a team's 4 warps owns MTW row tiles (row slice ms
// of MS) and NTW = 2 column tiles (column slice ns of NS) over all k-steps
// of the team's rounds; the two teams' partial histograms are combined in
// a fixed order at the end.  At 32 bins a warp's tiles are 1 x 2 (16
// accumulators, so that four blocks share an SM), at 64 bins 4 x 2.
__host__ __device__ constexpr int nmi_padded_bins(int bins) { return bins <= 32 ? 32 : 64; }

template <int BP>
struct NmiLayout {
  static constexpr int MT = BP / 16, NT = BP / 8;
  static constexpr int MTW = BP > 32 ? MT : 1, NTW = 2;
  static constexpr int MS = MT / MTW, NS = NT / NTW;
  static_assert(MS * NS == kNmiTeam / 32, "one (row, column slice) a warp of a team");
};

// Shared floats after the displacement staging: kNmiMaxBins centres, then
// per team the two (BP, kNmiStride) weight matrices; the teams' combine
// reuses them (2 BP * BP floats).
__host__ __device__ inline int nmi_extra_floats(int bins) {
  return kNmiMaxBins + 2 * 2 * nmi_padded_bins(bins) * kNmiStride;
}

// The team's barrier (ids 1 and 2; 0 is __syncthreads).
__device__ __forceinline__ void team_sync(int team) {
  asm volatile("bar.sync %0, %1;" ::"r"(team + 1), "r"(kNmiTeam) : "memory");
}

// The bins whose Parzen weight can be non-zero: those within `support` bins
// of the centre nearest x (kernels/bsi_fused.py:nmi_support_range); every
// bin for a NaN x.
__device__ __forceinline__ void nmi_support_range(float x, int bins, int support, int* lo,
                                                  int* hi) {
  if (x != x) {
    *lo = 0;
    *hi = bins - 1;
    return;
  }
  const float t = fminf(fmaxf(x * (float)(bins - 1), 0.f), (float)(bins - 1));
  const int k0 = __float2int_rn(t);
  *lo = max(k0 - support, 0);
  *hi = min(k0 + support, bins - 1);
}

// n / y as q0 = n r, q = q0 + (n - q0 y) r with r = 1/y correctly rounded:
// two FMAs and no reciprocal.  Markstein's theorem makes q the correctly
// rounded quotient, the true division's, when q0 is within an ulp of n / y
// and the steps stay normal; q0 = n r can be up to 1.5 ulps off, so for
// these uses it is checked, not proven (tests/test_torch_nmi_support.py, in
// exact arithmetic): for every float32 numerator of a weight that is
// neither 0 nor 1 at the default sigma of 0.5 / 31, and on samples for
// other sigmas and for the normalisation.
__device__ __forceinline__ float markstein_div(float n, float y, float r) {
  const float q0 = __fmul_rn(n, r);
  return __fmaf_rn(__fmaf_rn(-q0, y, n), r, q0);
}

// expf(-d^2 / 2) with d = (x - c) / sigma by markstein_div, for |x| <= 2^20
// and sigma in [2^-20, 2^20] (the caller's test), where its steps stay
// normal wherever |d| >= 2^-75; below, the weight is 1 either way.
__device__ __forceinline__ float parzen_exp(float x, float c, float sigma, float rcp) {
  const float d = markstein_div(x - c, sigma, rcp);
  return expf(-0.5f * (d * d));
}

// Weights at or above this are normalised by markstein_div with sum + eps
// in [2^-20, 2^20], where its steps stay normal; smaller ones by the true
// division.  The weights at or above it are the bins nearest x, one run of
// k.
constexpr float kNmiMarksteinMin = 0x1p-100f;

// scal: (lo_w, hi_w, lo_f, hi_f); centres: bins floats; support: the
// half-width of the evaluated bins (kernels/bsi_fused.py:nmi_support).
//
// The block's voxels are dealt to its two teams in rounds of kNmiChunk,
// alternately.  Per round, the weights stage: one thread per (voxel,
// volume) computes the voxel's normalised intensity x and, over the bins
// within `support` of the centre nearest x only, its Gaussian weights with
// the operations of repro/core/similarity.py:nmi in their order and
// rounding (the division by sigma, expf, the row sum in increasing k from
// 0, the normalising division by sum + eps; both divisions by
// markstein_div within its ranges, the true division outside them), into
// bin-major shared memory; it
// zeroes the rows of its column that the last round wrote and this one does
// not.  Outside the support every weight is 0.0f in the untruncated
// computation too (see the header), and a +0.0f changes neither the row sum
// nor a histogram cell.  Then the
// histogram stage: each of the team's warps forms its tiles of Wa^T Wb over
// the round's k-steps with mma.m16n8k8 TF32 in the 3xTF32 split (lo hi + hi
// lo + hi hi), each round from zero into its float32 sums: the tensor cores
// round their accumulation down, which over a block's voxels in one
// accumulator biases the histogram by about 1e-5.
template <int F, int BP>
__global__ void __launch_bounds__(kThreads, BP > 32 ? 2 : (F == kLerp ? 4 : 3))
    bsi_fused_nmi_kernel(const float* __restrict__ phi, const float* __restrict__ tabs,
                         const float* __restrict__ mov, const float* __restrict__ fix,
                         const float* __restrict__ scal,
                         const float* __restrict__ centres, float* __restrict__ partials,
                         TileBlock g, int X, int Y, int Z, int bins, int support,
                         float sigma, float eps) {
  using L = NmiLayout<BP>;
  extern __shared__ float smem[];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_disp<F>(phi, tabs, g, ti0, tj0, tk0, smem);
  const WarpBlock<F> b(smem, g, ti0, tj0, tk0);

  const int team = threadIdx.x / kNmiTeam, tt = threadIdx.x % kNmiTeam;
  float* s_c = smem + disp_smem_bytes<F>(g) / sizeof(float);
  float* sa = s_c + kNmiMaxBins + team * 2 * BP * kNmiStride;  // (BP, kNmiStride): wa
  float* sb = sa + BP * kNmiStride;  // (BP, kNmiStride): wb, both bin-major
  for (int k = threadIdx.x; k < bins; k += blockDim.x) s_c[k] = centres[k];
  for (int k = tt; k < 2 * BP * kNmiStride; k += kNmiTeam) sa[k] = 0.f;

  const float lo_w = scal[0], lo_f = scal[2];
  const float rw = fmaxf(scal[1] - scal[0], 1e-8f);
  const float rf = fmaxf(scal[3] - scal[2], 1e-8f);
  const float rcp = __frcp_rn(sigma);
  const bool fast_sigma = sigma >= 0x1p-20f && sigma <= 0x1p20f;

  // the weights stage: one thread per (voxel of the round, volume); lo1..hi1
  // the rows its column holds from the last round
  const int side = tt / kNmiChunk;  // 0: warped moving, 1: fixed
  const int v = tt % kNmiChunk;
  float* col = (side == 0 ? sa : sb) + v;
  int lo1 = 0, hi1 = -1;
  // the histogram stage: fragment row g, column t; row slice ms, column
  // slice ns
  const int warp = tt / 32, lane = tt % 32;
  const int gr = lane / 4, t = lane % 4;
  const int ms = warp / L::NS, ns = warp % L::NS;
  float acc[L::MTW][L::NTW][4] = {};
  // this thread's local voxel (xl, yl, zl), index c0 + v of the block's
  // voxels in the round at c0, stepped 2 kNmiChunk voxels (the other team's
  // round between) without divisions
  const int i0 = team * kNmiChunk + v, step = 2 * kNmiChunk;
  int zl = i0 % b.BZ, yl = i0 / b.BZ % b.BY, xl = i0 / (b.BZ * b.BY);
  const int dz = step % b.BZ, dy = step / b.BZ % b.BY, dx = step / (b.BZ * b.BY);
  __syncthreads();  // centres staged, weights zeroed

  for (int c0 = team * kNmiChunk; c0 < b.n; c0 += step) {
    int lo = 0, hi = -1;
    const int xg = b.x0 + xl, yg = b.y0 + yl, zg = b.z0 + zl;
    if (xl < b.BX && xg < X && yg < Y && zg < Z) {
      const float x = side == 0
                          ? (b.warp(mov, X, Y, Z, xl, yl, zl) - lo_w) / rw
                          : (__ldg(fix + ((size_t)xg * Y + yg) * Z + zg) - lo_f) / rf;
      nmi_support_range(x, bins, support, &lo, &hi);
      if (REPRO_NMI_STAGES & 1) {
        float sum = 0.f;
        // ka..kb: the run of weights >= kNmiMarksteinMin; split: not one run
        int ka = hi + 1, kb = lo - 1;
        bool below = false, split = false;
        if (fast_sigma && fabsf(x) <= 0x1p20f) {
#pragma unroll 2
          for (int k = lo; k <= hi; ++k) {
            const float e = parzen_exp(x, s_c[k], sigma, rcp);
            col[k * kNmiStride] = e;
            sum += e;
            if (e >= kNmiMarksteinMin) {
              split = split || below;
              ka = min(ka, k);
              kb = k;
            } else {
              below = below || kb >= lo;
            }
          }
        } else {
          for (int k = lo; k <= hi; ++k) {
            const float d = (x - s_c[k]) / sigma;
            const float e = expf(-0.5f * (d * d));
            col[k * kNmiStride] = e;
            sum += e;
          }
        }
        const float den = sum + eps;
        if (split || !(den >= 0x1p-20f && den <= 0x1p20f)) ka = hi + 1, kb = hi;
        const float rd = __frcp_rn(den);
        for (int k = lo; k < ka; ++k) col[k * kNmiStride] = col[k * kNmiStride] / den;
#pragma unroll 2
        for (int k = ka; k <= kb; ++k)
          col[k * kNmiStride] = markstein_div(col[k * kNmiStride], den, rd);
        for (int k = max(kb + 1, ka); k <= hi; ++k)
          col[k * kNmiStride] = col[k * kNmiStride] / den;
      } else {
        for (int k = lo; k <= hi; ++k) col[k * kNmiStride] = x;
      }
    }
    // zero the rows the last round wrote and this one does not
    for (int k = lo1; k <= hi1 && k < lo; ++k) col[k * kNmiStride] = 0.f;
    for (int k = max(lo1, hi + 1); k <= hi1; ++k) col[k * kNmiStride] = 0.f;
    lo1 = lo;
    hi1 = hi;
    zl += dz;
    if (zl >= b.BZ) zl -= b.BZ, ++yl;
    yl += dy;
    if (yl >= b.BY) yl -= b.BY, ++xl;
    xl += dx;
    team_sync(team);
    if (REPRO_NMI_STAGES & 2) {
      float c[L::MTW][L::NTW][4] = {};
#pragma unroll
      for (int ks = 0; ks < kNmiSteps; ++ks) {
        const int k0 = ks * 8 + t;
        unsigned ah[L::MTW][4], al[L::MTW][4];
#pragma unroll
        for (int ii = 0; ii < L::MTW; ++ii) {
          const float* p = sa + ((ms * L::MTW + ii) * 16 + gr) * kNmiStride + k0;
          split_tf32(p[0], &ah[ii][0], &al[ii][0]);
          split_tf32(p[8 * kNmiStride], &ah[ii][1], &al[ii][1]);
          split_tf32(p[4], &ah[ii][2], &al[ii][2]);
          split_tf32(p[8 * kNmiStride + 4], &ah[ii][3], &al[ii][3]);
        }
#pragma unroll
        for (int j = 0; j < L::NTW; ++j) {
          const float* q = sb + ((ns * L::NTW + j) * 8 + gr) * kNmiStride + k0;
          unsigned bh[2], bl[2];
          split_tf32(q[0], &bh[0], &bl[0]);
          split_tf32(q[4], &bh[1], &bl[1]);
#pragma unroll
          for (int ii = 0; ii < L::MTW; ++ii) {
            mma_tf32(c[ii][j], al[ii], bh);
            mma_tf32(c[ii][j], ah[ii], bl);
            mma_tf32(c[ii][j], ah[ii], bh);
          }
        }
      }
#pragma unroll
      for (int ii = 0; ii < L::MTW; ++ii)
#pragma unroll
        for (int j = 0; j < L::NTW; ++j)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[ii][j][r] = acc[ii][j][r] + c[ii][j][r];
    }
    team_sync(team);
  }

  // combine the teams in a fixed order; cells past `bins` are dropped.
  // Accumulator r of tile (ii, j) holds cell ((ms*MTW + ii)*16 + g +
  // 8*(r/2), (ns*NTW + j)*8 + 2t + r%2).
  __syncthreads();
  float* comb = s_c + kNmiMaxBins;  // (2, BP, BP), over both teams' weights
#pragma unroll
  for (int ii = 0; ii < L::MTW; ++ii)
#pragma unroll
    for (int j = 0; j < L::NTW; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int ci = (ms * L::MTW + ii) * 16 + gr + 8 * (r / 2);
        const int cj = (ns * L::NTW + j) * 8 + 2 * t + r % 2;
        comb[(team * BP + ci) * BP + cj] = acc[ii][j][r];
      }
  __syncthreads();
  float* out = partials + block_index() * bins * bins;
  for (int cell = threadIdx.x; cell < bins * bins; cell += blockDim.x) {
    const int ci = cell / bins, cj = cell % bins;
    out[cell] = comb[ci * BP + cj] + comb[(BP + ci) * BP + cj];
  }
}

// The lncc kernel's column: a block owns (ox, oy, oz) tiles, E voxels per
// axis, and stages S = E + win - 1 per axis.  Its shared memory, in floats:
// the displacement's constants (disp_floats), then the ring of the last
// `win` warped and fixed y-z slices (win * P floats each, P = Sy * Sz), the
// slice's x sums of the five moments (5 * P) and their y sums (5 * Ey * Sz).
// The lerp form's constants are its LUTs, the control window of the staged
// tiles, two x-stage planes (by + 3, bz + 3, 3) and two x-y stage planes
// (Sy, bz + 3, 3); the matrix form's the (64, d^3) basis and the control
// window.  g: the staged tiles per block.
struct LnccColumn {
  int Ex, Ey, Ez, Sy, Sz, P;
  size_t hx_floats, hy_floats, disp_floats, floats;

  template <int F>
  __host__ __device__ static LnccColumn make(const TileBlock& g, int ox, int oy, int oz,
                                             int win) {
    LnccColumn L;
    L.Ex = ox * g.dx;
    L.Ey = oy * g.dy;
    L.Ez = oz * g.dz;
    L.Sy = L.Ey + win - 1;
    L.Sz = L.Ez + win - 1;
    L.P = L.Sy * L.Sz;
    L.hx_floats = (size_t)(g.by + 3) * (g.bz + 3) * 3;
    L.hy_floats = (size_t)L.Sy * (g.bz + 3) * 3;
    L.disp_floats =
        F == kLerp ? lut_floats(g) + window_floats(g) + 2 * (L.hx_floats + L.hy_floats)
                   : (size_t)basis_floats(g) + window_floats(g);
    L.floats = L.disp_floats + (size_t)(2 * win + 5) * L.P + 5 * (size_t)L.Ey * L.Sz;
    return L;
  }
};

// inv: 1 / win^3 in float32.  partials row: (sum cc, count) of the block's
// own VALID positions.
//
// The block marches along x through its staged slices.  Each step warps one
// y-z slice, the rows of which lie along z in memory, into the ring, the
// same thread per position every step.  Once `win` slices are in, the thread
// sums the ring in x order for its positions, a = 0..win-1; then the y sums
// and the z sums of the slice's own positions follow, each a fold of `win`
// terms in order, as core/similarity.py:uniform_filter sums them.  The lerp
// form stages the x stage two slices ahead and the x-y stage one slice
// ahead, each double-buffered, so one barrier a step separates them.  W: the
// window where it is a compile-time constant (the sums' loops unroll and
// their loads go out together), else 0 and the window is win_arg.
template <int F, int W>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_fused_lncc_kernel(const float* __restrict__ phi, const float* __restrict__ tabs,
                          const float* __restrict__ mov, const float* __restrict__ fix,
                          float* __restrict__ partials, TileBlock g, int ox, int oy,
                          int oz, int X, int Y, int Z, int win_arg, float inv, float eps) {
  const int win = W > 0 ? W : win_arg;
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const LnccColumn L = LnccColumn::make<F>(g, ox, oy, oz, win);
  const int ti0 = blockIdx.x * ox, tj0 = blockIdx.y * oy, tk0 = blockIdx.z * oz;
  const int x0 = ti0 * g.dx, y0 = tj0 * g.dy, z0 = tk0 * g.dz;
  // the own VALID positions: nout slices of yv x zv; the staged ny x nz
  // positions of a slice all lie in the volume
  const int nout = min(L.Ex, X - win + 1 - x0);
  const int yv = min(L.Ey, Y - win + 1 - y0);
  const int zv = min(L.Ez, Z - win + 1 - z0);
  float acc = 0.f, cnt = 0.f;
  if (nout > 0 && yv > 0 && zv > 0) {
    const int ny = yv + win - 1, nz = zv + win - 1, np = ny * nz;
    const int wy = g.by + 3, wz = g.bz + 3, nv = tile_voxels(g);
    // the lerp form's constants and its x- and x-y-stage planes, each
    // double-buffered; the matrix form's window follows its basis
    const float* lx = smem;
    const float* ly = lx + 3 * g.dx;
    const float* t0z = ly + 3 * g.dy;
    const float* t1z = t0z + g.dz;
    const float* sz = t1z + g.dz;
    float* s_win = smem + (F == kLerp ? lut_floats(g) : basis_floats(g));
    float* hx0 = s_win + window_floats(g);
    float* hx1 = hx0 + L.hx_floats;
    float* hy0 = hx1 + L.hx_floats;
    float* hy1 = hy0 + L.hy_floats;
    if (F == kLerp) {
      for (int i = threadIdx.x; i < lut_floats(g); i += blockDim.x) smem[i] = tabs[i];
    } else {
      stage_basis(tabs, g, smem);
    }
    stage_window(phi, g, ti0, tj0, tk0, s_win);
    float* ring_w = smem + L.disp_floats;
    float* ring_f = ring_w + (size_t)win * L.P;
    float* xs = ring_f + (size_t)win * L.P;
    float* ys = xs + 5 * (size_t)L.P;
    const size_t ysm = (size_t)L.Ey * L.Sz;  // moment stride of the y sums

    // the lerp form's stages of slice s, as stage_xy computes them: the x
    // stage hx(ky, kz, ch) of the y and z control points, then the y stage
    // hy(yl, kz, ch) of the staged y voxels
    const int nky = (ny - 1) / g.dy + 4, nkz = (nz - 1) / g.dz + 4;
    auto stage_hx = [&](int s, float* out) {
      const int tx = s / g.dx, a = s - tx * g.dx;
      const int xstep = wy * wz * 3;
      for (int j = threadIdx.x; j < nky * nkz * 3; j += blockDim.x) {
        const int ch = j % 3, r = j / 3;
        const int kz = r % nkz, ky = r / nkz;
        const float* p = s_win + ((tx * wy + ky) * wz + kz) * 3 + ch;
        out[(ky * wz + kz) * 3 + ch] =
            LerpStage::apply(lx, g.dx, a, p[0], p[xstep], p[2 * xstep], p[3 * xstep]);
      }
    };
    auto stage_hy = [&](const float* in, float* out) {
      const int ystep = wz * 3;
      for (int j = threadIdx.x; j < ny * nkz * 3; j += blockDim.x) {
        const int ch = j % 3, r = j / 3;
        const int kz = r % nkz, yl = r / nkz;
        const int ty = yl / g.dy, b = yl - ty * g.dy;
        const float* p = in + (ty * wz + kz) * 3 + ch;
        out[(yl * wz + kz) * 3 + ch] =
            LerpStage::apply(ly, g.dy, b, p[0], p[ystep], p[2 * ystep], p[3 * ystep]);
      }
    };
    const int nsl = nout + win - 1;
    __syncthreads();
    if (F == kLerp) {
      stage_hx(0, hx0);
      if (nsl > 1) stage_hx(1, hx1);
      __syncthreads();
      stage_hy(hx0, hy0);
      __syncthreads();
    }

    for (int s = 0; s < nsl; ++s) {
      const int slot = s % win;
      const bool out = s >= win - 1;  // slice s completes output slice s - win + 1
      float* rw = ring_w + (size_t)slot * L.P;
      float* rf = ring_f + (size_t)slot * L.P;
      const float* hys = (s & 1) ? hy1 : hy0;
      const size_t row = (size_t)(x0 + s) * Y + y0;
      for (int i = threadIdx.x; i < np; i += blockDim.x) {
        const int yl = i / nz, zl = i - yl * nz;
        float u[3];
        if (F == kLerp) {
          const int tz = zl / g.dz;
          lerp_z(hys + (yl * wz + tz) * 3, t0z, t1z, sz, zl - tz * g.dz, u);
        } else {
          matmul_disp(smem, s_win, nv, wy, wz, g.dx, g.dy, g.dz, s, yl, zl, u);
        }
        rw[i] = sample_clamped(mov, X, Y, Z, (float)(x0 + s) + u[0], (float)(y0 + yl) + u[1],
                               (float)(z0 + zl) + u[2]);
        rf[i] = __ldg(fix + (row + yl) * Z + z0 + zl);
      }
      if (out) {
        // x sums of the five moments over slices s - win + 1 .. s, in order;
        // the ring slots of position i are this thread's own
        for (int i = threadIdx.x; i < np; i += blockDim.x) {
          int sl = slot + 1 == win ? 0 : slot + 1;
          float a = ring_w[(size_t)sl * L.P + i], b = ring_f[(size_t)sl * L.P + i];
          float m0 = a, m1 = b, m2 = a * a, m3 = b * b, m4 = a * b;
#pragma unroll
          for (int t = 1; t < win; ++t) {
            sl = sl + 1 == win ? 0 : sl + 1;
            a = ring_w[(size_t)sl * L.P + i];
            b = ring_f[(size_t)sl * L.P + i];
            m0 = m0 + a;
            m1 = m1 + b;
            m2 = m2 + a * a;
            m3 = m3 + b * b;
            m4 = m4 + a * b;
          }
          xs[i] = m0;
          xs[L.P + i] = m1;
          xs[2 * L.P + i] = m2;
          xs[3 * L.P + i] = m3;
          xs[4 * L.P + i] = m4;
        }
      }
      if (F == kLerp) {
        if (s + 1 < nsl) stage_hy((s & 1) ? hx0 : hx1, (s & 1) ? hy0 : hy1);
        if (s + 2 < nsl) stage_hx(s + 2, (s & 1) ? hx1 : hx0);
      }
      __syncthreads();
      if (!out) continue;

      // y sums: (5, yv, nz), position (y, z) at y * nz + z
      for (int j = threadIdx.x; j < yv * nz; j += blockDim.x) {
#pragma unroll
        for (int m = 0; m < 5; ++m) {
          const float* q = xs + (size_t)m * L.P + j;
          float t = q[0];
#pragma unroll
          for (int c = 1; c < win; ++c) t = t + q[c * nz];
          ys[m * ysm + j] = t;
        }
      }
      __syncthreads();

      // z sums and the local cc of the slice's own VALID positions
      for (int j = threadIdx.x; j < yv * zv; j += blockDim.x) {
        const int y = j / zv, z = j - y * zv;
        float sm[5];
#pragma unroll
        for (int m = 0; m < 5; ++m) {
          const float* q = ys + m * ysm + y * nz + z;
          float t = q[0];
#pragma unroll
          for (int c = 1; c < win; ++c) t = t + q[c];
          sm[m] = t;
        }
        const float mu_w = sm[0] * inv, mu_f = sm[1] * inv;
        const float var_w = sm[2] * inv - mu_w * mu_w;
        const float var_f = sm[3] * inv - mu_f * mu_f;
        const float cross = sm[4] * inv - mu_w * mu_f;
        acc += cross * cross / (var_w * var_f + eps);
        cnt += 1.f;  // at most a block's positions: exact
      }
    }
  }
  float* row = partials + 2 * block_index();
  const float s0 = block_reduce<kThreads>(acc, red, SumOp());
  if (threadIdx.x == 0) row[0] = s0;
  const float s1 = block_reduce<kThreads>(cnt, red, SumOp());
  if (threadIdx.x == 0) row[1] = s1;
}

constexpr int kReduceThreads = 1024;
enum LaneOp { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };

// The row's lanes by `mode`: 0 sums only; 1 the stats row (sum, min, max,
// count); 2 the lncc row (sum, count).
__device__ __forceinline__ int lane_op(int lane, int mode) {
  if (mode == 1) return lane;
  if (mode == 2 && lane == 1) return kCount;
  return kSum;
}

// Combine n partial rows of K lanes, lane by lane, in a fixed order.  A block
// takes L lanes (a power of two up to 32) with 1024 / L threads per lane;
// each thread folds rows phase, phase + R, ... and a fixed tree folds the
// threads.  With K = 1 this is one block summing n values with 1024 threads.
// The count lane folds in 64-bit integers, so it is exact.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* __restrict__ partials, int n, int K, int L,
                           int mode, float* __restrict__ out) {
  __shared__ float red[kReduceThreads];
  __shared__ long long redc[kReduceThreads];
  const int R = kReduceThreads / L;
  const int lane = blockIdx.x * L + threadIdx.x % L;
  const int phase = threadIdx.x / L;
  const int op = lane < K ? lane_op(lane, mode) : kSum;
  float acc = op == kMin ? CUDART_INF_F : op == kMax ? -CUDART_INF_F : 0.f;
  long long cnt = 0;
  if (lane < K) {
#pragma unroll 4
    for (int row = phase; row < n; row += R) {
      const float v = partials[(size_t)row * K + lane];
      if (op == kSum) acc += v;
      else if (op == kMin) acc = fminf(acc, v);
      else if (op == kMax) acc = fmaxf(acc, v);
      else cnt += (long long)v;
    }
  }
  red[threadIdx.x] = acc;
  redc[threadIdx.x] = cnt;
  __syncthreads();
  for (int s = R / 2; s > 0; s >>= 1) {
    if (phase < s) {
      const int o = threadIdx.x + s * L;
      if (op == kSum) red[threadIdx.x] += red[o];
      else if (op == kMin) red[threadIdx.x] = fminf(red[threadIdx.x], red[o]);
      else if (op == kMax) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[o]);
      else redc[threadIdx.x] += redc[o];
    }
    __syncthreads();
  }
  if (phase == 0 && lane < K)
    out[lane] = op == kCount ? (float)redc[threadIdx.x] : red[threadIdx.x];
}

inline cudaError_t reduce_partials(const float* partials, int n, int K, int mode,
                                   float* out, cudaStream_t s) {
  int L = 1;
  while (L < K && L < 32) L *= 2;
  reduce_partials_kernel<<<(K + L - 1) / L, kReduceThreads, 0, s>>>(partials, n, K, L,
                                                                    mode, out);
  return cudaGetLastError();
}

// Launch `kernel` on `grid` with `smem` bytes of shared memory, then the
// lane-wise reduce.
template <typename Kernel, typename... Args>
inline int launch_fused(Kernel kernel, dim3 grid, size_t smem, int n_partials, int K,
                        int mode, const float* partials, float* out, void* stream,
                        Args... args) {
  if ((long long)grid.x * grid.y * grid.z != n_partials) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partials, n_partials, K, mode, out, s);
}

// The lerp form's ssd or stats kernel on the forward kernels' grid of g.
template <int K>
inline int launch_walk(const FwdBlock& g, int n_partials, float* partials, float* out,
                       void* stream, const float* phi, const float* luts,
                       const float* mov, const float* fix) {
  if (g.bz < 1) return (int)cudaErrorInvalidValue;
  return launch_fused(bsi_fused_walk_kernel<K>, fwd_grid(g), walk_smem_bytes(g), n_partials,
                      K == kSsd ? 1 : 4, K == kSsd ? 0 : 1, partials, out, stream, phi, luts,
                      mov, fix, partials, g);
}

// The lncc kernel on the column grid of `own`; the window of 9 (the LNCC
// default) runs the instantiation with the window fixed at compile time.
template <int F>
inline int launch_lncc(const TileBlock& g, const TileBlock& own, int X, int Y, int Z,
                       int win, int n_partials, float* partials, float* out, void* stream,
                       const float* phi, const float* tabs, const float* mov,
                       const float* fix, float inv, float eps) {
  const size_t smem =
      sizeof(float) * LnccColumn::make<F>(g, own.bx, own.by, own.bz, win).floats;
  auto kernel = win == 9 ? bsi_fused_lncc_kernel<F, 9> : bsi_fused_lncc_kernel<F, 0>;
  return launch_fused(kernel, tile_grid(own, X, Y, Z), smem, n_partials, 2, 2, partials,
                      out, stream, phi, tabs, mov, fix, partials, g, own.bx, own.by,
                      own.bz, X, Y, Z, win, inv, eps);
}

// The nmi kernel for `bins` (padded to 32 or 64) on the tile-block grid of g.
template <int F>
inline int launch_nmi(const TileBlock& g, int X, int Y, int Z, int n_partials,
                      float* partials, float* out, void* stream, const float* phi,
                      const float* tabs, const float* mov, const float* fix,
                      const float* scal, const float* centres, int bins, int support,
                      float sigma, float eps) {
  const size_t smem = disp_smem_bytes<F>(g) + sizeof(float) * nmi_extra_floats(bins);
  auto kernel = nmi_padded_bins(bins) == 32 ? bsi_fused_nmi_kernel<F, 32>
                                            : bsi_fused_nmi_kernel<F, 64>;
  return launch_fused(kernel, tile_grid(g, X, Y, Z), smem, n_partials, bins * bins, 0,
                      partials, out, stream, phi, tabs, mov, fix, scal, centres, partials,
                      g, X, Y, Z, bins, support, sigma, eps);
}

}  // namespace repro_torch

// Launch variant kernel K<kLerp> or K<kMatmul> on the tile-block grid of g
// with the displacement staging plus `extra_floats` of shared memory.
#define REPRO_LAUNCH_FUSED(K, form, extra_floats, n_partials, lanes, mode, ...)      \
  ((form) == kMatmul                                                                 \
       ? launch_fused(K<kMatmul>, tile_grid(g, X, Y, Z),                             \
                      disp_smem_bytes<kMatmul>(g) + sizeof(float) * (extra_floats),  \
                      n_partials, lanes, mode, partials, out, stream, __VA_ARGS__)   \
       : launch_fused(K<kLerp>, tile_grid(g, X, Y, Z),                               \
                      disp_smem_bytes<kLerp>(g) + sizeof(float) * (extra_floats),    \
                      n_partials, lanes, mode, partials, out, stream, __VA_ARGS__))

// Entry points.  phi: (nx, ny, nz, 3); mov, fix: (X, Y, Z); all float32 and
// contiguous.  tabs: the lerp LUTs (form 0) or the (dx*dy*dz, 64) basis
// (form 1).  partials: n_partials rows of K floats, one row per thread
// block (the caller sizes it with the same grid); out: K floats.  Each
// returns the first cudaError_t, or cudaErrorInvalidValue on a size
// mismatch or an unknown form.  (bx, by, bz): the tiles a block owns; the
// lerp form's ssd and stats take (1, 1, bz), the forward kernels' blocks
// (kernels/bsi_fused.py:moment_blocks).

// out: 1 float, the sum of squared differences.
extern "C" int bsi_fused_ssd_f32(const float* phi, const float* tabs, const float* mov,
                                 const float* fix, float* partials, int n_partials,
                                 float* out, int nx, int ny, int nz, int dx, int dy,
                                 int dz, int X, int Y, int Z, int bx, int by, int bz,
                                 int form, void* stream) {
  using namespace repro_torch;
  if (form == kLerp) {
    if (bx != 1 || by != 1) return (int)cudaErrorInvalidValue;
    const FwdBlock g{nx, ny, nz, 3, dx, dy, dz, bz, X, Y, Z};
    return launch_walk<kSsd>(g, n_partials, partials, out, stream, phi, tabs, mov, fix);
  }
  if (form != kMatmul) return (int)cudaErrorInvalidValue;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  return launch_fused(bsi_fused_ssd_kernel<kMatmul>, tile_grid(g, X, Y, Z),
                      disp_smem_bytes<kMatmul>(g), n_partials, 1, 0, partials, out, stream,
                      phi, tabs, mov, fix, partials, g, X, Y, Z);
}

// out: 4 floats, the sum, min, max and count of the warped volume.
extern "C" int bsi_fused_stats_f32(const float* phi, const float* tabs, const float* mov,
                                   float* partials, int n_partials, float* out, int nx,
                                   int ny, int nz, int dx, int dy, int dz, int X, int Y,
                                   int Z, int bx, int by, int bz, int form,
                                   void* stream) {
  using namespace repro_torch;
  if (form == kLerp) {
    if (bx != 1 || by != 1) return (int)cudaErrorInvalidValue;
    const FwdBlock g{nx, ny, nz, 3, dx, dy, dz, bz, X, Y, Z};
    return launch_walk<kStats>(g, n_partials, partials, out, stream, phi, tabs, mov,
                               (const float*)nullptr);
  }
  if (form != kMatmul) return (int)cudaErrorInvalidValue;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  return launch_fused(bsi_fused_stats_kernel<kMatmul>, tile_grid(g, X, Y, Z),
                      disp_smem_bytes<kMatmul>(g), n_partials, 4, 1, partials, out, stream,
                      phi, tabs, mov, partials, g, X, Y, Z);
}

// scal: (mu_w, mu_f); out: 3 floats, sum ab, sum aa, sum bb.
extern "C" int bsi_fused_ncc_f32(const float* phi, const float* tabs, const float* mov,
                                 const float* fix, const float* scal, float* partials,
                                 int n_partials, float* out, int nx, int ny, int nz,
                                 int dx, int dy, int dz, int X, int Y, int Z, int bx,
                                 int by, int bz, int form, void* stream) {
  using namespace repro_torch;
  if (form != kLerp && form != kMatmul) return (int)cudaErrorInvalidValue;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  return REPRO_LAUNCH_FUSED(bsi_fused_ncc_kernel, form, 0, n_partials, 3, 0, phi, tabs,
                            mov, fix, scal, partials, g, X, Y, Z);
}

// scal: (lo_w, hi_w, lo_f, hi_f); centres: bins floats; 2 <= bins <= 64;
// support: the half-width in bins of the evaluated Parzen weights
// (kernels/bsi_fused.py:nmi_support), >= 0.  out: bins * bins floats, the
// joint histogram (row: moving bin).
extern "C" int bsi_fused_nmi_f32(const float* phi, const float* tabs, const float* mov,
                                 const float* fix, const float* scal,
                                 const float* centres, float* partials, int n_partials,
                                 float* out, int nx, int ny, int nz, int dx, int dy,
                                 int dz, int X, int Y, int Z, int bx, int by, int bz,
                                 int form, int bins, int support, float sigma, float eps,
                                 void* stream) {
  using namespace repro_torch;
  if (form != kLerp && form != kMatmul) return (int)cudaErrorInvalidValue;
  if (bins < 2 || bins > kNmiMaxBins || support < 0) return (int)cudaErrorInvalidValue;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  if (form == kMatmul)
    return launch_nmi<kMatmul>(g, X, Y, Z, n_partials, partials, out, stream, phi, tabs,
                               mov, fix, scal, centres, bins, support, sigma, eps);
  return launch_nmi<kLerp>(g, X, Y, Z, n_partials, partials, out, stream, phi, tabs, mov,
                           fix, scal, centres, bins, support, sigma, eps);
}

// (bx, by, bz): the tiles a block owns, its column's march along x and its
// y-z footprint (grid: ceil(tiles / owned) blocks per axis, n_partials of
// them); (ex, ey, ez): the halo tiles staged beyond them, ceil((win - 1) /
// d) per axis.  1 <= win <= min(X, Y, Z); inv: 1 / win^3.  out: 2 floats,
// the sum of the local cc^2 over the VALID window positions and their
// count.
extern "C" int bsi_fused_lncc_f32(const float* phi, const float* tabs, const float* mov,
                                  const float* fix, float* partials, int n_partials,
                                  float* out, int nx, int ny, int nz, int dx, int dy,
                                  int dz, int X, int Y, int Z, int bx, int by, int bz,
                                  int form, int ex, int ey, int ez, int win, float inv,
                                  float eps, void* stream) {
  using namespace repro_torch;
  if (form != kLerp && form != kMatmul) return (int)cudaErrorInvalidValue;
  if (win < 1 || win > X || win > Y || win > Z) return (int)cudaErrorInvalidValue;
  if (ex * dx < win - 1 || ey * dy < win - 1 || ez * dz < win - 1)
    return (int)cudaErrorInvalidValue;
  const TileBlock own{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx + ex, by + ey, bz + ez};
  if (form == kMatmul)
    return launch_lncc<kMatmul>(g, own, X, Y, Z, win, n_partials, partials, out, stream,
                                phi, tabs, mov, fix, inv, eps);
  return launch_lncc<kLerp>(g, own, X, Y, Z, win, n_partials, partials, out, stream, phi,
                            tabs, mov, fix, inv, eps);
}
