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
// The ssd, stats and ncc kernels, in both forms (bsi_fused_walk_kernel<F,
// K>), run on the blocks of the forward kernels (bsi_forward.cuh): a block
// owns one (x tile, y tile) and a run of bz tiles along z, the whole z at
// phantom1 (kernels/bsi_fused.py:moment_blocks), and walks its voxel
// columns in lines of 32 voxels (walk_lines): line l of column (a, b) is
// the voxels z = 32 l + lane - s, s the column's start in the streamed
// volume (the fixed one for ssd and ncc, the moving one for stats) modulo 32
// floats, so each warp's reads of that volume are one aligned 128-byte line
// and its trilinear taps neighbours across the warp.  The block's lines,
// column after column, are dealt to its 8 warps in 8 contiguous shares, none
// more than a line longer than another.  A voxel's displacement, then the
// clamped 8-tap sample and its sums; no loop over voxels divides.
//
// The lerp form stages the y-stage values of its dx * dy columns with the
// forward kernels' x-y stage (fwd_xy_stage: each value once, no division)
// and a z table, one float4 a voxel of a column's run, by fwd_z_positions'
// stepping (no division): the tile's offset into the column's y-stage
// values and the z LUT's three weights at z % dz; a voxel costs one 16-byte
// and twelve 4-byte shared loads and its nine z lerps, and the run is
// walked in one pass.
//
// The matrix form's 64 x 3 products and sums a voxel, unfused as plain
// rounds them (384 instructions: 0.516 ms at phantom1 and 1.98 GHz,
// launch/bounds.py:unfused_floor_ms), would, summed by the thread that
// samples the voxel, load 1 KB of basis and window a voxel from shared
// memory, more than the shared memory delivers in that time (the kernel it
// replaced spent 1.31 ms of 1.84 there).  So the block stages the (d^3, 64)
// basis once, a row every 17 float4, and takes its run in chunks of z
// tiles.  For a chunk it sums the displacement of the chunk's voxels into
// shared memory, a thread an item of two z tiles of a column
// (walk_chunk_disp: a basis quad loaded serves both tiles and a window
// point up to ten voxels, about 256 bytes a voxel), from the chunk's
// control window, its z points split by parity so that a warp's loads hit
// distinct banks, the next chunk's copied by cp.async meanwhile; then it
// walks the chunk's voxels, two lines of a column at a time, reading each
// displacement back (walk_smem_bytes).  The sums' order: each thread folds
// its voxels in walk order, each warp its lanes by a fixed shuffle tree
// (lane i takes lane i + 16, then + 8, + 4, + 2, + 1), then thread 0 the
// warps in order, one barrier; stats' min, max and count are exact in any
// order.
//
// The nmi and lncc kernels stage the matrix form's basis transposed to (64,
// d^3) so that the threads of a warp, at consecutive voxel offsets, read
// consecutive banks; each thread sums its voxel's 64 terms per channel in
// the order k = 0..63, as kernels/bsi_matmul.py:plain does.
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
//
// compute_dtype="float16" (the _f16 entry points, both forms) is the bf16
// contract below on __half: the same code, the fp16 tables (the lerp LUTs
// and the basis f16(f16(wx wy) wz) of the fp16 LUTs, kron_basis as the JAX
// kernel forms it), the displacement rounded once to fp16 (round to
// nearest even, subnormals kept) and widened, the fp16 taps widened
// exactly; the same blocks, shared memory and bounds.
//
// compute_dtype="bfloat16" (the _bf16 entry points, both forms): the JAX
// kernel's contract (_fused_kernel, with repro/kernels/ops.py's casts): phi
// and mov bf16, fix and every sum float32; the displacement in float32 from
// the widened grid and the bf16-rounded tables, rounded once to bf16 where
// it is formed and widened (as_stored), then the float32 warp of the
// widened bf16 taps.  The lerp form's tables are the bf16 lerp LUTs; the
// matrix form's basis is the one the JAX kernel builds from its bf16 LUTs
// (repro/kernels/bsi_fused.py:87-89, kron_basis: each product rounded to
// bf16; kernels/bsi_fused.py:basis_table), not bsi_matmul's basis rounded
// once.  The kernels are the float32 ones with a type T for phi and mov
// (walk_block, nmi_block, lncc_block, each behind a __global__ of its own
// so that the float32 kernels keep their names): the staging widens the
// grid as it loads it (the matrix-form walk's window by plain loads where
// the float32 walk uses cp.async) and the ring holds float32 samples, so
// each block's shared memory and layout are the float32 kernel's.  The
// stats walk streams the bf16 moving volume and keeps lines of 32 voxels,
// aligned to 32 values: a warp's reads of a line are one aligned 64-byte
// half of a 128-byte line.  Bound at phantom1: 272.2 MB for ssd, ncc, nmi
// and lncc (0.0812 ms), 92.4 MB for stats (its 0.0352 ms of operations
// bind); like the float32 walks, paced by the taps; the matrix form keeps
// its 0.516 ms floor of 384 unfused instructions a voxel.
#include <math_constants.h>

#include <type_traits>

#include "bsi_forward.cuh"

// REPRO_FUSED_SKIP: the parts of the ssd, stats and ncc walks left out in a
// measurement build (launch/profile_fused.py; the library is built with
// none): 1 the staging (the x-y stage; the matrix form's basis and window),
// 2 the displacement (each voxel sampled at identity), 4 the gathers (the
// sample is the sum of the voxel's coordinates: the displacement stays, the
// moving volume is not read); 8 all but the reduction (each thread's sums a
// constant); the matrix form's 64-term sum with 16 its basis weights as
// constants (no basis loads), 32 its window values as constants (no window
// loads).
#ifndef REPRO_FUSED_SKIP
#define REPRO_FUSED_SKIP 0
#endif

namespace repro_torch {

// The clamped 8-tap sample of vol (element type T: a bf16 volume's taps
// widen exactly) at float32 coordinates (cx, cy, cz), lerped in float32.
template <typename T>
__device__ __forceinline__ float sample_clamped(const T* __restrict__ vol, int X, int Y,
                                                int Z, float cx, float cy, float cz) {
  cx = fminf(fmaxf(cx, 0.f), (float)(X - 1));
  cy = fminf(fmaxf(cy, 0.f), (float)(Y - 1));
  cz = fminf(fmaxf(cz, 0.f), (float)(Z - 1));
  const float fx = floorf(cx), fy = floorf(cy), fz = floorf(cz);
  const float tx = cx - fx, ty = cy - fy, tz = cz - fz;
  const int x0 = (int)fx, y0 = (int)fy, z0 = (int)fz;
  const int x1 = min(x0 + 1, X - 1), y1 = min(y0 + 1, Y - 1), z1 = min(z0 + 1, Z - 1);
  auto at = [&](int x, int y, int z) {
    return to_float(__ldg(vol + ((size_t)x * Y + y) * Z + z));
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
// LUTs (kLerp) or the (d^3, 64) basis (kMatmul); T the grid's element type.
// Ends with __syncthreads().
template <int F, typename T>
__device__ inline void stage_disp(const T* __restrict__ phi,
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

// The block's voxels after stage_disp: local voxel i -> warped sample; T
// the element type of the grid and the moving volume (the displacement is
// rounded to it once, as the JAX kernel stores it in phi's dtype).
template <int F, typename T>
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

  // The displacement of a local voxel.
  __device__ __forceinline__ void disp(int xl, int yl, int zl, float* u) const {
    if (F == kLerp) {
      const int tz = zl / dz, cz = zl - tz * dz;
      lerp_z(s_hy + ((size_t)(xl * BY + yl) * wz + tz) * 3, t0z, t1z, sz, cz, u);
    } else {
      matmul_disp(s_bt, s_win, nv, wy, wz, dx, dy, dz, xl, yl, zl, u);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = as_stored<T>(u[i]);
  }

  // The moving volume sampled at identity + displacement of a local voxel.
  __device__ __forceinline__ float warp(const T* __restrict__ mov, int X, int Y, int Z,
                                        int xl, int yl, int zl) const {
    float u[3];
    disp(xl, yl, zl, u);
    return sample_clamped(mov, X, Y, Z, (float)(x0 + xl) + u[0], (float)(y0 + yl) + u[1],
                          (float)(z0 + zl) + u[2]);
  }
};

struct SumOp {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
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

enum Moments { kSsd = 0, kStats = 1, kNcc = 2 };
constexpr int kWarps = kThreads / 32;
// The matrix form's item: kWalkTiles z tiles of a column, whose voxels a
// thread sums kWalkOffsets offsets along z at a time (a tile of more takes
// several passes), the most its registers hold.
constexpr int kWalkTiles = 2;
constexpr int kWalkOffsets = 5;

// The walk's run along z of a column, in voxels.
__host__ __device__ inline int walk_run(const FwdBlock& g) { return g.bz * g.dz; }
// The matrix form's chunk: the z tiles of a run whose displacement the
// block computes at once, one item a thread.
__host__ __device__ inline int walk_chunk(const FwdBlock& g) {
  return min(g.bz, kWalkTiles * max(1, kThreads / (g.dx * g.dy)));
}
// Its staged rows, in float4: a basis row of 16 quads over k every 17, and
// a part of a row of a chunk's window (its z points kz = j mod kWalkTiles,
// one part for each j), so that a warp's loads from distinct rows, or from
// the z points t + m of its items' first tiles t, fall on distinct banks.
constexpr int kBasisRow = 17;
__host__ __device__ inline int walk_window_part(const FwdBlock& g) {
  return (walk_chunk(g) + 2 * kWalkTiles + 1) / kWalkTiles;
}
// The walk's shared memory.  The lerp form: [z table (a float4 a voxel of a
// column's run) | y-stage values of the dx * dy columns (fwd_column_floats
// floats each)].  The matrix form: [(d^3, 64) basis, a row of 16 quads over
// k every kBasisRow float4 | two chunk windows (the next chunk's copied
// while the block sums this one's), 4 x 4 x kWalkTiles wq points of one
// float4 (x, y, z, 0) each, wq = walk_window_part, point (l, m, kz) at ((l *
// 4 + m) * kWalkTiles + kz % kWalkTiles) * wq + kz / kWalkTiles | the
// chunk's displacement, x, y and z each dx * dy columns of chunk * dz
// floats].  g.c is 3.
template <int F>
__host__ __device__ inline size_t walk_smem_bytes(const FwdBlock& g) {
  if (F == kLerp)
    return sizeof(float4) * (size_t)walk_run(g) +
           sizeof(float) * (size_t)g.dx * g.dy * fwd_column_floats(g);
  return sizeof(float4) * (kBasisRow * (size_t)g.dx * g.dy * g.dz +
                           2 * 16 * kWalkTiles * (size_t)walk_window_part(g)) +
         sizeof(float) * 3 * (size_t)g.dx * g.dy * walk_chunk(g) * g.dz;
}

// The moments of a block's voxels, each thread's, in walk order: ssd the sum
// of (w - f)^2, stats the sum, min, max and count of w, ncc the sums of ab,
// aa and bb with a = w - mu_w, b = f - mu_f.
template <int K>
struct WalkSums {
  float acc[3];
  int cnt = 0;
  const float* fix;  // ssd and ncc
  float mu_w = 0.f, mu_f = 0.f;

  __device__ WalkSums(const float* f) : fix(f) {
    acc[0] = 0.f;
    acc[1] = K == kStats ? CUDART_INF_F : 0.f;
    acc[2] = K == kStats ? -CUDART_INF_F : 0.f;
  }

  // w: the warped sample of voxel i (a flat index).
  __device__ __forceinline__ void add(float w, size_t i) {
    if (K == kSsd) {
      const float d = w - __ldg(fix + i);
      acc[0] += d * d;
    } else if (K == kStats) {
      acc[0] += w;
      acc[1] = fminf(acc[1], w);
      acc[2] = fmaxf(acc[2], w);
      ++cnt;
    } else {
      const float a = w - mu_w, b = __ldg(fix + i) - mu_f;
      acc[0] += a * b;
      acc[1] += a * a;
      acc[2] += b * b;
    }
  }

  // The block's row: the warp's lanes by a fixed shuffle tree, then the
  // warps in order by thread 0; stats' lanes 1 and 2 are a min and a max,
  // every other lane a sum.
  __device__ __forceinline__ void store(float* partials) {
    __shared__ float red[3][kWarps];
    __shared__ int redc[kWarps];
    constexpr int kLanes = K == kSsd ? 1 : 3;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      acc[0] += __shfl_down_sync(0xffffffffu, acc[0], o);
      if (K == kStats) {
        acc[1] = fminf(acc[1], __shfl_down_sync(0xffffffffu, acc[1], o));
        acc[2] = fmaxf(acc[2], __shfl_down_sync(0xffffffffu, acc[2], o));
        cnt += __shfl_down_sync(0xffffffffu, cnt, o);
      } else if (K == kNcc) {
        acc[1] += __shfl_down_sync(0xffffffffu, acc[1], o);
        acc[2] += __shfl_down_sync(0xffffffffu, acc[2], o);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j < kLanes; ++j) red[j][warp] = acc[j];
      redc[warp] = cnt;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
#pragma unroll
    for (int j = 0; j < kLanes; ++j) acc[j] = red[j][0];
    cnt = redc[0];
    for (int w = 1; w < kWarps; ++w) {
      acc[0] += red[0][w];
      if (K == kStats) {
        acc[1] = fminf(acc[1], red[1][w]);
        acc[2] = fmaxf(acc[2], red[2][w]);
        cnt += redc[w];
      } else if (K == kNcc) {
        acc[1] += red[1][w];
        acc[2] += red[2][w];
      }
    }
    float* row = partials + (K == kSsd ? 1 : K == kStats ? 4 : 3) * block_index();
#pragma unroll
    for (int j = 0; j < kLanes; ++j) row[j] = acc[j];
    if (K == kStats) row[3] = (float)cnt;  // at most a block's voxels: exact
  }
};

// The block's columns (xl, yl) inside the volume, yl fastest, each walked
// over its voxels [za, zb) of the run in lines of 32: line l of a column is
// the voxels p = za + 32 l + lane - s, s the start of [za, zb) in `aligned`
// (element type A) modulo 32 values, so a warp's reads of it are one
// aligned 128-byte line of floats, or one aligned 64-byte half of a line of
// bf16 values (the bf16 stats walk, whose streamed volume is the moving
// one: its lines stay 32 voxels, so that every variant deals the same lines
// to its warps).  T: the moving volume's element type.
// The lines, column after column, are dealt to the 8 warps in 8 contiguous
// shares, none more than a line longer than another.  Each voxel's
// displacement by disp(xl, yl, p, u), the moving volume sampled at identity
// + u, clamped, and the sample added to the thread's sums; U lines of a
// column at a time.
template <int U, int K, typename A, typename T, typename Disp>
__device__ __forceinline__ void walk_lines(const FwdBlock& g, int x0, int y0, int z0,
                                           int za, int zb, const A* aligned,
                                           const T* __restrict__ mov, WalkSums<K>& sums,
                                           Disp disp) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nyl = min(g.dy, g.Y - y0);
  const int L = (zb - za + 62) / 32;  // the lines [za, zb) can touch, whatever its start
  const int total = min(g.dx, g.X - x0) * nyl * L;
  const int end = (warp + 1) * total / kWarps;
  int line = warp * total / kWarps;
  int l = line % L, xl = line / L / nyl, yl = line / L % nyl;
  while (line < end) {
    const int n = min(L - l, end - line);  // lines of this column
    const size_t at = ((size_t)(x0 + xl) * g.Y + y0 + yl) * g.Z + z0;
    const int s = (int)(reinterpret_cast<size_t>(aligned + at + za) / sizeof(A) & 31);
    const float fx = (float)(x0 + xl), fy = (float)(y0 + yl);
#pragma unroll U
    for (int p = za + 32 * l + lane - s, i = 0; i < n; ++i, p += 32) {
      if ((unsigned)(p - za) >= (unsigned)(zb - za)) continue;  // outside [za, zb)
      float u[3] = {0.f, 0.f, 0.f};
#if !(REPRO_FUSED_SKIP & 2)
      disp(xl, yl, p, u);
#endif
      const float cx = fx + u[0], cy = fy + u[1], cz = (float)(z0 + p) + u[2];
#if REPRO_FUSED_SKIP & 4
      sums.add(cx + cy + cz, at + p);
#else
      sums.add(sample_clamped(mov, g.X, g.Y, g.Z, cx, cy, cz), at + p);
#endif
    }
    line += n;
    l = 0;
    if (++yl == nyl) yl = 0, ++xl;
  }
}

// cp.async of 4 bytes, or of zeros where !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_all;" ::: "memory");
}

// The matrix form's window of a chunk of zt tiles of the block on x tile ti
// and y tile tj from z tile tk (the layout of walk_smem_bytes): points (l,
// m, tk + kz), kz < zt + 3; past them and past the grid along z, 0 (only
// voxels outside the volume use them).  A float32 grid by cp.async, which
// does not wait; a bf16 grid (T) by loads widened as they are stored.
template <typename T>
__device__ inline void walk_stage_window(const T* __restrict__ phi, const FwdBlock& g,
                                         int ti, int tj, int tk, int zt, int wq,
                                         float4* s_win) {
  const int ys = g.nz * 3, xs = g.ny * ys, row = kWalkTiles * wq;
  const T* src = phi + ((size_t)ti * g.ny + tj) * ys + (size_t)tk * 3;
  for (int i = threadIdx.x; i < 16 * row; i += kThreads) {
    const int lm = i / row, e = i - row * lm, kz = e % wq * kWalkTiles + e / wq;
    const bool valid = kz < zt + 3 && tk + kz < g.nz;
    const T* q = valid ? src + (lm >> 2) * xs + (lm & 3) * ys + kz * 3 : phi;
    float* d = reinterpret_cast<float*>(s_win + i);
    if constexpr (kIsFloat<T>) {
      cp_async4(d, q, valid);
      cp_async4(d + 1, q + 1, valid);
      cp_async4(d + 2, q + 2, valid);
    } else {
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) d[ch] = valid ? to_float(__ldg(q + ch)) : 0.f;
    }
  }
}

// The matrix form's displacement of one chunk of the block: item (column c,
// tiles t .. t + kWalkTiles - 1, t = kWalkTiles k) -> the voxels t * dz + r
// of column c, r < kWalkTiles dz, into s_u (x, y and z each of ncols
// columns of cv floats).  s_basis: the basis, row v at kBasisRow v; s_win:
// the chunk's window, point (l, m, kz) at ((l * 4 + m) * kWalkTiles + kz %
// kWalkTiles) * wq + kz / kWalkTiles.  A thread takes items i, i + 256,
// ...; each sums up to kWalkOffsets voxel offsets of all its tiles at once,
// so a basis quad loaded serves kWalkTiles voxels and a window point up to
// 4 kWalkOffsets: per channel the 64 terms B[v, k] * window[tile + (l, m,
// n)] in the order k = (l*4 + m)*4 + n, each product rounded and then added,
// as kernels/bsi_matmul.py:plain sums them, and stored as V holds it (a
// bf16 grid's displacement rounded once to bf16, as_stored).  The tiles of
// an item past the chunk are computed from the room past its points and not
// stored.  V: the element type of phi.
template <typename V>
__device__ inline void walk_chunk_disp(const float4* s_basis, const float4* s_win,
                                       float* s_u, int ncols, int nyl, int zt, int wq,
                                       int cv, int dy, int dz) {
  constexpr int T = kWalkTiles;
  const int su = ncols * cv, items = (zt + T - 1) / T;
  for (int i = threadIdx.x; i < ncols * items; i += kThreads) {
    const int c = i / items, k = i - c * items, t = T * k;
    const int xl = c / nyl, yl = c - xl * nyl;
    const float4* rows = s_basis + (xl * dy + yl) * dz * kBasisRow;
    const float4* w = s_win + k;  // z point t + m at w[(m % T) * wq + m / T]
    float* u = s_u + c * cv + t * dz;
    const int real = min(T, zt - t);  // tiles of the item inside the chunk
    for (int r0 = 0; r0 < dz; r0 += kWalkOffsets) {
      float acc[T][kWalkOffsets][3] = {};
#pragma unroll 2  // further, it keeps the loads of later terms and spills
      for (int q = 0; q < 16; ++q) {  // q = l * 4 + m
        float4 p[T + 3];
#pragma unroll
        for (int m = 0; m < T + 3; ++m) {
#if REPRO_FUSED_SKIP & 32
          p[m] = make_float4(1.f + (4 * q + m) * 0x1p-9f, 1.f + (4 * q + m) * 0x1p-8f,
                             1.f + (4 * q + m) * 0x1p-7f, 0.f);
#else
          p[m] = w[(q * T + m % T) * wq + m / T];
#endif
        }
#pragma unroll
        for (int r = 0; r < kWalkOffsets; ++r) {
          if (r0 + r >= dz) break;
#if REPRO_FUSED_SKIP & 16
          const float b[4] = {1.f + (4 * q) * 0x1p-10f, 1.f + (4 * q + 1) * 0x1p-10f,
                              1.f + (4 * q + 2) * 0x1p-10f, 1.f + (4 * q + 3) * 0x1p-10f};
#else
          const float4 bq = rows[(r0 + r) * kBasisRow + q];
          const float b[4] = {bq.x, bq.y, bq.z, bq.w};
#endif
#pragma unroll
          for (int j = 0; j < T; ++j)
#pragma unroll
            for (int n = 0; n < 4; ++n) {
              acc[j][r][0] = acc[j][r][0] + b[n] * p[j + n].x;
              acc[j][r][1] = acc[j][r][1] + b[n] * p[j + n].y;
              acc[j][r][2] = acc[j][r][2] + b[n] * p[j + n].z;
            }
        }
      }
#pragma unroll
      for (int j = 0; j < T; ++j)
#pragma unroll
        for (int r = 0; r < kWalkOffsets; ++r) {
          if (r0 + r >= dz || j >= real) break;
          float* v = u + j * dz + r0 + r;
          v[0] = as_stored<V>(acc[j][r][0]);
          v[su] = as_stored<V>(acc[j][r][1]);
          v[2 * su] = as_stored<V>(acc[j][r][2]);
        }
    }
  }
}

// The ssd (K = kSsd; partials row: the sum of (w - f)^2), stats (K =
// kStats; row: sum, min, max, count of w) and ncc (K = kNcc; row: sums of
// ab, aa, bb with a = w - mu_w, b = f - mu_f, scal = (mu_w, mu_f)) kernels
// of displacement form F on the forward kernels' blocks (see the header);
// tabs: the lerp LUTs of x, then y, then z (kLerp) or the (d^3, 64) basis
// (kMatmul).  T: the element type of phi and mov, float or __nv_bfloat16;
// fix and every sum stay float32.
template <int F, int K, typename T>
__device__ __forceinline__ void walk_block(const T* __restrict__ phi,
                                           const float* __restrict__ tabs,
                                           const T* __restrict__ mov,
                                           const float* __restrict__ fix,
                                           const float* __restrict__ scal,
                                           float* __restrict__ partials, const FwdBlock& g) {
  extern __shared__ float4 smem4[];
  WalkSums<K> sums(fix);
#if REPRO_FUSED_SKIP & 8
  sums.acc[0] = sums.acc[1] = sums.acc[2] = (float)threadIdx.x;
  sums.cnt = threadIdx.x;
#else
  if (K == kNcc) sums.mu_w = scal[0], sums.mu_f = scal[1];
  const int tj = blockIdx.x, ti = blockIdx.y, tk0 = blockIdx.z * g.bz;
  const int x0 = ti * g.dx, y0 = tj * g.dy, z0 = tk0 * g.dz;
  const int R = walk_run(g);
  const int run = min(R, g.Z - z0);  // voxels of a column inside the volume
  // the volume whose lines the warps read aligned: the moving one for stats
  auto walk = [&](auto unroll, int za, int zb, auto disp) {
    if constexpr (K == kStats)
      walk_lines<decltype(unroll)::value>(g, x0, y0, z0, za, zb, mov, mov, sums, disp);
    else
      walk_lines<decltype(unroll)::value>(g, x0, y0, z0, za, zb, fix, mov, sums, disp);
  };
  if constexpr (F == kLerp) {
    const int Q = fwd_column_floats(g);
    float* s_hy = reinterpret_cast<float*>(smem4 + R);
    {
      // the z table: voxel z of a run -> (its tile's offset into the
      // column's y-stage values, as int bits; the z LUT's t0, t1, s at z %
      // dz)
      const float* lz = tabs + 3 * (g.dx + g.dy);
      const int dz = g.dz;
      fwd_z_positions(R, 1, dz, [=](int i, int k, int, int r) {
        smem4[i] = make_float4(__int_as_float(3 * k), lz[r], lz[dz + r], lz[2 * dz + r]);
      });
    }
#if !(REPRO_FUSED_SKIP & 1)
    fwd_xy_stage<LerpStage, 3>(phi, tabs, g, ti, tj, tk0, s_hy);
#endif
    __syncthreads();
    walk(std::integral_constant<int, 1>(), 0, run, [&](int xl, int yl, int p, float* u) {
      const float4 e = smem4[p];
      lerp_z(s_hy + (xl * g.dy + yl) * Q + __float_as_int(e.x), e.y, e.z, e.w, u);
#pragma unroll
      for (int i = 0; i < 3; ++i) u[i] = as_stored<T>(u[i]);  // its one rounding
    });
  } else {
    // chunk by chunk: the displacement of its tiles (the next chunk's
    // window copied meanwhile), then the walk of their voxels
    const int nyl = min(g.dy, g.Y - y0), ncols = min(g.dx, g.X - x0) * nyl;
    const int chunk = walk_chunk(g), wq = walk_window_part(g), cv = chunk * g.dz;
    const int tiles = (run + g.dz - 1) / g.dz;  // tiles of a column inside the volume
    const int nv = g.dx * g.dy * g.dz, wf = 16 * kWalkTiles * wq;  // float4 a window
    float4* s_basis = smem4;
    float4* s_win = s_basis + kBasisRow * nv;  // two windows
    float* s_u = reinterpret_cast<float*>(s_win + 2 * wf);
    const int su = ncols * cv;
#if !(REPRO_FUSED_SKIP & 1)
    {
      const float4* b4 = reinterpret_cast<const float4*>(tabs);
      for (int i = threadIdx.x; i < 16 * nv; i += kThreads)
        s_basis[(i >> 4) * kBasisRow + (i & 15)] = __ldg(b4 + i);
    }
    walk_stage_window(phi, g, ti, tj, tk0, min(chunk, tiles), wq, s_win);
    cp_async_wait_all();
#endif
    __syncthreads();
    for (int c0 = 0, b = 0; c0 < tiles; c0 += chunk, b ^= 1) {
      const int zt = min(chunk, tiles - c0);
#if !(REPRO_FUSED_SKIP & 1)
      if (c0 + chunk < tiles)  // the next chunk's window, into the other buffer
        walk_stage_window(phi, g, ti, tj, tk0 + c0 + chunk, min(chunk, tiles - c0 - chunk),
                          wq, s_win + (b ^ 1) * wf);
#endif
#if !(REPRO_FUSED_SKIP & 2)
      walk_chunk_disp<T>(s_basis, s_win + b * wf, s_u, ncols, nyl, zt, wq, cv, g.dy, g.dz);
#endif
      cp_async_wait_all();
      __syncthreads();  // the chunk's displacement and the next window are in
      const int za = c0 * g.dz;
      walk(std::integral_constant<int, 2>(), za, min(run, za + zt * g.dz),
           [&](int xl, int yl, int p, float* u) {
             const float* up = s_u + (xl * nyl + yl) * cv + p - za;
             u[0] = up[0];
             u[1] = up[su];
             u[2] = up[2 * su];
           });
      __syncthreads();  // the walk has read s_u
    }
  }
#endif
  sums.store(partials);
}

template <int F, int K>
__global__ void __launch_bounds__(kThreads, F == kMatmul ? 3 : 4)
    bsi_fused_walk_kernel(const float* __restrict__ phi, const float* __restrict__ tabs,
                          const float* __restrict__ mov, const float* __restrict__ fix,
                          const float* __restrict__ scal, float* __restrict__ partials,
                          FwdBlock g) {
  walk_block<F, K>(phi, tabs, mov, fix, scal, partials, g);
}

// The same on a bf16 grid and moving volume (compute_dtype="bfloat16").
template <int F, int K>
__global__ void __launch_bounds__(kThreads, F == kMatmul ? 3 : 4)
    bsi_fused_walk_bf16_kernel(const __nv_bfloat16* __restrict__ phi,
                               const float* __restrict__ tabs,
                               const __nv_bfloat16* __restrict__ mov,
                               const float* __restrict__ fix, const float* __restrict__ scal,
                               float* __restrict__ partials, FwdBlock g) {
  walk_block<F, K>(phi, tabs, mov, fix, scal, partials, g);
}

// The same on an fp16 grid and moving volume (compute_dtype="float16").
template <int F, int K>
__global__ void __launch_bounds__(kThreads, F == kMatmul ? 3 : 4)
    bsi_fused_walk_f16_kernel(const __half* __restrict__ phi, const float* __restrict__ tabs,
                              const __half* __restrict__ mov, const float* __restrict__ fix,
                              const float* __restrict__ scal, float* __restrict__ partials,
                              FwdBlock g) {
  walk_block<F, K>(phi, tabs, mov, fix, scal, partials, g);
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
// accumulator biases the histogram by about 1e-5.  T: the element type of
// phi and mov (WarpBlock); the staging holds them widened, so the shared
// memory is the float32 kernel's.
template <int F, int BP, typename T>
__device__ __forceinline__ void nmi_block(const T* __restrict__ phi,
                                          const float* __restrict__ tabs,
                                          const T* __restrict__ mov,
                                          const float* __restrict__ fix,
                                          const float* __restrict__ scal,
                                          const float* __restrict__ centres,
                                          float* __restrict__ partials, const TileBlock& g,
                                          int X, int Y, int Z, int bins, int support,
                                          float sigma, float eps) {
  using L = NmiLayout<BP>;
  extern __shared__ float smem[];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_disp<F>(phi, tabs, g, ti0, tj0, tk0, smem);
  const WarpBlock<F, T> b(smem, g, ti0, tj0, tk0);

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

template <int F, int BP>
__global__ void __launch_bounds__(kThreads, BP > 32 ? 2 : (F == kLerp ? 4 : 3))
    bsi_fused_nmi_kernel(const float* __restrict__ phi, const float* __restrict__ tabs,
                         const float* __restrict__ mov, const float* __restrict__ fix,
                         const float* __restrict__ scal,
                         const float* __restrict__ centres, float* __restrict__ partials,
                         TileBlock g, int X, int Y, int Z, int bins, int support,
                         float sigma, float eps) {
  nmi_block<F, BP>(phi, tabs, mov, fix, scal, centres, partials, g, X, Y, Z, bins, support,
                   sigma, eps);
}

// The same on a bf16 grid and moving volume (compute_dtype="bfloat16").
template <int F, int BP>
__global__ void __launch_bounds__(kThreads, BP > 32 ? 2 : (F == kLerp ? 4 : 3))
    bsi_fused_nmi_bf16_kernel(const __nv_bfloat16* __restrict__ phi,
                              const float* __restrict__ tabs,
                              const __nv_bfloat16* __restrict__ mov,
                              const float* __restrict__ fix, const float* __restrict__ scal,
                              const float* __restrict__ centres,
                              float* __restrict__ partials, TileBlock g, int X, int Y, int Z,
                              int bins, int support, float sigma, float eps) {
  nmi_block<F, BP>(phi, tabs, mov, fix, scal, centres, partials, g, X, Y, Z, bins, support,
                   sigma, eps);
}

// The same on an fp16 grid and moving volume (compute_dtype="float16").
template <int F, int BP>
__global__ void __launch_bounds__(kThreads, BP > 32 ? 2 : (F == kLerp ? 4 : 3))
    bsi_fused_nmi_f16_kernel(const __half* __restrict__ phi, const float* __restrict__ tabs,
                             const __half* __restrict__ mov, const float* __restrict__ fix,
                             const float* __restrict__ scal,
                             const float* __restrict__ centres,
                             float* __restrict__ partials, TileBlock g, int X, int Y, int Z,
                             int bins, int support, float sigma, float eps) {
  nmi_block<F, BP>(phi, tabs, mov, fix, scal, centres, partials, g, X, Y, Z, bins, support,
                   sigma, eps);
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
// their loads go out together), else 0 and the window is win_arg.  T: the
// element type of phi and mov; the window, the stages and the ring hold
// float32 (a bf16 grid widened as staged, the displacement rounded to bf16
// once and widened, the warped samples float32), so the shared memory is
// the float32 kernel's.
template <int F, int W, typename T>
__device__ __forceinline__ void lncc_block(const T* __restrict__ phi,
                                           const float* __restrict__ tabs,
                                           const T* __restrict__ mov,
                                           const float* __restrict__ fix,
                                           float* __restrict__ partials, const TileBlock& g,
                                           int ox, int oy, int oz, int X, int Y, int Z,
                                           int win_arg, float inv, float eps) {
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
#pragma unroll
        for (int k = 0; k < 3; ++k) u[k] = as_stored<T>(u[k]);
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

template <int F, int W>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_fused_lncc_kernel(const float* __restrict__ phi, const float* __restrict__ tabs,
                          const float* __restrict__ mov, const float* __restrict__ fix,
                          float* __restrict__ partials, TileBlock g, int ox, int oy,
                          int oz, int X, int Y, int Z, int win_arg, float inv, float eps) {
  lncc_block<F, W>(phi, tabs, mov, fix, partials, g, ox, oy, oz, X, Y, Z, win_arg, inv, eps);
}

// The same on a bf16 grid and moving volume (compute_dtype="bfloat16").
template <int F, int W>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_fused_lncc_bf16_kernel(const __nv_bfloat16* __restrict__ phi,
                               const float* __restrict__ tabs,
                               const __nv_bfloat16* __restrict__ mov,
                               const float* __restrict__ fix, float* __restrict__ partials,
                               TileBlock g, int ox, int oy, int oz, int X, int Y, int Z,
                               int win_arg, float inv, float eps) {
  lncc_block<F, W>(phi, tabs, mov, fix, partials, g, ox, oy, oz, X, Y, Z, win_arg, inv,
                   eps);
}

// The same on an fp16 grid and moving volume (compute_dtype="float16").
template <int F, int W>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_fused_lncc_f16_kernel(const __half* __restrict__ phi, const float* __restrict__ tabs,
                              const __half* __restrict__ mov, const float* __restrict__ fix,
                              float* __restrict__ partials, TileBlock g, int ox, int oy,
                              int oz, int X, int Y, int Z, int win_arg, float inv,
                              float eps) {
  lncc_block<F, W>(phi, tabs, mov, fix, partials, g, ox, oy, oz, X, Y, Z, win_arg, inv,
                   eps);
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

// The walk kernel of form F, moment K and element type T.
template <int F, int K, typename T>
inline auto walk_kernel() {
  if constexpr (kIsFloat<T>) return bsi_fused_walk_kernel<F, K>;
  else if constexpr (kIsBf16<T>) return bsi_fused_walk_bf16_kernel<F, K>;
  else return bsi_fused_walk_f16_kernel<F, K>;
}

// The walk of moment K in either form on the forward kernels' grid; (bx, by)
// must be (1, 1).  T: the element type of phi and mov.
template <int K, typename T>
inline int launch_moment(int form, int nx, int ny, int nz, int dx, int dy, int dz, int X,
                         int Y, int Z, int bx, int by, int bz, int n_partials,
                         float* partials, float* out, void* stream, const T* phi,
                         const float* tabs, const T* mov, const float* fix,
                         const float* scal) {
  if (bx != 1 || by != 1 || bz < 1 || (form != kLerp && form != kMatmul))
    return (int)cudaErrorInvalidValue;
  const FwdBlock g{nx, ny, nz, 3, dx, dy, dz, bz, X, Y, Z};
  const int lanes = K == kSsd ? 1 : K == kStats ? 4 : 3, mode = K == kStats ? 1 : 0;
  return form == kLerp
             ? launch_fused(walk_kernel<kLerp, K, T>(), fwd_grid(g),
                            walk_smem_bytes<kLerp>(g), n_partials, lanes, mode, partials,
                            out, stream, phi, tabs, mov, fix, scal, partials, g)
             : launch_fused(walk_kernel<kMatmul, K, T>(), fwd_grid(g),
                            walk_smem_bytes<kMatmul>(g), n_partials, lanes, mode, partials,
                            out, stream, phi, tabs, mov, fix, scal, partials, g);
}

// The lncc kernel on the column grid of `own`; the window of 9 (the LNCC
// default) runs the instantiation with the window fixed at compile time.  T:
// the element type of phi and mov.
template <int F, typename T>
inline int launch_lncc(const TileBlock& g, const TileBlock& own, int X, int Y, int Z,
                       int win, int n_partials, float* partials, float* out, void* stream,
                       const T* phi, const float* tabs, const T* mov,
                       const float* fix, float inv, float eps) {
  const size_t smem =
      sizeof(float) * LnccColumn::make<F>(g, own.bx, own.by, own.bz, win).floats;
  auto kernel = [&] {
    if constexpr (kIsBf16<T>)
      return win == 9 ? bsi_fused_lncc_bf16_kernel<F, 9> : bsi_fused_lncc_bf16_kernel<F, 0>;
    else if constexpr (kIsHalf<T>)
      return win == 9 ? bsi_fused_lncc_f16_kernel<F, 9> : bsi_fused_lncc_f16_kernel<F, 0>;
    else
      return win == 9 ? bsi_fused_lncc_kernel<F, 9> : bsi_fused_lncc_kernel<F, 0>;
  }();
  return launch_fused(kernel, tile_grid(own, X, Y, Z), smem, n_partials, 2, 2, partials,
                      out, stream, phi, tabs, mov, fix, partials, g, own.bx, own.by,
                      own.bz, X, Y, Z, win, inv, eps);
}

// The nmi kernel for `bins` (padded to 32 or 64) on the tile-block grid of
// g; T: the element type of phi and mov.
template <int F, typename T>
inline int launch_nmi(const TileBlock& g, int X, int Y, int Z, int n_partials,
                      float* partials, float* out, void* stream, const T* phi,
                      const float* tabs, const T* mov, const float* fix,
                      const float* scal, const float* centres, int bins, int support,
                      float sigma, float eps) {
  const size_t smem = disp_smem_bytes<F>(g) + sizeof(float) * nmi_extra_floats(bins);
  auto kernel = [&] {
    if constexpr (kIsBf16<T>)
      return nmi_padded_bins(bins) == 32 ? bsi_fused_nmi_bf16_kernel<F, 32>
                                         : bsi_fused_nmi_bf16_kernel<F, 64>;
    else if constexpr (kIsHalf<T>)
      return nmi_padded_bins(bins) == 32 ? bsi_fused_nmi_f16_kernel<F, 32>
                                         : bsi_fused_nmi_f16_kernel<F, 64>;
    else
      return nmi_padded_bins(bins) == 32 ? bsi_fused_nmi_kernel<F, 32>
                                         : bsi_fused_nmi_kernel<F, 64>;
  }();
  return launch_fused(kernel, tile_grid(g, X, Y, Z), smem, n_partials, bins * bins, 0,
                      partials, out, stream, phi, tabs, mov, fix, scal, centres, partials,
                      g, X, Y, Z, bins, support, sigma, eps);
}

}  // namespace repro_torch

// Entry points.  phi: (nx, ny, nz, 3); mov, fix: (X, Y, Z); all contiguous,
// fix float32, phi and mov float32 (the _f32 entries), bf16 (the _bf16
// entries, compute_dtype="bfloat16") or fp16 (the _f16 entries,
// compute_dtype="float16").  tabs: the lerp LUTs (form 0) or the
// (dx*dy*dz, 64) basis (form 1; kernels/bsi_fused.py:basis_table), for the
// _bf16 and _f16 entries rounded to their type and held as floats.
// partials: n_partials rows of K floats, one row per thread block (the
// caller sizes it with the same grid); out: K floats.  Each returns the
// first cudaError_t, or cudaErrorInvalidValue on a size mismatch or an
// unknown form.  (bx, by, bz): the tiles a block owns; the
// ssd, stats and ncc walks take (1, 1, bz), the forward kernels' blocks
// (kernels/bsi_fused.py:moment_blocks).

// The walk's layout for the dims the entry points take (bx, by and the
// partials aside): out[0] its chunk (the matrix form's; the lerp form's is
// bz), out[1] its dynamic shared memory a block in bytes; the layout the
// launches use, for kernels/bsi_fused.py:moment_blocks to check its own
// against.
extern "C" int bsi_fused_walk_layout(int nx, int ny, int nz, int dx, int dy, int dz,
                                     int X, int Y, int Z, int bx, int by, int bz,
                                     int form, long long* out) {
  using namespace repro_torch;
  if (form != kLerp && form != kMatmul) return (int)cudaErrorInvalidValue;
  const FwdBlock g{nx, ny, nz, 3, dx, dy, dz, bz, X, Y, Z};
  out[0] = form == kLerp ? bz : walk_chunk(g);
  out[1] = (long long)(form == kLerp ? walk_smem_bytes<kLerp>(g)
                                     : walk_smem_bytes<kMatmul>(g));
  return 0;
}

namespace repro_torch {

template <typename T>
inline int fused_nmi(const T* phi, const float* tabs, const T* mov, const float* fix,
                     const float* scal, const float* centres, float* partials,
                     int n_partials, float* out, int nx, int ny, int nz, int dx, int dy,
                     int dz, int X, int Y, int Z, int bx, int by, int bz, int form, int bins,
                     int support, float sigma, float eps, void* stream) {
  if (form != kLerp && form != kMatmul) return (int)cudaErrorInvalidValue;
  if (bins < 2 || bins > kNmiMaxBins || support < 0) return (int)cudaErrorInvalidValue;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  if (form == kMatmul)
    return launch_nmi<kMatmul>(g, X, Y, Z, n_partials, partials, out, stream, phi, tabs,
                               mov, fix, scal, centres, bins, support, sigma, eps);
  return launch_nmi<kLerp>(g, X, Y, Z, n_partials, partials, out, stream, phi, tabs, mov,
                           fix, scal, centres, bins, support, sigma, eps);
}

template <typename T>
inline int fused_lncc(const T* phi, const float* tabs, const T* mov, const float* fix,
                      float* partials, int n_partials, float* out, int nx, int ny, int nz,
                      int dx, int dy, int dz, int X, int Y, int Z, int bx, int by, int bz,
                      int form, int ex, int ey, int ez, int win, float inv, float eps,
                      void* stream) {
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

}  // namespace repro_torch

// The entry points of element type T (float: _f32, __nv_bfloat16: _bf16,
// __half: _f16).
#define REPRO_FUSED_ENTRIES(SUFFIX, T)                                                     \
  /* out: 1 float, the sum of squared differences. */                                      \
  extern "C" int bsi_fused_ssd_##SUFFIX(                                                   \
      const T* phi, const float* tabs, const T* mov, const float* fix, float* partials,    \
      int n_partials, float* out, int nx, int ny, int nz, int dx, int dy, int dz, int X,   \
      int Y, int Z, int bx, int by, int bz, int form, void* stream) {                      \
    return repro_torch::launch_moment<repro_torch::kSsd>(                                  \
        form, nx, ny, nz, dx, dy, dz, X, Y, Z, bx, by, bz, n_partials, partials, out,      \
        stream, phi, tabs, mov, fix, nullptr);                                             \
  }                                                                                        \
  /* out: 4 floats, the sum, min, max and count of the warped volume. */                   \
  extern "C" int bsi_fused_stats_##SUFFIX(                                                 \
      const T* phi, const float* tabs, const T* mov, float* partials, int n_partials,      \
      float* out, int nx, int ny, int nz, int dx, int dy, int dz, int X, int Y, int Z,     \
      int bx, int by, int bz, int form, void* stream) {                                    \
    return repro_torch::launch_moment<repro_torch::kStats>(                                \
        form, nx, ny, nz, dx, dy, dz, X, Y, Z, bx, by, bz, n_partials, partials, out,      \
        stream, phi, tabs, mov, nullptr, nullptr);                                         \
  }                                                                                        \
  /* scal: (mu_w, mu_f); out: 3 floats, sum ab, sum aa, sum bb. */                         \
  extern "C" int bsi_fused_ncc_##SUFFIX(                                                   \
      const T* phi, const float* tabs, const T* mov, const float* fix, const float* scal,  \
      float* partials, int n_partials, float* out, int nx, int ny, int nz, int dx, int dy, \
      int dz, int X, int Y, int Z, int bx, int by, int bz, int form, void* stream) {       \
    return repro_torch::launch_moment<repro_torch::kNcc>(                                  \
        form, nx, ny, nz, dx, dy, dz, X, Y, Z, bx, by, bz, n_partials, partials, out,      \
        stream, phi, tabs, mov, fix, scal);                                                \
  }                                                                                        \
  /* scal: (lo_w, hi_w, lo_f, hi_f); centres: bins floats; 2 <= bins <= 64; support:       \
     the half-width in bins of the evaluated Parzen weights (bsi_fused.py:nmi_support),    \
     >= 0.  out: bins * bins floats, the joint histogram (row: moving bin). */             \
  extern "C" int bsi_fused_nmi_##SUFFIX(                                                   \
      const T* phi, const float* tabs, const T* mov, const float* fix, const float* scal,  \
      const float* centres, float* partials, int n_partials, float* out, int nx, int ny,   \
      int nz, int dx, int dy, int dz, int X, int Y, int Z, int bx, int by, int bz,         \
      int form, int bins, int support, float sigma, float eps, void* stream) {             \
    return repro_torch::fused_nmi(phi, tabs, mov, fix, scal, centres, partials,            \
                                  n_partials, out, nx, ny, nz, dx, dy, dz, X, Y, Z, bx,    \
                                  by, bz, form, bins, support, sigma, eps, stream);        \
  }                                                                                        \
  /* (bx, by, bz): the tiles a block owns, its column's march along x and its y-z          \
     footprint (grid: ceil(tiles / owned) blocks per axis, n_partials of them); (ex, ey,   \
     ez): the halo tiles staged beyond them, ceil((win - 1) / d) per axis.  1 <= win <=    \
     min(X, Y, Z); inv: 1 / win^3.  out: 2 floats, the sum of the local cc^2 over the      \
     VALID window positions and their count. */                                            \
  extern "C" int bsi_fused_lncc_##SUFFIX(                                                  \
      const T* phi, const float* tabs, const T* mov, const float* fix, float* partials,    \
      int n_partials, float* out, int nx, int ny, int nz, int dx, int dy, int dz, int X,   \
      int Y, int Z, int bx, int by, int bz, int form, int ex, int ey, int ez, int win,     \
      float inv, float eps, void* stream) {                                                \
    return repro_torch::fused_lncc(phi, tabs, mov, fix, partials, n_partials, out, nx, ny, \
                                   nz, dx, dy, dz, X, Y, Z, bx, by, bz, form, ex, ey, ez,  \
                                   win, inv, eps, stream);                                 \
  }

REPRO_FUSED_ENTRIES(f32, float)
REPRO_FUSED_ENTRIES(bf16, __nv_bfloat16)
REPRO_FUSED_ENTRIES(f16, __half)
