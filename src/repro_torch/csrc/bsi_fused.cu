// Fused level step: BSI displacement -> clamped trilinear warp -> a similarity's
// partial sums, with no dense field and no warped volume in device memory.
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_fused.py:bsi_fused_pallas
// (_fused_kernel, _disp_block, _warp_block) in four of its variants, dispatched
// by repro/kernels/ops.py:fused_similarity_loss:
//   sim=("ssd",)    sum of (w - f)^2                          -> 1 lane
//   sim=("stats",)  sum, min, max and count of w              -> 4 lanes
//   sim=("ncc",)    sums of ab, aa, bb with a = w - mu_w,
//                   b = f - mu_f (the means from a device buffer) -> 3 lanes
//   sim=("nmi", bins, sigma_ratio, eps)  the (bins, bins) joint Parzen
//                   histogram sum_v wa(v) wb(v)^T            -> bins^2 lanes
// Every sum runs over the voxels inside the volume only.
//
// What bounds it on an H100: for ssd, stats and ncc, reading the volumes once
// (at phantom1, (512, 228, 385), 180 MB each: 0.05-0.11 ms at 3.35 TB/s).
// For nmi, the operations: the histogram is 2 bins^2 flops per voxel (2048 at
// 32 bins, 92 GFLOP at phantom1, 1.4 ms at 67 TFLOP/s fp32) plus 2 bins
// Gaussian weights and their normalisation per voxel.
//
// Built with -fmad=false (kernels/build.py): every multiply and add of the
// displacement and the warp rounds as in the plain version, so the warped
// samples equal it bit for bit; the histogram's multiply-adds are fmaf.
//
// What the design does about it: one thread block per block of tiles
// evaluates its displacement in the lerp form of bsi_ttli (bsi_common.cuh;
// the JAX kernel uses the separable form, the same function to fp32
// rounding), samples the moving volume at identity + displacement with fp32
// coordinates clamped to the volume exactly as core/ffd.py:trilinear_sample
// does, and reduces its voxels to one partial row.  The JAX kernel
// accumulates into one output block because TPU grid cells run in order;
// CUDA blocks do not, so each block writes its row of K lanes and a second
// launch combines the rows lane by lane in a fixed order.  Every reduction
// is a fixed tree or a fixed loop: the results are deterministic and no
// float atomics are used.
//
// The nmi kernel stages 128 voxels at a time: one thread per voxel and
// volume computes the voxel's normalised intensity, its `bins` Gaussian
// weights (true divisions and expf, the operation order of
// repro/core/similarity.py:nmi) and their normalisation, into bin-major
// shared memory; then each thread accumulates a 4 x 4 tile of histogram
// cells over its group's share of those voxels, in voxel order.  The groups
// are combined in a fixed order at the end.  It runs on the fp32 pipes;
// tensor cores and truncated Parzen support are later work.
#include <math_constants.h>

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

// The block's voxels after stage_xy: local voxel i -> warped sample.
struct WarpBlock {
  const float* t0z;
  const float* t1z;
  const float* sz;
  const float* s_hy;
  int wz, BX, BY, BZ, x0, y0, z0, dz;
  int n;  // voxels of the block, inside the volume or not

  __device__ WarpBlock(const float* smem, const TileBlock& g, int ti0, int tj0,
                       int tk0) {
    t0z = smem + 3 * (g.dx + g.dy);
    t1z = t0z + g.dz;
    sz = t1z + g.dz;
    s_hy = smem + lut_floats(g) + window_floats(g);
    wz = g.bz + 3;
    BX = g.bx * g.dx;
    BY = g.by * g.dy;
    BZ = g.bz * g.dz;
    x0 = ti0 * g.dx;
    y0 = tj0 * g.dy;
    z0 = tk0 * g.dz;
    dz = g.dz;
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

  // The moving volume sampled at identity + displacement of a local voxel.
  __device__ __forceinline__ float warp(const float* __restrict__ mov, int X, int Y,
                                        int Z, int xl, int yl, int zl) const {
    const int tz = zl / dz, cz = zl - tz * dz;
    const float* p = s_hy + ((size_t)(xl * BY + yl) * wz + tz) * 3;
    const float u0 = lerp4(p[0], p[3], p[6], p[9], t0z[cz], t1z[cz], sz[cz]);
    const float u1 = lerp4(p[1], p[4], p[7], p[10], t0z[cz], t1z[cz], sz[cz]);
    const float u2 = lerp4(p[2], p[5], p[8], p[11], t0z[cz], t1z[cz], sz[cz]);
    return sample_clamped(mov, X, Y, Z, (float)(x0 + xl) + u0, (float)(y0 + yl) + u1,
                          (float)(z0 + zl) + u2);
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

__global__ void __launch_bounds__(kThreads)
    bsi_fused_ssd_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                         const float* __restrict__ mov, const float* __restrict__ fix,
                         float* __restrict__ partials, TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_xy(phi, luts, g, ti0, tj0, tk0, smem);
  const WarpBlock b(smem, g, ti0, tj0, tk0);
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

__global__ void __launch_bounds__(kThreads)
    bsi_fused_stats_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                           const float* __restrict__ mov, float* __restrict__ partials,
                           TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_xy(phi, luts, g, ti0, tj0, tk0, smem);
  const WarpBlock b(smem, g, ti0, tj0, tk0);
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
__global__ void __launch_bounds__(kThreads)
    bsi_fused_ncc_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                         const float* __restrict__ mov, const float* __restrict__ fix,
                         const float* __restrict__ scal, float* __restrict__ partials,
                         TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  __shared__ float red[kThreads];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_xy(phi, luts, g, ti0, tj0, tk0, smem);
  const WarpBlock b(smem, g, ti0, tj0, tk0);
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

constexpr int kNmiChunk = 128;             // voxels staged per round
constexpr int kNmiStride = kNmiChunk + 1;  // row stride of the staged weights
constexpr int kNmiMaxBins = 64;

__host__ __device__ inline int nmi_padded_bins(int bins) { return (bins + 3) / 4 * 4; }

// Shared floats after the staging: centres, then the two (BP, stride)
// weight matrices, which the group combine reuses (16 floats per thread).
__host__ __device__ inline int nmi_extra_floats(int bins) {
  const int bp = nmi_padded_bins(bins);
  const int weights = 2 * bp * kNmiStride;
  return bp + (weights > 16 * kThreads ? weights : 16 * kThreads);
}

// scal: (lo_w, hi_w, lo_f, hi_f); centres: bins floats.
__global__ void __launch_bounds__(kThreads)
    bsi_fused_nmi_kernel(const float* __restrict__ phi, const float* __restrict__ luts,
                         const float* __restrict__ mov, const float* __restrict__ fix,
                         const float* __restrict__ scal,
                         const float* __restrict__ centres, float* __restrict__ partials,
                         TileBlock g, int X, int Y, int Z, int bins, float sigma,
                         float eps) {
  extern __shared__ float smem[];
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  stage_xy(phi, luts, g, ti0, tj0, tk0, smem);
  const WarpBlock b(smem, g, ti0, tj0, tk0);

  const int bp = nmi_padded_bins(bins);
  float* s_c = smem + stage_smem_bytes(g) / sizeof(float);
  float* sa = s_c + bp;             // (bp, kNmiStride): wa, bin-major
  float* sb = sa + bp * kNmiStride;  // (bp, kNmiStride): wb
  for (int k = threadIdx.x; k < bins; k += blockDim.x) s_c[k] = centres[k];

  const float lo_w = scal[0], lo_f = scal[2];
  const float rw = fmaxf(scal[1] - scal[0], 1e-8f);
  const float rf = fmaxf(scal[3] - scal[2], 1e-8f);

  // the weights stage: one thread per (voxel of the chunk, volume)
  const int side = threadIdx.x / kNmiChunk;  // 0: warped moving, 1: fixed
  const int v = threadIdx.x % kNmiChunk;
  float* col = (side == 0 ? sa : sb) + v;
  // the histogram stage: groups of (bp/4)^2 threads, each a 4 x 4 tile of
  // cells; group q takes voxels q, q + G, ... of each chunk
  const int nb = bp / 4, tg = nb * nb, groups = kThreads / tg;
  const int grp = threadIdx.x / tg, r = threadIdx.x % tg;
  const int i0 = 4 * (r / nb), j0 = 4 * (r % nb);
  float acc[4][4] = {};
  __syncthreads();  // centres staged

  for (int cb = 0; cb < b.n; cb += kNmiChunk) {
    const int i = cb + v;
    int xl, yl, zl;
    size_t at;
    if (i < b.n && b.locate(X, Y, Z, i, &xl, &yl, &zl, &at)) {
      const float x = side == 0 ? (b.warp(mov, X, Y, Z, xl, yl, zl) - lo_w) / rw
                                : (__ldg(fix + at) - lo_f) / rf;
      float sum = 0.f;
      for (int k = 0; k < bins; ++k) {
        const float d = (x - s_c[k]) / sigma;
        const float e = expf(-0.5f * (d * d));
        col[k * kNmiStride] = e;
        sum += e;
      }
      const float den = sum + eps;
      for (int k = 0; k < bins; ++k) col[k * kNmiStride] = col[k * kNmiStride] / den;
      for (int k = bins; k < bp; ++k) col[k * kNmiStride] = 0.f;
    } else {
      for (int k = 0; k < bp; ++k) col[k * kNmiStride] = 0.f;
    }
    __syncthreads();
    if (grp < groups) {
      for (int u = grp; u < kNmiChunk; u += groups) {
        float a[4], c[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          a[q] = sa[(i0 + q) * kNmiStride + u];
          c[q] = sb[(j0 + q) * kNmiStride + u];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int p = 0; p < 4; ++p) acc[q][p] = fmaf(a[q], c[p], acc[q][p]);
      }
    }
    __syncthreads();
  }

  // combine the groups in a fixed order; cells past `bins` are dropped
  float* comb = sa;  // (groups * tg, 16)
  if (grp < groups) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int p = 0; p < 4; ++p) comb[threadIdx.x * 16 + q * 4 + p] = acc[q][p];
  }
  __syncthreads();
  float* out = partials + block_index() * bins * bins;
  for (int cell = threadIdx.x; cell < bins * bins; cell += blockDim.x) {
    const int ci = cell / bins, cj = cell % bins;
    const int slot = ((ci / 4) * nb + cj / 4) * 16 + (ci % 4) * 4 + cj % 4;
    float s = 0.f;
    for (int q = 0; q < groups; ++q) s += comb[q * tg * 16 + slot];
    out[cell] = s;
  }
}

constexpr int kReduceThreads = 1024;
enum LaneOp { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };

// The stats row: sum, min, max, count.
__device__ __forceinline__ int lane_op(int lane, int stats) {
  return stats ? lane : kSum;
}

// Combine n partial rows of K lanes, lane by lane, in a fixed order.  A block
// takes L lanes (a power of two up to 32) with 1024 / L threads per lane;
// each thread folds rows phase, phase + R, ... and a fixed tree folds the
// threads.  With K = 1 this is one block summing n values with 1024 threads.
// The count lane folds in 64-bit integers, so it is exact.
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float* __restrict__ partials, int n, int K, int L,
                           int stats, float* __restrict__ out) {
  __shared__ float red[kReduceThreads];
  __shared__ long long redc[kReduceThreads];
  const int R = kReduceThreads / L;
  const int lane = blockIdx.x * L + threadIdx.x % L;
  const int phase = threadIdx.x / L;
  const int op = lane < K ? lane_op(lane, stats) : kSum;
  float acc = op == kMin ? CUDART_INF_F : op == kMax ? -CUDART_INF_F : 0.f;
  long long cnt = 0;
  if (lane < K) {
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

inline cudaError_t reduce_partials(const float* partials, int n, int K, int stats,
                                   float* out, cudaStream_t s) {
  int L = 1;
  while (L < K && L < 32) L *= 2;
  reduce_partials_kernel<<<(K + L - 1) / L, kReduceThreads, 0, s>>>(partials, n, K, L,
                                                                    stats, out);
  return cudaGetLastError();
}

// Launch `kernel` on the tile-block grid, then the lane-wise reduce.
template <typename Kernel, typename... Args>
inline int launch_fused(Kernel kernel, const TileBlock& g, int X, int Y, int Z,
                        size_t extra_floats, int n_partials, int K, int stats,
                        const float* partials, float* out, void* stream,
                        Args... args) {
  const dim3 grid = tile_grid(g, X, Y, Z);
  if ((long long)grid.x * grid.y * grid.z != n_partials) return (int)cudaErrorInvalidValue;
  const size_t smem = stage_smem_bytes(g) + sizeof(float) * extra_floats;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  kernel<<<grid, kThreads, smem, s>>>(args...);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials(partials, n_partials, K, stats, out, s);
}

}  // namespace repro_torch

// Entry points.  phi: (nx, ny, nz, 3); mov, fix: (X, Y, Z); all float32 and
// contiguous.  partials: n_partials rows of K floats, one row per thread
// block (the caller sizes it with the same tile-block grid); out: K floats.
// Each returns the first cudaError_t, or cudaErrorInvalidValue on a size
// mismatch.

// out: 1 float, the sum of squared differences.
extern "C" int bsi_fused_ssd_f32(const float* phi, const float* luts, const float* mov,
                                 const float* fix, float* partials, int n_partials,
                                 float* out, int nx, int ny, int nz, int dx, int dy,
                                 int dz, int X, int Y, int Z, int bx, int by, int bz,
                                 void* stream) {
  using namespace repro_torch;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  return launch_fused(bsi_fused_ssd_kernel, g, X, Y, Z, 0, n_partials, 1, 0, partials,
                      out, stream, phi, luts, mov, fix, partials, g, X, Y, Z);
}

// out: 4 floats, the sum, min, max and count of the warped volume.
extern "C" int bsi_fused_stats_f32(const float* phi, const float* luts, const float* mov,
                                   float* partials, int n_partials, float* out, int nx,
                                   int ny, int nz, int dx, int dy, int dz, int X, int Y,
                                   int Z, int bx, int by, int bz, void* stream) {
  using namespace repro_torch;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  return launch_fused(bsi_fused_stats_kernel, g, X, Y, Z, 0, n_partials, 4, 1,
                      partials, out, stream, phi, luts, mov, partials, g, X, Y, Z);
}

// scal: (mu_w, mu_f); out: 3 floats, sum ab, sum aa, sum bb.
extern "C" int bsi_fused_ncc_f32(const float* phi, const float* luts, const float* mov,
                                 const float* fix, const float* scal, float* partials,
                                 int n_partials, float* out, int nx, int ny, int nz,
                                 int dx, int dy, int dz, int X, int Y, int Z, int bx,
                                 int by, int bz, void* stream) {
  using namespace repro_torch;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  return launch_fused(bsi_fused_ncc_kernel, g, X, Y, Z, 0, n_partials, 3, 0, partials,
                      out, stream, phi, luts, mov, fix, scal, partials, g, X, Y, Z);
}

// scal: (lo_w, hi_w, lo_f, hi_f); centres: bins floats; 2 <= bins <= 64;
// out: bins * bins floats, the joint histogram (row: moving bin).
extern "C" int bsi_fused_nmi_f32(const float* phi, const float* luts, const float* mov,
                                 const float* fix, const float* scal,
                                 const float* centres, float* partials, int n_partials,
                                 float* out, int nx, int ny, int nz, int dx, int dy,
                                 int dz, int X, int Y, int Z, int bx, int by, int bz,
                                 int bins, float sigma, float eps, void* stream) {
  using namespace repro_torch;
  if (bins < 2 || bins > kNmiMaxBins) return (int)cudaErrorInvalidValue;
  const TileBlock g{nx, ny, nz, 3, dx, dy, dz, bx, by, bz};
  return launch_fused(bsi_fused_nmi_kernel, g, X, Y, Z, nmi_extra_floats(bins),
                      n_partials, bins * bins, 0, partials, out, stream, phi, luts, mov,
                      fix, scal, centres, partials, g, X, Y, Z, bins, sigma, eps);
}
