// Shared device code of the BSI kernels: the control window, the staged x and
// y stages of the TTLI and separable forms, and the 64-term sum of the matrix
// form.
//
// A thread block owns a block of (bx, by, bz) tiles and stages its
// (bx+3, by+3, bz+3, C) control window in shared memory (the counterpart of
// kernels/common.py:phi_window in the JAX package).  The fused nmi kernel
// also stages its LUTs and runs the x and y lerp stages once per (x voxel,
// y voxel, z control point) into shared memory (stage_xy); the z stage, per
// voxel, is left to the kernel, which warps and scores.  The forward
// kernels bsi_ttli and bsi_separable, and the fused ssd, stats and ncc
// kernels in the lerp form, run the same stages with their own blocks
// (bsi_forward.cuh).  A
// stage collapses the four neighbours of one axis
// either by three lerps (LerpStage: the same a + t*(b-a) chain as
// repro.core.interpolate.bsi_ttli, stage for stage) or by a 4-term weighted
// sum against the (d, 4) weight LUT (WeightStage: the sweeps of
// bsi_separable).  Also the tensor cores' 3xTF32 split and product (the
// fused nmi histogram, bsi_matmul.cu) and the bulk store of a staged run
// (bsi_tt.cu, bsi_matmul.cu), of float, bf16 or fp16 elements.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <type_traits>

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

// The x, y and z stages of bsi_ttli: per axis the LUTs t0, t1, s, each
// (d,), one after the other; three lerps per output value.
struct LerpStage {
  static constexpr int kLutRows = 3;
  __device__ static float apply(const float* lut, int d, int a, float p0, float p1,
                                float p2, float p3) {
    return lerp4(p0, p1, p2, p3, lut[a], lut[d + a], lut[2 * d + a]);
  }
};

// The sweeps of bsi_separable: per axis the (d, 4) weight LUT, row-major; a
// 4-term weighted sum per output value.
struct WeightStage {
  static constexpr int kLutRows = 4;
  __device__ static float apply(const float* lut, int, int a, float p0, float p1,
                                float p2, float p3) {
    const float* w = lut + 4 * a;
    return w[0] * p0 + w[1] * p1 + w[2] * p2 + w[3] * p3;
  }
};

// A grid or volume value as float32: bf16 and fp16 widen exactly (an fp16
// subnormal included: __half2float, never a bit trick).
__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// The element types of a grid, field, cotangent or volume: float, or a
// 2-byte type of the reduced compute dtypes.  Every branch on the type keys
// on the type itself, never on its size (bf16 and fp16 are both 2 bytes).
template <typename T>
constexpr bool kIsFloat = std::is_same_v<T, float>;
template <typename T>
constexpr bool kIsBf16 = std::is_same_v<T, __nv_bfloat16>;
template <typename T>
constexpr bool kIsHalf = std::is_same_v<T, __half>;

// v stored as an element of type T: itself for float, rounded once to
// nearest even for bf16 and fp16 (fp16 keeps its subnormals; past 65504 it
// is inf, which no value of the contract reaches).
template <typename T>
__device__ __forceinline__ T store_as(float v) {
  static_assert(kIsFloat<T> || kIsBf16<T> || kIsHalf<T>, "float, bf16 or fp16");
  if constexpr (kIsFloat<T>) return v;
  else if constexpr (kIsBf16<T>) return __float2bfloat16_rn(v);
  else return __float2half_rn(v);
}

// v as an element of type T would hold it, widened again: itself for float,
// rounded once to nearest even for bf16 and fp16 (the reduced displacement
// of the fused kernels, which the JAX package's stores before its warp).
template <typename T>
__device__ __forceinline__ float as_stored(float v) {
  return to_float(store_as<T>(v));
}

// Two neighbouring values (o 4-byte aligned) as one 4-byte store of bf16 or
// fp16, each rounded once to nearest even.
__device__ __forceinline__ void store_pair(__nv_bfloat16* o, float v0, float v1) {
  *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
}
__device__ __forceinline__ void store_pair(__half* o, float v0, float v1) {
  *reinterpret_cast<__half2*>(o) = __floats2half2_rn(v0, v1);
}

struct TileBlock {
  int nx, ny, nz, c;  // stored control points per axis, channels
  int dx, dy, dz;     // tile: voxels per control interval
  int bx, by, bz;     // tiles per thread block
};

// Shared-memory layout of the fused kernels' staging, in floats: [LUTs |
// control window | y-stage values]; the lerp LUTs of x, then y, then z, 3 * d
// floats each.
__host__ __device__ inline int lut_floats(const TileBlock& g) {
  return LerpStage::kLutRows * (g.dx + g.dy + g.dz);
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
// points past the grid read 0 (only tiles outside the volume use them); T
// the grid's element type, widened as it is loaded.  Does not synchronise.
template <typename T>
__device__ inline void stage_window(const T* __restrict__ phi, const TileBlock& g,
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
      v = to_float(phi[(((size_t)gi * g.ny + gj) * g.nz + gk) * g.c + ch]);
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

// The x and y lerp stages of the fused kernels' blocks; luts: the lerp LUTs
// of x, then y, then z (lut_floats floats).  After the call, hy(xl, yl, kz,
// ch) = smem[lut + window + ((xl*BY + yl)*(bz+3) + kz)*c + ch] with BY =
// by*dy, for the block's local voxels xl, yl and its local z control points
// kz.  T: the grid's element type (stage_window).  Ends with __syncthreads().
template <typename T>
__device__ inline void stage_xy(const T* __restrict__ phi,
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

  const float* lx = s_lut;
  const float* ly = lx + LerpStage::kLutRows * g.dx;
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
      h[m] = LerpStage::apply(lx, g.dx, a, p[0], p[xstep], p[2 * xstep], p[3 * xstep]);
    }
    s_hy[i] = LerpStage::apply(ly, g.dy, b, h[0], h[1], h[2], h[3]);
  }
  __syncthreads();
}

// cvt.rna.tf32.f32 of a finite x in two integer operations: the float
// rounded to 10 mantissa bits, ties away from zero, the low 13 bits
// cleared.  On sm_90 the conversion instruction runs at a quarter of the
// integer rate.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// The 3xTF32 split: hi the nearest tf32 of x, lo the nearest tf32 of the
// rest (exact in float32); hi + lo holds x to about 2^-22.
__device__ __forceinline__ void split_tf32(float x, unsigned* hi, unsigned* lo) {
  *hi = tf32_rna(x);
  *lo = tf32_rna(x - __uint_as_float(*hi));
}

// d += a b on the tensor cores: a the 16 x 8 row-major fragment, b the 8 x 8
// column-major one, d the 16 x 8 float32 accumulator.
__device__ __forceinline__ void mma_tf32(float* d, const unsigned* a, const unsigned* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The bulk copy engine (TMA) stores a staged run: [gdst, gdst + bytes) from
// shared memory, both 16-byte aligned, bytes a multiple of 16.
__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(gdst),
               "r"((unsigned)__cvta_generic_to_shared(ssrc)), "r"(bytes)
               : "memory");
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
