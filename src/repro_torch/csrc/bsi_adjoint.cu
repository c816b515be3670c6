// BSI adjoint: dense cotangent -> control-grid cotangent, in two forms.
//
// Separable form.  Replaces: the Pallas TPU kernel
// repro/kernels/bsi_adjoint.py:bsi_adjoint_separable_pallas (_kernel,
// _band_sum), dispatched by repro/kernels/ops.py:bsi_adjoint_pallas.
//
// What bounds it on an H100: reading the cotangent of the dense field once.
// At phantom1 (512, 228, 385) x 3 channels that is 539 MB, about 0.16 ms at
// 3.35 TB/s.  The arithmetic is 4*d multiply-adds per intermediate value,
// far below the fp32 rate.
//
// What the design does about it: the three per-axis sweeps of the JAX
// kernel (z, then y, then x) run as three launches of one gather kernel.
// Each sweep writes one float per (outer, control point, inner) position: a
// weighted sum over the 4*d voxels of its four bands, in a fixed order, so
// the result is deterministic and needs no atomics.  The z sweep reads the
// cotangent once from device memory (its 4x band overlap hits L1 and L2) and
// shrinks it by d; the intermediates (X, Y, Nz, C) and (X, Ny, Nz, C) are 21%
// and 4.5% of the cotangent at a 5^3 tile.  Voxels outside the cropped
// volume count as zero: they are masked, and no padded copy of the cotangent
// is made (the JAX dispatcher pads by 3 tiles per side instead).
//
// Transposed-matmul form.  Replaces: the Pallas TPU kernel
// repro/kernels/bsi_adjoint.py:bsi_adjoint_matmul_pallas (_kernel_matmul),
// dispatched by repro/kernels/ops.py:bsi_adjoint_pallas(form="matmul").
//
// What bounds it on an H100: the operations, 64 multiply-adds per cotangent
// value (17.3 GFLOP at phantom1 with 3 channels, 0.26 ms at 67 TFLOP/s fp32);
// reading the 539 MB cotangent takes 0.16 ms.
//
// What the design does about it: two launches.  The JAX kernel stages a
// ((bc+3)*d)^3 x C cotangent window per block of control points; at bc = 2,
// d = 5 and 3 channels that is 188 KB, which with the 32 KB basis leaves no
// room on an H100 block (227 KB) and only 8 control points of work per
// block.  Here the first launch contracts each tile of the volume against
// the basis, c4[t, ch, k] = sum_v B[v, k] * g[t, v, ch] in the fixed order
// v = 0..d^3-1: a block stages its tiles' cotangents (zero outside the
// volume: masked, not padded) and the basis in shared memory, and a thread
// owns one (tile, channel, k), so a warp reads 32 consecutive basis columns
// (no bank conflicts) and one broadcast cotangent.  The c4 scratch is 64 x
// tiles x C floats (280 MB at phantom1).  The second launch is the 64-band
// overlap-add as a gather: control point p sums c4[p - (l, m, n), k] over
// k = (l*4 + m)*4 + n in order, tiles outside the volume counting zero.  No
// atomics: the result is deterministic.
#include "bsi_common.cuh"

namespace repro_torch {

// in: (outer, n_in, inner) -> out: (outer, n_ctrl, inner) with
// out[o, k, r] = sum_n sum_a w[a, n] * in[o, (k - n)*d + a, r], taps outside
// [0, n_in) being zero.  w is the (d, 4) weight LUT of the axis.
__global__ void __launch_bounds__(kThreads)
    adjoint_sweep_kernel(const float* __restrict__ in, const float* __restrict__ w,
                         float* __restrict__ out, long long outer, int n_in,
                         int n_ctrl, long long inner, int d) {
  const long long total = outer * n_ctrl * inner;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long r = i % inner;
    const long long q = i / inner;
    const int k = (int)(q % n_ctrl);
    const long long o = q / n_ctrl;
    const float* src = in + o * n_in * inner + r;
    float acc = 0.f;
    for (int band = 0; band < 4; ++band) {
      const int v0 = (k - band) * d;
      float part = 0.f;
      for (int a = 0; a < d; ++a) {
        const int v = v0 + a;
        if (v >= 0 && v < n_in) part += __ldg(w + a * 4 + band) * __ldg(src + (long long)v * inner);
      }
      acc += part;
    }
    out[i] = acc;
  }
}

inline cudaError_t sweep(const float* in, const float* w, float* out, long long outer,
                         int n_in, int n_ctrl, long long inner, int d,
                         cudaStream_t stream) {
  const long long total = outer * n_ctrl * inner;
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1LL << 30) ? blocks : (1LL << 30));
  adjoint_sweep_kernel<<<grid, kThreads, 0, stream>>>(in, w, out, outer, n_in, n_ctrl,
                                                      inner, d);
  return cudaGetLastError();
}

// c4[((tile)*c + ch)*64 + k] = sum_v B[v, k] * g[tile, v, ch] over the tiles
// that hold voxels of (X, Y, Z), tile-linear in (Tx, Ty, Tz).
__global__ void __launch_bounds__(kThreads)
    adjoint_matmul_c4_kernel(const float* __restrict__ g_in,
                             const float* __restrict__ basis, float* __restrict__ c4,
                             TileBlock g, int X, int Y, int Z) {
  extern __shared__ float smem[];
  const int nv = tile_voxels(g);
  float* s_b = smem;            // (nv, 64)
  float* s_g = smem + 64 * nv;  // (block tiles, nv, c)
  const int ti0 = blockIdx.x * g.bx, tj0 = blockIdx.y * g.by, tk0 = blockIdx.z * g.bz;
  for (int i = threadIdx.x; i < 64 * nv; i += blockDim.x) s_b[i] = basis[i];
  const int BX = g.bx * g.dx, BY = g.by * g.dy, BZ = g.bz * g.dz;
  const int x0 = ti0 * g.dx, y0 = tj0 * g.dy, z0 = tk0 * g.dz;
  const int nstage = BX * BY * BZ * g.c;
  for (int i = threadIdx.x; i < nstage; i += blockDim.x) {  // channel, then z fastest
    const int ch = i % g.c;
    int r = i / g.c;
    const int zl = r % BZ;
    r /= BZ;
    const int yl = r % BY;
    const int xl = r / BY;
    const int x = x0 + xl, y = y0 + yl, z = z0 + zl;
    float v = 0.f;  // outside the volume: masked
    if (x < X && y < Y && z < Z) v = g_in[(((size_t)x * Y + y) * Z + z) * g.c + ch];
    const int lt = ((xl / g.dx) * g.by + yl / g.dy) * g.bz + zl / g.dz;
    const int vo = ((xl % g.dx) * g.dy + yl % g.dy) * g.dz + zl % g.dz;
    s_g[((size_t)lt * nv + vo) * g.c + ch] = v;
  }
  __syncthreads();

  const int Tx = (X + g.dx - 1) / g.dx, Ty = (Y + g.dy - 1) / g.dy,
            Tz = (Z + g.dz - 1) / g.dz;
  const int items = g.bx * g.by * g.bz * g.c * 64;
  for (int w = threadIdx.x; w < items; w += blockDim.x) {
    const int k = w & 63;
    int r = w >> 6;
    const int ch = r % g.c;
    const int lt = r / g.c;
    const int lz = lt % g.bz, ly = (lt / g.bz) % g.by, lx = lt / (g.bz * g.by);
    const int tx = ti0 + lx, ty = tj0 + ly, tz = tk0 + lz;
    if (tx >= Tx || ty >= Ty || tz >= Tz) continue;
    const float* col = s_g + (size_t)lt * nv * g.c + ch;
    float acc = 0.f;
    for (int v = 0; v < nv; ++v) acc = acc + s_b[v * 64 + k] * col[v * g.c];
    c4[((((size_t)tx * Ty + ty) * Tz + tz) * g.c + ch) * 64 + k] = acc;
  }
}

// out[p, ch] = sum over k = (l*4 + m)*4 + n of c4[p - (l, m, n), ch, k], tiles
// outside [0, T) counting zero; out: (nx, ny, nz, c).
__global__ void __launch_bounds__(kThreads)
    adjoint_matmul_overlap_kernel(const float* __restrict__ c4, float* __restrict__ out,
                                  int nx, int ny, int nz, int c, int Tx, int Ty,
                                  int Tz) {
  const long long total = (long long)nx * ny * nz * c;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int ch = (int)(i % c);
    long long r = i / c;
    const int pz = (int)(r % nz);
    r /= nz;
    const int py = (int)(r % ny);
    const int px = (int)(r / ny);
    float acc = 0.f;
    for (int k = 0; k < 64; ++k) {
      const int tx = px - (k >> 4), ty = py - ((k >> 2) & 3), tz = pz - (k & 3);
      if (tx < 0 || ty < 0 || tz < 0 || tx >= Tx || ty >= Ty || tz >= Tz) continue;
      acc = acc + __ldg(c4 + ((((size_t)tx * Ty + ty) * Tz + tz) * c + ch) * 64 + k);
    }
    out[i] = acc;
  }
}

}  // namespace repro_torch

// g: (X, Y, Z, c) float32 cotangent of the field cropped to the volume.
// hz: (X, Y, nz, c) and hy: (X, ny, nz, c) scratch; out: (nx, ny, nz, c).
// wx, wy, wz: the (d, 4) weight LUTs.  Returns the first cudaError_t.
extern "C" int bsi_adjoint_f32(const float* g, const float* wx, const float* wy,
                               const float* wz, float* hz, float* hy, float* out,
                               int X, int Y, int Z, int c, int nx, int ny, int nz,
                               int dx, int dy, int dz, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = sweep(g, wz, hz, (long long)X * Y, Z, nz, c, dz, s);
  if (err != cudaSuccess) return (int)err;
  err = sweep(hz, wy, hy, X, Y, ny, (long long)nz * c, dy, s);
  if (err != cudaSuccess) return (int)err;
  err = sweep(hy, wx, out, 1, X, nx, (long long)ny * nz * c, dx, s);
  return (int)err;
}

// g: (X, Y, Z, c) float32 cotangent of the field cropped to the volume;
// basis: (dx*dy*dz, 64); c4: ceil(X/dx)*ceil(Y/dy)*ceil(Z/dz)*c*64 floats of
// scratch; out: (nx, ny, nz, c).  (bx, by, bz): tiles per block of the
// first launch.  Returns the first cudaError_t.
extern "C" int bsi_adjoint_matmul_f32(const float* g, const float* basis, float* c4,
                                      float* out, int X, int Y, int Z, int c, int nx,
                                      int ny, int nz, int dx, int dy, int dz, int bx,
                                      int by, int bz, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  const TileBlock tb{nx, ny, nz, c, dx, dy, dz, bx, by, bz};
  const size_t smem =
      sizeof(float) * (size_t)(basis_floats(tb) + bx * by * bz * tile_voxels(tb) * c);
  cudaError_t err = allow_smem(adjoint_matmul_c4_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  adjoint_matmul_c4_kernel<<<tile_grid(tb, X, Y, Z), kThreads, smem, s>>>(g, basis, c4,
                                                                         tb, X, Y, Z);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)nx * ny * nz * c;
  const long long blocks = (total + kThreads - 1) / kThreads;
  adjoint_matmul_overlap_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      c4, out, nx, ny, nz, c, (X + dx - 1) / dx, (Y + dy - 1) / dy, (Z + dz - 1) / dz);
  return (int)cudaGetLastError();
}
