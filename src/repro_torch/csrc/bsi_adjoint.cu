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
// What bounds it on an H100: reading the cotangent once, 539 MB at phantom1
// (512, 228, 385) x 3 channels, 0.16 ms at 3.35 TB/s; the form's own 64
// multiply-adds a value (8.76 G at a 5^3 tile) take 0.26 ms on the fp32
// pipes.  An earlier design wrote every tile's 64 band sums to device memory
// (280 MB at phantom1) and gathered them back, and its contraction read two
// shared-memory words per multiply-add: 4.0 + 0.5 ms on an H100.
//
// What the design does about it: the band sums never leave the chip.  A
// persistent block (two an SM at phantom1) stages the (d^3, 64) basis once
// and walks over boxes of (bx, by, bz) tiles, kernels/bsi_adjoint.py:
// matmul_blocks picking the box.  A box is contracted plane by plane, a
// plane being its tiles' voxels at one x offset: the planes stream through a
// ring of shared-memory slots by 16-byte cp.async (4-byte copies straight
// into place were slower), so the next planes load while one is contracted,
// across boxes too; each plane is then moved into U's layout, (dy*dz, cols)
// with a column per (tile, channel), zero outside the volume (masked, not
// padded).  The block forms B^T U register-blocked like an SGEMM, each of
// its 2*cols threads 8 bands x 4 columns read as 16-byte vectors (3 shared
// loads per 32 multiply-adds), the sum over v in the order v = 0..d^3-1 as
// before.  After a box's last plane its bands go to shared memory and each
// control point of the (bx+3)(by+3)(bz+3) the box touches is owned by one
// thread, which sums the bands that land on it in the order
// k = (l*4 + m)*4 + n and writes one partial a channel (32 MB at phantom1,
// read back from L2).  A small second launch sums, for each control point,
// the partials of the boxes that hold it, in box order.  No atomics: the
// result is deterministic.
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

#ifndef REPRO_ADJ_SKIP  // measurement builds: 1 leaves out the staging, 2 the
#define REPRO_ADJ_SKIP 0  // contraction, 4 the owner sums (launch/profile_adjoint.py)
#endif

constexpr int kAdjStages = 3;   // ring slots of the box kernel's staging
constexpr int kLaneFloats = 4;  // a lane's floats of a row of up to 128

// The matmul adjoint's geometry: the volume, its tiles and the boxes of
// tiles a block contracts at a time (kernels/bsi_adjoint.py:MatmulBlocks).
struct AdjointBoxes {
  int X, Y, Z, c;     // volume, channels
  int dx, dy, dz;     // tile
  int Tx, Ty, Tz;     // tiles that hold voxels of the volume
  int bx, by, bz;     // tiles per box
  int nbx, nby, nbz;  // boxes per axis
};

// Floats of one box's partial: its (bx+3, by+3, bz+3) control points, c each.
__host__ __device__ inline int box_partial_floats(const AdjointBoxes& a) {
  return (a.bx + 3) * (a.by + 3) * (a.bz + 3) * a.c;
}

// A plane of a box: its voxels at one x offset of its tiles, bx*by*dy rows
// along z of bz*dz*c floats (channels fastest), each staged as the 16-byte
// chunks that cover it, (row + 6) / 4 of them at most.
__host__ __device__ inline int plane_rows(const AdjointBoxes& a) {
  return a.bx * a.by * a.dy;
}
__host__ __device__ inline int raw_row_floats(const AdjointBoxes& a) {
  return 4 * ((a.bz * a.dz * a.c + 6) / 4);
}

// Shared memory of the box kernel, in 4-byte words: the (nv, 64) basis; a
// ring of kAdjStages raw planes; one plane of U, (dy*dz, cols + 4), whose
// room takes the (64, cols + 4) bands after a box's last plane; and the
// tables, a row's (z, channel) places (bz*dz*c) and each plane row's place
// (2 a row).  kernels/bsi_adjoint.py:matmul_smem_bytes is the same sum.
inline size_t adjoint_box_smem(const AdjointBoxes& a, int cols) {
  const int nvp = a.dy * a.dz;
  return 4 * ((size_t)64 * a.dx * nvp + (size_t)kAdjStages * plane_rows(a) * raw_row_floats(a) +
              (size_t)(nvp > 64 ? nvp : 64) * (cols + 4) + a.bz * a.dz * a.c +
              2 * plane_rows(a));
}

// A 16-byte asynchronous copy into shared memory (through L2 only) of the
// first `bytes` bytes at src, the rest zero-filled.
__device__ __forceinline__ void cp_async_16(unsigned dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// partials[box][((qx*(by+3) + qy)*(bz+3) + qz)*c + ch]: the bands of the box's
// tiles that land on its local control point q, summed in band order.
//
// A block walks over boxes blockIdx.x, + gridDim.x, ...; each box is dx
// planes, contracted in order.  The planes stream through a ring of
// kAdjStages slots by 16-byte cp.async, so the next planes load while one is
// contracted, across boxes too; each is then moved into U's layout, a
// (dy*dz, cols) slice, a column per (tile, channel), zero outside the volume
// (masked, not padded).  2*COLS threads, each 8 bands x 4 columns of B^T U:
// bands bg*4 + i and 32 + bg*4 + i (i < 4), columns cg*4 .. cg*4 + 3; a warp
// is 2 band groups x 16 column groups, so its 16-byte loads of one v read
// two and sixteen contiguous vectors.
// After a box's last plane the bands go to shared memory and each control
// point of the box is owned by one thread, which sums its channels.
template <int COLS>
__global__ void __launch_bounds__(2 * COLS)
    adjoint_matmul_box_kernel(const float* __restrict__ g, const float* __restrict__ basis,
                              float* __restrict__ partials, AdjointBoxes a) {
  constexpr int LD = COLS + 4;   // a row of U; the pad turns the banks by 4 a row
  constexpr int NT = 2 * COLS;   // threads
  constexpr int NW = NT / 32;    // warps
  extern __shared__ float smem[];
  const int nv = a.dx * a.dy * a.dz, nvp = a.dy * a.dz;  // voxels of a tile, a plane
  const int row_len = a.bz * a.dz * a.c, RS = raw_row_floats(a);
  const int BY = a.by * a.dy, nrows = plane_rows(a);
  float* s_b = smem;                               // (nv, 64)
  float* s_ring = s_b + 64 * nv;                   // kAdjStages x (nrows, RS)
  float* s_u = s_ring + kAdjStages * nrows * RS;   // (max(nvp, 64), LD)
  int* s_zoff = (int*)(s_u + (nvp > 64 ? nvp : 64) * LD);  // (row_len,): (z, ch) -> U
  int* s_rdst = s_zoff + row_len;                  // (nrows,): plane row -> U
  int* s_rxy = s_rdst + nrows;                     // (nrows,): lx*dx << 16 | y offset
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 64 * nv; i += NT) s_b[i] = basis[i];
  for (int e = tid; e < row_len; e += NT) {
    const int zl = e / a.c, tz = zl / a.dz;
    s_zoff[e] = (zl - tz * a.dz) * LD + tz * a.c + (e - zl * a.c);
  }
  for (int r = tid; r < nrows; r += NT) {
    const int lx = r / BY, yl = r - lx * BY, ly = yl / a.dy;
    s_rdst[r] = (yl - ly * a.dy) * a.dz * LD + (lx * a.by + ly) * a.bz * a.c;
    s_rxy[r] = (lx * a.dx) << 16 | yl;
  }
  __syncthreads();

  const int nboxes = a.nbx * a.nby * a.nbz;
  const int nplanes =
      blockIdx.x < nboxes ? ((nboxes - 1 - blockIdx.x) / gridDim.x + 1) * a.dx : 0;
  const int zrow = a.Z * a.c;
  const float* g_end = g + (size_t)a.X * a.Y * zrow;
  const unsigned ring = (unsigned)__cvta_generic_to_shared(s_ring);

  // Plane t's box and its first voxel (x0, y0, and zc0 in a row); row r
  // starts lx*dx and its y offset further on (s_rxy).
  auto plane = [&](int t, int& box, int& x0, int& y0, int& zc0) {
    box = blockIdx.x + (t / a.dx) * gridDim.x;
    const int bk = box % a.nbz, bj = (box / a.nbz) % a.nby, bi = box / (a.nbz * a.nby);
    x0 = bi * a.bx * a.dx + t % a.dx;
    y0 = bj * a.by * a.dy;
    zc0 = bk * row_len;
  };
  // Plane t's rows into ring slot t % kAdjStages, as the 16-byte chunks that
  // cover them: none for rows outside the volume, and nothing past g's end.
  // A chunk may begin up to 12 bytes before g, inside its allocation: torch
  // aligns allocations to 512 bytes, and a view's earlier bytes are its
  // storage's.
  auto stage = [&](int t) {
    if (REPRO_ADJ_SKIP & 1) return;
    int box, x0, y0, zc0;
    plane(t, box, x0, y0, zc0);
    const unsigned slot = ring + 4u * (t % kAdjStages) * nrows * RS;
    for (int r = warp; r < nrows; r += NW) {
      const int x = x0 + (s_rxy[r] >> 16), y = y0 + (s_rxy[r] & 0xffff);
      if (x >= a.X || y >= a.Y) continue;
      const float* src = g + ((size_t)x * a.Y + y) * zrow + zc0;
      const float* lo = (const float*)((size_t)src & ~(size_t)15);
      const int chunks = (int)((src - lo + row_len + 3) / 4);
      for (int i = lane; i < chunks; i += 32) {
        const float* p = lo + 4 * i;
        const long long left = g_end - p;
        const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * (int)left : 0);
        cp_async_16(slot + 4u * (r * RS + 4 * i), bytes ? p : g, bytes);
      }
    }
  };

  for (int t = 0; t < kAdjStages - 1; ++t) {
    if (t < nplanes) stage(t);
    cp_async_commit();
  }
  int zoff[kLaneFloats];  // U places of this lane's floats of a row (-1: none)
#pragma unroll
  for (int j = 0; j < kLaneFloats; ++j)
    zoff[j] = lane + 32 * j < row_len ? s_zoff[lane + 32 * j] : -1;
  const int bg = (warp % 4) * 2 + lane / 16, cg = (warp / 4) * 16 + lane % 16;
  float acc[8][4];
  for (int t = 0; t < nplanes; ++t) {
    const int cx = t % a.dx;
    if (cx == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    cp_async_wait<kAdjStages - 2>();  // plane t has landed (this thread's copies)
    __syncthreads();  // ... everyone's; plane t - 1's slot and U are free again
    if (t + kAdjStages - 1 < nplanes) stage(t + kAdjStages - 1);
    cp_async_commit();

    int box, x0, y0, zc0;
    plane(t, box, x0, y0, zc0);
    if (!(REPRO_ADJ_SKIP & 1)) {  // plane t into U's layout, masked
      const float* raw = s_ring + (t % kAdjStages) * nrows * RS;
      const int zlim = min(row_len, zrow - zc0);  // a row's floats in the volume
#pragma unroll 2
      for (int r = warp; r < nrows; r += NW) {
        const int x = x0 + (s_rxy[r] >> 16), y = y0 + (s_rxy[r] & 0xffff);
        const int n = x < a.X && y < a.Y ? zlim : 0;
        const float* row = g + ((size_t)x * a.Y + y) * zrow + zc0;  // as staged
        const float* src = raw + r * RS + (int)(((size_t)row >> 2) & 3);
        float* dst = s_u + s_rdst[r];
        if (row_len <= 32 * kLaneFloats) {  // a lane's places held in registers
          float val[kLaneFloats];
#pragma unroll
          for (int j = 0; j < kLaneFloats; ++j)
            val[j] = lane + 32 * j < n ? src[lane + 32 * j] : 0.f;
#pragma unroll
          for (int j = 0; j < kLaneFloats; ++j)
            if (zoff[j] >= 0) dst[zoff[j]] = val[j];
        } else {
          for (int e = lane; e < row_len; e += 32) dst[s_zoff[e]] = e < n ? src[e] : 0.f;
        }
      }
    }
    __syncthreads();

    const float* pb = s_b + cx * nvp * 64 + bg * 4;
    const float* pu = s_u + cg * 4;
#pragma unroll 2
    for (int v = 0; v < ((REPRO_ADJ_SKIP & 2) ? 0 : nvp); ++v) {  // v = cx*nvp .. in order
      const float4 b0 = *(const float4*)(pb + v * 64);
      const float4 b1 = *(const float4*)(pb + v * 64 + 32);
      const float4 u0 = *(const float4*)(pu + v * LD);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float u[4] = {u0.x, u0.y, u0.z, u0.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(b[i], u[j], acc[i][j]);
    }
    if (cx != a.dx - 1) continue;

    __syncthreads();  // every read of U before the bands take its room
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* dst = s_u + (i < 4 ? bg * 4 + i : 32 + bg * 4 + i - 4) * LD + cg * 4;
      *(float4*)dst = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    __syncthreads();

    // one owner a control point, its channels four at a time; the tiles past
    // the volume's are skipped
    const int bk = box % a.nbz, bj = (box / a.nbz) % a.nby, bi = box / (a.nbz * a.nby);
    const int ox = min(a.bx, a.Tx - bi * a.bx), oy = min(a.by, a.Ty - bj * a.by),
              oz = min(a.bz, a.Tz - bk * a.bz);
    const int wy = a.by + 3, wz = a.bz + 3, npts = (a.bx + 3) * wy * wz;
    float* part = partials + (size_t)box * npts * a.c;
    for (int q = tid; q < npts; q += NT) {
      const int qz = q % wz, qy = (q / wz) % wy, qx = q / (wz * wy);
      for (int ch0 = 0; ch0 < a.c; ch0 += 4) {
        const int nch = min(4, a.c - ch0);
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
        if (!(REPRO_ADJ_SKIP & 4))
          for (int l = max(0, qx - ox + 1); l <= min(3, qx); ++l)
            for (int m = max(0, qy - oy + 1); m <= min(3, qy); ++m)
              for (int n = max(0, qz - oz + 1); n <= min(3, qz); ++n) {
                const int lt = ((qx - l) * a.by + qy - m) * a.bz + qz - n;
                const float* p = s_u + ((l * 4 + m) * 4 + n) * LD + lt * a.c + ch0;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  if (j < nch) sum[j] += p[j];
              }
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (j < nch) part[q * a.c + ch0 + j] = sum[j];
      }
    }
  }
  cp_async_wait<0>();
}

// out[p, ch] = the sum over the boxes whose partial holds control point p, in
// box order; 0 where none does.  out: (nx, ny, nz, c).
__global__ void __launch_bounds__(kThreads)
    adjoint_matmul_seam_kernel(const float* __restrict__ partials, float* __restrict__ out,
                               AdjointBoxes a, int nx, int ny, int nz) {
  const long long total = (long long)nx * ny * nz * a.c;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const int wy = a.by + 3, wz = a.bz + 3;
  const int P = box_partial_floats(a);
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const int ch = (int)(i % a.c);
    long long r = i / a.c;
    const int pz = (int)(r % nz);
    r /= nz;
    const int py = (int)(r % ny);
    const int px = (int)(r / ny);
    // box b holds the points [b*bx, b*bx + bx + 3) of an axis
    const int i1 = min(a.nbx - 1, px / a.bx), j1 = min(a.nby - 1, py / a.by),
              k1 = min(a.nbz - 1, pz / a.bz);
    float acc = 0.f;
    for (int bi = px >= 3 ? (px - 3) / a.bx : 0; bi <= i1; ++bi)
      for (int bj = py >= 3 ? (py - 3) / a.by : 0; bj <= j1; ++bj)
        for (int bk = pz >= 3 ? (pz - 3) / a.bz : 0; bk <= k1; ++bk) {
          const int q = ((px - bi * a.bx) * wy + py - bj * a.by) * wz + pz - bk * a.bz;
          acc += partials[((size_t)(bi * a.nby + bj) * a.nbz + bk) * P + q * a.c + ch];
        }
    out[i] = acc;
  }
}

// The persistent box launch: as many blocks as the card holds at once.
template <int COLS>
inline cudaError_t launch_boxes(const float* g, const float* basis, float* partials,
                                const AdjointBoxes& a, cudaStream_t stream) {
  const size_t smem = adjoint_box_smem(a, COLS);
  cudaError_t err = allow_smem(adjoint_matmul_box_kernel<COLS>, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, adjoint_matmul_box_kernel<COLS>, 2 * COLS, smem);
  if (err != cudaSuccess) return err;
  const long long nboxes = (long long)a.nbx * a.nby * a.nbz;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = (unsigned)(nboxes < slots ? nboxes : slots);
  adjoint_matmul_box_kernel<COLS><<<grid, 2 * COLS, smem, stream>>>(g, basis, partials, a);
  return cudaGetLastError();
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
// basis: (dx*dy*dz, 64); partials: nbx*nby*nbz*(bx+3)*(by+3)*(bz+3)*c floats
// of scratch, nb = ceil(ceil(X/dx)/bx) and so on; out: (nx, ny, nz, c).
// (bx, by, bz): tiles per box; cols: the box kernel's columns (128 or 64;
// at least bx*by*bz*c), half its threads.  Returns the first cudaError_t.
extern "C" int bsi_adjoint_matmul_f32(const float* g, const float* basis, float* partials,
                                      float* out, int X, int Y, int Z, int c, int nx,
                                      int ny, int nz, int dx, int dy, int dz, int bx,
                                      int by, int bz, int cols, void* stream) {
  using namespace repro_torch;
  cudaStream_t s = (cudaStream_t)stream;
  const int Tx = (X + dx - 1) / dx, Ty = (Y + dy - 1) / dy, Tz = (Z + dz - 1) / dz;
  const AdjointBoxes a{X,  Y,  Z,  c,  dx, dy, dz, Tx, Ty, Tz, bx, by, bz,
                       (Tx + bx - 1) / bx, (Ty + by - 1) / by, (Tz + bz - 1) / bz};
  if (bx * by * bz * c > cols) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (cols) {
    case 128: err = launch_boxes<128>(g, basis, partials, a, s); break;
    case 64: err = launch_boxes<64>(g, basis, partials, a, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const long long total = (long long)nx * ny * nz * c;
  const long long blocks = (total + kThreads - 1) / kThreads;
  adjoint_matmul_seam_kernel<<<(unsigned)(blocks < (1LL << 30) ? blocks : (1LL << 30)),
                               kThreads, 0, s>>>(partials, out, a, nx, ny, nz);
  return (int)cudaGetLastError();
}
