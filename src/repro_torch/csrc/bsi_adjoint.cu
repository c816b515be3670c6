// BSI adjoint: dense cotangent -> control-grid cotangent, in two forms.
//
// Separable form.  Replaces: the Pallas TPU kernel
// repro/kernels/bsi_adjoint.py:bsi_adjoint_separable_pallas (_kernel,
// _band_sum), dispatched by repro/kernels/ops.py:bsi_adjoint_pallas.
//
// What bounds it on an H100: reading the cotangent of the dense field once.
// At phantom1 (512, 228, 385) x 3 channels that is 539 MB, about 0.16 ms at
// 3.35 TB/s; the y-reduced intermediate hy, (X, Ny, Nz, C), adds 24 MB
// written and 24 MB read back (mostly from L2), 48 MB.  The arithmetic is
// 4*d multiply-adds per intermediate value, far below the fp32 rate.  An
// earlier design ran the z, y and x sweeps as three launches of one gather
// kernel, a thread per output decoding its place with 64-bit divisions and
// a z-reduced intermediate (X, Y, Nz, C) of 112 MB written and read back:
// 0.99 ms at phantom1 on an NVIDIA H100 80GB HBM3 at 700 W.
//
// What the design does about it: one streaming launch does the z and y
// sweeps, and the cotangent is read once.  A block owns one x plane, a run
// of its y tiles and a span of z control points (all of them at phantom1:
// kernels/bsi_adjoint.py:stream_blocks picks the geometry).  Its rows, each
// the z voxels its control points reach, stream through a ring of
// kStreamStages shared-memory slots by the bulk copy engine: one thread
// issues a row as one cp.async.bulk of the whole aligned 16-byte chunks
// from its start rounded down (a row is Z*C floats, 4620 bytes at phantom1,
// so rows start anywhere), completing on the slot's mbarrier, and the
// row's shift modulo 4 floats tells where its data begins in the slot; the
// next rows load while one is reduced.  A lane owns one z tile of one
// channel, its place decoded once: it loads the tile's dz voxels of each
// row (a warp's loads fall on distinct banks when dz*C is odd, 15 at
// phantom1) and forms the tile's four band sums with the z LUT in registers
// (the paper's tile, 5, with 3 channels; shared memory for any other
// tile); a control point takes one band from its own lane and one from each
// of the three lanes to its left by warp shuffles, so each voxel is loaded
// once, not four times, and no division is left in the loop over rows.  The
// y sweep runs in registers: a row at offset b of y tile ty adds
// wy[b, m] * hz to control point ty + m (m < 4), four rolling accumulators;
// when a y tile ends, point ty is complete and is written to the run's
// partial of hy, and the accumulators shift.  A second launch does the x
// sweep: a thread owns four x control points of one (y point, z point,
// channel), threads coalesced along (z point, channel), its place decoded
// once in 32-bit arithmetic; it reads the seven x tiles those points reach
// once, its taps unrolled (the paper's tile) so their loads are in flight
// together; hy(x, j) is the sum of the partials of the runs holding j (one
// run at phantom1).  No atomics: every sum is taken in a fixed order (z in
// band-then-voxel order, y in row order, the runs in run order, x in voxel
// order within a band and the bands from the last), so two calls give the
// same bits.
//
// bsi_adjoint_bf16, the backward of a compute_dtype="bfloat16" field,
// replaces the same Pallas kernel run on a bf16 cotangent (its LUTs float32,
// its sums float32: repro/kernels/ops.py:200-211).  The streaming kernel
// takes the cotangent's type: a bf16 row is staged as bf16 in the float32
// kernel's slots and widened as each value is loaded, and everything after
// the load is the float32 kernel's, so it gives that kernel's bits on
// g.float().  Bound at phantom1: 269.7 MB of bf16 cotangent read and 4.9 MB
// of grid written, 0.0820 ms at 3.35 TB/s.
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
//
// bsi_adjoint_matmul_bf16 replaces the same Pallas kernel run on a bf16
// cotangent (its basis and sums float32: repro/kernels/ops.py:200-211).  The
// box kernel takes the cotangent's type: a bf16 plane is staged as bf16 in
// the float32 kernel's ring and widened as it is moved into U, and
// everything after is the float32 kernel's, so it gives that kernel's bits
// on g.float().  Bound at phantom1: 269.7 MB of bf16 cotangent read and 4.9
// MB of grid written, 0.0820 ms.
//
// bsi_adjoint_f16 and bsi_adjoint_matmul_f16, the backward of a
// compute_dtype="float16" field, are the same code on an fp16 cotangent:
// each value widened exactly by __half2float (at phantom1 most of the
// reference's fp16 cotangent is subnormal or zero: no flag of the build
// flushes fp16 denormals), so each gives the float32 kernel's bits on
// g.float(); the same bounds.
#include "bsi_common.cuh"

namespace repro_torch {

// Where src's data begins in its 16-byte chunk, in elements of T.
template <typename T>
__device__ __forceinline__ int chunk_shift(const T* src) {
  return (int)(((size_t)src / sizeof(T)) & (16 / sizeof(T) - 1));
}

template <typename T>
__device__ __forceinline__ const T* align16(const T* p) {
  return (const T*)((size_t)p & ~(size_t)15);
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// One thread's copy of the 16-byte chunks that cover n elements of type T
// (float, or bf16 or fp16: 4 or 8 a chunk) from src into shared memory at dst
// (dst_p its generic address) by the bulk copy engine, completing on the
// mbarrier bar: the chunks from src rounded down, cut at the tensor's last
// whole chunk before `end`; the elements past that cut (the tensor's last
// row only) by plain loads.
template <typename T>
__device__ __forceinline__ void stage_bulk(unsigned dst, T* dst_p, unsigned bar,
                                           const T* src, int n, const T* end) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  const T* lo = align16(src);
  const T* hi = lo + E * ((src - lo + n + E - 1) / E);
  const T* cut = hi < align16(end) ? hi : align16(end);
  const unsigned bytes = cut > lo ? (unsigned)(sizeof(T) * (cut - lo)) : 0u;
  bar_expect_tx(bar, bytes);
  if (bytes)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(dst),
        "l"(lo), "r"(bytes), "r"(bar)
        : "memory");
  for (const T* p = cut > src ? cut : src; p < src + n && p < end; ++p) dst_p[p - lo] = *p;
}

#ifndef REPRO_SEP_SKIP  // measurement builds: 1 leaves out the row loads, 2 the
#define REPRO_SEP_SKIP 0  // z arithmetic, 4 the partials' stores (launch/profile_adjoint.py)
#endif
#ifndef REPRO_SEP_GENERAL  // measurement builds: 1 launches the streaming kernel built
#define REPRO_SEP_GENERAL 0  // for any tile and channels, 2 the x sweep built for any
#endif                       // tile (launch/profile_adjoint.py)

constexpr int kStreamStages = 4;  // ring slots of the streaming kernel: 3 rows in flight
constexpr int kStreamBarFloats = 4 * ((kStreamStages + 1) / 2);  // its mbarriers, 16-byte whole
constexpr int kStreamOutputs = 29;  // control points a warp of the streaming kernel owns
constexpr int kStreamThreads = 9 * 32;  // its threads a block, at most
constexpr int kXsweepPoints = 4;  // x control points a thread of the x sweep owns

// The separable adjoint's geometry (kernels/bsi_adjoint.py:StreamBlocks).
struct StreamGeo {
  int X, Y, Z, c;    // volume, channels
  int dy, dz;        // tile along y and z
  int Ty, nzh;       // y tiles; z control points the volume reaches, Tz + 3
  int span, cb;      // z control points and channels a block owns
  int nzp;           // blocks along z of one channel group: ceil(nzh / span)
  int run, runs;     // y tiles a block streams; runs: ceil(Ty / run)
  int slot;          // floats of a ring slot
};

// Floats of a row a block stages, at most: the z voxels of span + 3 tiles,
// all channels; a slot holds it as the 16-byte chunks that cover it.
__host__ __device__ inline int stream_segment(const StreamGeo& s) {
  const int z = (s.span + 3) * s.dz;
  return (z < s.Z ? z : s.Z) * s.c;
}
__host__ __device__ inline int stream_slot(const StreamGeo& s) {
  return 4 * ((stream_segment(s) + 6) / 4);
}
// Shared memory: an 8-byte mbarrier a slot (rounded up to 16 bytes), the
// ring, the y LUT and the z LUT (4 floats a voxel offset each).
// kernels/bsi_adjoint.py:stream_smem_bytes is the same sum.
inline size_t stream_smem(const StreamGeo& s) {
  return 4 * (kStreamBarFloats + (size_t)kStreamStages * s.slot + 4 * s.dy + 4 * s.dz);
}

// hyp[((x*runs + r)*(run + 3) + jl)*nzh*c + kz*c + ch]: the y-reduced
// cotangent of control point j = r*run + jl from the rows of run r's tiles
// (their bands that land on j, summed in row order), zero where none does.
//
// Block (x, r, part): plane x, y tiles [r*run, r*run + run), z control
// points [kz0, kz0 + nk) and channels [ch0, ch0 + ncb) of blockIdx.z's part.
// A lane owns one z tile of one channel: the block's lanes run over the
// channels, each as nk + 3 tiles t = kz0 - 3 .. kz0 + nk - 1 (the first
// three a halo), warp w taking entries 29w .. 29w + 31.  A row's lane loads
// its tile's dz voxels and forms the tile's four band sums p[n] (band n
// lands on control point t + n); control point kz = t then sums p[0] of its
// own lane and p[n] of the lane n to its left (shuffled up), n = 1..3: the
// same sums, in the same order, as hz = sum_n sum_a wz[a, n] * row[z = (kz -
// n)*dz + a], with the voxels outside the volume read as zeros.  Lanes 3..31
// whose tile is not a halo own that control point.  The rows stream through
// the ring: thread 0 issues row t's copy kStreamStages - 1 rows ahead of its
// reduction, behind a barrier that frees the slot it fills.
//
// T: the cotangent's element type, float, __nv_bfloat16 or __half
// (compute_dtype="bfloat16" or "float16": the backward of a bf16 or fp16
// field).  A 2-byte row is staged as it is, in the 16-byte chunks that
// cover it (8 values each; the row's shift in its first chunk is 0..7
// values, and a row may start on an odd value), within the float32
// kernel's slots, which hold it with room to spare; each value widens
// exactly as it is loaded (an fp16 subnormal too: to_float).  The geometry, the LUTs,
// the arithmetic and its order are the float32 kernel's, so on g.float()
// that kernel gives the same bits.
template <int C, int D, typename T>
__global__ void __launch_bounds__(kStreamThreads, 4)
    adjoint_stream_kernel(const T* __restrict__ g, const float* __restrict__ wy,
                          const float* __restrict__ wz, float* __restrict__ hyp,
                          StreamGeo s) {
  extern __shared__ float smem[];
  const int c = C ? C : s.c, dz = D ? D : s.dz;
  const int x = blockIdx.x, r = blockIdx.y;
  const int zp = blockIdx.z % s.nzp, cp = blockIdx.z / s.nzp;
  const int kz0 = zp * s.span, nk = min(s.span, s.nzh - kz0);
  const int ch0 = cp * s.cb, ncb = min(s.cb, c - ch0);
  const int zs0 = max(0, (kz0 - 3) * dz), zs1 = min(s.Z, (kz0 + nk) * dz);
  const int seg = (zs1 - zs0) * c;  // > 0: kz0 < Tz + 3 reaches the volume
  const int t0 = r * s.run, nt = min(s.run, s.Ty - t0);  // the run's y tiles
  const int nrows = min(s.Y, (t0 + nt) * s.dy) - t0 * s.dy;
  float* ring = smem + kStreamBarFloats;  // after the slots' mbarriers
  float* s_wy = ring + kStreamStages * s.slot;
  float* s_wz = s_wy + 4 * s.dy;
  for (int i = threadIdx.x; i < 4 * s.dy; i += blockDim.x) s_wy[i] = wy[i];
  if (!D)
    for (int i = threadIdx.x; i < 4 * dz; i += blockDim.x) s_wz[i] = wz[i];
  const unsigned bars = (unsigned)__cvta_generic_to_shared(smem);
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStreamStages; ++i) bar_init(bars + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this lane's tile and control point, decoded once; its voxels in the
  // volume and the part (na of them) start at place in a staged row
  const int lane = threadIdx.x & 31;
  const int u = (threadIdx.x >> 5) * kStreamOutputs + lane, per = nk + 3;
  const int ch = ch0 + u / per, e = u % per, kz = kz0 - 3 + e;
  const bool owner = lane >= 3 && e >= 3 && u < ncb * per;
  const int na = u < ncb * per && kz >= 0 ? max(0, min(dz, zs1 - kz * dz)) : 0;
  const int place = (kz * dz - zs0) * c + ch;
  float w[D ? 4 * D : 1];
#pragma unroll
  for (int i = 0; i < (D ? 4 * D : 0); ++i) w[i] = __ldg(wz + i);

  const size_t zrow = (size_t)s.Z * c;
  const T* rows = g + ((size_t)x * s.Y + t0 * s.dy) * zrow + (size_t)zs0 * c;
  const T* g_end = g + (size_t)s.X * s.Y * zrow;
  const unsigned ring_s = (unsigned)__cvta_generic_to_shared(ring);
  auto stage = [&](int t) {  // thread 0 issues row t into slot t % kStreamStages
    const int k = t % kStreamStages;
    if (REPRO_SEP_SKIP & 1)
      bar_expect_tx(bars + 8 * k, 0);
    else
      stage_bulk(ring_s + 4u * k * s.slot, reinterpret_cast<T*>(ring + k * s.slot),
                 bars + 8 * k, rows + (size_t)t * zrow, seg, g_end);
  };
  if (threadIdx.x == 0)
    for (int t = 0; t < kStreamStages - 1 && t < nrows; ++t) stage(t);

  const int stride = s.nzh * c;  // floats of one control point's partial row
  float* part = hyp + ((size_t)x * s.runs + r) * (s.run + 3) * stride + kz * c + ch;
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int b = 0, jl = 0;  // the row's offset in its y tile; the run's tile
  for (int t = 0; t < nrows; ++t) {
    bar_wait(bars + 8 * (t % kStreamStages), (t / kStreamStages) & 1);  // row t has landed
    __syncthreads();  // every thread is past row t - 1: its slot is free again
    if (threadIdx.x == 0 && t + kStreamStages - 1 < nrows) stage(t + kStreamStages - 1);
    float hz;
    if (REPRO_SEP_SKIP & 2) {
      hz = (float)t;
    } else {
      const T* row = reinterpret_cast<const T*>(ring + (t % kStreamStages) * s.slot) +
                     chunk_shift(rows + (size_t)t * zrow) + place;
      float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;  // the tile's band sums
#pragma unroll
      for (int a = 0; a < (D ? D : dz); ++a) {
        const float v = a < na ? to_float(row[a * c]) : 0.f;
        const float* wa = D ? w + 4 * a : s_wz + 4 * a;
        p0 = fmaf(wa[0], v, p0);
        p1 = fmaf(wa[1], v, p1);
        p2 = fmaf(wa[2], v, p2);
        p3 = fmaf(wa[3], v, p3);
      }
      hz = p0 + __shfl_up_sync(0xffffffffu, p1, 1);
      hz += __shfl_up_sync(0xffffffffu, p2, 2);
      hz += __shfl_up_sync(0xffffffffu, p3, 3);
    }
    const float4 wb = reinterpret_cast<const float4*>(s_wy)[b];
    acc0 = fmaf(wb.x, hz, acc0);
    acc1 = fmaf(wb.y, hz, acc1);
    acc2 = fmaf(wb.z, hz, acc2);
    acc3 = fmaf(wb.w, hz, acc3);
    if (++b == s.dy || t == nrows - 1) {  // y tile jl ends: control point jl is complete
#if REPRO_SEP_SKIP & 4
      if (acc0 == -1.25e-30f)  // never true here: keeps the sums, drops the store
#endif
        if (owner) part[(size_t)jl * stride] = acc0;
      acc0 = acc1, acc1 = acc2, acc2 = acc3, acc3 = 0.f;
      b = 0, ++jl;
    }
  }
  if (owner && !(REPRO_SEP_SKIP & 4)) {  // the run's last three points, and zeros past them
    part[(size_t)nt * stride] = acc0;
    part[(size_t)(nt + 1) * stride] = acc1;
    part[(size_t)(nt + 2) * stride] = acc2;
    for (int j = nt + 3; j < s.run + 3; ++j) part[(size_t)j * stride] = 0.f;
  }
}

// out[i, j, q] = sum_l sum_a wx[a, l] * hy(x = (i - l)*dx + a, j, q) for q
// = kz*c + ch, the taps outside [0, X) skipped: each band's sum over a in
// voxel order, the bands added in descending order (l = 3 first); hy(x, j,
// q) is the sum of the partials of the runs holding j, in run order: run r
// holds [r*run, r*run + run + 3), and run >= 3 (or one run), so at most runs
// rlo and rlo + 1 do.  0 where q is past the points the volume reaches.  A
// thread owns kXsweepPoints points i0 .. i0 + P - 1 of one (j, q): it walks
// the x tiles i0 - 3 .. i0 + P - 1 once, forming each tile's four band sums
// and adding band l to point t + l, so a tile is read once for all P.
// Block (i0 / P * ny + j, q / blockDim.x), its place decoded once.  D > 0:
// the tile along x fixed, the x LUT in registers and the taps unrolled, so
// a thread's loads are in flight together; else the LUT, 4*dx floats, in
// dynamic shared memory.
template <int D>
__global__ void __launch_bounds__(kThreads)
    adjoint_xsweep_kernel(const float* __restrict__ hyp, const float* __restrict__ wx,
                          float* __restrict__ out, StreamGeo s, int dx, int nx, int ny,
                          int nz) {
  extern __shared__ float s_wx[];
  if (!D) {
    for (int k = threadIdx.x; k < 4 * dx; k += blockDim.x) s_wx[k] = wx[k];
    __syncthreads();
  }
  const int nq = nz * s.c, hq = s.nzh * s.c;
  const int q = blockIdx.y * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  const int ib = blockIdx.x / ny, j = blockIdx.x - ib * ny, i0 = ib * kXsweepPoints;
  const int rlo = j >= 3 ? (j - 3) / s.run : 0, rhi = min(s.runs - 1, j / s.run);
  const int d = D ? D : dx;
  float acc[kXsweepPoints] = {};
  if (q < hq && rlo <= rhi) {
    // point j of run rlo's partial at plane 0; run rlo + 1's is 3 rows on
    const float* p0 = hyp + ((size_t)rlo * (s.run + 3) + j - rlo * s.run) * hq + q;
    const bool two = rhi > rlo;
    const size_t plane = (size_t)s.runs * (s.run + 3) * hq;  // floats of a plane's partials
    float w[D ? 4 * D : 1];
#pragma unroll
    for (int k = 0; k < (D ? 4 * D : 0); ++k) w[k] = __ldg(wx + k);
#pragma unroll
    for (int k = 0; k < kXsweepPoints + 3; ++k) {  // tile i0 - 3 + k
      const int x0 = (i0 - 3 + k) * d;
      float p[4] = {};
#pragma unroll
      for (int a = 0; a < d; ++a) {
        const int x = x0 + a;
        if (x < 0 || x >= s.X) continue;
        const float* h = p0 + (size_t)x * plane;
        const float v = two ? h[0] + h[3 * hq] : h[0];
#pragma unroll
        for (int l = 0; l < 4; ++l) p[l] = fmaf(D ? w[a * 4 + l] : s_wx[a * 4 + l], v, p[l]);
      }
#pragma unroll
      for (int l = 0; l < 4; ++l)  // band l of tile i0 - 3 + k lands on point i0 + k - 3 + l
        if (k - 3 + l >= 0 && k - 3 + l < kXsweepPoints) acc[k - 3 + l] += p[l];
    }
  }
#pragma unroll
  for (int o = 0; o < kXsweepPoints; ++o)
    if (i0 + o < nx) out[((size_t)(i0 + o) * ny + j) * nq + q] = acc[o];
}

template <int C, int D, typename T>
inline cudaError_t launch_stream(const T* g, const float* wy, const float* wz, float* hyp,
                                 const StreamGeo& s, int threads, int ncp,
                                 cudaStream_t stream) {
  const size_t smem = stream_smem(s);
  cudaError_t err = allow_smem(adjoint_stream_kernel<C, D, T>, smem);
  if (err != cudaSuccess) return err;
  adjoint_stream_kernel<C, D, T><<<dim3(s.X, s.runs, s.nzp * ncp), threads, smem, stream>>>(
      g, wy, wz, hyp, s);
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
__device__ __forceinline__ void cp_async_16(unsigned dst, const void* src, int bytes) {
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
//
// T: the cotangent's element type, float, __nv_bfloat16 or __half (the
// backward of a bf16 or fp16 field).  A 2-byte row is staged as it is, in
// the 16-byte chunks that cover it (8 values each, the row's shift 0..7
// values), within the float32 kernel's slots, and widened as the plane is
// moved into U; the basis (the
// float32 one), the geometry and every sum are the float32 kernel's, so on
// g.float() that kernel gives the same bits.
template <int COLS, typename T>
__device__ __forceinline__ void adjoint_matmul_box(const T* __restrict__ g,
                                                   const float* __restrict__ basis,
                                                   float* __restrict__ partials,
                                                   const AdjointBoxes& a) {
  constexpr int E = 16 / sizeof(T);  // values of a 16-byte chunk
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
  const T* g_end = g + (size_t)a.X * a.Y * zrow;
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
      const T* src = g + ((size_t)x * a.Y + y) * zrow + zc0;
      const T* lo = (const T*)((size_t)src & ~(size_t)15);
      const int chunks = (int)((src - lo + row_len + E - 1) / E);
      for (int i = lane; i < chunks; i += 32) {
        const T* p = lo + E * i;
        const long long left = g_end - p;
        const int bytes = left >= E ? 16 : (left > 0 ? (int)sizeof(T) * (int)left : 0);
        cp_async_16(slot + 4u * r * RS + 16u * i, bytes ? (const void*)p : g, bytes);
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
        const T* row = g + ((size_t)x * a.Y + y) * zrow + zc0;  // as staged
        const T* src = reinterpret_cast<const T*>(raw + r * RS) +
                       (int)(((size_t)row / sizeof(T)) & (E - 1));
        float* dst = s_u + s_rdst[r];
        if (row_len <= 32 * kLaneFloats) {  // a lane's places held in registers
          float val[kLaneFloats];
#pragma unroll
          for (int j = 0; j < kLaneFloats; ++j)
            val[j] = lane + 32 * j < n ? to_float(src[lane + 32 * j]) : 0.f;
#pragma unroll
          for (int j = 0; j < kLaneFloats; ++j)
            if (zoff[j] >= 0) dst[zoff[j]] = val[j];
        } else {
          for (int e = lane; e < row_len; e += 32)
            dst[s_zoff[e]] = e < n ? to_float(src[e]) : 0.f;
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

template <int COLS>
__global__ void __launch_bounds__(2 * COLS)
    adjoint_matmul_box_kernel(const float* __restrict__ g, const float* __restrict__ basis,
                              float* __restrict__ partials, AdjointBoxes a) {
  adjoint_matmul_box<COLS>(g, basis, partials, a);
}

// The same on a bf16 cotangent.
template <int COLS>
__global__ void __launch_bounds__(2 * COLS)
    adjoint_matmul_box_bf16_kernel(const __nv_bfloat16* __restrict__ g,
                                   const float* __restrict__ basis,
                                   float* __restrict__ partials, AdjointBoxes a) {
  adjoint_matmul_box<COLS>(g, basis, partials, a);
}

// The same on an fp16 cotangent.
template <int COLS>
__global__ void __launch_bounds__(2 * COLS)
    adjoint_matmul_box_f16_kernel(const __half* __restrict__ g,
                                  const float* __restrict__ basis,
                                  float* __restrict__ partials, AdjointBoxes a) {
  adjoint_matmul_box<COLS>(g, basis, partials, a);
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

// The persistent box launch of the kernel for COLS and T: as many blocks as
// the card holds at once.
template <int COLS, typename T>
inline cudaError_t launch_boxes(const T* g, const float* basis, float* partials,
                                const AdjointBoxes& a, cudaStream_t stream) {
  void (*kernel)(const T*, const float*, float*, AdjointBoxes);
  if constexpr (kIsFloat<T>) kernel = adjoint_matmul_box_kernel<COLS>;
  else if constexpr (kIsBf16<T>) kernel = adjoint_matmul_box_bf16_kernel<COLS>;
  else kernel = adjoint_matmul_box_f16_kernel<COLS>;
  const size_t smem = adjoint_box_smem(a, COLS);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 2 * COLS, smem);
  if (err != cudaSuccess) return err;
  const long long nboxes = (long long)a.nbx * a.nby * a.nbz;
  const long long slots = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  const unsigned grid = (unsigned)(nboxes < slots ? nboxes : slots);
  kernel<<<grid, 2 * COLS, smem, stream>>>(g, basis, partials, a);
  return cudaGetLastError();
}

// The matmul adjoint of a cotangent of element type T: the box launch, then
// the seam pass (float32 partials in, float32 out).
template <typename T>
inline int adjoint_matmul(const T* g, const float* basis, float* partials, float* out,
                          int X, int Y, int Z, int c, int nx, int ny, int nz, int dx,
                          int dy, int dz, int bx, int by, int bz, int cols, void* stream) {
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

}  // namespace repro_torch

namespace repro_torch {

// The separable adjoint of a cotangent of element type T: the streaming
// launch, then the x sweep (float32 partials in, float32 out).
template <typename T>
inline int adjoint_separable(const T* g, const float* wx, const float* wy, const float* wz,
                             float* hyp, float* out, int X, int Y, int Z, int c, int nx,
                             int ny, int nz, int dx, int dy, int dz, int span, int cb,
                             int run, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int Ty = (Y + dy - 1) / dy, Tz = (Z + dz - 1) / dz;
  if (span < 1 || cb < 1 || run < (Ty < 3 ? Ty : 3) || threads > kStreamThreads ||
      threads % 32 || cb * (span + 3) > kStreamOutputs * (threads / 32) + 3 ||
      nz < Tz + 3 || ny < Ty + 3)
    return (int)cudaErrorInvalidValue;
  StreamGeo s{X, Y, Z, c, dy, dz, Ty, Tz + 3, span, cb, (Tz + 3 + span - 1) / span, run,
              (Ty + run - 1) / run, 0};
  s.slot = stream_slot(s);
  const int ncp = (c + cb - 1) / cb;
  cudaError_t err = !(REPRO_SEP_GENERAL & 1) && c == 3 && dz == 5
                        ? launch_stream<3, 5>(g, wy, wz, hyp, s, threads, ncp, st)
                        : launch_stream<0, 0>(g, wy, wz, hyp, s, threads, ncp, st);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nx + kXsweepPoints - 1) / kXsweepPoints * ny,
                  (nz * c + kThreads - 1) / kThreads);
  if (!(REPRO_SEP_GENERAL & 2) && dx == 5) {
    adjoint_xsweep_kernel<5><<<grid, kThreads, 0, st>>>(hyp, wx, out, s, dx, nx, ny, nz);
  } else {
    const size_t lut = 16 * (size_t)dx;
    if ((err = allow_smem(adjoint_xsweep_kernel<0>, lut)) != cudaSuccess) return (int)err;
    adjoint_xsweep_kernel<0><<<grid, kThreads, lut, st>>>(hyp, wx, out, s, dx, nx, ny, nz);
  }
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// g: (X, Y, Z, c) float32 cotangent of the field cropped to the volume;
// wx, wy, wz: the (d, 4) weight LUTs; hyp: X*runs*(run + 3)*(Tz + 3)*c floats
// of scratch, runs = ceil(ceil(Y/dy)/run); out: (nx, ny, nz, c).  (span,
// cb): z control points and channels a block owns, cb * (span + 3) lanes
// of `threads` (29 owners a warp); run: y tiles a block streams, at least 3
// or all of them (kernels/bsi_adjoint.py:stream_blocks).  Returns the first
// cudaError_t.
extern "C" int bsi_adjoint_f32(const float* g, const float* wx, const float* wy,
                               const float* wz, float* hyp, float* out, int X, int Y,
                               int Z, int c, int nx, int ny, int nz, int dx, int dy, int dz,
                               int span, int cb, int run, int threads, void* stream) {
  return repro_torch::adjoint_separable(g, wx, wy, wz, hyp, out, X, Y, Z, c, nx, ny, nz, dx,
                                        dy, dz, span, cb, run, threads, stream);
}

// The same on a bf16 cotangent (the backward of a bf16 field): float32 LUTs,
// sums and output, the float32 entry's geometry.
extern "C" int bsi_adjoint_bf16(const __nv_bfloat16* g, const float* wx, const float* wy,
                                const float* wz, float* hyp, float* out, int X, int Y,
                                int Z, int c, int nx, int ny, int nz, int dx, int dy,
                                int dz, int span, int cb, int run, int threads,
                                void* stream) {
  return repro_torch::adjoint_separable(g, wx, wy, wz, hyp, out, X, Y, Z, c, nx, ny, nz, dx,
                                        dy, dz, span, cb, run, threads, stream);
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
  return repro_torch::adjoint_matmul(g, basis, partials, out, X, Y, Z, c, nx, ny, nz, dx,
                                     dy, dz, bx, by, bz, cols, stream);
}

// The same on a bf16 cotangent (the backward of a bf16 field): the float32
// basis, partials and output, the float32 entry's geometry.
extern "C" int bsi_adjoint_matmul_bf16(const __nv_bfloat16* g, const float* basis,
                                       float* partials, float* out, int X, int Y, int Z,
                                       int c, int nx, int ny, int nz, int dx, int dy,
                                       int dz, int bx, int by, int bz, int cols,
                                       void* stream) {
  return repro_torch::adjoint_matmul(g, basis, partials, out, X, Y, Z, c, nx, ny, nz, dx,
                                     dy, dz, bx, by, bz, cols, stream);
}

// The same on an fp16 cotangent (the backward of an fp16 field): float32
// LUTs, sums and output, the float32 entry's geometry.
extern "C" int bsi_adjoint_f16(const __half* g, const float* wx, const float* wy,
                               const float* wz, float* hyp, float* out, int X, int Y, int Z,
                               int c, int nx, int ny, int nz, int dx, int dy, int dz,
                               int span, int cb, int run, int threads, void* stream) {
  return repro_torch::adjoint_separable(g, wx, wy, wz, hyp, out, X, Y, Z, c, nx, ny, nz, dx,
                                        dy, dz, span, cb, run, threads, stream);
}

// The same on an fp16 cotangent: the float32 basis, partials and output, the
// float32 entry's geometry.
extern "C" int bsi_adjoint_matmul_f16(const __half* g, const float* basis, float* partials,
                                      float* out, int X, int Y, int Z, int c, int nx,
                                      int ny, int nz, int dx, int dy, int dz, int bx,
                                      int by, int bz, int cols, void* stream) {
  return repro_torch::adjoint_matmul(g, basis, partials, out, X, Y, Z, c, nx, ny, nz, dx,
                                     dy, dz, bx, by, bz, cols, stream);
}
