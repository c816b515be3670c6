// Forward BSI, matrix form (Wu & Zou), on the tensor cores: for each (x tile,
// y tile) the field is the product out[v, (tk, ch)] = sum_k B[v, k] *
// W[k, (tk, ch)] of the (d^3, 64) Kronecker basis B and the column matrix W
// of the control window, k = (l*4 + m)*4 + n and W[k, (tk, ch)] = phi[tx +
// l, ty + m, tk + n, ch].
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_matmul.py:bsi_matmul_pallas
// (_kernel, kron_basis, contract_window), dispatched by
// repro/kernels/ops.py:bsi_pallas(mode="matmul").
//
// What bounds it on an H100: the bytes.  It reads the control grid once and
// writes the field once: 544.3 MB at the paper's phantom1 volume (512, 228,
// 385), tile 5^3, 3 channels, 0.1625 ms at 3.35 TB/s.  Its own products come
// near that: three TF32 products of d^3 (padded to whole 64-row tiles) by
// each unit's columns (padded to whole 8s), 54.0 GFLOP, 0.109 ms at 495
// TFLOP/s (launch/bounds.py:matmul_tf32_ms).
//
// Rounding: B and W are each split into hi + lo, hi the nearest TF32 of the
// float32 value (tf32_rna: ties away from zero) and lo the nearest TF32 of
// the rest; B's split is done once on the host
// (kernels/bsi_matmul.py:basis_fragments), W's once per staged control
// value.  Each k-step of 8 adds lo_B hi_W, then hi_B lo_W into one
// accumulator and hi_B hi_W into another (lo_B lo_W, about 2^-24 of a
// term, is dropped), each with the tensor cores' own float32 accumulation;
// the two are added once at the end.  The small products keep an
// accumulator of their own so that the tensor cores' truncating
// accumulation costs them nothing at the scale of the result: 8 rounded
// steps of the large one, not 24.  So the kernel does not round as
// kernels/bsi_matmul.py:plain does (64 rounded products and adds in order
// k); it is held to it at 1e-5 absolute.
//
// What the design does about the bytes:
// - Work unit: one (x tile, y tile) and a chunk of zt whole z tiles (zt * c
//   columns, 48 at most past one z tile; fewer where the staging would not
//   fit: kernels/bsi_matmul.py:matmul_blocks).  Persistent blocks, two an
//   SM, walk the units round robin.
// - The products are wgmma.m64n24k8 TF32 of the two warpgroups, each on a
//   64-row tile of voxel offsets and a half of the columns (a task): A = B's
//   fragments in registers (64 a thread, loaded once from the host-built
//   table, again per task only where the 64-row tiles outnumber the
//   warpgroups), W^T from shared memory, K-major, its 32-byte rows in the
//   32-byte swizzle.  mma.sync would read each fragment of W by shared
//   loads, 4 warp loads per 3 products: those loads, not the tensor cores,
//   then set the pace.
// - W^T is built once a unit, hi and lo, from the unit's control values:
//   16 rows (l, m) of (zt + 3) * c consecutive grid floats, copied by one
//   16-byte cp.async a thread (each row from its start rounded down to 16
//   bytes) while the previous unit's products run.  Row n of W^T at k-step
//   2 l + m / 2 holds the 4 values W[(l, m, 0..3), n] = row (l, m) at n, n
//   + c, n + 2 c, n + 3 c: one 16-byte store each, hi and lo.
// - Epilogue: each accumulator entry goes to a staging buffer in the field's
//   order, one run of zt * dz * c floats a voxel column (a, b), placed so
//   that it shares its place's alignment modulo 16 bytes.  Each run then
//   leaves by one bulk copy (TMA) of its 16-byte-aligned body, the few
//   floats at its ends by lanes; rows past d^3, columns past the unit and
//   voxels outside (X, Y, Z) are never stored.  Two staging buffers: a
//   unit's stores overlap the next unit's products.  No atomics: two calls
//   are bit-equal.
//
// bsi_matmul_bf16, the compute_dtype="bfloat16" variant, replaces the same
// Pallas kernel run on a bf16 grid (its operands bf16, its product float32,
// its field phi's dtype: repro/kernels/bsi_matmul.py:88-90): the bf16 rows
// copied as they are, widened into W^T (exact in TF32, as the bf16 basis
// is), one wgmma a k-step, one rounding to bf16 at the staging.  Bound at
// phantom1: 269.7 MB of bf16 field and 2.5 MB of grid, 0.0812 ms.
// bsi_matmul_f16, the compute_dtype="float16" variant, is the same code on
// __half: an fp16 value and the fp16 basis (basis_matrix(tile, float16),
// rounded once) are exact in TF32 too, so it is one wgmma a k-step and one
// rounding to fp16 at the staging, the bits of the float32 kernel on the
// widened grid with the fp16 basis's fragments, rounded once; the same
// bound.
//
// Measurement builds (-DREPRO_MM_SKIP=mask, launch/profile_forward.py): 1
// leaves out the stores to the field (the sums are kept), 2 the products (a
// constant is staged and stored at the same positions), 4 the window's copy
// and W^T's build; 6 is the stores alone.
#include <cstdint>

#include "bsi_common.cuh"

#ifndef REPRO_MM_SKIP
#define REPRO_MM_SKIP 0
#endif

namespace repro_torch {

constexpr int kHalf = 24;                // columns of a task: the wgmma's N
constexpr int kGroups = kThreads / 128;  // warpgroups a block

struct MMBlock {
  int nx, ny, nz, c;  // stored control points per axis, channels
  int dx, dy, dz;     // tile: voxels per control interval
  int X, Y, Z;        // the volume written
  int zt;             // z tiles a unit
};

// n-halves of a unit: its columns in whole kHalf
__host__ __device__ inline int mm_halves(const MMBlock& g) {
  return (g.zt * g.c + kHalf - 1) / kHalf;
}
// 64-row tiles of the d^3 voxel offsets
__host__ __device__ inline int mm_mgroups(const MMBlock& g) {
  return (g.dx * g.dy * g.dz + 63) / 64;
}
// A raw window row: (zt + 3) * c floats from their start rounded down to 16
// bytes, in whole 16 bytes.
__host__ __device__ inline int mm_raw_row(const MMBlock& g) {
  return ((g.zt + 3) * g.c + 3 + 3) / 4 * 4;
}
// A staged run's slot: zt * dz * c floats, an offset of up to 3, in 16 bytes.
__host__ __device__ inline int mm_run(const MMBlock& g) {
  return (g.zt * g.dz * g.c + 3) / 4 * 4 + 4;
}
// W^T's bytes, hi or lo: 8 k-steps of halves * kHalf rows of 32 bytes
__host__ __device__ inline int mm_wt_bytes(const MMBlock& g) {
  return 8 * mm_halves(g) * kHalf * 32;
}
// Shared memory in bytes: [alignment slack | W^T hi | W^T lo | two
// stagings of dx * dy runs | the raw window, 16 rows]
__host__ __device__ inline size_t mm_smem_bytes(const MMBlock& g) {
  return 1024 + (size_t)2 * mm_wt_bytes(g) + (size_t)2 * g.dx * g.dy * mm_run(g) * 4 +
         (size_t)16 * mm_raw_row(g) * 4;
}

// A wgmma shared-memory descriptor of a K-major tile in the 32-byte swizzle:
// rows of 32 bytes, 8-row groups 256 bytes apart (the start 256-byte
// aligned, so the base offset is 0).
__device__ __forceinline__ uint64_t wt_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(16 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32) | (3ull << 62);
}

// D(64 x 24, fp32) (+)= A(64 x 8, tf32 registers) B(8 x 24), B K-major in
// shared memory; accumulate = 0 ignores D's old value.
__device__ __forceinline__ void wgmma_tf32_n24(float (&d)[12], const unsigned (&a)[4],
                                               uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The wgmma of a warpgroup: registers and shared memory written before made
// visible to them; issued ones grouped; all waited for, and the compiler
// kept from touching their accumulators before the wait.
__device__ __forceinline__ void mm_wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void mm_wgmma_commit_wait(float (&d0)[12], float (&d1)[12]) {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 12; ++i) asm volatile("" : "+f"(d0[i]), "+f"(d1[i])::"memory");
}

// A unit's place: x tile, y tile, chunk of z tiles.
struct Unit {
  int ti, tj, h;
};

// C: the channels (3), or 0 for any.  T: the element type of the grid and
// the field, float, __nv_bfloat16 or __half.  A bf16 or fp16 grid's rows
// are copied as they are (E = 8 values a 16-byte chunk) and widened where
// W^T is built; a bf16 or fp16 value is exact in TF32 (at most 11
// significant bits, fp16's subnormals inside float32's exponents), and so
// is the basis of that type (basis_fragments: its lo parts are zero), so
// only the hi_B hi_W product runs, into the float32 kernel's accumulator in
// its order, and each value is rounded once where it is staged; the runs'
// alignment and stores count E values to 16 bytes.
template <int C, typename T>
__device__ __forceinline__ void mm_block(const T* __restrict__ phi,
                                         const uint4* __restrict__ afrag,
                                         T* __restrict__ out, const MMBlock& g) {
  constexpr bool kWide = kIsFloat<T>;
  constexpr int E = 16 / sizeof(T);  // values of a 16-byte chunk
  extern __shared__ float4 smem4[];
  const int c = C ? C : g.c;
  // a raw window row's and a staged run's slot, in floats; run_t: the
  // run's slot in values of T
  const int raw_row = mm_raw_row(g), run = mm_run(g), ncol = g.dx * g.dy;
  const int run_t = run * (int)(sizeof(float) / sizeof(T));
  const int halves = mm_halves(g), wt_bytes = mm_wt_bytes(g);
  // W^T on a 1024-byte boundary (the swizzle repeats every 256 bytes)
  const uint32_t s_base = (uint32_t)__cvta_generic_to_shared(smem4);
  const uint32_t wt_hi = (s_base + 1023) & ~1023u, wt_lo = wt_hi + wt_bytes;
  unsigned char* wt_ptr = reinterpret_cast<unsigned char*>(smem4) + (wt_hi - s_base);
  float* s_stage = reinterpret_cast<float*>(wt_ptr + 2 * wt_bytes);  // 2 x ncol x run
  float* s_raw = s_stage + 2 * ncol * run;                             // 16 x raw_row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, wq = warp & 3;  // warpgroup, warp in it
  const int gq = lane >> 2, tq = lane & 3;
  const int tx = (g.X + g.dx - 1) / g.dx, ty = (g.Y + g.dy - 1) / g.dy,
            tz = (g.Z + g.dz - 1) / g.dz;
  const int chunks = (tz + g.zt - 1) / g.zt;
  const int units = tx * ty * chunks;
  const int nv = g.dx * g.dy * g.dz, mg = mm_mgroups(g);
  const int tasks = mg * halves;  // (64-row tile, n-half), the tile fastest
  const bool a_fixed = mg <= kGroups;
  const unsigned obase = (unsigned)(reinterpret_cast<size_t>(out) / sizeof(T));

  // Units are walked with a stride of the grid, each place stepped from the
  // last without a division.
  const int G = gridDim.x, sh = G % chunks, sj = G / chunks % ty, si = G / chunks / ty;
  auto next_unit = [&](Unit p) {
    p.h += sh;
    const int carry = p.h >= chunks;
    p.h -= carry ? chunks : 0;
    p.tj += sj + carry;
    const int carry2 = p.tj >= ty;
    p.tj -= carry2 ? ty : 0;
    p.ti += si + carry2;
    return p;
  };
  // row wr = (l, m) of unit p: its first value in the grid
  auto row_src = [&](Unit p, int wr) -> const T* {
    return phi +
           ((size_t)((p.ti + (wr >> 2)) * g.ny + p.tj + (wr & 3)) * g.nz + p.h * g.zt) * c;
  };

  // The window's copy: thread tid copies 16-byte chunks tid % 16 + 16 i of
  // row tid / 16, from the row's start rounded down to 16 bytes; the bytes
  // past the unit's values read as zeros.
  auto copy_window = [&](Unit p) {
    const int wr = tid >> 4;
    const int nval = (min(g.zt, tz - p.h * g.zt) + 3) * c;
    const T* src = row_src(p, wr);
    const int shift = (int)(reinterpret_cast<size_t>(src) & 15) / (int)sizeof(T);
    const T* base = src - shift;
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s_raw + wr * raw_row);
    for (int q = tid & 15; E * q < shift + nval; q += 16) {
      const int valid = min(shift + nval - E * q, E);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst + 16 * q),
                   "l"(base + E * q), "r"((int)sizeof(T) * valid)
                   : "memory");
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };
  // W^T of unit p from the raw window (after a barrier: threads read the
  // rows others copied).  Job (row wr, column n): the values at n + i c, i <
  // 4, of row wr, split, to row n of k-step 2 l + m / 2, 16-byte chunk m % 2
  // (swizzled); columns past the unit's are zeros.  Then visible to wgmma.
  auto build_wt = [&](Unit p) {
    const int ncols = min(g.zt, tz - p.h * g.zt) * c, nrows = halves * kHalf;
    for (int job = tid; job < 16 * nrows; job += kThreads) {
      const int wr = job / nrows, n = job - wr * nrows;
      const T* r = reinterpret_cast<const T*>(s_raw + wr * raw_row) +
                   (int)(reinterpret_cast<size_t>(row_src(p, wr)) & 15) / (int)sizeof(T);
      uint4 hi = make_uint4(0, 0, 0, 0), lo = hi;
      if (n < ncols) {
        split_tf32(to_float(r[n]), &hi.x, &lo.x);
        split_tf32(to_float(r[n + c]), &hi.y, &lo.y);
        split_tf32(to_float(r[n + 2 * c]), &hi.z, &lo.z);
        split_tf32(to_float(r[n + 3 * c]), &hi.w, &lo.w);
      }
      const int s = (wr >> 2) * 2 + ((wr >> 1) & 1), q = (wr & 1) ^ ((n >> 2) & 1);
      const int off = s * nrows * 32 + n * 32 + q * 16;
      *reinterpret_cast<uint4*>(wt_ptr + off) = hi;
      if (kWide) *reinterpret_cast<uint4*>(wt_ptr + wt_bytes + off) = lo;  // bf16, fp16: 0
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  };

  // The warp's A fragments: (8 k-steps, hi / lo, 32 lanes) uint4s of its m16
  // slice of the 64-row tile; and the lane's two rows v = 64 mi + 16 wq + g
  // (+8): its voxel offset (a, b, cz), and whether it lies in d^3.
  unsigned ah[8][4], al[8][4];
  int ra[2], rb[2], rz[2];
  bool rok[2];
  auto load_tile = [&](int mi) {
    const uint4* p = afrag + (size_t)(4 * mi + wq) * 8 * 2 * 32 + lane;
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint4 h4 = __ldg(p + (2 * s) * 32), l4 = __ldg(p + (2 * s + 1) * 32);
      ah[s][0] = h4.x, ah[s][1] = h4.y, ah[s][2] = h4.z, ah[s][3] = h4.w;
      al[s][0] = l4.x, al[s][1] = l4.y, al[s][2] = l4.z, al[s][3] = l4.w;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int v = 64 * mi + 16 * wq + gq + 8 * e;
      rok[e] = v < nv;
      ra[e] = v / (g.dy * g.dz);
      const int rem = v - ra[e] * g.dy * g.dz;
      rb[e] = rem / g.dz;
      rz[e] = rem - rb[e] * g.dz;
    }
  };
  if (a_fixed && wg < tasks) load_tile(wg % mg);

  Unit cur{0, 0, 0};
  if ((int)blockIdx.x < units) {
    const int r = blockIdx.x / chunks;
    cur = Unit{r / ty, r - r / ty * ty, (int)blockIdx.x - r * chunks};
#if !(REPRO_MM_SKIP & 4)
    copy_window(cur);
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    build_wt(cur);
#endif
  }
  for (int u = blockIdx.x, it = 0; u < units; u += G, ++it) {
    const int ti = cur.ti, tj = cur.tj;
    const int tk0 = cur.h * g.zt, ztu = min(g.zt, tz - tk0);
    const int ncols = ztu * c;
    T* stage = reinterpret_cast<T*>(s_stage + (it & 1) * ncol * run);
    // the staging buffer's copies of two units ago have read it
    if (lane == 0) asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
    __syncthreads();  // W^T is built; the staging buffer is free
    const Unit nxt = next_unit(cur);
    const bool more = u + G < units;
#if !(REPRO_MM_SKIP & 4)
    if (more) copy_window(nxt);  // lands while the products run
#endif

    for (int q = wg; q < tasks; q += kGroups) {
      const int mi = q % mg, nh = q / mg;
      if (nh * kHalf >= ncols) continue;  // the half holds none of the unit's columns
      if (!a_fixed) load_tile(mi);
      float acc[12], sml[12];
#pragma unroll
      for (int i = 0; i < 12; ++i) acc[i] = sml[i] = 0.f;
#if REPRO_MM_SKIP & 2
#pragma unroll
      for (int i = 0; i < 12; ++i) acc[i] = 1.f + i;
#else
      mm_wgmma_fence();
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint32_t off = (s * halves + nh) * kHalf * 32;
        const uint64_t bh = wt_desc(wt_hi + off), bl = wt_desc(wt_lo + off);
        if (kWide) {
          wgmma_tf32_n24(sml, al[s], bh, s > 0);
          wgmma_tf32_n24(sml, ah[s], bl, 1);
        }
        wgmma_tf32_n24(acc, ah[s], bh, s > 0);
      }
      mm_wgmma_commit_wait(acc, sml);
#endif
      // the lane's rows in the staging: the run of (a, b), offset to share
      // its place's alignment modulo 16 bytes, then z offset cz
      int sb[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const unsigned x = ti * g.dx + ra[e], y = tj * g.dy + rb[e];
        const unsigned delta =
            (obase + ((x * g.Y + y) * g.Z + tk0 * g.dz) * (unsigned)c) & (E - 1u);
        sb[e] = (ra[e] * g.dy + rb[e]) * run_t + (int)delta + rz[e] * c;
      }
      // entry 4 i + 2 e + j: row g + 8 e, column 24 nh + 8 i + 2 t + j =
      // (tk, ch), at (tk * dz + cz) * c + ch of its run
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = nh * kHalf + 8 * i + 2 * tq + j;
          if (col >= ncols) continue;
          const int tk = col / c, pc = tk * g.dz * c + col - tk * c;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (rok[e])
              stage[sb[e] + pc] = store_as<T>(acc[4 * i + 2 * e + j] + sml[4 * i + 2 * e + j]);
        }
    }
#if !(REPRO_MM_SKIP & 4)
    asm volatile("cp.async.wait_all;" ::: "memory");
#endif
    // the staging is read by the bulk copies: the writes before them made
    // visible to that proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // the staging is complete; the next window has landed

    // each voxel column's run: its body by one bulk copy, its ends by lanes
    const int z0 = tk0 * g.dz, n = (min(z0 + ztu * g.dz, g.Z) - z0) * c;
    for (int ab = warp; ab < ncol; ab += kThreads / 32) {
      const int a = ab / g.dy, b = ab - a * g.dy;
      const int x = ti * g.dx + a, y = tj * g.dy + b;
      if (x >= g.X || y >= g.Y) continue;
      T* o = out + ((size_t)x * g.Y + y) * g.Z * c + (size_t)z0 * c;
      const unsigned delta =
          (obase + (((unsigned)x * g.Y + y) * g.Z + z0) * (unsigned)c) & (E - 1u);
      const T* v = stage + ab * run_t + delta;
      // values before o's next 16-byte boundary; the body in whole 16 bytes
      const int head = (int)((16 - (reinterpret_cast<size_t>(o) & 15)) & 15) / (int)sizeof(T);
      const int body = max(n - head, 0) & ~(E - 1);
#if !(REPRO_MM_SKIP & 1)
      if (body > 0) {
        if (lane == 0) bulk_store(o + head, v + head, body * (int)sizeof(T));
        if (lane < head) o[lane] = v[lane];
        if (lane < n - head - body) o[head + body + lane] = v[head + body + lane];
      } else if (lane < n) {
        o[lane] = v[lane];
      }
#endif
    }
    if (lane == 0) asm volatile("cp.async.bulk.commit_group;" ::: "memory");
#if !(REPRO_MM_SKIP & 4)
    if (more) build_wt(nxt);  // this unit's products are done with W^T
#endif
    cur = nxt;
  }
  if (lane == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_matmul_kernel(const float* __restrict__ phi, const uint4* __restrict__ afrag,
                      float* __restrict__ out, MMBlock g) {
  mm_block<C>(phi, afrag, out, g);
}

// The same on a bf16 grid, writing a bf16 field.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_matmul_bf16_kernel(const __nv_bfloat16* __restrict__ phi,
                           const uint4* __restrict__ afrag,
                           __nv_bfloat16* __restrict__ out, MMBlock g) {
  mm_block<C>(phi, afrag, out, g);
}

// The same on an fp16 grid, writing an fp16 field.
template <int C>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_matmul_f16_kernel(const __half* __restrict__ phi, const uint4* __restrict__ afrag,
                          __half* __restrict__ out, MMBlock g) {
  mm_block<C>(phi, afrag, out, g);
}

// The launch of `kernel` (the instantiation for g.c) on `blocks` persistent
// blocks; returns its cudaError_t.
template <typename T, typename Kernel>
inline int launch_matmul(Kernel kernel, const T* phi, const float* afrag, T* out,
                         const MMBlock& g, int blocks, void* stream) {
  if (g.zt < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = mm_smem_bytes(g);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      phi, reinterpret_cast<const uint4*>(afrag), out, g);
  return (int)cudaGetLastError();
}

}  // namespace repro_torch

// phi: (nx, ny, nz, c) float32, contiguous; afrag: the basis's A fragments
// (kernels/bsi_matmul.py:basis_fragments).  out: (X, Y, Z, c) float32 with
// X <= (nx - 3) * dx and so on; zt z tiles a unit and the persistent blocks
// (kernels/bsi_matmul.py:matmul_blocks).  Returns the launch's cudaError_t.
extern "C" int bsi_matmul_f32(const float* phi, const float* afrag, float* out, int nx,
                              int ny, int nz, int c, int dx, int dy, int dz, int X,
                              int Y, int Z, int zt, int blocks, void* stream) {
  using namespace repro_torch;
  const MMBlock g{nx, ny, nz, c, dx, dy, dz, X, Y, Z, zt};
  void (*kernel)(const float*, const uint4*, float*, MMBlock) =
      c == 3 ? bsi_matmul_kernel<3> : bsi_matmul_kernel<0>;
  return launch_matmul(kernel, phi, afrag, out, g, blocks, stream);
}

// The same with phi and out bf16 and afrag the bf16 basis's fragments
// (basis_fragments(..., bfloat16): lo parts zero).
extern "C" int bsi_matmul_bf16(const __nv_bfloat16* phi, const float* afrag,
                               __nv_bfloat16* out, int nx, int ny, int nz, int c, int dx,
                               int dy, int dz, int X, int Y, int Z, int zt, int blocks,
                               void* stream) {
  using namespace repro_torch;
  const MMBlock g{nx, ny, nz, c, dx, dy, dz, X, Y, Z, zt};
  void (*kernel)(const __nv_bfloat16*, const uint4*, __nv_bfloat16*, MMBlock) =
      c == 3 ? bsi_matmul_bf16_kernel<3> : bsi_matmul_bf16_kernel<0>;
  return launch_matmul(kernel, phi, afrag, out, g, blocks, stream);
}

// The same with phi and out fp16 and afrag the fp16 basis's fragments
// (basis_fragments(..., float16): lo parts zero).
extern "C" int bsi_matmul_f16(const __half* phi, const float* afrag, __half* out, int nx,
                              int ny, int nz, int c, int dx, int dy, int dz, int X, int Y,
                              int Z, int zt, int blocks, void* stream) {
  using namespace repro_torch;
  const MMBlock g{nx, ny, nz, c, dx, dy, dz, X, Y, Z, zt};
  void (*kernel)(const __half*, const uint4*, __half*, MMBlock) =
      c == 3 ? bsi_matmul_f16_kernel<3> : bsi_matmul_f16_kernel<0>;
  return launch_matmul(kernel, phi, afrag, out, g, blocks, stream);
}
