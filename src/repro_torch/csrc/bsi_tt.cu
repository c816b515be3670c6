// Forward BSI, TT form (thread-per-tile, paper §3.2): each output value is the
// 64-term weighted sum sum_{l,m,n} window[tile + (l, m, n)] * ((wx[a,l] *
// wy[b,m]) * wz[r,n]), the terms added one at a time in l, m, n order.
//
// Replaces: the Pallas TPU kernel repro/kernels/bsi_tt.py:bsi_tt_pallas
// (_kernel), dispatched by repro/kernels/ops.py:bsi_pallas(mode="tt").
//
// What bounds it on an H100: its own rounding.  The least work for the
// function is writing the field (539 MB at the paper's phantom1 volume (512,
// 228, 385) with 3 channels, 0.16 ms at 3.35 TB/s), but this form is held to
// the plain version bit for bit (built with -fmad=false,
// kernels/build.py:SOURCE_FLAGS): each term is a rounded product p * w and a
// rounded add, two fp32 instructions, 128 an output value.  At phantom1
// that is 134.8 M values x 128 = 17.3 G instructions, 0.52 ms at one warp
// instruction a clock on each of the 528 schedulers (1.98 GHz); measured,
// those instructions alone issue at about 0.7 of that (PERF.md, PR 23).
//
// What the design does about it: it issues little beside them.
// - A thread owns one slot (y tile, z tile, channel) of an x tile and holds
//   the slot's 64 control values in registers across the dx * dy voxel
//   columns (a, b) of its block, decoded once; its loads are coalesced
//   across the warp.  The slots of an x tile are numbered y tile, then z
//   tile, then channel; a group of 64 threads takes a whole number of z
//   tiles' consecutive slots (63 at 3 channels), a block four groups.
// - The weights (wx[a,l] * wy[b,m]) * wz[r,n] of the block's columns come
//   from a table built once on the host (kernels/bsi_tt.py:weight_table,
//   rounded as the plain version rounds them) and are copied to shared
//   memory once a block; all lanes read the same float4 of them (a
//   broadcast): 16 loads an output value.  A thread sums the dz values of
//   its slot in a column together (dz independent chains, each in the fixed
//   order).
// - A group stages a column's values in the field's order (its slots are
//   consecutive, so they are consecutive positions of one or two (x, y)
//   rows), offset so that each shares its place's alignment modulo 16
//   bytes.  Each row's piece then goes out by one bulk copy (TMA) of its
//   16-byte-aligned body, the few floats at its ends by lanes; a second
//   piece not aligned alike is stored by lanes, every warp one aligned
//   128-byte line.  Two staging buffers: one barrier of the group a column.
//   Only voxels inside (X, Y, Z) are written: dense_field's crop is fused.
// - A block may take a part of the columns (grid z) where the x tiles and
//   slot blocks alone would not fill the card (kernels/bsi_tt.py:tt_blocks).
// - More than 64 channels: a group holds 64 slots, not whole z tiles, and
//   each thread stores its own values (consecutive channels: coalesced).
//
// bsi_tt_bf16, the compute_dtype="bfloat16" variant, replaces the same
// Pallas kernel run on a bf16 grid (its field phi's dtype): the grid widened
// as it is loaded, the weights the products of the bf16 LUTs in float32
// (kernels/bsi_tt.py:weight_table), the same float32 sums, one rounding to
// bf16 where a value is staged; the staging and its bulk stores move bf16
// values.  (The Pallas kernel sums in phi's dtype, so interpreted on a CPU
// it rounds every term to bf16; this kernel does not.)  Bound at phantom1:
// 272.2 MB, 0.0812 ms; its 128 instructions a value keep the 0.515 ms
// floor.  bsi_tt_f16, the compute_dtype="float16" variant, is the same
// code on __half: the fp16 grid widened exactly, the weights the products
// of the fp16 LUTs, one rounding to fp16 (round to nearest even,
// subnormals kept) where a value is staged; the same bound.
//
// Measurement builds (-DREPRO_TT_SKIP=mask, launch/profile_forward.py): 1
// leaves out the stores to the field (the sums are kept), 2 the weights
// (each term's weight a constant), 4 the sums (a constant is staged and
// stored at the same positions), 8 all but the sums (no barrier, nothing
// stored but the staging); 16 sums each term with one fused multiply-add,
// the rounding this form may not have, to show what its two cost.
#include "bsi_common.cuh"

#ifndef REPRO_TT_SKIP
#define REPRO_TT_SKIP 0
#endif

namespace repro_torch {

// A group of two warps shares a staging buffer and a named barrier.
constexpr int kGroupThreads = 64;
constexpr int kGroups = kThreads / kGroupThreads;

struct TTBlock {
  int nx, ny, nz, c;  // stored control points per axis, channels
  int dx, dy, dz;     // tile: voxels per control interval
  int X, Y, Z;        // the volume written
  int sg;             // slots a group
  int pc;             // columns a block (a part)
};

constexpr int kMaxChunk = 8;  // z offsets summed together at most

__host__ __device__ inline int tt_chunk(const TTBlock& g) {
  return g.dz < kMaxChunk ? g.dz : kMaxChunk;
}
// weight rows of a column: dz rounded up to whole chunks (the rows past dz
// are 0 and their sums never stored)
__host__ __device__ inline int tt_weight_rows(const TTBlock& g) {
  const int r = tt_chunk(g);
  return (g.dz + r - 1) / r * r;
}
__host__ __device__ inline bool tt_direct(const TTBlock& g) { return g.c > kGroupThreads; }
// Shared memory, in floats: [the part's weight slices, pc x rows x 64 |
// each group's staging, 2 x sg * dz]
__host__ __device__ inline int tt_slice_floats(const TTBlock& g) {
  return tt_weight_rows(g) * 64;
}
// a staging buffer: a column's values of a group, from an offset of up to 3
// floats that gives them the field's alignment modulo 16 bytes
__host__ __device__ inline int tt_stage_floats(const TTBlock& g) {
  return (g.sg * g.dz + 3) / 4 * 4 + 4;
}
__host__ __device__ inline size_t tt_smem_bytes(const TTBlock& g) {
  return sizeof(float) *
         ((size_t)g.pc * tt_slice_floats(g) + (size_t)kGroups * 2 * tt_stage_floats(g));
}

inline dim3 tt_grid(const TTBlock& g) {
  const int tx = (g.X + g.dx - 1) / g.dx, ty = (g.Y + g.dy - 1) / g.dy,
            tz = (g.Z + g.dz - 1) / g.dz;
  const long slots = (long)ty * tz * g.c, sb = (long)kGroups * g.sg;
  return dim3((unsigned)((slots + sb - 1) / sb), tx, (g.dx * g.dy + g.pc - 1) / g.pc);
}

// The barrier of a group's warps (named barrier 1 + grp; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + grp), "r"(kGroupThreads) : "memory");
}

// R: z offsets summed together (tt_chunk); T: the element type of the grid
// and the field, float, __nv_bfloat16 or __half (the grid widened as it is
// loaded, each value rounded once where it is staged; a staged run's
// alignment and its stores count E = 16 / sizeof(T) values to 16 bytes).
template <int R, typename T>
__device__ __forceinline__ void tt_block(const T* __restrict__ phi,
                                         const float* __restrict__ wtab,
                                         T* __restrict__ out, const TTBlock& g) {
  constexpr int E = 16 / sizeof(T);   // values of 16 bytes
  constexpr int L = 128 / sizeof(T);  // values of a 128-byte line
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int c = g.c, dz = g.dz, sg = g.sg;
  const int nw = tt_slice_floats(g);
  const bool direct = tt_direct(g);
  const int ti = blockIdx.y;
  const int col0 = blockIdx.z * g.pc;
  const int col1 = min(col0 + g.pc, min(g.dx, g.X - ti * g.dx) * g.dy);
  if (col0 >= col1) return;  // the part's columns lie past the volume
  const int t = threadIdx.x, grp = t / kGroupThreads, lg = t - grp * kGroupThreads;
  float* s_w = smem;  // pc x nw: the part's weight slices
  const int sbuf = tt_stage_floats(g);
  float* s_st = s_w + g.pc * nw + grp * 2 * sbuf;  // the group's two buffers

  // the weight slices of the part's columns, copied once, 16 bytes a copy,
  // all in flight while the control values load (cp.async, L2 only)
  {
    const float4* src = reinterpret_cast<const float4*>(wtab + (size_t)col0 * nw);
    const unsigned dst = (unsigned)__cvta_generic_to_shared(s_w);
    for (int i = t; i < (col1 - col0) * nw / 4; i += kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst + 16 * i),
                   "l"(src + i)
                   : "memory");
  }

  // the thread's slot s = (tj, k, ch), decoded once; the group's slots are
  // consecutive, a whole number of z tiles unless direct
  const int tz = (g.Z + dz - 1) / dz, ty = (g.Y + g.dy - 1) / g.dy;
  const int srow = tz * c;  // slots of one (x tile, y tile)
  const int total = ty * srow;
  const int sg0 = (blockIdx.x * kGroups + grp) * sg;  // the group's first slot
  const int nslots = max(0, min(sg, total - sg0));
  const bool active = lg < nslots;
  const int tj = (sg0 + lg) / srow;
  // the thread's staging offset at r = 0 (its stride in r: c, or when direct
  // a row of the group's slots)
  int st0;
  float p[64];
  {
    const int rem = active ? sg0 + lg - tj * srow : 0;
    const int k = rem / c, ch = rem - k * c;
    st0 = direct ? lg : (lg - ch) * dz + ch;
    const int ys = g.nz * c, xs = g.ny * ys;  // the grid is small: ints
    const T* src = phi + ((size_t)(ti * g.ny + (active ? tj : 0)) * g.nz + k) * c + ch;
#pragma unroll
    for (int q = 0; q < 64; ++q) {
      const int l = q >> 4, m = (q >> 2) & 3, n = q & 3;
      p[q] = active ? to_float(__ldg(src + l * xs + m * ys + n * c)) : 0.f;
    }
  }

  // the group's values of a column in the field's order: position F = s *
  // dz - ch * (dz - 1) + r * c of its x tile, staged at F - F0; a row (tj)
  // holds frow of them, the first Z * c inside the volume.  Kept in shared
  // memory, read where the column is stored: registers go to the sums.
  __shared__ int s_run[kGroups][4];  // F0, its length, first and last row
  if (lg == 0) {
    const int F0 = sg0 * dz, len = nslots * dz, frow = srow * dz;
    s_run[grp][0] = F0;
    s_run[grp][1] = len;
    s_run[grp][2] = F0 / frow;
    s_run[grp][3] = (F0 + max(len, 1) - 1) / frow;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  for (int col = col0, i = 0; col < col1; ++col, ++i) {
    const int a = col / g.dy, b = col - a * g.dy;
    const int x = blockIdx.y * g.dx + a, y = tj * g.dy + b;
    const float* w = s_w + (col - col0) * nw;
    // the staging of this column, offset so that a value and its place in
    // the field share their alignment modulo 16 bytes (the first row's)
    // (32-bit arithmetic: only the offset modulo E values matters)
    T* st;
    {
      const int F0 = s_run[grp][0], tj_lo = s_run[grp][2];
      const unsigned o1 = (unsigned)(reinterpret_cast<size_t>(out) / sizeof(T)) +
                          ((unsigned)x * g.Y + tj_lo * g.dy + b) * (unsigned)(g.Z * c) +
                          (unsigned)(F0 - tj_lo * srow * dz);
      st = reinterpret_cast<T*>(s_st + (i & 1) * sbuf) + (o1 & (E - 1));
    }
    if (active && y < g.Y) {
#pragma unroll 1
      for (int r0 = 0; r0 < dz; r0 += R) {
        float acc[R];
#pragma unroll
        for (int rr = 0; rr < R; ++rr) acc[rr] = 0.f;
#if !(REPRO_TT_SKIP & 4)
        const float4* w4 = reinterpret_cast<const float4*>(w + r0 * 64);
#if REPRO_TT_SKIP & 2
        const float cz = w[0] * 0.f;  // keeps the constants in the column
#endif
#pragma unroll
        for (int q4 = 0; q4 < 16; ++q4)
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
#if REPRO_TT_SKIP & 2
            // a constant the compiler cannot fold or hoist out of the column
            const float cw = 0.015625f * (rr + 1) + cz;
            const float4 wq = make_float4(cw, cw, cw, cw);
#else
            const float4 wq = w4[rr * 16 + q4];  // the same for every lane
#endif
#if REPRO_TT_SKIP & 16
            acc[rr] = __fmaf_rn(p[4 * q4], wq.x, acc[rr]);
            acc[rr] = __fmaf_rn(p[4 * q4 + 1], wq.y, acc[rr]);
            acc[rr] = __fmaf_rn(p[4 * q4 + 2], wq.z, acc[rr]);
            acc[rr] = __fmaf_rn(p[4 * q4 + 3], wq.w, acc[rr]);
#else
            acc[rr] = acc[rr] + p[4 * q4] * wq.x;
            acc[rr] = acc[rr] + p[4 * q4 + 1] * wq.y;
            acc[rr] = acc[rr] + p[4 * q4 + 2] * wq.z;
            acc[rr] = acc[rr] + p[4 * q4 + 3] * wq.w;
#endif
          }
#else
#pragma unroll
        for (int rr = 0; rr < R; ++rr) acc[rr] = 1.f;
#endif
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          if (r0 + rr < dz) st[st0 + (r0 + rr) * (direct ? sg : c)] = store_as<T>(acc[rr]);
      }
    }
#if REPRO_TT_SKIP & 8
    continue;  // the sums alone: no barrier, nothing stored but the staging
#endif
    // the staging is read by the bulk copies: the writes before them made
    // visible to that proxy; the previous column's copies have read theirs
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    if (lg == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    group_sync(grp);
    if (direct) {  // each thread its own values: consecutive channels
      const int rem = sg0 + lg - tj * srow, k = rem / c, ch = rem - k * c;
      if (active && y < g.Y)
        for (int r = 0; r < dz && k * dz + r < g.Z; ++r) {
          const T v = st[lg + r * sg];
#if REPRO_TT_SKIP & 1
          if (to_float(v) == -1.25e-30f)  // never true here: drops the store
#endif
            out[(((size_t)x * g.Y + y) * g.Z + k * dz + r) * c + ch] = v;
        }
      continue;
    }
    // each row's piece of the column, every warp one aligned 128-byte line
    // (of bf16 values, one aligned half of one); lanes before the piece's
    // start store nothing
    const int F0 = s_run[grp][0], len = s_run[grp][1];
    const int tj_lo = s_run[grp][2], tj_hi = s_run[grp][3], frow = srow * dz;
    for (int rj = tj_lo; rj <= tj_hi && len > 0; ++rj) {
      const int yr = rj * g.dy + b;
      if (yr >= g.Y) break;
      const int rs = rj * frow;
      const int lo = max(F0, rs), hi = min(F0 + len, rs + g.Z * c);
      T* o = out + ((size_t)x * g.Y + yr) * g.Z * c + (lo - rs);
      const T* v = st + (lo - F0);
      const int n = hi - lo;
      // values before o's next 16-byte boundary; the body in whole 16 bytes
      const int head = (int)((16 - (reinterpret_cast<size_t>(o) & 15)) & 15) / (int)sizeof(T);
      const int body = max(n - head, 0) & ~(E - 1);
      if (body > 0 &&
          (reinterpret_cast<size_t>(v + head) & 15) == 0) {  // aligned alike
#if !(REPRO_TT_SKIP & 1)
        if (lg == 0) bulk_store(o + head, v + head, body * (int)sizeof(T));
        if (lg < head) o[lg] = v[lg];
        if (lg < n - head - body) o[head + body + lg] = v[head + body + lg];
#endif
        continue;
      }
      const int sh = (int)(reinterpret_cast<size_t>(o) / sizeof(T) & (L - 1));
      for (int q = lg - sh; q < n; q += kGroupThreads) {
#if REPRO_TT_SKIP & 1
        if (to_float(v[max(q, 0)]) == -1.25e-30f)  // never true here: drops the store
#endif
          if (q >= 0) o[q] = v[q];
      }
    }
    if (lg == 0) asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  }
  if (lg == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_tt_kernel(const float* __restrict__ phi, const float* __restrict__ wtab,
                  float* __restrict__ out, TTBlock g) {
  tt_block<R>(phi, wtab, out, g);
}

// The same on a bf16 grid, writing a bf16 field.
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_tt_bf16_kernel(const __nv_bfloat16* __restrict__ phi,
                       const float* __restrict__ wtab, __nv_bfloat16* __restrict__ out,
                       TTBlock g) {
  tt_block<R>(phi, wtab, out, g);
}

// The same on an fp16 grid, writing an fp16 field.
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
    bsi_tt_f16_kernel(const __half* __restrict__ phi, const float* __restrict__ wtab,
                      __half* __restrict__ out, TTBlock g) {
  tt_block<R>(phi, wtab, out, g);
}

// The kernel of element type T at R z offsets summed together.
template <int R, typename T>
inline auto tt_kernel() {
  if constexpr (kIsFloat<T>) return bsi_tt_kernel<R>;
  else if constexpr (kIsBf16<T>) return bsi_tt_bf16_kernel<R>;
  else return bsi_tt_f16_kernel<R>;
}

// The launch of the instantiation of tt_chunk(g); returns the launch's
// cudaError_t.
template <typename T>
inline int launch_tt(const T* phi, const float* wtab, T* out, const TTBlock& g,
                     void* stream) {
  if (g.pc < 1) return (int)cudaErrorInvalidValue;
  void (*kernel)(const T*, const float*, T*, TTBlock);
  switch (tt_chunk(g)) {
    case 1: kernel = tt_kernel<1, T>(); break;
    case 2: kernel = tt_kernel<2, T>(); break;
    case 3: kernel = tt_kernel<3, T>(); break;
    case 4: kernel = tt_kernel<4, T>(); break;
    case 5: kernel = tt_kernel<5, T>(); break;
    case 6: kernel = tt_kernel<6, T>(); break;
    case 7: kernel = tt_kernel<7, T>(); break;
    default: kernel = tt_kernel<kMaxChunk, T>(); break;
  }
  const size_t smem = tt_smem_bytes(g);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<tt_grid(g), kThreads, smem, (cudaStream_t)stream>>>(phi, wtab, out, g);
  return (int)cudaGetLastError();
}

// A group's slots: whole z tiles, or its threads where c exceeds them.
inline int tt_group_slots(int c) {
  return c > kGroupThreads ? kGroupThreads : kGroupThreads / c * c;
}

}  // namespace repro_torch

// phi: (nx, ny, nz, c) float32, contiguous; wtab: the weight table
// (kernels/bsi_tt.py:weight_table), (dx * dy, rows * 64).  out: (X, Y, Z, c)
// float32 with X <= (nx - 3) * dx and so on; pc columns a block
// (kernels/bsi_tt.py:tt_blocks).  Returns the launch's cudaError_t.
extern "C" int bsi_tt_f32(const float* phi, const float* wtab, float* out, int nx,
                          int ny, int nz, int c, int dx, int dy, int dz, int X, int Y,
                          int Z, int pc, void* stream) {
  using namespace repro_torch;
  const TTBlock g{nx, ny, nz, c, dx, dy, dz, X, Y, Z, tt_group_slots(c), pc};
  return launch_tt(phi, wtab, out, g, stream);
}

// The same with phi and out bf16 and wtab the products of the LUTs rounded
// to bf16 (weight_table(..., bfloat16), floats).
extern "C" int bsi_tt_bf16(const __nv_bfloat16* phi, const float* wtab, __nv_bfloat16* out,
                           int nx, int ny, int nz, int c, int dx, int dy, int dz, int X,
                           int Y, int Z, int pc, void* stream) {
  using namespace repro_torch;
  const TTBlock g{nx, ny, nz, c, dx, dy, dz, X, Y, Z, tt_group_slots(c), pc};
  return launch_tt(phi, wtab, out, g, stream);
}

// The same with phi and out fp16 and wtab the products of the LUTs rounded
// to fp16 (weight_table(..., float16), floats).
extern "C" int bsi_tt_f16(const __half* phi, const float* wtab, __half* out, int nx, int ny,
                          int nz, int c, int dx, int dy, int dz, int X, int Y, int Z, int pc,
                          void* stream) {
  using namespace repro_torch;
  const TTBlock g{nx, ny, nz, c, dx, dy, dz, X, Y, Z, tt_group_slots(c), pc};
  return launch_tt(phi, wtab, out, g, stream);
}
