// Flash attention in bf16 on Hopper's tensor cores: causal / sliding-window /
// logit-softcapped GQA attention by online softmax, wgmma for both products,
// TMA for every tile, one producer and two consumer warpgroups.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (_kernel), for bf16 q, k and v (float32 stays on
// the CUDA-core kernel of flash_attention.cu).  Per query row and 64-key
// block: s = (q . k) * 1/sqrt(hd) in float32; s = tanh(s / softcap) *
// softcap; masked (k > q when causal, k <= q - window when window > 0,
// k >= S) to NEG_INF = -2e30; m' = max(m, max s), p = exp(s - m'),
// l = l * exp(m - m') + sum p, acc = acc * exp(m - m') + p v, m from -inf;
// out = acc / max(l, 1e-30) in bf16.
//
// What bounds it on an H100: the operations.  QK^T and PV are 4 * hd flops
// per (query, key) pair the mask keeps: 1.09 TFLOP for a global gemma2-2b
// layer (batch 4, 8160 tokens, 8 query and 4 key/value heads, head dim 256),
// 1.10 ms at the 989 TFLOP/s of bf16 tensor cores, against 401 MB of q, k,
// v and o (0.12 ms at 3.35 TB/s).
//
// The design.  A block owns 128 query rows of one (batch, query head) and
// has three warpgroups.  The producer (24 registers a thread after
// setmaxnreg) is one elected thread starting the TMA copies: Q once, then
// K and V of each 64-key block into a 2-stage ring, each stage with a full
// barrier for K, one for V and an empty barrier the 256 consumer threads
// arrive on.
// Each consumer warpgroup (240 registers) owns 64 of the rows:
// 1. S = Q K^T by wgmma.m64n64k16, both operands in shared memory, K-major
//    (k is stored (key, d), so no transpose is made in memory);
// 2. the scale, then the softcap by accurate tanhf (tanh.approx's ~1e-3
//    relative error at cap 50 would move a score by ~0.05, a 5% weight
//    after exp), s / softcap taken as s times the float32 reciprocal, as
//    PyTorch divides a tensor on the card by a scalar;
// 3. the masks, only on the diagonal, window-edge and ragged blocks;
// 4. the row max and sum over the 4 threads that hold a row's 64 scores;
// 5. l sums the float32 p, as the TPU kernel does;
// 6. p rounded to bf16 in registers is the A operand of O += P V by
//    wgmma.m64n{64,32,16}k16, V from shared memory MN-major through the
//    transpose bit.
// At hd 256 O is 128 float32 registers a thread.  The epilogue writes
// O / max(l, 1e-30) in bf16 over the warpgroup's rows of the Q tile and
// stores it by TMA, which clips rows past S.  Shared memory at hd 256: Q
// 64 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB.  The tensor maps view q
// and o as (hd, H, S, B) and k, v as (hd, KV, S, B), innermost first, so
// query head h reads key/value head h / (H / KV) in place; a box is a
// chunk of min(hd, 64) columns with the 128-, 64- or 32-byte swizzle that
// its row width allows; TMA zero-fills keys past S (masked anyway).  The
// producer loads the key blocks of key_range over the block's 128 rows;
// each consumer computes those of its own 64 rows and only releases the
// others (after they land, so that no arrival runs a round ahead), so it
// walks the blocks of plain(block=64) exactly.  Query blocks with the most
// key blocks run first (the grid's slow axis counts down).  No atomics: two
// launches write the same bits.
//
// Rounding.  The TPU kernel multiplies float32 p by v; this one rounds p to
// bf16, p~ = p (1 + d) with |d| <= 2^-8, for the PV product.  Since l sums
// the float32 p, the output moves by |sum p_i d_i v_i| / l <= 2^-8 max|v|:
// the kernel agrees with plain() within 2^-7 max(|o|, |r|) + 2^-8 max|v| +
// 1e-5 (one bf16 step of the output, and that).  plain(p_dtype=bfloat16)
// rounds as this kernel does; where the float32 scores agree bit for bit
// (inputs whose q . k sums are exact, e.g. q and k on the quarter-integers)
// the two differ by the order of the sums of l and P V only, within one
// bf16 step, 2^-7 max(|o|, |r|) + 1e-5.  On other inputs the tensor cores
// sum q . k in another order than the einsum, and a few p round to the
// other bf16 neighbour.
#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace repro_torch {
namespace {

constexpr int kBlockQ = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int kBlockK = 64;   // keys per stage
constexpr int kStages = 2;
constexpr int kThreads = 384;  // the producer warpgroup and two consumers
constexpr float kNegInf = -2.0e30f;

template <int HD>
struct Tile {
  static constexpr int CW = HD < 64 ? HD : 64;  // columns of a chunk: one TMA box
  static constexpr int CB = 2 * CW;             // bytes of a chunk's row: the swizzle
  static constexpr int NCH = HD / CW;           // chunks per row
  static constexpr uint32_t Q_BYTES = kBlockQ * HD * 2;
  static constexpr uint32_t KV_BYTES = kBlockK * HD * 2;
  // Q, then each stage's K and V, then 7 barriers; + slack for 1024-alignment
  static constexpr uint32_t BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  static constexpr uint32_t SMEM = BAR_OFF + 64 + 1024;
  // the wgmma descriptor's layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32
  static constexpr uint64_t LAYOUT = CB == 128 ? 1 : CB == 64 ? 2 : 3;
};

__device__ __forceinline__ void key_range(int q0, int q1, int S, int causal, int window,
                                          int& k0, int& k1) {
  k1 = causal ? min(S, q1) : S;
  k0 = window > 0 ? max(0, q0 - window + 1) / kBlockK * kBlockK : 0;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: start, leading and stride byte offsets
// (16-byte units), swizzle layout.  The tiles sit on 1024-byte boundaries,
// so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching registers that a wgmma in flight reads or
// writes before the wait: each empty asm "writes" them after it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Two floats as a bf16 pair, round to nearest even; lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// D(64 x 64, fp32) (+)= A(64 x 16) B(16 x 64), A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D(64 x 16, fp32) += A(64 x 16, bf16 registers) B(16 x 16), B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 32, fp32) += A(64 x 16, bf16 registers) B(16 x 32), B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D(64 x 64, fp32) += A(64 x 16, bf16 registers) B(16 x 64), B MN-major in
// shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t b) {
  if constexpr (N == 16) {
    wgmma_rs_n16(d, a, b);
  } else if constexpr (N == 32) {
    wgmma_rs_n32(d, a, b);
  } else {
    wgmma_rs_n64(d, a, b);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_o, int S, int H, int KV,
                      int causal, int window, float scale, float softcap) {
  using T = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t s_q = base;
  const uint32_t bars = base + T::BAR_OFF;  // q_full, k_full[2], v_full[2], empty[2]
  const uint32_t q_full = bars;
  auto s_k = [&](int s) { return base + T::Q_BYTES + s * 2 * T::KV_BYTES; };
  auto s_v = [&](int s) { return s_k(s) + T::KV_BYTES; };
  auto k_full = [&](int s) { return bars + 8 + 8 * s; };
  auto v_full = [&](int s) { return bars + 8 + 8 * kStages + 8 * s; };
  auto empty = [&](int s) { return bars + 8 + 16 * kStages + 8 * s; };

  const int b = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // the longest rows first
  int k_lo, k_hi;
  key_range(q0, min(S, q0 + kBlockQ), S, causal, window, k_lo, k_hi);
  const int n_blocks = (k_hi - k_lo + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int c = 0; c < T::NCH; ++c)
        tma_load(s_q + c * kBlockQ * T::CB, &tm_q, q_full, c * T::CW, h, q0, b);
      for (int i = 0; i < n_blocks; ++i) {
        const int s = i % kStages, k0 = k_lo + i * kBlockK;
        if (i >= kStages) mbar_wait(empty(s), (i / kStages - 1) & 1);
        mbar_expect_tx(k_full(s), T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load(s_k(s) + c * kBlockK * T::CB, &tm_k, k_full(s), c * T::CW, g, k0, b);
        mbar_expect_tx(v_full(s), T::KV_BYTES);
        for (int c = 0; c < T::NCH; ++c)
          tma_load(s_v(s) + c * kBlockK * T::CB, &tm_v, v_full(s), c * T::CW, g, k0, b);
      }
    }
  } else {  // a consumer: 64 rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wg = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
    const int r0 = q0 + 64 * wg;
    const bool active = r0 < S;
    int m_lo = 0, m_hi = 0;
    if (active) key_range(r0, min(S, r0 + 64), S, causal, window, m_lo, m_hi);
    // this thread's rows (row_a, row_b = row_a + 8) and its first column of
    // each 8-column group of an accumulator
    const int row_a = r0 + 16 * (t / 32) + (t % 32) / 4, row_b = row_a + 8;
    const int col = 2 * (t % 4);
    const uint32_t q_rows = s_q + wg * 64 * T::CB;
    // s / softcap as PyTorch divides a CUDA tensor by a scalar: times the
    // float32 reciprocal
    const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;

    float o[T::NCH][T::CW / 2];
#pragma unroll
    for (int n = 0; n < T::NCH; ++n)
#pragma unroll
      for (int j = 0; j < T::CW / 2; ++j) o[n][j] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
    mbar_wait(q_full, 0);

    for (int i = 0; i < n_blocks; ++i) {
      const int s = i % kStages, k0 = k_lo + i * kBlockK;
      const uint32_t phase = (i / kStages) & 1;
      if (active && k0 >= m_lo && k0 < m_hi) {
        mbar_wait(k_full(s), phase);
        float sc[32];
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] = 0.f;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk) {
          const int c = kk * 16 / T::CW, e = (kk * 16 % T::CW) * 2;
          wgmma_ss_n64(sc,
                       smem_desc(q_rows + c * kBlockQ * T::CB + e, 16, 8 * T::CB, T::LAYOUT),
                       smem_desc(s_k(s) + c * kBlockK * T::CB + e, 16, 8 * T::CB, T::LAYOUT),
                       kk > 0);
        }
        wgmma_commit();
        wgmma_wait_all();
        hold(sc);

        // sc[4 j + e]: row_a (e < 2) or row_b, key k0 + 8 j + col + (e & 1)
        const bool edge = k0 + kBlockK > S || (causal && k0 + kBlockK - 1 > r0) ||
                          (window > 0 && k0 <= r0 + 63 - window);
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          float x = sc[j] * scale;
          if (softcap > 0.f) x = tanhf(x * inv_cap) * softcap;
          if (edge) {
            const int key = k0 + 8 * (j / 4) + col + (j & 1);
            const int row = (j & 2) ? row_b : row_a;
            bool ok = key < S;
            if (causal) ok = ok && key <= row;
            if (window > 0) ok = ok && key > row - window;
            x = ok ? x : kNegInf;
          }
          sc[j] = x;
          if (j & 2) {
            mx_b = fmaxf(mx_b, x);
          } else {
            mx_a = fmaxf(mx_a, x);
          }
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the 4 threads of a row
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float corr_a = expf(m_a - mn_a), corr_b = expf(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float p = expf(sc[j] - ((j & 2) ? mn_b : mn_a));
          sc[j] = p;
          if (j & 2) {
            sum_b += p;
          } else {
            sum_a += p;
          }
        }
        l_a = l_a * corr_a + sum_a;  // this thread's share of the row's sum
        l_b = l_b * corr_b + sum_b;
#pragma unroll
        for (int n = 0; n < T::NCH; ++n)
#pragma unroll
          for (int j = 0; j < T::CW / 2; ++j) o[n][j] *= (j & 2) ? corr_b : corr_a;
        // p as the A operand: keys 16 kk .. 16 kk + 15 of the two rows
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

        mbar_wait(v_full(s), phase);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int n = 0; n < T::NCH; ++n)
            wgmma_rs<T::CW>(o[n], pa[kk],
                            smem_desc(s_v(s) + n * kBlockK * T::CB + kk * 16 * T::CB,
                                      kBlockK * T::CB, 8 * T::CB, T::LAYOUT));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int n = 0; n < T::NCH; ++n) hold(o[n]);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) hold(pa[kk]);
      } else {
        // a block outside this warpgroup's rows: released all the same, but
        // only once loaded, so that no arrival runs a round ahead
        mbar_wait(k_full(s), phase);
      }
      mbar_arrive(empty(s));
    }

    if (active) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
      // O over this warpgroup's rows of the Q tile, in the swizzled layout
      // of the TMA map (16-byte unit u of row r sits at u ^ (address bits 7+))
      const int rr = 16 * (t / 32) + (t % 32) / 4;
#pragma unroll
      for (int n = 0; n < T::NCH; ++n)
#pragma unroll
        for (int j = 0; j < T::CW / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const float l = half ? lb : la;
            uint32_t off = (rr + 8 * half) * T::CB + (8 * j + col) * 2;
            off ^= ((off >> 7) & (T::CB / 16 - 1)) << 4;
            *reinterpret_cast<uint32_t*>(gbase + n * kBlockQ * T::CB + wg * 64 * T::CB + off) =
                pack_bf16(o[n][4 * j + 2 * half] / l, o[n][4 * j + 2 * half + 1] / l);
          }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
      if (t == 0) {
        for (int n = 0; n < T::NCH; ++n)
          tma_store(&tm_o, q_rows + n * kBlockQ * T::CB, n * T::CW, h, r0, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up through the runtime, so that the library
// links no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault) != cudaSuccess)
      return nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// (B, S, heads, hd) bf16 viewed as (hd, heads, S, B), innermost first; a box
// is `cw` columns of `rows` rows of one head.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int hd, int heads, int S,
                int B, int cw, int rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)hd * 2, (cuuint64_t)heads * hd * 2,
                                 (cuuint64_t)S * heads * hd * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cw, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_hd(const __nv_bfloat16* q, const __nv_bfloat16* k, const __nv_bfloat16* v,
                      __nv_bfloat16* o, int B, int S, int H, int KV, int causal, int window,
                      float scale, float softcap, cudaStream_t stream) {
  using T = Tile<HD>;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  const CUtensorMapSwizzle swizzle = T::CB == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : T::CB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                   : CU_TENSOR_MAP_SWIZZLE_32B;
  CUtensorMap mq, mk, mv, mo;
  if (!tensor_map(enc, &mq, q, HD, H, S, B, T::CW, kBlockQ, swizzle) ||
      !tensor_map(enc, &mk, k, HD, KV, S, B, T::CW, kBlockK, swizzle) ||
      !tensor_map(enc, &mv, v, HD, KV, S, B, T::CW, kBlockK, swizzle) ||
      !tensor_map(enc, &mo, o, HD, H, S, B, T::CW, 64, swizzle))
    return cudaErrorInvalidValue;
  auto kernel = flash_sm90_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, T::SMEM, stream>>>(mq, mk, mv, mo, S, H, KV, causal, window, scale,
                                              softcap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q, o: (B, S, H, hd) and k, v: (B, S, KV, hd), bf16, contiguous, 16-byte
// aligned, H % KV == 0, hd in {16, 32, 64, 128, 256}; causal 0/1; window 0 =
// full; softcap 0 = off; scale = 1/sqrt(hd).  Returns the launch's cudaError_t.
extern "C" int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                                    const __nv_bfloat16* v, __nv_bfloat16* o, int B, int S,
                                    int H, int KV, int hd, int causal, int window,
                                    float scale, float softcap, void* stream) {
  using namespace repro_torch;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 16:
      return (int)launch_hd<16>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, st);
    case 32:
      return (int)launch_hd<32>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, st);
    case 64:
      return (int)launch_hd<64>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, st);
    case 128:
      return (int)launch_hd<128>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, st);
    case 256:
      return (int)launch_hd<256>(q, k, v, o, B, S, H, KV, causal, window, scale, softcap, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
