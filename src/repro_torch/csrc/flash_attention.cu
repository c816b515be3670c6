// Flash attention in float32 on Hopper's tensor cores: causal / sliding-window
// / logit-softcapped GQA attention by online softmax, both products as three
// TF32 products (3xTF32) by mma.sync, the tiles staged by the bulk copy
// engine into a ring of shared memory.  bf16 inputs run on
// flash_attention_sm90.cu instead.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (_kernel), the fused counterpart of the JAX
// package's repro/models/attention.py:attend_blockwise.  Per query row and
// key block: s = (q * 1/sqrt(hd)) . k; s = tanh(s / softcap) * softcap;
// masked (k > q when causal, k <= q - window when window > 0, k >= S) to
// NEG_INF = -2e30; then m' = max(m, max s), p = exp(s - m'),
// l = l * exp(m - m') + sum p, acc = acc * exp(m - m') + p v, m from -inf;
// out = acc / max(l, 1e-30).  Scores, the running max and sum, p and the
// accumulator stay float32.
//
// What bounds it on an H100: the operations.  QK^T and PV are 4 * hd flops
// per (query, key) pair the mask keeps: at gemma2-2b's layer (batch 4, 8160
// tokens, 8 query and 4 key/value heads, head dim 256) 1.09 TFLOP for a
// global layer, 2.20 ms as one dense TF32 product at 495 TFLOP/s (16.3 ms on
// the float32 CUDA cores at 67), against 802 MB of q, k, v and o (0.24 ms at
// 3.35 TB/s).  The three TF32 products this kernel issues take 6.61 ms at
// wgmma's rate; mma.sync TF32 runs at 319 TFLOP/s on the card (6.7 clocks
// an m16n8k8 on a scheduler, launch/mma_rate.cu), 10.2 ms, and a scheduler
// issues nothing else meanwhile, so every split, load and softmax
// instruction adds to that.
//
// The design.  A block of 256 threads owns kBlockQ = 64 query rows of one
// (batch, query head), in two halves of four warps: warp w of either half
// owns rows 16 w .. 16 w + 15, the even half takes the even kBlockK = 32-key
// blocks of the rows' key range and the odd half the odd ones, each warp
// keeping its own online softmax over its blocks.  So each of the SM's four
// schedulers holds one warp of each half, and one warp's softmax, splits and
// loads fill the other's gaps between tensor-core products.  At the end the
// odd half hands its m, l and accumulator over shared memory and the even
// one merges them (m = max, each side scaled by exp(m_side - m)) and writes
// the rows.  A warp skips the blocks its own rows see no key of (past the
// diagonal, left of the window): that changes rounding only, as a fully
// masked block's exp(0) terms are wiped out by a later exp(-2e30 - m) = 0.
// The first warp of each half stages its half's tiles: Q once (64 rows), K
// and V of each block into a ring of 2 stages (hd 256, one a half) or 4,
// one cp.async.bulk a row (a lane a row; the rows padded in shared memory
// so that the fragment loads below hit distinct banks), each tile on an
// mbarrier of its own; it refills K as soon as the half is done with Q K^T
// and V after P V (a named barrier of the half each).  Keys and rows past S
// copy row S - 1: the keys are masked, their p is 0, and no row past S is
// written.
// 1. S = Q K^T by mma.sync.m16n8k8 TF32, a warp's 16 rows by 32 keys, each
//    operand split into hi, the nearest TF32 (split_tf32's, ties away), and
//    the rest x - hi, exact in float32, which the tensor core takes as TF32
//    (its top 19 bits: split_tf32 rounds the rest once more, to the same
//    error, with two more instructions an operand in the hottest loops;
//    TF32 wgmma reads B from shared memory only, K-major, and the hi and lo
//    of K and of V transposed beside Q do not fit at hd 256);
//    the products lo.hi + hi.lo go into an accumulator of their own and
//    hi.hi into S, summed at the end (the tensor cores' sums truncate).
//    Within 16 of d the k-steps take d in the order 4t, 4t+1 | 4t+2, 4t+3
//    (lane t of a group of four), so a lane's Q and K fragments are one
//    float4 each;
// 2. the softcap by accurate tanhf (tanh.approx's ~1e-3 relative error at
//    cap 50 would move a score by ~0.05), s / softcap taken as s times the
//    float32 reciprocal (from the host), as PyTorch divides a CUDA tensor
//    by a scalar; the masks, only on the diagonal, window-edge and ragged
//    blocks; the row max and sum over the 4 lanes that hold a row, expf;
// 3. O += P V, p in float32 split as above: the S accumulator gives a lane
//    keys 2t and 2t + 1 of each 8, where the A fragment wants t and t + 4,
//    so the k-step takes the keys in that order (P V sums over the keys; only
//    the order of its sums changes) and V's B fragment is loaded from rows
//    2t and 2t + 1.  The output columns are permuted likewise, n-tile n of a
//    chunk of 32 taking columns 4 g + n (16 and 2 g + n at hd 16), so a
//    lane's V values of four n-tiles are one float4 and its outputs 8
//    adjacent columns.  Each chunk's P V of the block is summed in fresh
//    accumulators (the small products apart) and added to the float32 O, so
//    no sum over blocks runs in the tensor cores.
// At hd 256 O is 128 float32 registers a thread: built at ptxas -O1
// (kernels/build.py) it takes 253 and spills nothing; at -O3 ptxas hoists
// loads past the 255 registers and keeps accumulator values in local memory.
// Shared memory at hd 256: Q 64 x 272 floats + 2 stages x (K 32 x 272 + V 32
// x 260) = 205,952 bytes with the barriers; one block an SM.  Query blocks
// with the most key blocks run first (the grid's slow axis counts down).  GQA reads the (B, S, H, hd) and
// (B, S, KV, hd) tensors in place: query head h reads key/value head
// h / (H / KV).  No atomics: two launches on the same inputs write the same
// bits.
//
// REPRO_FLASH_SKIP (measurement builds, launch/profile_flash.py): 1 leaves
// out the K and V staging, 2 the product Q K^T, 4 the softcap and softmax, 8
// the product P V.
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>

#include "bsi_common.cuh"

#ifndef REPRO_FLASH_SKIP
#define REPRO_FLASH_SKIP 0
#endif

namespace repro_torch {
namespace {

constexpr int kBlockQ = 64;    // query rows per block, 16 a warp of each half
constexpr int kBlockK = 32;    // keys per stage: a row a lane of a staging warp
constexpr int kFlashThreads = 256;  // two halves of 4 warps
constexpr float kNegInf = -2.0e30f;

template <int HD>
struct Cfg {
  // row strides in floats: Q and K rows 16 floats past a multiple of 32
  // (a float4 fragment load of 8 lanes on 8 bank groups), V rows 4 past
  static constexpr int QS = HD == 16 ? 16 : HD + 16;
  static constexpr int VS = HD + 4;
  static constexpr int NV = HD >= 32 ? 4 : 2;       // n-tiles of one V vector load
  static constexpr int CW = 8 * NV;                 // output columns of a chunk
  static constexpr int NC = HD / CW;                // chunks
  static constexpr int STAGES = HD == 256 ? 2 : 4;  // even: stage s serves half s % 2
  static constexpr int Q_FLOATS = kBlockQ * QS;
  static constexpr int K_FLOATS = kBlockK * QS;
  static constexpr int STAGE_FLOATS = K_FLOATS + kBlockK * VS;
  // the odd half's hand-over: per warp and lane, O and m, l of two rows
  static constexpr int MERGE_FLOATS = 4 * 32 * (HD / 2 + 4);
  static constexpr int RING_FLOATS =
      STAGES * STAGE_FLOATS > MERGE_FLOATS ? STAGES * STAGE_FLOATS : MERGE_FLOATS;
  static constexpr int BAR_BYTES = 128;  // q_full, and full_k and full_v a stage
  static constexpr size_t SMEM = BAR_BYTES + sizeof(float) * (Q_FLOATS + RING_FLOATS);
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

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, by the bulk copy engine, completing on the mbarrier bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The 128 threads of one half of the block (named barriers 1 and 2).
__device__ __forceinline__ void half_sync(int half) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + half) : "memory");
}

// split_tf32's hi (the nearest TF32 of x, ties away) and the rest x - hi,
// exact in float32, left for the tensor core to take as TF32 (its top 19
// bits): one rounding fewer than split_tf32, in the hottest loops.
__device__ __forceinline__ void split_operand(float x, unsigned* hi, unsigned* lo) {
  *hi = tf32_rna(x);
  *lo = __float_as_uint(x - __uint_as_float(*hi));
}

template <int N>
struct Vec;
template <>
struct Vec<2> {
  __device__ static void load(const float* p, float (&x)[2]) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  }
};
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float (&x)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <int HD>
__global__ void __launch_bounds__(kFlashThreads, 1)
    flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV,
                      int causal, int window, float scale, float softcap, float inv_cap) {
  using C = Cfg<HD>;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem_raw);
  float* const qs = reinterpret_cast<float*>(smem_raw + C::BAR_BYTES);
  float* const ring = qs + C::Q_FLOATS;
  const uint32_t s_q = base + C::BAR_BYTES;
  const uint32_t q_full = base;
  auto stage = [&](int s) { return ring + s * C::STAGE_FLOATS; };
  auto s_addr = [&](const float* p) { return s_q + 4u * (uint32_t)(p - qs); };
  auto full_k = [&](int s) { return base + 8 + 8 * s; };
  auto full_v = [&](int s) { return base + 8 + 8 * C::STAGES + 8 * s; };

  const int b = blockIdx.x / H, h = blockIdx.x % H, g = h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;  // the longest rows first
  int k_lo, k_hi;
  key_range(q0, min(S, q0 + kBlockQ), S, causal, window, k_lo, k_hi);
  const int n_blocks = (k_hi - k_lo + kBlockK - 1) / kBlockK;
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  constexpr uint32_t kRow = HD * sizeof(float);

  // warp w of half `half` owns rows r0 .. r0 + 15 and the key blocks of
  // parity `half`; warp 0 of a half stages its half's tiles
  const int wq = threadIdx.x / 32 % 4, half = threadIdx.x / 128, lane = threadIdx.x % 32;
  const int gr = lane / 4, t = lane % 4;  // the fragments' group and lane in it
  const bool stager = wq == 0;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)g * HD;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)g * HD;
  // block i's K (or V) rows, a row a lane of the staging warp, into stage i % STAGES
  auto stage_tile = [&](int i, bool is_v) {
    const int s = i % C::STAGES;
    const uint32_t bar = is_v ? full_v(s) : full_k(s);
    if (REPRO_FLASH_SKIP & 1) {
      if (lane == 0) mbar_arrive(bar);
      return;
    }
    if (lane == 0) mbar_expect_tx(bar, kBlockK * kRow);
    __syncwarp();
    const size_t row = (size_t)min(k_lo + i * kBlockK + lane, S - 1) * kv_row;
    if (is_v) {
      bulk_load(s_addr(stage(s) + C::K_FLOATS) + 4u * lane * C::VS, vb + row, kRow, bar);
    } else {
      bulk_load(s_addr(stage(s)) + 4u * lane * C::QS, kb + row, kRow, bar);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) {  // Q, rows past S as row S - 1
    const float* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
    if (lane == 0) mbar_expect_tx(q_full, kBlockQ * kRow);
    __syncwarp();
    for (int r = lane; r < kBlockQ; r += 32)
      bulk_load(s_q + 4u * r * C::QS, qb + (size_t)min(q0 + r, S - 1) * q_row, kRow, q_full);
  }
  if (stager)  // the half's first stages
    for (int i = half; i < C::STAGES && i < n_blocks; i += 2) {
      stage_tile(i, false);
      stage_tile(i, true);
    }

  const int r0 = q0 + 16 * wq;
  const int row_a = r0 + gr, row_b = row_a + 8;
  const bool active = r0 < S;
  int m_lo = 0, m_hi = 0;
  if (active) key_range(r0, min(S, r0 + 16), S, causal, window, m_lo, m_hi);

  mbar_wait(q_full, 0);
  for (int e = threadIdx.x; e < kBlockQ * HD; e += kFlashThreads)  // q * scale, as plain
    qs[(e / HD) * C::QS + e % HD] *= scale;
  __syncthreads();

  float acc[C::NC][C::NV][4];
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
#pragma unroll
    for (int n = 0; n < C::NV; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[c][n][r] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const float* qa = qs + (16 * wq + gr) * C::QS + 4 * t;

  for (int i = half; i < n_blocks; i += 2) {
    const int s = i % C::STAGES, k0 = k_lo + i * kBlockK;
    const uint32_t parity = (i / C::STAGES) & 1;
    const float* ks = stage(s);
    const float* vs = ks + C::K_FLOATS;
    const bool visit = active && k0 >= m_lo && k0 < m_hi;
    // S = Q K^T: sc[j][e] is row row_a (e < 2) or row_b, key k0 + 8 j + 2 t + (e & 1)
    float sc[4][4];
    mbar_wait(full_k(s), parity);
    if (visit && (REPRO_FLASH_SKIP & 2)) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = ks[(8 * j + gr) * C::QS + 4 * t + e];
    } else if (visit) {
      float small[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = small[j][e] = 0.f;
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 16) {
        float xa[4], xb[4];
        Vec<4>::load(qa + d0, xa);
        Vec<4>::load(qa + 8 * C::QS + d0, xb);
        unsigned ah[2][4], al[2][4];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          split_operand(xa[2 * kk], &ah[kk][0], &al[kk][0]);
          split_operand(xb[2 * kk], &ah[kk][1], &al[kk][1]);
          split_operand(xa[2 * kk + 1], &ah[kk][2], &al[kk][2]);
          split_operand(xb[2 * kk + 1], &ah[kk][3], &al[kk][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float y[4];
          Vec<4>::load(ks + (8 * j + gr) * C::QS + d0 + 4 * t, y);
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            unsigned bh[2], bl[2];
            split_operand(y[2 * kk], &bh[0], &bl[0]);
            split_operand(y[2 * kk + 1], &bh[1], &bl[1]);
            mma_tf32(small[j], al[kk], bh);
            mma_tf32(small[j], ah[kk], bl);
            mma_tf32(sc[j], ah[kk], bh);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += small[j][e];
    }
    // the half is done with K of stage s: its staging warp refills it
    half_sync(half);
    if (stager && i + C::STAGES < n_blocks) stage_tile(i + C::STAGES, false);

    if (visit) {
      float corr_a = 1.f, corr_b = 1.f;
      if (!(REPRO_FLASH_SKIP & 4)) {
        const bool edge = k0 + kBlockK > S || (causal && k0 + kBlockK - 1 > r0) ||
                          (window > 0 && k0 <= r0 + 15 - window);
        float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = sc[j][e];
            if (softcap > 0.f) x = tanhf(x * inv_cap) * softcap;
            if (edge) {
              const int key = k0 + 8 * j + 2 * t + (e & 1);
              const int row = (e & 2) ? row_b : row_a;
              bool ok = key < S;
              if (causal) ok = ok && key <= row;
              if (window > 0) ok = ok && key > row - window;
              x = ok ? x : kNegInf;
            }
            sc[j][e] = x;
            if (e & 2) {
              mx_b = fmaxf(mx_b, x);
            } else {
              mx_a = fmaxf(mx_a, x);
            }
          }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        corr_a = expf(m_a - mn_a);
        corr_b = expf(m_b - mn_b);
        m_a = mn_a;
        m_b = mn_b;
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(sc[j][e] - ((e & 2) ? mn_b : mn_a));
            sc[j][e] = p;
            if (e & 2) {
              sum_b += p;
            } else {
              sum_a += p;
            }
          }
        l_a = l_a * corr_a + sum_a;  // this lane's share of the row's sum
        l_b = l_b * corr_b + sum_b;
      }

      mbar_wait(full_v(s), parity);
      if (!(REPRO_FLASH_SKIP & 8)) {
        // p as the A operand of k-step j: MMA column t is key 8 j + 2 t,
        // column t + 4 key 8 j + 2 t + 1
        unsigned ph[4][4], pl[4][4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          split_operand(sc[j][0], &ph[j][0], &pl[j][0]);
          split_operand(sc[j][2], &ph[j][1], &pl[j][1]);
          split_operand(sc[j][1], &ph[j][2], &pl[j][2]);
          split_operand(sc[j][3], &ph[j][3], &pl[j][3]);
        }
        // V rows 2t and 2t + 1 of each 8 keys; n-tile n of chunk c takes
        // columns c CW + NV gr + n
        const float* vr = vs + 2 * t * C::VS + C::NV * gr;
#pragma unroll
        for (int c = 0; c < C::NC; ++c) {
          float big[C::NV][4], small[C::NV][4];
#pragma unroll
          for (int n = 0; n < C::NV; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) big[n][e] = small[n][e] = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float v0[C::NV], v1[C::NV];
            Vec<C::NV>::load(vr + 8 * j * C::VS + c * C::CW, v0);
            Vec<C::NV>::load(vr + (8 * j + 1) * C::VS + c * C::CW, v1);
#pragma unroll
            for (int n = 0; n < C::NV; ++n) {
              unsigned bh[2], bl[2];
              split_operand(v0[n], &bh[0], &bl[0]);
              split_operand(v1[n], &bh[1], &bl[1]);
              mma_tf32(small[n], pl[j], bh);
              mma_tf32(small[n], ph[j], bl);
              mma_tf32(big[n], ph[j], bh);
            }
          }
#pragma unroll
          for (int n = 0; n < C::NV; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[c][n][e] = acc[c][n][e] * ((e & 2) ? corr_b : corr_a) +
                             (big[n][e] + small[n][e]);
        }
      }
    } else {
      mbar_wait(full_v(s), parity);  // landed, so that the stage may be refilled
    }
    // and with V
    half_sync(half);
    if (stager && i + C::STAGES < n_blocks) stage_tile(i + C::STAGES, true);
  }

  // the odd half hands its m, l and accumulator to the even half's warp of
  // the same rows, in the ring (every tile has been read)
  __syncthreads();
  float* hand = ring + wq * 32 + lane;  // value x of a lane at hand[128 x]
  if (half == 1) {
#pragma unroll
    for (int c = 0; c < C::NC; ++c)
#pragma unroll
      for (int n = 0; n < C::NV; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) hand[128 * ((c * C::NV + n) * 4 + e)] = acc[c][n][e];
    hand[128 * (HD / 2)] = m_a;
    hand[128 * (HD / 2 + 1)] = m_b;
    hand[128 * (HD / 2 + 2)] = l_a;
    hand[128 * (HD / 2 + 3)] = l_b;
  }
  __syncthreads();
  if (half == 1 || !active) return;
  const float m1_a = hand[128 * (HD / 2)], m1_b = hand[128 * (HD / 2 + 1)];
  // m at least NEG_INF, so that a side that saw no block scales by exp(-inf) = 0
  const float mm_a = fmaxf(fmaxf(m_a, m1_a), kNegInf), mm_b = fmaxf(fmaxf(m_b, m1_b), kNegInf);
  const float c0_a = expf(m_a - mm_a), c1_a = expf(m1_a - mm_a);
  const float c0_b = expf(m_b - mm_b), c1_b = expf(m1_b - mm_b);
  l_a = l_a * c0_a + hand[128 * (HD / 2 + 2)] * c1_a;
  l_b = l_b * c0_b + hand[128 * (HD / 2 + 3)] * c1_b;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float la = fmaxf(l_a, 1e-30f), lb = fmaxf(l_b, 1e-30f);
  float* ob = o + (size_t)b * S * q_row + (size_t)h * HD;
#pragma unroll
  for (int c = 0; c < C::NC; ++c)
#pragma unroll
    for (int e2 = 0; e2 < 4; e2 += 2) {  // row_a, then row_b
      const int row = e2 ? row_b : row_a;
      const float l = e2 ? lb : la, c0 = e2 ? c0_b : c0_a, c1 = e2 ? c1_b : c1_a;
      // columns c CW + 2 t NV + x: n-tile x % NV, accumulator e2 + x / NV
      float out[2 * C::NV];
#pragma unroll
      for (int x = 0; x < 2 * C::NV; ++x) {
        const int n = x % C::NV, e = e2 + x / C::NV;
        const float other = hand[128 * ((c * C::NV + n) * 4 + e)];
        out[x] = (acc[c][n][e] * c0 + other * c1) / l;
      }
      if (row < S) {
        float* dst = ob + (size_t)row * q_row + c * C::CW + 2 * t * C::NV;
#pragma unroll
        for (int x = 0; x < 2 * C::NV; x += 4)
          *reinterpret_cast<float4*>(dst + x) =
              make_float4(out[x], out[x + 1], out[x + 2], out[x + 3]);
      }
    }
}

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v, float* o, int B, int S,
                      int H, int KV, int causal, int window, float scale, float softcap,
                      cudaStream_t stream) {
  auto kernel = flash_tf32_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Cfg<HD>::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + kBlockQ - 1) / kBlockQ);
  // s / softcap as PyTorch divides a CUDA tensor by a scalar: times the
  // float32 reciprocal, taken here, so that the kernel divides nowhere but
  // in its epilogue
  const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
  kernel<<<grid, kFlashThreads, Cfg<HD>::SMEM, stream>>>(q, k, v, o, S, H, KV, causal, window,
                                                        scale, softcap, inv_cap);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// q, o: (B, S, H, hd) and k, v: (B, S, KV, hd), contiguous, 16-byte aligned,
// H % KV == 0, hd in {16, 32, 64, 128, 256}; causal 0/1; window 0 = full;
// softcap 0 = off; scale = 1/sqrt(hd).  Returns the launch's cudaError_t.
extern "C" int flash_attention_f32(const float* q, const float* k, const float* v,
                                   float* o, int B, int S, int H, int KV, int hd,
                                   int causal, int window, float scale, float softcap,
                                   void* stream) {
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
