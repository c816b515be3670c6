// Flash attention in float32 on the CUDA cores: causal / sliding-window /
// logit-softcapped GQA attention by online softmax.  bf16 inputs run on the
// tensor cores instead (flash_attention_sm90.cu).
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py:
// flash_attention_pallas (_kernel), the fused counterpart of the JAX
// package's repro/models/attention.py:attend_blockwise.  Per query row and
// key block: s = (q * 1/sqrt(hd)) . k;
// s = tanh(s / softcap) * softcap; masked (k > q when causal, k <= q - window
// when window > 0, k >= S) to NEG_INF = -2e30; then m' = max(m, max s),
// p = exp(s - m'), l = l * exp(m - m') + sum p, acc = acc * exp(m - m') + p v,
// m from -inf; out = acc / max(l, 1e-30).
//
// What bounds it on an H100: the operations.  QK^T and PV are 4 * hd flops per
// (query, key) pair the mask keeps: at gemma2-2b's layer (batch 4, 8160
// tokens, 8 query and 4 key/value heads, head dim 256) 1.09 TFLOP for a global
// layer, 16.3 ms at the 67 TFLOP/s of float32 on the CUDA cores, against 802
// MB of q, k, v and o (0.24 ms at 3.35 TB/s).
//
// What the design does about it: the simple form, float32 FMAs.  One thread
// block of 256 threads owns kBlockQ = 64 query rows of one (batch, head) and
// walks the kBlockK = 64-key blocks its rows can see: the blocks wholly past
// the diagonal (causal) and wholly left of the window are skipped, which
// only changes rounding (a fully masked block adds exp(0) terms that a later
// exp(-2e30 - m) = 0 wipes out).  Shared memory holds the scaled Q tile and
// the K tile transposed (d-major), the V tile row-major, the block's
// probabilities and the per-row max, sum and correction (213,760 bytes at
// hd 256).  A thread forms a 4 x 4 tile of scores from one float4 of Q and
// one of K per d, and owns (64 / TR) rows x (hd / TC) columns of the float32
// accumulator in registers.  GQA reads the (B, S, H, hd) and (B, S, KV, hd)
// tensors in place: query head h reads key/value head h / (H / KV), so no key
// or value is copied.  Keys past S are masked (their K and V read as 0) and
// rows past S are not written, so any sequence length runs.  No atomics:
// two launches on the same inputs write the same bits.
#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>
#include <cstdint>

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;   // query rows per block
constexpr int kBlockK = 64;   // keys per step of a block's loop
constexpr float kNegInf = -2.0e30f;

// 32 bytes (8 floats) of row `row` from element d0; zeros past the sequence.
__device__ __forceinline__ void load_chunk(const float* __restrict__ base, size_t row_stride,
                                           int row, int S, int d0, float (&f)[8]) {
  constexpr int n = 8;
  if (row >= S) {
#pragma unroll
    for (int e = 0; e < n; ++e) f[e] = 0.f;
    return;
  }
  const uint4* src = reinterpret_cast<const uint4*>(base + (size_t)row * row_stride + d0);
  uint4 raw[2];
  raw[0] = __ldg(src);
  raw[1] = __ldg(src + 1);
  const float* t = reinterpret_cast<const float*>(raw);
#pragma unroll
  for (int e = 0; e < n; ++e) f[e] = t[e];
}

template <int HD>
struct Layout {
  // the accumulator: TC threads across the columns, TR across the rows
  static constexpr int TC = HD < 32 ? HD : 32;
  static constexpr int TR = kThreads / TC;
  static constexpr int RM = kBlockQ / TR;  // rows per thread
  static constexpr int CN = HD / TC;       // columns per thread
  static constexpr int VW = CN < 4 ? CN : 4;  // columns per vector load
  static constexpr size_t smem_floats =
      (size_t)HD * kBlockQ + 2 * (size_t)HD * kBlockK + kBlockQ * kBlockK + 3 * kBlockQ;
};

// The VW-wide column groups j of a thread's columns: VW * tc + VW * TC * j.
template <int HD>
__device__ __forceinline__ void load_cols(const float* __restrict__ row, int tc,
                                          float (&out)[Layout<HD>::CN]) {
  using L = Layout<HD>;
#pragma unroll
  for (int j = 0; j < L::CN / L::VW; ++j) {
    const float* src = row + L::VW * tc + L::VW * L::TC * j;
    if constexpr (L::VW == 4) {
      const float4 x = *reinterpret_cast<const float4*>(src);
      out[4 * j] = x.x;
      out[4 * j + 1] = x.y;
      out[4 * j + 2] = x.z;
      out[4 * j + 3] = x.w;
    } else if constexpr (L::VW == 2) {
      const float2 x = *reinterpret_cast<const float2*>(src);
      out[2 * j] = x.x;
      out[2 * j + 1] = x.y;
    } else {
      out[j] = src[0];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int S, int H, int KV,
                 int causal, int window, float scale, float softcap) {
  using L = Layout<HD>;
  constexpr int CH = 8;  // elements per 32-byte chunk
  constexpr int NCH = HD / CH;        // chunks per row
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // (HD, kBlockQ): q * scale, d-major
  float* kt = qt + HD * kBlockQ;                 // (HD, kBlockK): k, d-major
  float* vs = kt + HD * kBlockK;                 // (kBlockK, HD): v
  float* ps = vs + kBlockK * HD;                 // (kBlockQ, kBlockK): p
  float* m_s = ps + kBlockQ * kBlockK;           // per row: running max,
  float* l_s = m_s + kBlockQ;                    // running sum,
  float* c_s = l_s + kBlockQ;                    // this step's correction

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kBlockQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = h / (H / KV);
  const size_t q_row = (size_t)H * HD, kv_row = (size_t)KV * HD;
  const float* qb = q + (size_t)b * S * q_row + (size_t)h * HD;
  const float* kb = k + (size_t)b * S * kv_row + (size_t)g * HD;
  const float* vb = v + (size_t)b * S * kv_row + (size_t)g * HD;
  float* ob = o + (size_t)b * S * q_row + (size_t)h * HD;

  for (int c = tid; c < kBlockQ * NCH; c += kThreads) {
    const int r = c % kBlockQ, d0 = (c / kBlockQ) * CH;
    float f[CH];
    load_chunk(qb, q_row, q0 + r, S, d0, f);
#pragma unroll
    for (int e = 0; e < CH; ++e) qt[(d0 + e) * kBlockQ + r] = f[e] * scale;
  }
  if (tid < kBlockQ) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }

  // scores: rows 4 sr .. 4 sr + 3, keys 4 sc .. 4 sc + 3 of the step
  const int sr = tid / 16, sc = tid % 16;
  // accumulator: rows tr * RM + i, columns VW * tc + VW * TC * j + e
  const int tr = tid / L::TC, tc = tid % L::TC;
  float acc[L::RM][L::CN];
#pragma unroll
  for (int i = 0; i < L::RM; ++i)
#pragma unroll
    for (int n = 0; n < L::CN; ++n) acc[i][n] = 0.f;

  const int k_end = causal ? min(S, q0 + kBlockQ) : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / kBlockK * kBlockK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // the last step is done with kt, vs and ps
    for (int c = tid; c < kBlockK * NCH; c += kThreads) {
      const int j = c % kBlockK, d0 = (c / kBlockK) * CH;
      float f[CH];
      load_chunk(kb, kv_row, k0 + j, S, d0, f);
#pragma unroll
      for (int e = 0; e < CH; ++e) kt[(d0 + e) * kBlockK + j] = f[e];
    }
    for (int c = tid; c < kBlockK * NCH; c += kThreads) {
      const int d0 = (c % NCH) * CH, j = c / NCH;
      float f[CH];
      load_chunk(vb, kv_row, k0 + j, S, d0, f);
#pragma unroll
      for (int e = 0; e < CH; e += 4)
        *reinterpret_cast<float4*>(vs + j * HD + d0 + e) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kBlockQ + 4 * sr);
      const float4 bk = *reinterpret_cast<const float4*>(kt + d * kBlockK + 4 * sc);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(av[r], bv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = 4 * sr + r, qpos = q0 + row;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kpos = k0 + 4 * sc + c;
        float x = s[r][c];
        if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
        bool ok = kpos < S;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[r][c] = ok ? x : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      // the row's 64 keys lie in the 16 lanes of this half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = m_s[row];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - m_new);
        sum += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      *reinterpret_cast<float4*>(ps + row * kBlockK + 4 * sc) =
          make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
      if (sc == 0) {  // every lane of the half-warp has read m_old (the shuffles)
        const float corr = expf(m_old - m_new);
        m_s[row] = m_new;
        l_s[row] = l_s[row] * corr + sum;
        c_s[row] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < L::RM; ++i) {
      const float corr = c_s[tr * L::RM + i];
#pragma unroll
      for (int n = 0; n < L::CN; ++n) acc[i][n] *= corr;
    }
    for (int j0 = 0; j0 < kBlockK; j0 += 4) {
      float p[L::RM][4];
#pragma unroll
      for (int i = 0; i < L::RM; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(ps + (tr * L::RM + i) * kBlockK + j0);
        p[i][0] = x.x;
        p[i][1] = x.y;
        p[i][2] = x.z;
        p[i][3] = x.w;
      }
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        float vv[L::CN];
        load_cols<HD>(vs + (j0 + jj) * HD, tc, vv);
#pragma unroll
        for (int i = 0; i < L::RM; ++i)
#pragma unroll
          for (int n = 0; n < L::CN; ++n) acc[i][n] = fmaf(p[i][jj], vv[n], acc[i][n]);
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < L::RM; ++i) {
    const int row = tr * L::RM + i, qpos = q0 + row;
    if (qpos >= S) continue;
    const float l = fmaxf(l_s[row], 1e-30f);
    float* orow = ob + (size_t)qpos * q_row;
#pragma unroll
    for (int j = 0; j < L::CN / L::VW; ++j)
#pragma unroll
      for (int e = 0; e < L::VW; ++e)
        orow[L::VW * tc + L::VW * L::TC * j + e] = acc[i][j * L::VW + e] / l;
  }
}

template <int HD>
cudaError_t launch_hd(const float* q, const float* k, const float* v, float* o, int B, int S,
                      int H, int KV, int causal, int window, float scale, float softcap,
                      cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout<HD>::smem_floats;
  auto kernel = flash_kernel<HD>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  kernel<<<grid, kThreads, smem, stream>>>(q, k, v, o, S, H, KV, causal, window, scale,
                                           softcap);
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
