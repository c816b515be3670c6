// BSI adjoint, separable form: dense cotangent -> control-grid cotangent.
//
// Replaces: the Pallas TPU kernel
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
