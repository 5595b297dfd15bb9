// Population-batched maximum bounding box (paper Eq. 2).
//
// Replaces: src/repro/kernels/bbox.py::maxbbox_pallas (body `_kernel`).
//
// Layout: ux, uy [P, U, B] (T = float or bf16) -> out [P] fp32 =
// max_u (max_b ux - min_b ux) + (max_b uy - min_b uy).  Inputs are upcast
// to f32 on load.
//
// Bound on the H100: bytes (8 bytes per block in f32 against ~4 compares).
// At the main path's shape (P = 64, U = 80, B = 28) the call reads ~1.1 MB,
// a third of a microsecond at 3.35 TB/s, so the launch dominates.
//
// Design: one block per row, one thread per unit (strided when U exceeds
// the block), each walking its unit's B contiguous blocks, then one block
// max.  The TPU version transposed to [P, B, U] and padded units and blocks
// with neutral copies; here the loops stop at the real U and B.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
bbox_kernel(const T* __restrict__ ux, const T* __restrict__ uy,
            float* __restrict__ out, int U, int B) {
  __shared__ float scratch[32];
  const size_t row = static_cast<size_t>(blockIdx.x) * U * B;
  float best = -INFINITY;
  for (int u = threadIdx.x; u < U; u += kThreads) {
    const T* px = ux + row + static_cast<size_t>(u) * B;
    const T* py = uy + row + static_cast<size_t>(u) * B;
    float x_lo = INFINITY, x_hi = -INFINITY, y_lo = INFINITY, y_hi = -INFINITY;
    for (int b = 0; b < B; ++b) {
      const float x = to_f32(px[b]);
      const float y = to_f32(py[b]);
      x_lo = fminf(x_lo, x);
      x_hi = fmaxf(x_hi, x);
      y_lo = fminf(y_lo, y);
      y_hi = fmaxf(y_hi, y);
    }
    best = fmaxf(best, (x_hi - x_lo) + (y_hi - y_lo));
  }
  best = block_reduce<true>(best, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

template <typename T>
int launch(const void* ux, const void* uy, void* out, int P, int U, int B,
           void* stream) {
  bbox_kernel<T><<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ux), static_cast<const T*>(uy),
      static_cast<float*>(out), U, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" int bbox_f32(const void* ux, const void* uy, void* out, int P, int U,
                        int B, void* stream) {
  return launch<float>(ux, uy, out, P, U, B, stream);
}

extern "C" int bbox_bf16(const void* ux, const void* uy, void* out, int P, int U,
                         int B, void* stream) {
  return launch<__nv_bfloat16>(ux, uy, out, P, U, B, stream);
}

REPRO_EXPORT_ERROR_STRING(bbox)
