// Population-batched squared wirelength (paper Eq. 1) over gathered endpoints.
//
// Replaces: src/repro/kernels/wirelength.py::wirelength2_pallas (body
// `_kernel`).
//
// Layout: x1, y1, x2, y2 [P, N] (T = float or bf16), w [N] (w_stride 0) or
// [P, N] (w_stride N) -> out [P] fp32 = sum_n ((|x1-x2| + |y1-y2|) w)^2.
// All inputs are upcast to f32 on load and accumulated in f32.
//
// Bound on the H100: bytes.  16 bytes per (row, net) in f32 against ~8
// flops.  At the main path's shape (P = 64, N = 1999) that is ~2 MB, under
// a microsecond at 3.35 TB/s, so the launch dominates.
//
// Design: one block per row, threads stride over the row's nets (loads
// coalesce across the warp), then one block sum.  The TPU's sequential net
// tiles accumulating into a revisited output tile become that loop; no
// padding, since the loop stops at the real N.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
wirelength_kernel(const T* __restrict__ x1, const T* __restrict__ y1,
                  const T* __restrict__ x2, const T* __restrict__ y2,
                  const T* __restrict__ w, long long w_stride,
                  float* __restrict__ out, int N) {
  __shared__ float scratch[32];
  const size_t row = static_cast<size_t>(blockIdx.x) * N;
  const T* wr = w + static_cast<size_t>(blockIdx.x) * w_stride;
  float acc = 0.0f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const float dl = (fabsf(to_f32(x1[row + n]) - to_f32(x2[row + n])) +
                      fabsf(to_f32(y1[row + n]) - to_f32(y2[row + n]))) *
                     to_f32(wr[n]);
    acc += dl * dl;
  }
  acc = block_reduce<false>(acc, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <typename T>
int launch(const void* x1, const void* y1, const void* x2, const void* y2,
           const void* w, long long w_stride, void* out, int P, int N, void* stream) {
  wirelength_kernel<T><<<P, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(y1),
      static_cast<const T*>(x2), static_cast<const T*>(y2),
      static_cast<const T*>(w), w_stride, static_cast<float*>(out), N);
  return cudaGetLastError();
}

}  // namespace

extern "C" int wirelength_f32(const void* x1, const void* y1, const void* x2,
                              const void* y2, const void* w, long long w_stride,
                              void* out, int P, int N, void* stream) {
  return launch<float>(x1, y1, x2, y2, w, w_stride, out, P, N, stream);
}

extern "C" int wirelength_bf16(const void* x1, const void* y1, const void* x2,
                               const void* y2, const void* w, long long w_stride,
                               void* out, int P, int N, void* stream) {
  return launch<__nv_bfloat16>(x1, y1, x2, y2, w, w_stride, out, P, N, stream);
}

REPRO_EXPORT_ERROR_STRING(wirelength)
