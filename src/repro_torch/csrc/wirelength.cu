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
// a microsecond at 3.35 TB/s: the latency of the loads and the launch
// decide the time.
//
// Design.  One block of `threads` threads per row (the plan,
// kernels/wirelength.py::plan, sets threads from N alone).  Thread t takes
// nets t, t + threads, t + 2 threads, ..., kUnroll of them at a time, and
// issues the loads of all five arrays for those kUnroll nets before it
// uses any: at N = 1999, 256 threads, two rounds of 20 loads in flight per
// thread, where one net's five loads per trip of a loop cost a round trip
// to memory each.  A warp's loads of one array are 32 consecutive values,
// one 128-byte request, whatever the row's alignment (f32 rows of 1999
// nets start 16-byte aligned one row in four).  Each thread adds its nets
// in order, then the block adds the threads' sums in a fixed tree
// (common.cuh block_reduce): one store per row, no memset, no atomics.
// Batch invariance: which thread adds which net, and in what order, is a
// function of N alone -- not of P, the row, the grid or the row's
// alignment -- so a row gives the same bits alone, in a slice and in any
// batch.
// Measured on the H100 (PERF.md): a cluster of 8 blocks per row
// combining partial sums through distributed shared memory, and 16-byte
// loads of 4-net groups (scalar loads where a row is not aligned), were
// slower than this design at the paths' row counts; at 256 rows and more
// the cluster launches cost more than the whole kernel.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 4;                  // nets in flight per array and thread

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
wirelength_kernel(const T* __restrict__ x1, const T* __restrict__ y1, const T* __restrict__ x2,
                  const T* __restrict__ y2, const T* __restrict__ w, long long w_stride,
                  float* __restrict__ out, int N) {
  __shared__ float scratch[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * N;
  const T* __restrict__ wr = w + static_cast<size_t>(blockIdx.x) * w_stride;
  float acc = 0.0f;
  for (int n0 = threadIdx.x; n0 < N; n0 += kUnroll * blockDim.x) {
    float a[kUnroll], b[kUnroll], c[kUnroll], d[kUnroll], e[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int n = n0 + k * blockDim.x;
      const bool in = n < N;
      a[k] = in ? to_f32(__ldg(x1 + off + n)) : 0.0f;
      b[k] = in ? to_f32(__ldg(y1 + off + n)) : 0.0f;
      c[k] = in ? to_f32(__ldg(x2 + off + n)) : 0.0f;
      d[k] = in ? to_f32(__ldg(y2 + off + n)) : 0.0f;
      e[k] = in ? to_f32(__ldg(wr + n)) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (n0 + k * blockDim.x < N) {
        const float dl = (fabsf(a[k] - c[k]) + fabsf(b[k] - d[k])) * e[k];
        acc = __fmaf_rn(dl, dl, acc);
      }
    }
  }
  acc = block_reduce<false>(acc, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

template <typename T>
int launch(const void* x1, const void* y1, const void* x2, const void* y2, const void* w,
           long long w_stride, void* out, int P, int N, int threads, void* stream) {
  // the plan's invariants (kernels/wirelength.py::plan holds the same)
  if (P < 1 || N < 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  wirelength_kernel<T><<<P, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x1), static_cast<const T*>(y1), static_cast<const T*>(x2),
      static_cast<const T*>(y2), static_cast<const T*>(w), w_stride, static_cast<float*>(out), N);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_WIRELENGTH_ENTRY(tag, T)                                                     \
  extern "C" int wirelength_##tag(const void* x1, const void* y1, const void* x2,          \
                                  const void* y2, const void* w, long long w_stride,       \
                                  void* out, int P, int N, int threads, void* stream) {    \
    return launch<T>(x1, y1, x2, y2, w, w_stride, out, P, N, threads, stream);            \
  }

REPRO_WIRELENGTH_ENTRY(f32, float)
REPRO_WIRELENGTH_ENTRY(bf16, __nv_bfloat16)

REPRO_EXPORT_ERROR_STRING(wirelength)
