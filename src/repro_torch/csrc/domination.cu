// Pareto domination matrix for NSGA-II, with optional dominated-by counts.
//
// Replaces: src/repro/kernels/fused_eval.py::domination_counts_pallas (body
// `_dom_kernel`) and src/repro/kernels/domination.py::domination_pallas
// (body `_kernel`).  A null `cnt` pointer is the domination_pallas case.
//
// Layout: objs [P, M] (T = float or bf16, M <= 8) -> dom [P, P] bytes
// (torch.bool) with dom[i, j] = (objs_i <= objs_j everywhere) and
// (objs_i < objs_j somewhere); cnt [P] int32 = sum_i dom[i, j].
//
// Bound on the H100: bytes written.  The P*P output bytes dwarf the 4*P*M
// input bytes, and the 2M compares per pair are far below the card's rate.
// At the main path's P = 64 and 128 the whole call moves under 17 KB, so
// the launch dominates.
//
// Design: one thread per column j, holding objs_j in registers and its
// count in a register (deterministic, no atomics).  Rows i stream through
// shared memory in chunks of one block's width; each thread writes its
// byte of row i, so a warp's stores to dom[i, :] are contiguous.  M is an
// argument, so NSGA-II on more objectives needs no other path.  The TPU's
// +inf padding rows are not needed: loops stop at the real P.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxM = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
domination_kernel(const T* __restrict__ objs, unsigned char* __restrict__ dom,
                  int* __restrict__ cnt, int P, int M) {
  __shared__ float rows[kThreads * kMaxM];
  const int j = blockIdx.x * kThreads + threadIdx.x;

  float col[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m)
    col[m] = (j < P && m < M) ? to_f32(objs[static_cast<size_t>(j) * M + m]) : 0.0f;

  int count = 0;
  for (int i0 = 0; i0 < P; i0 += kThreads) {
    const int n_rows = min(kThreads, P - i0);
    __syncthreads();
    for (int k = threadIdx.x; k < n_rows * M; k += kThreads)
      rows[k] = to_f32(objs[static_cast<size_t>(i0) * M + k]);
    __syncthreads();
    if (j >= P) continue;
    for (int r = 0; r < n_rows; ++r) {
      bool le = true;
      bool lt = false;
#pragma unroll
      for (int m = 0; m < kMaxM; ++m) {
        if (m < M) {
          const float a = rows[r * M + m];
          le = le && (a <= col[m]);
          lt = lt || (a < col[m]);
        }
      }
      const bool d = le && lt;
      dom[static_cast<size_t>(i0 + r) * P + j] = d;
      count += d;
    }
  }
  if (cnt != nullptr && j < P) cnt[j] = count;
}

template <typename T>
int launch(const void* objs, void* dom, void* cnt, int P, int M, void* stream) {
  const int blocks = (P + kThreads - 1) / kThreads;
  domination_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(objs), static_cast<unsigned char*>(dom),
      static_cast<int*>(cnt), P, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" int domination_f32(const void* objs, void* dom, void* cnt, int P, int M,
                              void* stream) {
  return launch<float>(objs, dom, cnt, P, M, stream);
}

extern "C" int domination_bf16(const void* objs, void* dom, void* cnt, int P, int M,
                               void* stream) {
  return launch<__nv_bfloat16>(objs, dom, cnt, P, M, stream);
}

REPRO_EXPORT_ERROR_STRING(domination)
