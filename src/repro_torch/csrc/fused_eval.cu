// Fused placement evaluation: decode-gather, Eq. 1 and Eq. 2 in one launch.
//
// Replaces: src/repro/kernels/fused_eval.py::fused_eval_pallas (body
// `_eval_kernel`), the TPU kernel that keeps a coordinate row-block in VMEM
// and walks net and unit tiles on a sequential grid axis.
//
// Layout: cx, cy [P, G] (T = float or bf16), src/dst [N] int32, w [N] T,
// uidx [U, B] int32 -> out [P, 2] fp32 = (sum_n ((|dx|+|dy|) w_n)^2,
// max_u (max-min)x + (max-min)y).
//
// Bound on the H100: bytes.  Each row is read once (8 G bytes in f32) and
// the nets/units tables are shared by every row; the arithmetic is ~8 flops
// per net and ~4 per block, far below the fp32 rate.  At the main path's
// shapes (P = 64, G = 2240) the whole call moves ~1.2 MB, a fraction of a
// microsecond at 3.35 TB/s, so the launch itself dominates.
//
// Design: one block per population row.  The TPU's sequential j grid with
// revisited output tiles becomes two loops inside the block: the row's
// coordinates are staged once in shared memory as f32 (8 G bytes: 17.9 KB
// at xcvu11p, 27.5 KB at xcvu3p; above 48 KB the launch opts in to the
// larger carve-out), every gather then hits shared memory, threads stride
// over nets and then over units, and the block reduces with warp shuffles.
// No padding is needed: loops are bounded by the real N, U, B.  An index
// outside [0, G) turns the row's result into NaN instead of reading out of
// bounds.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_eval_kernel(const T* __restrict__ cx, const T* __restrict__ cy,
                  const int* __restrict__ src, const int* __restrict__ dst,
                  const T* __restrict__ w, const int* __restrict__ uidx,
                  float* __restrict__ out, int G, int N, int U, int B) {
  extern __shared__ float coords[];
  float* sx = coords;
  float* sy = coords + G;
  __shared__ float scratch[32];

  const size_t row = static_cast<size_t>(blockIdx.x) * G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    sx[g] = to_f32(cx[row + g]);
    sy[g] = to_f32(cy[row + g]);
  }
  __syncthreads();

  int bad = 0;
  float wl = 0.0f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const int s = src[n];
    const int d = dst[n];
    if (static_cast<unsigned>(s) >= static_cast<unsigned>(G) ||
        static_cast<unsigned>(d) >= static_cast<unsigned>(G)) {
      bad = 1;
      continue;
    }
    const float dl = (fabsf(sx[s] - sx[d]) + fabsf(sy[s] - sy[d])) * to_f32(w[n]);
    wl += dl * dl;
  }

  float bb = -INFINITY;
  for (int u = threadIdx.x; u < U; u += kThreads) {
    const int* ids = uidx + static_cast<size_t>(u) * B;
    float x_lo = INFINITY, x_hi = -INFINITY, y_lo = INFINITY, y_hi = -INFINITY;
    for (int b = 0; b < B; ++b) {
      const int g = ids[b];
      if (static_cast<unsigned>(g) >= static_cast<unsigned>(G)) {
        bad = 1;
        break;
      }
      const float x = sx[g];
      const float y = sy[g];
      x_lo = fminf(x_lo, x);
      x_hi = fmaxf(x_hi, x);
      y_lo = fminf(y_lo, y);
      y_hi = fmaxf(y_hi, y);
    }
    bb = fmaxf(bb, (x_hi - x_lo) + (y_hi - y_lo));
  }

  bad = __syncthreads_or(bad);
  wl = block_reduce<false>(wl, scratch);
  bb = block_reduce<true>(bb, scratch);
  if (threadIdx.x == 0) {
    out[2 * blockIdx.x] = bad ? NAN : wl;
    out[2 * blockIdx.x + 1] = bad ? NAN : bb;
  }
}

template <typename T>
int launch(const void* cx, const void* cy, const void* src, const void* dst,
           const void* w, const void* uidx, void* out, int P, int G, int N,
           int U, int B, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(G) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_eval_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fused_eval_kernel<T><<<P, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cx), static_cast<const T*>(cy),
      static_cast<const int*>(src), static_cast<const int*>(dst),
      static_cast<const T*>(w), static_cast<const int*>(uidx),
      static_cast<float*>(out), G, N, U, B);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_eval_f32(const void* cx, const void* cy, const void* src,
                              const void* dst, const void* w, const void* uidx,
                              void* out, int P, int G, int N, int U, int B,
                              void* stream) {
  return launch<float>(cx, cy, src, dst, w, uidx, out, P, G, N, U, B, stream);
}

extern "C" int fused_eval_bf16(const void* cx, const void* cy, const void* src,
                               const void* dst, const void* w, const void* uidx,
                               void* out, int P, int G, int N, int U, int B,
                               void* stream) {
  return launch<__nv_bfloat16>(cx, cy, src, dst, w, uidx, out, P, G, N, U, B,
                               stream);
}

REPRO_EXPORT_ERROR_STRING(fused_eval)
