// Shared device helpers for the repro_torch kernels (built for sm_90a).
//
// Every kernel library exports a plain C interface: one entry point per
// input dtype returning the cudaError_t of its launch as an int, plus
// `<name>_error_string` so the Python wrapper can name a failure.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sum (kMax = false) or max (kMax = true) of one value per
// thread; blockDim.x must be a multiple of 32.  The result is valid in
// thread 0.  `scratch` holds >= 32 floats of shared memory; the leading
// barrier makes back-to-back calls on the same scratch safe.
template <bool kMax>
__device__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  __syncthreads();
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  const float neutral = kMax ? -INFINITY : 0.0f;
  v = threadIdx.x < n_warps ? scratch[threadIdx.x] : neutral;
  if (warp == 0) v = kMax ? warp_max(v) : warp_sum(v);
  return v;
}

// ------------------------------------------------ staging a row in shared memory

// Shared floats per staged array: n + 3 for the Strip's shift, rounded up
// so that the next array starts 16-byte aligned.
__host__ __device__ constexpr int room_floats(int n) { return ((n + 3) & ~3) + 4; }

// One array's run of n elements, staged into shared memory as f32 in
// three parts: a scalar head up to the source's first 16-byte boundary,
// a body of 16-byte loads (4 floats or 8 bf16 each), a scalar tail.  The
// split follows the address only; element i always lands in dst[i], so
// what is computed from the staged values does not depend on alignment.
template <typename T>
struct Strip {
  const T* src;
  float* dst;      // dst + head is 16-byte aligned, so the body stores whole vectors
  int n, head, nvec;
};

// `room` is 16-byte aligned shared memory for n + 3 floats.
template <typename T>
__device__ __forceinline__ Strip<T> make_strip(const T* src, int n, float* room) {
  constexpr int kVec = 16 / sizeof(T);
  Strip<T> s;
  s.src = src;
  s.n = n;
  const int head = static_cast<int>(
      ((16u - (static_cast<unsigned>(reinterpret_cast<uintptr_t>(src)) & 15u)) & 15u) /
      sizeof(T));
  s.head = head < n ? head : n;
  s.nvec = (n - s.head) / kVec;
  s.dst = room + ((4 - (s.head & 3)) & 3);
  return s;
}

__device__ __forceinline__ void store_vec(float* dst, uint4 raw, float) {
  *reinterpret_cast<uint4*>(dst) = raw;
}

__device__ __forceinline__ void store_vec(float* dst, uint4 raw, __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// Stages K strips with the `nt` threads tid = 0 .. nt - 1 of a group.  A
// thread issues every load of a round -- its head and tail value and
// kUnroll 16-byte loads per strip -- before any store, so a strip of up to
// nt * kUnroll vectors costs one round trip to memory.  The caller syncs
// after.
template <int kUnroll, typename T, int K>
__device__ __forceinline__ void stage_strips(const Strip<T> (&s)[K], int tid, int nt) {
  constexpr int kVec = 16 / sizeof(T);
  int most = 0;
  float edge[K][2];
#pragma unroll
  for (int a = 0; a < K; ++a) {           // head and tail: fewer than kVec <= nt values each
    const int tail = s[a].head + s[a].nvec * kVec;
    edge[a][0] = tid < s[a].head ? to_f32(__ldg(s[a].src + tid)) : 0.0f;
    edge[a][1] = tail + tid < s[a].n ? to_f32(__ldg(s[a].src + tail + tid)) : 0.0f;
    most = s[a].nvec > most ? s[a].nvec : most;
  }
  int v0 = tid;
  do {
    uint4 raw[K][kUnroll];
#pragma unroll
    for (int a = 0; a < K; ++a)
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (v0 + k * nt < s[a].nvec)
          raw[a][k] = __ldg(reinterpret_cast<const uint4*>(s[a].src + s[a].head) + v0 + k * nt);
    if (v0 == tid) {
#pragma unroll
      for (int a = 0; a < K; ++a) {
        const int tail = s[a].head + s[a].nvec * kVec;
        if (tid < s[a].head) s[a].dst[tid] = edge[a][0];
        if (tail + tid < s[a].n) s[a].dst[tail + tid] = edge[a][1];
      }
    }
#pragma unroll
    for (int a = 0; a < K; ++a)
#pragma unroll
      for (int k = 0; k < kUnroll; ++k)
        if (v0 + k * nt < s[a].nvec)
          store_vec(s[a].dst + s[a].head + (v0 + k * nt) * kVec, raw[a][k], T());
    v0 += kUnroll * nt;
  } while (v0 < most);
}

#define REPRO_EXPORT_ERROR_STRING(name)                          \
  extern "C" const char* name##_error_string(int err) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(err));   \
  }
