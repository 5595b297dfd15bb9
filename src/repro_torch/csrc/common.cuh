// Shared device helpers for the repro_torch kernels (built for sm_90a).
//
// Every kernel library exports a plain C interface: one entry point per
// input dtype returning the cudaError_t of its launch as an int, plus
// `<name>_error_string` so the Python wrapper can name a failure.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

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

#define REPRO_EXPORT_ERROR_STRING(name)                          \
  extern "C" const char* name##_error_string(int err) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(err));   \
  }
