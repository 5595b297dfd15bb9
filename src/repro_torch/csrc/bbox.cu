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
// a third of a microsecond at 3.35 TB/s: the latency of the loads and the
// launch decide the time.
//
// Design.  One block per row.  The row's U * B values of each array are
// contiguous (8960 bytes at the path's shape), so the block stages them in
// shared memory coalesced, `tile_units` units at a time (the whole row up
// to MAX_TILE values): 16-byte loads where the address allows, a scalar
// head and tail where it does not (common.cuh Strip), every load of a thread
// in flight before any store, and `threads` threads enough for one round
// trip per tile.  Each unit's min and max are then taken from shared
// memory by `sub` lanes, the largest power of two <= 32 that divides B,
// lane s reading blocks s, s + sub, ...: B / sub is odd (or a warp holds
// one unit), so the 32 lanes of a warp read 32 distinct banks with no
// padding (at B = 28, 4 lanes per unit; one lane per unit, 28 words
// apart, met 4-way conflicts).  The lanes combine with xor shuffles and
// the block takes the max over its units: one store per row, no memset.
// kernels/bbox.py::plan picks tile_units, sub and threads.  Min and max
// are exact, so a row gives the same bits alone, in a slice and in any
// batch.  (A cluster of up to 8 blocks per row, combining maxima through
// distributed shared memory, measured slower than one block per row at
// every row count from 1 to 2048 on the H100: see PERF.md.)
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxTile = 4096;              // values per array: 2 x (4096 + 4) floats = 32 KB
constexpr int kUnroll = 4;                  // 16-byte loads in flight per array and thread

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
bbox_kernel(const T* __restrict__ ux, const T* __restrict__ uy, float* __restrict__ out,
            int U, int B, int tile_units, int sub) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float scratch[32];
  const size_t off = static_cast<size_t>(blockIdx.x) * U * B;
  const int room = room_floats(tile_units * B);
  const int per_pass = blockDim.x / sub;    // units a pass of the block covers
  const int j_lane = threadIdx.x / sub, s = threadIdx.x % sub;
  float best = -INFINITY;
  for (int u0 = 0; u0 < U; u0 += tile_units) {
    const int nu = min(tile_units, U - u0);
    const Strip<T> st[2] = {make_strip(ux + off + static_cast<size_t>(u0) * B, nu * B, smem),
                            make_strip(uy + off + static_cast<size_t>(u0) * B, nu * B,
                                       smem + room)};
    if (u0 > 0) __syncthreads();            // the last tile's reads are done
    stage_strips<kUnroll>(st, threadIdx.x, blockDim.x);
    __syncthreads();
    for (int j0 = 0; j0 < nu; j0 += per_pass) {
      const int j = j0 + j_lane;
      float x_lo = INFINITY, x_hi = -INFINITY, y_lo = INFINITY, y_hi = -INFINITY;
      if (j < nu) {
        const float* px = st[0].dst + j * B;
        const float* py = st[1].dst + j * B;
        for (int b = s; b < B; b += sub) {
          const float x = px[b], y = py[b];
          x_lo = fminf(x_lo, x);
          x_hi = fmaxf(x_hi, x);
          y_lo = fminf(y_lo, y);
          y_hi = fmaxf(y_hi, y);
        }
      }
      for (int o = sub / 2; o > 0; o >>= 1) {
        x_lo = fminf(x_lo, __shfl_xor_sync(0xffffffffu, x_lo, o));
        x_hi = fmaxf(x_hi, __shfl_xor_sync(0xffffffffu, x_hi, o));
        y_lo = fminf(y_lo, __shfl_xor_sync(0xffffffffu, y_lo, o));
        y_hi = fmaxf(y_hi, __shfl_xor_sync(0xffffffffu, y_hi, o));
      }
      if (j < nu) best = fmaxf(best, (x_hi - x_lo) + (y_hi - y_lo));
    }
  }
  best = block_reduce<true>(best, scratch);
  if (threadIdx.x == 0) out[blockIdx.x] = best;
}

template <typename T>
int launch(const void* ux, const void* uy, void* out, int P, int U, int B, int tile_units,
           int sub, int threads, void* stream) {
  // the plan's invariants (kernels/bbox.py::plan holds the same)
  if (P < 1 || U < 1 || B < 1 || tile_units < 1 || tile_units > U ||
      tile_units * B > kMaxTile || sub < 1 || sub > 32 || (sub & (sub - 1)) != 0 ||
      B % sub != 0 || threads < 32 || threads > kMaxThreads || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * room_floats(tile_units * B) * sizeof(float);
  bbox_kernel<T><<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(ux), static_cast<const T*>(uy), static_cast<float*>(out), U, B,
      tile_units, sub);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_BBOX_ENTRY(tag, T)                                                              \
  extern "C" int bbox_##tag(const void* ux, const void* uy, void* out, int P, int U, int B,  \
                            int tile_units, int sub, int threads, void* stream) {            \
    return launch<T>(ux, uy, out, P, U, B, tile_units, sub, threads, stream);                \
  }

REPRO_BBOX_ENTRY(f32, float)
REPRO_BBOX_ENTRY(bf16, __nv_bfloat16)

REPRO_EXPORT_ERROR_STRING(bbox)
