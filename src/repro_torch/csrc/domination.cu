// Pareto domination matrix for NSGA-II, with optional dominated-by counts.
//
// Replaces: src/repro/kernels/fused_eval.py::domination_counts_pallas (body
// `_dom_kernel`) and src/repro/kernels/domination.py::domination_pallas
// (body `_kernel`).  A null `cnt` pointer is the domination_pallas case.
//
// Layout: objs [B, P, M] (T = float or bf16, M <= 8) -> dom [B, P, P] bytes
// (torch.bool) with dom[b, i, j] = (objs_bi <= objs_bj everywhere) and
// (objs_bi < objs_bj somewhere); cnt [B, P] int32 = sum_i dom[b, i, j].
// B independent problems (portfolio members or islands, the batch axis
// `jax.vmap` gives the Pallas kernels) share one launch: grid.z = B, and
// each block adds its problem's offset to its indices.  (Offsetting the
// __restrict__ parameters themselves, and testing the store's alignment on
// the pointer, measured ~0.6 us slower per launch on the H100 in
// chip_smoke.py's domination rows, at B = 1 as at B = 8.)
//
// Bound on the H100: bytes written.  The P*P output bytes dwarf the 4*P*M
// input bytes, and the 2M compares per pair are far below the card's rate:
// 0.0053 us at P = 128, 1.26 us at P = 2048 (3.35 TB/s).  At the main
// path's P = 64 and 128 the launch itself dominates.
//
// Design, by size.  Up to P = 256 (the main path's P = 64 and 128): tiles
// of 256 rows by 16 columns, so one row of ceil(P / 16) blocks covers every
// row and each block stores its column sums as the counts: one device op,
// no memset, no atomics.  Above 256: a 2-D grid of 64 x 64 tiles (P =
// 2048: 1,024 blocks), each adding its column sums to cnt with one global
// atomicAdd per column, after a cudaMemsetAsync zeroes cnt on the same
// stream (a second device op, zeroing all B x P counts; chip_smoke.py
// counts both in the device time).  In both, a 256-thread block stages its
// rows' and columns' objectives in shared memory in one pass (columns
// objective-major, so a warp's reads are broadcasts).  Each thread builds 16 consecutive bytes of
// one row and writes them as one 16-byte store where they are aligned and
// inside P, byte by byte at a ragged or misaligned edge (P % 16 != 0).
// Column sums: the lanes of a warp that hold the same columns add their
// 0/1 bytes with xor shuffles (a sum <= 32 never carries into the next
// byte), then one thread per column adds the eight warps' sums.  Integer
// sums do not depend on their order, so counts are exact.  M is an
// argument, so NSGA-II on more objectives needs no other path.  (Measured
// on the H100: the tall tiles were the fastest up to 256 rows and the
// slowest beyond, where each row of a tile is half a 32-byte sector; one
// 64 x 64 grid for every P paid the memset at P = 128; shared-memory
// atomics per set byte, and warp ballots, counted slower than shuffles.)
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBytes = 16;                     // output bytes per thread
constexpr int kThreads = 256;
constexpr int kMaxM = 8;
constexpr int kOneGroupRows = 256;             // tall tiles up to this P

// A block computes a kRows x kCols tile of dom, each thread 16 bytes of
// one row.
template <typename T, int kRows, int kCols>
__global__ void __launch_bounds__(kThreads)
domination_kernel(const T* __restrict__ objs, unsigned char* __restrict__ dom,
                  int* __restrict__ cnt, int P, int M) {
  const T* __restrict__ src = objs + static_cast<size_t>(blockIdx.z) * P * M;
  const size_t dom0 = static_cast<size_t>(blockIdx.z) * P * P;
  __shared__ float rows[kRows][kMaxM];
  __shared__ float cols[kMaxM][kCols];
  __shared__ uint32_t warp_cnt[kThreads / 32][kCols / 4];
  constexpr int kRowThreads = kCols / kBytes;  // threads per row of a tile
  constexpr int kStage = kRows > kCols ? kRows : kCols;
  static_assert(kRows * kRowThreads == kThreads, "one thread per 16 bytes");
  const int i0 = blockIdx.y * kRows;
  const int j0 = blockIdx.x * kCols;
  for (int k = threadIdx.x; k < kStage * M; k += kThreads) {
    const int r = k / M, m = k % M;    // rows and columns in one pass: one latency
    if (r < kRows)
      rows[r][m] = i0 + r < P ? to_f32(src[static_cast<size_t>(i0 + r) * M + m]) : 0.f;
    if (r < kCols)
      cols[m][r] = j0 + r < P ? to_f32(src[static_cast<size_t>(j0 + r) * M + m]) : 0.f;
  }
  __syncthreads();
  const int r = threadIdx.x / kRowThreads;               // row in the tile
  const int c0 = (threadIdx.x % kRowThreads) * kBytes;
  const int i = i0 + r;
  float a[kMaxM];
#pragma unroll
  for (int m = 0; m < kMaxM; ++m) a[m] = m < M ? rows[r][m] : 0.f;
  uint32_t word[kBytes / 4] = {0u, 0u, 0u, 0u};   // byte c in word c / 4
#pragma unroll
  for (int c = 0; c < kBytes; ++c) {
    bool le = true, lt = false;
#pragma unroll
    for (int m = 0; m < kMaxM; ++m) {
      if (m < M) {
        const float b = cols[m][c0 + c];
        le = le && (a[m] <= b);
        lt = lt || (a[m] < b);
      }
    }
    const uint32_t d = le && lt && i < P && (j0 + c0 + c < P);
    word[c / 4] |= d << (8 * (c % 4));
  }
  const size_t base = dom0 + static_cast<size_t>(i) * P + j0 + c0;
  if (i < P && j0 + c0 + kBytes <= P && base % kBytes == 0) {
    *reinterpret_cast<uint4*>(dom + base) = make_uint4(word[0], word[1], word[2], word[3]);
  } else if (i < P) {
#pragma unroll
    for (int c = 0; c < kBytes; ++c)
      if (j0 + c0 + c < P) dom[base + c] = (word[c / 4] >> (8 * (c % 4))) & 0xffu;
  }
  if (cnt == nullptr) return;
  // Column sums: the lanes of a warp that hold the same columns add their
  // bytes (each sum <= 32, so no byte carries into the next), then one
  // thread per column adds the warps' sums.
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int w = 0; w < kBytes / 4; ++w) {
#pragma unroll
    for (int off = kRowThreads; off < 32; off *= 2)
      word[w] += __shfl_xor_sync(0xffffffffu, word[w], off);
    if (lane < kRowThreads) warp_cnt[warp][lane * (kBytes / 4) + w] = word[w];
  }
  __syncthreads();
  const int c = threadIdx.x, j = j0 + c;
  if (c < kCols && j < P) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w)
      sum += (warp_cnt[w][c / 4] >> (8 * (c % 4))) & 0xffu;
    const size_t cj = static_cast<size_t>(blockIdx.z) * P + j;
    if (gridDim.y == 1)
      cnt[cj] = sum;
    else if (sum != 0)
      atomicAdd(&cnt[cj], sum);
  }
}

template <typename T, int kRows, int kCols>
int launch_tiles(const void* objs, void* dom, void* cnt, int B, int P, int M,
                 cudaStream_t st) {
  const dim3 grid((P + kCols - 1) / kCols, (P + kRows - 1) / kRows, B);
  if (cnt != nullptr && grid.y > 1) {
    const cudaError_t err = cudaMemsetAsync(cnt, 0, sizeof(int) * B * P, st);
    if (err != cudaSuccess) return err;
  }
  domination_kernel<T, kRows, kCols><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(objs), static_cast<unsigned char*>(dom),
      static_cast<int*>(cnt), P, M);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* objs, void* dom, void* cnt, int B, int P, int M, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= kOneGroupRows)
    return launch_tiles<T, kOneGroupRows, 16>(objs, dom, cnt, B, P, M, st);
  return launch_tiles<T, 64, 64>(objs, dom, cnt, B, P, M, st);
}

}  // namespace

extern "C" int domination_f32(const void* objs, void* dom, void* cnt, int B, int P,
                              int M, void* stream) {
  return launch<float>(objs, dom, cnt, B, P, M, stream);
}

extern "C" int domination_bf16(const void* objs, void* dom, void* cnt, int B, int P,
                               int M, void* stream) {
  return launch<__nv_bfloat16>(objs, dom, cnt, B, P, M, stream);
}

REPRO_EXPORT_ERROR_STRING(domination)
