// Fused placement evaluation: decode-gather, Eq. 1 and Eq. 2 in one launch.
//
// Replaces: src/repro/kernels/fused_eval.py::fused_eval_pallas (body
// `_eval_kernel`), the TPU kernel that keeps a coordinate row-block in VMEM
// and walks net and unit tiles on a sequential grid axis.
//
// Layout: cx, cy [P, G] (T = float or bf16), src/dst [N] int32, w [N] T,
// uidx [U, B] int32 -> out [P, 2] fp32 = (sum_n ((|dx|+|dy|) w_n)^2,
// max_u (max-min)x + (max-min)y).  Inputs are upcast to f32 on load.
//
// Bound on the H100: bytes.  Each row is read once (8 G bytes in f32) and
// the tables (12 N + 4 U B bytes) are shared by every row; the arithmetic
// is ~8 flops per net and ~4 per block, far below the fp32 rate.  At the
// main path's shape (P = 64, G = 2240) the call moves ~1.2 MB, a third of
// a microsecond at 3.35 TB/s: the latency of dependent loads decides the
// time, so the design keeps as many loads in flight as it can and puts as
// few round trips to memory as it can one after the other.
//
// Design: one block per row (a cluster of blocks per row measured slower
// than one block at every row count on this card: see PERF.md), launched
// as kernels/fused_eval.py::plan decides from (G, N, U, B) only:
// 1. Thread 0 first starts a Hopper bulk copy (cp.async.bulk, completing
//    on an mbarrier) of each f32 array's 16-byte-aligned body into shared
//    memory; bf16 rows, which must be upcast, are staged by the threads
//    with 16-byte loads instead (common.cuh stage_strips).  Either way a
//    scalar head and tail, and element i of a row lands at sx[i] whatever
//    the row's alignment.
// 2. The tables do not depend on the row, so before the barrier each thread
//    issues its loads of them -- src, dst and w of its first kUnroll nets,
//    its unit lane's first kLaneIds indices -- and they land while the row
//    arrives.
// 3. After the barrier, the thread's first round of nets and its lane's
//    first indices are added in one straight run with no branch, every
//    shared gather in flight together (a bad index is tested with selects,
//    not branches: branches put each net's gathers one after another).
// 4. Nets: thread t takes nets t, t + T, t + 2T, ... (T the block's
//    threads), kUnroll per round; each adds its nets in order with
//    __fmaf_rn.  Which thread adds which net, and in what order, depends
//    on (G, N, U, B) only, not on P or the row.
// 5. Units: the first `unit_threads` threads are lanes, `sub` of them per
//    unit (the largest power of two <= 32 dividing B), lane s reading
//    blocks s, s + sub, ..., min and max from the staged row, then xor
//    shuffles across the unit's lanes.  With the arange unit table the 32
//    lanes of a warp read 32 distinct banks.  Every thread takes both
//    nets and (where it is a lane) units, so the two passes interleave.
// 6. One barrier: each warp's sum, max and bad flag go to shared memory,
//    and warp 0 combines them in a fixed tree.  One 8-byte store per row,
//    no memset, no atomics: one device op per call.
// Loops run over the real N, U and B.  An index outside [0, G) turns the
// row's result into NaN and is never read (gid 0 is read in its place).
// A row's bits do not depend on P, the row's place in the batch or its
// alignment.  PERF.md holds the trials behind each choice: the bulk copy
// against 16-byte loads for f32, interleaved passes against warps split
// between nets and units.
//
// Shared memory (dynamic only, so kernels/fused_eval.py::shared_bytes is
// the whole of it): the mbarrier (16 bytes), 3 x 32 floats of per-warp
// partials, then room_floats(G) floats per array.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kUnroll = 4;                  // nets per round and thread, per table
constexpr int kLaneIds = 7;                 // unit indices a lane holds at once (B = 28: 7 a lane)
constexpr int kStageUnroll = 2;             // 16-byte loads per array and thread in a round
constexpr int kHeaderFloats = 4 + 3 * 32;   // the mbarrier, then wl, bb, bad per warp

struct Nets {
  int s[kUnroll], d[kUnroll];
  float w[kUnroll];
};

// Nets n0, n0 + step, ..., kUnroll of them (those below N).
template <typename T>
__device__ __forceinline__ Nets load_nets(const int* __restrict__ src, const int* __restrict__ dst,
                                          const T* __restrict__ w, int n0, int step, int N) {
  Nets r;
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const int n = n0 + k * step;
    const bool in = n < N;
    r.s[k] = in ? __ldg(src + n) : 0;
    r.d[k] = in ? __ldg(dst + n) : 0;
    r.w[k] = in ? to_f32(__ldg(w + n)) : 0.0f;
  }
  return r;
}

// Lane s's blocks s + (i0 + i) sub, i < kLaneIds, of unit j (those below
// B, of a unit below U).
__device__ __forceinline__ void load_ids(int (&ids)[kLaneIds], const int* __restrict__ uidx,
                                         int j, int U, int B, int s, int sub, int i0) {
#pragma unroll
  for (int i = 0; i < kLaneIds; ++i) {
    const int b = s + (i0 + i) * sub;
    ids[i] = j < U && b < B ? __ldg(uidx + static_cast<size_t>(j) * B + b) : 0;
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 starts the bulk copy of the strips' 16-byte-aligned bodies,
// completing on `bar`, before anything else of the block.
template <int K>
__device__ __forceinline__ void start_bulk(const Strip<float> (&s)[K], uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  uint32_t bytes = 0;
#pragma unroll
  for (int a = 0; a < K; ++a) bytes += 16u * s[a].nvec;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
#pragma unroll
  for (int a = 0; a < K; ++a)
    if (s[a].nvec)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
          "[%3];\n" ::"r"(smem_u32(s[a].dst + s[a].head)),
          "l"(s[a].src + s[a].head), "r"(16u * s[a].nvec), "r"(smem_u32(bar))
          : "memory");
}

// The strips' scalar heads and tails (fewer than 4 values each).
template <int K>
__device__ __forceinline__ void stage_edges(const Strip<float> (&s)[K], int tid) {
#pragma unroll
  for (int a = 0; a < K; ++a) {
    const int tail = s[a].head + 4 * s[a].nvec;
    if (tid < s[a].head) s[a].dst[tid] = __ldg(s[a].src + tid);
    if (tail + tid < s[a].n) s[a].dst[tail + tid] = __ldg(s[a].src + tail + tid);
  }
}

// Waits for the completion of `bar`'s first phase (the bulk copy).
__device__ __forceinline__ void wait_bulk(uint64_t* bar) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar))
        : "memory");
  } while (!done);
}

// Adds round `cur` of nets n0, n0 + step, ... to wl (a net past N adds
// nothing; an index outside [0, G) sets `bad` and gid 0 is read instead).
__device__ __forceinline__ void add_nets(const Nets& cur, int n0, int step, int N, int G,
                                         const float* sx, const float* sy, float& wl, int& bad) {
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {       // no branch: every gather of the round in flight
    const bool ok = static_cast<unsigned>(cur.s[k]) < static_cast<unsigned>(G) &&
                    static_cast<unsigned>(cur.d[k]) < static_cast<unsigned>(G);
    bad |= !ok;                             // (nets past N read gid 0)
    const int a = ok ? cur.s[k] : 0, b = ok ? cur.d[k] : 0;
    const float dl = (fabsf(sx[a] - sx[b]) + fabsf(sy[a] - sy[b])) * cur.w[k];
    wl = n0 + k * step < N ? __fmaf_rn(dl, dl, wl) : wl;
  }
}

// Widens box (x_lo, x_hi, y_lo, y_hi) by the lane's blocks ids[0 ..] of
// chunk i0 (past B: the chunk's first block again; an index outside
// [0, G) sets `bad` and gid 0 is read instead).
__device__ __forceinline__ void add_ids(const int (&ids)[kLaneIds], int i0, int per_lane, int G,
                                        const float* sx, const float* sy, float (&box)[4],
                                        int& bad) {
#pragma unroll
  for (int i = 0; i < kLaneIds; ++i) {
    const int id = i0 + i < per_lane ? ids[i] : ids[0];
    const bool ok = static_cast<unsigned>(id) < static_cast<unsigned>(G);
    bad |= !ok;
    const float x = sx[ok ? id : 0], y = sy[ok ? id : 0];
    box[0] = fminf(box[0], x);
    box[1] = fmaxf(box[1], x);
    box[2] = fminf(box[2], y);
    box[3] = fmaxf(box[3], y);
  }
}

// The unit's width + height from its `sub` lanes' boxes (xor shuffles).
__device__ __forceinline__ float close_box(float (&box)[4], int sub) {
  for (int o = sub / 2; o > 0; o >>= 1) {
    box[0] = fminf(box[0], __shfl_xor_sync(0xffffffffu, box[0], o));
    box[1] = fmaxf(box[1], __shfl_xor_sync(0xffffffffu, box[1], o));
    box[2] = fminf(box[2], __shfl_xor_sync(0xffffffffu, box[2], o));
    box[3] = fmaxf(box[3], __shfl_xor_sync(0xffffffffu, box[3], o));
  }
  return (box[1] - box[0]) + (box[3] - box[2]);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
fused_eval_kernel(const T* __restrict__ cx, const T* __restrict__ cy,
                  const int* __restrict__ src, const int* __restrict__ dst,
                  const T* __restrict__ w, const int* __restrict__ uidx,
                  float* __restrict__ out, int G, int N, int U, int B,
                  int unit_threads, int sub) {
  constexpr bool kBulk = sizeof(T) == 4;    // f32 rows by bulk copy, bf16 by loads
  extern __shared__ __align__(16) float smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* part = smem + 4;                   // [3][32]: wl, bb, bad of each warp
  const int tid = threadIdx.x;
  const size_t row = static_cast<size_t>(blockIdx.x) * G;
  const Strip<T> st[2] = {make_strip(cx + row, G, smem + kHeaderFloats),
                          make_strip(cy + row, G, smem + kHeaderFloats + room_floats(G))};
  if constexpr (kBulk)
    if (tid == 0) start_bulk(st, bar);      // 1. the row's body, first of all

  // 2. the tables' loads: the first round of nets, the lane's first indices
  const int step = blockDim.x;              // every thread takes nets
  int n0 = tid;
  Nets cur = load_nets(src, dst, w, n0, step, N);
  const int per_pass = unit_threads / sub;  // units a pass of the lanes covers
  const int j_lane = tid < unit_threads ? tid / sub : U;   // past U: not a lane
  const int s = tid % sub;
  const int per_lane = B / sub;             // blocks of a unit per lane
  int ids[kLaneIds];
  load_ids(ids, uidx, j_lane, U, B, s, sub, 0);

  // 1. the rest of the row, staged as f32 (the barrier also publishes the
  // mbarrier's initialisation)
  if constexpr (kBulk)
    stage_edges(st, tid);
  else
    stage_strips<kStageUnroll>(st, tid, blockDim.x);
  __syncthreads();
  if constexpr (kBulk) wait_bulk(bar);
  const float* sx = st[0].dst;
  const float* sy = st[1].dst;

  // 3-5. the first round of nets and the first indices of the lane's unit
  // in one run, every gather in flight together; then the rest of each
  int bad = 0;
  float wl = 0.0f;
  float box[4] = {INFINITY, -INFINITY, INFINITY, -INFINITY};
  add_nets(cur, n0, step, N, G, sx, sy, wl, bad);
  add_ids(ids, 0, per_lane, G, sx, sy, box, bad);
  for (n0 += kUnroll * step; n0 < N; n0 += kUnroll * step) {
    cur = load_nets(src, dst, w, n0, step, N);
    add_nets(cur, n0, step, N, G, sx, sy, wl, bad);
  }
  float bb = -INFINITY;
  for (int j = j_lane, j0 = 0; j0 < U; j0 += per_pass, j += per_pass) {
    for (int i0 = j0 > 0 ? 0 : kLaneIds; i0 < per_lane; i0 += kLaneIds) {
      load_ids(ids, uidx, j, U, B, s, sub, i0);
      add_ids(ids, i0, per_lane, G, sx, sy, box, bad);
    }
    const float wh = close_box(box, sub);   // whole warps: unit_threads % 32 == 0
    if (j < U) bb = fmaxf(bb, wh);
    box[0] = box[2] = INFINITY;
    box[1] = box[3] = -INFINITY;
  }

  // 6. one barrier, then warp 0 combines the warps in a fixed tree
  const int warp = tid >> 5, lane_id = tid & 31;
  wl = warp_sum(wl);
  bb = warp_max(bb);
  bad = __any_sync(0xffffffffu, bad);
  if (lane_id == 0) {
    part[warp] = wl;
    part[32 + warp] = bb;
    part[64 + warp] = bad ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (warp == 0) {
    const bool in = lane_id < static_cast<int>(blockDim.x >> 5);
    wl = warp_sum(in ? part[lane_id] : 0.0f);
    bb = warp_max(in ? part[32 + lane_id] : -INFINITY);
    bad = __any_sync(0xffffffffu, in && part[64 + lane_id] != 0.0f);
    if (lane_id == 0)
      reinterpret_cast<float2*>(out)[blockIdx.x] = bad ? make_float2(NAN, NAN) : make_float2(wl, bb);
  }
}

template <typename T>
int launch(const void* cx, const void* cy, const void* src, const void* dst, const void* w,
           const void* uidx, void* out, int P, int G, int N, int U, int B, int threads,
           int unit_threads, int sub, void* stream) {
  // the plan's invariants (kernels/fused_eval.py::plan holds the same)
  if (P < 1 || G < 0 || N < 0 || U < 1 || B < 1 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 || unit_threads < 32 || unit_threads > threads ||
      unit_threads % 32 != 0 || sub < 1 || sub > 32 || (sub & (sub - 1)) != 0 || B % sub != 0)
    return cudaErrorInvalidValue;
  const size_t smem = (kHeaderFloats + 2 * static_cast<size_t>(room_floats(G))) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_eval_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  fused_eval_kernel<T><<<P, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(cx), static_cast<const T*>(cy), static_cast<const int*>(src),
      static_cast<const int*>(dst), static_cast<const T*>(w), static_cast<const int*>(uidx),
      static_cast<float*>(out), G, N, U, B, unit_threads, sub);
  return cudaGetLastError();
}

}  // namespace

#define REPRO_FUSED_EVAL_ENTRY(tag, T)                                                        \
  extern "C" int fused_eval_##tag(const void* cx, const void* cy, const void* src,            \
                                  const void* dst, const void* w, const void* uidx, void* out, \
                                  int P, int G, int N, int U, int B, int threads,             \
                                  int unit_threads, int sub, void* stream) {                  \
    return launch<T>(cx, cy, src, dst, w, uidx, out, P, G, N, U, B, threads, unit_threads,   \
                     sub, stream);                                                            \
  }

REPRO_FUSED_EVAL_ENTRY(f32, float)
REPRO_FUSED_EVAL_ENTRY(bf16, __nv_bfloat16)

REPRO_EXPORT_ERROR_STRING(fused_eval)
