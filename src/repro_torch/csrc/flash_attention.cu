// Causal flash attention (FA-2 online softmax), GQA-aware, on Hopper's
// tensor cores.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body `_fwd_kernel`).
//
// Contract (every route): q [B, H, S, D], k and v [B, Hkv, T, D] (one
// dtype, contiguous) -> out [B, H, S, D] in q's dtype.  Query row i sits at
// position q_pos = i + (T - S): bottom-right causal alignment, so S < T is
// a chunk of queries at the end of a longer key sequence.  Key t is
// visible to query i iff t < T, (not causal or t <= q_pos) and (no window
// or t > q_pos - window).  Query head h reads kv head h / (H / Hkv); K and
// V are never repeated in memory.  The scale 1/sqrt(D) is applied in fp32
// where each route can do so without rounding: the wgmma and tf32x3 routes
// scale the fp32 logits after Q K^T (folded with log2 e into the softmax's
// exp2), as the plain version does, because Q reaches them through TMA
// and scaling it first would cost a pass over the tile and, in bf16, a
// rounding of q / sqrt(D) to bf16 that the TPU kernel's fp32 q does not
// have.  The fma route scales the q tile in shared memory before the dot,
// as the TPU kernel does.  The running max starts at the TPU
// kernel's finite -1e30, but masked keys weigh exactly 0, so a row with no
// visible key outputs 0.  kv tiles wholly above the causal diagonal or
// before the window are never loaded, and q tiles are issued longest-first
// (the last q tile has the most kv tiles) to even out the causal triangle.
//
// Bound on the H100: operations.  At the serving path's prefill shape
// (H = 32, Hkv = 4, S = T = 2048, D = 128, causal) the two products are
// 4 H D S (S + 1) / 2 = 34.4 GFLOP against ~38 MB (bf16) or ~75 MB (fp32)
// of traffic: 34.8 us at 989 TFLOP/s in bf16; in fp32, 513 us at the
// 67 TFLOP/s of the CUDA cores, or 208.5 us for the three TF32 products
// of the fp32-accurate route below at 495 TFLOP/s.
//
// Routes (chosen by the wrapper from dtype and D, `route()` in
// kernels/flash_attention.py; each is its own entry point):
//
// * wgmma (bf16, D in {64, 128, 256}): one consumer warpgroup owns a
//   64-row q tile; a fifth warp is the producer.  Q and a ring of two K/V
//   stages arrive through TMA (128-byte swizzle, 64-column boxes, zero
//   fill past S and T), each stage signalled by its own mbarriers for K
//   and for V so S = Q K^T starts before V lands.  S = Q K^T is
//   `wgmma.m64n64k16` with Q and K from shared memory (both K-major, as
//   they lie in memory); after the online softmax P is rounded to bf16 and
//   fed from registers (the S accumulator layout is the A fragment layout)
//   into O += P V, `wgmma.m64n64k16` per 64 output columns with V read
//   MN-major through the descriptor's transpose bit.  m, l and O stay in
//   fp32 registers.  The matrix descriptors are built once per block and
//   moved by constant offsets (rebuilding them from pointers for every
//   wgmma cost a third of the kernel's time).  Two blocks share an SM
//   (80 KB of shared memory, 128 registers at D = 128), so one block's
//   softmax overlaps the other's products; issuing the next tile's
//   Q K^T before the softmax (as FA-3 does) measured slower here, with
//   one warpgroup per block and with two under `setmaxnreg`.
// * tf32x3 (fp32, D in {64, 128}): the same producer and ring (32-column
//   boxes), eight consumer warps on a 128-row q tile, each owning 16 rows; the
//   producer is a whole warpgroup that hands its registers to the two consumer
//   warpgroups (`setmaxnreg` 40 / 232), or twelve warps would cap every thread
//   at 168 registers and spill.  Both products are `mma.sync.m16n8k8` TF32 in
//   three parts: every operand x splits into hi = tf32(x) (round to nearest)
//   and lo = x - hi (truncated to TF32 by the tensor core), and hi*hi + hi*lo
//   + lo*hi accumulate in fp32 (CUTLASS's OpMultiplyAddFastF32). The tensor
//   core drops low bits when it adds into a large accumulator, so the small
//   products of S sum apart from hi*hi, and each kv tile's P V sums in fresh
//   registers that are added to O in fp32: an O accumulator carried over every
//   tile put 13 of yi-6b's 64,000 last-token logits outside 1e-4 of the plain
//   version's; this order keeps them as close as the CUDA-core fp32 kernel
//   does.  wgmma's TF32 form needs B K-major, i.e. V staged transposed;
//   mma.sync reads fragments from shared memory instead, and permuting the key
//   order inside each k-step of 8 lets P's accumulator registers serve as the
//   A fragment with no shuffle.  Fragment reads of the swizzled tiles are free
//   of bank conflicts.  192 KB of shared memory at D = 128.
// * fma (fp32, D = 256): plain FMA on the CUDA cores, because at D = 256 the
//   fp32 tiles of the tf32x3 route no longer fit beside a two-stage ring.  One
//   block of 256 threads per 64-row q tile, the q tile pre-scaled in shared
//   memory, each kv tile staged first as K and then as V, a 4-row micro-tile
//   of S and O per thread, plain FMA.
#include <cuda.h>   // CUtensorMap and its enums (types only: no -lcuda)
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1e30f;     // the TPU kernel's mask value
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- TMA

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a CUDA driver API function; the runtime hands out its
// address, so the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [BH, rows, D] tensor seen as boxes of (128 bytes of D) x box_rows x 1,
// written to shared memory with the 128-byte swizzle; boxes reaching past
// `rows` are zero filled.
template <typename T>
cudaError_t make_map(CUtensorMap* map, const void* base, int BH, int rows, int D,
                     int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {sizeof(T) * D, sizeof(T) * D * static_cast<cuuint64_t>(rows)};
  const cuuint32_t box[3] = {128 / sizeof(T), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(base), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ------------------------------------------------- tiles and the producer

// Shared memory of one block: the q tile, then kStages K tiles and
// kStages V tiles, each as D / kAtomCols swizzle atoms of rows x 128 bytes
// (a box of TMA); the barriers are static shared memory (`Bars`).
template <typename T, int D_, int BQ_, int BK_, int kConsumerWarps_, int kProducerWarps_>
struct Cfg {
  static constexpr int D = D_, BQ = BQ_, BK = BK_;
  static constexpr int kStages = 2;
  static constexpr int kConsumerWarps = kConsumerWarps_;
  static constexpr int kConsumers = 32 * kConsumerWarps;
  static constexpr int kThreads = kConsumers + 32 * kProducerWarps_;  // one lane produces
  static constexpr int kAtomCols = 128 / sizeof(T);
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr uint32_t kQBytes = sizeof(T) * BQ * D;
  static constexpr uint32_t kKVBytes = sizeof(T) * BK * D;
  static constexpr size_t kSmemBytes =
      kQBytes + 2 * kStages * kKVBytes + 1024 /* alignment */;
};

struct Bars {
  uint64_t q, full_k[2], full_v[2], empty[2];
};

// Positions shared by the producer and the consumers of one block.
struct Work {
  int i0, rows, shift, bh_q, bh_kv, j_lo, j_end;
};

template <class C>
__device__ __forceinline__ Work block_work(int H, int Hkv, int S, int Tk, int causal,
                                           int window) {
  Work w;
  w.i0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;        // longest rows first
  w.rows = min(C::BQ, S - w.i0);
  w.shift = Tk - S;                                    // q_pos = i + shift
  w.bh_q = blockIdx.z * H + blockIdx.y;
  w.bh_kv = blockIdx.z * Hkv + blockIdx.y / (H / Hkv);
  // the kv tiles holding a key visible to some row of this q tile
  const int q_lo = w.i0 + w.shift;
  const int q_hi = w.i0 + w.rows - 1 + w.shift;
  const int t_hi = causal ? min(Tk - 1, q_hi) : Tk - 1;
  const int t_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  w.j_lo = t_lo / C::BK;
  w.j_end = t_hi < t_lo ? w.j_lo : t_hi / C::BK + 1;
  return w;
}

template <class C, typename T>
__device__ __forceinline__ T* atom(T* tile, int rows, int a) {
  return tile + a * rows * C::kAtomCols;
}

// One lane: the q tile, then every kv tile of the block through the ring.
template <class C, typename T>
__device__ void produce(const CUtensorMap* qmap, const CUtensorMap* kmap,
                        const CUtensorMap* vmap, T* Qs, T* Ks, T* Vs, Bars& bars,
                        const Work& w) {
  mbar_expect_tx(&bars.q, C::kQBytes);
  for (int a = 0; a < C::kAtoms; ++a)
    tma_load(atom<C>(Qs, C::BQ, a), qmap, &bars.q, a * C::kAtomCols, w.i0, w.bh_q);
  for (int j = w.j_lo, it = 0; j < w.j_end; ++j, ++it) {
    const int s = it % C::kStages;
    if (it >= C::kStages) mbar_wait(&bars.empty[s], ((it / C::kStages) & 1) ^ 1);
    T* K = Ks + s * C::BK * C::D;
    T* V = Vs + s * C::BK * C::D;
    mbar_expect_tx(&bars.full_k[s], C::kKVBytes);
    for (int a = 0; a < C::kAtoms; ++a)
      tma_load(atom<C>(K, C::BK, a), kmap, &bars.full_k[s], a * C::kAtomCols, j * C::BK,
               w.bh_kv);
    mbar_expect_tx(&bars.full_v[s], C::kKVBytes);
    for (int a = 0; a < C::kAtoms; ++a)
      tma_load(atom<C>(V, C::BK, a), vmap, &bars.full_v[s], a * C::kAtomCols, j * C::BK,
               w.bh_kv);
  }
}

// Carve the block's shared memory (1024-byte aligned for the swizzle) and
// set up the barriers; every thread of the block calls this once.
template <class C, typename T>
__device__ __forceinline__ void carve(unsigned char* raw, Bars& bars, T*& Qs, T*& Ks, T*& Vs) {
  const uint32_t pad = (1024 - (smem_u32(raw) & 1023)) & 1023;
  Qs = reinterpret_cast<T*>(raw + pad);
  Ks = Qs + C::BQ * C::D;
  Vs = Ks + C::kStages * C::BK * C::D;
  if (threadIdx.x == 0) {
    mbar_init(&bars.q, 1);
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&bars.full_k[s], 1);
      mbar_init(&bars.full_v[s], 1);
      mbar_init(&bars.empty[s], C::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ------------------------------------------------ softmax and epilogue
//
// Both tensor-core routes hold a 16-row slice of S and O per warp in the
// accumulator layout of mma m16n8 (and of wgmma m64nN per warp): element
// 4n + e of a thread is row g + 8 (e / 2), column 8n + 2t + (e % 2), with
// g = lane / 4 and t = lane % 4.  So the four threads of a quad share a
// row pair and reduce over it with two shuffles.

// 2^x (MUFU.EX2; rel. error ~2^-22, results below 2^-126 flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Mask the tile's logits (raw dots) in place, then the online softmax
// update: s becomes p, m and l (this thread's partial row sums) advance,
// and O is rescaled.  `r0` is the first of the thread's two query rows.
template <int BK, int D>
__device__ __forceinline__ void softmax_step(float (&s)[BK / 2], float (&o)[D / 2],
                                             float (&m)[2], float (&l)[2], int r0, int t0,
                                             const Work& w, int Tk, int causal, int window,
                                             float scale_log2) {
  const int t = threadIdx.x & 3;
  const int q_lo = w.i0 + w.shift;
  const bool need_mask = t0 + BK > Tk || (causal && t0 + BK - 1 > q_lo) ||
                         (window > 0 && t0 <= w.i0 + w.rows - 1 + w.shift - window);
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int key = t0 + 8 * (i >> 2) + 2 * t + (i & 1);
      const int q_pos = q_lo + r0 + 8 * ((i & 3) >> 1);
      const bool ok = key < Tk && (!causal || key <= q_pos) &&
                      (window <= 0 || key > q_pos - window);
      if (!ok) s[i] = kNegInf;
    }
  }
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) mx[(i & 3) >> 1] = fmaxf(mx[(i & 3) >> 1], s[i]);
  float alpha[2], neg_m[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_new = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = exp2_approx((m[h] - m_new) * scale_log2);
    neg_m[h] = -m_new * scale_log2;
    m[h] = m_new;
  }
  if (need_mask) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int half = (i & 3) >> 1;
      s[i] = s[i] == kNegInf ? 0.f : exp2_approx(fmaf(s[i], scale_log2, neg_m[half]));
      rs[half] += s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int half = (i & 3) >> 1;
      s[i] = exp2_approx(fmaf(s[i], scale_log2, neg_m[half]));
      rs[half] += s[i];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + rs[h];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i & 3) >> 1];
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int D, typename T>
__device__ __forceinline__ void write_out(T* out, const float (&o)[D / 2], float (&l)[2],
                                          int r0, const Work& w, int S) {
  const int t = threadIdx.x & 3;
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float den = quad_sum(l[h]);
    inv[h] = den > 0.f ? 1.f / den : 0.f;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    if (r >= w.rows) continue;
    T* orow = out + (static_cast<size_t>(w.bh_q) * S + w.i0 + r) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      store2(orow + 8 * n + 2 * t, o[4 * n + 2 * h] * inv[h], o[4 * n + 2 * h + 1] * inv[h]);
  }
}

// ------------------------------------------------------- route: wgmma

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major: the leading
// offset is unused (16 bytes), 8-row groups 1024 bytes apart.  MN-major
// (transposed B): 64-column atoms `lead` bytes apart, 8-row groups along
// the reduction 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lead) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead & 0x3FFFF) >> 4) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define WGMMA_D32                                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WGMMA_OUT32(d)                                                                      \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),      \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),           \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),        \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),        \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])

// d[64 x 64] = A[64 x 16] B[16 x 64] (+ d if `accumulate`), A and B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b, int accumulate) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
               ", %32, %33, p, 1, 1, 0, 0;\n}\n"
               : WGMMA_OUT32(d)
               : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers, B MN-major in
// shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs_t(float* d, const uint32_t (&a)[4], uint64_t b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WGMMA_D32
               ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
               : WGMMA_OUT32(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
using WgmmaCfg = Cfg<__nv_bfloat16, D, 64, 64, 4, 1>;

template <int D>
__global__ void __launch_bounds__(WgmmaCfg<D>::kThreads, D > 128 ? 1 : 2)
flash_attention_kernel_wgmma(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ out, int H, int Hkv, int S, int Tk,
                             int causal, int window, float scale_log2) {
  using C = WgmmaCfg<D>;
  using T = __nv_bfloat16;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Bars bars;
  T *Qs, *Ks, *Vs;
  carve<C>(smem_raw, bars, Qs, Ks, Vs);
  const Work w = block_work<C>(H, Hkv, S, Tk, causal, window);
  const int warp = threadIdx.x / 32;

  if (warp == C::kConsumerWarps) {
    if ((threadIdx.x & 31) == 0) produce<C>(&qmap, &kmap, &vmap, Qs, Ks, Vs, bars, w);
    return;
  }

  const int r0 = 16 * warp + (threadIdx.x & 31) / 4;
  float o[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // Descriptors of the tiles' starts; a k-step or stage moves one by its
  // byte offset / 16 (the address field is the low 14 bits).
  const uint64_t q_desc = sw128_desc(Qs, 16);
  const uint64_t k_desc0 = sw128_desc(Ks, 16);
  const uint64_t v_desc0 = sw128_desc(Vs, C::BK * 128);
  mbar_wait(&bars.q, 0);

  for (int j = w.j_lo, it = 0; j < w.j_end; ++j, ++it) {
    const int st = it % C::kStages;
    const int ph = (it / C::kStages) & 1;
    const uint64_t k_desc = k_desc0 + ((st * C::kKVBytes) >> 4);
    const uint64_t v_desc = v_desc0 + ((st * C::kKVBytes) >> 4);

    float s[C::BK / 2];
    mbar_wait(&bars.full_k[st], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      // atom kk / 4 (64 columns), 32 bytes per k-step inside it
      const uint32_t off = (kk % 4) * 32;
      wgmma_ss(s, q_desc + (((kk / 4) * C::BQ * 128 + off) >> 4),
               k_desc + (((kk / 4) * C::BK * 128 + off) >> 4), kk > 0);
    }
    wgmma_commit_wait();

    softmax_step<C::BK, D>(s, o, m, l, r0, j * C::BK, w, Tk, causal, window, scale_log2);

    // P (bf16) from registers: the S accumulator of key columns
    // 16kk..16kk+15 is the A fragment of the kk-th k-step.
    uint32_t pa[C::BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < C::BK / 16; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

    mbar_wait(&bars.full_v[st], ph);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < D / 64; ++c)      // atom c, 16 rows of 128 bytes per k-step
#pragma unroll
      for (int kk = 0; kk < C::BK / 16; ++kk)
        wgmma_rs_t(o + 32 * c, pa[kk], v_desc + ((c * C::BK * 128 + kk * 16 * 128) >> 4));
    wgmma_commit_wait();
    mbar_arrive(&bars.empty[st]);
  }
  write_out<D>(out, o, l, r0, w, S);
}

// ------------------------------------------------------ route: tf32x3

// x = hi + lo as TF32 values.  hi rounds to nearest with ties away from
// zero (what cvt.rna.tf32.f32 gives, but in an integer add and mask, which
// run at four times the rate of a conversion).  lo = x - hi is exact in
// fp32 and is handed over as it is: the tensor core reads only the top 19
// bits of a TF32 operand, so lo is truncated to TF32 there.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float* d, const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b in three TF32 products: the two small ones into `small`, hi*hi into
// `big` (the same registers, or apart to keep the small sums' bits).
__device__ __forceinline__ void mma_3xtf32(float* big, float* small, const uint32_t (&ahi)[4],
                                           const uint32_t (&alo)[4], float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(small, alo, bh0, bh1);
  mma_tf32(small, ahi, bl0, bl1);
  mma_tf32(big, ahi, bh0, bh1);
}

// Element (r, c) of an fp32 tile of `rows` rows stored by TMA as 32-column
// atoms with the 128-byte swizzle (16-byte chunk index XOR r % 8).
__device__ __forceinline__ float lds_sw(const float* tile, int rows, int r, int c) {
  return tile[(c >> 5) * rows * 32 + r * 32 + ((((c & 31) >> 2) ^ (r & 7)) << 2) + (c & 3)];
}

template <int D>
using Tf32Cfg = Cfg<float, D, 128, 64, 8, 4>;

template <int D>
__global__ void __launch_bounds__(Tf32Cfg<D>::kThreads, 1)
flash_attention_kernel_tf32x3(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap,
                              float* __restrict__ out, int H, int Hkv, int S, int Tk,
                              int causal, int window, float scale_log2) {
  using C = Tf32Cfg<D>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ Bars bars;
  float *Qs, *Ks, *Vs;
  carve<C>(smem_raw, bars, Qs, Ks, Vs);
  const Work w = block_work<C>(H, Hkv, S, Tk, causal, window);
  const int warp = threadIdx.x / 32;

  // Registers move from the producer warpgroup to the two consumer ones
  // (12 warps would otherwise cap every thread at 168).
  if (warp >= C::kConsumerWarps) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == C::kConsumers) produce<C>(&qmap, &kmap, &vmap, Qs, Ks, Vs, bars, w);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  const int g = (threadIdx.x & 31) / 4, t = threadIdx.x & 3;
  const int r0 = 16 * warp + g;
  float o[D / 2], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mbar_wait(&bars.q, 0);

  for (int j = w.j_lo, it = 0; j < w.j_end; ++j, ++it) {
    const int st = it % C::kStages;
    const int ph = (it / C::kStages) & 1;
    const float* K = Ks + st * C::BK * D;
    const float* V = Vs + st * C::BK * D;

    // S = Q K^T: hi*hi in s, the small products apart in s_lo
    float s[C::BK / 2], s_lo[C::BK / 2];
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) s[i] = s_lo[i] = 0.f;
    mbar_wait(&bars.full_k[st], ph);
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)     // (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        split_tf32(lds_sw(Qs, C::BQ, r0 + 8 * (x & 1), 8 * kk + t + 4 * (x >> 1)), ahi[x],
                   alo[x]);
#pragma unroll
      for (int n = 0; n < C::BK / 8; ++n)
        mma_3xtf32(s + 4 * n, s_lo + 4 * n, ahi, alo, lds_sw(K, C::BK, 8 * n + g, 8 * kk + t),
                   lds_sw(K, C::BK, 8 * n + g, 8 * kk + t + 4));
    }
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) s[i] += s_lo[i];

    softmax_step<C::BK, D>(s, o, m, l, r0, j * C::BK, w, Tk, causal, window, scale_log2);

    // O += P V: the tile's sum in fresh registers, added to O in fp32 (a
    // tensor-core accumulator carried over every kv tile loses low bits)
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
    mbar_wait(&bars.full_v[st], ph);
#pragma unroll
    for (int kk = 0; kk < C::BK / 8; ++kk) {
      // k index t <-> key 8kk + 2t, t + 4 <-> key 8kk + 2t + 1: then the
      // A fragment (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4) is
      // accumulator elements 0, 2, 1, 3 of P's n-tile kk.
      uint32_t ahi[4], alo[4];
      split_tf32(s[4 * kk + 0], ahi[0], alo[0]);
      split_tf32(s[4 * kk + 2], ahi[1], alo[1]);
      split_tf32(s[4 * kk + 1], ahi[2], alo[2]);
      split_tf32(s[4 * kk + 3], ahi[3], alo[3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        mma_3xtf32(pv + 4 * n, pv + 4 * n, ahi, alo,
                   lds_sw(V, C::BK, 8 * kk + 2 * t, 8 * n + g),
                   lds_sw(V, C::BK, 8 * kk + 2 * t + 1, 8 * n + g));
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
    mbar_arrive(&bars.empty[st]);
  }
  write_out<D>(out, o, l, r0, w, S);
}

// ---------------------------------------------------------- route: fma

constexpr int kFmaThreads = 256;      // 16 x 16 thread grid
constexpr int kFmaBQ = 64;            // query rows per block

template <int D>
struct FmaTile {
  static constexpr int BK = 32;                  // key rows per kv tile
  static constexpr int LD = D + 4;               // shared row stride of Q, K, V
  static constexpr int LDP = BK + 4;             // shared row stride of P
  static constexpr int TM = kFmaBQ / 16;         // query rows per thread
  static constexpr int TN = BK / 16;             // S columns per thread
  static constexpr int TG = D / 64;              // float4 O groups per thread
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kFmaBQ * LD + BK * LD + kFmaBQ * LDP);
};

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows x D elements of `src` (row stride D) -> `dst` (row stride D + 4),
// times `scale`; rows at or past `valid` are zero.
template <int D>
__device__ __forceinline__ void stage(float* dst, const float* src, int rows, int valid,
                                      float scale) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < rows * kVec; idx += kFmaThreads) {
    const int r = idx / kVec;
    const int c = (idx % kVec) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < valid) {
      v = load4(src + static_cast<size_t>(r) * D + c);
      v.x *= scale;
      v.y *= scale;
      v.z *= scale;
      v.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * (D + 4) + c) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(kFmaThreads, 1)
flash_attention_kernel_fma(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int H,
                           int Hkv, int S, int Tk, int causal, int window, float scale) {
  using C = FmaTile<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + kFmaBQ * C::LD;
  float* Ps = KVs + C::BK * C::LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kFmaBQ;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int shift = Tk - S;                               // q_pos = i + shift
  const size_t q_off = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * Tk * D;
  const int rows = min(kFmaBQ, S - i0);

  stage<D>(Qs, q + q_off + static_cast<size_t>(i0) * D, kFmaBQ, rows, scale);

  const int q_lo = i0 + shift;
  const int q_hi = i0 + rows - 1 + shift;
  const int t_hi = causal ? min(Tk - 1, q_hi) : Tk - 1;
  const int t_lo = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int j_lo = t_lo / C::BK;
  const int j_end = t_hi < t_lo ? j_lo : t_hi / C::BK + 1;

  float acc[C::TM][4 * C::TG];
  float m[C::TM], l[C::TM];
#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * C::TG; ++c) acc[i][c] = 0.f;
  }

  for (int j = j_lo; j < j_end; ++j) {
    const int t0 = j * C::BK;
    const int t_valid = min(C::BK, Tk - t0);
    __syncthreads();                       // Q staged; last P V read done
    stage<D>(KVs, k + kv_off + static_cast<size_t>(t0) * D, C::BK, t_valid, 1.f);
    __syncthreads();

    float s[C::TM][C::TN];
#pragma unroll
    for (int i = 0; i < C::TM; ++i)
#pragma unroll
      for (int n = 0; n < C::TN; ++n) s[i][n] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[C::TM], ka[C::TN];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) qa[i] = load4(Qs + (ty * C::TM + i) * C::LD + d);
#pragma unroll
      for (int n = 0; n < C::TN; ++n) ka[n] = load4(KVs + (tx + 16 * n) * C::LD + d);
#pragma unroll
      for (int i = 0; i < C::TM; ++i)
#pragma unroll
        for (int n = 0; n < C::TN; ++n) {
          float a = s[i][n];
          a = fmaf(qa[i].x, ka[n].x, a);
          a = fmaf(qa[i].y, ka[n].y, a);
          a = fmaf(qa[i].z, ka[n].z, a);
          a = fmaf(qa[i].w, ka[n].w, a);
          s[i][n] = a;
        }
    }

    // mask, then the online softmax update of each of this thread's rows
#pragma unroll
    for (int i = 0; i < C::TM; ++i) {
      const int r = ty * C::TM + i;
      const int q_pos = i0 + r + shift;
      bool ok[C::TN];
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < C::TN; ++n) {
        const int t = t0 + tx + 16 * n;
        ok[n] = t < Tk && (!causal || t <= q_pos) && (window <= 0 || t > q_pos - window);
        if (!ok[n]) s[i][n] = kNegInf;
        mx = fmaxf(mx, s[i][n]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < C::TN; ++n) {
        const float p = ok[n] ? expf(s[i][n] - m_new) : 0.f;
        Ps[r * C::LDP + tx + 16 * n] = p;
        rs += p;
      }
      rs = half_warp_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * C::TG; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                       // K reads done, P complete
    stage<D>(KVs, v + kv_off + static_cast<size_t>(t0) * D, C::BK, t_valid, 1.f);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < C::BK; c += 4) {
      float4 pa[C::TM];
#pragma unroll
      for (int i = 0; i < C::TM; ++i) pa[i] = load4(Ps + (ty * C::TM + i) * C::LDP + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
        for (int g = 0; g < C::TG; ++g) {
          const float4 vv = load4(KVs + (c + cc) * C::LD + tx * 4 + 64 * g);
#pragma unroll
          for (int i = 0; i < C::TM; ++i) {
            const float p = comp(pa[i], cc);
            acc[i][4 * g + 0] = fmaf(p, vv.x, acc[i][4 * g + 0]);
            acc[i][4 * g + 1] = fmaf(p, vv.y, acc[i][4 * g + 1]);
            acc[i][4 * g + 2] = fmaf(p, vv.z, acc[i][4 * g + 2]);
            acc[i][4 * g + 3] = fmaf(p, vv.w, acc[i][4 * g + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < C::TM; ++i) {
    const int r = ty * C::TM + i;
    if (r >= rows) continue;
    const float den = l[i] > 0.f ? l[i] : 1.f;
    float* orow = out + q_off + static_cast<size_t>(i0 + r) * D;
#pragma unroll
    for (int g = 0; g < C::TG; ++g) {
      *reinterpret_cast<float4*>(orow + tx * 4 + 64 * g) =
          make_float4(acc[i][4 * g + 0] / den, acc[i][4 * g + 1] / den,
                      acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den);
    }
  }
}

// ------------------------------------------------------------ launchers

struct Args {
  const void *q, *k, *v;
  void* out;
  int B, H, Hkv, S, Tk, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename Kern>
cudaError_t set_smem(Kern kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The two TMA routes: three tensor maps, then one block per (q tile, head,
// batch) of C::kThreads threads.
template <class C, typename T, typename Kern>
int launch_tma(Kern kernel, const Args& a) {
  CUtensorMap qmap, kmap, vmap;
  cudaError_t err = make_map<T>(&qmap, a.q, a.B * a.H, a.S, C::D, C::BQ);
  if (err == cudaSuccess) err = make_map<T>(&kmap, a.k, a.B * a.Hkv, a.Tk, C::D, C::BK);
  if (err == cudaSuccess) err = make_map<T>(&vmap, a.v, a.B * a.Hkv, a.Tk, C::D, C::BK);
  if (err == cudaSuccess) err = set_smem(kernel, C::kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + C::BQ - 1) / C::BQ, a.H, a.B);
  kernel<<<grid, C::kThreads, C::kSmemBytes, a.stream>>>(
      qmap, kmap, vmap, static_cast<T*>(a.out), a.H, a.Hkv, a.S, a.Tk, a.causal, a.window,
      a.scale * kLog2e);
  return cudaGetLastError();
}

int launch_wgmma(const Args& a, int D) {
  switch (D) {
    case 64:
      return launch_tma<WgmmaCfg<64>, __nv_bfloat16>(flash_attention_kernel_wgmma<64>, a);
    case 128:
      return launch_tma<WgmmaCfg<128>, __nv_bfloat16>(flash_attention_kernel_wgmma<128>, a);
    case 256:
      return launch_tma<WgmmaCfg<256>, __nv_bfloat16>(flash_attention_kernel_wgmma<256>, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch_tf32x3(const Args& a, int D) {
  switch (D) {
    case 64:
      return launch_tma<Tf32Cfg<64>, float>(flash_attention_kernel_tf32x3<64>, a);
    case 128:
      return launch_tma<Tf32Cfg<128>, float>(flash_attention_kernel_tf32x3<128>, a);
    default:
      return cudaErrorInvalidValue;
  }
}

int launch_fma(const Args& a, int D) {
  if (D != 256) return cudaErrorInvalidValue;
  constexpr size_t smem = FmaTile<256>::kSmemBytes;
  const cudaError_t err = set_smem(flash_attention_kernel_fma<256>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kFmaBQ - 1) / kFmaBQ, a.H, a.B);
  flash_attention_kernel_fma<256><<<grid, kFmaThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.H, a.Hkv, a.S, a.Tk,
      a.causal, a.window, a.scale);
  return cudaGetLastError();
}

}  // namespace

// One entry point per route, all with the same arguments; window <= 0
// means no window.
#define REPRO_FLASH_ENTRY(route)                                                          \
  extern "C" int flash_attention_##route(const void* q, const void* k, const void* v,    \
                                         void* out, int B, int H, int Hkv, int S, int T, \
                                         int D, int causal, int window, float scale,     \
                                         void* stream) {                                 \
    const Args a{q, k, v, out, B, H, Hkv, S, T, causal, window, scale,                   \
                 static_cast<cudaStream_t>(stream)};                                     \
    return launch_##route(a, D);                                                         \
  }

REPRO_FLASH_ENTRY(wgmma)
REPRO_FLASH_ENTRY(tf32x3)
REPRO_FLASH_ENTRY(fma)

REPRO_EXPORT_ERROR_STRING(flash_attention)
