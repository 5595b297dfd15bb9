// Causal flash attention (FA-2 online softmax), GQA-aware, fp32 math.
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_pallas
// (body `_fwd_kernel`).
//
// Layout: q [B, H, S, D], k and v [B, Hkv, T, D] (float or bf16, one dtype,
// contiguous) -> out [B, H, S, D] in q's dtype.  Query row i sits at
// position q_pos = i + (T - S): bottom-right causal alignment, so S < T is
// a chunk of queries at the end of a longer key sequence.  Key t is
// visible to query i iff t < T, (not causal or t <= q_pos) and (no window
// or t > q_pos - window).  Query head h reads kv head h / (H / Hkv); K and
// V are never repeated in memory.  q is scaled by 1/sqrt(D) in fp32 before
// the dot, as in the TPU kernel; bf16 inputs are upcast on load.  A row
// with no visible key outputs 0: masked keys add exactly 0 to the row sum.
//
// Bound on the H100: operations.  At the serving path's prefill shape
// (H = 32, Hkv = 4, S = T = 2048, D = 128) causal attention is ~34 GFLOP
// against ~75 MB of fp32 traffic, ~450 flops per byte, far above the
// card's fp32 balance point (~20 flops per byte on CUDA cores).
//
// Design: one block of 256 threads per (q tile of 64 rows, head, batch);
// the TPU's sequential kv grid axis becomes a loop inside the block, and
// the running max m, sum l and output tile stay in registers.  The q tile
// (pre-scaled) is staged once in shared memory; each kv tile is staged in
// one shared buffer, first as K for S = Q K^T, then as V for O += P V, with
// P in shared memory between the two products.  The 16 x 16 thread grid
// gives each thread 4 query rows: a 4 x (BK/16) micro-tile of S (key
// columns strided by 16) and a 4 x (D/16) micro-tile of O (float4 groups
// strided by 64 columns), so the 16 threads that share a row are one half
// warp and reduce the row max and sum with shuffles.  Shared rows are
// padded by 4 floats so the float4 reads of 16 different K rows fall into
// distinct banks.  Tiles wholly above the causal diagonal or before the
// window are never loaded, and q tiles are issued longest-first (the last
// q tile has the most kv tiles) to even out the causal imbalance.  Plain
// FMA on CUDA cores; wgmma / TMA are later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;      // 16 x 16 thread grid
constexpr int kBQ = 64;            // query rows per block
constexpr float kNegInf = -1e30f;  // the TPU kernel's mask value

template <int D>
struct Tile {
  static constexpr int BK = D > 128 ? 32 : 64;   // key rows per kv tile
  static constexpr int LD = D + 4;               // shared row stride of Q, K, V
  static constexpr int LDP = BK + 4;             // shared row stride of P
  static constexpr int TM = kBQ / 16;            // query rows per thread
  static constexpr int TN = BK / 16;             // S columns per thread
  static constexpr int TG = D / 64;              // float4 O groups per thread
  static constexpr int kMinBlocks = D > 128 ? 1 : 2;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (kBQ * LD + BK * LD + kBQ * LDP);
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  alignas(8) __nv_bfloat162 h[2];
  *reinterpret_cast<uint2*>(h) = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  alignas(8) __nv_bfloat162 h[2];
  h[0] = __floats2bfloat162_rn(v.x, v.y);
  h[1] = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

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

// rows x D elements of `src` (row stride D) -> fp32 `dst` (row stride
// D + 4), times `scale`; rows at or past `valid` are zero.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int rows,
                                      int valid, float scale) {
  constexpr int kVec = D / 4;
  for (int idx = threadIdx.x; idx < rows * kVec; idx += kThreads) {
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
    store4(dst + r * (D + 4) + c, v);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Tile<D>::kMinBlocks)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int S, int Tk, int causal, int window,
                       float scale) {
  using C = Tile<D>;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* KVs = Qs + kBQ * C::LD;
  float* Ps = KVs + C::BK * C::LD;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int shift = Tk - S;                            // q_pos = i + shift
  const size_t q_off = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t kv_off = (static_cast<size_t>(b) * Hkv + hk) * Tk * D;
  const int rows = min(kBQ, S - i0);

  stage<D>(Qs, q + q_off + static_cast<size_t>(i0) * D, kBQ, rows, scale);

  // the kv tiles holding a key visible to some row of this q tile
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
    T* orow = out + q_off + static_cast<size_t>(i0 + r) * D;
#pragma unroll
    for (int g = 0; g < C::TG; ++g) {
      store4(orow + tx * 4 + 64 * g,
             make_float4(acc[i][4 * g + 0] / den, acc[i][4 * g + 1] / den,
                         acc[i][4 * g + 2] / den, acc[i][4 * g + 3] / den));
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int H, int Hkv, int S, int Tk, int causal, int window,
             float scale, cudaStream_t stream) {
  constexpr size_t smem = Tile<D>::kSmemBytes;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, S, Tk, causal,
      window, scale);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int Hkv, int S, int Tk, int D, int causal, int window,
           float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch_d<T, 64>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale, st);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale, st);
    case 256:
      return launch_d<T, 256>(q, k, v, out, B, H, Hkv, S, Tk, causal, window, scale, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// window <= 0 means no window.
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v,
                                   void* out, int B, int H, int Hkv, int S,
                                   int T, int D, int causal, int window,
                                   float scale, void* stream) {
  return launch<float>(q, k, v, out, B, H, Hkv, S, T, D, causal, window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v,
                                    void* out, int B, int H, int Hkv, int S,
                                    int T, int D, int causal, int window,
                                    float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, H, Hkv, S, T, D, causal, window,
                               scale, stream);
}

REPRO_EXPORT_ERROR_STRING(flash_attention)
