// K2: single-token cached attention (flash-decode) for Hopper (sm_90a).
//
// Replaces llavamod_tpu/ops/decode_attention.py::_decode_kernel (launched by
// _flash_decode_local): attention of one new query token per sequence over
// a [B, KH, S, D] KV cache stored as bf16, f32, or int8 with f32 per-slot
// scales [B, KH, S].
//
// What bounds it on an H100: every decode step reads the whole cache once
// and does ~2 FLOP per byte read, so it is bound by device-memory bandwidth
// (3.35 TB/s).  At the serving shape (B=8, KH=16, S=1056, D=128, bf16) one
// layer reads ~69 MB, a floor of ~21 us.
//
// Design (simple first; splitting S across blocks comes later):
//   * one block per (kv head, batch).  All G = H/KH query heads of that kv
//     head sit in the block, so the cache rows are read once;
//   * a loop over S tiles of 128 slots runs the online softmax.  Logits:
//     D/8 lanes cooperate on one cache row with 16-byte (bf16) loads and a
//     shuffle reduction.  P.V: each thread owns one output column and walks
//     the tile's rows, so a warp reads a row segment contiguously;
//   * the cache is read in its stored dtype.  For int8 the k-scale multiplies
//     the logits after *scale and before the softcap, and the v-scale
//     multiplies p after the running-sum update (decode_attention.py:88-94,
//     :111-115); p then stays f32 (:76).  For float caches p is rounded to
//     the cache dtype before P.V, and K is rounded to the query dtype;
//   * slots with kv_seg == 0 (left padding, not yet written) and slots past S
//     are masked; masked p is zeroed after the exp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int BS = 128;        // cache slots per tile
constexpr int MAX_G = 8;       // query heads per kv head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ void store(T* p, float x);
template <> __device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
template <> __device__ __forceinline__ void store(float* p, float x) { *p = x; }

// 8 consecutive cache elements -> floats
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const int8_t* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = (float)c[i];
}

template <typename QT, typename CT, int D>
// (NTHREADS, 1): one block per (kv head, batch) is 128 blocks at the
// serving shape, one an SM, so ptxas need not squeeze registers for
// occupancy (without the bound it spilled at 48 registers)
__global__ void __launch_bounds__(NTHREADS, 1)
flash_decode_kernel(const QT* __restrict__ q,          // [B, H, D]
                    const CT* __restrict__ k,          // [B, KH, S, D]
                    const CT* __restrict__ v,
                    const float* __restrict__ k_scale, // [B, KH, S] or null
                    const float* __restrict__ v_scale,
                    const int* __restrict__ kv_seg,    // [B, S]
                    QT* __restrict__ out,              // [B, H, D]
                    int H, int KH, int S, float scale, float softcap) {
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  constexpr bool kRoundK = std::is_same<QT, __nv_bfloat16>::value &&
                           std::is_same<CT, float>::value;
  constexpr bool kRoundP = std::is_same<CT, __nv_bfloat16>::value;
  constexpr int LPR = D / 8;          // lanes per cache row (logits phase)
  constexpr int RPW = 32 / LPR;       // cache rows per warp step
  constexpr int NG = NTHREADS / D;    // column groups in the P.V phase

  __shared__ float sq[MAX_G][D];
  __shared__ float slog[MAX_G][BS];   // logits of the tile
  __shared__ float spv[MAX_G][BS];    // probabilities as P.V consumes them
  __shared__ int svalid[BS];
  __shared__ float sm[MAX_G], sl[MAX_G], salpha[MAX_G];
  __shared__ float sred[NG][MAX_G][D];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / KH;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const long long row0 = ((long long)b * KH + kvh) * S;   // first slot of (b, kvh)
  const CT* kb = k + row0 * D;
  const CT* vb = v + row0 * D;
  const QT* qb = q + ((long long)b * H + kvh * G) * D;

  for (int i = tid; i < G * D; i += NTHREADS) sq[i / D][i % D] = to_f(qb[i]);
  if (tid < G) {
    sm[tid] = NEG_INF;
    sl[tid] = 0.f;
  }

  const int col = tid % D;
  const int grp = tid / D;
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;

  const int sub = lane % LPR;
  const int n_tiles = (S + BS - 1) / BS;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int s0 = tile * BS;
    __syncthreads();  // previous tile's slog/spv fully consumed; sq ready

    // logits: s = (q . k) * scale [* k_scale]; softcap; mask
    for (int jj = warp * RPW + lane / LPR; jj < BS; jj += NWARPS * RPW) {
      const int j = s0 + jj;
      const bool in = j < S;
      float kf[8];
      if (in) {
        load8(kb + (long long)j * D + sub * 8, kf);
        if (kRoundK) {
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = round_bf16(kf[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kf[e] = 0.f;
      }
      const bool valid = in && kv_seg[(long long)b * S + j] != 0;
      const float ks = (kQuant && in) ? k_scale[row0 + j] : 1.f;
      for (int g = 0; g < G; ++g) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) part += sq[g][sub * 8 + e] * kf[e];
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        if (sub == 0) {
          float s = part * scale;
          if (kQuant) s *= ks;
          if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
          slog[g][jj] = valid ? s : NEG_INF;
        }
      }
      if (sub == 0) svalid[jj] = valid;
    }
    __syncthreads();

    // online softmax, one warp per query head
    for (int g = warp; g < G; g += NWARPS) {
      float mx = NEG_INF;
      for (int jj = lane; jj < BS; jj += 32) mx = fmaxf(mx, slog[g][jj]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int jj = lane; jj < BS; jj += 32) {
        const float p = svalid[jj] ? __expf(slog[g][jj] - m_new) : 0.f;
        sum += p;
        float pv = p;
        if (kQuant) pv = svalid[jj] ? p * v_scale[row0 + s0 + jj] : 0.f;
        if (kRoundP) pv = round_bf16(pv);
        spv[g][jj] = pv;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = __expf(m_prev - m_new);
      if (lane == 0) {
        sm[g] = m_new;
        sl[g] = sl[g] * alpha + sum;
        salpha[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . v
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) acc[g] *= salpha[g];
    const int rows = min(BS, S - s0);
    for (int jj = grp; jj < rows; jj += NG) {
      const float vf = to_f(vb[(long long)(s0 + jj) * D + col]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] += spv[g][jj] * vf;
    }
  }

  // combine the column groups, normalise, write
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G) sred[grp][g][col] = acc[g];
  __syncthreads();
  if (grp == 0) {
    for (int g = 0; g < G; ++g) {
      float a = 0.f;
      for (int r = 0; r < NG; ++r) a += sred[r][g][col];
      const float l = sl[g];
      store(out + ((long long)b * H + kvh * G + g) * D + col,
            a / (l == 0.f ? 1.f : l));
    }
  }
}

template <typename QT, typename CT, int D>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const int* seg, void* out, int B, int H, int KH,
           int S, float scale, float softcap, cudaStream_t stream) {
  dim3 grid(KH, B);
  flash_decode_kernel<QT, CT, D><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), ks, vs, seg, static_cast<QT*>(out), H, KH,
      S, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const float* ks, const float* vs, const int* seg, void* out,
               int B, int H, int KH, int S, float scale, float softcap,
               cudaStream_t stream) {
  if (D == 64)
    return launch<QT, CT, 64>(q, k, v, ks, vs, seg, out, B, H, KH, S, scale,
                              softcap, stream);
  if (D == 128)
    return launch<QT, CT, 128>(q, k, v, ks, vs, seg, out, B, H, KH, S, scale,
                               softcap, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int dispatch_cache(int cache_dtype, int D, const void* q, const void* k,
                   const void* v, const float* ks, const float* vs,
                   const int* seg, void* out, int B, int H, int KH, int S,
                   float scale, float softcap, cudaStream_t stream) {
  switch (cache_dtype) {
    case 0:
      return dispatch_d<QT, __nv_bfloat16>(D, q, k, v, ks, vs, seg, out, B, H,
                                           KH, S, scale, softcap, stream);
    case 1:
      return dispatch_d<QT, float>(D, q, k, v, ks, vs, seg, out, B, H, KH, S,
                                   scale, softcap, stream);
    case 2:
      return dispatch_d<QT, int8_t>(D, q, k, v, ks, vs, seg, out, B, H, KH, S,
                                    scale, softcap, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = bf16, 1 = f32, 2 = int8 (cache only; needs both scales).
// softcap <= 0 means none.  Returns a cudaError_t (0 = launched).
extern "C" int llavamod_flash_decode(const void* q, const void* k,
                                     const void* v, const float* k_scale,
                                     const float* v_scale, const int* kv_seg,
                                     void* out, int B, int H, int KH, int S,
                                     int D, int q_dtype, int cache_dtype,
                                     float scale, float softcap,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % KH != 0 || H / KH > MAX_G) return (int)cudaErrorInvalidValue;
  if (q_dtype == 0)
    return dispatch_cache<__nv_bfloat16>(cache_dtype, D, q, k, v, k_scale,
                                         v_scale, kv_seg, out, B, H, KH, S,
                                         scale, softcap, s);
  if (q_dtype == 1)
    return dispatch_cache<float>(cache_dtype, D, q, k, v, k_scale, v_scale,
                                 kv_seg, out, B, H, KH, S, scale, softcap, s);
  return (int)cudaErrorInvalidValue;
}
