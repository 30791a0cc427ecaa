// K2: single-token cached attention (flash-decode) for Hopper (sm_90a),
// split over the cache length with a combine pass (flash-decoding).
//
// Replaces llavamod_tpu/ops/decode_attention.py::_decode_kernel (launched by
// _flash_decode_local): attention of one new query token per sequence over
// a [B, KH, S, D] KV cache stored as bf16, f32, or int8 with f32 per-slot
// scales [B, KH, S].
//
// What bounds it on an H100: ~2 FLOP per byte read, so device-memory
// bandwidth (3.35 TB/s).  What a step must read is the live cache slots
// (kv_seg != 0) once: at the serving shape of chip_smoke.py (B=8, KH=16,
// S=1056, D=128, bf16, 5,140 of 8,448 slots live) that is 42 MB, a floor of
// 12.6 us; the whole cache (69 MB) would be 21 us.
//
// Design:
//   * split S: the grid is (splits, KH, B), and split i owns a run of whole
//     128-slot spans (ops/decode_attention.py::split_bounds, mirrored in
//     split_range below); `splits` is picked in Python (decode_splits) so
//     the card holds ~2 blocks per SM.  All G = H/KH query heads of a kv
//     head sit in one block, so each cache row is read once;
//   * a producer warp streams 32-slot tiles of K and V (each contiguous in
//     the [B, KH, S, D] layout) into a 4-stage shared-memory ring with 1-D
//     bulk copies (cp.async.bulk, completion on an mbarrier), the tile's
//     segment ids (and int8 scales) beside them.  A tile whose slots are all
//     empty (kv_seg == 0: left padding, slots not yet written) is neither
//     loaded nor computed;
//   * four consumer warps, each with its own online softmax over its 8 rows
//     of every tile: no barrier inside the walk.  D/8 lanes share a cache
//     row; the row's logits are 16-byte vector reads and a shuffle
//     reduction, P.V reads the V row the same way, every step unrolled.  At
//     the end of the split the four warps' (m, l, acc) merge through shared
//     memory;
//   * each split writes f32 partials (its max m, sum l and the unnormalised
//     acc) to a workspace the wrapper allocates; flash_decode_combine_kernel
//     merges the splits in a fixed order and writes acc / l (l = 0 taken as
//     1, so a row with no live slot gives 0) in the query's dtype.  No
//     atomics: the result is bitwise reproducible;
//   * the arithmetic is the TPU kernel's: for int8 the k-scale multiplies
//     the logits after *scale and before the softcap, and the v-scale
//     multiplies p after the running-sum update (decode_attention.py:88-94,
//     :111-115); p then stays f32 (:76).  For float caches p is rounded to
//     the cache dtype before P.V and K to the query dtype.  p is rounded
//     against the running max of its warp's rows within the split (the TPU
//     kernel: one max per 1024-slot block; the plain version: one max over
//     the row), which ops/tolerance.py covers.

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int NWARPS = 4;                // consumer warps
constexpr int NCONS = NWARPS * 32;
constexpr int NTHREADS = NCONS + 32;     // and the producer warp
constexpr int BS = 32;                   // cache slots per streamed tile
constexpr int RW = BS / NWARPS;          // rows of a tile per consumer warp
// 4 stages of 32 slots (64 KB for bf16 at D = 128) let three blocks share
// an SM; fewer blocks with deeper or wider rings measured slower
constexpr int STAGES = 4;
constexpr int SPAN = 128;                // a split owns whole spans of this
constexpr int MAX_G = 8;                 // query heads per kv head
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T> __device__ __forceinline__ void store(T* p, float x);
template <> __device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
template <> __device__ __forceinline__ void store(float* p, float x) { *p = x; }

// 8 consecutive elements (shared memory, 8-element aligned) -> floats
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

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NCONS) : "memory");
}

// slots [begin, end) of split `i` of `splits`: a balanced share of the
// cache's 128-slot spans (ops/decode_attention.py::split_bounds)
__device__ __forceinline__ void split_range(int S, int splits, int i,
                                            int& begin, int& end) {
  const int spans = (S + SPAN - 1) / SPAN;
  begin = (int)((long long)i * spans / splits) * SPAN;
  end = min(S, (int)((long long)(i + 1) * spans / splits) * SPAN);
}

template <typename CT, int D, int MG>
struct DecSmem {
  static constexpr int TILE = BS * D * (int)sizeof(CT);
  static constexpr size_t ring = size_t(2) * STAGES * TILE;   // K, V
  // the warps' (m, l, acc) at the end of the split reuse the ring
  static constexpr size_t merge = size_t(NWARPS) * MG * (D + 2) * 4;
  static constexpr size_t seg_off = ring > merge ? ring : merge;
  static constexpr size_t ks_off = seg_off + size_t(STAGES) * BS * 4;
  static constexpr size_t vs_off = ks_off + size_t(STAGES) * BS * 4;
  static constexpr size_t q_off = vs_off + size_t(STAGES) * BS * 4;
  static constexpr size_t kind_off = q_off + size_t(MG) * D * 4;
  static constexpr size_t bar_off = (kind_off + STAGES * 4 + 7) / 8 * 8;
  static constexpr size_t bytes = bar_off + size_t(2) * STAGES * 8;
};

struct DecArgs {
  const void* q;          // [B, H, D]
  const void* k;          // [B, KH, S, D]
  const void* v;
  const float* k_scale;   // [B, KH, S] or null
  const float* v_scale;
  const int* kv_seg;      // [B, S]
  float* part_acc;        // [B, H, splits, D]
  float* part_m;          // [B, H, splits]
  float* part_l;          // [B, H, splits]
  int H, KH, S, splits;
  float scale, softcap;
};

// MG: query heads the registers are laid out for (1, or MAX_G for any G).
// (NTHREADS, 1): without the bound ptxas held some MG = 8 variants to 128
// registers and spilled
template <typename QT, typename CT, int D, int MG>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_decode_split_kernel(const DecArgs a) {
  using L = DecSmem<CT, D, MG>;
  constexpr bool kQuant = std::is_same<CT, int8_t>::value;
  constexpr bool kRoundK = std::is_same<QT, __nv_bfloat16>::value &&
                           std::is_same<CT, float>::value;
  constexpr bool kRoundP = std::is_same<CT, __nv_bfloat16>::value;
  constexpr int LPR = D / 8;          // lanes per cache row
  constexpr int RPW = 32 / LPR;       // rows a warp covers per step
  constexpr int NSTEP = RW / RPW;     // steps per tile

  extern __shared__ __align__(128) unsigned char smem[];
  CT* sK = reinterpret_cast<CT*>(smem);
  CT* sV = reinterpret_cast<CT*>(smem + STAGES * L::TILE);
  int* sSeg = reinterpret_cast<int*>(smem + L::seg_off);        // [STAGES][BS]
  float* sKs = reinterpret_cast<float*>(smem + L::ks_off);      // [STAGES][BS]
  float* sVs = reinterpret_cast<float*>(smem + L::vs_off);
  float* sq = reinterpret_cast<float*>(smem + L::q_off);        // [MG][D]
  int* sKind = reinterpret_cast<int*>(smem + L::kind_off);      // [STAGES]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + STAGES;

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = MG == 1 ? 1 : a.H / a.KH;
  const int tid = threadIdx.x;
  const long long row0 = ((long long)b * a.KH + kvh) * a.S;   // slot 0 of (b, kvh)
  int s_begin, s_end;
  split_range(a.S, a.splits, split, s_begin, s_end);
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + BS - 1) / BS : 0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);        // the producer's lanes
      mbar_init(&empty[s], NWARPS);   // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= NCONS) {
    // ---------------- producer ----------------
    const int lane = tid - NCONS;
    const CT* kb = static_cast<const CT*>(a.k) + row0 * D;
    const CT* vb = static_cast<const CT*>(a.v) + row0 * D;
    // a tile's segment ids (and int8 scales), for lane + 32 u
    struct Ids {
      int seg[BS / 32];
      float ks[BS / 32], vs[BS / 32];
    };
    auto read_ids = [&](int i, Ids& t) {
      const int s0 = s_begin + i * BS;
      const int rows = min(BS, s_end - s0);
#pragma unroll
      for (int u = 0; u < BS / 32; ++u) {
        const int r = lane + 32 * u;
        const bool in = i < n_tiles && r < rows;
        t.seg[u] = in ? a.kv_seg[(long long)b * a.S + s0 + r] : 0;
        if (kQuant) {
          t.ks[u] = in ? a.k_scale[row0 + s0 + r] : 0.f;
          t.vs[u] = in ? a.v_scale[row0 + s0 + r] : 0.f;
        }
      }
    };
    Ids cur, nxt;
    read_ids(0, cur);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % STAGES;
      const int s0 = s_begin + i * BS;
      const int rows = min(BS, s_end - s0);
      // the next tile's ids are read one tile ahead, so their latency
      // overlaps this tile's wait and issue
      read_ids(i + 1, nxt);
      mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
      bool any = false;
#pragma unroll
      for (int u = 0; u < BS / 32; ++u) {
        const int r = lane + 32 * u;
        sSeg[st * BS + r] = cur.seg[u];
        any |= cur.seg[u] != 0;
        if (kQuant) {
          sKs[st * BS + r] = cur.ks[u];
          sVs[st * BS + r] = cur.vs[u];
        }
      }
      any = __any_sync(0xffffffffu, any);
      if (lane == 0) {
        sKind[st] = any;
        const uint32_t bytes = any ? rows * D * (int)sizeof(CT) : 0;
        mbar_arrive_expect_tx(&full[st], 2 * bytes);
        if (any) {
          bulk_load(sK + st * BS * D, kb + (long long)s0 * D, bytes, &full[st]);
          bulk_load(sV + st * BS * D, vb + (long long)s0 * D, bytes, &full[st]);
        }
      } else {
        mbar_arrive(&full[st]);
      }
      cur = nxt;
    }
    return;
  }

  // ---------------- consumers: warp w owns rows RW w .. of every tile ----
  // q of the kv head's G query heads, as f32 (its load overlaps the
  // producer's first copies)
  const QT* qb = static_cast<const QT*>(a.q) + ((long long)b * a.H + kvh * G) * D;
  for (int i = tid; i < G * D; i += NCONS) sq[i] = to_f(qb[i]);
  consumers_sync();
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int half = lane / LPR;         // which row of a step
  const int sub = lane % LPR;          // columns 8 sub ..
  float m[MG], l[MG], acc[MG][8];
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  }

  for (int i = 0; i < n_tiles; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    if (sKind[st]) {
      const int rows = min(BS, s_end - (s_begin + i * BS));
      const CT* tk = sK + st * BS * D;
      const CT* tv = sV + st * BS * D;
      const int* seg = sSeg + st * BS;

      // logits of the warp's rows: s = (q . k) * scale [* k_scale];
      // softcap; NEG_INF where the slot is empty or past the split
      float s[MG][NSTEP];
#pragma unroll
      for (int j = 0; j < NSTEP; ++j) {
        const int jj = RW * warp + RPW * j + half;
        float kf[8];
        if (jj < rows) {
          load8(tk + jj * D + sub * 8, kf);
          if (kRoundK) {
#pragma unroll
            for (int e = 0; e < 8; ++e) kf[e] = round_bf16(kf[e]);
          }
        } else {   // past the split: shared memory holds stale bytes
#pragma unroll
          for (int e = 0; e < 8; ++e) kf[e] = 0.f;
        }
        const bool valid = jj < rows && seg[jj] != 0;
        const float ks = kQuant ? sKs[st * BS + jj] : 1.f;
#pragma unroll
        for (int g = 0; g < MG; ++g) {
          if (g >= G) continue;
          const float4 qa = *reinterpret_cast<const float4*>(sq + g * D + sub * 8);
          const float4 qc = *reinterpret_cast<const float4*>(sq + g * D + sub * 8 + 4);
          float part = qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                       qc.x * kf[4] + qc.y * kf[5] + qc.z * kf[6] + qc.w * kf[7];
#pragma unroll
          for (int off = LPR / 2; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          float x = part * a.scale;
          if (kQuant) x *= ks;
          if (a.softcap > 0.f) x = tanhf(x / a.softcap) * a.softcap;
          s[g][j] = valid ? x : NEG_INF;
        }
      }

      // online softmax of the warp's rows; s becomes p as P.V takes it
#pragma unroll
      for (int g = 0; g < MG; ++g) {
        if (g >= G) continue;
        float mx = NEG_INF;
#pragma unroll
        for (int j = 0; j < NSTEP; ++j) mx = fmaxf(mx, s[g][j]);
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[g], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < NSTEP; ++j) {
          const int jj = RW * warp + RPW * j + half;
          const bool valid = jj < rows && seg[jj] != 0;
          const float p = valid ? __expf(s[g][j] - m_new) : 0.f;
          sum += p;
          float pv = p;
          if (kQuant) pv = valid ? p * sVs[st * BS + jj] : 0.f;
          if (kRoundP) pv = round_bf16(pv);
          s[g][j] = pv;
        }
#pragma unroll
        for (int off = LPR; off < 32; off <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = __expf(m[g] - m_new);
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] *= alpha;
      }

      // acc += p . v over the warp's rows, 8 columns a lane
#pragma unroll
      for (int j = 0; j < NSTEP; ++j) {
        const int jj = RW * warp + RPW * j + half;
        if (jj < rows) {
          float vf[8];
          load8(tv + jj * D + sub * 8, vf);
#pragma unroll
          for (int g = 0; g < MG; ++g) {
            if (g >= G) continue;
#pragma unroll
            for (int e = 0; e < 8; ++e) acc[g][e] += s[g][j] * vf[e];
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // the rows of a step sit on different lanes: sum acc over them
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g >= G) continue;
#pragma unroll
    for (int e = 0; e < 8; ++e)
#pragma unroll
      for (int off = LPR; off < 32; off <<= 1)
        acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  }

  // merge the four warps (through the ring, now idle); write the partials
  consumers_sync();
  float* wacc = reinterpret_cast<float*>(smem);        // [NWARPS][MG][D]
  float* wm = wacc + NWARPS * MG * D;                  // [NWARPS][MG]
  float* wl = wm + NWARPS * MG;
#pragma unroll
  for (int g = 0; g < MG; ++g) {
    if (g >= G) continue;
    if (half == 0) {
#pragma unroll
      for (int e = 0; e < 8; ++e) wacc[(warp * MG + g) * D + sub * 8 + e] = acc[g][e];
    }
    if (lane == 0) {
      wm[warp * MG + g] = m[g];
      wl[warp * MG + g] = l[g];
    }
  }
  consumers_sync();
  for (int i = tid; i < G * D; i += NCONS) {
    const int g = i / D, d = i % D;
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, wm[w * MG + g]);
    float sum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      const float f = __expf(wm[w * MG + g] - mx);
      sum += wl[w * MG + g] * f;
      out += wacc[(w * MG + g) * D + d] * f;
    }
    const long long p = ((long long)b * a.H + kvh * G + g) * a.splits + split;
    a.part_acc[p * D + d] = out;
    if (d == 0) {
      a.part_m[p] = mx;
      a.part_l[p] = sum;
    }
  }
}

// out[b, h] = sum_i acc_i e^(m_i - M) / sum_i l_i e^(m_i - M), M = max_i m_i,
// over the splits i in order; one block of D threads per (b, h).
template <typename QT, int D>
__global__ void __launch_bounds__(D)
flash_decode_combine_kernel(const float* __restrict__ part_acc,
                            const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            QT* __restrict__ out, int splits) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* m = part_m + bh * splits;
  const float* l = part_l + bh * splits;
  float mx = NEG_INF;
  for (int i = 0; i < splits; ++i) mx = fmaxf(mx, m[i]);
  float lsum = 0.f, acc = 0.f;
  for (int i = 0; i < splits; ++i) {
    const float w = __expf(m[i] - mx);
    lsum += l[i] * w;
    acc += part_acc[(bh * splits + i) * D + d] * w;
  }
  store(out + bh * D + d, acc / (lsum == 0.f ? 1.f : lsum));
}

template <typename QT, typename CT, int D, int MG>
int launch(const DecArgs& a, void* out, int B, cudaStream_t stream) {
  constexpr size_t smem = DecSmem<CT, D, MG>::bytes;
  const auto kernel = flash_decode_split_kernel<QT, CT, D, MG>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  // the most of the SM's unified memory as shared memory, so that as many
  // blocks share an SM as their rings allow
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(a.splits, a.KH, B);
  flash_decode_split_kernel<QT, CT, D, MG><<<grid, NTHREADS, smem, stream>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine_kernel<QT, D><<<B * a.H, D, 0, stream>>>(
      a.part_acc, a.part_m, a.part_l, static_cast<QT*>(out), a.splits);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT>
int dispatch_d(int D, const DecArgs& a, void* out, int B, cudaStream_t s) {
  const bool one = a.H == a.KH;
  if (D == 64)
    return one ? launch<QT, CT, 64, 1>(a, out, B, s)
               : launch<QT, CT, 64, MAX_G>(a, out, B, s);
  if (D == 128)
    return one ? launch<QT, CT, 128, 1>(a, out, B, s)
               : launch<QT, CT, 128, MAX_G>(a, out, B, s);
  return (int)cudaErrorInvalidValue;
}

template <typename QT>
int dispatch_cache(int cache_dtype, int D, const DecArgs& a, void* out, int B,
                   cudaStream_t s) {
  switch (cache_dtype) {
    case 0: return dispatch_d<QT, __nv_bfloat16>(D, a, out, B, s);
    case 1: return dispatch_d<QT, float>(D, a, out, B, s);
    case 2: return dispatch_d<QT, int8_t>(D, a, out, B, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = bf16, 1 = f32, 2 = int8 (cache only; needs both scales).
// part_acc [B, H, splits, D], part_m and part_l [B, H, splits]: f32
// workspace.  softcap <= 0 means none.  Launches the split kernel and the
// combine; returns the first cudaError_t that is not 0 (0 = launched).
extern "C" int llavamod_flash_decode(const void* q, const void* k,
                                     const void* v, const float* k_scale,
                                     const float* v_scale, const int* kv_seg,
                                     void* out, float* part_acc, float* part_m,
                                     float* part_l, int B, int H, int KH,
                                     int S, int D, int splits, int q_dtype,
                                     int cache_dtype, float scale,
                                     float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % KH != 0 || H / KH > MAX_G || splits < 1 ||
      splits > (S + SPAN - 1) / SPAN)
    return (int)cudaErrorInvalidValue;
  const DecArgs a{q, k, v, k_scale, v_scale, kv_seg, part_acc, part_m,
                  part_l, H, KH, S, splits, scale, softcap};
  if (q_dtype == 0) return dispatch_cache<__nv_bfloat16>(cache_dtype, D, a, out, B, s);
  if (q_dtype == 1) return dispatch_cache<float>(cache_dtype, D, a, out, B, s);
  return (int)cudaErrorInvalidValue;
}
