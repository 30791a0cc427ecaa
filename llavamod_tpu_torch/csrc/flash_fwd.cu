// K1: flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces llavamod_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd): tiled online-softmax attention that never writes the [T, S] score
// matrix to device memory.
//
// What bounds it on an H100: at the training shape (B=1, T=S=2048, H=16 or
// 32, D=128, causal) the work is 17.2 GFLOP per 16 heads against ~25 MB of
// q/k/v/o traffic, far above the ~295 FLOP/byte ridge: it is bound by the
// tensor cores, so the design keeps them fed and keeps everything else out
// of their way.
//
// Design:
//   * one CTA of 384 threads per (128 query rows, head, batch): two consumer
//     warpgroups own 64 query rows each; one producer warp (of the third
//     warpgroup, whose registers `setmaxnreg` hands to the consumers) keeps
//     TMA loads of K and V tiles (128 kv rows) in flight in a 2-stage ring
//     guarded by full / empty mbarriers, and loads Q once;
//   * S = Q K^T is a wgmma with both operands K-major in shared memory
//     (128-byte swizzle); S stays in registers, and so does the online
//     softmax: scale, softcap and mask per element on the accumulator
//     layout, row max and row sum reduced over the 4 lanes of a quad;
//   * O += P V is a wgmma whose A operand is P packed to bf16 in registers
//     (the accumulator layout is the A-fragment layout) and whose B operand
//     is the V tile, MN-major with the transpose bit; O stays in registers
//     for the whole kv loop and is written once, as bf16, with lse in f32;
//   * masking is one rule: (q, k) is live iff qseg == kseg != 0 and (!causal
//     || k <= q); rows and keys past the sequence are segment 0 (TMA fills
//     them with zeros).  The producer classifies every kv tile from its
//     segment ids: a tile that is all padding is not loaded and not
//     computed; a tile whose ids are uniform and equal to the warpgroup's
//     uniform query id, below the causal diagonal, skips the mask.  Masked
//     probabilities are zeroed after the exp, so a fully masked row writes
//     o = 0 and lse = NEG_INF (flash_attention.py:110-130); a q tile that
//     is all padding writes that and exits;
//   * causal: the kv loop stops at the diagonal, and the q tiles run
//     heaviest first (the tile index is reversed on the slowest grid axis);
//   * q/k/v are read through strides from the [B, T, H, D] API layout by
//     4-D tensor maps, so no transpose copy is made; GQA maps query head h
//     to kv head h / (H / KH).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;          // query rows per CTA (2 warpgroups x 64)
constexpr int BK = 128;          // kv rows per tile
constexpr int STAGES = 2;
constexpr int NTHREADS = 384;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct FwdSmem {
  static constexpr int CH = D / CHUNK_COLS;
  static constexpr int Q_CHUNK = BQ * ROW_BYTES;
  static constexpr int KV_CHUNK = BK * ROW_BYTES;
  static constexpr int KV_TILE = CH * KV_CHUNK;
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(CH) * Q_CHUNK;
  static constexpr size_t v_off = k_off + size_t(STAGES) * KV_TILE;
  static constexpr size_t kseg_off = v_off + size_t(STAGES) * KV_TILE;
  static constexpr size_t kind_off = kseg_off + size_t(STAGES) * BK * 4;
  static constexpr size_t qseg_off = kind_off + size_t(STAGES) * 8;
  static constexpr size_t quni_off = qseg_off + size_t(BQ) * 4;
  static constexpr size_t bar_off = quni_off + 8;
  static constexpr size_t bytes = bar_off + size_t(2 * STAGES + 1) * 8;
  static constexpr size_t alloc = bytes + 1024;   // to align the base
};

struct FwdArgs {
  const int* q_seg;    // [B, T] or null
  const int* kv_seg;   // [B, S] or null
  __nv_bfloat16* o;
  float* lse;          // [B, H, T]
  int H, KH, T, S;
  long long o_sb, o_st, o_sh;
  float scale, softcap;
  int causal;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Scores of one tile into log2 units (scale, softcap, and with MASKED the
// NEG_INF of dead pairs), then the online-softmax update: sc becomes p, o
// is rescaled, m and l move.  Entry i of the accumulator layout sits on row
// `hi ? t_hi : t_lo` (hi = (i / 2) % 2) and column k0 + 8 (i / 4) + col0 +
// i % 2.
template <bool MASKED, int N, int DO>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[N], float (&o)[DO], float& m_lo, float& m_hi, float& l_lo,
    float& l_hi, const FwdArgs& a, const int* kseg, int k0, int col0,
    int t_lo, int t_hi, int qs_lo, int qs_hi) {
  const float scale2 = a.scale * LOG2E;
  float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool hi = (i / 2) % 2;
    float x = sc[i];
    x = a.softcap > 0.f ? tanhf(x * a.scale / a.softcap) * a.softcap * LOG2E
                        : x * scale2;
    if (MASKED) {
      const int col = 8 * (i / 4) + col0 + (i % 2);
      const int ks = kseg[col];
      const bool ok = (hi ? qs_hi : qs_lo) == ks && ks != 0 &&
                      (!a.causal || k0 + col <= (hi ? t_hi : t_lo));
      x = ok ? x : NEG_INF;
    }
    sc[i] = x;
    if (hi) mx_hi = fmaxf(mx_hi, x);
    else mx_lo = fmaxf(mx_lo, x);
  }
  const float mn_lo = fmaxf(m_lo, quad_max(mx_lo));
  const float mn_hi = fmaxf(m_hi, quad_max(mx_hi));
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool hi = (i / 2) % 2;
    float p = ex2(sc[i] - (hi ? mn_hi : mn_lo));
    // NEG_INF is finite: an all-masked row has m = NEG_INF and exp(0) = 1,
    // so dead pairs are zeroed after the exp
    if (MASKED && sc[i] == NEG_INF) p = 0.f;
    sc[i] = p;
    if (hi) sum_hi += p;
    else sum_lo += p;
  }
  const float al_lo = ex2(m_lo - mn_lo), al_hi = ex2(m_hi - mn_hi);
  l_lo = l_lo * al_lo + quad_sum(sum_lo);
  l_hi = l_hi * al_hi + quad_sum(sum_hi);
  m_lo = mn_lo;
  m_hi = mn_hi;
#pragma unroll
  for (int i = 0; i < DO; ++i) o[i] *= ((i / 2) % 2) ? al_hi : al_lo;
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const FwdArgs a) {
  using L = FwdSmem<D>;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + L::q_off;
  unsigned char* sK = smem + L::k_off;
  unsigned char* sV = smem + L::v_off;
  int* sKSeg = reinterpret_cast<int*>(smem + L::kseg_off);   // [STAGES][BK]
  int* sKind = reinterpret_cast<int*>(smem + L::kind_off);   // [STAGES][2]
  int* sQSeg = reinterpret_cast<int*>(smem + L::qseg_off);   // [BQ]
  int* sQUni = reinterpret_cast<int*>(smem + L::quni_off);   // [2]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;   // heaviest first
  const int kvh = h / (a.H / a.KH);
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);     // the producer warp's lanes
      mbar_init(&empty[s], 8);     // the consumer warps
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  int qs = 0;
  if (tid < BQ) {
    qs = seg_at(a.q_seg, b, a.T, q0 + tid);
    sQSeg[tid] = qs;
  }
  if (!__syncthreads_or(qs != 0)) {
    // every query row of the tile is padding: o = 0 and lse = NEG_INF
    for (int i = tid; i < BQ * (D / 2); i += NTHREADS) {
      const int t = q0 + i / (D / 2), c = (i % (D / 2)) * 2;
      if (t < a.T)
        *reinterpret_cast<__nv_bfloat162*>(a.o + b * a.o_sb + t * a.o_st +
                                           h * a.o_sh + c) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
    if (tid < BQ && q0 + tid < a.T)
      a.lse[((long long)b * a.H + h) * a.T + q0 + tid] = NEG_INF;
    return;
  }
  if (tid < 64) {   // per consumer warpgroup: one query segment id or MIXED
    const int w = tid / 32, lane = tid % 32;
    int mn = min(sQSeg[64 * w + lane], sQSeg[64 * w + lane + 32]);
    int mx = max(sQSeg[64 * w + lane], sQSeg[64 * w + lane + 32]);
    warp_min_max(mn, mx);
    if (lane == 0) sQUni[w] = mn == mx ? mn : MIXED;
  }
  __syncthreads();

  int n_kt = (a.S + BK - 1) / BK;
  if (a.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  const int wg = tid / 128;
  const int lane = tid % 32;

  if (wg == 2) {
    // ---------------- producer ----------------
    regs_dealloc<40>();
    if (tid >= 256 + 32) return;   // one warp issues the loads
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, CH * L::Q_CHUNK);
      for (int c = 0; c < CH; ++c)
        tma_load_4d(sQ + c * L::Q_CHUNK, &tq, qbar, c * CHUNK_COLS, h, q0, b);
    }
    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES;
      mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
      const int k0 = j * BK;
      int mn = INT_MAX, mx = INT_MIN;
      for (int r = lane; r < BK; r += 32) {
        const int v = seg_at(a.kv_seg, b, a.S, k0 + r);
        sKSeg[s * BK + r] = v;
        mn = min(mn, v);
        mx = max(mx, v);
      }
      warp_min_max(mn, mx);
      const int kind = tile_kind(mn, mx);
      if (lane == 0) {
        sKind[2 * s] = kind;
        sKind[2 * s + 1] = mn;
        mbar_arrive_expect_tx(&full[s], kind == TILE_SKIP ? 0 : 2 * L::KV_TILE);
        if (kind != TILE_SKIP) {
          for (int c = 0; c < CH; ++c) {
            tma_load_4d(sK + s * L::KV_TILE + c * L::KV_CHUNK, &tk, &full[s],
                        c * CHUNK_COLS, kvh, k0, b);
            tma_load_4d(sV + s * L::KV_TILE + c * L::KV_CHUNK, &tv, &full[s],
                        c * CHUNK_COLS, kvh, k0, b);
          }
        }
      } else {
        mbar_arrive(&full[s]);
      }
    }
  } else {
    // ---------------- consumers: warpgroup wg owns q rows 64 wg .. ----------
    regs_alloc<232>();
    const int warp = (tid / 32) % 4;
    const int r_lo = 64 * wg + 16 * warp + lane / 4;
    const int t_lo = q0 + r_lo, t_hi = t_lo + 8;
    const int qs_lo = sQSeg[r_lo], qs_hi = sQSeg[r_lo + 8];
    const int quni = sQUni[wg];
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base = smem_u32(sQ) + wg * 64 * ROW_BYTES;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_lo = NEG_INF, m_hi = NEG_INF, l_lo = 0.f, l_hi = 0.f;
    mbar_wait(qbar, 0);

    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const int kind = sKind[2 * s], kval = sKind[2 * s + 1];
      const int k0 = j * BK;
      if (kind != TILE_SKIP) {
        float sc[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
        const uint32_t k_base = smem_u32(sK) + s * L::KV_TILE;
        fence_regs(sc);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128(sc, desc_kmajor(q_base + c * L::Q_CHUNK + kk * 32),
                          desc_kmajor(k_base + c * L::KV_CHUNK + kk * 32),
                          c + kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);

        const bool dense = kind == TILE_UNIFORM && quni == kval &&
                           (!a.causal || k0 + BK - 1 <= q0 + 64 * wg);
        const int* kseg = sKSeg + s * BK;
        if (dense)
          softmax_tile<false>(sc, o, m_lo, m_hi, l_lo, l_hi, a, kseg, k0,
                              col0, t_lo, t_hi, qs_lo, qs_hi);
        else
          softmax_tile<true>(sc, o, m_lo, m_hi, l_lo, l_hi, a, kseg, k0,
                             col0, t_lo, t_hi, qs_lo, qs_hi);

        uint32_t pa[BK / 16][4];
        pack_a(sc, pa);   // P to bf16 before P V (flash_attention.py:118)
        const uint32_t v_base = smem_u32(sV) + s * L::KV_TILE;
        fence_regs(o);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_tb<D>(o, pa[kk],
                    desc_mnmajor(v_base + kk * 16 * ROW_BYTES, L::KV_CHUNK));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    const float inv_lo = l_lo == 0.f ? 0.f : 1.f / l_lo;
    const float inv_hi = l_hi == 0.f ? 0.f : 1.f / l_hi;
    __nv_bfloat16* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
    for (int j8 = 0; j8 < D / 8; ++j8) {
      const int c = 8 * j8 + col0;
      if (t_lo < a.T)
        *reinterpret_cast<__nv_bfloat162*>(ob + t_lo * a.o_st + c) =
            __floats2bfloat162_rn(o[4 * j8] * inv_lo, o[4 * j8 + 1] * inv_lo);
      if (t_hi < a.T)
        *reinterpret_cast<__nv_bfloat162*>(ob + t_hi * a.o_st + c) =
            __floats2bfloat162_rn(o[4 * j8 + 2] * inv_hi,
                                  o[4 * j8 + 3] * inv_hi);
    }
    if (lane % 4 == 0) {
      float* lb = a.lse + ((long long)b * a.H + h) * a.T;
      if (t_lo < a.T) lb[t_lo] = l_lo == 0.f ? NEG_INF : m_lo * LN2 + logf(l_lo);
      if (t_hi < a.T) lb[t_hi] = l_hi == 0.f ? NEG_INF : m_hi * LN2 + logf(l_hi);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* q_seg,
           const int* kv_seg, void* o, float* lse, int B, int H, int KH,
           int T, int S, const long long* st, float scale, float softcap,
           int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = make_bthd_map(&tq, q, B, T, H, D, st[0], st[1], st[2], BQ);
  if (!err) err = make_bthd_map(&tk, k, B, S, KH, D, st[3], st[4], st[5], BK);
  if (!err) err = make_bthd_map(&tv, v, B, S, KH, D, st[6], st[7], st[8], BK);
  if (err) return err;
  const FwdArgs args{q_seg, kv_seg, static_cast<__nv_bfloat16*>(o), lse,
                     H, KH, T, S, st[9], st[10], st[11], scale, softcap,
                     causal};
  const size_t smem = FwdSmem<D>::alloc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (T + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(tq, tk, tv, args);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 12 element strides, (batch, seq, head) for q, k, v and o.
// softcap <= 0 means none.  Returns a cudaError_t (0 = launched).
extern "C" int llavamod_flash_fwd(const void* q, const void* k, const void* v,
                                  const int* q_seg, const int* kv_seg,
                                  void* o, float* lse, int B, int H, int KH,
                                  int T, int S, int D,
                                  const long long* strides, float scale,
                                  float softcap, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, q_seg, kv_seg, o, lse, B, H, KH, T, S, strides,
                      scale, softcap, causal, s);
  if (D == 128)
    return launch<128>(q, k, v, q_seg, kv_seg, o, lse, B, H, KH, T, S, strides,
                       scale, softcap, causal, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* llavamod_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
