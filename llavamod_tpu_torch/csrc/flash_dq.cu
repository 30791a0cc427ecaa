// K3: flash-attention backward dq for Hopper (sm_90a), bf16 in / bf16 out,
// f32 accumulation.  (K4, dk and dv, is csrc/flash_dkv.cu: the two kernels
// mirror each other with the roles of (Q, dO) and (K, V) swapped.)
//
// Replaces llavamod_tpu/ops/flash_attention.py::_dq_kernel (launched by
// _bwd).  It recomputes the probability tile p = exp(softcap(s) - lse) from
// q, k and the forward's saved logsumexp, so the [T, S] score matrix never
// reaches device memory, and takes delta = rowsum(dO * O) from the wrapper:
//
//   dp = dO V^T (f32),  ds = p * (dp - delta) * softcap'(s) * scale
//   dq = sum_j ds_j K_j         (ds cast to bf16 first)
//
// with softcap'(s) = 1 - tanh^2(s_raw / c) on the RAW scaled score.
//
// What bounds it on an H100: at the training shape (B=1, T=S=2048,
// H=KH=16, D=128, causal) it does 25.8 GFLOP (3 products per live pair)
// against ~21 MB of q/k/v/dO/lse/delta in and dq out: far above the ~295
// FLOP/byte ridge, so bound by the tensor cores.
//
// Design:
//   * one CTA of 256 threads per (128 query rows, head, batch): two
//     warpgroups own 64 query rows each.  Q and dO are loaded once by TMA;
//     64-row tiles of K and V stream through a 3-stage TMA / mbarrier ring,
//     with the tile's kv segment ids beside them, refilled two tiles ahead
//     by warp 0 right after it releases its own stage (K4's layout: no
//     separate producer warp, so ptxas is not held to the 168 registers a
//     thread of a 3-warpgroup kernel gets).  Each thread keeps lse (in log2
//     units) and delta of its two rows in registers;
//   * S = Q K^T and dP = dO V^T are m64n64 wgmmas with both operands
//     K-major in shared memory (128-byte swizzle) into registers; dS is
//     formed in registers and packed to bf16 as the register A operand of
//     dq += dS K, whose B operand is the K tile, MN-major with the
//     transpose bit.  dq stays in registers for the whole kv walk (D / 2
//     f32 a thread) and is written once as bf16; nothing goes through
//     shared memory as f32;
//   * masking is one rule: (q, k) is live iff qseg == kseg != 0 and (!causal
//     || k <= q); rows and keys past the sequence are segment 0 (TMA fills
//     them with zeros).  p is never formed on a dead pair, so a fully masked
//     query row (lse = NEG_INF) gets dq = 0, not inf * 0.  A kv tile that is
//     all padding is neither loaded nor computed, a warpgroup skips kv tiles
//     wholly above its causal diagonal, only tiles on the diagonal or with
//     mixed segment ids pay for the mask, and a q tile that is all padding
//     writes zeros and exits;
//   * causal: the kv walk stops at the diagonal, and the q tiles run
//     heaviest first (the tile index is reversed on the slowest grid axis);
//   * each CTA sums its kv tiles in a fixed order and no two CTAs write the
//     same rows: no atomics, so dq is bitwise reproducible;
//   * tensors are read through strides from the [B, T, H, D] API layout by
//     4-D tensor maps; GQA maps query head h to kv head h / (H / KH).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BQ = 128;          // query rows per CTA (2 warpgroups x 64)
constexpr int BK = 64;           // kv rows per streamed tile
static_assert(BK == 64, "the loading warp fills two kv rows per lane and "
              "S / dP are m64n64 wgmma products");
constexpr int STAGES = 3;
constexpr int NTHREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DqSmem {
  static constexpr int CH = D / CHUNK_COLS;
  static constexpr int Q_CHUNK = BQ * ROW_BYTES;
  static constexpr int KV_CHUNK = BK * ROW_BYTES;
  static constexpr int KV_TILE = CH * KV_CHUNK;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + size_t(CH) * Q_CHUNK;
  static constexpr size_t k_off = do_off + size_t(CH) * Q_CHUNK;
  static constexpr size_t v_off = k_off + size_t(STAGES) * KV_TILE;
  static constexpr size_t kseg_off = v_off + size_t(STAGES) * KV_TILE;
  static constexpr size_t kind_off = kseg_off + size_t(STAGES) * BK * 4;
  static constexpr size_t qseg_off = kind_off + size_t(STAGES) * 8;
  static constexpr size_t quni_off = qseg_off + size_t(BQ) * 4;
  static constexpr size_t bar_off = quni_off + 8;
  static constexpr size_t bytes = bar_off + size_t(2 * STAGES + 1) * 8;
  static constexpr size_t alloc = bytes + 1024;   // to align the base
};

struct DqArgs {
  const float* lse;     // [B, H, T]
  const float* delta;   // [B, H, T]
  const int* q_seg;     // [B, T] or null
  const int* kv_seg;    // [B, S] or null
  __nv_bfloat16* dq;
  int H, KH, T, S;
  long long dq_sb, dq_st, dq_sh;
  float scale, softcap;
  int causal;
};

// dS of one tile, in place of dP, from S (raw Q K products) and dP.  Entry
// i of the accumulator layout sits on query row `hi ? t_hi : t_lo` (hi =
// (i / 2) % 2) and kv column k0 + 8 (i / 4) + col0 + i % 2.
template <bool MASKED>
__device__ __forceinline__ void grad_tile(
    const float (&st)[BK / 2], float (&dp)[BK / 2], const DqArgs& a,
    const int* kseg, int k0, int col0, int t_lo, int t_hi, int qs_lo,
    int qs_hi, float lse_lo, float lse_hi, float dl_lo, float dl_hi) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const bool hi = (i / 2) % 2;
    bool live = true;
    if (MASKED) {
      const int col = 8 * (i / 4) + col0 + (i % 2);
      const int ks = kseg[col];
      live = (hi ? qs_hi : qs_lo) == ks && ks != 0 &&
             (!a.causal || k0 + col <= (hi ? t_hi : t_lo));
    }
    float ds = 0.f;
    if (live) {
      const float x = st[i] * a.scale;
      float capped = x, chain = 1.f;
      if (a.softcap > 0.f) {
        const float th = tanhf(x / a.softcap);
        capped = th * a.softcap;
        chain = 1.f - th * th;
      }
      const float p = ex2(capped * LOG2E - (hi ? lse_hi : lse_lo));
      ds = p * (dp[i] - (hi ? dl_hi : dl_lo)) * chain * a.scale;
    }
    dp[i] = ds;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo, const DqArgs a) {
  using L = DqSmem<D>;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem + L::q_off;
  unsigned char* sDO = smem + L::do_off;
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
  __nv_bfloat16* dqb = a.dq + b * a.dq_sb + h * a.dq_sh;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);     // the loading warp's lanes
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
    // every query row of the tile is padding: dq = 0
    for (int i = tid; i < BQ * (D / 2); i += NTHREADS) {
      const int t = q0 + i / (D / 2), c = (i % (D / 2)) * 2;
      if (t < a.T)
        *reinterpret_cast<__nv_bfloat162*>(dqb + t * a.dq_st + c) =
            __floats2bfloat162_rn(0.f, 0.f);
    }
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
  const bool loader = tid < 32;   // warp 0 also issues the loads

  // kv tile j into stage j % STAGES, once both warpgroups have released
  // what the stage held (tile j - STAGES): its segment ids by the warp's
  // lanes, K and V by TMA unless the tile is all padding.
  auto produce = [&](int j) {
    const int s = j % STAGES;
    mbar_wait(&empty[s], ((j / STAGES) & 1) ^ 1);
    const int k0 = j * BK;
    const int v0 = seg_at(a.kv_seg, b, a.S, k0 + lane);
    const int v1 = seg_at(a.kv_seg, b, a.S, k0 + lane + 32);
    sKSeg[s * BK + lane] = v0;
    sKSeg[s * BK + lane + 32] = v1;
    int mn = min(v0, v1), mx = max(v0, v1);
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
  };

  if (loader) {
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, 2 * CH * L::Q_CHUNK);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(sQ + c * L::Q_CHUNK, &tq, qbar, c * CHUNK_COLS, h, q0, b);
        tma_load_4d(sDO + c * L::Q_CHUNK, &tdo, qbar, c * CHUNK_COLS, h, q0, b);
      }
    }
    for (int j = 0; j < min(STAGES - 1, n_kt); ++j) produce(j);
  }

  {
    // warpgroup wg owns query rows q0 + 64 wg ..
    const int warp = (tid / 32) % 4;
    const int r_lo = 64 * wg + 16 * warp + lane / 4;
    const int t_lo = q0 + r_lo, t_hi = t_lo + 8;
    const int qs_lo = sQSeg[r_lo], qs_hi = sQSeg[r_lo + 8];
    const int quni = sQUni[wg];
    const int wg_q0 = q0 + 64 * wg;
    const int col0 = 2 * (lane % 4);
    const uint32_t q_base = smem_u32(sQ) + wg * 64 * ROW_BYTES;
    const uint32_t do_base = smem_u32(sDO) + wg * 64 * ROW_BYTES;
    const long long rb = ((long long)b * a.H + h) * a.T;
    const float lse_lo = t_lo < a.T ? a.lse[rb + t_lo] * LOG2E : 0.f;
    const float lse_hi = t_hi < a.T ? a.lse[rb + t_hi] * LOG2E : 0.f;
    const float dl_lo = t_lo < a.T ? a.delta[rb + t_lo] : 0.f;
    const float dl_hi = t_hi < a.T ? a.delta[rb + t_hi] : 0.f;

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(qbar, 0);

    for (int j = 0; j < n_kt; ++j) {
      const int s = j % STAGES;
      mbar_wait(&full[s], (j / STAGES) & 1);
      const int kind = sKind[2 * s], kval = sKind[2 * s + 1];
      const int k0 = j * BK;
      // no live pair for this warpgroup: keys that are all padding, query
      // rows that are all padding, or a kv tile wholly above the diagonal
      const bool none = kind == TILE_SKIP || quni == 0 ||
                        (a.causal && k0 > wg_q0 + 63);
      if (!none) {
        float st[BK / 2], dp[BK / 2];
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) st[i] = dp[i] = 0.f;
        const uint32_t k_base = smem_u32(sK) + s * L::KV_TILE;
        const uint32_t v_base = smem_u32(sV) + s * L::KV_TILE;
        fence_regs(st);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(st, desc_kmajor(q_base + c * L::Q_CHUNK + kk * 32),
                         desc_kmajor(k_base + c * L::KV_CHUNK + kk * 32),
                         c + kk > 0);
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64(dp, desc_kmajor(do_base + c * L::Q_CHUNK + kk * 32),
                         desc_kmajor(v_base + c * L::KV_CHUNK + kk * 32),
                         c + kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);

        const bool dense = kind == TILE_UNIFORM && quni == kval &&
                           (!a.causal || k0 + BK - 1 <= wg_q0);
        const int* kseg = sKSeg + s * BK;
        if (dense)
          grad_tile<false>(st, dp, a, kseg, k0, col0, t_lo, t_hi, qs_lo,
                           qs_hi, lse_lo, lse_hi, dl_lo, dl_hi);
        else
          grad_tile<true>(st, dp, a, kseg, k0, col0, t_lo, t_hi, qs_lo,
                          qs_hi, lse_lo, lse_hi, dl_lo, dl_hi);

        // ds to bf16 before ds K (flash_attention.py:257)
        uint32_t dsa[BK / 16][4];
        pack_a(dp, dsa);
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_tb<D>(dq, dsa[kk],
                         desc_mnmajor(k_base + kk * 16 * ROW_BYTES, L::KV_CHUNK));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(dsa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      // keep STAGES - 1 tiles in flight ahead of the one computed next
      if (loader && j + STAGES - 1 < n_kt) produce(j + STAGES - 1);
    }

#pragma unroll
    for (int j8 = 0; j8 < D / 8; ++j8) {
      const int c = 8 * j8 + col0;
      if (t_lo < a.T)
        *reinterpret_cast<__nv_bfloat162*>(dqb + t_lo * a.dq_st + c) =
            __floats2bfloat162_rn(dq[4 * j8], dq[4 * j8 + 1]);
      if (t_hi < a.T)
        *reinterpret_cast<__nv_bfloat162*>(dqb + t_hi * a.dq_st + c) =
            __floats2bfloat162_rn(dq[4 * j8 + 2], dq[4 * j8 + 3]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const DqArgs& args, int B, const long long* st,
              cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const int H = args.H, KH = args.KH, T = args.T, S = args.S;
  int err = make_bthd_map(&tq, q, B, T, H, D, st[0], st[1], st[2], BQ);
  if (!err) err = make_bthd_map(&tk, k, B, S, KH, D, st[3], st[4], st[5], BK);
  if (!err) err = make_bthd_map(&tv, v, B, S, KH, D, st[6], st[7], st[8], BK);
  if (!err) err = make_bthd_map(&tdo, dout, B, T, H, D, st[9], st[10], st[11],
                                BQ);
  if (err) return err;
  const size_t smem = DqSmem<D>::alloc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(H, B, (T + BQ - 1) / BQ);
  flash_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(tq, tk, tv, tdo, args);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 21 element strides, (batch, seq, head) for q, k, v, dO, dq and
// two unused triples (the layout llavamod_flash_dkv takes).  lse and delta
// are contiguous [B, H, T] f32.  softcap <= 0 means none.  Returns a
// cudaError_t (0 = launched).
extern "C" int llavamod_flash_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, const int* q_seg,
                                 const int* kv_seg, void* dq, int B, int H,
                                 int KH, int T, int S, int D,
                                 const long long* st, float scale,
                                 float softcap, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DqArgs args{lse, delta, q_seg, kv_seg,
                    static_cast<__nv_bfloat16*>(dq), H, KH, T, S,
                    st[12], st[13], st[14], scale, softcap, causal};
  if (D == 64) return launch_dq<64>(q, k, v, dout, args, B, st, s);
  if (D == 128) return launch_dq<128>(q, k, v, dout, args, B, st, s);
  return (int)cudaErrorInvalidValue;
}
