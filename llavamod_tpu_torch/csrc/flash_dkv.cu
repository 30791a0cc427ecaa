// K4: flash-attention backward dk and dv for Hopper (sm_90a), bf16 in /
// bf16 out, f32 accumulation.
//
// Replaces llavamod_tpu/ops/flash_attention.py::_dkv_kernel (launched by
// _bwd).  It recomputes the probability tile p = exp(softcap(s) - lse) from
// q, k and the forward's saved logsumexp, so the [T, S] score matrix never
// reaches device memory, and takes delta = rowsum(dO * O) from the wrapper:
//
//   dp = dO V^T (f32),  ds = p * (dp - delta) * softcap'(s) * scale
//   dv = sum_{i, g} p^T dO       (p cast to bf16 first)
//   dk = sum_{i, g} ds^T Q       (ds cast to bf16 first)
//
// with softcap'(s) = 1 - tanh^2(s_raw / c) on the RAW scaled score.
//
// What bounds it on an H100: at the training shape (B=1, T=S=2048,
// H=KH=16, D=128, causal) it does 34.4 GFLOP (4 products per live pair)
// against ~25 MB in and out: far above the ~295 FLOP/byte ridge, so bound
// by the tensor cores.
//
// Design:
//   * one CTA of 256 threads per (128 kv rows, kv head, batch): two
//     warpgroups own 64 kv rows each.  K and V are loaded once by TMA; 32-row
//     tiles of Q and dO stream through a 3-stage TMA / mbarrier ring, with
//     lse (in log2 units), delta and the query segment ids of the tile
//     beside them, refilled two tiles ahead by warp 0 right after it
//     releases its own stage.  There is no separate producer warp: a third
//     warpgroup would cap every thread at 168 registers, and each thread's
//     dk, dv, S^T and dP^T (2 x 64 + 2 x 16 f32 at D = 128) need ~210, with
//     no spills and no serialised wgmma;
//   * the walk is the TPU kernel's: the GQA group's query heads, and in each
//     the q tiles from the causal diagonal on, in a fixed order inside one
//     CTA, so the sums are deterministic and need no atomics;
//   * S^T = K Q^T and dP^T = V dO^T are wgmmas with both operands K-major in
//     shared memory (128-byte swizzle) into registers; P^T and dS^T are
//     formed in registers, reading lse and delta per column from shared
//     memory; dV += P^T dO and dK += dS^T Q are wgmmas whose A operand is
//     P^T or dS^T packed to bf16 in registers and whose B operand (dO, Q) is
//     MN-major with the transpose bit.  dk and dv stay in registers for the
//     whole walk (2 x D / 2 f32 per thread) and are written once as bf16;
//     nothing goes through shared memory as f32;
//   * masking is one rule: (q, k) is live iff qseg == kseg != 0 and (!causal
//     || k <= q); rows and keys past the sequence are segment 0.  p is never
//     formed on a dead pair, so a fully masked query row (lse = NEG_INF)
//     contributes 0, not inf * 0.  A q tile that is all padding is neither
//     loaded nor computed, a warpgroup skips q tiles entirely above the
//     causal diagonal or with none of its keys live, and only tiles on the
//     diagonal or with mixed segment ids pay for the mask;
//   * tensors are read through strides from the [B, T, H, D] API layout by
//     4-D tensor maps; GQA maps query head h to kv head h / (H / KH).

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BKV = 128;         // kv rows per CTA (2 warpgroups x 64)
constexpr int BQT = 32;          // query rows per streamed tile: one a lane
static_assert(BQT == 32, "the loading warp fills one q row per lane and "
              "S^T / dP^T are m64n32 wgmma products");
constexpr int STAGES = 3;
// two warpgroups and no third: registers are granted per warpgroup, so a
// third (even a lone producer warp) caps every thread at 168, and ptxas
// compiles the consumers to that cap whatever setmaxnreg hands out later;
// dk and dv (2 x D / 2 f32) beside the score tiles need ~210
constexpr int NTHREADS = 256;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DkvSmem {
  static constexpr int CH = D / CHUNK_COLS;
  static constexpr int KV_CHUNK = BKV * ROW_BYTES;
  static constexpr int Q_CHUNK = BQT * ROW_BYTES;
  static constexpr int Q_TILE = CH * Q_CHUNK;
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + size_t(CH) * KV_CHUNK;
  static constexpr size_t q_off = v_off + size_t(CH) * KV_CHUNK;
  static constexpr size_t do_off = q_off + size_t(STAGES) * Q_TILE;
  static constexpr size_t qseg_off = do_off + size_t(STAGES) * Q_TILE;
  static constexpr size_t lse_off = qseg_off + size_t(STAGES) * BQT * 4;
  static constexpr size_t delta_off = lse_off + size_t(STAGES) * BQT * 4;
  static constexpr size_t kind_off = delta_off + size_t(STAGES) * BQT * 4;
  static constexpr size_t kseg_off = kind_off + size_t(STAGES) * 8;
  static constexpr size_t kuni_off = kseg_off + size_t(BKV) * 4;
  static constexpr size_t bar_off = kuni_off + 8;
  static constexpr size_t bytes = bar_off + size_t(2 * STAGES + 1) * 8;
  static constexpr size_t alloc = bytes + 1024;   // to align the base
};

struct DkvArgs {
  const float* lse;     // [B, H, T]
  const float* delta;   // [B, H, T]
  const int* q_seg;     // [B, T] or null
  const int* kv_seg;    // [B, S] or null
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, KH, T, S;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
  float scale, softcap;
  int causal;
};

// P^T and dS^T of one tile, in place of S^T (raw Q K products) and dP^T.
// Entry i of the accumulator layout sits on kv row `hi ? s_hi : s_lo` (hi =
// (i / 2) % 2) and query column q0 + 8 (i / 4) + col0 + i % 2.
template <bool MASKED>
__device__ __forceinline__ void grad_tile(
    float (&st)[BQT / 2], float (&dp)[BQT / 2], const DkvArgs& a,
    const float* lse2, const float* delta, const int* qseg, int q0, int col0,
    int s_lo, int s_hi, int ks_lo, int ks_hi) {
#pragma unroll
  for (int i = 0; i < BQT / 2; ++i) {
    const int col = 8 * (i / 4) + col0 + (i % 2);
    bool live = true;
    if (MASKED) {
      const bool hi = (i / 2) % 2;
      const int ks = hi ? ks_hi : ks_lo;
      live = qseg[col] == ks && ks != 0 &&
             (!a.causal || (hi ? s_hi : s_lo) <= q0 + col);
    }
    float p = 0.f, ds = 0.f;
    if (live) {
      const float x = st[i] * a.scale;
      float capped = x, chain = 1.f;
      if (a.softcap > 0.f) {
        const float th = tanhf(x / a.softcap);
        capped = th * a.softcap;
        chain = 1.f - th * th;
      }
      p = ex2(capped * LOG2E - lse2[col]);
      ds = p * (dp[i] - delta[col]) * chain * a.scale;
    }
    st[i] = p;
    dp[i] = ds;
  }
}

template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs,
                                           const float (&acc)[D / 2],
                                           int s_lo, int s_hi, int S,
                                           int col0) {
#pragma unroll
  for (int j8 = 0; j8 < D / 8; ++j8) {
    const int c = 8 * j8 + col0;
    if (s_lo < S)
      *reinterpret_cast<__nv_bfloat162*>(base + s_lo * rs + c) =
          __floats2bfloat162_rn(acc[4 * j8], acc[4 * j8 + 1]);
    if (s_hi < S)
      *reinterpret_cast<__nv_bfloat162*>(base + s_hi * rs + c) =
          __floats2bfloat162_rn(acc[4 * j8 + 2], acc[4 * j8 + 3]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, const DkvArgs a) {
  using L = DkvSmem<D>;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem + L::k_off;
  unsigned char* sV = smem + L::v_off;
  unsigned char* sQ = smem + L::q_off;
  unsigned char* sDO = smem + L::do_off;
  int* sQSeg = reinterpret_cast<int*>(smem + L::qseg_off);      // [STAGES][BQT]
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);    // log2 units
  float* sDelta = reinterpret_cast<float*>(smem + L::delta_off);
  int* sKind = reinterpret_cast<int*>(smem + L::kind_off);      // [STAGES][2]
  int* sKSeg = reinterpret_cast<int*>(smem + L::kseg_off);      // [BKV]
  int* sKUni = reinterpret_cast<int*>(smem + L::kuni_off);      // [2]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bar_off);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;   // early kv tiles see the most q tiles
  const int g = a.H / a.KH;
  const int tid = threadIdx.x;
  __nv_bfloat16* dkb = a.dk + b * a.dk_sb + kvh * a.dk_sh;
  __nv_bfloat16* dvb = a.dv + b * a.dv_sb + kvh * a.dv_sh;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);     // the loading warp's lanes
      mbar_init(&empty[s], 8);     // the consumer warps
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  int ks = 0;
  if (tid < BKV) {
    ks = seg_at(a.kv_seg, b, a.S, k0 + tid);
    sKSeg[tid] = ks;
  }
  if (!__syncthreads_or(ks != 0)) {
    // no key of the tile is seen by any query: dk = dv = 0
    for (int i = tid; i < BKV * (D / 2); i += NTHREADS) {
      const int s = k0 + i / (D / 2), c = (i % (D / 2)) * 2;
      if (s < a.S) {
        const __nv_bfloat162 z = __floats2bfloat162_rn(0.f, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(dkb + s * a.dk_ss + c) = z;
        *reinterpret_cast<__nv_bfloat162*>(dvb + s * a.dv_ss + c) = z;
      }
    }
    return;
  }
  if (tid < 64) {   // per consumer warpgroup: one kv segment id or MIXED
    const int w = tid / 32, lane = tid % 32;
    int mn = min(sKSeg[64 * w + lane], sKSeg[64 * w + lane + 32]);
    int mx = max(sKSeg[64 * w + lane], sKSeg[64 * w + lane + 32]);
    warp_min_max(mn, mx);
    if (lane == 0) sKUni[w] = mn == mx ? mn : MIXED;
  }
  __syncthreads();

  const int nq = (a.T + BQT - 1) / BQT;
  const int i_start = a.causal ? min(k0 / BQT, nq) : 0;  // first q tile with a row >= k0
  const int per_head = nq - i_start;
  const int n_items = g * per_head;
  const int wg = tid / 128;
  const int lane = tid % 32;
  const bool loader = tid < 32;   // warp 0 also issues the loads

  // Item `it` (a q tile of one head) into stage it % STAGES, once both
  // warpgroups have released what the stage held (item it - STAGES): the
  // tile's segment ids, lse and delta by the warp's lanes, Q and dO by TMA.
  auto produce = [&](int it) {
    const int h = kvh * g + it / per_head;
    const int q0 = (i_start + it % per_head) * BQT;
    const int s = it % STAGES;
    mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
    const int t = q0 + lane;   // BQT == 32: one row per lane
    const long long row = ((long long)b * a.H + h) * a.T + t;
    const int qs = seg_at(a.q_seg, b, a.T, t);
    sQSeg[s * BQT + lane] = qs;
    sLse[s * BQT + lane] = t < a.T ? a.lse[row] * LOG2E : 0.f;
    sDelta[s * BQT + lane] = t < a.T ? a.delta[row] : 0.f;
    int mn = qs, mx = qs;
    warp_min_max(mn, mx);
    const int kind = tile_kind(mn, mx);
    if (lane == 0) {
      sKind[2 * s] = kind;
      sKind[2 * s + 1] = mn;
      mbar_arrive_expect_tx(&full[s], kind == TILE_SKIP ? 0 : 2 * L::Q_TILE);
      if (kind != TILE_SKIP) {
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(sQ + s * L::Q_TILE + c * L::Q_CHUNK, &tq, &full[s],
                      c * CHUNK_COLS, h, q0, b);
          tma_load_4d(sDO + s * L::Q_TILE + c * L::Q_CHUNK, &tdo, &full[s],
                      c * CHUNK_COLS, h, q0, b);
        }
      }
    } else {
      mbar_arrive(&full[s]);
    }
  };

  if (loader) {
    if (lane == 0) {
      mbar_arrive_expect_tx(kvbar, 2 * CH * L::KV_CHUNK);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(sK + c * L::KV_CHUNK, &tk, kvbar, c * CHUNK_COLS, kvh, k0, b);
        tma_load_4d(sV + c * L::KV_CHUNK, &tv, kvbar, c * CHUNK_COLS, kvh, k0, b);
      }
    }
    for (int it = 0; it < min(STAGES - 1, n_items); ++it) produce(it);
  }

  {
    // warpgroup wg owns kv rows k0 + 64 wg ..
    const int warp = (tid / 32) % 4;
    const int r_lo = 64 * wg + 16 * warp + lane / 4;
    const int s_lo = k0 + r_lo, s_hi = s_lo + 8;
    const int ks_lo = sKSeg[r_lo], ks_hi = sKSeg[r_lo + 8];
    const int kuni = sKUni[wg];
    const int wg_k0 = k0 + 64 * wg;
    const int col0 = 2 * (lane % 4);
    const uint32_t k_base = smem_u32(sK) + wg * 64 * ROW_BYTES;
    const uint32_t v_base = smem_u32(sV) + wg * 64 * ROW_BYTES;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kvbar, 0);

    for (int it = 0; it < n_items; ++it) {
      const int q0 = (i_start + it % per_head) * BQT;
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const int kind = sKind[2 * s], kval = sKind[2 * s + 1];
      // no live pair for this warpgroup: an all-pad q tile, keys that are
      // all padding, or a q tile wholly above the causal diagonal
      const bool none = kind == TILE_SKIP || kuni == 0 ||
                        (a.causal && q0 + BQT - 1 < wg_k0);
      if (!none) {
        float st[BQT / 2], dp[BQT / 2];
#pragma unroll
        for (int i = 0; i < BQT / 2; ++i) st[i] = dp[i] = 0.f;
        const uint32_t q_base = smem_u32(sQ) + s * L::Q_TILE;
        const uint32_t do_base = smem_u32(sDO) + s * L::Q_TILE;
        fence_regs(st);
        fence_regs(dp);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n32(st, desc_kmajor(k_base + c * L::KV_CHUNK + kk * 32),
                         desc_kmajor(q_base + c * L::Q_CHUNK + kk * 32),
                         c + kk > 0);
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n32(dp, desc_kmajor(v_base + c * L::KV_CHUNK + kk * 32),
                         desc_kmajor(do_base + c * L::Q_CHUNK + kk * 32),
                         c + kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);

        const bool dense = kind == TILE_UNIFORM && kuni == kval &&
                           (!a.causal || wg_k0 + 63 <= q0);
        const float* lse2 = sLse + s * BQT;
        const float* delta = sDelta + s * BQT;
        const int* qseg = sQSeg + s * BQT;
        if (dense)
          grad_tile<false>(st, dp, a, lse2, delta, qseg, q0, col0, s_lo, s_hi,
                           ks_lo, ks_hi);
        else
          grad_tile<true>(st, dp, a, lse2, delta, qseg, q0, col0, s_lo, s_hi,
                          ks_lo, ks_hi);

        // p and ds to bf16 before p^T dO and ds^T Q
        uint32_t pa[BQT / 16][4], dsa[BQT / 16][4];
        pack_a(st, pa);
        pack_a(dp, dsa);
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BQT / 16; ++kk)
          wgmma_rs_tb<D>(dv, pa[kk],
                     desc_mnmajor(do_base + kk * 16 * ROW_BYTES, L::Q_CHUNK));
#pragma unroll
        for (int kk = 0; kk < BQT / 16; ++kk)
          wgmma_rs_tb<D>(dk, dsa[kk],
                     desc_mnmajor(q_base + kk * 16 * ROW_BYTES, L::Q_CHUNK));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(dsa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
      // keep STAGES - 1 items in flight ahead of the one computed next
      if (loader && it + STAGES - 1 < n_items) produce(it + STAGES - 1);
    }

    store_rows<D>(dkb, a.dk_ss, dk, s_lo, s_hi, a.S, col0);
    store_rows<D>(dvb, a.dv_ss, dv, s_lo, s_hi, a.S, col0);
  }
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const DkvArgs& args, int B, const long long* st,
               cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  const int H = args.H, KH = args.KH, T = args.T, S = args.S;
  int err = make_bthd_map(&tq, q, B, T, H, D, st[0], st[1], st[2], BQT);
  if (!err) err = make_bthd_map(&tk, k, B, S, KH, D, st[3], st[4], st[5], BKV);
  if (!err) err = make_bthd_map(&tv, v, B, S, KH, D, st[6], st[7], st[8], BKV);
  if (!err) err = make_bthd_map(&tdo, dout, B, T, H, D, st[9], st[10], st[11],
                                BQT);
  if (err) return err;
  const size_t smem = DkvSmem<D>::alloc;
  cudaError_t e = cudaFuncSetAttribute(
      flash_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(KH, B, (S + BKV - 1) / BKV);
  flash_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(tq, tk, tv, tdo, args);
  return (int)cudaGetLastError();
}

}  // namespace

// strides: 21 element strides, (batch, seq, head) for q, k, v, dO, (unused),
// dk and dv.  lse and delta are contiguous [B, H, T] f32.  softcap <= 0
// means none.  Returns a cudaError_t (0 = launched).
extern "C" int llavamod_flash_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, const int* q_seg,
                                  const int* kv_seg, void* dk, void* dv, int B,
                                  int H, int KH, int T, int S, int D,
                                  const long long* st, float scale,
                                  float softcap, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const DkvArgs args{lse, delta, q_seg, kv_seg,
                     static_cast<__nv_bfloat16*>(dk),
                     static_cast<__nv_bfloat16*>(dv), H, KH, T, S,
                     st[15], st[16], st[17], st[18], st[19], st[20],
                     scale, softcap, causal};
  if (D == 64) return launch_dkv<64>(q, k, v, dout, args, B, st, s);
  if (D == 128) return launch_dkv<128>(q, k, v, dout, args, B, st, s);
  return (int)cudaErrorInvalidValue;
}
