// K3: flash-attention backward dq for Hopper (sm_90a), bf16 in / bf16
// out, f32 accumulation.  (K4, dk and dv, is csrc/flash_dkv.cu.)
//
// Replaces llavamod_tpu/ops/flash_attention.py::_dq_kernel (launched by
// _bwd): it recomputes the probability tile p = exp(softcap(s) - lse) from
// q, k and the forward's saved logsumexp, so the [T, S] score matrix never
// reaches device memory, and uses delta = rowsum(dO * O) (computed by the
// wrapper, as _bwd does in XLA):
//
//   dp = dO V^T (f32),  ds = p * (dp - delta) * softcap'(s) * scale
//   dq = sum_j ds_j K_j         (ds cast to bf16 first)
//
// with softcap'(s) = 1 - tanh^2(s_raw / c) on the RAW scaled score.
//
// What bounds it on an H100: at the training shape (B=1, T=S=2048,
// H=KH=16, D=128, causal) it does 25.8 GFLOP (3 products per live pair)
// against ~21 MB of q/k/v/dO/lse/delta in and dq out: far above the ~295
// FLOP/byte ridge, so bound by tensor-core throughput and, in this first
// version, by shared-memory traffic around WMMA.
//
// Design (simple and correct first; the wgmma/TMA redesign of K1 and K4 in
// hopper.cuh is the model for its next version):
//   * no atomics, deterministic, as the TPU kernel: one block of 4 warps per
//     (q tile of 64 rows, head, batch) loops over the kv tiles, skipping
//     those that causality masks out whole;
//   * each warp owns 16 q rows; products run through WMMA 16x16x16 bf16
//     fragments with f32 accumulation; the f32 score and dp tiles go through
//     shared memory so the elementwise ds step is plain indexed arithmetic;
//     the dq accumulator stays in fragments (16 x D per warp);
//   * masking is one rule: a row or column past the sequence gets segment
//     0, and (q, k) is live iff qseg == kseg != 0 and (!causal || k <= q).
//     p is never formed on a dead pair, so a fully masked row (lse =
//     NEG_INF) gives p = 0, not inf * 0: padded query rows get dq = 0;
//   * tensors are read and written through strides from the [B, T, H, D]
//     API layout, as in K1; GQA maps query head h to kv head h / (H / KH).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // kv rows per tile
constexpr int NWARPS = 4;       // each warp owns 16 rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int VEC = 8;          // bf16 per 16-byte vector

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> FragB;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

struct Strides {
  long long q_sb, q_st, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_st, o_sh;     // dO
  long long dq_sb, dq_st, dq_sh;
  long long dk_sb, dk_ss, dk_sh;
  long long dv_sb, dv_ss, dv_sh;
};

template <int D>
struct Pitch {
  // Row pitches (elements).  The pads break shared-memory bank conflicts
  // and keep every WMMA tile pointer 32-byte aligned.
  static constexpr int LDQ = D + 8;    // bf16 q, k, v, dO tiles
  static constexpr int LDS = 64 + 4;   // f32 score / dp tiles (64 columns)
  static constexpr int LDP = 64 + 8;   // bf16 p / ds tiles
  static constexpr int LDO = D + 4;    // f32 accumulators
};

// 64 rows x D of bf16 from global (row stride `rs`, 16-byte vectors) into a
// shared tile; rows at or past `n` are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int r0, int n) {
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n)
      val = *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * Pitch<D>::LDQ + c) = val;
  }
}

// out[16 x 64] (f32, pitch LDS) = A[16 x D] B^T where B is 64 x D row-major
// in shared memory (read as a col-major D x 64 operand).
template <int D>
__device__ __forceinline__ void mm_abt(float* out, const __nv_bfloat16* a,
                                       const __nv_bfloat16* b) {
  using P = Pitch<D>;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + kk * 16, P::LDQ);
      wmma::load_matrix_sync(fb, b + n * 16 * P::LDQ + kk * 16, P::LDQ);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, P::LDS, wmma::mem_row_major);
  }
}

// Write 64 x D f32 rows (pitch LDO) as bf16 to global rows r0.. (< n).
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long rs,
                                           const float* src, int r0, int n) {
  for (int i = threadIdx.x; i < 64 * (D / 2); i += NTHREADS) {
    const int r = i / (D / 2), c = (i % (D / 2)) * 2;
    if (r0 + r < n) {
      const float* s = src + r * Pitch<D>::LDO + c;
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)(r0 + r) * rs + c) =
          __floats2bfloat162_rn(s[0], s[1]);
    }
  }
}

__device__ __forceinline__ int seg_at(const int* seg, int b, int n, int i) {
  return i < n ? (seg ? seg[(long long)b * n + i] : 1) : 0;
}

// ds for one live (q, k) pair from its raw score product and dp.
__device__ __forceinline__ float grad_score(float qk, float dp, float lse,
                                            float delta, float scale,
                                            float softcap, float* p_out) {
  const float s = qk * scale;
  float capped = s, chain = 1.f;
  if (softcap > 0.f) {
    const float th = tanhf(s / softcap);
    capped = th * softcap;
    chain = 1.f - th * th;
  }
  const float p = __expf(capped - lse);
  *p_out = p;
  return p * (dp - delta) * chain * scale;
}

// ---------------------------------------------------------------------------
// K3: dq
// ---------------------------------------------------------------------------

template <int D>
struct DqLayout {
  using P = Pitch<D>;
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + size_t(BQ) * P::LDQ * 2;
  static constexpr size_t k_off = do_off + size_t(BQ) * P::LDQ * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * P::LDQ * 2;
  static constexpr size_t s_off = v_off + size_t(BK) * P::LDQ * 2;
  static constexpr size_t dp_off = s_off + size_t(BQ) * P::LDS * 4;
  static constexpr size_t ds_off = dp_off + size_t(BQ) * P::LDS * 4;
  static constexpr size_t lse_off = ds_off + size_t(BQ) * P::LDP * 2;
  static constexpr size_t delta_off = lse_off + size_t(BQ) * 4;
  static constexpr size_t qseg_off = delta_off + size_t(BQ) * 4;
  static constexpr size_t kseg_off = qseg_off + size_t(BQ) * 4;
  static constexpr size_t bytes = kseg_off + size_t(BK) * 4;
  // the f32 dq staging tile reuses the q and dO tiles after the loop
  static_assert(size_t(BQ) * P::LDO * 4 <= k_off, "dq staging overflows");
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const __nv_bfloat16* __restrict__ dout,
                const float* __restrict__ lse,     // [B, H, T]
                const float* __restrict__ delta,   // [B, H, T]
                const int* __restrict__ q_seg, const int* __restrict__ kv_seg,
                __nv_bfloat16* __restrict__ dq, int H, int KH, int T, int S,
                Strides st, float scale, float softcap, int causal) {
  using P = Pitch<D>;
  using L = DqLayout<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sDO = reinterpret_cast<__nv_bfloat16*>(smem + L::do_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  float* sDP = reinterpret_cast<float*>(smem + L::dp_off);
  __nv_bfloat16* sDS = reinterpret_cast<__nv_bfloat16*>(smem + L::ds_off);
  float* sLse = reinterpret_cast<float*>(smem + L::lse_off);
  float* sDelta = reinterpret_cast<float*>(smem + L::delta_off);
  int* sQSeg = reinterpret_cast<int*>(smem + L::qseg_off);
  int* sKSeg = reinterpret_cast<int*>(smem + L::kseg_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KH);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  load_tile<D>(sQ, q + b * st.q_sb + h * st.q_sh, st.q_st, q0, T);
  load_tile<D>(sDO, dout + b * st.o_sb + h * st.o_sh, st.o_st, q0, T);
  if (tid < BQ) {
    const int t = q0 + tid;
    const long long row = ((long long)b * H + h) * T + t;
    sLse[tid] = t < T ? lse[row] : 0.f;
    sDelta[tid] = t < T ? delta[row] : 0.f;
    sQSeg[tid] = seg_at(q_seg, b, T, t);
  }

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  const __nv_bfloat16* kb = k + b * st.k_sb + kvh * st.k_sh;
  const __nv_bfloat16* vb = v + b * st.v_sb + kvh * st.v_sh;
  // lane pair (2r, 2r+1) of a warp owns row r of the warp's 16 rows
  const int prow = warp * 16 + (lane >> 1);
  const int half = lane & 1;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(sK, kb, st.k_ss, k0, S);
    load_tile<D>(sV, vb, st.v_ss, k0, S);
    if (tid < BK) sKSeg[tid] = seg_at(kv_seg, b, S, k0 + tid);
    __syncthreads();

    mm_abt<D>(sS + warp * 16 * P::LDS, sQ + warp * 16 * P::LDQ, sK);
    mm_abt<D>(sDP + warp * 16 * P::LDS, sDO + warp * 16 * P::LDQ, sV);
    __syncwarp();

    {
      const int t = q0 + prow;
      const int qs = sQSeg[prow];
      const float l = sLse[prow], dl = sDelta[prow];
      const float* srow = sS + prow * P::LDS;
      const float* dprow = sDP + prow * P::LDS;
      __nv_bfloat16* dsrow = sDS + prow * P::LDP;
#pragma unroll 8
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const int ks = sKSeg[c];
        const bool ok = qs == ks && ks != 0 && (!causal || k0 + c <= t);
        float p, ds = 0.f;
        if (ok) ds = grad_score(srow[c], dprow[c], l, dl, scale, softcap, &p);
        dsrow[c] = __float2bfloat16(ds);
      }
    }
    __syncwarp();

    // dq += ds K   (K tile row-major [BK, D])
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, sDS + warp * 16 * P::LDP + kk * 16, P::LDP);
        wmma::load_matrix_sync(fb, sK + kk * 16 * P::LDQ + n * 16, P::LDQ);
        wmma::mma_sync(acc[n], fa, fb, acc[n]);
      }
    }
  }

  __syncthreads();  // the staging tile overwrites sQ / sDO
  float* stage = reinterpret_cast<float*>(smem + L::q_off);
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + warp * 16 * P::LDO + n * 16, acc[n],
                            P::LDO, wmma::mem_row_major);
  __syncthreads();
  store_rows<D>(dq + b * st.dq_sb + h * st.dq_sh, st.dq_st, stage, q0, T);
}

Strides unpack(const long long* s) {
  return Strides{s[0],  s[1],  s[2],  s[3],  s[4],  s[5],  s[6],
                 s[7],  s[8],  s[9],  s[10], s[11], s[12], s[13],
                 s[14], s[15], s[16], s[17], s[18], s[19], s[20]};
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, const int* q_seg,
              const int* kv_seg, void* dq, int B, int H, int KH, int T, int S,
              const Strides& st, float scale, float softcap, int causal,
              cudaStream_t stream) {
  const size_t smem = DqLayout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), lse, delta, q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(dq), H, KH, T, S, st, scale, softcap, causal);
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
                                 const long long* strides, float scale,
                                 float softcap, int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st = unpack(strides);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, H,
                         KH, T, S, st, scale, softcap, causal, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, q_seg, kv_seg, dq, B, H,
                          KH, T, S, st, scale, softcap, causal, s);
  return (int)cudaErrorInvalidValue;
}
