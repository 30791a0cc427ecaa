// K1: flash-attention forward for Hopper (sm_90a), bf16 in / bf16 out.
//
// Replaces llavamod_tpu/ops/flash_attention.py::_fwd_kernel (launched by
// _fwd): tiled online-softmax attention that never writes the [T, S] score
// matrix to device memory.
//
// What bounds it on an H100: at the serving prefill shape (B=8, T=S=1024,
// H=KH=16, D=128, causal) the work is ~34 GFLOP per layer against ~100 MB of
// q/k/v/o traffic, i.e. far above the ~295 FLOP/byte ridge: it is bound by
// matrix-unit throughput and, in this first version, by shared-memory
// traffic around the matrix unit.
//
// Design (simple and correct first; wgmma/TMA/pipelining come later):
//   * one block of 4 warps per (q tile of 64 rows, head, batch); each warp
//     owns 16 query rows.  The TPU kernel's sequential kv grid axis becomes
//     a loop inside the block, which stops at the causal diagonal;
//   * Q K^T and P V run on the tensor cores through WMMA 16x16x16 bf16
//     fragments with f32 accumulation; Q fragments stay in registers;
//   * scores, the bf16 probabilities and the f32 output accumulator live in
//     shared memory so that the per-row online-softmax rescale is plain
//     indexed arithmetic (WMMA fragments hide their row mapping);
//   * masked probabilities are zeroed AFTER the exp: NEG_INF is finite, so
//     an all-masked tile has m_new = NEG_INF and exp(s - m_new) = 1
//     (flash_attention.py:110-115).  A fully masked row (a left-pad query,
//     segment 0) writes output 0 and lse NEG_INF (:125-130);
//   * q/k/v are read through strides from the [B, T, H, D] API layout, so no
//     transpose copy is made; GQA maps query head h to kv head h*KH/H.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // kv rows per tile
constexpr int NWARPS = BQ / 16;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

template <int D>
struct Layout {
  // Row pitches (elements).  The +8 / +4 pads break shared-memory bank
  // conflicts while keeping every WMMA tile pointer 32-byte aligned.
  static constexpr int LDQ = D + 8;    // bf16 q, k, v tiles
  static constexpr int LDS = BK + 4;   // f32 scores
  static constexpr int LDP = BK + 8;   // bf16 probabilities
  static constexpr int LDO = D + 4;    // f32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + size_t(BQ) * LDQ * 2;
  static constexpr size_t v_off = k_off + size_t(BK) * LDQ * 2;
  static constexpr size_t s_off = v_off + size_t(BK) * LDQ * 2;
  static constexpr size_t p_off = s_off + size_t(BQ) * LDS * 4;
  static constexpr size_t o_off = p_off + size_t(BQ) * LDP * 2;
  static constexpr size_t m_off = o_off + size_t(BQ) * LDO * 4;
  static constexpr size_t l_off = m_off + size_t(BQ) * 4;
  static constexpr size_t qseg_off = l_off + size_t(BQ) * 4;
  static constexpr size_t kseg_off = qseg_off + size_t(BQ) * 4;
  static constexpr size_t bytes = kseg_off + size_t(BK) * 4;
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 const int* __restrict__ q_seg,    // [B, T] or null
                 const int* __restrict__ kv_seg,   // [B, S] or null
                 __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse,          // [B, H, T]
                 int H, int KH, int T, int S,
                 long long q_sb, long long q_st, long long q_sh,
                 long long k_sb, long long k_ss, long long k_sh,
                 long long v_sb, long long v_ss, long long v_sh,
                 long long o_sb, long long o_st, long long o_sh,
                 float scale, float softcap, int causal) {
  using L = Layout<D>;
  constexpr int VEC = 8;            // bf16 per 16-byte vector
  constexpr int VPR = D / VEC;      // vectors per row
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem + L::q_off);
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem + L::k_off);
  __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(smem + L::v_off);
  float* sS = reinterpret_cast<float*>(smem + L::s_off);
  __nv_bfloat16* sP = reinterpret_cast<__nv_bfloat16*>(smem + L::p_off);
  float* sO = reinterpret_cast<float*>(smem + L::o_off);
  float* sM = reinterpret_cast<float*>(smem + L::m_off);
  float* sL = reinterpret_cast<float*>(smem + L::l_off);
  int* sQSeg = reinterpret_cast<int*>(smem + L::qseg_off);
  int* sKSeg = reinterpret_cast<int*>(smem + L::kseg_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * KH / H;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;

  // Q tile (zero rows past T), output accumulator, softmax state.  A row or
  // column past the sequence gets segment 0, which masks it; without segment
  // ids every real row and column is segment 1.
  for (int i = tid; i < BQ * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    const int t = q0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (t < T) val = *reinterpret_cast<const uint4*>(qb + t * q_st + c);
    *reinterpret_cast<uint4*>(sQ + r * L::LDQ + c) = val;
  }
  for (int i = tid; i < BQ * L::LDO; i += NTHREADS) sO[i] = 0.f;
  if (tid < BQ) {
    const int t = q0 + tid;
    sM[tid] = NEG_INF;
    sL[tid] = 0.f;
    sQSeg[tid] = t < T ? (q_seg ? q_seg[(long long)b * T + t] : 1) : 0;
  }
  __syncthreads();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * L::LDQ + kk * 16, L::LDQ);

  int n_tiles = (S + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  // lane pair (2r, 2r+1) of a warp owns row r of the warp's 16 rows
  const int prow = warp * 16 + (lane >> 1);
  const int half = lane & 1;
  const int t_row = q0 + prow;
  const int qs_row = sQSeg[prow];

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int i = tid; i < BK * VPR; i += NTHREADS) {
      const int r = i / VPR, c = (i % VPR) * VEC;
      const int s = k0 + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (s < S) {
        kv = *reinterpret_cast<const uint4*>(kb + s * k_ss + c);
        vv = *reinterpret_cast<const uint4*>(vb + s * v_ss + c);
      }
      *reinterpret_cast<uint4*>(sK + r * L::LDQ + c) = kv;
      *reinterpret_cast<uint4*>(sV + r * L::LDQ + c) = vv;
    }
    if (tid < BK) {
      const int s = k0 + tid;
      sKSeg[tid] = s < S ? (kv_seg ? kv_seg[(long long)b * S + s] : 1) : 0;
    }
    __syncthreads();

    // scores for this warp's 16 rows: S = Q K^T (K tile read as K^T, i.e.
    // column-major [D, BK])
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + n * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(sS + warp * 16 * L::LDS + n * 16, sf, L::LDS,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax on the row: scale, softcap, mask, running max / sum
    {
      float* srow = sS + prow * L::LDS;
      const int c0 = half * (BK / 2);
      float mx = NEG_INF;
#pragma unroll 8
      for (int c = c0; c < c0 + BK / 2; ++c) {
        float s = srow[c] * scale;
        if (softcap > 0.f) s = tanhf(s / softcap) * softcap;
        const int ks = sKSeg[c];
        const bool ok = qs_row == ks && ks != 0 && (!causal || k0 + c <= t_row);
        s = ok ? s : NEG_INF;
        srow[c] = s;
        mx = fmaxf(mx, s);
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[prow];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll 8
      for (int c = c0; c < c0 + BK / 2; ++c) {
        const int ks = sKSeg[c];
        const bool ok = qs_row == ks && ks != 0 && (!causal || k0 + c <= t_row);
        const float p = ok ? __expf(srow[c] - m_new) : 0.f;
        sP[prow * L::LDP + c] = __float2bfloat16(p);
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      const float alpha = __expf(m_prev - m_new);
      float* orow = sO + prow * L::LDO;
      for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) orow[c] *= alpha;
      // both lanes of the pair read sM/sL before the shuffles above
      if (half == 0) {
        sM[prow] = m_new;
        sL[prow] = sL[prow] * alpha + sum;
      }
    }
    __syncwarp();

    // O += P V  (P bf16 as in flash_attention.py:118-119)
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      float* optr = sO + warp * 16 * L::LDO + n * 16;
      wmma::load_matrix_sync(of, optr, L::LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sP + warp * 16 * L::LDP + kk * 16, L::LDP);
        wmma::load_matrix_sync(vf, sV + kk * 16 * L::LDQ + n * 16, L::LDQ);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(optr, of, L::LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  if (t_row < T) {
    const float l = sL[prow];
    const float l_safe = l == 0.f ? 1.f : l;
    const float* orow = sO + prow * L::LDO;
    __nv_bfloat16* out = o + b * o_sb + t_row * o_st + h * o_sh;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(orow[c] / l_safe, orow[c + 1] / l_safe);
    }
    if (half == 0)
      lse[((long long)b * H + h) * T + t_row] =
          l == 0.f ? NEG_INF : sM[prow] + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const int* q_seg,
           const int* kv_seg, void* o, float* lse, int B, int H, int KH,
           int T, int S, const long long* st, float scale, float softcap,
           int causal, cudaStream_t stream) {
  const size_t smem = Layout<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_seg, kv_seg,
      static_cast<__nv_bfloat16*>(o), lse, H, KH, T, S, st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], scale,
      softcap, causal);
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
