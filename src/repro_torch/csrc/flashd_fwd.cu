// FLASH-D forward (prefill) for Hopper: the counterpart of the Pallas kernel
// repro/kernels/flashd_fwd.py::flashd_fwd_pallas (_flashd_kernel).
//
// One CTA per (q block of BQ rows, q head, batch row); the TPU's sequential
// kv grid axis becomes a loop over KV tiles inside the CTA. Per tile and row
// the carry is FLASH-D's single (acc, Λ) pair, with the exact guards of the
// Pallas body:
//
//     m_b = tile-local max, m_safe = max(m_b, NEG_INF/2), p = e^{s − m_safe}
//     λ_b = m_safe + ln Σp          (NEG_INF when Σp = 0)
//     W = σ(λ_b − Λ), Λ' = λ_b − ln W, c = e^{m_safe − Λ'} ≤ 1
//     acc ← acc·(1 − W) + (P V)·c   — no epilogue division
//
// Q, K and V are read through their strides, so the model layout
// [B, S, H, d] is used as it is (no transpose copy). Tiles outside the mask
// (tile_live) are never loaded; q rows ≥ Sq are never written. With skip on,
// a row whose tile max lies more than θ + ln(block_k) below its running Λ
// keeps its carry, and a warp whose rows all skip does no exp and no P·V.
//
// Bound on the H100: at prefill lengths the work is O(Sq·Skv·d) operations
// on O((Sq + Skv)·d) bytes, so operations bound it. This first kernel does
// its products with f32 FMA on the CUDA cores (no mma/wgmma), K/V tiles
// staged in shared memory as f32; moving the two products onto tensor cores
// is later work.
#include <cfloat>

#include "flashd_common.cuh"

using namespace flashd;

namespace {

constexpr int BQ = 32;       // q rows per CTA
constexpr int BK_MAX = 64;   // largest kv tile; lanes own columns lane, lane+32
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = BQ / NWARPS;  // q rows per warp

enum MaskKind { MASK_FULL = 0, MASK_CAUSAL = 1, MASK_LOCAL = 2, MASK_CHUNKED = 3 };

struct FwdArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lam;
  long long q_sb, q_sh, q_ss;  // element strides of the [B, H, S, d] views
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int B, Hq, Hkv, Sq, Skv;
  int mask_kind, window, chunk, q_offset;
  int block_k;
  float scale;
  int skip;
  float skip_thr;  // θ + ln(block_k)
};

// core/blockwise.py::tile_live for the kernel's (BQ, block_k) tiling
__device__ __forceinline__ bool tile_live(const FwdArgs& a, int iq, int ik) {
  const long long k_lo = (long long)ik * a.block_k;
  if (a.mask_kind == MASK_FULL) return k_lo < a.Skv;
  const long long k_hi = k_lo + a.block_k - 1;
  const long long q_lo = (long long)iq * BQ + a.q_offset;
  const long long q_hi = q_lo + BQ - 1;
  bool live = k_lo <= q_hi;
  if (a.mask_kind == MASK_LOCAL) live = live && (q_lo - k_hi < a.window);
  if (a.mask_kind == MASK_CHUNKED)
    live = live && (floordiv(q_lo, a.chunk) <= floordiv(k_hi, a.chunk));
  return live;
}

// flashd_fwd.py::_mask_bias as a predicate
__device__ __forceinline__ bool keep(const FwdArgs& a, int qpos, int kpos) {
  if (kpos >= a.Skv) return false;
  if (a.mask_kind == MASK_FULL) return true;
  const long long qp = (long long)qpos + a.q_offset;
  const long long kp = kpos;
  bool ok = kp <= qp;
  if (a.mask_kind == MASK_LOCAL) ok = ok && (qp - kp < a.window);
  if (a.mask_kind == MASK_CHUNKED) ok = ok && (floordiv(qp, a.chunk) == floordiv(kp, a.chunk));
  return ok;
}

template <int HD>
constexpr int smem_floats() {
  return BQ * HD + BK_MAX * (HD + 1) + BK_MAX * HD + BQ * BK_MAX;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flashd_fwd_kernel(FwdArgs a) {
  constexpr int NC = (HD + 31) / 32;  // output columns per lane
  constexpr int KLD = HD + 1;         // padded K row: conflict-free column reads
  extern __shared__ float smem[];
  float* sQ = smem;                 // [BQ][HD]
  float* sK = sQ + BQ * HD;         // [BK_MAX][KLD]
  float* sV = sK + BK_MAX * KLD;    // [BK_MAX][HD]
  float* sP = sV + BK_MAX * HD;     // [BQ][BK_MAX]

  const int iq = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (a.Hq / a.Hkv);  // GQA: q head h reads kv head h // G
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = iq * BQ;
  const int bk = a.block_k;

  const T* qb = (const T*)a.q + b * a.q_sb + hq * a.q_sh;
  const T* kb = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* vb = (const T*)a.v + b * a.v_sb + hk * a.v_sh;

  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
    const int r = idx / HD, c = idx % HD, qr = q0 + r;
    sQ[idx] = qr < a.Sq ? to_float(qb[qr * a.q_ss + c]) : 0.0f;
  }

  float acc[ROWS][NC];
  float lam_run[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    lam_run[r] = NEG_INF;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.0f;
  }

  const int n_k = (a.Skv + bk - 1) / bk;
  for (int ik = 0; ik < n_k; ++ik) {
    if (!tile_live(a, iq, ik)) continue;  // uniform across the CTA
    const int k0 = ik * bk;
    __syncthreads();  // every warp is done with the previous tile
    for (int idx = tid; idx < bk * HD; idx += NTHREADS) {
      const int r = idx / HD, c = idx % HD, kr = k0 + r;
      const bool in = kr < a.Skv;
      sK[r * KLD + c] = in ? to_float(kb[kr * a.k_ss + c]) : 0.0f;
      sV[r * HD + c] = in ? to_float(vb[kr * a.v_ss + c]) : 0.0f;
    }
    __syncthreads();

    // scores of this warp's ROWS rows against columns lane and lane + 32
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.0f;
    const float* k_lo = sK + lane * KLD;
    const float* k_hi = sK + (lane + 32) * KLD;
    const float* q_w = sQ + warp * ROWS * HD;
#pragma unroll 4
    for (int kk = 0; kk < HD; ++kk) {
      const float ka = k_lo[kk], kc = k_hi[kk];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float qv = q_w[r * HD + kk];
        s[r][0] = fmaf(qv, ka, s[r][0]);
        s[r][1] = fmaf(qv, kc, s[r][1]);
      }
    }

    float m_b[ROWS];
    bool any_update = false;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = lane + 32 * j;
        s[r][j] = (col < bk && keep(a, qpos, k0 + col)) ? s[r][j] * a.scale : NEG_INF;
      }
      m_b[r] = warp_max(fmaxf(s[r][0], s[r][1]));
      const bool first = lam_run[r] <= DEAD;
      any_update = any_update ||
                   (qpos < a.Sq && (first || m_b[r] - lam_run[r] >= -a.skip_thr));
    }
    // whole-tile skip (per warp): every row below threshold leaves its carry
    // exactly as the per-row predicate would, without the exp and the P·V
    if (a.skip && !any_update) continue;

    float w[ROWS], cf[ROWS], lam_new[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float m_safe = fmaxf(m_b[r], DEAD);
      const float p0 = expf(s[r][0] - m_safe);
      const float p1 = expf(s[r][1] - m_safe);
      const float l = warp_sum(p0 + p1);
      const float lam_b = l > 0.0f ? m_safe + logf(fmaxf(l, F32_TINY)) : NEG_INF;
      const float delta = lam_b - lam_run[r];
      float ww = sigmoid(delta);
      float ln = lam_b - log_sigmoid(delta);  // = logaddexp(Λ, λ_b), no division
      const bool dead = lam_b <= DEAD;
      const bool first = lam_run[r] <= DEAD;
      ww = dead ? 0.0f : (first ? 1.0f : ww);
      ln = dead ? lam_run[r] : (first ? lam_b : ln);
      float c = dead ? 0.0f : expf(m_safe - ln);  // ≤ 1
      if (a.skip && (m_b[r] - lam_run[r] < -a.skip_thr) && !first) {
        ww = 0.0f;
        c = 0.0f;
        ln = lam_run[r];
      }
      w[r] = ww;
      cf[r] = c;
      lam_new[r] = ln;
      float* prow = sP + (warp * ROWS + r) * BK_MAX;
      prow[lane] = p0;
      prow[lane + 32] = p1;
    }
    __syncwarp();

    float pv[ROWS][NC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) pv[r][j] = 0.0f;
    const float* p_w = sP + warp * ROWS * BK_MAX;
    for (int c = 0; c < bk; ++c) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        vv[j] = col < HD ? sV[c * HD + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = p_w[r * BK_MAX + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) pv[r][j] = fmaf(p, vv[j], pv[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = acc[r][j] * (1.0f - w[r]) + pv[r][j] * cf[r];
      lam_run[r] = lam_new[r];
    }
    __syncwarp();  // sP is rewritten by the next tile
  }

  // no division, no rescale: acc already holds softmax(S)·V
  T* ob = (T*)a.o + b * a.o_sb + hq * a.o_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      if (col < HD) ob[qpos * a.o_ss + col] = from_float<T>(acc[r][j]);
    }
    if (lane == 0) a.lam[((long long)b * a.Hq + hq) * a.Sq + qpos] = lam_run[r];
  }
}

template <typename T, int HD>
cudaError_t launch(const FwdArgs& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<HD>();
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        flashd_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  flashd_fwd_kernel<T, HD><<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const FwdArgs& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 48: return launch<T, 48>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flashd_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lam,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int Hq, int Hkv, int Sq, int Skv, int hd, int is_bf16,
    int mask_kind, int window, int chunk, int q_offset, int block_k,
    float scale, int skip, float skip_thr, void* stream) {
  if (Sq == 0 || B == 0 || Hq == 0) return (int)cudaGetLastError();
  if (block_k < 1 || block_k > BK_MAX) return (int)cudaErrorInvalidValue;
  FwdArgs a{q, k, v, o, lam,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
            B, Hq, Hkv, Sq, Skv, mask_kind, window, chunk, q_offset, block_k,
            scale, skip, skip_thr};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, a, s) : dispatch_hd<float>(hd, a, s);
  return (int)e;
}
