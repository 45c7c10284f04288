// FlashAttention-2 forward for Hopper (K6): the counterpart of the Pallas
// kernel repro/kernels/fa2_fwd.py::fa2_fwd_pallas (_fa2_kernel), the paper's
// controlled baseline.
//
// The CTA structure, tiles, loads, masks and tile pruning are K1's
// (flashd_fwd.cu): one CTA per (q block of BQ rows, q head, batch row)
// looping over KV tiles of ≤ 64 keys, 4 warps of 8 rows, lanes owning score
// columns lane and lane + 32. Only the datapath differs — FA2's carry of two
// row vectors and an accumulator, with the rescale chain through the
// running max and the division epilogue that FLASH-D removes:
//
//     m' = max(m, m_b), m_safe = max(m', NEG_INF/2)
//     α = e^{m − m_safe} (0 while m is dead), p = e^{s − m_safe}
//     ℓ ← ℓ·α + Σp,  acc ← acc·α + P V
//     epilogue: O = acc / max(ℓ, tiny),  Λ = m + ln ℓ (NEG_INF when ℓ = 0)
//
// It returns the same (O, Λ) as K1, dead rows O = 0 and Λ = NEG_INF, so the
// one backward kernel (flashd_bwd.cu) serves both forwards.
//
// Bound on the H100: as K1, O(Sq·Skv·d) operations on O((Sq + Skv)·d)
// bytes, operations bound it; f32 FMA on the CUDA cores here.
#include "flashd_common.cuh"

using namespace flashd;

namespace {

constexpr int BQ = 32;  // q rows per CTA (K1's)
constexpr int BK = 64;  // kv tile (K1's default); lanes own columns lane, lane+32
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = BQ / NWARPS;

struct Fa2Args {
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
  AttnMask mask;
  float scale;
};

template <int HD>
constexpr int smem_floats() {
  return BQ * HD + BK * (HD + 1) + BK * HD + BQ * BK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) fa2_fwd_kernel(Fa2Args a) {
  constexpr int NC = (HD + 31) / 32;
  constexpr int KLD = HD + 1;
  extern __shared__ float smem[];
  float* sQ = smem;              // [BQ][HD]
  float* sK = sQ + BQ * HD;      // [BK][KLD]
  float* sV = sK + BK * KLD;     // [BK][HD]
  float* sP = sV + BK * HD;      // [BQ][BK]

  const int iq = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = iq * BQ;

  const T* qb = (const T*)a.q + b * a.q_sb + hq * a.q_sh;
  const T* kb = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* vb = (const T*)a.v + b * a.v_sb + hk * a.v_sh;

  for (int idx = tid; idx < BQ * HD; idx += NTHREADS) {
    const int r = idx / HD, c = idx % HD, qr = q0 + r;
    sQ[idx] = qr < a.Sq ? to_float(qb[qr * a.q_ss + c]) : 0.0f;
  }

  float acc[ROWS][NC];
  float m_run[ROWS], l_run[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m_run[r] = NEG_INF;
    l_run[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.0f;
  }

  const int n_k = (a.Skv + BK - 1) / BK;
  for (int ik = 0; ik < n_k; ++ik) {
    if (!a.mask.tile_live(iq, BQ, ik, BK)) continue;  // uniform across the CTA
    const int k0 = ik * BK;
    __syncthreads();
    for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
      const int r = idx / HD, c = idx % HD, kr = k0 + r;
      const bool in = kr < a.Skv;
      sK[r * KLD + c] = in ? to_float(kb[kr * a.k_ss + c]) : 0.0f;
      sV[r * HD + c] = in ? to_float(vb[kr * a.v_ss + c]) : 0.0f;
    }
    __syncthreads();

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

    float alpha[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int qpos = q0 + warp * ROWS + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int col = lane + 32 * j;
        s[r][j] = a.mask.keep(qpos, k0 + col) ? s[r][j] * a.scale : NEG_INF;
      }
      const float m_b = warp_max(fmaxf(s[r][0], s[r][1]));
      const float m_new = fmaxf(m_run[r], m_b);  // the serial cross-tile max chain
      const float m_safe = fmaxf(m_new, DEAD);
      alpha[r] = m_run[r] <= DEAD ? 0.0f : expf(m_run[r] - m_safe);
      const float p0 = expf(s[r][0] - m_safe);
      const float p1 = expf(s[r][1] - m_safe);
      l_run[r] = l_run[r] * alpha[r] + warp_sum(p0 + p1);
      m_run[r] = m_new;
      float* prow = sP + (warp * ROWS + r) * BK;
      prow[lane] = p0;
      prow[lane + 32] = p1;
    }
    __syncwarp();

    float pv[ROWS][NC];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) pv[r][j] = 0.0f;
    const float* p_w = sP + warp * ROWS * BK;
    for (int c = 0; c < BK; ++c) {
      float vv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        vv[j] = col < HD ? sV[c * HD + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float p = p_w[r * BK + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) pv[r][j] = fmaf(p, vv[j], pv[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[r][j] = acc[r][j] * alpha[r] + pv[r][j];  // rescale
    __syncwarp();
  }

  // the epilogue division FLASH-D eliminates
  T* ob = (T*)a.o + b * a.o_sb + hq * a.o_sh;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= a.Sq) continue;
    const float l_safe = fmaxf(l_run[r], F32_TINY);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      if (col < HD) ob[qpos * a.o_ss + col] = from_float<T>(acc[r][j] / l_safe);
    }
    if (lane == 0)
      a.lam[((long long)b * a.Hq + hq) * a.Sq + qpos] =
          l_run[r] > 0.0f ? m_run[r] + logf(l_safe) : NEG_INF;
  }
}

template <typename T, int HD>
cudaError_t launch(const Fa2Args& a, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<HD>();
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        fa2_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
  fa2_fwd_kernel<T, HD><<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Fa2Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 48: return launch<T, 48>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fa2_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lam,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int Hq, int Hkv, int Sq, int Skv, int hd, int is_bf16,
    int mask_kind, int window, int chunk, int q_offset, float scale, void* stream) {
  if (Sq == 0 || B == 0 || Hq == 0) return (int)cudaGetLastError();
  Fa2Args a{q, k, v, o, lam,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
            B, Hq, Hkv, Sq, Skv, AttnMask{mask_kind, window, chunk, q_offset, Skv}, scale};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, a, s) : dispatch_hd<float>(hd, a, s);
  return (int)e;
}
