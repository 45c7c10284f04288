// FLASH-D attention backward for Hopper (K5): the counterpart of the Pallas
// kernel repro/kernels/flashd_bwd.py::flashd_bwd_pallas (_recompute_p_ds,
// _dq_kernel, _dkv_kernel).
//
// From the saved (O, Λ) and D = rowsum(dO∘O) (a PyTorch reduction in the
// wrapper, as the reference computes it outside its kernel):
//
//     P  = e^{s − Λ}            exact probabilities, exponent ≤ 0: no max pass
//     dS = P∘(dO·Vᵀ − D)·scale
//     dQ = dS·K,  dK = dSᵀ·Q,  dV = Pᵀ·dO
//
// Guards: a masked key scores NEG_INF, and a row with Λ ≤ NEG_INF/2 (dead:
// every key masked, or a padded row) gets P = 0 by a select — without it
// e^{NEG_INF − NEG_INF} = 1 on a dead row.
//
// Two kernels and no atomics, the TPU's split: the dQ kernel has a CTA per
// (q block, q head, batch row) looping over the KV tiles; the dK/dV kernel a
// CTA per (kv block, kv head, batch row) looping over its G q heads × q
// blocks, so GQA's group sum happens in the CTA's registers. Every sum runs
// in a fixed order: the gradients are the same on every run. Tiles are K1's
// (32 q rows × 64 keys) with the same masks and tile_live pruning; Q, K, V
// and dO are read through their strides (the model layout goes in as a
// view) and dQ, dK, dV are written through theirs.
//
// Bound on the H100: five products of d per visible (q, k) pair — s, dO·Vᵀ,
// dQ, dK, dV, 10·d flops — on O((Sq + Skv)·d) bytes: operations bound it.
// This first kernel runs them as f32 FMA on the CUDA cores, the operand
// tiles staged in shared memory as f32.
#include "flashd_common.cuh"

using namespace flashd;

namespace {

constexpr int BQ = 32;  // q rows per tile
constexpr int BK = 64;  // keys per tile; lanes own columns lane, lane + 32

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lam;   // [B, Hq, Sq] contiguous
  const float* dsum;  // [B, Hq, Sq] contiguous
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_sh, q_ss;  // element strides of the [B, H, S, d] views
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long do_sb, do_sh, do_ss;
  long long dq_sb, dq_sh, dq_ss;
  long long dk_sb, dk_sh, dk_ss;
  long long dv_sb, dv_sh, dv_ss;
  int B, Hq, Hkv, Sq, Skv;
  AttnMask mask;
  float scale;
};

// Scores and dO·Vᵀ of NR q rows (rows r0 … r0+NR−1 of the staged tile)
// against this lane's columns lane and lane + 32 of the staged key tile,
// then P and dS of those entries.
template <int HD, int NR>
__device__ __forceinline__ void p_ds(const BwdArgs& a, const float* sQ, const float* sDO,
                                     const float* sK, const float* sV, int r0, int q0, int k0,
                                     const float (&lam)[NR], const float (&dsum)[NR], int lane,
                                     float (&p)[NR][2], float (&ds)[NR][2]) {
  constexpr int KLD = HD + 1;
  float s[NR][2], dp[NR][2];
#pragma unroll
  for (int r = 0; r < NR; ++r) s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.0f;
  const float* k_lo = sK + lane * KLD;
  const float* k_hi = sK + (lane + 32) * KLD;
  const float* v_lo = sV + lane * KLD;
  const float* v_hi = sV + (lane + 32) * KLD;
#pragma unroll 4
  for (int kk = 0; kk < HD; ++kk) {
    const float ka = k_lo[kk], kc = k_hi[kk], va = v_lo[kk], vc = v_hi[kk];
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float qv = sQ[(r0 + r) * HD + kk], dov = sDO[(r0 + r) * HD + kk];
      s[r][0] = fmaf(qv, ka, s[r][0]);
      s[r][1] = fmaf(qv, kc, s[r][1]);
      dp[r][0] = fmaf(dov, va, dp[r][0]);
      dp[r][1] = fmaf(dov, vc, dp[r][1]);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const int qpos = q0 + r0 + r;
    const bool dead = lam[r] <= DEAD;  // padded rows carry Λ = NEG_INF too
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float sc = a.mask.keep(qpos, k0 + lane + 32 * j) ? s[r][j] * a.scale : NEG_INF;
      p[r][j] = dead ? 0.0f : expf(sc - lam[r]);
      ds[r][j] = p[r][j] * (dp[r][j] - dsum[r]) * a.scale;
    }
  }
}

// stage rows [r0, r0 + n) of a [S, HD] operand as f32 (zeros past S)
template <typename T, int HD, int LD>
__device__ __forceinline__ void stage(float* dst, const T* src, long long ss, int r0, int n,
                                      int S, int tid, int nthreads) {
  for (int idx = tid; idx < n * HD; idx += nthreads) {
    const int r = idx / HD, c = idx % HD, sr = r0 + r;
    dst[r * LD + c] = sr < S ? to_float(src[sr * ss + c]) : 0.0f;
  }
}

// ---------------------------------------------------------------- dQ ----
constexpr int DQ_WARPS = 4;
constexpr int DQ_THREADS = DQ_WARPS * 32;
constexpr int DQ_ROWS = BQ / DQ_WARPS;  // q rows per warp

template <int HD>
constexpr int dq_smem_floats() {
  return 2 * BQ * HD + 2 * BK * (HD + 1) + BQ * BK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(DQ_THREADS) flashd_bwd_dq_kernel(BwdArgs a) {
  constexpr int NC = (HD + 31) / 32;  // output columns per lane
  constexpr int KLD = HD + 1;
  extern __shared__ float smem[];
  float* sQ = smem;                // [BQ][HD]
  float* sDO = sQ + BQ * HD;       // [BQ][HD]
  float* sK = sDO + BQ * HD;       // [BK][KLD]
  float* sV = sK + BK * KLD;       // [BK][KLD]
  float* sDS = sV + BK * KLD;      // [BQ][BK]

  const int iq = blockIdx.x, hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = iq * BQ, r0 = warp * DQ_ROWS;

  stage<T, HD, HD>(sQ, (const T*)a.q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, BQ, a.Sq, tid,
                   DQ_THREADS);
  stage<T, HD, HD>(sDO, (const T*)a.dout + b * a.do_sb + hq * a.do_sh, a.do_ss, q0, BQ, a.Sq,
                   tid, DQ_THREADS);
  const T* kb = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* vb = (const T*)a.v + b * a.v_sb + hk * a.v_sh;

  float lam[DQ_ROWS], dsum[DQ_ROWS], acc[DQ_ROWS][NC];
  const long long row0 = ((long long)b * a.Hq + hq) * a.Sq;
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r) {
    const int qpos = q0 + r0 + r;
    lam[r] = qpos < a.Sq ? a.lam[row0 + qpos] : NEG_INF;
    dsum[r] = qpos < a.Sq ? a.dsum[row0 + qpos] : 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[r][j] = 0.0f;
  }

  const int n_k = (a.Skv + BK - 1) / BK;
  for (int ik = 0; ik < n_k; ++ik) {
    if (!a.mask.tile_live(iq, BQ, ik, BK)) continue;  // uniform across the CTA
    const int k0 = ik * BK;
    __syncthreads();  // every warp is done with the previous tile
    stage<T, HD, KLD>(sK, kb, a.k_ss, k0, BK, a.Skv, tid, DQ_THREADS);
    stage<T, HD, KLD>(sV, vb, a.v_ss, k0, BK, a.Skv, tid, DQ_THREADS);
    __syncthreads();

    float p[DQ_ROWS][2], ds[DQ_ROWS][2];
    p_ds<HD, DQ_ROWS>(a, sQ, sDO, sK, sV, r0, q0, k0, lam, dsum, lane, p, ds);
#pragma unroll
    for (int r = 0; r < DQ_ROWS; ++r) {
      sDS[(r0 + r) * BK + lane] = ds[r][0];
      sDS[(r0 + r) * BK + lane + 32] = ds[r][1];
    }
    __syncwarp();
    // dQ[r, c] += Σ_key dS[r, key] · K[key, c]
    for (int c = 0; c < BK; ++c) {
      float kv[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int col = lane + 32 * j;
        kv[j] = col < HD ? sK[c * KLD + col] : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < DQ_ROWS; ++r) {
        const float d = sDS[(r0 + r) * BK + c];
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[r][j] = fmaf(d, kv[j], acc[r][j]);
      }
    }
    __syncwarp();  // sDS is rewritten by the next tile
  }

  T* dqb = (T*)a.dq + b * a.dq_sb + hq * a.dq_sh;
#pragma unroll
  for (int r = 0; r < DQ_ROWS; ++r) {
    const int qpos = q0 + r0 + r;
    if (qpos >= a.Sq) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      if (col < HD) dqb[qpos * a.dq_ss + col] = from_float<T>(acc[r][j]);
    }
  }
}

// ------------------------------------------------------------- dK, dV ----
constexpr int DKV_WARPS = 8;
constexpr int DKV_THREADS = DKV_WARPS * 32;
constexpr int DKV_QROWS = BQ / DKV_WARPS;  // q rows per warp in the score phase
constexpr int DKV_KROWS = BK / DKV_WARPS;  // keys per warp in the accumulate phase

template <int HD>
constexpr int dkv_smem_floats() {
  return 2 * BK * (HD + 1) + 2 * BQ * HD + 2 * BQ * BK;
}

template <typename T, int HD>
__global__ void __launch_bounds__(DKV_THREADS) flashd_bwd_dkv_kernel(BwdArgs a) {
  constexpr int NC = (HD + 31) / 32;
  constexpr int KLD = HD + 1;
  extern __shared__ float smem[];
  float* sK = smem;                // [BK][KLD]
  float* sV = sK + BK * KLD;       // [BK][KLD]
  float* sQ = sV + BK * KLD;       // [BQ][HD]
  float* sDO = sQ + BQ * HD;       // [BQ][HD]
  float* sP = sDO + BQ * HD;       // [BQ][BK]
  float* sDS = sP + BQ * BK;       // [BQ][BK]

  const int ik = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int k0 = ik * BK;
  const int qr0 = warp * DKV_QROWS, kr0 = warp * DKV_KROWS;

  stage<T, HD, KLD>(sK, (const T*)a.k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, BK, a.Skv, tid,
                    DKV_THREADS);
  stage<T, HD, KLD>(sV, (const T*)a.v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, BK, a.Skv, tid,
                    DKV_THREADS);

  float dk[DKV_KROWS][NC], dv[DKV_KROWS][NC];
#pragma unroll
  for (int r = 0; r < DKV_KROWS; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) dk[r][j] = dv[r][j] = 0.0f;

  const int n_q = (a.Sq + BQ - 1) / BQ;
  for (int g = 0; g < group; ++g) {  // the q heads that read this kv head
    const int hq = hk * group + g;
    const T* qb = (const T*)a.q + b * a.q_sb + hq * a.q_sh;
    const T* dob = (const T*)a.dout + b * a.do_sb + hq * a.do_sh;
    const long long row0 = ((long long)b * a.Hq + hq) * a.Sq;
    for (int iq = 0; iq < n_q; ++iq) {
      if (!a.mask.tile_live(iq, BQ, ik, BK)) continue;  // uniform across the CTA
      const int q0 = iq * BQ;
      __syncthreads();  // the previous tile's sQ / sDO / sP / sDS are consumed
      stage<T, HD, HD>(sQ, qb, a.q_ss, q0, BQ, a.Sq, tid, DKV_THREADS);
      stage<T, HD, HD>(sDO, dob, a.do_ss, q0, BQ, a.Sq, tid, DKV_THREADS);
      float lam[DKV_QROWS], dsum[DKV_QROWS];
#pragma unroll
      for (int r = 0; r < DKV_QROWS; ++r) {
        const int qpos = q0 + qr0 + r;
        lam[r] = qpos < a.Sq ? a.lam[row0 + qpos] : NEG_INF;
        dsum[r] = qpos < a.Sq ? a.dsum[row0 + qpos] : 0.0f;
      }
      __syncthreads();

      float p[DKV_QROWS][2], ds[DKV_QROWS][2];
      p_ds<HD, DKV_QROWS>(a, sQ, sDO, sK, sV, qr0, q0, k0, lam, dsum, lane, p, ds);
#pragma unroll
      for (int r = 0; r < DKV_QROWS; ++r) {
        sP[(qr0 + r) * BK + lane] = p[r][0];
        sP[(qr0 + r) * BK + lane + 32] = p[r][1];
        sDS[(qr0 + r) * BK + lane] = ds[r][0];
        sDS[(qr0 + r) * BK + lane + 32] = ds[r][1];
      }
      __syncthreads();
      // dV[key, c] += Σ_r P[r, key] · dO[r, c];  dK[key, c] += Σ_r dS[r, key] · Q[r, c]
      for (int r = 0; r < BQ; ++r) {
        float qv[NC], dov[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = lane + 32 * j;
          qv[j] = col < HD ? sQ[r * HD + col] : 0.0f;
          dov[j] = col < HD ? sDO[r * HD + col] : 0.0f;
        }
#pragma unroll
        for (int kr = 0; kr < DKV_KROWS; ++kr) {
          const float pp = sP[r * BK + kr0 + kr], dd = sDS[r * BK + kr0 + kr];
#pragma unroll
          for (int j = 0; j < NC; ++j) {
            dv[kr][j] = fmaf(pp, dov[j], dv[kr][j]);
            dk[kr][j] = fmaf(dd, qv[j], dk[kr][j]);
          }
        }
      }
    }
  }

  T* dkb = (T*)a.dk + b * a.dk_sb + hk * a.dk_sh;
  T* dvb = (T*)a.dv + b * a.dv_sb + hk * a.dv_sh;
#pragma unroll
  for (int kr = 0; kr < DKV_KROWS; ++kr) {
    const int kpos = k0 + kr0 + kr;
    if (kpos >= a.Skv) continue;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      if (col < HD) {
        dkb[kpos * a.dk_ss + col] = from_float<T>(dk[kr][j]);
        dvb[kpos * a.dv_ss + col] = from_float<T>(dv[kr][j]);
      }
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t dq_bytes = sizeof(float) * dq_smem_floats<HD>();
  const size_t dkv_bytes = sizeof(float) * dkv_smem_floats<HD>();
  cudaError_t e = cudaFuncSetAttribute(flashd_bwd_dq_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flashd_bwd_dkv_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (e != cudaSuccess) return e;
  if (a.Sq > 0) {
    const dim3 dq_grid((a.Sq + BQ - 1) / BQ, a.Hq, a.B);
    flashd_bwd_dq_kernel<T, HD><<<dq_grid, DQ_THREADS, dq_bytes, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (a.Skv > 0) {  // with Sq = 0 it writes dK = dV = 0
    const dim3 dkv_grid((a.Skv + BK - 1) / BK, a.Hkv, a.B);
    flashd_bwd_dkv_kernel<T, HD><<<dkv_grid, DKV_THREADS, dkv_bytes, stream>>>(a);
    e = cudaGetLastError();
  }
  return e;
}

template <typename T>
cudaError_t dispatch_hd(int hd, const BwdArgs& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, stream);
    case 48: return launch<T, 48>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flashd_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, const float* lam,
    const float* dsum, void* dq, void* dk, void* dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int B, int Hq, int Hkv, int Sq, int Skv, int hd, int is_bf16,
    int mask_kind, int window, int chunk, int q_offset, float scale, void* stream) {
  if (B == 0 || Hq == 0 || (Sq == 0 && Skv == 0)) return (int)cudaGetLastError();
  BwdArgs a{q, k, v, dout, lam, dsum, dq, dk, dv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
            dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
            B, Hq, Hkv, Sq, Skv, AttnMask{mask_kind, window, chunk, q_offset, Skv}, scale};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, a, s) : dispatch_hd<float>(hd, a, s);
  return (int)e;
}
