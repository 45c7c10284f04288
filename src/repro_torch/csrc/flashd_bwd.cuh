// K5's two kernels (flashd_bwd.cu explains their design): everything but
// the C entry point, shared by the translation units that instantiate them —
// flashd_bwd.cu (head dims 16–128) and flashd_bwd_hd256.cu (256), which
// nvcc compiles at once (kernels/_build.py UNITS).
#pragma once

#include "attn_tc.cuh"

namespace flashd {
namespace bwd {

struct Args {
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

// The tile plan of a head dim. Each kernel owns BM rows, 16 a warp, whose
// gradient accumulator (HD / 2 registers a thread) stays in registers — q
// rows in dQ, keys in dK/dV — and streams tiles of BN rows through a ring
// of STAGES in shared memory: keys (K, V) into dQ, q rows (Q, dO, and Λ, D
// as floats) into dK/dV. Up to head dim 128 both tiles are 64 rows and the
// ring two stages deep. At 256 the streamed tile of dQ and the owned block
// of dK/dV halve to 32 rows, so a thread holds its 128 accumulator
// registers and 32 score registers in either kernel, and a ring stage that
// no longer fits in f32 is dropped: see flashd_bwd.cu for the bytes.
template <typename T, int HD>
struct Plan {
  static constexpr int LD = tc::Layout<T, HD>::LD;  // padded row, elements
  static constexpr size_t ROW = sizeof(T) * LD;
  static constexpr int DQ_BM = 64, DQ_BN = HD <= 128 ? 64 : 32;
  static constexpr int KV_BM = HD <= 128 ? 64 : 32, KV_BN = 64;
  static constexpr int LDP = KV_BN + 8;  // padded row of the shared Pᵀ tile (floats)

  // dQ: Q and dO of BM rows, then K and V of BN rows a stage
  static constexpr size_t DQ_OWN = ROW * 2 * DQ_BM, DQ_STAGE = ROW * 2 * DQ_BN;
  static constexpr int DQ_STAGES = DQ_OWN + 2 * DQ_STAGE <= tc::MAX_SMEM ? 2 : 1;
  static constexpr size_t DQ_BYTES = DQ_OWN + DQ_STAGES * DQ_STAGE;
  // dK/dV: K and V of BM rows and, as floats, Λ and D of two stages and
  // Pᵀ [BM][LDP]; then Q and dO of BN rows a stage
  static constexpr size_t KV_OWN =
      ROW * 2 * KV_BM + sizeof(float) * (4 * KV_BN + KV_BM * LDP);
  static constexpr size_t KV_STAGE = ROW * 2 * KV_BN;
  static constexpr int KV_STAGES = KV_OWN + 2 * KV_STAGE <= tc::MAX_SMEM ? 2 : 1;
  static constexpr size_t KV_BYTES = KV_OWN + KV_STAGES * KV_STAGE;
  static constexpr int DQ_THREADS = 2 * DQ_BM;  // BM / 16 warps
  static constexpr int KV_THREADS = 4 * KV_BM;  // two groups of BM / 16 warps
  static_assert(DQ_BM == tc::BQ, "dQ walks K1's q blocks (tc::next_live)");
  static_assert(2 * KV_BN <= KV_THREADS, "a thread per Λ and D entry of a q tile");
  static_assert(DQ_BYTES <= tc::MAX_SMEM && KV_BYTES <= tc::MAX_SMEM, "shared memory");
};

// ---- the two products per warp: 16 rows × 8·NS columns × HD ----
//   scores(s, A, r0, B):  s[j] += A[r0 + 0..15, :] · B[8j + 0..7, :]ᵀ
//   pv(o, p, B):          o[n] += P · B[0..8·NS − 1, 8n + 0..7], P the
//                         16 × 8·NS tile in score registers; fresh partials

template <typename T, int HD>
struct MM;

template <int HD>
struct MM<__nv_bfloat16, HD> {
  static constexpr int LD = tc::Layout<__nv_bfloat16, HD>::LD;

  template <int NS>
  static __device__ __forceinline__ void scores(float (&s)[NS][4], const __nv_bfloat16* sA,
                                                int r0, const __nv_bfloat16* sB, int lane) {
    const __nv_bfloat16* pa = sA + (r0 + (lane & 15)) * LD + (lane >> 4) * 8;
    const __nv_bfloat16* pb = sB + ((lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t af[4];
      tc::ldsm_x4(af, pa + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t b[4];
        tc::ldsm_x4(b, pb + jp * 16 * LD + kk * 16);
        tc::mma_bf16(s[2 * jp], af, b[0], b[1]);
        tc::mma_bf16(s[2 * jp + 1], af, b[2], b[3]);
      }
    }
  }

  // P rounded to bf16 as the A fragments; each 16 output columns of the
  // tile go into a fresh partial (NS / 2 k16 steps), added to o in f32
  template <int NS>
  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NS][4],
                                            const __nv_bfloat16* sB, int lane) {
    uint32_t a[NS / 2][4];
#pragma unroll
    for (int ks = 0; ks < NS / 2; ++ks) {
      a[ks][0] = tc::pack_bf16(p[2 * ks][0], p[2 * ks][1]);
      a[ks][1] = tc::pack_bf16(p[2 * ks][2], p[2 * ks][3]);
      a[ks][2] = tc::pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
      a[ks][3] = tc::pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
    }
    const __nv_bfloat16* bp = sB + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      float part[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int ks = 0; ks < NS / 2; ++ks) {
        uint32_t b[4];
        tc::ldsm_x4_trans(b, bp + ks * 16 * LD + np * 16);
        tc::mma_bf16(part[0], a[ks], b[0], b[1]);
        tc::mma_bf16(part[1], a[ks], b[2], b[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        o[2 * np][e] += part[0][e];
        o[2 * np + 1][e] += part[1][e];
      }
    }
  }
};

template <int HD>
struct MM<float, HD> {
  static constexpr int LD = tc::Layout<float, HD>::LD;

  // K1's f32 score product: 3xTF32, a fresh partial per k8 step
  template <int NS>
  static __device__ __forceinline__ void scores(float (&s)[NS][4], const float* sA, int r0,
                                                const float* sB, int lane) {
    tc::Products<float, HD>().scores(s, sA, sB, r0, lane);
  }

  // P split into TF32 halves from the score registers, k permuted (logical
  // k t ↔ column 2t, t + 4 ↔ 2t + 1); a fresh partial per k8 step and n8 block
  template <int NS>
  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NS][4],
                                            const float* sB, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* bb = sB + 2 * t * LD + g;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      uint32_t ah[4], al[4];
      tc::split_tf32(p[j][0], ah[0], al[0]);  // (g, col 2t)
      tc::split_tf32(p[j][2], ah[1], al[1]);  // (g + 8, col 2t)
      tc::split_tf32(p[j][1], ah[2], al[2]);  // (g, col 2t + 1)
      tc::split_tf32(p[j][3], ah[3], al[3]);  // (g + 8, col 2t + 1)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float* b = bb + 8 * j * LD + 8 * n;
        uint32_t bh0, bl0, bh1, bl1;
        tc::split_tf32(b[0], bh0, bl0);   // B[8j + 2t][8n + g]
        tc::split_tf32(b[LD], bh1, bl1);  // B[8j + 2t + 1][8n + g]
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        tc::mma_3xtf32(part, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += part[e];
      }
    }
  }
};

template <int NS>
__device__ __forceinline__ void zero(float (&x)[NS][4]) {
#pragma unroll
  for (int j = 0; j < NS; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
}

// ---------------------------------------------------------------- dQ ----

template <typename T, int HD>
__global__ void __launch_bounds__(Plan<T, HD>::DQ_THREADS) dq_kernel(Args a) {
  using P = Plan<T, HD>;
  constexpr int BM = P::DQ_BM, BN = P::DQ_BN, NT = P::DQ_THREADS, STAGES = P::DQ_STAGES;
  constexpr int TM = BM * P::LD, TN = BN * P::LD;  // elements of an owned / a streamed tile
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + TM;
  T* const sKV0 = sDO + TM;  // stage st: K at sKV0 + 2·st·TN, V one TN after

  const int nq = gridDim.z;
  const int iq = a.mask.kind == MASK_FULL ? (int)blockIdx.z : nq - 1 - (int)blockIdx.z;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int hk = hq / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * BM, r0 = warp * 16;
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const T* kb = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* vb = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  tc::load_tile<T, HD, BM, NT>(sQ, (const T*)a.q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, a.Sq,
                               tid);
  tc::load_tile<T, HD, BM, NT>(sDO, (const T*)a.dout + b * a.do_sb + hq * a.do_sh, a.do_ss, q0,
                               a.Sq, tid);
  const int n_k = (a.Skv + BN - 1) / BN;
  int ik = tc::next_live(a.mask, iq, -1, n_k, BN);
  if (ik < n_k) {
    tc::load_tile<T, HD, BN, NT>(sKV0, kb, a.k_ss, ik * BN, a.Skv, tid);
    tc::load_tile<T, HD, BN, NT>(sKV0 + TN, vb, a.v_ss, ik * BN, a.Skv, tid);
  }
  tc::cp_async_commit();  // group: Q, dO and the first live tile

  float lam[2], dsum[2];
  const long long row0 = ((long long)b * a.Hq + hq) * a.Sq;
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // padded rows are dead: P = 0
    lam[r] = qrow[r] < a.Sq ? a.lam[row0 + qrow[r]] : NEG_INF;
    dsum[r] = qrow[r] < a.Sq ? a.dsum[row0 + qrow[r]] : 0.0f;
  }
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  const long long q_lo = (long long)q0 + a.mask.q_offset;

  for (int st = 0; ik < n_k; st = (st + 1) % STAGES) {
    const int nxt = tc::next_live(a.mask, iq, ik, n_k, BN);
    if constexpr (STAGES == 2) {
      if (nxt < n_k) {
        T* dst = sKV0 + 2 * (st ^ 1) * TN;
        tc::load_tile<T, HD, BN, NT>(dst, kb, a.k_ss, nxt * BN, a.Skv, tid);
        tc::load_tile<T, HD, BN, NT>(dst + TN, vb, a.v_ss, nxt * BN, a.Skv, tid);
      }
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and Q, dO) landed; a next one stays in flight
    __syncthreads();
    const T* sK = sKV0 + 2 * st * TN;
    const T* sV = sK + TN;
    const int k0 = ik * BN;

    float s[BN / 8][4], dp[BN / 8][4];
    zero(s);
    zero(dp);
    MM<T, HD>::scores(s, sQ, r0, sK, lane);
    MM<T, HD>::scores(dp, sDO, r0, sV, lane);
    const bool edge = !tc::tile_full(a.mask, q_lo, q_lo + BM - 1, k0, BN);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool keep = !edge || a.mask.keep(qrow[r], k0 + 8 * j + 2 * t + (e & 1));
        const float p = keep && lam[r] > DEAD ? expf(s[j][e] * a.scale - lam[r]) : 0.0f;
        s[j][e] = p * (dp[j][e] - dsum[r]) * a.scale;  // dS
      }
    MM<T, HD>::pv(acc, s, sK, lane);  // dQ += dS·K
    __syncthreads();  // every warp is done with this stage before it is refilled
    if constexpr (STAGES == 1) {  // one stage: the next tile's copy starts only now
      if (nxt < n_k) {
        tc::load_tile<T, HD, BN, NT>(sKV0, kb, a.k_ss, nxt * BN, a.Skv, tid);
        tc::load_tile<T, HD, BN, NT>(sKV0 + TN, vb, a.v_ss, nxt * BN, a.Skv, tid);
      }
      tc::cp_async_commit();  // the next step's wait<1> passes its own empty group
    }
    ik = nxt;
  }
  tc::cp_async_wait<0>();

  T* dqb = (T*)a.dq + b * a.dq_sb + hq * a.dq_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= a.Sq) continue;
    T* row = dqb + qrow[r] * a.dq_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) tc::store2(row + 8 * n, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// ------------------------------------------------------------- dK, dV ----

// the next live work item after `it` (item = q head of the group · nq + q
// tile of bq rows) for the key block ik of bk keys
__device__ __forceinline__ int next_item(const AttnMask& m, int it, int n_items, int nq, int bq,
                                         int ik, int bk) {
  for (++it; it < n_items; ++it)
    if (m.tile_live(it % nq, bq, ik, bk)) return it;
  return n_items;
}

// issue the item's Q (first half of the threads) or dO tile (second half)
// into stage st (cp.async); returns this thread's entry of the item's Λ
// (tid < BN) or D (BN ≤ tid < 2·BN) column vector
template <typename T, int HD>
__device__ __forceinline__ float issue_item(const Args& a, T* sQD0, int it, int st, int nq,
                                            int hk, int b, int tid) {
  using P = Plan<T, HD>;
  constexpr int BN = P::KV_BN, HALF = P::KV_THREADS / 2, TN = BN * P::LD;
  const int hq = hk * (a.Hq / a.Hkv) + it / nq, q0 = (it % nq) * BN;
  T* dst = sQD0 + 2 * st * TN;
  if (tid < HALF)
    tc::load_tile<T, HD, BN, HALF>(dst, (const T*)a.q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0,
                                   a.Sq, tid);
  else
    tc::load_tile<T, HD, BN, HALF>(dst + TN, (const T*)a.dout + b * a.do_sb + hq * a.do_sh,
                                   a.do_ss, q0, a.Sq, tid - HALF);
  const int qpos = q0 + tid % BN;
  const long long row = ((long long)b * a.Hq + hq) * a.Sq + qpos;
  if (tid < BN) return qpos < a.Sq ? a.lam[row] : NEG_INF;  // padded columns are dead
  return tid < 2 * BN && qpos < a.Sq ? a.dsum[row] : 0.0f;
}

// Two groups of BM / 16 warps over the same BM keys, 16 keys a warp: the
// dV group forms Pᵀ = e^{K·Qᵀ·scale − Λ}, shares it through shared memory
// and adds Pᵀ·dO; the dK group forms dPᵀ = V·dOᵀ meanwhile, waits for Pᵀ
// (a named barrier), and adds dSᵀ·Q. Each thread holds one accumulator:
// half the registers of one group doing both.
template <typename T, int HD>
__global__ void __launch_bounds__(Plan<T, HD>::KV_THREADS) dkv_kernel(Args a) {
  using P = Plan<T, HD>;
  constexpr int BM = P::KV_BM, BN = P::KV_BN, NT = P::KV_THREADS, STAGES = P::KV_STAGES;
  constexpr int WG = BM / 16, LDP = P::LDP;  // warps a group
  constexpr int TM = BM * P::LD, TN = BN * P::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + TM;
  T* const sQD0 = sV + TM;  // stage st: Q at sQD0 + 2·st·TN, dO one TN after
  float* const sLD0 = reinterpret_cast<float*>(sQD0 + 2 * STAGES * TN);  // stage st: Λ, D [2][BN]
  float* const sP = sLD0 + 4 * BN;  // Pᵀ [BM keys][LDP]

  const int ik = blockIdx.z;  // small ik first: under causal masks the longest blocks
  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool dk_role = warp >= WG;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = ik * BM, r0 = (warp % WG) * 16;
  const int key[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  if (dk_role)
    tc::load_tile<T, HD, BM, NT / 2>(sV, (const T*)a.v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0,
                                     a.Skv, tid - NT / 2);
  else
    tc::load_tile<T, HD, BM, NT / 2>(sK, (const T*)a.k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0,
                                     a.Skv, tid);

  // the work items: (q head of the group, q tile), head outer, live tiles only
  const int nq = (a.Sq + BN - 1) / BN;
  const int n_items = group * nq;
  int it = next_item(a.mask, -1, n_items, nq, BN, ik, BM);
  if (it < n_items) {
    const float ld = issue_item<T, HD>(a, sQD0, it, 0, nq, hk, b, tid);
    if (tid < 2 * BN) sLD0[tid] = ld;
  }
  tc::cp_async_commit();  // group: K, V and the first item

  float acc[HD / 8][4];  // dV (dV group) or dK (dK group)
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int st = 0; it < n_items; st = (st + 1) % STAGES) {
    const int nxt = next_item(a.mask, it, n_items, nq, BN, ik, BM);
    float next_ld = 0.0f;
    if constexpr (STAGES == 2) {
      if (nxt < n_items) next_ld = issue_item<T, HD>(a, sQD0, nxt, st ^ 1, nq, hk, b, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this item's tiles (and K, V) landed
    __syncthreads();
    const T* sQ = sQD0 + 2 * st * TN;
    const T* sDO = sQ + TN;
    const float* sLam = sLD0 + 2 * st * BN;
    const float* sD = sLam + BN;

    float s[BN / 8][4];  // Pᵀ (dV group) or dPᵀ, then dSᵀ (dK group); keys are the rows
    zero(s);
    if (!dk_role) {
      MM<T, HD>::scores(s, sK, r0, sQ, lane);
      const int q0 = (it % nq) * BN;
      const long long q_lo = (long long)q0 + a.mask.q_offset;
      const bool edge = !tc::tile_full(a.mask, q_lo, q_lo + BN - 1, k0, BM);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * j + 2 * t + (e & 1);
          const float lam = sLam[col];
          const bool keep = !edge || a.mask.keep(q0 + col, key[e >> 1]);
          s[j][e] = keep && lam > DEAD ? expf(s[j][e] * a.scale - lam) : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(sP + (r0 + g + 8 * r) * LDP + 8 * j + 2 * t) =
              make_float2(s[j][2 * r], s[j][2 * r + 1]);
      }
      asm volatile("bar.arrive 1, %0;\n" ::"n"(NT) : "memory");  // Pᵀ is shared
      MM<T, HD>::pv(acc, s, sDO, lane);  // dV += Pᵀ·dO
    } else {
      MM<T, HD>::scores(s, sV, r0, sDO, lane);
      asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");  // wait for Pᵀ
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 8 * j + 2 * t;
          const float2 p = *reinterpret_cast<const float2*>(sP + (r0 + g + 8 * r) * LDP + col);
          s[j][2 * r] = p.x * (s[j][2 * r] - sD[col]) * a.scale;
          s[j][2 * r + 1] = p.y * (s[j][2 * r + 1] - sD[col + 1]) * a.scale;
        }
      MM<T, HD>::pv(acc, s, sQ, lane);  // dK += dSᵀ·Q
    }

    if constexpr (STAGES == 2) {
      if (nxt < n_items && tid < 2 * BN) sLD0[2 * (st ^ 1) * BN + tid] = next_ld;
    }
    __syncthreads();  // every warp is done with this stage (and Pᵀ) before it is refilled
    if constexpr (STAGES == 1) {  // one stage: the next item's copy starts only now
      if (nxt < n_items) {
        next_ld = issue_item<T, HD>(a, sQD0, nxt, 0, nq, hk, b, tid);
        if (tid < 2 * BN) sLD0[tid] = next_ld;
      }
      tc::cp_async_commit();
    }
    it = nxt;
  }
  tc::cp_async_wait<0>();

  T* ob = dk_role ? (T*)a.dk + b * a.dk_sb + hk * a.dk_sh : (T*)a.dv + b * a.dv_sb + hk * a.dv_sh;
  const long long oss = dk_role ? a.dk_ss : a.dv_ss;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.Skv) continue;
    T* row = ob + key[r] * oss + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) tc::store2(row + 8 * n, acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

template <typename T, int HD>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  using P = Plan<T, HD>;
  constexpr size_t dq_bytes = P::DQ_BYTES, kv_bytes = P::KV_BYTES;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kv_bytes);
  if (e != cudaSuccess) return e;
  if (a.Sq > 0) {
    const dim3 grid(a.Hq, a.B, (a.Sq + P::DQ_BM - 1) / P::DQ_BM);
    dq_kernel<T, HD><<<grid, P::DQ_THREADS, dq_bytes, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (a.Skv > 0) {  // with Sq = 0 it writes dK = dV = 0
    const dim3 grid(a.Hkv, a.B, (a.Skv + P::KV_BM - 1) / P::KV_BM);
    dkv_kernel<T, HD><<<grid, P::KV_THREADS, kv_bytes, stream>>>(a);
    e = cudaGetLastError();
  }
  return e;
}

// one definition per head dim, in the unit that builds it: both dtypes
#define FLASHD_BWD_HD(HD) cudaError_t bwd_hd##HD(const Args& a, bool bf16, cudaStream_t s)
FLASHD_BWD_HD(16);
FLASHD_BWD_HD(32);
FLASHD_BWD_HD(48);
FLASHD_BWD_HD(64);
FLASHD_BWD_HD(96);
FLASHD_BWD_HD(128);
FLASHD_BWD_HD(256);

}  // namespace bwd
}  // namespace flashd
