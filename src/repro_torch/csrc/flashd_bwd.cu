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
// Guards: a masked key gets P = 0, and a row with Λ ≤ NEG_INF/2 (dead:
// every key masked, or a padded row) gets P = 0 by a select — without it
// e^{NEG_INF − NEG_INF} = 1 on a dead row.
//
// Bound on the H100: five products of d per visible (q, k) pair — s,
// dO·Vᵀ, dQ, dK, dV: 10·d flops — on O((Sq + Skv)·d) bytes: operations
// bound it, on the tensor cores (989 TFLOP/s bf16; f32 as three TF32
// products at 495). The kernel this one replaced ran them as f32 FMA on the
// CUDA cores (67 TFLOP/s).
//
// Design: K1's tile machine (attn_tc.cuh) turned around, every product on
// mma.sync, the operand tiles in a 2-stage cp.async ring of padded rows.
// Two kernels and no atomics, the TPU's split, so every gradient is summed
// in a fixed order and repeated calls are bitwise equal:
//   - dQ: a CTA per (q block of 64 rows, q head, batch row), 4 warps of 16
//     rows, looping over the live KV tiles of 64 keys (longest q blocks
//     first under causal masks). S = Q·Kᵀ and dP = dO·Vᵀ are K1's score
//     product; dS is formed in the accumulator registers; dQ += dS·K is
//     K1's P·V step with dS for P and K for V.
//   - dK/dV: a CTA per (KV block of 64 keys, kv head, batch row) looping
//     over its G q heads × live q tiles, so GQA's group sum stays in the
//     CTA. Keys are the M rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ put Pᵀ and dSᵀ
//     in registers in the A layout, and dV += Pᵀ·dO, dK += dSᵀ·Q are again
//     the P·V step; Λ and D are per column, staged per q tile in shared
//     memory beside Q and dO. 8 warps in two groups over the same 16-key
//     slices: the dV group forms Pᵀ and adds Pᵀ·dO, the dK group forms dPᵀ
//     meanwhile, takes Pᵀ through shared memory (a named barrier) and adds
//     dSᵀ·Q — two products each, one accumulator a thread.
// Operand rounding: bf16 products take bf16 operands, with P and dS
// rounded to bf16 (as FA2 does); f32 products are 3xTF32 (hi = cvt.rna(x),
// lo = cvt.rna(x − hi)). The f32 P·V step takes P from the score
// registers with its k order permuted (logical k t ↔ column 2t, t + 4 ↔
// 2t + 1) and reads B rows 2t, 2t + 1 to match, so no transposed copy.
// The tensor core truncates when it adds its products to an accumulator,
// and dK / dV sum over G × every q tile, so no gradient accumulator is
// chained through an mma: each k8 step (f32) or each 16 output columns of
// a tile (bf16) goes into a fresh partial added to it in f32.
//
// Registers and shared memory at d 128 (ptxas -v, sm_90a; no spills): dQ
// 255 registers f32 / 224 bf16, 6 padded 64-row tiles (Q, dO, two K/V
// stages) of shared memory, 203 KB f32 — one CTA (4 warps) an SM — and
// 104 KB bf16, two; dK/dV 187 f32 / 230 bf16, 6 tiles (K, V, two Q/dO
// stages) + Pᵀ, 222 KB f32 and 122 KB bf16, one CTA (8 warps) an SM. A
// 4-warp dK/dV CTA holding both accumulators spilled at f32 d 128: hence
// the two groups.
#include "attn_tc.cuh"

using namespace flashd;

namespace {

constexpr int BT = tc::BKP;  // rows of every tile: q rows (dQ), keys (dK/dV), 64
constexpr int NJ = tc::NJ;   // n8 blocks of a 64-column score tile
constexpr int NTHREADS = tc::NTHREADS;  // 4 warps, 16 tile rows each

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

template <typename T, int HD>
constexpr size_t smem_bytes() {
  return 6 * sizeof(T) * tc::Layout<T, HD>::TILE + 4 * sizeof(float) * BT;
}

// ---- the two products per warp: 16 rows × 64 columns × HD ----
//   scores(s, A, r0, B):  s[j] += A[r0 + 0..15, :] · B[8j + 0..7, :]ᵀ
//   pv(o, p, B):          o[n] += P · B[0..63, 8n + 0..7], P the 16 × 64
//                         tile in score registers; fresh partials, see above

template <typename T, int HD>
struct MM;

template <int HD>
struct MM<__nv_bfloat16, HD> {
  using L = tc::Layout<__nv_bfloat16, HD>;

  static __device__ __forceinline__ void scores(float (&s)[NJ][4], const __nv_bfloat16* sA,
                                                int r0, const __nv_bfloat16* sB, int lane) {
    const __nv_bfloat16* pa = sA + (r0 + (lane & 15)) * L::LD + (lane >> 4) * 8;
    const __nv_bfloat16* pb =
        sB + ((lane & 7) + ((lane >> 4) << 3)) * L::LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t af[4];
      tc::ldsm_x4(af, pa + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        tc::ldsm_x4(b, pb + jp * 16 * L::LD + kk * 16);
        tc::mma_bf16(s[2 * jp], af, b[0], b[1]);
        tc::mma_bf16(s[2 * jp + 1], af, b[2], b[3]);
      }
    }
  }

  // P rounded to bf16 as the A fragments; each 16 output columns of the
  // tile go into a fresh partial (4 k16 steps), added to o in f32
  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NJ][4],
                                            const __nv_bfloat16* sB, int lane) {
    uint32_t a[NJ / 2][4];
#pragma unroll
    for (int ks = 0; ks < NJ / 2; ++ks) {
      a[ks][0] = tc::pack_bf16(p[2 * ks][0], p[2 * ks][1]);
      a[ks][1] = tc::pack_bf16(p[2 * ks][2], p[2 * ks][3]);
      a[ks][2] = tc::pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]);
      a[ks][3] = tc::pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3]);
    }
    const __nv_bfloat16* bp =
        sB + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::LD + (lane >> 4) * 8;
#pragma unroll
    for (int np = 0; np < HD / 16; ++np) {
      float part[2][4] = {{0.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 0.0f}};
#pragma unroll
      for (int ks = 0; ks < NJ / 2; ++ks) {
        uint32_t b[4];
        tc::ldsm_x4_trans(b, bp + ks * 16 * L::LD + np * 16);
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
  using L = tc::Layout<float, HD>;

  // K1's f32 score product: 3xTF32, a fresh partial per k8 step
  static __device__ __forceinline__ void scores(float (&s)[NJ][4], const float* sA, int r0,
                                                const float* sB, int lane) {
    tc::Products<float, HD>().scores(s, sA, sB, r0, lane);
  }

  // P split into TF32 halves from the score registers, k permuted (logical
  // k t ↔ column 2t, t + 4 ↔ 2t + 1); a fresh partial per k8 step and n8 block
  static __device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NJ][4],
                                            const float* sB, int lane) {
    const int g = lane >> 2, t = lane & 3;
    const float* bb = sB + 2 * t * L::LD + g;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t ah[4], al[4];
      tc::split_tf32(p[j][0], ah[0], al[0]);  // (g, col 2t)
      tc::split_tf32(p[j][2], ah[1], al[1]);  // (g + 8, col 2t)
      tc::split_tf32(p[j][1], ah[2], al[2]);  // (g, col 2t + 1)
      tc::split_tf32(p[j][3], ah[3], al[3]);  // (g + 8, col 2t + 1)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float* b = bb + 8 * j * L::LD + 8 * n;
        uint32_t bh0, bl0, bh1, bl1;
        tc::split_tf32(b[0], bh0, bl0);      // B[8j + 2t][8n + g]
        tc::split_tf32(b[L::LD], bh1, bl1);  // B[8j + 2t + 1][8n + g]
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        tc::mma_3xtf32(part, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] += part[e];
      }
    }
  }
};

__device__ __forceinline__ void zero(float (&x)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
}

// ---------------------------------------------------------------- dQ ----

template <typename T, int HD>
__global__ void __launch_bounds__(NTHREADS) flashd_bwd_dq_kernel(BwdArgs a) {
  using L = tc::Layout<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sDO = sQ + L::TILE;
  T* const sKV0 = sDO + L::TILE;  // stage st: K at sKV0 + 2·st·TILE, V one TILE after

  const int nq = gridDim.z;
  const int iq = a.mask.kind == MASK_FULL ? (int)blockIdx.z : nq - 1 - (int)blockIdx.z;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int hk = hq / (a.Hq / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * BT, r0 = warp * 16;
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const T* kb = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* vb = (const T*)a.v + b * a.v_sb + hk * a.v_sh;
  tc::load_tile<T, HD>(sQ, (const T*)a.q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, a.Sq, tid);
  tc::load_tile<T, HD>(sDO, (const T*)a.dout + b * a.do_sb + hq * a.do_sh, a.do_ss, q0, a.Sq,
                       tid);
  const int n_k = (a.Skv + BT - 1) / BT;
  int ik = tc::next_live(a.mask, iq, -1, n_k, BT);
  if (ik < n_k) {
    tc::load_tile<T, HD>(sKV0, kb, a.k_ss, ik * BT, a.Skv, tid);
    tc::load_tile<T, HD>(sKV0 + L::TILE, vb, a.v_ss, ik * BT, a.Skv, tid);
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

  for (int st = 0; ik < n_k; st ^= 1) {
    const int nxt = tc::next_live(a.mask, iq, ik, n_k, BT);
    if (nxt < n_k) {
      T* dst = sKV0 + 2 * (st ^ 1) * L::TILE;
      tc::load_tile<T, HD>(dst, kb, a.k_ss, nxt * BT, a.Skv, tid);
      tc::load_tile<T, HD>(dst + L::TILE, vb, a.v_ss, nxt * BT, a.Skv, tid);
    }
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and Q, dO) landed; the next one stays in flight
    __syncthreads();
    const T* sK = sKV0 + 2 * st * L::TILE;
    const T* sV = sK + L::TILE;
    const int k0 = ik * BT;

    float s[NJ][4], dp[NJ][4];
    zero(s);
    zero(dp);
    MM<T, HD>::scores(s, sQ, r0, sK, lane);
    MM<T, HD>::scores(dp, sDO, r0, sV, lane);
    const bool edge = !tc::tile_full(a.mask, q_lo, q_lo + BT - 1, k0, BT);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const bool keep = !edge || a.mask.keep(qrow[r], k0 + 8 * j + 2 * t + (e & 1));
        const float p = keep && lam[r] > DEAD ? expf(s[j][e] * a.scale - lam[r]) : 0.0f;
        s[j][e] = p * (dp[j][e] - dsum[r]) * a.scale;  // dS
      }
    MM<T, HD>::pv(acc, s, sK, lane);  // dQ += dS·K
    __syncthreads();  // every warp is done with this stage before it is refilled
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

// the next live work item after `it` (item = q head of the group · nq + q tile)
__device__ __forceinline__ int next_item(const AttnMask& m, int it, int n_items, int nq, int ik) {
  for (++it; it < n_items; ++it)
    if (m.tile_live(it % nq, BT, ik, BT)) return it;
  return n_items;
}

// issue the item's Q (first 128 threads) or dO tile (last 128) into stage
// st (cp.async); returns this thread's entry of the item's Λ (tid < BT) or
// D (BT ≤ tid < 2·BT) column vector
template <typename T, int HD>
__device__ __forceinline__ float issue_item(const BwdArgs& a, T* sQD0, int it, int st, int nq,
                                            int hk, int b, int tid) {
  using L = tc::Layout<T, HD>;
  const int hq = hk * (a.Hq / a.Hkv) + it / nq, q0 = (it % nq) * BT;
  T* dst = sQD0 + 2 * st * L::TILE;
  if (tid < NTHREADS)
    tc::load_tile<T, HD>(dst, (const T*)a.q + b * a.q_sb + hq * a.q_sh, a.q_ss, q0, a.Sq, tid);
  else
    tc::load_tile<T, HD>(dst + L::TILE, (const T*)a.dout + b * a.do_sb + hq * a.do_sh, a.do_ss,
                         q0, a.Sq, tid - NTHREADS);
  const int qpos = q0 + (tid & (BT - 1));
  const long long row = ((long long)b * a.Hq + hq) * a.Sq + qpos;
  if (tid < BT) return qpos < a.Sq ? a.lam[row] : NEG_INF;  // padded columns are dead
  return tid < 2 * BT && qpos < a.Sq ? a.dsum[row] : 0.0f;
}

// 8 warps in two groups over the same 64 keys, 16 keys a warp: the dV group
// (warps 0–3) forms Pᵀ = e^{K·Qᵀ·scale − Λ}, shares it through shared memory
// and adds Pᵀ·dO; the dK group (warps 4–7) forms dPᵀ = V·dOᵀ meanwhile,
// waits for Pᵀ (a named barrier), and adds dSᵀ·Q. Each thread holds one
// accumulator: half the registers of one group doing both.
constexpr int DKV_THREADS = 2 * NTHREADS;
constexpr int LDP = BT + 8;  // padded row of the shared Pᵀ tile (floats): no bank conflicts

template <typename T, int HD>
constexpr size_t dkv_smem_bytes() {
  return smem_bytes<T, HD>() + sizeof(float) * BT * LDP;
}

template <typename T, int HD>
__global__ void __launch_bounds__(DKV_THREADS) flashd_bwd_dkv_kernel(BwdArgs a) {
  using L = tc::Layout<T, HD>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + L::TILE;
  T* const sQD0 = sV + L::TILE;  // stage st: Q at sQD0 + 2·st·TILE, dO one TILE after
  float* const sLD0 = reinterpret_cast<float*>(sQD0 + 4 * L::TILE);  // stage st: Λ, D [2][BT]
  float* const sP = sLD0 + 4 * BT;  // Pᵀ [BT keys][LDP]

  const int ik = blockIdx.z;  // small ik first: under causal masks the longest blocks
  const int hk = blockIdx.x, b = blockIdx.y;
  const int group = a.Hq / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool dk_role = warp >= NTHREADS / 32;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = ik * BT, r0 = (warp & 3) * 16;
  const int key[2] = {k0 + r0 + g, k0 + r0 + g + 8};

  if (dk_role)
    tc::load_tile<T, HD>(sV, (const T*)a.v + b * a.v_sb + hk * a.v_sh, a.v_ss, k0, a.Skv,
                         tid - NTHREADS);
  else
    tc::load_tile<T, HD>(sK, (const T*)a.k + b * a.k_sb + hk * a.k_sh, a.k_ss, k0, a.Skv, tid);

  // the work items: (q head of the group, q tile), head outer, live tiles only
  const int nq = (a.Sq + BT - 1) / BT;
  const int n_items = group * nq;
  int it = next_item(a.mask, -1, n_items, nq, ik);
  if (it < n_items) {
    const float ld = issue_item<T, HD>(a, sQD0, it, 0, nq, hk, b, tid);
    if (tid < 2 * BT) sLD0[tid] = ld;
  }
  tc::cp_async_commit();  // group: K, V and the first item

  float acc[HD / 8][4];  // dV (dV group) or dK (dK group)
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;

  for (int st = 0; it < n_items; st ^= 1) {
    const int nxt = next_item(a.mask, it, n_items, nq, ik);
    float next_ld = 0.0f;
    if (nxt < n_items) next_ld = issue_item<T, HD>(a, sQD0, nxt, st ^ 1, nq, hk, b, tid);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this item's tiles (and K, V) landed
    __syncthreads();
    const T* sQ = sQD0 + 2 * st * L::TILE;
    const T* sDO = sQ + L::TILE;
    const float* sLam = sLD0 + 2 * st * BT;
    const float* sD = sLam + BT;

    float s[NJ][4];  // Pᵀ (dV group) or dPᵀ, then dSᵀ (dK group); keys are the rows
    zero(s);
    if (!dk_role) {
      MM<T, HD>::scores(s, sK, r0, sQ, lane);
      const int q0 = (it % nq) * BT;
      const long long q_lo = (long long)q0 + a.mask.q_offset;
      const bool edge = !tc::tile_full(a.mask, q_lo, q_lo + BT - 1, k0, BT);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
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
      asm volatile("bar.arrive 1, %0;\n" ::"n"(DKV_THREADS) : "memory");  // Pᵀ is shared
      MM<T, HD>::pv(acc, s, sDO, lane);  // dV += Pᵀ·dO
    } else {
      MM<T, HD>::scores(s, sV, r0, sDO, lane);
      asm volatile("bar.sync 1, %0;\n" ::"n"(DKV_THREADS) : "memory");  // wait for Pᵀ
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = 8 * j + 2 * t;
          const float2 p =
              *reinterpret_cast<const float2*>(sP + (r0 + g + 8 * r) * LDP + col);
          s[j][2 * r] = p.x * (s[j][2 * r] - sD[col]) * a.scale;
          s[j][2 * r + 1] = p.y * (s[j][2 * r + 1] - sD[col + 1]) * a.scale;
        }
      MM<T, HD>::pv(acc, s, sQ, lane);  // dK += dSᵀ·Q
    }

    if (nxt < n_items && tid < 2 * BT) sLD0[2 * (st ^ 1) * BT + tid] = next_ld;
    __syncthreads();  // every warp is done with this stage (and Pᵀ) before it is refilled
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
cudaError_t launch(const BwdArgs& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes<T, HD>(), dkv_bytes = dkv_smem_bytes<T, HD>();
  cudaError_t e = cudaFuncSetAttribute(flashd_bwd_dq_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flashd_bwd_dkv_kernel<T, HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (e != cudaSuccess) return e;
  if (a.Sq > 0) {
    const dim3 dq_grid(a.Hq, a.B, (a.Sq + BT - 1) / BT);
    flashd_bwd_dq_kernel<T, HD><<<dq_grid, NTHREADS, bytes, stream>>>(a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  if (a.Skv > 0) {  // with Sq = 0 it writes dK = dV = 0
    const dim3 dkv_grid(a.Hkv, a.B, (a.Skv + BT - 1) / BT);
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
