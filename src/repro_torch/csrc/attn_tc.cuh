// The tile machine shared by the two prefill forward kernels, K1
// (flashd_fwd.cu, FLASH-D's carry) and K6 (fa2_fwd.cu, FA2's carry), on
// Hopper's tensor cores. Everything but the carry lives here: the Q load,
// the K/V ring, the two products, the row reductions over mma fragments,
// the masks and tile pruning, the schedule and the epilogue's stores. A
// kernel supplies a Carry (one per q row, held by the four threads of a
// quad) with
//
//     base(m_b)               the exp base: p = e^{s − base} on this tile
//     updates(m_b, a)         false when skip (a.skip) leaves the carry as it is
//     step(m_b, base, Σp, a) → (acc_scale, p_scale):
//                             acc ← acc·acc_scale + (P·p_scale)·V
//     out(acc), lse()         the epilogue's O entry and Λ
//
// CTA: 4 warps, BQ = 64 q rows, 16 per warp (one mma M), one (q block,
// q head, batch row) each; KV tiles of BKP = 64 physical keys starting at
// ik·block_k, columns ≥ block_k masked, so skip's per-tile threshold stays
// the reference's. The grid is (Hq, B, q blocks) with the q blocks in
// reverse under every causal-type mask: the longest rows start first, and
// the q heads that share a KV head sit next to each other.
//
// Staging: cp.async with 16-byte copies into a 2-stage K/V ring; the next
// live tile's copy is in flight while the current one computes. Q is copied
// once per CTA. Rows are padded by 16 bytes in shared memory, which keeps
// ldmatrix (bf16) and the 32-bit fragment reads (f32) free of bank
// conflicts for every head dim (32, 48, 64, 128). Rows past Sq / Skv are
// zero-filled by the copy (src-size 0).
//
// Products (mma.sync, f32 accumulation):
//   bf16  m16n8k16: Q and K fragments by ldmatrix, V by ldmatrix.trans; P
//         from the score registers, rounded to bf16 (|ΔO| ≤ 2^-9·max|v|).
//   f32   m16n8k8 TF32 as 3xTF32: x = hi + lo, hi = cvt.rna.tf32(x),
//         lo = cvt.rna.tf32(x − hi), and a·b ≈ lo_a·hi_b + hi_a·lo_b +
//         hi_a·hi_b, the split PyTorch's f32 memory-efficient SDPA uses
//         (OpMultiplyAddFastF32). One-pass TF32 would not hold 5e-5. P·V
//         takes P from the score registers with its k order permuted
//         (logical k t ↔ key 2t, t + 4 ↔ key 2t + 1) and V read to match,
//         so no shuffle and no transposed V copy is needed.
//         The tensor core sums an mma's products and its accumulator with
//         truncation, so a score chained through all 3·d/8 products of a
//         row drifts toward zero by up to an ulp of |s| per link — enough
//         to break 5e-5 on Λ at scores of ±60 (the GPU test
//         test_tc_fwd_kernels_hold_f32_at_large_scores). Each k8 step's
//         three products therefore go into a fresh partial that is added
//         to the score in f32 (round to nearest). A tile's f32 P·V goes
//         into a fresh partial added to acc in f32: chained across tiles,
//         acc's truncation biased O toward zero by enough to show in a
//         training step's grad norm (chip_smoke phase 12). bf16 P·V stays
//         chained: the partial's registers would spill, and O is rounded
//         to bf16 anyway.
//
// Reductions run in a fixed order (thread, then xor 1, xor 2 in the quad)
// and nothing is atomic: two calls on the same inputs are bitwise equal.
#pragma once

#include <cstdint>

#include "flashd_common.cuh"

namespace flashd {
namespace tc {

constexpr int BQ = 64;   // q rows per CTA
constexpr int BKP = 64;  // keys per physical KV tile (≥ block_k)
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int NJ = BKP / 8;  // n8 score blocks per tile
static_assert(BQ == NWARPS * 16, "one 16-row mma M per warp");
static_assert(BQ == BKP, "Q and K/V tiles share one shared-memory layout");

struct Args {
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
  int block_k;  // logical KV tile, 1 … BKP
  float scale;
  int skip;
  float skip_thr;  // θ + ln(block_k)
};

// shared memory: sQ, then K and V of stage 0, then of stage 1
template <typename T, int HD>
struct Layout {
  static constexpr int CHUNK = 16 / (int)sizeof(T);  // elements per 16-byte copy
  static constexpr int LD = HD + CHUNK;              // padded row, elements
  static constexpr int CPR = HD / CHUNK;             // copies per row
  static constexpr int TILE = BKP * LD;
  static constexpr size_t BYTES = sizeof(T) * 5 * TILE;
  static_assert(HD % 16 == 0, "head dim");
};

// ---- PTX ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global → shared, asynchronous; zero-filled when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// 3xTF32 operand split: x ≈ hi + lo, both TF32, |x − hi − lo| ≤ 2^-22·|x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}
// 3 products into d: the two small cross terms, then the large one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], uint32_t bh0, uint32_t bh1,
                                           uint32_t bl0, uint32_t bl1) {
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- the two products per warp (16 q rows × 64 keys × HD) ----
// Fragment coordinates: lane = 4·g + t; a thread holds score / output
// entries (row g, cols 2t, 2t + 1) in [0], [1] and (row g + 8, …) in [2], [3]
// of each n8 block.

template <typename T, int HD>
struct Products;

template <int HD>
struct Products<__nv_bfloat16, HD> {
  using L = Layout<__nv_bfloat16, HD>;
  uint32_t qf[HD / 16][4];  // Q's A fragments, loaded once

  __device__ __forceinline__ void load_q(const __nv_bfloat16* sQ, int r0, int lane) {
    const __nv_bfloat16* p = sQ + (r0 + (lane & 15)) * L::LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) ldsm_x4(qf[kk], p + kk * 16);
  }

  __device__ __forceinline__ void scores(float (&s)[NJ][4], const __nv_bfloat16*,
                                         const __nv_bfloat16* sK, int, int lane) const {
    // x4: (keys 16jp + 0..7, k lo), (…, k hi), (keys 16jp + 8..15, k lo), (…, k hi)
    const __nv_bfloat16* p =
        sK + ((lane & 7) + ((lane >> 4) << 3)) * L::LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NJ / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, p + jp * 16 * L::LD + kk * 16);
        mma_bf16(s[2 * jp], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }
  }

  __device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NJ][4],
                                     const __nv_bfloat16* sV, int lane) const {
    // x4 trans: (keys 16ks + 0..7, d 16np), (keys + 8, d 16np), (keys, d + 8), (keys + 8, d + 8)
    const __nv_bfloat16* vp = sV + ((lane & 7) + ((lane >> 3) & 1) * 8) * L::LD + (lane >> 4) * 8;
#pragma unroll
    for (int ks = 0; ks < NJ / 2; ++ks) {
      const uint32_t a[4] = {pack_bf16(p[2 * ks][0], p[2 * ks][1]),
                             pack_bf16(p[2 * ks][2], p[2 * ks][3]),
                             pack_bf16(p[2 * ks + 1][0], p[2 * ks + 1][1]),
                             pack_bf16(p[2 * ks + 1][2], p[2 * ks + 1][3])};
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vp + ks * 16 * L::LD + np * 16);
        mma_bf16(o[2 * np], a, b[0], b[1]);
        mma_bf16(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
};

template <int HD>
struct Products<float, HD> {
  using L = Layout<float, HD>;

  // Q stays in shared memory (f32 fragments of 16 × HD would take 2·HD/8
  // registers a thread once split); it is split as it is read
  __device__ __forceinline__ void load_q(const float*, int, int) {}

  __device__ __forceinline__ void scores(float (&s)[NJ][4], const float* sQ, const float* sK,
                                         int r0, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const float* qa = sQ + (r0 + g) * L::LD + t;
    const float* kb = sK + g * L::LD + t;
#pragma unroll 2
    for (int kk = 0; kk < HD; kk += 8) {
      uint32_t ah[4], al[4];  // a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
      split_tf32(qa[kk], ah[0], al[0]);
      split_tf32(qa[kk + 8 * L::LD], ah[1], al[1]);
      split_tf32(qa[kk + 4], ah[2], al[2]);
      split_tf32(qa[kk + 8 * L::LD + 4], ah[3], al[3]);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {  // b0 (k t, key g), b1 (k t + 4, key g)
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(kb[j * 8 * L::LD + kk], bh0, bl0);
        split_tf32(kb[j * 8 * L::LD + kk + 4], bh1, bl1);
        float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_3xtf32(part, ah, al, bh0, bh1, bl0, bl1);
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] += part[e];
      }
    }
  }

  // this tile's P·V goes into a fresh partial, added to o in f32
  __device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NJ][4],
                                     const float* sV, int lane) const {
    const int g = lane >> 2, t = lane & 3;
    const float* vb = sV + 2 * t * L::LD + g;
    float part[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) part[n][0] = part[n][1] = part[n][2] = part[n][3] = 0.0f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {  // keys 8j … 8j + 7; logical k t ↔ key 2t, t + 4 ↔ 2t + 1
      uint32_t ah[4], al[4];
      split_tf32(p[j][0], ah[0], al[0]);  // (g, key 2t)
      split_tf32(p[j][2], ah[1], al[1]);  // (g + 8, key 2t)
      split_tf32(p[j][1], ah[2], al[2]);  // (g, key 2t + 1)
      split_tf32(p[j][3], ah[3], al[3]);  // (g + 8, key 2t + 1)
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        const float* v = vb + 8 * j * L::LD + 8 * n;
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(v[0], bh0, bl0);      // V[8j + 2t][8n + g]
        split_tf32(v[L::LD], bh1, bl1);  // V[8j + 2t + 1][8n + g]
        mma_3xtf32(part[n], ah, al, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] += part[n][e];
  }
};

// ---- staging ----

// rows row0 … row0 + 63 of a [rows, HD] view (row stride ld) into a
// padded tile; rows ≥ n_rows are zero-filled
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ld, int row0, int n_rows,
                                          int tid) {
  using L = Layout<T, HD>;
#pragma unroll 4
  for (int i = tid; i < BKP * L::CPR; i += NTHREADS) {
    const int r = i / L::CPR, c = i - r * L::CPR;
    const int gr = row0 + r;
    const bool ok = gr < n_rows;
    cp_async16(dst + r * L::LD + c * L::CHUNK, ok ? src + gr * ld + c * L::CHUNK : src, ok);
  }
}

__device__ __forceinline__ int next_live(const AttnMask& m, int iq, int ik, int n_k, int bk) {
  for (++ik; ik < n_k; ++ik)
    if (m.tile_live(iq, BQ, ik, bk)) return ik;
  return n_k;
}

// every (q, k) of q positions [q_lo, q_hi] (q_offset applied) × keys
// [k0, k0 + bk) kept: the tile needs no per-entry mask
__device__ __forceinline__ bool tile_full(const AttnMask& m, long long q_lo, long long q_hi,
                                          long long k0, int bk) {
  const long long k_hi = k0 + bk - 1;
  if (k_hi >= m.kv_len) return false;
  if (m.kind == MASK_FULL) return true;
  bool full = k_hi <= q_lo;
  if (m.kind == MASK_LOCAL) full = full && (q_hi - k0 < m.window);
  if (m.kind == MASK_CHUNKED) full = full && (floordiv(k0, m.chunk) == floordiv(q_hi, m.chunk));
  return full;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// ---- the machine: one CTA's (q block, q head, batch row) ----

template <class Carry, typename T, int HD>
__device__ __forceinline__ void tile_machine(const Args& a, unsigned char* smem) {
  using L = Layout<T, HD>;
  T* sQ = reinterpret_cast<T*>(smem);
  T* const sK0 = sQ + L::TILE;  // stage st: K at sK0 + 2·st·TILE, V one TILE after

  const int nq = gridDim.z;
  const int iq = a.mask.kind == MASK_FULL ? (int)blockIdx.z : nq - 1 - (int)blockIdx.z;
  const int hq = blockIdx.x, b = blockIdx.y;
  const int hk = hq / (a.Hq / a.Hkv);  // GQA: q head h reads kv head h // G
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = iq * BQ, r0 = warp * 16;
  const int bk = a.block_k;
  const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  const T* qb = (const T*)a.q + b * a.q_sb + hq * a.q_sh;
  const T* kb = (const T*)a.k + b * a.k_sb + hk * a.k_sh;
  const T* vb = (const T*)a.v + b * a.v_sb + hk * a.v_sh;

  load_tile<T, HD>(sQ, qb, a.q_ss, q0, a.Sq, tid);
  const int n_k = (a.Skv + bk - 1) / bk;
  int ik = next_live(a.mask, iq, -1, n_k, bk);
  if (ik < n_k) {
    load_tile<T, HD>(sK0, kb, a.k_ss, ik * bk, a.Skv, tid);
    load_tile<T, HD>(sK0 + L::TILE, vb, a.v_ss, ik * bk, a.Skv, tid);
  }
  cp_async_commit();  // group: Q and the first live tile

  Products<T, HD> mm;
  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  Carry row[2];
  const long long q_lo = (long long)q0 + a.mask.q_offset;

  for (int step = 0, st = 0; ik < n_k; ++step, st ^= 1) {
    const int nxt = next_live(a.mask, iq, ik, n_k, bk);
    if (nxt < n_k) {
      T* dst = sK0 + 2 * (st ^ 1) * L::TILE;
      load_tile<T, HD>(dst, kb, a.k_ss, nxt * bk, a.Skv, tid);
      load_tile<T, HD>(dst + L::TILE, vb, a.v_ss, nxt * bk, a.Skv, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and Q) landed; the next one stays in flight
    __syncthreads();
    if (step == 0) mm.load_q(sQ, r0, lane);
    const T* sK = sK0 + 2 * st * L::TILE;
    const T* sV = sK + L::TILE;
    const int k0 = ik * bk;

    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
    mm.scores(s, sQ, sK, r0, lane);
    const bool edge = bk < BKP || !tile_full(a.mask, q_lo, q_lo + BQ - 1, k0, bk);
    float mb[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const bool keep = !edge || (col < bk && a.mask.keep(qrow[e >> 1], k0 + col));
        s[j][e] = keep ? s[j][e] * a.scale : NEG_INF;
        mb[e >> 1] = fmaxf(mb[e >> 1], s[j][e]);
      }
    mb[0] = quad_max(mb[0]);
    mb[1] = quad_max(mb[1]);

    // whole-warp skip: every row below threshold keeps its carry exactly as
    // the per-row predicate in step() would, without the exps and P·V
    bool skip_warp = false;
    if (a.skip) {
      bool any_update = false;
#pragma unroll
      for (int r = 0; r < 2; ++r) any_update |= qrow[r] < a.Sq && row[r].updates(mb[r], a);
      skip_warp = !__any_sync(0xffffffffu, any_update);
    }
    if (!skip_warp) {
      float base[2], l[2] = {0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 2; ++r) base[r] = row[r].base(mb[r]);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = expf(s[j][e] - base[e >> 1]);
          l[e >> 1] += s[j][e];
        }
      float acc_scale[2], p_scale[2];
#pragma unroll
      for (int r = 0; r < 2; ++r)
        row[r].step(mb[r], base[r], quad_sum(l[r]), a, acc_scale[r], p_scale[r]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= acc_scale[e >> 1];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= p_scale[e >> 1];
      mm.pv(acc, s, sV, lane);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
    ik = nxt;
  }
  cp_async_wait<0>();

  T* ob = (T*)a.o + b * a.o_sb + hq * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = qrow[r];
    if (qpos >= a.Sq) continue;
    T* orow = ob + qpos * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(orow + 8 * n, row[r].out(acc[n][2 * r]), row[r].out(acc[n][2 * r + 1]));
    if (t == 0) a.lam[((long long)b * a.Hq + hq) * a.Sq + qpos] = row[r].lse();
  }
}

// the dynamic shared memory is set per instantiation; grid (Hq, B, q blocks)
template <typename T, int HD>
cudaError_t launch(void (*kernel)(Args), const Args& a, cudaStream_t stream) {
  const size_t bytes = Layout<T, HD>::BYTES;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.Hq, a.B, (a.Sq + BQ - 1) / BQ);
  kernel<<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace tc
}  // namespace flashd
