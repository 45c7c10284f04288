// The CUDA-core split body shared by the decode kernels K2 and K3
// (flashd_decode.cu) and by K4's few-row path (flashd_varlen.cu): one CTA
// computes the normalised FLASH-D partial (o_p [GC, d], λ_p [GC]) of up to
// GC query rows over a run of KV positions [i0, i0 + n).
//
// The rows' K and V live either in a contiguous [S, d] view (K2) or in the
// pages of a pool [P, page, Hkv, d] reached through one block-table row (K3,
// K4): row `pos` is at tbl[pos / page], offset pos % page. The table is
// read only for the rows the caller asks for, so a slot past a sequence's
// live pages (the garbage page 0, which may hold anything) is never
// followed. A byte pool (int8, or fp8 e4m3) is staged as bytes with one f32
// scale per (page, kv head) beside each row, and dequantized when a lane
// reads it (x·scale, the reference's order), before the scores or P·V use
// it.
//
// The design keeps HBM busy (one query row per head: bytes bound decode):
//   - every live K and V row is staged with 16-byte cp.async copies, all
//     issued at once (a 2-stage ring of `rows`-row chunks when the run is
//     longer than one chunk), so a CTA's whole run is in flight;
//   - scores: a row of d elements is LPR lanes × 16 bytes of q (4 f32 or 8
//     bf16 a lane; 32 bytes, 8 f32, where 16-byte chunks would need more
//     than a warp: f32 at head dim 256; the K row's matching VEC elements,
//     4 or 8 bytes of a byte pool), RPW = 32/LPR rows per warp at a time, each dot product
//     reduced by shuffles over its row's lanes and read once for all GC
//     query rows; P·V: the same rows per warp, VEC columns a lane into
//     GC×VEC registers, summed over the warp's rows by shuffles and over the
//     warps in shared memory, in a fixed order;
//   - chunks of one run are blended in order into the carry, so two calls
//     on the same inputs are bitwise equal.
#pragma once

#include <cuda_fp8.h>

#include <cstdint>

#include "attn_tc.cuh"
#include "flashd_common.cuh"

namespace flashd {
namespace fma {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MERGE_CH = 64;  // splits whose blend weights K2 / K3's merge holds at once

// the rows a chunk stages at most: 64, or 32 at head dim 256, where two
// stages of 64 f32 K and V rows alone would take 256 KB
__host__ __device__ constexpr int max_rows(int hd) { return hd > 128 ? 32 : 64; }

// a row of HD elements as VEC-element chunks (16 bytes of q, or 32 where a
// row has more than 32 chunks of 16): LPR lanes to a row (a power of two ≥
// the chunk count; lanes past it idle), RPW rows to a warp
template <typename TQ, int HD>
struct Geo {
  static constexpr int CH = 16 / (int)sizeof(TQ);
  static constexpr int VEC = HD / CH > 32 ? 2 * CH : CH;
  static constexpr int NCH = HD / VEC;
  static constexpr int LPR = NCH <= 4 ? 4 : NCH <= 8 ? 8 : NCH <= 16 ? 16 : 32;
  static constexpr int RPW = 32 / LPR;
  static constexpr int RPP = NWARPS * RPW;  // rows the CTA covers per pass
  static_assert(HD % VEC == 0 && NCH <= 32, "head dim");
};

template <int GC, int HD>
struct Units {  // the GC×HD partial as float4 units, N per thread
  static constexpr int N = (GC * HD / 4 + NTHREADS - 1) / NTHREADS;
};

__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack16(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = p.x;  // the low half holds the lower address
    f[2 * i + 1] = p.y;
  }
}

// VEC elements at p (shared memory) as floats: 16 bytes of f32 or bf16,
// 4 or 8 bytes of int8 or fp8 (e4m3)
__device__ __forceinline__ void load_vec(const float* p, float (&f)[4]) {
  unpack16(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float (&f)[8]) {
  unpack16(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load_vec(const float* p, float (&f)[8]) {  // 32 bytes
  const uint4 u[2] = {*reinterpret_cast<const uint4*>(p), *reinterpret_cast<const uint4*>(p + 4)};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    f[4 * i] = __uint_as_float(u[i].x);
    f[4 * i + 1] = __uint_as_float(u[i].y);
    f[4 * i + 2] = __uint_as_float(u[i].z);
    f[4 * i + 3] = __uint_as_float(u[i].w);
  }
}
__device__ __forceinline__ void char4_to(const char4 c, float* f) {
  f[0] = (float)c.x;  // .x holds the lowest address
  f[1] = (float)c.y;
  f[2] = (float)c.z;
  f[3] = (float)c.w;
}
__device__ __forceinline__ void load_vec(const signed char* p, float (&f)[4]) {
  char4_to(*reinterpret_cast<const char4*>(p), f);
}
__device__ __forceinline__ void load_vec(const signed char* p, float (&f)[8]) {
  const int2 w = *reinterpret_cast<const int2*>(p);
  char4_to(*reinterpret_cast<const char4*>(&w.x), f);
  char4_to(*reinterpret_cast<const char4*>(&w.y), f + 4);
}
// four e4m3 bytes (the lowest address in the low byte) → floats, exactly:
// e4m3 → half (every e4m3 value is a half) → float
__device__ __forceinline__ void fp8x4_to(const uint32_t w, float* f) {
  const __half2_raw lo = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w & 0xffffu), __NV_E4M3);
  const __half2_raw hi = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w >> 16), __NV_E4M3);
  const float2 a = __half22float2(__half2(lo)), b = __half22float2(__half2(hi));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = b.x;
  f[3] = b.y;
}
__device__ __forceinline__ void load_vec(const __nv_fp8_e4m3* p, float (&f)[4]) {
  fp8x4_to(*reinterpret_cast<const uint32_t*>(p), f);
}
__device__ __forceinline__ void load_vec(const __nv_fp8_e4m3* p, float (&f)[8]) {
  const uint2 w = *reinterpret_cast<const uint2*>(p);
  fp8x4_to(w.x, f);
  fp8x4_to(w.y, f + 4);
}

// Where the K and V rows of one (sequence, kv head) live. Contiguous: k / v
// point at position 0 and row `pos` is pos·ss further. Paged: k / v point at
// the pool plus the kv head's offset, `tbl` at the sequence's block-table
// row, and row `pos` is at page tbl[pos / page], offset pos % page; a byte
// pool's scales `ks` / `vs` point at (page 0, this kv head), page stride hkv.
template <typename TKV, bool PAGED>
struct KVSrc {
  const TKV* k;
  const TKV* v;
  long long k_ss, v_ss;
  long long k_sp, v_sp;
  const int* tbl;
  int page;
  const float* ks;
  const float* vs;
  int hkv;
};

// rows [pos0, pos0 + nr) of K (or V) into an unpadded shared tile [nr][HD],
// one 16-byte asynchronous copy each; a byte pool's row scales into dsc
template <typename TKV, int HD, bool PAGED>
__device__ __forceinline__ void stage_rows(TKV* dst, float* dsc, const TKV* base, long long ss,
                                           long long sp, const float* scales,
                                           const KVSrc<TKV, PAGED>& src, long long pos0, int nr,
                                           int tid) {
  constexpr int CH = 16 / (int)sizeof(TKV), NCH = HD / CH;
  for (int i = tid; i < nr * NCH; i += NTHREADS) {
    const int r = i / NCH, c = i - r * NCH;
    const long long pos = pos0 + r;
    const TKV* row;
    if constexpr (PAGED) {
      const int ip = (int)pos / src.page;  // positions < 2^31
      const long long pid = __ldg(src.tbl + ip);
      row = base + pid * sp + ((int)pos - ip * src.page) * ss;
      if (sizeof(TKV) == 1 && c == 0) dsc[r] = __ldg(scales + pid * src.hkv);
    } else {
      row = base + pos * ss;
    }
    tc::cp_async16(dst + r * HD + c * CH, row + c * CH, true);
  }
}

// the body's dynamic shared memory, one layout for host and device (bytes)
struct Smem {
  size_t s, red, stat, w, lamp, sc, flag, total;
  __host__ __device__ Smem(int elt, int hd, int gc, int rows, int nst) {
    s = (size_t)nst * 2 * rows * hd * elt;          // K and V: [nst][2][rows][hd]
    red = s + sizeof(float) * gc * rows;            // scores, then P: [gc][rows]
    stat = red + sizeof(float) * NWARPS * gc * hd;  // per-warp P·V: [NWARPS][gc][hd]
    w = stat + sizeof(float) * 4 * gc;              // λ_c, c, -, blend weight: [4][gc]
    lamp = w + sizeof(float) * MERGE_CH * gc;       // merge weights: [MERGE_CH][gc]
    sc = lamp + sizeof(float) * MERGE_CH * gc;      // the partials' λ: [MERGE_CH][gc]
    flag = sc + sizeof(float) * nst * 2 * rows;     // byte-pool row scales: [nst][2][rows]
    total = flag + 16;
  }
};

// one step of the in-order FLASH-D blend (_merge_into_carry) of a partial
// with λ `lam_p` into the running Λ: returns its weight w = σ(λ_p − Λ)
// and advances Λ to logaddexp(Λ, λ_p); a dead partial weighs 0, a first
// live one 1. One exp serves both: e = e^{−|λ_p − Λ|}.
__device__ __forceinline__ float blend_step(float& lam_run, float lam_p) {
  if (lam_p <= DEAD) return 0.0f;
  if (lam_run <= DEAD) {
    lam_run = lam_p;
    return 1.0f;
  }
  const float x = lam_p - lam_run, e = expf(-fabsf(x));
  lam_run = fmaxf(lam_run, lam_p) + log1pf(e);
  return (x >= 0.0f ? 1.0f : e) / (1.0f + e);
}

// every row sees every position of the run (K2, K3: the run is already
// clipped to the live range)
struct AllVisible {
  __device__ __forceinline__ bool keep(int, long long) const { return true; }
};

// The run [i0, i0 + n) in chunks of `rows` (a 2-stage ring when nst == 2),
// each chunk's partial blended in order into (carry, lam_run) — the FLASH-D
// carry. G ≤ GC live query rows, row g's q at qrow(g) (16-byte aligned);
// mask.keep(g, pos) drops a (row, position) pair from the scores. Thread
// g < G holds row g's Λ; carry unit u of thread tid is entry
// e = tid + u·NTHREADS of the [G][HD/4] float4 partial.
template <typename TQ, typename TKV, int HD, int GC, bool PAGED, class QRow, class Mask>
__device__ __forceinline__ void split_partial(unsigned char* smem, int G, int rows, int nst,
                                              float scale, const QRow& qrow,
                                              const KVSrc<TKV, PAGED>& src, const Mask& mask,
                                              long long i0, int n,
                                              float (&carry)[Units<GC, HD>::N][4],
                                              float& lam_run) {
  using Gm = Geo<TQ, HD>;
  constexpr int VEC = Gm::VEC, NCH = Gm::NCH, LPR = Gm::LPR, RPW = Gm::RPW, RPP = Gm::RPP;
  constexpr bool QUANT = sizeof(TKV) == 1;
  const Smem L(sizeof(TKV), HD, GC, rows, nst);
  TKV* sKV = reinterpret_cast<TKV*>(smem);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sRed = reinterpret_cast<float*>(smem + L.red);
  float* sStat = reinterpret_cast<float*>(smem + L.stat);
  float* sSc = reinterpret_cast<float*>(smem + L.sc);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rsub = lane / LPR, c = lane % LPR;
  const bool lane_on = c < NCH;

  // this lane's 16-byte chunk of each row's q
  float qr[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < G && lane_on) {
      load_vec(qrow(g) + c * VEC, qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.0f;
    }
  }

  // cp.async groups, in order: K_0, V_0, then K_{j+1}, V_{j+1} per chunk j
  auto stage = [&](int st, int r0, int nr) {
    TKV* dst = sKV + (size_t)st * 2 * rows * HD;
    float* dsc = sSc + st * 2 * rows;
    stage_rows<TKV, HD, PAGED>(dst, dsc, src.k, src.k_ss, src.k_sp, src.ks, src, i0 + r0, nr, tid);
    tc::cp_async_commit();
    stage_rows<TKV, HD, PAGED>(dst + rows * HD, dsc + rows, src.v, src.v_ss, src.v_sp, src.vs, src,
                               i0 + r0, nr, tid);
  };
  const int n_chunks = (n + rows - 1) / rows;
  stage(0, 0, min(rows, n));
  tc::cp_async_commit();

  for (int j = 0; j < n_chunks; ++j) {
    const int st = nst == 2 ? (j & 1) : 0;
    const TKV* sK = sKV + (size_t)st * 2 * rows * HD;
    const TKV* sV = sK + rows * HD;
    const float* sKs = sSc + st * 2 * rows;
    const float* sVs = sKs + rows;
    const int r0 = j * rows, nr = min(rows, n - r0);
    if (j + 1 < n_chunks) {  // the next chunk into the other stage
      stage(st ^ 1, r0 + rows, min(rows, n - r0 - rows));
    } else {
      tc::cp_async_commit();
    }
    tc::cp_async_commit();
    tc::cp_async_wait<3>();  // K_j landed; V_j and the next chunk stay in flight
    __syncthreads();

    // scores: RPW rows per warp at a time, VEC elements a lane, each row's
    // dot product reduced over its LPR lanes; K read once for all G rows
#pragma unroll 4
    for (int rr = warp * RPW; rr < nr; rr += RPP) {
      const int r = rr + rsub;
      float kf[VEC];
      if (lane_on && r < nr) {
        load_vec(sK + r * HD + c * VEC, kf);
        if constexpr (QUANT) {
          const float ksc = sKs[r];
#pragma unroll
          for (int e = 0; e < VEC; ++e) kf[e] *= ksc;
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = 0.0f;
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= G) break;
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qr[g][e], kf[e], d);
#pragma unroll
        for (int off = 1; off < LPR; off <<= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
        if (c == 0 && r < nr) sS[g * rows + r] = mask.keep(g, i0 + r0 + r) ? d * scale : NEG_INF;
      }
    }
    __syncthreads();

    // per-row chunk statistics (_split_partial): one warp per row
    for (int g = warp; g < G; g += NWARPS) {
      float* srow = sS + g * rows;
      float m = NEG_INF;
      for (int i = lane; i < nr; i += 32) m = fmaxf(m, srow[i]);
      m = warp_max(m);
      const float m_safe = fmaxf(m, DEAD);
      float l = 0.0f;
      for (int i = lane; i < nr; i += 32) {
        const float p = expf(srow[i] - m_safe);
        srow[i] = p;
        l += p;
      }
      l = warp_sum(l);
      const float lam = l > 0.0f ? m_safe + logf(fmaxf(l, F32_TINY)) : NEG_INF;
      if (lane == 0) {
        sStat[g] = lam;
        sStat[GC + g] = l > 0.0f ? expf(m_safe - lam) : 0.0f;  // ⇒ pv·c = softmax·V
      }
    }
    tc::cp_async_wait<2>();  // V_j landed
    __syncthreads();

    // P·V: the same rows per warp, VEC columns a lane in registers, summed
    // over the warp's row groups by shuffles, then over warps in order
    float acc[GC][VEC];
#pragma unroll
    for (int g = 0; g < GC; ++g)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][e] = 0.0f;
#pragma unroll 4
    for (int rr = warp * RPW; rr < nr; rr += RPP) {
      const int r = rr + rsub;
      if (!(lane_on && r < nr)) continue;
      float vf[VEC];
      load_vec(sV + r * HD + c * VEC, vf);
      if constexpr (QUANT) {
        const float vsc = sVs[r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) vf[e] *= vsc;
      }
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= G) break;
        const float p = sS[g * rows + r];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
      }
    }
#pragma unroll
    for (int off = LPR; off < 32; off <<= 1)
#pragma unroll
      for (int g = 0; g < GC; ++g)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
    if (rsub == 0 && lane_on) {
#pragma unroll
      for (int g = 0; g < GC; ++g) {
        if (g >= G) break;
        float4* dst = reinterpret_cast<float4*>(sRed + (warp * GC + g) * HD + c * VEC);
#pragma unroll
        for (int e = 0; e < VEC / 4; ++e)
          dst[e] = make_float4(acc[g][4 * e], acc[g][4 * e + 1], acc[g][4 * e + 2],
                               acc[g][4 * e + 3]);
      }
    }
    // the chunk's blend weight per row (_merge_into_carry, chunk order)
    if (tid < G) sStat[3 * GC + tid] = blend_step(lam_run, sStat[tid]);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < Units<GC, HD>::N; ++u) {
      const int e = tid + u * NTHREADS;
      if (e >= G * HD / 4) break;
      const int g = e / (HD / 4), col = (e - g * (HD / 4)) * 4;
      const float cc = sStat[GC + g], w = sStat[3 * GC + g];
      float4 o = *reinterpret_cast<const float4*>(sRed + g * HD + col);
#pragma unroll
      for (int wp = 1; wp < NWARPS; ++wp) {  // warp 0, 1, 2, 3: a fixed order
        const float4 x = *reinterpret_cast<const float4*>(sRed + (wp * GC + g) * HD + col);
        o.x += x.x;
        o.y += x.y;
        o.z += x.z;
        o.w += x.w;
      }
      const float oc[4] = {o.x * cc, o.y * cc, o.z * cc, o.w * cc};
#pragma unroll
      for (int k = 0; k < 4; ++k) carry[u][k] = carry[u][k] + (oc[k] - carry[u][k]) * w;
    }
    __syncthreads();  // sS, sRed and this stage are rewritten by the next chunk
  }
  tc::cp_async_wait<0>();
}

}  // namespace fma
}  // namespace flashd
