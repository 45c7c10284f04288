// FLASH-D split-K decode for Hopper: the counterparts of the Pallas kernels
// repro/kernels/flashd_decode.py::flashd_decode_pallas (K2: _split_partial,
// _lo_bound, _split_live, _merge_into_carry) and ::flashd_decode_paged_pallas
// (K3: _decode_paged_kernel).
//
// One query token per sequence attends its KV cache. On the TPU the splits
// were a sequential grid axis with the (acc, Λ) carry in VMEM; here CTAs
// over (split, kv head, batch row) run in parallel, each writes its split's
// normalised partial (o_p [G, d], λ_p [G]), and the partials are blended
// with the FLASH-D sigmoid in split order, o ← o + (o_p − o)·σ(λ_p − Λ),
// the fused Pallas carry's order. A dead split (_split_live false) touches
// no cache memory and leaves the identity partial (0, NEG_INF).
//
// Bound on the H100: one query row per head makes decode a pass over the
// live K/V bytes (at most G·2 flops per element read), so memory bandwidth
// bounds it: live bytes over 3.35 TB/s. G = Hq/Hkv can be 1, which no
// tensor-core tile fits: the dot products are f32 FMA on the CUDA cores.
//
// K2 (the contiguous cache [B, S_max, Hkv, d], read through strides) and K3
// (pools [P, page, Hkv, d] through a block table [B, N]) are one kernel,
// decode_kernel<…, PAGED>, and each is one launch. Its design is about
// keeping HBM busy:
//   - the caller picks the split from (B, Hkv, S_max, SM count) so that
//     2–4 CTAs sit on every SM (kernels/flashd_decode.py::gpu_decode_splits;
//     K3 takes S_max = N·page). A split is a run of logical positions, not
//     a page: with pages of 4–16 a split spans several pages, with pages of
//     64 a page spans several splits;
//   - a CTA stages its split's live K and V rows with 16-byte cp.async
//     copies, all issued at once (decode_fma.cuh: the body, the scores and
//     P·V are there), so its whole split is in flight. K3's row i is at
//     page tbl[b, i / page], offset i % page: the TPU resolved the table in
//     its DMA descriptors (scalar prefetch), here the copying thread reads
//     the entry — only for live rows, so table slots past the live range
//     (the engine parks them on the garbage page 0, which may hold
//     anything) are never followed. An int8 pool is staged as bytes with
//     its (page, kv head) scale beside each row and dequantized as a lane
//     reads it (x·scale, the reference's order), before the scores;
//   - fused, each CTA counts itself into a per-(b, kv head) arrival
//     counter after its partial is visible; the last to arrive blends all
//     n_splits partials in split order and writes O (and Λ). Which CTA
//     merges varies, the order does not: repeated calls are bitwise equal.
//     Unfused (K2 only), the kernel writes the partials only
//     (merge_partials runs).
#include <cfloat>

#include "decode_fma.cuh"

using namespace flashd;
using namespace flashd::fma;

namespace {

constexpr int G_MAX = 8;  // largest query group per kv head

struct Args {
  const void* q;         // [B, Hq, d] view
  const void* k;         // K2: [B, Hkv, S_max, d] view; K3: pool [P, page, Hkv, d]
  const void* v;
  const int* cache_len;  // [B]
  const int* start;      // [B] or null
  float* o_part;         // [n_splits, B, Hq, d]
  float* lam_part;       // [n_splits, B, Hq]
  void* o;               // [B, Hq, d] in q's dtype (fused)
  float* lam;            // [B, Hq] or null
  int* arrivals;         // [B, Hkv], zero on entry; null: write the partials only
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;  // K3: k_sb is the pool's page stride
  long long v_sb, v_sh, v_ss;
  int B, Hq, Hkv, S_max, n_splits, split, rows, window, chunk;
  float scale;
  const int* tbl;        // K3: [B, N] block table
  long long tbl_sb;
  int page;
  const float* ks;       // K3 with an int8 pool: [P, Hkv] f32 scales; else null
  const float* vs;
};

__host__ __device__ __forceinline__ int stages(const Args& a) { return a.split > a.rows ? 2 : 1; }

// The last CTA of (b, kv head) to arrive blends the n_splits partials of
// its G heads in split order — the fused Pallas carry's order, whichever
// CTA runs it, so repeated calls are bitwise equal.
template <typename TQ, typename TKV, int HD, int GC>
__device__ __forceinline__ void merge_splits(const Args& a, unsigned char* smem, int G, int hk,
                                             int b) {
  const Smem L(sizeof(TKV), HD, GC, a.rows, stages(a));
  float* sW = reinterpret_cast<float*>(smem + L.w);
  float* sLamP = reinterpret_cast<float*>(smem + L.lamp);
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * a.Hq + (long long)hk * G;  // (b, first head) in [B, Hq]
  const long long stride = (long long)a.B * a.Hq;                   // partial rows per split
  float acc[Units<GC, HD>::N][4];
#pragma unroll
  for (int u = 0; u < Units<GC, HD>::N; ++u) acc[u][0] = acc[u][1] = acc[u][2] = acc[u][3] = 0.0f;
  float lam_run = NEG_INF;
  for (int s0 = 0; s0 < a.n_splits; s0 += MERGE_CH) {
    const int ns = min(MERGE_CH, a.n_splits - s0);
    for (int i = tid; i < ns * G; i += NTHREADS) {
      const int s = i / G, g = i - s * G;
      sLamP[s * GC + g] = __ldcg(a.lam_part + (s0 + s) * stride + row0 + g);
    }
    __syncthreads();
    if (tid < G)
      for (int s = 0; s < ns; ++s) sW[s * GC + tid] = blend_step(lam_run, sLamP[s * GC + tid]);
    __syncthreads();
#pragma unroll
    for (int u = 0; u < Units<GC, HD>::N; ++u) {
      const int e = tid + u * NTHREADS;
      if (e >= G * HD / 4) break;
      const int g = e / (HD / 4), col = (e - g * (HD / 4)) * 4;
      const float* src = a.o_part + ((s0 * stride + row0 + g) * HD + col);
      for (int s1 = 0; s1 < ns; s1 += 8) {  // 8 partials' loads in flight, then their blends
        float4 x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          if (s1 + i < ns) x[i] = __ldcg(reinterpret_cast<const float4*>(src + (s1 + i) * stride * HD));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (s1 + i >= ns) break;
          const float w = sW[(s1 + i) * GC + g];  // 0 for a dead partial: the identity
          acc[u][0] = acc[u][0] + (x[i].x - acc[u][0]) * w;
          acc[u][1] = acc[u][1] + (x[i].y - acc[u][1]) * w;
          acc[u][2] = acc[u][2] + (x[i].z - acc[u][2]) * w;
          acc[u][3] = acc[u][3] + (x[i].w - acc[u][3]) * w;
        }
      }
    }
    __syncthreads();  // sW and sLamP are refilled by the next group of splits
  }
  TQ* ob = (TQ*)a.o + row0 * HD;
#pragma unroll
  for (int u = 0; u < Units<GC, HD>::N; ++u) {
    const int e = tid + u * NTHREADS;
    if (e >= G * HD / 4) break;
    const int g = e / (HD / 4), col = (e - g * (HD / 4)) * 4;
    tc::store2(ob + g * HD + col, acc[u][0], acc[u][1]);
    tc::store2(ob + g * HD + col + 2, acc[u][2], acc[u][3]);
  }
  if (a.lam != nullptr && tid < G) a.lam[row0 + tid] = lam_run;
}

template <typename TQ>
struct HeadRows {  // row g of the group: q head hk·G + g of batch row b
  const TQ* base;
  long long sh;
  __device__ __forceinline__ const TQ* operator()(int g) const { return base + g * sh; }
};

// CTA (split, kv head, batch row): the split's partial for the G heads of
// the group; fused, the arrival count and, in the last CTA, the merge
template <typename TQ, typename TKV, int HD, int GC, bool PAGED>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = a.Hq / a.Hkv;
  const int ip = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const long long cache_len = a.cache_len[b];
  const long long start = a.start ? a.start[b] : 0;
  const long long lo = (long long)ip * a.split;

  // _lo_bound: window / chunk structure ∨ the caller's per-row start;
  // _split_live narrowed to the rows the split reads: n == 0 ⇒ dead
  long long lo_bound = start > 0 ? start : 0;
  if (a.window > 0) lo_bound = max(lo_bound, cache_len - a.window);
  if (a.chunk > 0) lo_bound = max(lo_bound, floordiv(cache_len - 1, a.chunk) * a.chunk);
  const long long i0 = max(lo, lo_bound);
  const long long i1 = min(min(lo + a.split, cache_len), (long long)a.S_max);
  const int n = (int)max(i1 - i0, 0LL);

  float carry[Units<GC, HD>::N][4];
#pragma unroll
  for (int u = 0; u < Units<GC, HD>::N; ++u)
    carry[u][0] = carry[u][1] = carry[u][2] = carry[u][3] = 0.0f;
  float lam_run = NEG_INF;
  // a dead split touches no cache memory: its partial is the identity (0, NEG_INF)
  if (n > 0) {
    KVSrc<TKV, PAGED> src;
    if constexpr (PAGED) {
      src = {(const TKV*)a.k + hk * a.k_sh, (const TKV*)a.v + hk * a.v_sh, a.k_ss, a.v_ss,
             a.k_sb, a.v_sb, a.tbl + b * a.tbl_sb, a.page,
             a.ks ? a.ks + hk : nullptr, a.vs ? a.vs + hk : nullptr, a.Hkv};
    } else {
      src = {(const TKV*)a.k + b * a.k_sb + hk * a.k_sh, (const TKV*)a.v + b * a.v_sb + hk * a.v_sh,
             a.k_ss, a.v_ss, 0, 0, nullptr, 1, nullptr, nullptr, a.Hkv};
    }
    const HeadRows<TQ> qrow{(const TQ*)a.q + b * a.q_sb + (long long)hk * G * a.q_sh, a.q_sh};
    split_partial<TQ, TKV, HD, GC, PAGED>(smem, G, a.rows, stages(a), a.scale, qrow, src,
                                          AllVisible{}, i0, n, carry, lam_run);
  }

  const long long prow = ((long long)ip * a.B + b) * a.Hq + (long long)hk * G;
  float4* op = reinterpret_cast<float4*>(a.o_part + prow * HD);
#pragma unroll
  for (int u = 0; u < Units<GC, HD>::N; ++u) {
    const int e = tid + u * NTHREADS;
    if (e >= G * HD / 4) break;
    op[e] = make_float4(carry[u][0], carry[u][1], carry[u][2], carry[u][3]);
  }
  if (tid < G) a.lam_part[prow + tid] = lam_run;
  if (a.arrivals == nullptr) return;

  int* sFlag = reinterpret_cast<int*>(smem + Smem(sizeof(TKV), HD, GC, a.rows, stages(a)).flag);
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // (cumulative) the CTA's partial is visible device-wide before it counts
    *sFlag = atomicAdd(a.arrivals + (long long)b * a.Hkv + hk, 1) == a.n_splits - 1;
  }
  __syncthreads();
  if (!*sFlag) return;
  __threadfence();
  merge_splits<TQ, TKV, HD, GC>(a, smem, G, hk, b);
}

template <typename TQ, typename TKV, int HD, int GC, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const Smem L(sizeof(TKV), HD, GC, a.rows, stages(a));
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<TQ, TKV, HD, GC, PAGED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.n_splits, a.Hkv, a.B);
  decode_kernel<TQ, TKV, HD, GC, PAGED><<<grid, NTHREADS, L.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD, bool PAGED>
cudaError_t dispatch_group(const Args& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<TQ, TKV, HD, 1, PAGED>(a, stream);
  if (G <= 2) return launch<TQ, TKV, HD, 2, PAGED>(a, stream);
  if (G <= 4) return launch<TQ, TKV, HD, 4, PAGED>(a, stream);
  return launch<TQ, TKV, HD, 8, PAGED>(a, stream);
}

template <typename TQ, typename TKV, bool PAGED>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_group<TQ, TKV, 32, PAGED>(a, stream);
    case 48: return dispatch_group<TQ, TKV, 48, PAGED>(a, stream);
    case 64: return dispatch_group<TQ, TKV, 64, PAGED>(a, stream);
    case 128: return dispatch_group<TQ, TKV, 128, PAGED>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

bool bad_split(int Hq, int Hkv, int split, int rows) {
  return Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > G_MAX || split < 1 ||
         rows != min((split + 3) / 4 * 4, 64);
}

}  // namespace

// K2: one-token decode over the contiguous cache, one launch. Writes the
// split partials o_part [n_splits, B, Hq, hd] / lam_part [n_splits, B, Hq];
// with `arrivals` ([B·Hkv] int32 scratch, zeroed here) it also merges them
// in split order into o [B, Hq, hd] (q's dtype) and, when lam_out is not
// null, Λ [B, Hq]. `rows` (a multiple of 4, ≤ 64) is the CTA's chunk.
extern "C" int flashd_decode_launch(
    const void* q, const void* k, const void* v, const int* cache_len, const int* start,
    float* o_part, float* lam_part, void* o, float* lam_out, int* arrivals,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    int B, int Hq, int Hkv, int S_max, int hd, int is_bf16,
    int n_splits, int split, int rows, int window, int chunk, float scale, void* stream) {
  if (B == 0 || n_splits == 0) return (int)cudaGetLastError();
  if (bad_split(Hq, Hkv, split, rows)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (arrivals != nullptr) {
    cudaError_t e = cudaMemsetAsync(arrivals, 0, sizeof(int) * B * Hkv, s);
    if (e != cudaSuccess) return (int)e;
  }
  Args a{q, k, v, cache_len, start, o_part, lam_part, o, lam_out, arrivals,
         q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         B, Hq, Hkv, S_max, n_splits, split, rows, window, chunk, scale,
         nullptr, 0, 1, nullptr, nullptr};
  return (int)(is_bf16 ? dispatch_hd<__nv_bfloat16, __nv_bfloat16, false>(hd, a, s)
                       : dispatch_hd<float, float, false>(hd, a, s));
}

// K3: one-token decode through a block table, one launch: the same kernel
// with row i of a sequence at page tbl[b, i / page] of the pools
// [P, page, Hkv, d] (element strides k_sp, k_ss, k_sh), split over
// n_splits runs of `split` positions of S_max = n_tbl·page, merged in split
// order into o [B, Hq, hd] (q's dtype). q_type / kv_type: 0 float32,
// 1 bfloat16, 2 int8 (then ks / vs [P, Hkv] f32 are the per-(page, head)
// scales; null otherwise). o_part / lam_part are scratch [n_splits, B, Hq,
// hd] / [n_splits, B, Hq]; arrivals [B·Hkv] int32, zeroed here.
extern "C" int flashd_decode_paged_launch(
    const void* q, const void* k_pages, const void* v_pages, const int* tbl,
    const int* cache_len, const float* ks, const float* vs,
    float* o_part, float* lam_part, void* o, int* arrivals,
    long long q_sb, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long tbl_sb,
    int B, int Hq, int Hkv, int n_tbl, int page, int hd, int q_type, int kv_type,
    int n_splits, int split, int rows, int window, int chunk, float scale, void* stream) {
  if (B == 0 || Hq == 0 || n_splits == 0) return (int)cudaGetLastError();
  if (bad_split(Hq, Hkv, split, rows) || page < 1 || n_tbl < 1 ||
      (long long)n_splits * split < (long long)n_tbl * page)
    return (int)cudaErrorInvalidValue;
  if ((kv_type == 2) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(arrivals, 0, sizeof(int) * B * Hkv, s);
  if (e != cudaSuccess) return (int)e;
  Args a{q, k_pages, v_pages, cache_len, nullptr, o_part, lam_part, o, nullptr, arrivals,
         q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss,
         B, Hq, Hkv, n_tbl * page, n_splits, split, rows, window, chunk, scale,
         tbl, tbl_sb, page, ks, vs};
  if (q_type == 0 && kv_type == 0) e = dispatch_hd<float, float, true>(hd, a, s);
  else if (q_type == 1 && kv_type == 1) e = dispatch_hd<__nv_bfloat16, __nv_bfloat16, true>(hd, a, s);
  else if (q_type == 0 && kv_type == 2) e = dispatch_hd<float, signed char, true>(hd, a, s);
  else if (q_type == 1 && kv_type == 2) e = dispatch_hd<__nv_bfloat16, signed char, true>(hd, a, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
