// K2 / K3's kernel (flashd_decode.cu explains its design): everything but
// the C entry points, shared by the translation units that instantiate it —
// flashd_decode.cu (head dims 16, 32), flashd_decode_hd64.cu (48, 64),
// flashd_decode_hd128.cu (96, 128) and flashd_decode_hd256.cu (256), which
// nvcc compiles at once (kernels/_build.py UNITS).
#pragma once

#include <cfloat>

#include "decode_fma.cuh"

namespace flashd {
namespace decode {

using namespace fma;

constexpr int G_MAX = 16;  // largest query group per kv head
constexpr int GC_MAX = 8;  // largest group a CTA takes; larger ones take ⌈G / 8⌉ CTAs

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
  int* arrivals;         // [B, Hkv·⌈G / GC⌉], zero on entry; null: write the partials only
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;  // K3: k_sb is the pool's page stride
  long long v_sb, v_sh, v_ss;
  int B, Hq, Hkv, S_max, n_splits, split, rows, window, chunk;
  float scale;
  const int* tbl;        // K3: [B, N] block table
  long long tbl_sb;
  int page;
  const float* ks;       // K3 with a byte pool: [P, Hkv] f32 scales; else null
  const float* vs;
};

__host__ __device__ __forceinline__ int stages(const Args& a) { return a.split > a.rows ? 2 : 1; }

// The last CTA of (b, heads h0 … h0 + G − 1) to arrive blends the n_splits
// partials of those G heads in split order — the fused Pallas carry's
// order, whichever CTA runs it, so repeated calls are bitwise equal.
template <typename TQ, typename TKV, int HD, int GC>
__device__ __forceinline__ void merge_splits(const Args& a, unsigned char* smem, int G, int h0,
                                             int b) {
  const Smem L(sizeof(TKV), HD, GC, a.rows, stages(a));
  float* sW = reinterpret_cast<float*>(smem + L.w);
  float* sLamP = reinterpret_cast<float*>(smem + L.lamp);
  const int tid = threadIdx.x;
  const long long row0 = (long long)b * a.Hq + h0;  // (b, first head) in [B, Hq]
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
struct HeadRows {  // row g of the CTA's heads: q head h0 + g of batch row b
  const TQ* base;
  long long sh;
  __device__ __forceinline__ const TQ* operator()(int g) const { return base + g * sh; }
};

// CTA (split, kv head × sub-group, batch row): the split's partial for its
// G ≤ GC heads of the group; fused, the arrival count and, in the last CTA,
// the merge
template <typename TQ, typename TKV, int HD, int GC, bool PAGED>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group = a.Hq / a.Hkv, nsub = (group + GC - 1) / GC;
  const int ip = blockIdx.x, hk = blockIdx.y / nsub, b = blockIdx.z;
  const int sub = blockIdx.y - hk * nsub;
  const int h0 = hk * group + sub * GC;  // this CTA's first q head
  const int G = min(GC, group - sub * GC);
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
    const HeadRows<TQ> qrow{(const TQ*)a.q + b * a.q_sb + (long long)h0 * a.q_sh, a.q_sh};
    split_partial<TQ, TKV, HD, GC, PAGED>(smem, G, a.rows, stages(a), a.scale, qrow, src,
                                          AllVisible{}, i0, n, carry, lam_run);
  }

  const long long prow = ((long long)ip * a.B + b) * a.Hq + h0;
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
    *sFlag = atomicAdd(a.arrivals + (long long)b * gridDim.y + blockIdx.y, 1) == a.n_splits - 1;
  }
  __syncthreads();
  if (!*sFlag) return;
  __threadfence();
  merge_splits<TQ, TKV, HD, GC>(a, smem, G, h0, b);
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
  const int group = a.Hq / a.Hkv;
  const dim3 grid(a.n_splits, a.Hkv * ((group + GC - 1) / GC), a.B);
  decode_kernel<TQ, TKV, HD, GC, PAGED><<<grid, NTHREADS, L.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV, int HD, bool PAGED>
cudaError_t dispatch_group(const Args& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<TQ, TKV, HD, 1, PAGED>(a, stream);
  if (G <= 2) return launch<TQ, TKV, HD, 2, PAGED>(a, stream);
  if (G <= 4) return launch<TQ, TKV, HD, 4, PAGED>(a, stream);
  return launch<TQ, TKV, HD, GC_MAX, PAGED>(a, stream);  // G 9–16: two CTAs of up to 8 heads
}

// every (q, kv) dtype pair the entry points take at one head dim: q_type /
// kv_type 0 float32, 1 bfloat16, 2 int8, 3 fp8 e4m3 (2 and 3 paged only)
template <int HD>
cudaError_t dispatch_types(const Args& a, int q_type, int kv_type, bool paged,
                           cudaStream_t s) {
  if (!paged) {
    if (q_type == 0 && kv_type == 0) return dispatch_group<float, float, HD, false>(a, s);
    if (q_type == 1 && kv_type == 1)
      return dispatch_group<__nv_bfloat16, __nv_bfloat16, HD, false>(a, s);
    return cudaErrorInvalidValue;
  }
  if (q_type == 0 && kv_type == 0) return dispatch_group<float, float, HD, true>(a, s);
  if (q_type == 1 && kv_type == 1) return dispatch_group<__nv_bfloat16, __nv_bfloat16, HD, true>(a, s);
  if (q_type == 0 && kv_type == 2) return dispatch_group<float, signed char, HD, true>(a, s);
  if (q_type == 1 && kv_type == 2) return dispatch_group<__nv_bfloat16, signed char, HD, true>(a, s);
  if (q_type == 0 && kv_type == 3) return dispatch_group<float, __nv_fp8_e4m3, HD, true>(a, s);
  if (q_type == 1 && kv_type == 3) return dispatch_group<__nv_bfloat16, __nv_fp8_e4m3, HD, true>(a, s);
  return cudaErrorInvalidValue;
}

// one per built head dim, each defined in the translation unit named above
#define FLASHD_DECODE_HD(HD)                                                            \
  cudaError_t decode_hd##HD(const Args& a, int q_type, int kv_type, bool paged,         \
                            cudaStream_t s)
FLASHD_DECODE_HD(16);
FLASHD_DECODE_HD(32);
FLASHD_DECODE_HD(48);
FLASHD_DECODE_HD(64);
FLASHD_DECODE_HD(96);
FLASHD_DECODE_HD(128);
FLASHD_DECODE_HD(256);

}  // namespace decode
}  // namespace flashd
