// FLASH-D split-K decode for Hopper: the counterparts of the Pallas kernels
// repro/kernels/flashd_decode.py::flashd_decode_pallas (K2: _split_partial,
// _lo_bound, _split_live, _merge_into_carry) and ::flashd_decode_paged_pallas
// (K3: _decode_paged_kernel).
//
// One query token per sequence attends a contiguous KV cache. On the TPU the
// splits were a sequential grid axis with the (acc, Λ) carry in VMEM; here
// blocks run in parallel, so the work is two launches:
//
//   1. decode_split_kernel — one CTA per (split, kv head, batch row). It
//      reads q for the G grouped heads and streams only the live positions
//      [max(lo, lo_bound), min(lo + split, cache_len)) of K and V from the
//      [B, S_max, Hkv, d] cache through its strides, and writes the split's
//      normalised partial (o_p [G, dv], λ_p [G]) to a scratch buffer. A dead
//      split (_split_live false) touches no cache memory and writes the
//      identity partial (0, NEG_INF).
//   2. decode_merge_kernel — blends the partials in split order with the
//      FLASH-D sigmoid, o ← o + (o_p − o)·σ(λ_p − Λ), the same order as the
//      fused Pallas carry, and writes o [B, Hq, dv] (+ Λ [B, Hq]).
//
// Bound on the H100: one query row per head makes decode a pass over the
// live KV bytes (G·2 operations per byte read at most), so memory bandwidth
// bounds it. G = Hq/Hkv can be 1, which no tensor-core tile fits: the dot
// products are f32 FMA on the CUDA cores. Each K row is read once for all G
// heads of its group, and splits spread one sequence over many SMs.
//
// K3, the paged cache: the same two launches with one PAGE per split. K/V
// live in a global pool [P, page, Hkv, d] and each sequence has a block
// table [B, N]; the TPU resolved tbl[b, ip] in its DMA descriptors (scalar
// prefetch), here the split CTA reads tbl[b, ip] itself — only when the
// split is live, so table slots past the live range (the engine parks them
// on the garbage page 0, which may hold anything) are never followed — and
// offsets its K/V pointers to that physical page. The merge runs in page
// order, the order of the TPU's fused carry. An int8 pool comes with one
// f32 scale per (page, kv head); the tile is dequantized as it is loaded
// (x·scale, the reference's order), before the scores.
#include <cfloat>

#include "flashd_common.cuh"

using namespace flashd;

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int G_MAX = 8;  // largest query group per kv head

struct SplitArgs {
  const void* q;      // [B, Hq, d] view
  const void* k;      // contiguous: [B, Hkv, S_max, d] view; paged: pool [P, page, Hkv, d]
  const void* v;      // the same for V
  const int* cache_len;  // [B]
  const int* start;      // [B] or null
  float* o_part;      // [P, B, Hq, dv]
  float* lam_part;    // [P, B, Hq]
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;  // paged: k_sb is the pool's page stride
  long long v_sb, v_sh, v_ss;
  int B, Hq, Hkv, S_max, split, window, chunk;
  float scale;
  const int* tbl;     // [B, N] block table (paged; split == page), or null
  long long tbl_sb;
  const float* ks;    // [P, Hkv] f32 scales of an int8 pool, or null
  const float* vs;
};

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NTHREADS) decode_split_kernel(SplitArgs a) {
  constexpr int NC = (HD + 31) / 32;
  extern __shared__ float smem[];
  const int G = a.Hq / a.Hkv;
  float* sS = smem;               // [G][split] scores, then probabilities
  float* sStat = smem + G * a.split;  // [G] λ_p, then [G] c

  const int ip = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long cache_len = a.cache_len[b];
  const long long start = a.start ? a.start[b] : 0;
  const long long lo = (long long)ip * a.split;

  // _lo_bound: window / chunk structure ∨ the caller's per-row start
  long long lo_bound = start > 0 ? start : 0;
  if (a.window > 0) lo_bound = max(lo_bound, cache_len - a.window);
  if (a.chunk > 0) lo_bound = max(lo_bound, floordiv(cache_len - 1, a.chunk) * a.chunk);
  const bool live = lo < cache_len && lo + a.split > lo_bound;

  const long long part = ((long long)ip * a.B + b) * a.Hq + (long long)hk * G;
  float* op = a.o_part + part * HD;
  float* lp = a.lam_part + part;
  if (!live) {
    for (int idx = tid; idx < G * HD; idx += NTHREADS) op[idx] = 0.0f;
    if (tid < G) lp[tid] = NEG_INF;
    return;
  }
  const long long i0 = max(lo, lo_bound);
  const long long i1 = min(min(lo + a.split, cache_len), (long long)a.S_max);
  const int n = (int)max(i1 - i0, 0LL);

  const TQ* qb = (const TQ*)a.q + b * a.q_sb + (long long)hk * G * a.q_sh;
  // kb / vb point at the split's position lo: row i0 + i is kb[(i0 + i − lo)·k_ss]
  const TKV* kb;
  const TKV* vb;
  float ksc = 1.0f, vsc = 1.0f;
  if (a.tbl != nullptr) {  // paged: this split is logical page ip
    const long long pid = a.tbl[b * a.tbl_sb + ip];
    kb = (const TKV*)a.k + pid * a.k_sb + hk * a.k_sh;
    vb = (const TKV*)a.v + pid * a.v_sb + hk * a.v_sh;
    if (a.ks != nullptr) {
      ksc = a.ks[pid * a.Hkv + hk];
      vsc = a.vs[pid * a.Hkv + hk];
    }
  } else {
    kb = (const TKV*)a.k + b * a.k_sb + hk * a.k_sh + lo * a.k_ss;
    vb = (const TKV*)a.v + b * a.v_sb + hk * a.v_sh + lo * a.v_ss;
  }
  const long long r0 = i0 - lo;  // first live row within the split

  float qr[G_MAX][NC];
#pragma unroll
  for (int g = 0; g < G_MAX; ++g)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      qr[g][j] = (g < G && col < HD) ? to_float(qb[g * a.q_sh + col]) : 0.0f;
    }

  // scores: one warp per cache position, lanes across the head dim; the K
  // row is read once for all G heads of the group
  for (int i = warp; i < n; i += NWARPS) {
    const TKV* krow = kb + (r0 + i) * a.k_ss;
    float kv[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      kv[j] = col < HD ? to_float(krow[col]) * ksc : 0.0f;
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) {
      if (g >= G) break;
      float d = 0.0f;
#pragma unroll
      for (int j = 0; j < NC; ++j) d = fmaf(qr[g][j], kv[j], d);
      d = warp_sum(d);
      if (lane == 0) sS[g * a.split + i] = d * a.scale;
    }
  }
  __syncthreads();

  // per-head split statistics (_split_partial): one warp per head
  for (int g = warp; g < G; g += NWARPS) {
    float* srow = sS + g * a.split;
    float m = NEG_INF;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, srow[i]);
    m = warp_max(m);
    const float m_safe = fmaxf(m, DEAD);
    float l = 0.0f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(srow[i] - m_safe);
      srow[i] = p;
      l += p;
    }
    l = warp_sum(l);
    const float lam = l > 0.0f ? m_safe + logf(fmaxf(l, F32_TINY)) : NEG_INF;
    if (lane == 0) {
      sStat[g] = lam;
      sStat[G + g] = l > 0.0f ? expf(m_safe - lam) : 0.0f;  // ⇒ pv·c = softmax·V
    }
  }
  __syncthreads();

  // P·V: one thread per output column, V rows read coalesced
  for (int col = tid; col < HD; col += NTHREADS) {
    float acc[G_MAX];
#pragma unroll
    for (int g = 0; g < G_MAX; ++g) acc[g] = 0.0f;
    for (int i = 0; i < n; ++i) {
      const float vv = to_float(vb[(r0 + i) * a.v_ss + col]) * vsc;
#pragma unroll
      for (int g = 0; g < G_MAX; ++g)
        if (g < G) acc[g] = fmaf(sS[g * a.split + i], vv, acc[g]);
    }
#pragma unroll
    for (int g = 0; g < G_MAX; ++g)
      if (g < G) op[g * HD + col] = acc[g] * sStat[G + g];
  }
  if (tid < G) lp[tid] = sStat[tid];
}

// sequential FLASH-D blend of the P partials of one (b, hq) row, in split
// order — _merge_into_carry applied along what was the TPU's split axis
template <typename T>
__global__ void decode_merge_kernel(const float* o_part, const float* lam_part, T* o,
                                    float* lam_out, int P, int BH, int dv) {
  const int bh = blockIdx.x, col = threadIdx.x;
  float acc = 0.0f, lam_run = NEG_INF;
  for (int p = 0; p < P; ++p) {
    const long long row = (long long)p * BH + bh;
    const float lam_p = lam_part[row];
    const float o_p = col < dv ? o_part[row * dv + col] : 0.0f;
    const bool dead_b = lam_p <= DEAD, dead_a = lam_run <= DEAD;
    float w = sigmoid(lam_p - lam_run);
    w = dead_b ? 0.0f : (dead_a ? 1.0f : w);
    acc = acc + (o_p - acc) * w;
    const float ln_w1 = log_sigmoid(lam_run - lam_p);  // ln(1 − w)
    lam_run = dead_b ? lam_run : (dead_a ? lam_p : lam_run - ln_w1);
  }
  if (col < dv) o[(long long)bh * dv + col] = from_float<T>(acc);
  if (lam_out != nullptr && col == 0) lam_out[bh] = lam_run;
}

size_t split_smem_bytes(int G, int split) {
  return sizeof(float) * ((size_t)G * split + 2 * G);
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch_split(const SplitArgs& a, int n_splits, cudaStream_t stream) {
  const size_t bytes = split_smem_bytes(a.Hq / a.Hkv, a.split);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_split_kernel<TQ, TKV, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(n_splits, a.Hkv, a.B);
  decode_split_kernel<TQ, TKV, HD><<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(int hd, const SplitArgs& a, int n_splits, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_split<TQ, TKV, 32>(a, n_splits, stream);
    case 48: return launch_split<TQ, TKV, 48>(a, n_splits, stream);
    case 64: return launch_split<TQ, TKV, 64>(a, n_splits, stream);
    case 128: return launch_split<TQ, TKV, 128>(a, n_splits, stream);
    default: return cudaErrorInvalidValue;
  }
}

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (K/V only)
cudaError_t dispatch_types(int q_type, int kv_type, int hd, const SplitArgs& a, int n_splits,
                           cudaStream_t s) {
  if (q_type == 0 && kv_type == 0) return dispatch_hd<float, float>(hd, a, n_splits, s);
  if (q_type == 1 && kv_type == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a, n_splits, s);
  if (q_type == 0 && kv_type == 2) return dispatch_hd<float, signed char>(hd, a, n_splits, s);
  if (q_type == 1 && kv_type == 2)
    return dispatch_hd<__nv_bfloat16, signed char>(hd, a, n_splits, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_merge(const float* o_part, const float* lam_part, void* o, float* lam_out,
                         int P, int B, int Hq, int dv, cudaStream_t s) {
  const int threads = ((dv + 31) / 32) * 32;
  decode_merge_kernel<T><<<B * Hq, threads, 0, s>>>(o_part, lam_part, (T*)o, lam_out, P,
                                                    B * Hq, dv);
  return cudaGetLastError();
}

}  // namespace

// Launch 1: per-split partials into o_part [P, B, Hq, hd] / lam_part [P, B, Hq].
extern "C" int flashd_decode_split_launch(
    const void* q, const void* k, const void* v, const int* cache_len, const int* start,
    float* o_part, float* lam_part,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    int B, int Hq, int Hkv, int S_max, int hd, int is_bf16,
    int n_splits, int split, int window, int chunk, float scale, void* stream) {
  if (B == 0 || n_splits == 0) return (int)cudaGetLastError();
  if (Hq % Hkv != 0 || Hq / Hkv > G_MAX || split < 1) return (int)cudaErrorInvalidValue;
  SplitArgs a{q, k, v, cache_len, start, o_part, lam_part,
              q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
              B, Hq, Hkv, S_max, split, window, chunk, scale,
              nullptr, 0, nullptr, nullptr};
  const int t = is_bf16 ? 1 : 0;
  return (int)dispatch_types(t, t, hd, a, n_splits, (cudaStream_t)stream);
}

// Launch 2: the in-order sigmoid merge into o [B, Hq, dv] (q's dtype) and,
// when lam_out is not null, Λ [B, Hq].
extern "C" int flashd_decode_merge_launch(
    const float* o_part, const float* lam_part, void* o, float* lam_out,
    int P, int B, int Hq, int dv, int is_bf16, void* stream) {
  if (B == 0 || Hq == 0) return (int)cudaGetLastError();
  if (dv < 1 || dv > 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(is_bf16 ? launch_merge<__nv_bfloat16>(o_part, lam_part, o, lam_out, P, B, Hq, dv, s)
                       : launch_merge<float>(o_part, lam_part, o, lam_out, P, B, Hq, dv, s));
}

// K3: one-token decode through a block table — the split launch with one
// page per split over pools [P, page, Hkv, d] (element strides k_sp, k_ss,
// k_sh), then the in-page-order merge into o [B, Hq, dv] (q's dtype).
// q_type / kv_type: 0 float32, 1 bfloat16, 2 int8 (then ks / vs [P, Hkv]
// f32 are the per-(page, head) scales; null otherwise). o_part / lam_part
// are scratch [N, B, Hq, dv] / [N, B, Hq].
extern "C" int flashd_decode_paged_launch(
    const void* q, const void* k_pages, const void* v_pages, const int* tbl,
    const int* cache_len, const float* ks, const float* vs,
    float* o_part, float* lam_part, void* o,
    long long q_sb, long long q_sh,
    long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long tbl_sb,
    int B, int Hq, int Hkv, int n_tbl, int page, int hd, int q_type, int kv_type,
    int window, int chunk, float scale, void* stream) {
  if (B == 0 || Hq == 0) return (int)cudaGetLastError();
  if (Hq % Hkv != 0 || Hq / Hkv > G_MAX || page < 1 || n_tbl < 1 || hd > 1024)
    return (int)cudaErrorInvalidValue;
  if ((kv_type == 2) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
  SplitArgs a{q, k_pages, v_pages, cache_len, nullptr, o_part, lam_part,
              q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss,
              B, Hq, Hkv, n_tbl * page, page, window, chunk, scale,
              tbl, tbl_sb, ks, vs};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = dispatch_types(q_type, kv_type, hd, a, n_tbl, s);
  if (e != cudaSuccess) return (int)e;
  e = q_type == 1 ? launch_merge<__nv_bfloat16>(o_part, lam_part, o, nullptr, n_tbl, B, Hq, hd, s)
                  : launch_merge<float>(o_part, lam_part, o, nullptr, n_tbl, B, Hq, hd, s);
  return (int)e;
}
