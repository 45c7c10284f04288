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
// K2, the contiguous cache [B, S_max, Hkv, d] (read through strides), is
// one launch (k2::decode_kernel). Its design is about keeping HBM busy:
//   - the caller picks the split from (B, Hkv, S_max, SM count) so that
//     2–4 CTAs sit on every SM (kernels/flashd_decode.py::gpu_decode_splits);
//   - a CTA stages its split's live K and V rows with 16-byte cp.async
//     copies, all issued at once (a 2-stage ring of 64-row chunks when a
//     caller's split is longer), so its whole split is in flight;
//   - scores: a row of d elements is LPR lanes × 16 bytes (8 bf16 or 4 f32
//     a lane), RPW = 32/LPR rows per warp at a time, each dot product
//     reduced by shuffles over its row's lanes and read once for all G
//     heads; P·V: the same rows per warp, 16 bytes of V a lane into G×VEC
//     registers, summed over the warp's rows by shuffles and over the
//     warps in shared memory, in a fixed order;
//   - fused, each CTA counts itself into a per-(b, kv head) arrival
//     counter after its partial is visible; the last to arrive blends all
//     n_splits partials in split order and writes O (and Λ). Which CTA
//     merges varies, the order does not: repeated calls are bitwise equal.
//     Unfused, the kernel writes the partials only (merge_partials runs).
//
// K3, the paged cache, keeps the two-launch body below (decode_split_kernel
// + decode_merge_kernel) with one PAGE per split: K/V live in a global pool
// [P, page, Hkv, d] and each sequence has a block table [B, N]; the TPU
// resolved tbl[b, ip] in its DMA descriptors (scalar prefetch), here the
// split CTA reads tbl[b, ip] itself — only when the split is live, so table
// slots past the live range (the engine parks them on the garbage page 0,
// which may hold anything) are never followed — and offsets its K/V
// pointers to that physical page. The merge runs in page order, the order
// of the TPU's fused carry. An int8 pool comes with one f32 scale per
// (page, kv head); the tile is dequantized as it is loaded (x·scale, the
// reference's order), before the scores.
#include <cfloat>

#include "attn_tc.cuh"
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

// ---- K2: the contiguous cache, one launch ----

namespace k2 {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MERGE_CH = 64;  // splits whose blend weights the merge holds at once

struct Args {
  const void* q;         // [B, Hq, d] view
  const void* k;         // [B, Hkv, S_max, d] view
  const void* v;
  const int* cache_len;  // [B]
  const int* start;      // [B] or null
  float* o_part;         // [P, B, Hq, d]
  float* lam_part;       // [P, B, Hq]
  void* o;               // [B, Hq, d] in q's dtype (fused)
  float* lam;            // [B, Hq] or null
  int* arrivals;         // [B, Hkv], zero on entry; null: write the partials only
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  int B, Hq, Hkv, S_max, n_splits, split, rows, window, chunk;
  float scale;
};

// a row of HD elements as 16-byte chunks: LPR lanes to a row (a power of
// two ≥ the chunk count; lanes past it idle), RPW rows to a warp
template <typename T, int HD>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16-byte chunk
  static constexpr int NCH = HD / VEC;
  static constexpr int LPR = NCH <= 4 ? 4 : NCH <= 8 ? 8 : NCH <= 16 ? 16 : 32;
  static constexpr int RPW = 32 / LPR;
  static constexpr int RPP = NWARPS * RPW;  // rows the CTA covers per pass
  static_assert(HD % VEC == 0 && NCH <= 32, "head dim");
};

template <int GC, int HD>
struct Units {  // the G×HD partial as float4 units, UNITS per thread
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

// rows [r0, r0 + nr) of a [rows, HD] view (row stride ss) into an
// unpadded shared tile, one 16-byte asynchronous copy each
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long long ss, int r0, int nr,
                                           int tid) {
  constexpr int VEC = Geo<T, HD>::VEC, NCH = Geo<T, HD>::NCH;
  for (int i = tid; i < nr * NCH; i += NTHREADS) {
    const int r = i / NCH, c = i - r * NCH;
    tc::cp_async16(dst + r * HD + c * VEC, src + (r0 + r) * ss + c * VEC, true);
  }
}

// the dynamic shared memory, one layout for host and device (byte offsets)
struct Smem {
  size_t s, red, stat, w, lamp, flag, total;
  __host__ __device__ Smem(int elt, int hd, int gc, int rows, int nst) {
    s = (size_t)nst * 2 * rows * hd * elt;          // K and V: [nst][2][rows][hd]
    red = s + sizeof(float) * gc * rows;            // scores, then P: [gc][rows]
    stat = red + sizeof(float) * NWARPS * gc * hd;  // per-warp P·V: [NWARPS][gc][hd]
    w = stat + sizeof(float) * 4 * gc;              // λ_c, c, -, blend weight: [4][gc]
    lamp = w + sizeof(float) * MERGE_CH * gc;       // merge weights: [MERGE_CH][gc]
    flag = lamp + sizeof(float) * MERGE_CH * gc;    // the partials' λ: [MERGE_CH][gc]
    total = flag + 16;
  }
};

__device__ __forceinline__ int stages(const Args& a) { return a.split > a.rows ? 2 : 1; }

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

// The split's live rows [i0, i0 + n) in chunks of a.rows, each chunk's
// partial blended in order into (carry, lam_run) — the FLASH-D carry; with
// the default splits there is one chunk. Thread g < G holds head g's Λ.
template <typename T, int HD, int GC>
__device__ __forceinline__ void split_partial(const Args& a, unsigned char* smem, int G,
                                              long long i0, int n, int hk, int b,
                                              float (&carry)[Units<GC, HD>::N][4],
                                              float& lam_run) {
  using Gm = Geo<T, HD>;
  constexpr int VEC = Gm::VEC, NCH = Gm::NCH, LPR = Gm::LPR, RPW = Gm::RPW, RPP = Gm::RPP;
  const int rows = a.rows, nst = stages(a);
  const Smem L(sizeof(T), HD, GC, rows, nst);
  T* sKV = reinterpret_cast<T*>(smem);
  float* sS = reinterpret_cast<float*>(smem + L.s);
  float* sRed = reinterpret_cast<float*>(smem + L.red);
  float* sStat = reinterpret_cast<float*>(smem + L.stat);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rsub = lane / LPR, c = lane % LPR;
  const bool lane_on = c < NCH;
  const T* qb = (const T*)a.q + b * a.q_sb + (long long)hk * G * a.q_sh;
  const T* kb = (const T*)a.k + b * a.k_sb + hk * a.k_sh + i0 * a.k_ss;
  const T* vb = (const T*)a.v + b * a.v_sb + hk * a.v_sh + i0 * a.v_ss;

  // this lane's 16-byte chunk of each head's q row
  float qr[GC][VEC];
#pragma unroll
  for (int g = 0; g < GC; ++g) {
    if (g < G && lane_on) {
      unpack16(*reinterpret_cast<const uint4*>(qb + g * a.q_sh + c * VEC), qr[g]);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) qr[g][e] = 0.0f;
    }
  }

  // cp.async groups, in order: K_0, V_0, then K_{j+1}, V_{j+1} per chunk j
  const int n_chunks = (n + rows - 1) / rows;
  stage_rows<T, HD>(sKV, kb, a.k_ss, 0, min(rows, n), tid);
  tc::cp_async_commit();
  stage_rows<T, HD>(sKV + rows * HD, vb, a.v_ss, 0, min(rows, n), tid);
  tc::cp_async_commit();

  for (int j = 0; j < n_chunks; ++j) {
    const int st = nst == 2 ? (j & 1) : 0;
    const T* sK = sKV + (size_t)st * 2 * rows * HD;
    const T* sV = sK + rows * HD;
    const int r0 = j * rows, nr = min(rows, n - r0);
    if (j + 1 < n_chunks) {  // the next chunk into the other stage
      T* dst = sKV + (size_t)(st ^ 1) * 2 * rows * HD;
      const int nr1 = min(rows, n - r0 - rows);
      stage_rows<T, HD>(dst, kb, a.k_ss, r0 + rows, nr1, tid);
      tc::cp_async_commit();
      stage_rows<T, HD>(dst + rows * HD, vb, a.v_ss, r0 + rows, nr1, tid);
    } else {
      tc::cp_async_commit();
    }
    tc::cp_async_commit();
    tc::cp_async_wait<3>();  // K_j landed; V_j and the next chunk stay in flight
    __syncthreads();

    // scores: RPW rows per warp at a time, 16 bytes a lane, each row's
    // dot product reduced over its LPR lanes; K read once for all G heads
#pragma unroll 4
    for (int rr = warp * RPW; rr < nr; rr += RPP) {
      const int r = rr + rsub;
      float kf[VEC];
      if (lane_on && r < nr) {
        unpack16(*reinterpret_cast<const uint4*>(sK + r * HD + c * VEC), kf);
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
        if (c == 0 && r < nr) sS[g * rows + r] = d * a.scale;
      }
    }
    __syncthreads();

    // per-head chunk statistics (_split_partial): one warp per head
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
      unpack16(*reinterpret_cast<const uint4*>(sV + r * HD + c * VEC), vf);
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
    // the chunk's blend weight per head (_merge_into_carry, chunk order)
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

// The last CTA of (b, kv head) to arrive blends the n_splits partials of
// its G heads in split order — the fused Pallas carry's order, whichever
// CTA runs it, so repeated calls are bitwise equal.
template <typename T, int HD, int GC>
__device__ __forceinline__ void merge_splits(const Args& a, unsigned char* smem, int G, int hk,
                                             int b) {
  const Smem L(sizeof(T), HD, GC, a.rows, stages(a));
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
  T* ob = (T*)a.o + row0 * HD;
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

// CTA (split, kv head, batch row): the split's partial for the G heads of
// the group; fused, the arrival count and, in the last CTA, the merge
template <typename T, int HD, int GC>
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
  if (n > 0) split_partial<T, HD, GC>(a, smem, G, i0, n, hk, b, carry, lam_run);

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

  int* sFlag = reinterpret_cast<int*>(smem + Smem(sizeof(T), HD, GC, a.rows, stages(a)).flag);
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // (cumulative) the CTA's partial is visible device-wide before it counts
    *sFlag = atomicAdd(a.arrivals + (long long)b * a.Hkv + hk, 1) == a.n_splits - 1;
  }
  __syncthreads();
  if (!*sFlag) return;
  __threadfence();
  merge_splits<T, HD, GC>(a, smem, G, hk, b);
}

template <typename T, int HD, int GC>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const Smem L(sizeof(T), HD, GC, a.rows, a.split > a.rows ? 2 : 1);
  if (L.total > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, HD, GC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(a.n_splits, a.Hkv, a.B);
  decode_kernel<T, HD, GC><<<grid, NTHREADS, L.total, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_group(const Args& a, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  if (G <= 1) return launch<T, HD, 1>(a, stream);
  if (G <= 2) return launch<T, HD, 2>(a, stream);
  if (G <= 4) return launch<T, HD, 4>(a, stream);
  return launch<T, HD, 8>(a, stream);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t stream) {
  switch (hd) {
    case 32: return dispatch_group<T, 32>(a, stream);
    case 48: return dispatch_group<T, 48>(a, stream);
    case 64: return dispatch_group<T, 64>(a, stream);
    case 128: return dispatch_group<T, 128>(a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k2

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
  if (Hq % Hkv != 0 || Hq / Hkv > G_MAX || split < 1 || rows != min((split + 3) / 4 * 4, 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (arrivals != nullptr) {
    cudaError_t e = cudaMemsetAsync(arrivals, 0, sizeof(int) * B * Hkv, s);
    if (e != cudaSuccess) return (int)e;
  }
  k2::Args a{q, k, v, cache_len, start, o_part, lam_part, o, lam_out, arrivals,
             q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
             B, Hq, Hkv, S_max, n_splits, split, rows, window, chunk, scale};
  return (int)(is_bf16 ? k2::dispatch_hd<__nv_bfloat16>(hd, a, s) : k2::dispatch_hd<float>(hd, a, s));
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
