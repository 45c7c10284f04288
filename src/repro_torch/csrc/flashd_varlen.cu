// Packed varlen FLASH-D over a paged KV cache for Hopper: the counterpart of
// the Pallas kernel repro/kernels/flashd_varlen.py::flashd_varlen_pallas
// (_varlen_kernel, _varlen_partial; carry blend _merge_into_carry).
//
// Query rows of many sequences arrive as one flat pack q [T, Hq, d] — whole
// prompts, prefill chunks and one-row decode segments side by side — and
// K/V live in the global page pool [P, page, Hkv, d] of the paged cache.
// The packing contract: every sequence's rows form one segment aligned to
// block_q rows, so each q block belongs to one sequence (blk_seq =
// seq_ids[ib·block_q]); padding rows carry seq_id −1 and q_pos −1.
//
// The TPU ran a (q block, kv head, logical page) grid with the page axis
// sequential and the (acc, Λ) carry in VMEM; the table lookup lived in the
// DMA descriptors. Here one CTA owns up to RB = 32 of the block's
// block_q·G query rows (GQA: the G heads of one kv head share every K/V
// tile) and loops over the logical pages of the block's sequence itself:
// it reads tbl[seq, ip] for pages below kv_len only — never a table slot
// past the sequence's live pages — and loads that physical page in tiles
// of ≤ 64 keys into shared memory (int8 pools dequantized on load, x·scale
// of the page's kv head). Per tile and row it computes the normalized
// partial of _varlen_partial (tile-local max clamped at NEG_INF/2, λ, c =
// e^{m_safe − λ}) and blends it into the carry with the sigmoid merge,
// with the Pallas guards (dead partial = identity). Masks are per element:
// pos < kv_len, pos ≤ q_pos, window, chunk. A page is skipped only when no
// row of the CTA can see it (the conservative rule of flashd_varlen.py:
// lo ≤ max q_pos, and lo + page > min q_pos − window + 1). A padding block
// (blk_seq < 0) reads nothing and writes zeros; a row with q_pos < 0 sees
// no key, keeps the identity carry and so writes exact zeros.
//
// Bound on the H100: a mixed step holds few query rows per sequence (one
// per decode segment, a prefill chunk per prefill segment), so the work is
// near a pass over the live KV pages — bytes bound it, as for decode — and
// a long whole prompt makes it operations-bound like K1. This first kernel
// keeps K1's CUDA-core f32 FMA tile body (G can be 1: no tensor-core tile
// fits a decode row), shares each K/V tile across the G heads and the
// block's rows, and leaves tensor cores / TMA to later work.
#include <cfloat>
#include <climits>

#include "flashd_common.cuh"

using namespace flashd;

namespace {

constexpr int RB = 32;       // query rows per CTA
constexpr int BK = 64;       // keys per tile; lanes own columns lane, lane + 32
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = RB / NWARPS;  // rows per warp

struct VarlenArgs {
  const void* q;        // [T, Hq, d] view
  const void* k;        // pool [P, page, Hkv, d] view
  const void* v;
  void* o;              // [T, Hq, d]
  const int* tbl;       // [B, N]
  const int* seq_ids;   // [T]
  const int* q_pos;     // [T]
  const int* kv_len;    // [B]
  const float* ks;      // [P, Hkv] f32 scales of an int8 pool, or null
  const float* vs;
  long long q_st, q_sh, o_st, o_sh;
  long long k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, tbl_sb;
  int Hq, Hkv, n_tbl, page, block_q, window, chunk;
  float scale;
};

template <int HD>
constexpr int smem_floats() {
  return RB * HD + BK * (HD + 1) + BK * HD + RB * BK;
}

// _varlen_partial's mask as a predicate
__device__ __forceinline__ bool visible(const VarlenArgs& a, long long qpos, long long kpos,
                                        long long kv_len) {
  bool ok = kpos < kv_len && kpos <= qpos;
  if (a.window > 0) ok = ok && (qpos - kpos < a.window);
  if (a.chunk > 0) ok = ok && (floordiv(qpos, a.chunk) == floordiv(kpos, a.chunk));
  return ok;
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NTHREADS) varlen_kernel(VarlenArgs a) {
  constexpr int NC = (HD + 31) / 32;  // output columns per lane
  constexpr int KLD = HD + 1;         // padded K row: conflict-free column reads
  extern __shared__ float smem[];
  float* sQ = smem;               // [RB][HD]
  float* sK = sQ + RB * HD;       // [BK][KLD]
  float* sV = sK + BK * KLD;      // [BK][HD]
  float* sP = sV + BK * HD;       // [RB][BK]

  const int ib = blockIdx.x, hk = blockIdx.y;
  const int G = a.Hq / a.Hkv;
  const int R = a.block_q * G;          // rows of this q block
  const int r_base = blockIdx.z * RB;   // first row of this CTA
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long t0 = (long long)ib * a.block_q;
  const int seq = a.seq_ids[t0];

  TQ* ob = (TQ*)a.o;
  if (seq < 0) {  // a whole padding block: zeros, nothing read
    for (int idx = tid; idx < RB * HD; idx += NTHREADS) {
      const int r = r_base + idx / HD;
      if (r >= R) continue;
      const long long t = t0 + r / G;
      const int h = hk * G + r % G;
      ob[t * a.o_st + h * a.o_sh + idx % HD] = from_float<TQ>(0.0f);
    }
    return;
  }
  const long long kv_len = a.kv_len[seq];

  // this CTA's rows: (packed row t0 + r / G, q head hk·G + r % G)
  const TQ* qb = (const TQ*)a.q;
  for (int idx = tid; idx < RB * HD; idx += NTHREADS) {
    const int r = r_base + idx / HD, c = idx % HD;
    float x = 0.0f;
    if (r < R) x = to_float(qb[(t0 + r / G) * a.q_st + (long long)(hk * G + r % G) * a.q_sh + c]);
    sQ[idx] = x;
  }
  long long qp[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = r_base + warp * ROWS + rr;
    qp[rr] = r < R ? (long long)a.q_pos[t0 + r / G] : -1;
  }
  // the CTA's row span for page pruning (padding rows never widen it)
  long long q_max = -1, q_min = LLONG_MAX;
  for (int rr = 0; rr < RB; ++rr) {
    const int r = r_base + rr;
    if (r >= R) break;
    const long long p = a.q_pos[t0 + r / G];
    if (p >= 0) {
      q_max = max(q_max, p);
      q_min = min(q_min, p);
    }
  }

  float acc[ROWS][NC];
  float lam_run[ROWS];
#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    lam_run[rr] = NEG_INF;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[rr][j] = 0.0f;
  }

  const long long live_pages = min((kv_len + a.page - 1) / a.page, (long long)a.n_tbl);
  for (long long ip = 0; ip < live_pages; ++ip) {
    const long long lo = ip * a.page;
    if (lo > q_max) break;  // later pages are further in the future
    if (a.window > 0 && lo + a.page <= q_min - a.window + 1) continue;
    const long long pid = a.tbl[(long long)seq * a.tbl_sb + ip];
    const TKV* kp = (const TKV*)a.k + pid * a.k_sp + hk * a.k_sh;
    const TKV* vp = (const TKV*)a.v + pid * a.v_sp + hk * a.v_sh;
    const float ksc = a.ks != nullptr ? a.ks[pid * a.Hkv + hk] : 1.0f;
    const float vsc = a.vs != nullptr ? a.vs[pid * a.Hkv + hk] : 1.0f;

    for (int k0 = 0; k0 < a.page; k0 += BK) {
      const long long kbase = lo + k0;
      if (kbase >= kv_len) break;
      const int nk = min(BK, a.page - k0);
      __syncthreads();  // every warp is done with the previous tile
      for (int idx = tid; idx < BK * HD; idx += NTHREADS) {
        const int c = idx / HD, col = idx % HD;
        const bool in = c < nk && kbase + c < kv_len;  // rows past kv_len read as 0
        sK[c * KLD + col] = in ? to_float(kp[(k0 + c) * a.k_ss + col]) * ksc : 0.0f;
        sV[c * HD + col] = in ? to_float(vp[(k0 + c) * a.v_ss + col]) * vsc : 0.0f;
      }
      __syncthreads();

      // scores of this warp's rows against columns lane and lane + 32
      float s[ROWS][2];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) s[rr][0] = s[rr][1] = 0.0f;
      const float* k_lo = sK + lane * KLD;
      const float* k_hi = sK + (lane + 32) * KLD;
      const float* q_w = sQ + warp * ROWS * HD;
#pragma unroll 4
      for (int kk = 0; kk < HD; ++kk) {
        const float ka = k_lo[kk], kc = k_hi[kk];
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const float qv = q_w[rr * HD + kk];
          s[rr][0] = fmaf(qv, ka, s[rr][0]);
          s[rr][1] = fmaf(qv, kc, s[rr][1]);
        }
      }

      float m_b[ROWS];
      bool any_live = false;
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = lane + 32 * j;
          s[rr][j] = (col < nk && visible(a, qp[rr], kbase + col, kv_len)) ? s[rr][j] * a.scale
                                                                          : NEG_INF;
        }
        m_b[rr] = warp_max(fmaxf(s[rr][0], s[rr][1]));
        any_live = any_live || m_b[rr] > DEAD;
      }
      if (!any_live) continue;  // every row's partial is dead: the identity

      float w[ROWS], cf[ROWS];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr) {
        const float m_safe = fmaxf(m_b[rr], DEAD);
        const float p0 = expf(s[rr][0] - m_safe);
        const float p1 = expf(s[rr][1] - m_safe);
        const float l = warp_sum(p0 + p1);
        const float lam_b = l > 0.0f ? m_safe + logf(fmaxf(l, F32_TINY)) : NEG_INF;
        cf[rr] = l > 0.0f ? expf(m_safe - lam_b) : 0.0f;  // ⇒ pv·c = softmax·V
        // _merge_into_carry: w = σ(λ_b − Λ), Λ ← Λ − ln σ(Λ − λ_b)
        const bool dead_b = lam_b <= DEAD, dead_a = lam_run[rr] <= DEAD;
        float ww = sigmoid(lam_b - lam_run[rr]);
        ww = dead_b ? 0.0f : (dead_a ? 1.0f : ww);
        const float ln_w1 = log_sigmoid(lam_run[rr] - lam_b);
        lam_run[rr] = dead_b ? lam_run[rr] : (dead_a ? lam_b : lam_run[rr] - ln_w1);
        w[rr] = ww;
        float* prow = sP + (warp * ROWS + rr) * BK;
        prow[lane] = p0;
        prow[lane + 32] = p1;
      }
      __syncwarp();

      float pv[ROWS][NC];
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
        for (int j = 0; j < NC; ++j) pv[rr][j] = 0.0f;
      const float* p_w = sP + warp * ROWS * BK;
      for (int c = 0; c < nk; ++c) {
        float vv[NC];
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const int col = lane + 32 * j;
          vv[j] = col < HD ? sV[c * HD + col] : 0.0f;
        }
#pragma unroll
        for (int rr = 0; rr < ROWS; ++rr) {
          const float p = p_w[rr * BK + c];
#pragma unroll
          for (int j = 0; j < NC; ++j) pv[rr][j] = fmaf(p, vv[j], pv[rr][j]);
        }
      }
#pragma unroll
      for (int rr = 0; rr < ROWS; ++rr)
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float o_p = pv[rr][j] * cf[rr];
          acc[rr][j] = acc[rr][j] + (o_p - acc[rr][j]) * w[rr];
        }
      __syncwarp();  // sP is rewritten by the next tile
    }
  }

#pragma unroll
  for (int rr = 0; rr < ROWS; ++rr) {
    const int r = r_base + warp * ROWS + rr;
    if (r >= R) continue;
    TQ* orow = ob + (t0 + r / G) * a.o_st + (long long)(hk * G + r % G) * a.o_sh;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = lane + 32 * j;
      if (col < HD) orow[col] = from_float<TQ>(acc[rr][j]);
    }
  }
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(const VarlenArgs& a, int nb, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats<HD>();
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(varlen_kernel<TQ, TKV, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const int rows = a.block_q * (a.Hq / a.Hkv);
  const dim3 grid(nb, a.Hkv, (rows + RB - 1) / RB);
  varlen_kernel<TQ, TKV, HD><<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(int hd, const VarlenArgs& a, int nb, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<TQ, TKV, 32>(a, nb, stream);
    case 48: return launch<TQ, TKV, 48>(a, nb, stream);
    case 64: return launch<TQ, TKV, 64>(a, nb, stream);
    case 128: return launch<TQ, TKV, 128>(a, nb, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K4: o [T, Hq, hd] (q's dtype) for the packed rows q [T, Hq, hd], T a
// multiple of block_q. q_type / kv_type: 0 float32, 1 bfloat16, 2 int8
// (then ks / vs [P, Hkv] f32 are the per-(page, head) scales; null
// otherwise). Strides are in elements.
extern "C" int flashd_varlen_launch(
    const void* q, const void* k_pages, const void* v_pages, void* o, const int* tbl,
    const int* seq_ids, const int* q_pos, const int* kv_len, const float* ks, const float* vs,
    long long q_st, long long q_sh, long long o_st, long long o_sh,
    long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long tbl_sb,
    int T, int Hq, int Hkv, int n_tbl, int page, int block_q, int hd, int q_type, int kv_type,
    int window, int chunk, float scale, void* stream) {
  if (T == 0 || Hq == 0) return (int)cudaGetLastError();
  if (block_q < 1 || T % block_q != 0 || Hkv < 1 || Hq % Hkv != 0 || page < 1 || n_tbl < 1)
    return (int)cudaErrorInvalidValue;
  if ((kv_type == 2) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
  VarlenArgs a{q, k_pages, v_pages, o, tbl, seq_ids, q_pos, kv_len, ks, vs,
               q_st, q_sh, o_st, o_sh, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, tbl_sb,
               Hq, Hkv, n_tbl, page, block_q, window, chunk, scale};
  const int nb = T / block_q;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e;
  if (q_type == 0 && kv_type == 0) e = dispatch_hd<float, float>(hd, a, nb, s);
  else if (q_type == 1 && kv_type == 1) e = dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a, nb, s);
  else if (q_type == 0 && kv_type == 2) e = dispatch_hd<float, signed char>(hd, a, nb, s);
  else if (q_type == 1 && kv_type == 2) e = dispatch_hd<__nv_bfloat16, signed char>(hd, a, nb, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
