// Packed varlen FLASH-D over a paged KV cache for Hopper (K4): the
// counterpart of the Pallas kernel
// repro/kernels/flashd_varlen.py::flashd_varlen_pallas (_varlen_kernel,
// _varlen_partial; carry blend _merge_into_carry).
//
// Query rows of many sequences arrive as one flat pack q [T, Hq, d] — whole
// prompts, prefill chunks, one-row decode segments and K+1-row verify
// segments side by side — and K/V live in the global page pool
// [P, page, Hkv, d] of the paged cache. The packing contract: every
// sequence's rows form one segment aligned to block_q rows, so each q block
// belongs to one sequence (seq = seq_ids[ib·block_q]); padding rows carry
// seq_id −1 and q_pos −1 and come back as exact zeros.
//
// The TPU ran a (q block, kv head, logical page) grid with the page axis
// sequential and the (acc, Λ) carry in VMEM. Here the grid is (q block ×
// row group, kv head, kv split) and every CTA runs in parallel:
//   - rows: the live rows for kv head hk, (token, head) pairs with
//     q_pos ≥ 0 in order, 64 to a row group. When a block has fewer than
//     64 rows (block_q·G < 64), the CTA of the first block of an aligned
//     group of bpg = 64 / (block_q·G) blocks also takes the following
//     blocks of the group that belong to the same sequence (a whole prompt
//     or a long chunk spans many blocks), and their own CTAs stop: four
//     16-row blocks fill the four warps of one tensor-core CTA. Rows with
//     q_pos < 0 — 7 of a decode block's 8 at block_q 8 — are not computed
//     at all: one CTA per (block, kv head) writes them as exact zeros, and
//     an all-padding block (seq < 0) is only that CTA's zeros, reading
//     nothing.
//   - kv split: a run of `split` logical positions of S = N·page. A CTA
//     reads only [i0, i1): below kv_len, at most the rows' largest q_pos,
//     at least the window / chunk start of their smallest — the
//     conservative rules of the reference. A run left empty reads nothing
//     (not even the table) and leaves the identity partial (0, NEG_INF).
//   - staging: K/V rows are 16-byte cp.async copies through the block table
//     (row pos at page tbl[seq, pos / page], offset pos % page, the entry
//     read by the copying thread for live rows only). An int8 pool is
//     staged as bytes with its (page, kv head) scales and dequantized when
//     read (x·scale, the reference's order).
//   - few rows (< 16 live rows per kv head: decode rows, short verify
//     segments): decode_fma.cuh's CUDA-core body, K3's, over the run in
//     passes of 8 rows, each row masked at its own q_pos (causal, window,
//     chunk).
//   - many rows (≥ 16: prefill chunks at block_q·G ≥ 16, whole prompts):
//     attn_tc.cuh's Products on the tensor cores, 16 rows a warp, over
//     64-key tiles in a 2-stage cp.async ring, with K1's FLASH-D carry per
//     row — bf16 as bf16 with P rounded to bf16, f32 as 3xTF32 with each
//     k8 step's score partial and each tile's P·V partial added in f32.
//   - merge: every CTA of a row group finds the same range of runs its
//     rows can see; a CTA outside it returns at once. With one live run
//     the CTA writes O. Otherwise it writes its rows' normalised partial,
//     counts itself into the (row group, kv head)'s arrival counter, and
//     the last live CTA to arrive blends the partials in split order — so
//     repeated calls are bitwise equal.
//
// Bound on the H100: a mixed step holds few query rows per sequence, so
// the work is near one pass over the live KV pages — bytes bound it, as for
// decode — and a long whole prompt makes it operations-bound like K1.
#include <algorithm>
#include <climits>

#include "decode_fma.cuh"

using namespace flashd;

namespace {

constexpr int NTHREADS = fma::NTHREADS;
constexpr int RB = 64;         // live rows per CTA: 4 warps × one 16-row mma M
constexpr int FMA_ROWS = 8;    // rows per pass of the CUDA-core body
constexpr int TC_MIN = 16;     // live rows from which a CTA takes the tensor cores
constexpr int BK = tc::BKP;    // keys per tile (tensor cores) / chunk (CUDA cores)
constexpr int MAX_SPLITS = 64;  // the merge holds every split's weights
constexpr int HEAD = 1536;     // bytes of the CTA's row table at the start of shared memory
static_assert(RB == tc::BQ, "a row group is one tensor-core q tile");

struct Args {
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
  float* o_part;        // [n_splits, nb·RG, Hkv, rb, d] (n_splits > 1)
  float* lam_part;      // [n_splits, nb·RG, Hkv, rb]
  int* arrivals;        // [nb·RG·Hkv], zero on entry (indexed by the group's first block)
  long long q_st, q_sh, o_st, o_sh;
  long long k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, tbl_sb;
  int Hq, Hkv, n_tbl, page, block_q, window, chunk;
  int nb, RG, bpg, rb, n_splits, split;  // q blocks, row groups a block, blocks a group
  float scale;
};

// _varlen_partial's mask for a key below kv_len
__device__ __forceinline__ bool visible(long long qpos, long long kpos, int window, int chunk) {
  bool ok = kpos <= qpos;
  if (window > 0) ok = ok && (qpos - kpos < window);
  if (chunk > 0) ok = ok && (floordiv(qpos, chunk) == floordiv(kpos, chunk));
  return ok;
}

template <typename TQ>
struct RowsAt {  // row g: q + off[g] (a gathered (token, head) row)
  const TQ* q;
  const long long* off;
  __device__ __forceinline__ const TQ* operator()(int g) const { return q + off[g]; }
};

struct RowMask {  // row g sees position pos at its own q_pos
  const int* pos;
  int window, chunk;
  __device__ __forceinline__ bool keep(int g, long long kpos) const {
    return visible(pos[g], kpos, window, chunk);
  }
};

template <typename T>
__device__ __forceinline__ void store4(T* p, float a, float b, float c, float d) {
  tc::store2(p, a, b);
  tc::store2(p + 2, c, d);
}

// ---- the tensor-core body ----

template <typename TQ, typename TKV, int HD>
struct TcSmem {  // bytes: Q, then K/V (QUANT: the dequantized tiles, then the int8 ring)
  using L = tc::Layout<TQ, HD>;
  static constexpr bool QUANT = sizeof(TKV) == 1;
  static constexpr size_t RING = QUANT ? 3 * sizeof(TQ) * L::TILE : 0;
  static constexpr size_t SCALES = RING + 4 * BK * HD;
  static constexpr size_t BYTES = QUANT ? SCALES + sizeof(float) * 4 * BK : 5 * sizeof(TQ) * L::TILE;
};

// keys [k0, k0 + BK) ∩ [.., i1) of the pool into K and V tiles (row stride
// LDD elements); keys ≥ i1 are zero-filled and read nothing, not even the
// table; an int8 pool's row scales into dKs / dVs (0 past i1)
template <typename TKV, int HD, int LDD>
__device__ __forceinline__ void stage_tile(TKV* dK, TKV* dV, float* dKs, float* dVs,
                                           const fma::KVSrc<TKV, true>& src, long long k0,
                                           long long i1, int tid) {
  constexpr int CH = 16 / (int)sizeof(TKV), CPR = HD / CH;
  constexpr bool QUANT = sizeof(TKV) == 1;
#pragma unroll 4
  for (int i = tid; i < BK * CPR; i += NTHREADS) {
    const int r = i / CPR, c = i - r * CPR;
    const long long pos = k0 + r;
    const bool ok = pos < i1;
    const TKV* kr = src.k;
    const TKV* vr = src.v;
    if (ok) {
      const int ip = (int)pos / src.page, off = (int)pos - ip * src.page;  // positions < 2^31
      const long long pid = __ldg(src.tbl + ip);
      kr = src.k + pid * src.k_sp + off * src.k_ss + c * CH;
      vr = src.v + pid * src.v_sp + off * src.v_ss + c * CH;
      if (QUANT && c == 0) {
        dKs[r] = __ldg(src.ks + pid * src.hkv);
        dVs[r] = __ldg(src.vs + pid * src.hkv);
      }
    } else if (QUANT && c == 0) {
      dKs[r] = dVs[r] = 0.0f;
    }
    tc::cp_async16(dK + r * LDD + c * CH, kr, ok);
    tc::cp_async16(dV + r * LDD + c * CH, vr, ok);
  }
}

// an int8 tile [BK][HD] with its row scales → a padded TQ tile, x·scale
template <typename TQ, int HD>
__device__ __forceinline__ void dequant_tile(TQ* dst, const signed char* src, const float* sc,
                                             int tid) {
  using L = tc::Layout<TQ, HD>;
  for (int i = tid; i < BK * HD / 4; i += NTHREADS) {
    const int r = i / (HD / 4), c4 = (i - r * (HD / 4)) * 4;
    const char4 x = *reinterpret_cast<const char4*>(src + r * HD + c4);
    const float s = sc[r];
    store4(dst + r * L::LD + c4, (float)x.x * s, (float)x.y * s, (float)x.z * s, (float)x.w * s);
  }
}

// The CTA's R (16 … 64) rows over keys [i0, i1): warp w owns rows 16w …
// 16w + 15 (rows ≥ R are zero q rows at q_pos −1, dead). Returns each
// thread's O fragments (acc, normalised: softmax·V over the run) and the
// Λ of its rows g and g + 8.
template <typename TQ, typename TKV, int HD>
__device__ __forceinline__ void tc_run(const Args& a, unsigned char* body, const long long* sQoff,
                                       const int* sPos, int R, const fma::KVSrc<TKV, true>& src,
                                       long long i0, long long i1, float (&acc)[HD / 8][4],
                                       float (&lam)[2]) {
  using L = tc::Layout<TQ, HD>;
  using S = TcSmem<TQ, TKV, HD>;
  constexpr bool QUANT = S::QUANT;
  constexpr int NJ = tc::NJ;
  TQ* sQ = reinterpret_cast<TQ*>(body);
  TQ* const sK0 = sQ + L::TILE;  // QUANT: the dequantized K, V; else stage st at sK0 + 2·st·TILE
  TKV* const sB = reinterpret_cast<TKV*>(body + S::RING);  // QUANT: the int8 ring [2][2][BK][HD]
  float* const sBs = reinterpret_cast<float*>(body + S::SCALES);  // QUANT: [2][2][BK] scales

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t = lane & 3, r0 = warp * 16;
  const bool has_rows = r0 < R;
  const int qp[2] = {sPos[r0 + (lane >> 2)], sPos[r0 + (lane >> 2) + 8]};

  for (int i = tid; i < RB * L::CPR; i += NTHREADS) {  // Q: the gathered rows, 16 bytes a copy
    const int r = i / L::CPR, c = i - r * L::CPR;
    const bool ok = r < R;
    tc::cp_async16(sQ + r * L::LD + c * L::CHUNK,
                   (const TQ*)a.q + (ok ? sQoff[r] + c * L::CHUNK : 0), ok);
  }
  auto stage = [&](int st, long long k0) {
    if constexpr (QUANT) {
      TKV* d = sB + (size_t)st * 2 * BK * HD;
      stage_tile<TKV, HD, HD>(d, d + BK * HD, sBs + st * 2 * BK, sBs + st * 2 * BK + BK, src, k0,
                              i1, tid);
    } else {
      TKV* d = reinterpret_cast<TKV*>(sK0 + (size_t)st * 2 * L::TILE);
      stage_tile<TKV, HD, L::LD>(d, d + L::TILE, nullptr, nullptr, src, k0, i1, tid);
    }
  };
  const int n_tiles = (int)((i1 - i0 + BK - 1) / BK);
  stage(0, i0);
  tc::cp_async_commit();  // group: Q and the first tile

  tc::Products<TQ, HD> mm;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  lam[0] = lam[1] = NEG_INF;

  for (int j = 0, st = 0; j < n_tiles; ++j, st ^= 1) {
    const long long k0 = i0 + (long long)j * BK;
    if (j + 1 < n_tiles) stage(st ^ 1, k0 + BK);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and Q) landed; the next one stays in flight
    __syncthreads();
    const TQ* sK = sK0;
    if constexpr (QUANT) {
      const signed char* b = reinterpret_cast<const signed char*>(sB) + (size_t)st * 2 * BK * HD;
      dequant_tile<TQ, HD>(sK0, b, sBs + st * 2 * BK, tid);
      dequant_tile<TQ, HD>(sK0 + L::TILE, b + BK * HD, sBs + st * 2 * BK + BK, tid);
      __syncthreads();
    } else {
      sK = sK0 + (size_t)st * 2 * L::TILE;
    }
    const TQ* sV = sK + L::TILE;
    if (has_rows) {
      if (j == 0) mm.load_q(sQ, r0, lane);
      float s[NJ][4];
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj) s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.0f;
      mm.scores(s, sQ, sK, r0, lane);
      float mb[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long pos = k0 + 8 * jj + 2 * t + (e & 1);
          const bool keep = pos < i1 && visible(qp[e >> 1], pos, a.window, a.chunk);
          s[jj][e] = keep ? s[jj][e] * a.scale : NEG_INF;
          mb[e >> 1] = fmaxf(mb[e >> 1], s[jj][e]);
        }
      mb[0] = tc::quad_max(mb[0]);
      mb[1] = tc::quad_max(mb[1]);
      // a warp whose 16 rows see nothing of this tile keeps its carry exactly
      if (__any_sync(0xffffffffu, mb[0] > DEAD || mb[1] > DEAD)) {
        float l[2] = {0.0f, 0.0f};
        const float base[2] = {fmaxf(mb[0], DEAD), fmaxf(mb[1], DEAD)};
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[jj][e] = expf(s[jj][e] - base[e >> 1]);
            l[e >> 1] += s[jj][e];
          }
        // K1's FLASH-D carry: W = σ(λ_b − Λ), Λ' = logaddexp(Λ, λ_b),
        // acc ← acc·(1 − W) + (P·e^{m − Λ'})·V
        float acc_scale[2], p_scale[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float lsum = tc::quad_sum(l[r]);
          const float lam_b = lsum > 0.0f ? base[r] + logf(fmaxf(lsum, F32_TINY)) : NEG_INF;
          const float delta = lam_b - lam[r];
          float w = sigmoid(delta);
          float ln = lam_b - log_sigmoid(delta);
          const bool dead = lam_b <= DEAD, first = lam[r] <= DEAD;
          w = dead ? 0.0f : (first ? 1.0f : w);
          ln = dead ? lam[r] : (first ? lam_b : ln);
          p_scale[r] = dead ? 0.0f : expf(base[r] - ln);
          acc_scale[r] = 1.0f - w;
          lam[r] = ln;
        }
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] *= acc_scale[e >> 1];
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[jj][e] *= p_scale[e >> 1];
        mm.pv(acc, s, sV, lane);
      }
    }
    __syncthreads();  // every warp is done with this stage (and the dequantized tiles)
  }
  tc::cp_async_wait<0>();
}

// ---- the kernel ----

// the block's rows that no CTA computes, as exact zeros: every row of a
// padding block, else the rows with q_pos < 0
template <typename TQ, int HD>
__device__ __forceinline__ void zero_dead_rows(const Args& a, long long t0, bool all, int hk,
                                               int G) {
  TQ* o = (TQ*)a.o;
  const int per_t = G * HD / 4;
  for (int i = threadIdx.x; i < a.block_q * per_t; i += NTHREADS) {
    const int tt = i / per_t, rem = i - tt * per_t, g = rem / (HD / 4);
    const int c4 = (rem - g * (HD / 4)) * 4;
    if (all || a.q_pos[t0 + tt] < 0)
      store4(o + (t0 + tt) * a.o_st + (long long)(hk * G + g) * a.o_sh + c4, 0.0f, 0.0f, 0.0f,
             0.0f);
  }
}

// CTA (q block × row group, kv head, kv split)
template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(NTHREADS, 1) varlen_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long* sQoff = reinterpret_cast<long long*>(smem);  // [RB] q row offsets
  long long* sOoff = sQoff + RB;                          // [RB] o row offsets
  int* sPos = reinterpret_cast<int*>(sOoff + RB);         // [RB] q_pos (−1 past R)
  int* sMisc = sPos + RB;                                 // live rows, q_min, q_max, flag
  unsigned char* body = smem + HEAD;

  const int G = a.Hq / a.Hkv;
  const int ibr = blockIdx.x, ib = ibr / a.RG, rg = ibr - ib * a.RG;
  const int hk = blockIdx.y, split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long t0 = (long long)ib * a.block_q;
  const int seq = a.seq_ids[t0];
  if (rg == 0 && split == 0) zero_dead_rows<TQ, HD>(a, t0, seq < 0, hk, G);
  if (seq < 0) return;  // a padding block: those zeros are all of it
  // the previous block of the aligned group is this sequence's: its CTA has our rows
  if (ib % a.bpg != 0 && a.seq_ids[t0 - a.block_q] == seq) return;
  const long long kv_len = a.kv_len[seq];
  const long long lo = (long long)split * a.split;
  // a run wholly past kv_len is dead for every row: its CTA reads nothing and
  // is not counted (split 0 stays: it answers for rows that see nothing)
  if (split > 0 && lo >= kv_len) return;

  // the row table: the live (token, head) rows of this block and of the
  // group's following blocks of the same sequence, in order; this row
  // group's 64 of them
  for (int r = tid; r < RB; r += NTHREADS) {
    sPos[r] = -1;
    sQoff[r] = 0;
    sOoff[r] = 0;
  }
  __syncthreads();
  if (warp == 0) {
    const int ibn = ib + lane;  // lane j: is block ib + j of the group and of this sequence?
    const bool same = lane < a.bpg && ibn < a.nb && ibn / a.bpg == ib / a.bpg &&
                      a.seq_ids[(long long)ibn * a.block_q] == seq;
    const int n_tok = (__ffs(~__ballot_sync(0xffffffffu, same)) - 1) * a.block_q;
    int live = 0;
    for (int tb = 0; tb < n_tok; tb += 32) {
      const int tt = tb + lane;
      const int p = tt < n_tok ? a.q_pos[t0 + tt] : -1;
      const unsigned m = __ballot_sync(0xffffffffu, p >= 0);
      const int rank = live + __popc(m & ((1u << lane) - 1u));
      if (p >= 0) {
        for (int g = 0; g < G; ++g) {
          const int r = rank * G + g - rg * RB;
          if (r >= 0 && r < RB) {
            sQoff[r] = (t0 + tt) * a.q_st + (long long)(hk * G + g) * a.q_sh;
            sOoff[r] = (t0 + tt) * a.o_st + (long long)(hk * G + g) * a.o_sh;
            sPos[r] = p;
          }
        }
      }
      live += __popc(m);
    }
    __syncwarp();
    const int R = min(max(live * G - rg * RB, 0), RB);
    int q_min = INT_MAX, q_max = -1;
    for (int r = lane; r < R; r += 32) {
      q_min = min(q_min, sPos[r]);
      q_max = max(q_max, sPos[r]);
    }
    q_min = __reduce_min_sync(0xffffffffu, q_min);
    q_max = __reduce_max_sync(0xffffffffu, q_max);
    if (lane == 0) {
      sMisc[0] = R;
      sMisc[1] = q_min;
      sMisc[2] = q_max;
    }
  }
  __syncthreads();
  const int R = sMisc[0];
  if (R == 0) return;  // this row group holds no live row
  const long long q_min = sMisc[1], q_max = sMisc[2];

  // [v0, v1): the positions some row can see — below kv_len and the rows'
  // largest q_pos, at or past the window / chunk start of their smallest —
  // and the runs they fall in, [s_lo, s_lo + n_live). Every CTA of the row
  // group finds the same range; a CTA outside it reads nothing, counts
  // nothing and returns (split 0 stays when no run is live: its rows are 0)
  long long v0 = 0;
  if (a.window > 0) v0 = max(v0, q_min - a.window + 1);
  if (a.chunk > 0) v0 = max(v0, floordiv(q_min, a.chunk) * a.chunk);
  const long long v1 = min(min((long long)a.n_tbl * a.page, kv_len), q_max + 1);
  const int s_lo = v1 > v0 ? (int)(v0 / a.split) : 0;
  const int n_live = v1 > v0 ? (int)((v1 - 1) / a.split) - s_lo + 1 : 0;
  if (split < s_lo || split >= s_lo + max(n_live, 1)) return;
  const long long i0 = max(lo, v0), i1 = min(lo + a.split, v1);  // this run's part
  const bool live = n_live > 0;

  const bool direct = n_live <= 1;  // one live run: the CTA writes O
  TQ* o = (TQ*)a.o;
  const long long pbase = (((long long)split * gridDim.x + ibr) * a.Hkv + hk) * a.rb;
  const fma::KVSrc<TKV, true> src{
      (const TKV*)a.k + hk * a.k_sh, (const TKV*)a.v + hk * a.v_sh, a.k_ss, a.v_ss, a.k_sp,
      a.v_sp, a.tbl + (long long)seq * a.tbl_sb, a.page,
      a.ks ? a.ks + hk : nullptr, a.vs ? a.vs + hk : nullptr, a.Hkv};

  if (!live) {  // no row sees any position: O = 0, nothing read
    for (int i = tid; i < R * HD / 4; i += NTHREADS) {
      const int r = i / (HD / 4), c4 = (i - r * (HD / 4)) * 4;
      store4(o + sOoff[r] + c4, 0.0f, 0.0f, 0.0f, 0.0f);
    }
  } else if (R < TC_MIN) {  // few rows: the CUDA-core body, 8 rows a pass
    constexpr int U = fma::Units<FMA_ROWS, HD>::N;
    const int nst = a.split > BK ? 2 : 1;
    for (int p0 = 0; p0 < R; p0 += FMA_ROWS) {
      const int gp = min(FMA_ROWS, R - p0);
      float carry[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) carry[u][0] = carry[u][1] = carry[u][2] = carry[u][3] = 0.0f;
      float lam_run = NEG_INF;
      fma::split_partial<TQ, TKV, HD, FMA_ROWS, true>(
          body, gp, BK, nst, a.scale, RowsAt<TQ>{(const TQ*)a.q, sQoff + p0}, src,
          RowMask{sPos + p0, a.window, a.chunk}, i0, (int)(i1 - i0), carry, lam_run);
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = tid + u * NTHREADS;
        if (e >= gp * HD / 4) break;
        const int g = e / (HD / 4), c4 = (e - g * (HD / 4)) * 4;
        if (direct)
          store4(o + sOoff[p0 + g] + c4, carry[u][0], carry[u][1], carry[u][2], carry[u][3]);
        else
          *reinterpret_cast<float4*>(a.o_part + (pbase + p0 + g) * HD + c4) =
              make_float4(carry[u][0], carry[u][1], carry[u][2], carry[u][3]);
      }
      if (!direct && tid < gp) a.lam_part[pbase + p0 + tid] = lam_run;
    }
  } else {  // many rows: the tensor cores
    float acc[HD / 8][4], lam[2];
    tc_run<TQ, TKV, HD>(a, body, sQoff, sPos, R, src, i0, i1, acc, lam);
    const int t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + 8 * h;
      if (r >= R) continue;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        if (direct)
          tc::store2(o + sOoff[r] + 8 * n + 2 * t, acc[n][2 * h], acc[n][2 * h + 1]);
        else
          tc::store2(a.o_part + (pbase + r) * HD + 8 * n + 2 * t, acc[n][2 * h],
                     acc[n][2 * h + 1]);
      }
      if (!direct && t == 0) a.lam_part[pbase + r] = lam[h];
    }
  }
  if (direct) return;

  // the last live CTA of (row group, kv head) to arrive merges the live runs
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // (cumulative) the CTA's partial is visible device-wide before it counts
    sMisc[3] = atomicAdd(a.arrivals + (long long)ibr * a.Hkv + hk, 1) == n_live - 1;
  }
  __syncthreads();
  if (!sMisc[3]) return;
  __threadfence();
  const long long stride = (long long)gridDim.x * a.Hkv * a.rb;  // partial rows per split
  const long long row0 = ((long long)ibr * a.Hkv + hk) * a.rb;
  float* sW = reinterpret_cast<float*>(body);  // [n_live][RB] blend weights
  for (int r = tid; r < R; r += NTHREADS) {
    float lam_run = NEG_INF;
    for (int s = 0; s < n_live; ++s)
      sW[s * RB + r] =
          fma::blend_step(lam_run, __ldcg(a.lam_part + (s_lo + s) * stride + row0 + r));
  }
  __syncthreads();
  for (int i = tid; i < R * HD / 4; i += NTHREADS) {
    const int r = i / (HD / 4), c4 = (i - r * (HD / 4)) * 4;
    const float* srcp = a.o_part + ((s_lo * stride + row0 + r) * HD + c4);
    float4 m = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s1 = 0; s1 < n_live; s1 += 8) {  // 8 partials' loads in flight, then their blends
      float4 x[8];
      float w[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        w[k] = s1 + k < n_live ? sW[(s1 + k) * RB + r] : 0.0f;
        // a partial that weighs 0 adds nothing: not read
        x[k] = w[k] != 0.0f ? __ldcg(reinterpret_cast<const float4*>(srcp + (s1 + k) * stride * HD))
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        if (w[k] == 0.0f) continue;
        m.x = m.x + (x[k].x - m.x) * w[k];
        m.y = m.y + (x[k].y - m.y) * w[k];
        m.z = m.z + (x[k].z - m.z) * w[k];
        m.w = m.w + (x[k].w - m.w) * w[k];
      }
    }
    store4(o + sOoff[r] + c4, m.x, m.y, m.z, m.w);
  }
}

template <typename TQ, typename TKV, int HD>
size_t smem_bytes(const Args& a) {
  const size_t fma_b = fma::Smem(sizeof(TKV), HD, FMA_ROWS, BK, a.split > BK ? 2 : 1).total;
  const size_t merge_b = sizeof(float) * MAX_SPLITS * RB;
  return HEAD + std::max(TcSmem<TQ, TKV, HD>::BYTES, std::max(fma_b, merge_b));
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(const Args& a, int nbr, cudaStream_t stream) {
  const size_t bytes = smem_bytes<TQ, TKV, HD>(a);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(varlen_kernel<TQ, TKV, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(nbr, a.Hkv, a.n_splits);
  varlen_kernel<TQ, TKV, HD><<<grid, NTHREADS, bytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(int hd, const Args& a, int nbr, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<TQ, TKV, 32>(a, nbr, stream);
    case 48: return launch<TQ, TKV, 48>(a, nbr, stream);
    case 64: return launch<TQ, TKV, 64>(a, nbr, stream);
    case 128: return launch<TQ, TKV, 128>(a, nbr, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// K4: o [T, Hq, hd] (q's dtype) for the packed rows q [T, Hq, hd], T a
// multiple of block_q, in one launch over (T/block_q × RG row groups, Hkv,
// n_splits runs of `split` positions); a row group takes up to bpg blocks
// of one sequence and writes rb partial rows. The caller chooses RG, bpg
// and rb (flashd_varlen.py `_row_groups`); they are refused unless every
// row of a group's blocks lands in one of RB-row groups and rb holds them.
// q_type / kv_type: 0 float32, 1 bfloat16, 2 int8 (then ks / vs [P, Hkv]
// f32 are the per-(page, head) scales; null otherwise). Strides are in
// elements. With n_splits > 1, o_part [n_splits, nbr, Hkv, rb, hd] and
// lam_part [n_splits, nbr, Hkv, rb] (nbr = T/block_q·RG) are scratch and
// arrivals [nbr·Hkv] int32 is zeroed here.
extern "C" int flashd_varlen_launch(
    const void* q, const void* k_pages, const void* v_pages, void* o, const int* tbl,
    const int* seq_ids, const int* q_pos, const int* kv_len, const float* ks, const float* vs,
    float* o_part, float* lam_part, int* arrivals,
    long long q_st, long long q_sh, long long o_st, long long o_sh,
    long long k_sp, long long k_ss, long long k_sh,
    long long v_sp, long long v_ss, long long v_sh, long long tbl_sb,
    int T, int Hq, int Hkv, int n_tbl, int page, int block_q, int hd, int q_type, int kv_type,
    int window, int chunk, int RG, int bpg, int rb, int n_splits, int split, float scale,
    void* stream) {
  if (T == 0 || Hq == 0) return (int)cudaGetLastError();
  if (block_q < 1 || T % block_q != 0 || Hkv < 1 || Hq % Hkv != 0 || page < 1 || n_tbl < 1 ||
      n_splits < 1 || n_splits > MAX_SPLITS || split < 1 ||
      (long long)n_splits * split < (long long)n_tbl * page)
    return (int)cudaErrorInvalidValue;
  const long long group_rows = (long long)block_q * (Hq / Hkv) * bpg;  // rows of a group's blocks
  if (bpg < 1 || bpg > 32 || RG < 1 || (long long)RG * RB < group_rows ||
      rb < std::min<long long>(RB, group_rows))
    return (int)cudaErrorInvalidValue;
  if ((kv_type == 2) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
  if (n_splits > 1 && (o_part == nullptr || lam_part == nullptr || arrivals == nullptr))
    return (int)cudaErrorInvalidValue;
  const int nbr = T / block_q * RG;
  cudaStream_t s = (cudaStream_t)stream;
  if (n_splits > 1) {
    cudaError_t e = cudaMemsetAsync(arrivals, 0, sizeof(int) * nbr * Hkv, s);
    if (e != cudaSuccess) return (int)e;
  }
  Args a{q, k_pages, v_pages, o, tbl, seq_ids, q_pos, kv_len, ks, vs, o_part, lam_part, arrivals,
         q_st, q_sh, o_st, o_sh, k_sp, k_ss, k_sh, v_sp, v_ss, v_sh, tbl_sb,
         Hq, Hkv, n_tbl, page, block_q, window, chunk,
         T / block_q, RG, bpg, rb, n_splits, split, scale};
  cudaError_t e;
  if (q_type == 0 && kv_type == 0) e = dispatch_hd<float, float>(hd, a, nbr, s);
  else if (q_type == 1 && kv_type == 1) e = dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, a, nbr, s);
  else if (q_type == 0 && kv_type == 2) e = dispatch_hd<float, signed char>(hd, a, nbr, s);
  else if (q_type == 1 && kv_type == 2) e = dispatch_hd<__nv_bfloat16, signed char>(hd, a, nbr, s);
  else e = cudaErrorInvalidValue;
  return (int)e;
}
