// K4's kernel (flashd_varlen.cu explains its design): everything but the
// C entry point, shared by the translation units that instantiate it —
// flashd_varlen.cu (head dims 16, 32, 48), flashd_varlen_hd96.cu (64, 96),
// flashd_varlen_hd128.cu (128) and flashd_varlen_hd256.cu (256), which
// nvcc compiles at once (kernels/_build.py UNITS).
#pragma once

#include <algorithm>
#include <climits>

#include "decode_fma.cuh"

namespace flashd {
namespace varlen {


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
  const float* ks;      // [P, Hkv] f32 scales of a byte pool (int8, fp8), or null
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

// Bytes: Q, then K/V — K1's ring of L::STAGES stages (one for f32 at head
// dim 256) — or, from a byte pool, the dequantized K and V tiles, then a
// 2-stage byte ring and its scales. Where those exceed a block's shared
// memory beside the row table (f32 q at head dim 256: 267,776 B), one
// dequantized tile holds K for the scores and then V for P·V (ONE_DEQ).
template <typename TQ, typename TKV, int HD>
struct TcSmem {
  using L = tc::Layout<TQ, HD>;
  static constexpr bool QUANT = sizeof(TKV) == 1;
  static constexpr size_t BYTE_RING = 4 * BK * HD + sizeof(float) * 4 * BK;
  static constexpr bool ONE_DEQ =
      QUANT && HEAD + 3 * sizeof(TQ) * L::TILE + BYTE_RING > tc::MAX_SMEM;
  static constexpr int NST = QUANT ? 2 : L::STAGES;  // stages of the copy ring
  static constexpr size_t RING = QUANT ? (ONE_DEQ ? 2 : 3) * sizeof(TQ) * L::TILE : 0;
  static constexpr size_t SCALES = RING + 4 * BK * HD;
  static constexpr size_t BYTES =
      QUANT ? RING + BYTE_RING : (1 + 2 * L::STAGES) * sizeof(TQ) * L::TILE;
};

// keys [k0, k0 + BK) ∩ [.., i1) of the pool into K and V tiles (row stride
// LDD elements); keys ≥ i1 are zero-filled and read nothing, not even the
// table; a byte pool's row scales into dKs / dVs (0 past i1)
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

// a byte tile (int8 or fp8 e4m3) [BK][HD] with its row scales → a padded
// TQ tile, x·scale
template <typename TQ, typename TKV, int HD>
__device__ __forceinline__ void dequant_tile(TQ* dst, const TKV* src, const float* sc, int tid) {
  using L = tc::Layout<TQ, HD>;
  for (int i = tid; i < BK * HD / 4; i += NTHREADS) {
    const int r = i / (HD / 4), c4 = (i - r * (HD / 4)) * 4;
    float x[4];
    fma::load_vec(src + r * HD + c4, x);
    const float s = sc[r];
    store4(dst + r * L::LD + c4, x[0] * s, x[1] * s, x[2] * s, x[3] * s);
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
  TKV* const sB = reinterpret_cast<TKV*>(body + S::RING);  // QUANT: the byte ring [2][2][BK][HD]
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

  for (int j = 0, st = 0; j < n_tiles; ++j, st = (st + 1) % S::NST) {
    const long long k0 = i0 + (long long)j * BK;
    if (S::NST == 2 && j + 1 < n_tiles) stage(st ^ 1, k0 + BK);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // this tile (and Q) landed; the next one stays in flight
    __syncthreads();
    const TQ* sK = sK0;
    const TKV* bytes = sB + (size_t)st * 2 * BK * HD;  // QUANT: this stage's K, then V
    if constexpr (QUANT) {
      dequant_tile<TQ, TKV, HD>(sK0, bytes, sBs + st * 2 * BK, tid);
      if constexpr (!S::ONE_DEQ)
        dequant_tile<TQ, TKV, HD>(sK0 + L::TILE, bytes + BK * HD, sBs + st * 2 * BK + BK, tid);
      __syncthreads();
    } else {
      sK = sK0 + (size_t)st * 2 * L::TILE;
    }
    const TQ* sV = S::ONE_DEQ ? sK0 : sK + L::TILE;
    bool do_pv = false;
    float s[NJ][4];
    if (has_rows) {
      if (j == 0) mm.load_q(sQ, r0, lane);
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
        do_pv = true;
      }
    }
    if constexpr (S::ONE_DEQ) {  // V into the tile the scores are done with
      __syncthreads();
      dequant_tile<TQ, TKV, HD>(sK0, bytes + BK * HD, sBs + st * 2 * BK + BK, tid);
      __syncthreads();
    }
    if (do_pv) mm.pv(acc, s, sV, lane);
    __syncthreads();  // every warp is done with this stage (and the dequantized tiles)
    if (S::NST == 1) {  // one stage: the next tile's copy starts only now
      if (j + 1 < n_tiles) stage(0, k0 + BK);
      tc::cp_async_commit();  // the next step's wait<1> passes its own empty group
    }
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
    constexpr int CH = fma::max_rows(HD);  // the body's chunk: 64 rows, 32 at head dim 256
    const int nst = a.split > CH ? 2 : 1;
    for (int p0 = 0; p0 < R; p0 += FMA_ROWS) {
      const int gp = min(FMA_ROWS, R - p0);
      float carry[U][4];
#pragma unroll
      for (int u = 0; u < U; ++u) carry[u][0] = carry[u][1] = carry[u][2] = carry[u][3] = 0.0f;
      float lam_run = NEG_INF;
      fma::split_partial<TQ, TKV, HD, FMA_ROWS, true>(
          body, gp, CH, nst, a.scale, RowsAt<TQ>{(const TQ*)a.q, sQoff + p0}, src,
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
  constexpr int CH = fma::max_rows(HD);
  const size_t fma_b = fma::Smem(sizeof(TKV), HD, FMA_ROWS, CH, a.split > CH ? 2 : 1).total;
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

// every (q, kv) dtype pair K4 takes at one head dim: q_type / kv_type 0
// float32, 1 bfloat16, 2 int8, 3 fp8 e4m3
template <int HD>
cudaError_t dispatch_types(const Args& a, int q_type, int kv_type, int nbr, cudaStream_t s) {
  if (q_type == 0 && kv_type == 0) return launch<float, float, HD>(a, nbr, s);
  if (q_type == 1 && kv_type == 1) return launch<__nv_bfloat16, __nv_bfloat16, HD>(a, nbr, s);
  if (q_type == 0 && kv_type == 2) return launch<float, signed char, HD>(a, nbr, s);
  if (q_type == 1 && kv_type == 2) return launch<__nv_bfloat16, signed char, HD>(a, nbr, s);
  if (q_type == 0 && kv_type == 3) return launch<float, __nv_fp8_e4m3, HD>(a, nbr, s);
  if (q_type == 1 && kv_type == 3) return launch<__nv_bfloat16, __nv_fp8_e4m3, HD>(a, nbr, s);
  return cudaErrorInvalidValue;
}

// one per built head dim, each defined in the translation unit named above
#define FLASHD_VARLEN_HD(HD) \
  cudaError_t varlen_hd##HD(const Args& a, int q_type, int kv_type, int nbr, cudaStream_t s)
FLASHD_VARLEN_HD(16);
FLASHD_VARLEN_HD(32);
FLASHD_VARLEN_HD(48);
FLASHD_VARLEN_HD(64);
FLASHD_VARLEN_HD(96);
FLASHD_VARLEN_HD(128);
FLASHD_VARLEN_HD(256);

}  // namespace varlen
}  // namespace flashd
