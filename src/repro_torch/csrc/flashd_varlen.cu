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
//     read by the copying thread for live rows only). A byte pool (int8
//     or fp8 e4m3) is staged as bytes with its (page, kv head) scales and
//     dequantized when read (x·scale, the reference's order).
//   - few rows (< 16 live rows per kv head: decode rows, short verify
//     segments): decode_fma.cuh's CUDA-core body, K3's, over the run in
//     passes of 8 rows, each row masked at its own q_pos (causal, window,
//     chunk), in chunks of 64 positions (32 at head dim 256).
//   - many rows (≥ 16: prefill chunks at block_q·G ≥ 16, whole prompts):
//     attn_tc.cuh's Products on the tensor cores, 16 rows a warp, over
//     64-key tiles in a 2-stage cp.async ring (K1's one stage for f32 at
//     head dim 256; see TcSmem for byte pools), with K1's FLASH-D carry per
//     row — bf16 as bf16 with P rounded to bf16, f32 as 3xTF32 with each
//     k8 step's score partial and each tile's P·V partial added in f32.
//     A decode row of a group of 16 (qwen3-moe-235b-a22b) is 16 live rows:
//     the tensor cores, one row group of a block_q·16-row block.
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
#include "flashd_varlen.cuh"

using namespace flashd;
using namespace flashd::varlen;

namespace flashd {
namespace varlen {
FLASHD_VARLEN_HD(16) { return dispatch_types<16>(a, q_type, kv_type, nbr, s); }
FLASHD_VARLEN_HD(32) { return dispatch_types<32>(a, q_type, kv_type, nbr, s); }
FLASHD_VARLEN_HD(48) { return dispatch_types<48>(a, q_type, kv_type, nbr, s); }
}  // namespace varlen
}  // namespace flashd

namespace {

cudaError_t dispatch_hd(int hd, const Args& a, int q_type, int kv_type, int nbr, cudaStream_t s) {
  switch (hd) {
    case 16: return varlen_hd16(a, q_type, kv_type, nbr, s);
    case 32: return varlen_hd32(a, q_type, kv_type, nbr, s);
    case 48: return varlen_hd48(a, q_type, kv_type, nbr, s);
    case 64: return varlen_hd64(a, q_type, kv_type, nbr, s);
    case 96: return varlen_hd96(a, q_type, kv_type, nbr, s);
    case 128: return varlen_hd128(a, q_type, kv_type, nbr, s);
    case 256: return varlen_hd256(a, q_type, kv_type, nbr, s);
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
// q_type / kv_type: 0 float32, 1 bfloat16, 2 int8, 3 fp8 e4m3 (for 2 and 3,
// ks / vs [P, Hkv] f32 are the per-(page, head) scales; null otherwise). Strides are in
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
  if ((kv_type >= 2) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
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
  return (int)dispatch_hd(hd, a, q_type, kv_type, nbr, s);
}
