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
//     anything) are never followed. A byte pool (int8 or fp8 e4m3) is
//     staged as bytes with its (page, kv head) scale beside each row and
//     dequantized as a lane reads it (x·scale, the reference's order),
//     before the scores;
//   - fused, each CTA counts itself into a per-(b, kv head) arrival
//     counter after its partial is visible; the last to arrive blends all
//     n_splits partials in split order and writes O (and Λ). Which CTA
//     merges varies, the order does not: repeated calls are bitwise equal.
//     Unfused (K2 only), the kernel writes the partials only
//     (merge_partials runs);
//   - a query group of more than 8 heads (G 9–16: recurrentgemma-9b's and
//     qwen3-moe-235b-a22b's 16) runs as ⌈G / 8⌉ CTAs of up to 8 heads each
//     over the same split, each with its own arrival counter and merge: the
//     group-8 body, whose q and P·V registers (GC × VEC each) would spill at
//     GC 16, serves every group, no wider instance is built, and a kv head's
//     K/V rows are read by each of its CTAs — the second read mostly from
//     L2, since the CTAs of one kv head are launched next to each other.
#include "flashd_decode.cuh"

using namespace flashd;
using namespace flashd::decode;

namespace flashd {
namespace decode {
FLASHD_DECODE_HD(16) { return dispatch_types<16>(a, q_type, kv_type, paged, s); }
FLASHD_DECODE_HD(32) { return dispatch_types<32>(a, q_type, kv_type, paged, s); }
}  // namespace decode
}  // namespace flashd

namespace {

cudaError_t dispatch_hd(int hd, const Args& a, int q_type, int kv_type, bool paged,
                        cudaStream_t s) {
  switch (hd) {
    case 16: return decode_hd16(a, q_type, kv_type, paged, s);
    case 32: return decode_hd32(a, q_type, kv_type, paged, s);
    case 48: return decode_hd48(a, q_type, kv_type, paged, s);
    case 64: return decode_hd64(a, q_type, kv_type, paged, s);
    case 96: return decode_hd96(a, q_type, kv_type, paged, s);
    case 128: return decode_hd128(a, q_type, kv_type, paged, s);
    case 256: return decode_hd256(a, q_type, kv_type, paged, s);
    default: return cudaErrorInvalidValue;
  }
}

// the arrival counters a fused launch zeroes: one per (b, kv head, sub-group)
long long n_arrivals(int B, int Hq, int Hkv) {
  const int G = Hq / Hkv;
  return (long long)B * Hkv * (G <= GC_MAX ? 1 : (G + GC_MAX - 1) / GC_MAX);
}

// kernels/flashd_decode.py::decode_rows decides `rows` the same way
bool bad_split(int Hq, int Hkv, int split, int rows, int hd) {
  return Hkv < 1 || Hq % Hkv != 0 || Hq / Hkv > G_MAX || split < 1 ||
         rows != min((split + 3) / 4 * 4, max_rows(hd));
}

}  // namespace

// K2: one-token decode over the contiguous cache, one launch. Writes the
// split partials o_part [n_splits, B, Hq, hd] / lam_part [n_splits, B, Hq];
// with `arrivals` ([B·Hq] int32 scratch, zeroed here) it also merges them
// in split order into o [B, Hq, hd] (q's dtype) and, when lam_out is not
// null, Λ [B, Hq]. `rows` (a
// multiple of 4, ≤ max_rows(hd)) is the CTA's chunk.
extern "C" int flashd_decode_launch(
    const void* q, const void* k, const void* v, const int* cache_len, const int* start,
    float* o_part, float* lam_part, void* o, float* lam_out, int* arrivals,
    long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    int B, int Hq, int Hkv, int S_max, int hd, int is_bf16,
    int n_splits, int split, int rows, int window, int chunk, float scale, void* stream) {
  if (B == 0 || n_splits == 0) return (int)cudaGetLastError();
  if (bad_split(Hq, Hkv, split, rows, hd)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (arrivals != nullptr) {
    cudaError_t e = cudaMemsetAsync(arrivals, 0, sizeof(int) * n_arrivals(B, Hq, Hkv), s);
    if (e != cudaSuccess) return (int)e;
  }
  Args a{q, k, v, cache_len, start, o_part, lam_part, o, lam_out, arrivals,
         q_sb, q_sh, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss,
         B, Hq, Hkv, S_max, n_splits, split, rows, window, chunk, scale,
         nullptr, 0, 1, nullptr, nullptr};
  return (int)dispatch_hd(hd, a, is_bf16 ? 1 : 0, is_bf16 ? 1 : 0, false, s);
}

// K3: one-token decode through a block table, one launch: the same kernel
// with row i of a sequence at page tbl[b, i / page] of the pools
// [P, page, Hkv, d] (element strides k_sp, k_ss, k_sh), split over
// n_splits runs of `split` positions of S_max = n_tbl·page, merged in split
// order into o [B, Hq, hd] (q's dtype). q_type / kv_type: 0 float32,
// 1 bfloat16, 2 int8, 3 fp8 e4m3 (for 2 and 3, ks / vs [P, Hkv] f32 are the
// per-(page, head) scales; null otherwise). o_part / lam_part are scratch [n_splits, B, Hq,
// hd] / [n_splits, B, Hq]; arrivals [B·Hq] int32, zeroed here.
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
  if (bad_split(Hq, Hkv, split, rows, hd) || page < 1 || n_tbl < 1 ||
      (long long)n_splits * split < (long long)n_tbl * page)
    return (int)cudaErrorInvalidValue;
  if ((kv_type >= 2) != (ks != nullptr && vs != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(arrivals, 0, sizeof(int) * n_arrivals(B, Hq, Hkv), s);
  if (e != cudaSuccess) return (int)e;
  Args a{q, k_pages, v_pages, cache_len, nullptr, o_part, lam_part, o, nullptr, arrivals,
         q_sb, q_sh, k_sp, k_sh, k_ss, v_sp, v_sh, v_ss,
         B, Hq, Hkv, n_tbl * page, n_splits, split, rows, window, chunk, scale,
         tbl, tbl_sb, page, ks, vs};
  return (int)dispatch_hd(hd, a, q_type, kv_type, true, s);
}
