// FLASH-D attention backward for Hopper (K5): the counterpart of the Pallas
// kernel repro/kernels/flashd_bwd.py::flashd_bwd_pallas (_recompute_p_ds,
// _dq_kernel, _dkv_kernel).
//
// From the saved (O, Λ) and D = rowsum(dO∘O) (a PyTorch reduction in the
// wrapper, as the reference computes it outside its kernel):
//
//     P  = e^{s − Λ}            exact probabilities, exponent ≤ 0: no max pass
//     dS = P∘(dO·Vᵀ − D)·scale
//     dQ = dS·K,  dK = dSᵀ·Q,  dV = Pᵀ·dO
//
// Guards: a masked key gets P = 0, and a row with Λ ≤ NEG_INF/2 (dead:
// every key masked, or a padded row) gets P = 0 by a select — without it
// e^{NEG_INF − NEG_INF} = 1 on a dead row.
//
// Bound on the H100: five products of d per visible (q, k) pair — s,
// dO·Vᵀ, dQ, dK, dV: 10·d flops — on O((Sq + Skv)·d) bytes: operations
// bound it, on the tensor cores (989 TFLOP/s bf16; f32 as three TF32
// products at 495). The kernel this one replaced ran them as f32 FMA on the
// CUDA cores (67 TFLOP/s).
//
// Design: K1's tile machine (attn_tc.cuh) turned around, every product on
// mma.sync, the operand tiles in a 2-stage cp.async ring of padded rows.
// Two kernels and no atomics, the TPU's split, so every gradient is summed
// in a fixed order and repeated calls are bitwise equal:
//   - dQ: a CTA per (q block of 64 rows, q head, batch row), 4 warps of 16
//     rows, looping over the live KV tiles of 64 keys (longest q blocks
//     first under causal masks). S = Q·Kᵀ and dP = dO·Vᵀ are K1's score
//     product; dS is formed in the accumulator registers; dQ += dS·K is
//     K1's P·V step with dS for P and K for V.
//   - dK/dV: a CTA per (KV block of 64 keys, kv head, batch row) looping
//     over its G q heads × live q tiles, so GQA's group sum stays in the
//     CTA. Keys are the M rows: Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ put Pᵀ and dSᵀ
//     in registers in the A layout, and dV += Pᵀ·dO, dK += dSᵀ·Q are again
//     the P·V step; Λ and D are per column, staged per q tile in shared
//     memory beside Q and dO. 8 warps in two groups over the same 16-key
//     slices: the dV group forms Pᵀ and adds Pᵀ·dO, the dK group forms dPᵀ
//     meanwhile, takes Pᵀ through shared memory (a named barrier) and adds
//     dSᵀ·Q — two products each, one accumulator a thread.
// Operand rounding: bf16 products take bf16 operands, with P and dS
// rounded to bf16 (as FA2 does); f32 products are 3xTF32 (hi = cvt.rna(x),
// lo = cvt.rna(x − hi)). The f32 P·V step takes P from the score
// registers with its k order permuted (logical k t ↔ column 2t, t + 4 ↔
// 2t + 1) and reads B rows 2t, 2t + 1 to match, so no transposed copy.
// The tensor core truncates when it adds its products to an accumulator,
// and dK / dV sum over G × every q tile, so no gradient accumulator is
// chained through an mma: each k8 step (f32) or each 16 output columns of
// a tile (bf16) goes into a fresh partial added to it in f32.
//
// Registers and shared memory at d 128 (ptxas -v, sm_90a; no spills): dQ
// 255 registers f32 / 224 bf16, 6 padded 64-row tiles (Q, dO, two K/V
// stages) of shared memory, 203 KB f32 — one CTA (4 warps) an SM — and
// 104 KB bf16, two; dK/dV 187 f32 / 230 bf16, 6 tiles (K, V, two Q/dO
// stages) + Pᵀ, 222 KB f32 and 122 KB bf16, one CTA (8 warps) an SM. A
// 4-warp dK/dV CTA holding both accumulators spilled at f32 d 128: hence
// the two groups.
//
// Head dim 256 (recurrentgemma-9b) changes the tile plan (flashd_bwd.cuh
// Plan), because neither the shared memory nor the registers of the d-128
// plan fit there. A padded 64-row tile is 66,560 B in f32 (33,792 B
// bf16), so the d-128 plan's six tiles would take 400,384 B (dQ) and
// 418,816 B (dK/dV) in f32 against the 232,448 B a block may hold; and a
// thread's accumulator doubles to 128 registers, beside which 64 score
// registers (dQ's S and dP over 64 keys) would not fit. So at d 256:
//   - dQ keeps its 64 q rows (4 warps) and streams K/V tiles of 32 keys:
//     its S and dP take 16 registers each. f32: Q, dO and one K/V stage,
//     199,680 B (two stages would be 266,240 B), the next tile copied once
//     every warp is done with this one, as K1's one-stage ring; bf16: two
//     stages, 135,168 B;
//   - dK/dV owns 32 keys (two groups of 2 warps) and streams q tiles of 64
//     rows: Pᵀ / dPᵀ take 32 registers. f32: K, V, one Q/dO stage, Λ/D
//     and Pᵀ (32 × 72 floats), 209,920 B (two stages: 343,040 B); bf16:
//     two stages, 179,200 B.
// Summation follows the tiles: dQ adds fresh partials per k8 step (f32)
// or per 16 columns of a 32-key tile (bf16), and dK / dV per q tile of
// 64, as at d 128. K5 has no θ-skip, so no threshold depends on a tile
// height. The d-256 instances live in flashd_bwd_hd256.cu; phase 2 of
// chip_smoke.py prints their registers and spill.
#include "flashd_bwd.cuh"

using namespace flashd;
using namespace flashd::bwd;

namespace flashd {
namespace bwd {
FLASHD_BWD_HD(16) { return bf16 ? launch<__nv_bfloat16, 16>(a, s) : launch<float, 16>(a, s); }
FLASHD_BWD_HD(32) { return bf16 ? launch<__nv_bfloat16, 32>(a, s) : launch<float, 32>(a, s); }
FLASHD_BWD_HD(48) { return bf16 ? launch<__nv_bfloat16, 48>(a, s) : launch<float, 48>(a, s); }
FLASHD_BWD_HD(64) { return bf16 ? launch<__nv_bfloat16, 64>(a, s) : launch<float, 64>(a, s); }
FLASHD_BWD_HD(96) { return bf16 ? launch<__nv_bfloat16, 96>(a, s) : launch<float, 96>(a, s); }
FLASHD_BWD_HD(128) { return bf16 ? launch<__nv_bfloat16, 128>(a, s) : launch<float, 128>(a, s); }
}  // namespace bwd
}  // namespace flashd

namespace {

cudaError_t dispatch_hd(int hd, const Args& a, bool bf16, cudaStream_t s) {
  switch (hd) {
    case 16: return bwd_hd16(a, bf16, s);
    case 32: return bwd_hd32(a, bf16, s);
    case 48: return bwd_hd48(a, bf16, s);
    case 64: return bwd_hd64(a, bf16, s);
    case 96: return bwd_hd96(a, bf16, s);
    case 128: return bwd_hd128(a, bf16, s);
    case 256: return bwd_hd256(a, bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flashd_bwd_launch(
    const void* q, const void* k, const void* v, const void* dout, const float* lam,
    const float* dsum, void* dq, void* dk, void* dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long do_sb, long long do_sh, long long do_ss,
    long long dq_sb, long long dq_sh, long long dq_ss,
    long long dk_sb, long long dk_sh, long long dk_ss,
    long long dv_sb, long long dv_sh, long long dv_ss,
    int B, int Hq, int Hkv, int Sq, int Skv, int hd, int is_bf16,
    int mask_kind, int window, int chunk, int q_offset, float scale, void* stream) {
  if (B == 0 || Hq == 0 || (Sq == 0 && Skv == 0)) return (int)cudaGetLastError();
  Args a{q, k, v, dout, lam, dsum, dq, dk, dv,
            q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, do_sb, do_sh, do_ss,
            dq_sb, dq_sh, dq_ss, dk_sb, dk_sh, dk_ss, dv_sb, dv_sh, dv_ss,
            B, Hq, Hkv, Sq, Skv, AttnMask{mask_kind, window, chunk, q_offset, Skv}, scale};
  return (int)dispatch_hd(hd, a, is_bf16 != 0, (cudaStream_t)stream);
}
