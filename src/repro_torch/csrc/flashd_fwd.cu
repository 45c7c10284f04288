// FLASH-D forward (prefill) for Hopper (K1): the counterpart of the Pallas
// kernel repro/kernels/flashd_fwd.py::flashd_fwd_pallas (_flashd_kernel).
//
// The tile machine is attn_tc.cuh's, shared with K6 (fa2_fwd.cu): a CTA per
// (q block of 64 rows, q head, batch row) loops over the live KV tiles — the
// TPU's sequential kv grid axis — with both products on the tensor cores and
// the K/V tiles in a cp.async ring. This file holds only FLASH-D's carry,
// per row, with the exact guards of the Pallas body:
//
//     m_b = tile max, m_safe = max(m_b, NEG_INF/2), p = e^{s − m_safe}
//     λ_b = m_safe + ln Σp          (NEG_INF when Σp = 0)
//     W = σ(λ_b − Λ), Λ' = λ_b − ln W, c = e^{m_safe − Λ'} ≤ 1
//     acc ← acc·(1 − W) + (P·c)·V   — no epilogue division
//
// With skip on, a row whose tile max lies more than θ + ln(block_k) below
// its running Λ keeps its carry, and a warp whose 16 rows all skip does no
// exp and no P·V.
//
// Bound on the H100 at prefill lengths: operations, 4·d flops per visible
// (q, k) pair — bf16 on the tensor cores at 989 TFLOP/s; f32 as 3xTF32,
// three TF32 products at 495 TFLOP/s (the f32 CUDA-core rate, 67 TFLOP/s,
// is what the kernel this one replaced was bound by); the exps on the
// special-function units come next. The design moves both products onto
// mma.sync (bf16 m16n8k16; f32 m16n8k8 TF32 split 3 ways) and overlaps the
// next tile's copy with the current tile's products. mma.sync rather than
// wgmma: one datapath serves both dtypes — TF32 wgmma has no transpose for
// V's tile and reads B only from shared memory, so 3xTF32 there would need
// hi/lo and transposed copies of every K/V tile — and its fragments are
// addressable per thread, which the carry's row reductions read directly.
// A bf16 wgmma body (A from registers, B through no-swizzle descriptors on
// a core-matrix tile layout) was tried on the card: correct at head dims
// 32, 48 and 128 but not 64, and slower than this body while each product
// is waited for before the softmax. wgmma pays once the products run
// asynchronously (a TMA producer warp, pingpong): the next step (ROADMAP).
//
// Occupancy at d 128 (ptxas -v on sm_90a; shared memory is 5 tiles of 64
// padded rows: Q and two stages of K and V): bf16 209 registers and 87,040
// B — two CTAs (8 warps) an SM; f32 223 registers and 168,960 B — one CTA
// (4 warps) an SM, bound by shared memory. At d 256 (recurrentgemma-9b):
// bf16 250 registers (Q read per k step) and 168,960 B; f32 255 registers
// with 48 B of spill stores (P·V in passes of 64 columns) and 199,680 B,
// its ring one stage deep — one CTA an SM either way.
#include "attn_tc.cuh"

using namespace flashd;

namespace {

struct FlashdCarry {
  float lam = NEG_INF;

  __device__ __forceinline__ float base(float m_b) const { return fmaxf(m_b, DEAD); }

  __device__ __forceinline__ bool updates(float m_b, const tc::Args& a) const {
    return lam <= DEAD || fmaxf(m_b, DEAD) - lam >= -a.skip_thr;
  }

  __device__ __forceinline__ void step(float, float m_safe, float l, const tc::Args& a,
                                       float& acc_scale, float& p_scale) {
    const float lam_b = l > 0.0f ? m_safe + logf(fmaxf(l, F32_TINY)) : NEG_INF;
    const float delta = lam_b - lam;
    float w = sigmoid(delta);
    float ln = lam_b - log_sigmoid(delta);  // = logaddexp(Λ, λ_b), no division
    const bool dead = lam_b <= DEAD;
    const bool first = lam <= DEAD;
    w = dead ? 0.0f : (first ? 1.0f : w);
    ln = dead ? lam : (first ? lam_b : ln);
    float c = dead ? 0.0f : expf(m_safe - ln);  // ≤ 1
    if (a.skip && !first && m_safe - lam < -a.skip_thr) {
      w = 0.0f;
      c = 0.0f;
      ln = lam;
    }
    lam = ln;
    acc_scale = 1.0f - w;
    p_scale = c;
  }

  // no division, no rescale: acc already holds softmax(S)·V
  __device__ __forceinline__ float out(float acc) const { return acc; }
  __device__ __forceinline__ float lse() const { return lam; }
};

template <typename T, int HD>
__global__ void __launch_bounds__(tc::NTHREADS) flashd_fwd_kernel(tc::Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  tc::tile_machine<FlashdCarry, T, HD>(a, smem);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const tc::Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return tc::launch<T, 16>(flashd_fwd_kernel<T, 16>, a, stream);
    case 32: return tc::launch<T, 32>(flashd_fwd_kernel<T, 32>, a, stream);
    case 48: return tc::launch<T, 48>(flashd_fwd_kernel<T, 48>, a, stream);
    case 64: return tc::launch<T, 64>(flashd_fwd_kernel<T, 64>, a, stream);
    case 96: return tc::launch<T, 96>(flashd_fwd_kernel<T, 96>, a, stream);
    case 128: return tc::launch<T, 128>(flashd_fwd_kernel<T, 128>, a, stream);
    case 256: return tc::launch<T, 256>(flashd_fwd_kernel<T, 256>, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flashd_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lam,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int Hq, int Hkv, int Sq, int Skv, int hd, int is_bf16,
    int mask_kind, int window, int chunk, int q_offset, int block_k,
    float scale, int skip, float skip_thr, void* stream) {
  if (Sq == 0 || B == 0 || Hq == 0) return (int)cudaGetLastError();
  if (block_k < 1 || block_k > tc::BKP) return (int)cudaErrorInvalidValue;
  tc::Args a{q, k, v, o, lam,
             q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
             B, Hq, Hkv, Sq, Skv, AttnMask{mask_kind, window, chunk, q_offset, Skv},
             block_k, scale, skip, skip_thr};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, a, s) : dispatch_hd<float>(hd, a, s);
  return (int)e;
}
