// FlashAttention-2 forward for Hopper (K6): the counterpart of the Pallas
// kernel repro/kernels/fa2_fwd.py::fa2_fwd_pallas (_fa2_kernel), the paper's
// controlled baseline.
//
// The CTA structure, tiles, staging, products, masks and tile pruning are
// K1's: both kernels run attn_tc.cuh's tile machine (64 q rows, KV tiles of
// 64 keys, mma.sync on the tensor cores — bf16 m16n8k16, f32 as 3xTF32 —
// and a cp.async K/V ring). Only the carry differs — FA2's two row vectors
// and accumulator, with the rescale chain through the running max and the
// division epilogue that FLASH-D removes:
//
//     m' = max(m, m_b), m_safe = max(m', NEG_INF/2)
//     α = e^{m − m_safe} (0 while m is dead), p = e^{s − m_safe}
//     ℓ ← ℓ·α + Σp,  acc ← acc·α + P·V
//     epilogue: O = acc / max(ℓ, tiny),  Λ = m + ln ℓ (NEG_INF when ℓ = 0)
//
// It returns the same (O, Λ) as K1, dead rows O = 0 and Λ = NEG_INF, so the
// one backward kernel (flashd_bwd.cu) serves both forwards. There is no skip
// (the reference FA2 kernel has none); its KV tile is 64 keys.
//
// Bound on the H100: as K1's (flashd_fwd.cu), operations — 4·d flops per
// visible (q, k) pair over 989 TFLOP/s in bf16, three TF32 products over
// 495 TFLOP/s in f32; the design, and why mma.sync, are K1's.
#include "attn_tc.cuh"

using namespace flashd;

namespace {

struct Fa2Carry {
  float m = NEG_INF;
  float l = 0.0f;

  __device__ __forceinline__ float base(float m_b) const { return fmaxf(fmaxf(m, m_b), DEAD); }

  __device__ __forceinline__ bool updates(float, const tc::Args&) const { return true; }  // no skip

  __device__ __forceinline__ void step(float m_b, float m_safe, float l_b, const tc::Args&,
                                       float& acc_scale, float& p_scale) {
    const float alpha = m <= DEAD ? 0.0f : expf(m - m_safe);  // the rescale
    l = l * alpha + l_b;
    m = fmaxf(m, m_b);  // the serial cross-tile max chain
    acc_scale = alpha;
    p_scale = 1.0f;
  }

  // the epilogue division FLASH-D eliminates
  __device__ __forceinline__ float out(float acc) const { return acc / fmaxf(l, F32_TINY); }
  __device__ __forceinline__ float lse() const {
    return l > 0.0f ? m + logf(fmaxf(l, F32_TINY)) : NEG_INF;
  }
};

template <typename T, int HD>
__global__ void __launch_bounds__(tc::NTHREADS) fa2_fwd_kernel(tc::Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  tc::tile_machine<Fa2Carry, T, HD>(a, smem);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const tc::Args& a, cudaStream_t stream) {
  switch (hd) {
    case 16: return tc::launch<T, 16>(fa2_fwd_kernel<T, 16>, a, stream);
    case 32: return tc::launch<T, 32>(fa2_fwd_kernel<T, 32>, a, stream);
    case 48: return tc::launch<T, 48>(fa2_fwd_kernel<T, 48>, a, stream);
    case 64: return tc::launch<T, 64>(fa2_fwd_kernel<T, 64>, a, stream);
    case 96: return tc::launch<T, 96>(fa2_fwd_kernel<T, 96>, a, stream);
    case 128: return tc::launch<T, 128>(fa2_fwd_kernel<T, 128>, a, stream);
    case 256: return tc::launch<T, 256>(fa2_fwd_kernel<T, 256>, a, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int fa2_fwd_launch(
    const void* q, const void* k, const void* v, void* o, float* lam,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    int B, int Hq, int Hkv, int Sq, int Skv, int hd, int is_bf16,
    int mask_kind, int window, int chunk, int q_offset, float scale, void* stream) {
  if (Sq == 0 || B == 0 || Hq == 0) return (int)cudaGetLastError();
  tc::Args a{q, k, v, o, lam,
             q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
             B, Hq, Hkv, Sq, Skv, AttnMask{mask_kind, window, chunk, q_offset, Skv},
             tc::BKP, scale, 0, 0.0f};
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = is_bf16 ? dispatch_hd<__nv_bfloat16>(hd, a, s) : dispatch_hd<float>(hd, a, s);
  return (int)e;
}
