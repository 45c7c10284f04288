// Shared device helpers of the FLASH-D Hopper kernels (flashd_fwd.cu,
// flashd_decode.cu, flashd_varlen.cu, flashd_bwd.cu, fa2_fwd.cu). Everything is f32 arithmetic with the exact library
// functions (expf / logf / log1pf): the kernels are held to 5e-5 against
// their plain PyTorch versions, so no --use_fast_math and no __expf.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace flashd {

// finite stand-in for -inf in masked scores; a Λ at or below NEG_INF / 2
// marks a dead row / dead partial (O = 0, Λ = NEG_INF)
constexpr float NEG_INF = -1e30f;
constexpr float DEAD = NEG_INF * 0.5f;
constexpr float F32_TINY = 1.17549435e-38f;  // jnp.finfo(float32).tiny

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(signed char x) { return (float)x; }  // int8 pool

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// stable log σ(x) = min(x, 0) − log1p(e^{−|x|})
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// Python's floor division (positions may go negative, e.g. cache_len − 1)
__device__ __forceinline__ long long floordiv(long long a, long long b) {
  long long q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

enum MaskKind { MASK_FULL = 0, MASK_CAUSAL = 1, MASK_LOCAL = 2, MASK_CHUNKED = 3 };

// core/blockwise.py::MaskSpec over a q block × kv tile grid (the full-
// sequence kernels K1, K5, K6): `kv_len` bounds the key axis
struct AttnMask {
  int kind, window, chunk, q_offset, kv_len;

  // core/blockwise.py::tile_live for a (bq, bk) tiling
  __device__ __forceinline__ bool tile_live(int iq, int bq, int ik, int bk) const {
    const long long k_lo = (long long)ik * bk;
    if (kind == MASK_FULL) return k_lo < kv_len;
    const long long k_hi = k_lo + bk - 1;
    const long long q_lo = (long long)iq * bq + q_offset;
    const long long q_hi = q_lo + bq - 1;
    bool live = k_lo <= q_hi;
    if (kind == MASK_LOCAL) live = live && (q_lo - k_hi < window);
    if (kind == MASK_CHUNKED) live = live && (floordiv(q_lo, chunk) <= floordiv(k_hi, chunk));
    return live;
  }

  // kernels/flashd_fwd.py::_mask_bias as a predicate
  __device__ __forceinline__ bool keep(int qpos, int kpos) const {
    if (kpos >= kv_len) return false;
    if (kind == MASK_FULL) return true;
    const long long qp = (long long)qpos + q_offset;
    const long long kp = kpos;
    bool ok = kp <= qp;
    if (kind == MASK_LOCAL) ok = ok && (qp - kp < window);
    if (kind == MASK_CHUNKED) ok = ok && (floordiv(qp, chunk) == floordiv(kp, chunk));
    return ok;
  }
};

}  // namespace flashd
