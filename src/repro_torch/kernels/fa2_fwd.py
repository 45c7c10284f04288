"""K6 — FlashAttention-2 forward on the H100 (the paper's baseline), and its
plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/fa2_fwd.py::fa2_fwd_pallas`
(`_fa2_kernel`). The CUDA source is `csrc/fa2_fwd.cu`.

Design. The paper's comparison is controlled: the two kernels share the
tiling and differ only in the datapath. So K6 runs K1's tile machine
(`csrc/attn_tc.cuh`: a CTA per (q block of 64 rows, q head, batch row)
looping over KV tiles of 64 keys, both products on the tensor cores —
bf16 m16n8k16, f32 as 3xTF32 — a cp.async K/V ring, masks and `tile_live`
pruning), with FA2's carry in place of FLASH-D's: a running max m and sum
ℓ per row, the α = e^{m−m'} rescale of ℓ and acc per tile, and the acc/ℓ
division at the end. It returns (O, Λ = m + ln ℓ) with FLASH-D's dead-row
convention (Λ = NEG_INF, O = 0), so K5 serves its backward as it serves
K1's. The carry code is K6's own: nothing of K1's carry is shared. There
is no skip option (the reference FA2 kernel has none). Operands obey K1's
16-byte copy alignment (`check_copy_alignment`).

Bound. K1's: 4·d flops per visible (q, k) pair over 989 TFLOP/s in bf16,
three TF32 products over 495 TFLOP/s in f32. Its times, beside K1's at
the same shape, are in PERF.md.

`launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.blockwise import MaskSpec, blockwise_fa2
from repro_torch.kernels.flashd_fwd import (
    _MASK_KINDS,
    check_copy_alignment,
    check_no_grad,
    check_operands,
)

__all__ = ["fa2_fwd", "fa2_fwd_plain", "launches"]

launches = 0
_fn = None


def fa2_fwd_plain(
    q: torch.Tensor,  # [B, Hq, Sq, d]
    k: torch.Tensor,  # [B, Hkv, Skv, d]
    v: torch.Tensor,  # [B, Hkv, Skv, dv]
    *,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
):
    """The kernel's function in plain PyTorch: `blockwise_fa2` over every
    (batch, kv head, q group). Returns (o [B, Hq, Sq, dv] in q.dtype,
    Λ [B, Hq, Sq] f32); blocks left None take `tuning.choose_prefill_blocks`."""
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    if block_q is None or block_k is None:
        from repro_torch.kernels.tuning import choose_prefill_blocks

        tiling = choose_prefill_blocks(sq, skv, d, dv)
        block_q = tiling.block_q if block_q is None else block_q
        block_k = tiling.block_k if block_k is None else block_k
    o, lam = blockwise_fa2(
        q.reshape(b, hkv, hq // hkv, sq, d), k[:, :, None], v[:, :, None], mask=mask,
        scale=scale, block_q=min(block_q, max(sq, 1)), block_k=min(block_k, max(skv, 1)),
    )
    return o.reshape(b, hq, sq, dv).to(q.dtype), lam.reshape(b, hq, sq)


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels._build import load

        fn = load("fa2_fwd").fa2_fwd_launch
        P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 5 + [L] * 12 + [I] * 11 + [F, P]
        fn.restype = I
        _fn = fn
    return _fn


def fa2_fwd(
    q: torch.Tensor,  # [B, Hq, Sq, d]  — any strides with a contiguous head dim
    k: torch.Tensor,  # [B, Hkv, Skv, d]
    v: torch.Tensor,  # [B, Hkv, Skv, d]
    *,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
):
    """Launch K6. Returns (o [B, Hq, Sq, d] in q.dtype, Λ [B, Hq, Sq] f32);
    `o` is a view of a [B, Sq, Hq, d] (model layout) buffer, as K1's. Like
    K1's wrapper it refuses inputs that need a gradient."""
    global launches
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    check_operands("fa2_fwd", (q, k, v), d)
    check_copy_alignment("fa2_fwd", (q, k, v))
    check_no_grad(q, k, v)
    if k.shape != (b, hkv, skv, d) or dv != d or hq % hkv:
        raise ValueError(f"fa2_fwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (needs d == dv, Hq % Hkv == 0)")
    if mask.kind not in _MASK_KINDS:
        raise ValueError(f"unknown mask kind {mask.kind!r}")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    o = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device).transpose(1, 2)
    lam = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lam.data_ptr(),
        *(x.stride(i) for x in (q, k, v, o) for i in range(3)),
        b, hq, hkv, sq, skv, d, int(q.dtype == torch.bfloat16),
        _MASK_KINDS[mask.kind], mask.window, mask.chunk, mask.q_offset, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"fa2_fwd: CUDA error {rc} at launch")
    return o, lam
