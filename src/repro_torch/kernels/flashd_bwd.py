"""K5 — FLASH-D attention backward on the H100, and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/flashd_bwd.py::flashd_bwd_pallas`
(`_recompute_p_ds`, `_dq_kernel`, `_dkv_kernel` and their two
`pallas_call`s). The CUDA source is `csrc/flashd_bwd.cu`.

From the forward's saved (O, Λ) it recomputes P = exp(s − Λ) — exact, with
an exponent ≤ 0, so no max pass — and returns dQ = dS·K, dK = dSᵀ·Q,
dV = Pᵀ·dO with dS = P∘(dO·Vᵀ − D)·scale and D = rowsum(dO∘O). D is one
PyTorch reduction here, as the reference computes it outside its kernel.

Design. Two kernels and no atomics, the TPU's split: a dQ kernel with a CTA
per (q block, q head, batch row) looping over the KV tiles, and a dK/dV
kernel with a CTA per (kv block, kv head, batch row) looping over its G q
heads × q blocks, so GQA's group sum stays in registers. Each gradient is
summed in a fixed order: the same inputs give the same bits on every run,
which the bitwise-resume contract of the resilient trainer relies on. The
masks, tiles (32 × 64) and `tile_live` pruning are K1's; dead rows
(Λ ≤ NEG_INF/2, padded q rows) get P = 0. Q, K, V and dO are read through
their strides and dQ, dK, dV written in the model layout, so the
reference's transposed copies (`ops.py:181-184`) disappear. The forward's
`skip` does not reach the backward: P is recomputed exactly.

Bound. Five products of d per visible (q, k) pair — 10·d flops — on
O((Sq + Skv)·d) bytes: operations bound it, at 67 TFLOP/s in f32 on the
CUDA cores, where this first kernel runs them as FMA. Its times are in
PERF.md.

`launches` counts calls that launch the pair (one per backward).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.blockwise import MaskSpec, blockwise_backward
from repro_torch.kernels.flashd_fwd import _MASK_KINDS, check_operands

__all__ = ["flashd_bwd", "flashd_bwd_plain", "launches"]

launches = 0
_fn = None


def flashd_bwd_plain(
    q: torch.Tensor,  # [B, Hq, Sq, d]
    k: torch.Tensor,  # [B, Hkv, Skv, d]
    v: torch.Tensor,  # [B, Hkv, Skv, dv]
    o: torch.Tensor,  # [B, Hq, Sq, dv]
    lam: torch.Tensor,  # [B, Hq, Sq]
    do: torch.Tensor,  # [B, Hq, Sq, dv]
    *,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
):
    """The kernel's function in plain PyTorch: `blockwise_backward` over
    every (batch, kv head, q group), dK/dV summed over the group in f32.
    Returns (dq, dk, dv) in the layout and dtypes of (q, k, v)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, dv_ = v.shape
    g = hq // hkv
    dq, dk, dv = blockwise_backward(  # f32 operands: one rounding at the end, as the kernel
        q.float().reshape(b, hkv, g, sq, d), k.float()[:, :, None], v.float()[:, :, None],
        o.reshape(b, hkv, g, sq, dv_), lam.reshape(b, hkv, g, sq),
        do.reshape(b, hkv, g, sq, dv_), mask=mask, scale=scale,
        block_q=min(block_q, max(sq, 1)), block_k=min(block_k, max(skv, 1)),
    )
    return (dq.reshape(b, hq, sq, d).to(q.dtype), dk.sum(dim=2).to(k.dtype),
            dv.sum(dim=2).to(v.dtype))


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels._build import load

        fn = load("flashd_bwd").flashd_bwd_launch
        P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 9 + [L] * 21 + [I] * 11 + [F, P]
        fn.restype = I
        _fn = fn
    return _fn


def flashd_bwd(
    q: torch.Tensor,  # [B, Hq, Sq, d]   — any strides with a contiguous head dim
    k: torch.Tensor,  # [B, Hkv, Skv, d]
    v: torch.Tensor,  # [B, Hkv, Skv, d]
    o: torch.Tensor,  # [B, Hq, Sq, d]   saved forward output
    lam: torch.Tensor,  # [B, Hq, Sq] f32 saved Λ
    do: torch.Tensor,  # [B, Hq, Sq, d]
    *,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
):
    """Launch K5. Returns (dq [B, Hq, Sq, d], dk, dv [B, Hkv, Skv, d]) in the
    operands' dtype, each a view of a buffer in the model layout [B, S, H,
    d] (so `.transpose(1, 2)` is contiguous)."""
    global launches
    b, hq, sq, d = q.shape
    _, hkv, skv, dv_ = v.shape
    check_operands("flashd_bwd", (q, k, v, o, do), d)
    if (k.shape != (b, hkv, skv, d) or dv_ != d or hq % hkv or o.shape != q.shape
            or do.shape != q.shape or lam.shape != (b, hq, sq)):
        raise ValueError(f"flashd_bwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} o {tuple(o.shape)} Λ {tuple(lam.shape)} "
                         f"dO {tuple(do.shape)} (needs d == dv, Hq % Hkv == 0)")
    if mask.kind not in _MASK_KINDS:
        raise ValueError(f"unknown mask kind {mask.kind!r}")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    lam = lam.float().contiguous()
    dsum = torch.sum(do.float() * o.float(), dim=-1).contiguous()  # D = rowsum(dO ∘ O)
    dq = torch.empty((b, sq, hq, d), dtype=q.dtype, device=q.device).transpose(1, 2)
    dk = torch.empty((b, skv, hkv, d), dtype=k.dtype, device=q.device).transpose(1, 2)
    dv = torch.empty((b, skv, hkv, d), dtype=v.dtype, device=q.device).transpose(1, 2)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lam.data_ptr(),
        dsum.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *(x.stride(i) for x in (q, k, v, do, dq, dk, dv) for i in range(3)),
        b, hq, hkv, sq, skv, d, int(q.dtype == torch.bfloat16),
        _MASK_KINDS[mask.kind], mask.window, mask.chunk, mask.q_offset, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"flashd_bwd: CUDA error {rc} at launch")
    return dq, dk, dv
