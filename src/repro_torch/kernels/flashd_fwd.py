"""K1 — FLASH-D forward (prefill) on the H100, and its plain PyTorch version.

Replaces the Pallas TPU kernel `repro/kernels/flashd_fwd.py::flashd_fwd_pallas`
(`_flashd_kernel`, `_mask_bias`; pruning by `core/blockwise.py::tile_live`).
The CUDA source is `csrc/flashd_fwd.cu`.

Design. The TPU ran a (batch, head, q block, kv block) grid whose kv axis
was sequential, carrying (acc, Λ) in VMEM. Hopper runs blocks in parallel
and in no order, so one CTA owns a (q block of 64 rows, q head, batch row)
and loops over the KV tiles itself, with the exact FLASH-D carry and guards
of the Pallas body (tile-local max clamped at NEG_INF/2, `tile_dead` /
`first` selects, c ≤ 1, no epilogue division). Q, K and V are read through
their strides, so the model layout [B, S, H, d] goes in as a transposed
view — the reference's `ops.py` transposed copies of q/k/v disappear.
Tiles that `tile_live` rules out are never loaded, and q rows ≥ Sq are
never written.

Datapath. Both products run on the tensor cores (mma.sync): bf16 operands
as m16n8k16 with P rounded to bf16; f32 operands as 3xTF32 (each operand
split into two TF32 halves, three products, f32 accumulation), which holds
the 5e-5 bound where one-pass TF32 would not. K/V tiles stream through a
2-stage cp.async ring (one stage for f32 at head dim 256, whose two stages
would pass a block's 227 KB of shared memory). The tile machine (`csrc/attn_tc.cuh`) is shared
with K6; only the carry is this kernel's. cp.async copies 16 bytes, so
every operand's base and batch / head / row strides must be multiples of
16 bytes (`check_copy_alignment`); the model-layout views are.

Bound. At prefill lengths the work is O(Sq·Skv·d) operations on
O((Sq + Skv)·d) bytes: operations bound it — 4·d flops per visible pair
over 989 TFLOP/s in bf16, three TF32 products over 495 TFLOP/s in f32.
Its times are in PERF.md.

Launches are counted in the module-level integer `launches` (one per
kernel launch), which `chip_smoke.py` reads to prove the main path ran it.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.blockwise import DEFAULT_SKIP_THETA, MaskSpec, blockwise_flashd

__all__ = [
    "flashd_fwd",
    "flashd_fwd_plain",
    "KERNEL_BLOCK_Q",
    "KERNEL_BLOCK_K",
    "HEAD_DIMS",
    "check_copy_alignment",
    "launches",
]

KERNEL_BLOCK_Q = 64  # q rows per CTA (tc::BQ in csrc/attn_tc.cuh)
KERNEL_BLOCK_K = 64  # default and largest kv tile (tc::BKP)
HEAD_DIMS = (16, 32, 48, 64, 96, 128, 256)  # built into K1–K4 and K6 (K5: flashd_bwd.HEAD_DIMS)
_MASK_KINDS = {"full": 0, "causal": 1, "local": 2, "chunked": 3}

launches = 0
_fn = None


def flashd_fwd_plain(
    q: torch.Tensor,  # [B, Hq, Sq, d]
    k: torch.Tensor,  # [B, Hkv, Skv, d]
    v: torch.Tensor,  # [B, Hkv, Skv, dv]
    *,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    skip: bool = False,
    skip_theta: float = DEFAULT_SKIP_THETA,
):
    """The kernel's function in plain PyTorch: the tile loop of
    `blockwise_flashd` over every (batch, kv head, q group). Returns
    (o [B, Hq, Sq, dv] in q.dtype, Λ [B, Hq, Sq] f32). Blocks left None
    take the reference's heuristic (`tuning.choose_prefill_blocks`)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    if block_q is None or block_k is None:
        from repro_torch.kernels.tuning import choose_prefill_blocks

        tiling = choose_prefill_blocks(sq, skv, d, dv)
        block_q = tiling.block_q if block_q is None else block_q
        block_k = tiling.block_k if block_k is None else block_k
    o, lam = blockwise_flashd(
        q.reshape(b, hkv, hq // hkv, sq, d), k[:, :, None], v[:, :, None],
        mask=mask, scale=scale, block_q=min(block_q, max(sq, 1)),
        block_k=min(block_k, max(skv, 1)), skip=skip, skip_theta=skip_theta,
    )
    return o.reshape(b, hq, sq, dv).to(q.dtype), lam.reshape(b, hq, sq)


def check_no_grad(*tensors: torch.Tensor) -> None:
    """A forward kernel's wrapper carries no gradient of its own: refuse
    inputs that would need one rather than return outputs that silently
    carry none. Training goes through `core.attention.flash_attention`,
    whose autograd Function calls K1 / K6 with gradients off and runs K5 as
    the backward; the decode kernels (K2–K4) serve only."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            "the FLASH-D kernel wrappers have no backward of their own: call under "
            "torch.no_grad(); training goes through core.attention.flash_attention"
        )


def check_operands(name: str, tensors, head_dim: int, head_dims=HEAD_DIMS) -> None:
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(
                f"{name} launches a CUDA kernel and got a {t.device.type} tensor; "
                f"the plain version is {name}_plain"
            )
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: dtype {t.dtype} not supported (float32, bfloat16)")
        if t.dtype != tensors[0].dtype:
            raise ValueError(f"{name}: operands must share one dtype")
        if t.device != tensors[0].device:
            raise ValueError(f"{name}: operands must be on one device")
        if t.stride(-1) != 1:
            raise ValueError(f"{name}: the head dim must be contiguous (stride 1)")
    if head_dim not in head_dims:
        raise ValueError(f"{name}: head dim {head_dim} not built (have {head_dims})")


def check_copy_alignment(name: str, tensors) -> None:
    """Every kernel stages rows with 16-byte asynchronous copies (K1–K6):
    every base address and every batch / head / row stride (of a dim
    longer than 1) must be a multiple of 16 bytes. A view that breaks this
    raises here rather than launching."""
    for t in tensors:
        size = t.element_size()
        bad = [i for i in range(t.dim() - 1) if t.shape[i] > 1 and (t.stride(i) * size) % 16]
        if t.data_ptr() % 16 or (t.shape[-1] * size) % 16 or bad:
            raise ValueError(
                f"{name}: the kernel copies 16-byte rows; base, head dim and strides "
                f"{tuple(t.stride())} of a {t.dtype} operand must be multiples of 16 bytes"
            )


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels._build import load

        fn = load("flashd_fwd").flashd_fwd_launch
        P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 5 + [L] * 12 + [I] * 12 + [F, I, F, P]
        fn.restype = I
        _fn = fn
    return _fn


def flashd_fwd(
    q: torch.Tensor,  # [B, Hq, Sq, d]  — any strides with a contiguous head dim
    k: torch.Tensor,  # [B, Hkv, Skv, d]
    v: torch.Tensor,  # [B, Hkv, Skv, d]
    *,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
    block_k: Optional[int] = None,
    skip: bool = False,
    skip_theta: float = DEFAULT_SKIP_THETA,
):
    """Launch K1. Returns (o [B, Hq, Sq, d] in q.dtype, Λ [B, Hq, Sq] f32).

    `o` is a [B, Hq, Sq, d] view of a [B, Sq, Hq, d] (model layout) buffer,
    so `o.transpose(1, 2)` is contiguous. `block_k` (≤ 64, default 64,
    clamped to Skv like the reference) matters for skip: its threshold is
    θ + ln(block_k), so compare with `flashd_fwd_plain(block_k=...)`. It
    refuses inputs that need a gradient: `core.attention.flash_attention`
    is the differentiable entry, with K5 as its backward."""
    global launches
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    check_operands("flashd_fwd", (q, k, v), d)
    check_copy_alignment("flashd_fwd", (q, k, v))
    check_no_grad(q, k, v)
    if k.shape != (b, hkv, skv, d) or dv != d or hq % hkv:
        raise ValueError(f"flashd_fwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} (needs d == dv, Hq % Hkv == 0)")
    if mask.kind not in _MASK_KINDS:
        raise ValueError(f"unknown mask kind {mask.kind!r}")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    block_k = min(KERNEL_BLOCK_K if block_k is None else block_k, max(skv, 1))
    if not 1 <= block_k <= KERNEL_BLOCK_K:
        raise ValueError(f"flashd_fwd: block_k {block_k} outside [1, {KERNEL_BLOCK_K}]")

    o_model = torch.empty((b, sq, hq, dv), dtype=q.dtype, device=q.device)
    lam = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    o = o_model.transpose(1, 2)
    rc = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lam.data_ptr(),
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        o.stride(0), o.stride(1), o.stride(2),
        b, hq, hkv, sq, skv, d, int(q.dtype == torch.bfloat16),
        _MASK_KINDS[mask.kind], mask.window, mask.chunk, mask.q_offset, block_k,
        float(scale), int(skip), float(skip_theta + math.log(block_k)),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"flashd_fwd: CUDA error {rc} at launch")
    return o, lam
