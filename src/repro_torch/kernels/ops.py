"""Dispatch registry over the Hopper kernels — the port of
`repro/kernels/ops.py`.

Each entry point is registered under a stable op name (`attention_fwd`,
`attention_bwd`, `decode`, `decode_paged`, `varlen`) and takes the MODEL layout ([B, S, H,
d] activations, [B, S_max, Hkv, d] caches, [P, page, Hkv, d] page pools);
the kernels read that layout through strides, so nothing here transposes
a copy. Every op also has a registered fallback with the
same signature — the plain PyTorch path (`get_fallback`), which the tests
and the `flashd_plain` impl use; `fallback_impl` maps a kernel impl name to
it ('flashd_gpu' → 'flashd'), `plain_impl` any kernel route to its plain
impl ('flashd', 'flashd_gpu' → 'flashd_plain'), the engine's downgrade.

The ops launch CUDA kernels and raise on CPU tensors: nothing here picks a
path by catching an error. `attention_fwd` runs K1 (impl 'flashd') or K6
(impl 'fa2'); `attention_bwd` runs K5, the one backward that serves both
forwards, since both save the same Λ.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.blockwise import MaskSpec
from repro_torch.kernels.fa2_fwd import fa2_fwd, fa2_fwd_plain
from repro_torch.kernels.flashd_bwd import flashd_bwd, flashd_bwd_plain
from repro_torch.kernels.flashd_decode import flashd_decode, flashd_decode_paged
from repro_torch.kernels.flashd_fwd import flashd_fwd, flashd_fwd_plain
from repro_torch.kernels.flashd_varlen import flashd_varlen

__all__ = [
    "gpu_attention_fwd_batched",
    "gpu_attention_bwd_batched",
    "gpu_decode",
    "gpu_decode_paged",
    "gpu_varlen",
    "register_op",
    "get_op",
    "op_names",
    "register_fallback",
    "get_fallback",
    "fallback_impl",
    "plain_impl",
    "on_gpu",
]

_REGISTRY: Dict[str, Callable] = {}
_FALLBACKS: Dict[str, Callable] = {}


def register_op(name: str) -> Callable[[Callable], Callable]:
    """Register a kernel dispatch entry point under `name` (decorator)."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY:
            raise ValueError(f"op {name!r} already registered")
        _REGISTRY[name] = fn
        return fn

    return deco


def get_op(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel op {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def op_names() -> tuple:
    return tuple(sorted(_REGISTRY))


def register_fallback(name: str) -> Callable[[Callable], Callable]:
    """Register the plain PyTorch fallback for op `name` (same signature)."""

    def deco(fn: Callable) -> Callable:
        if name in _FALLBACKS:
            raise ValueError(f"fallback for {name!r} already registered")
        _FALLBACKS[name] = fn
        return fn

    return deco


def get_fallback(name: str) -> Callable:
    if name not in _REGISTRY:
        raise KeyError(f"unknown kernel op {name!r}; registered: {sorted(_REGISTRY)}")
    if name not in _FALLBACKS:
        raise KeyError(f"op {name!r} has no registered plain fallback")
    return _FALLBACKS[name]


def fallback_impl(attn_impl: str) -> str:
    """The plain twin of a kernel impl name ('flashd_gpu' → 'flashd');
    other impls map to themselves."""
    suffix = "_gpu"
    return attn_impl[: -len(suffix)] if attn_impl.endswith(suffix) else attn_impl


def plain_impl(attn_impl: str) -> str:
    """The plain route of an impl name, the serving engine's downgrade
    target ('flashd', 'flashd_gpu' → 'flashd_plain'; 'fa2', 'fa2_gpu' →
    'fa2_plain'): unlike `fallback_impl`, it launches no kernel on a CUDA
    tensor. Other impls map to themselves."""
    family = attn_impl[: -len("_gpu")] if attn_impl.endswith("_gpu") else attn_impl
    return f"{family}_plain" if family in ("flashd", "fa2") else attn_impl


def on_gpu() -> bool:
    return torch.cuda.is_available()


def _bhsd(*xs):
    """Model-layout [B, S, H, d] operands as [B, H, S, d] views (no copy)."""
    return tuple(x.transpose(1, 2) for x in xs)


@register_op("attention_fwd")
def gpu_attention_fwd_batched(
    q: torch.Tensor,  # [B, Sq, Hq, d]   (model layout)
    k: torch.Tensor,  # [B, Skv, Hkv, d]
    v: torch.Tensor,  # [B, Skv, Hkv, dv]
    *,
    mask: MaskSpec,
    scale: float,
    impl: str = "flashd",
    block_q: int | None = None,
    block_k: int | None = None,
    skip: bool = False,
):
    """K1 (impl 'flashd') or K6 (impl 'fa2') on model-layout operands →
    (o [B, Sq, Hq, dv], Λ [B, Hq, Sq]). The kernels keep their own q tile
    (block_q steers only the plain fallback); K1 takes block_k ≤ 64."""
    if impl == "flashd":
        o, lam = flashd_fwd(*_bhsd(q, k, v), mask=mask, scale=scale, block_k=block_k, skip=skip)
    elif impl == "fa2":
        o, lam = fa2_fwd(*_bhsd(q, k, v), mask=mask, scale=scale)
    else:
        raise ValueError(f"unknown attention kernel impl {impl!r} (flashd, fa2)")
    return o.transpose(1, 2), lam


@register_op("attention_bwd")
def gpu_attention_bwd_batched(
    q: torch.Tensor,  # [B, Sq, Hq, d]   (model layout)
    k: torch.Tensor,  # [B, Skv, Hkv, d]
    v: torch.Tensor,  # [B, Skv, Hkv, dv]
    o: torch.Tensor,  # [B, Sq, Hq, dv]  saved forward output
    lam: torch.Tensor,  # [B, Hq, Sq] f32 saved Λ
    do: torch.Tensor,  # [B, Sq, Hq, dv]
    *,
    mask: MaskSpec,
    scale: float,
    block_q: int | None = None,
    block_k: int | None = None,
):
    """K5 from the saved (O, Λ) → (dq, dk, dv) in the model layout. One
    backward serves every forward that saves Λ; the kernel keeps its own
    tiles (block_q / block_k only steer the plain fallback)."""
    dq, dk, dv = flashd_bwd(*_bhsd(q, k, v, o), lam, do.transpose(1, 2), mask=mask, scale=scale)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


@register_op("decode")
def gpu_decode(
    q: torch.Tensor,  # [B, 1, Hq, d] or [B, Hq, d]
    k_cache: torch.Tensor,  # [B, S, Hkv, d]
    v_cache: torch.Tensor,  # [B, S, Hkv, dv]
    cache_len: torch.Tensor,  # [B], on the card
    *,
    scale=None,
    n_splits: int | None = None,
    window: int = 0,
    chunk: int = 0,
    fused: bool = True,
):
    """K2 on the model-layout cache → o [B, 1, Hq, dv]."""
    o = flashd_decode(
        q[:, 0] if q.ndim == 4 else q,
        k_cache.transpose(1, 2), v_cache.transpose(1, 2), cache_len,
        scale=scale, n_splits=n_splits, window=window, chunk=chunk, fused=fused,
    )
    return o[:, None]


@register_op("decode_paged")
def gpu_decode_paged(
    q: torch.Tensor,  # [B, 1, Hq, d] or [B, Hq, d]
    k_pages: torch.Tensor,  # [P, page, Hkv, d]
    v_pages: torch.Tensor,  # [P, page, Hkv, dv]
    block_tbl: torch.Tensor,  # [B, N] int32, on the card
    cache_len: torch.Tensor,  # [B], on the card
    *,
    scale=None,
    window: int = 0,
    chunk: int = 0,
    k_scale=None,
    v_scale=None,
):
    """K3 through the block table → o [B, 1, Hq, dv]."""
    o = flashd_decode_paged(
        q[:, 0] if q.ndim == 4 else q, k_pages, v_pages, block_tbl, cache_len,
        scale=scale, window=window, chunk=chunk, k_scale=k_scale, v_scale=v_scale,
    )
    return o[:, None]


@register_op("varlen")
def gpu_varlen(
    q: torch.Tensor,  # [T, Hq, d], T a multiple of block_q
    k_pages: torch.Tensor,  # [P, page, Hkv, d]
    v_pages: torch.Tensor,  # [P, page, Hkv, dv]
    block_tbl: torch.Tensor,  # [B, N] int32, on the card
    seq_ids: torch.Tensor,  # [T]
    q_pos: torch.Tensor,  # [T]
    kv_len: torch.Tensor,  # [B]
    *,
    scale=None,
    window: int = 0,
    chunk: int = 0,
    block_q: int,
    k_scale=None,
    v_scale=None,
):
    """K4 over the packed rows → o [T, Hq, dv]."""
    return flashd_varlen(
        q, k_pages, v_pages, block_tbl, seq_ids, q_pos, kv_len, scale=scale,
        window=window, chunk=chunk, block_q=block_q, k_scale=k_scale, v_scale=v_scale,
    )


@register_fallback("attention_fwd")
def plain_attention_fwd_batched(q, k, v, *, mask: MaskSpec, scale: float, impl: str = "flashd",
                                block_q: int | None = None, block_k: int | None = None,
                                skip: bool = False):
    if impl == "flashd":
        o, lam = flashd_fwd_plain(*_bhsd(q, k, v), mask=mask, scale=scale, block_q=block_q,
                                  block_k=block_k, skip=skip)
    elif impl == "fa2":
        o, lam = fa2_fwd_plain(*_bhsd(q, k, v), mask=mask, scale=scale, block_q=block_q,
                               block_k=block_k)
    else:
        raise ValueError(f"unknown attention kernel impl {impl!r} (flashd, fa2)")
    return o.transpose(1, 2), lam


@register_fallback("attention_bwd")
def plain_attention_bwd_batched(q, k, v, o, lam, do, *, mask: MaskSpec, scale: float,
                                block_q: int | None = None, block_k: int | None = None):
    """`blockwise_backward` over (B, Hkv, G), dK/dV summed over G — the
    reference's jnp fallback (`ops.py:318`) and K5's plain version."""
    if block_q is None or block_k is None:
        from repro_torch.kernels.tuning import choose_prefill_blocks

        tiling = choose_prefill_blocks(q.shape[1], k.shape[1], q.shape[-1], v.shape[-1])
        block_q = tiling.block_q if block_q is None else block_q
        block_k = tiling.block_k if block_k is None else block_k
    dq, dk, dv = flashd_bwd_plain(*_bhsd(q, k, v, o), lam, do.transpose(1, 2), mask=mask,
                                  scale=scale, block_q=block_q, block_k=block_k)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


@register_fallback("decode")
def plain_decode(q, k_cache, v_cache, cache_len, *, scale=None, n_splits=None,
                 window: int = 0, chunk: int = 0, fused: bool = True):
    from repro_torch.core.attention import decode_attention  # lazy: avoid cycle

    return decode_attention(
        q if q.ndim == 4 else q[:, None], k_cache, v_cache, cache_len,
        scale=scale, window=window, chunk=chunk, n_splits=n_splits,
    )


@register_fallback("decode_paged")
def plain_decode_paged(q, k_pages, v_pages, block_tbl, cache_len, *, scale=None,
                       window: int = 0, chunk: int = 0, k_scale=None, v_scale=None):
    from repro_torch.core.attention import decode_attention_paged  # lazy: avoid cycle

    return decode_attention_paged(
        q if q.ndim == 4 else q[:, None], k_pages, v_pages, block_tbl, cache_len,
        scale=scale, window=window, chunk=chunk, k_scale=k_scale, v_scale=v_scale,
    )


@register_fallback("varlen")
def plain_varlen(q, k_pages, v_pages, block_tbl, seq_ids, q_pos, kv_len, *, scale=None,
                 window: int = 0, chunk: int = 0, block_q: int, k_scale=None, v_scale=None):
    from repro_torch.core.attention import varlen_attention  # lazy: avoid cycle

    return varlen_attention(
        q, k_pages, v_pages, block_tbl, seq_ids, q_pos, kv_len, scale=scale,
        window=window, chunk=chunk, impl="flashd_plain", block_q=block_q,
        k_scale=k_scale, v_scale=v_scale,
    )
