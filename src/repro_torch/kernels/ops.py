"""Dispatch registry over the Hopper kernels — the port of
`repro/kernels/ops.py`.

Each entry point is registered under a stable op name (`attention_fwd`,
`decode`, `decode_paged`, `varlen`) and takes the MODEL layout ([B, S, H,
d] activations, [B, S_max, Hkv, d] caches, [P, page, Hkv, d] page pools);
the kernels read that layout through strides, so nothing here transposes
a copy. Every op also has a registered fallback with the
same signature — the plain PyTorch path (`get_fallback`), which the tests
and the `flashd_plain` impl use; `fallback_impl` maps a kernel impl name to
it ('flashd_gpu' → 'flashd').

The ops launch CUDA kernels and raise on CPU tensors: nothing here picks a
path by catching an error. `attention_bwd` (K5) registers with the
training slice (A11).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.core.blockwise import MaskSpec
from repro_torch.kernels.flashd_decode import flashd_decode, flashd_decode_paged
from repro_torch.kernels.flashd_fwd import flashd_fwd, flashd_fwd_plain
from repro_torch.kernels.flashd_varlen import flashd_varlen

__all__ = [
    "gpu_attention_fwd_batched",
    "gpu_decode",
    "gpu_decode_paged",
    "gpu_varlen",
    "register_op",
    "get_op",
    "op_names",
    "register_fallback",
    "get_fallback",
    "fallback_impl",
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


def on_gpu() -> bool:
    return torch.cuda.is_available()


@register_op("attention_fwd")
def gpu_attention_fwd_batched(
    q: torch.Tensor,  # [B, Sq, Hq, d]   (model layout)
    k: torch.Tensor,  # [B, Skv, Hkv, d]
    v: torch.Tensor,  # [B, Skv, Hkv, dv]
    *,
    mask: MaskSpec,
    scale: float,
    block_k: int | None = None,
    skip: bool = False,
):
    """K1 on model-layout operands → (o [B, Sq, Hq, dv], Λ [B, Hq, Sq])."""
    o, lam = flashd_fwd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        mask=mask, scale=scale, block_k=block_k, skip=skip,
    )
    return o.transpose(1, 2), lam


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
def plain_attention_fwd_batched(q, k, v, *, mask: MaskSpec, scale: float,
                                block_k: int | None = None, skip: bool = False):
    o, lam = flashd_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        mask=mask, scale=scale, block_k=block_k, skip=skip,
    )
    return o.transpose(1, 2), lam


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
