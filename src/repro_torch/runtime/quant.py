"""Quantized KV page-pool format — the port of `repro/runtime/quant.py`.

Pages are stored in a one-byte format with a per-(page, kv head) f32 scale
side-band held as extra pool leaves (`k_scale` / `v_scale`, shaped
[n_pages, Hkv]) beside `k_pages` / `v_pages`. A page's scale is fixed by
its slot-0 row — amax over the head dim of the page's first K (resp. V)
row, divided by qmax / HEADROOM — and never revised, so a page's bytes and
scale are a function of its own (token, position) stream alone: the
precondition for the radix prefix cache to alias quantized pages, on both
write paths (the sequential `_paged_attn_step` and the packed
`_packed_attn`), since slot 0 of a page is always written at or before its
other slots.

The arithmetic is the reference's as its engine runs it (under jit), so
the same rows give the same bytes: x / scale, clip to ±qmax, round half to
even for integers, cast; and the slot-0 scale amax · (HEADROOM / qmax) —
XLA folds the reference's division by the constant qmax / HEADROOM into a
product with its f32 reciprocal, which its eager call does not (one ulp
apart on some scales). fp8 (e4m3) registers where torch has
`torch.float8_e4m3fn`, as the reference registers it where jax has
`jnp.float8_e4m3fn`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

__all__ = [
    "QuantSpec",
    "HEADROOM",
    "available",
    "get_spec",
    "spec_for_dtype",
    "kv_itemsize",
    "slot0_scale",
    "quantize_rows",
    "dequantize_pages",
]

# the slot-0 row maps to ±(qmax / HEADROOM); later rows get 2× margin
HEADROOM = 2.0
_EPS = 1e-8  # all-zero slot-0 rows still get a positive, finite scale


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """One storage format for the KV page pool."""

    name: str
    dtype: torch.dtype  # dtype of the stored pages
    qmax: float  # largest representable magnitude to clip against
    itemsize: int = 1  # bytes per stored element


_SPECS = {"int8": QuantSpec("int8", torch.int8, 127.0)}
if hasattr(torch, "float8_e4m3fn"):  # gated: older torch lacks fp8 dtypes
    _SPECS["fp8"] = QuantSpec("fp8", torch.float8_e4m3fn, 448.0)


def available() -> tuple:
    return tuple(sorted(_SPECS))


def get_spec(kv_dtype: str) -> Optional[QuantSpec]:
    """Spec for a ServeConfig.kv_dtype string; "" (native) → None."""
    if not kv_dtype:
        return None
    try:
        return _SPECS[kv_dtype]
    except KeyError:
        raise ValueError(
            f"unknown kv_dtype {kv_dtype!r}; available: {available()} "
            "(\"\" stores pages in the model compute dtype)"
        ) from None


def spec_for_dtype(dtype: torch.dtype) -> Optional[QuantSpec]:
    """Spec whose storage dtype is `dtype`, else None (native pool): the
    cache tree carries only tensors, so consumers that find scale leaves
    beside a pool recover the format from the pages' dtype."""
    for spec in _SPECS.values():
        if spec.dtype == dtype:
            return spec
    return None


def kv_itemsize(kv_dtype: str) -> int:
    """Stored bytes per K/V element (feeds the tuning heuristics)."""
    spec = get_spec(kv_dtype)
    return 4 if spec is None else spec.itemsize


@functools.lru_cache(maxsize=None)
def _inv_step(spec: QuantSpec) -> float:
    """HEADROOM / qmax rounded to f32, as a Python float (exact in f32, so
    the product below is the same on every device)."""
    return float(torch.tensor(HEADROOM / spec.qmax, dtype=torch.float32))


def slot0_scale(row: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """Per-head page scale from the page's slot-0 row: row [..., Hkv, d] →
    scale [..., Hkv] f32, a function of the row alone."""
    amax = torch.amax(torch.abs(row.float()), dim=-1)
    return torch.clamp(amax, min=_EPS) * _inv_step(spec)


def quantize_rows(rows: torch.Tensor, scales: torch.Tensor, spec: QuantSpec) -> torch.Tensor:
    """rows [..., Hkv, d] × scales [..., Hkv] → the stored dtype (saturating)."""
    x = rows.float() / scales[..., None]
    x = torch.clamp(x, -spec.qmax, spec.qmax)
    if not spec.dtype.is_floating_point:
        x = torch.round(x)  # half to even, as jnp.round
    return x.to(spec.dtype)


def dequantize_pages(pages: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """[P, page, Hkv, d] pages × [P, Hkv] scales → the f32 pool (x·scale,
    the kernels' in-tile order)."""
    return pages.float() * scales[:, None, :, None]
