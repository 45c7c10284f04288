"""O(S²) oracles — the port of `repro/kernels/ref.py`.

Full-matrix softmax, deliberately not the tiled recurrence. Fully masked
rows follow the dead-row convention of the kernels: O = 0, Λ = NEG_INF
(a logsumexp over all-sentinel scores is finite, −1e30 + ln S, so rows are
detected by magnitude, not by isfinite).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blockwise import NEG_INF, MaskSpec

__all__ = ["attention_ref", "decode_ref"]


def attention_ref(
    q: torch.Tensor,  # [B, Hq, Sq, d]
    k: torch.Tensor,  # [B, Hkv, Skv, d]
    v: torch.Tensor,  # [B, Hkv, Skv, dv]
    *,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
):
    """Full-matrix softmax attention with GQA. Returns (o, Λ)."""
    b, hq, sq, d = q.shape
    _, hkv, skv, dv = v.shape
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    qf = q.float().reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
    bias = mask.block_bias(torch.arange(sq, device=q.device), torch.arange(skv, device=q.device))
    if bias is not None:
        s = s + bias
    lam = torch.logsumexp(s, dim=-1)
    dead = lam <= NEG_INF / 2
    lam = torch.where(dead, NEG_INF, lam)
    p = torch.where(dead[..., None], 0.0, torch.exp(s - lam[..., None]))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, dv).to(q.dtype), lam.reshape(b, hq, sq)


def decode_ref(
    q: torch.Tensor,  # [B, Hq, d]
    k_cache: torch.Tensor,  # [B, Hkv, S, d]
    v_cache: torch.Tensor,  # [B, Hkv, S, dv]
    cache_len: torch.Tensor,  # [B]
    *,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
):
    b, hq, d = q.shape
    _, hkv, s_max, dv = v_cache.shape
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.float()) * scale
    pos = torch.arange(s_max, device=q.device)
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(b, 1)
    keep = pos[None, :] < cache_len
    if window > 0:
        keep &= pos[None, :] >= cache_len - window
    if chunk > 0:
        keep &= (torch.div(pos[None, :], chunk, rounding_mode="floor")
                 == torch.div(cache_len - 1, chunk, rounding_mode="floor"))
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    lam = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lam[..., None])
    # rows with no visible key (cache_len == 0) are zero, not uniform
    p = torch.where(keep[:, None, None, :], p, 0.0)
    o = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return o.reshape(b, hq, dv).to(q.dtype)
