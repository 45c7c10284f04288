"""Shared layers: init, norm, rotary embedding, embed, LM head — the port of
`repro/models/layers.py`, with its numerics kept exactly:

  * `rms_norm` computes in f32 and scales by (1 + weight);
  * RoPE rotates split halves (not interleaved pairs);
  * `embed_lookup` casts to the compute dtype;
  * `logits_from_hidden` multiplies in the compute dtype with f32 output
    (here: both operands upcast before the product, since a torch bf16
    matmul would round its output to bf16) and masks the padded vocab.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

__all__ = ["dense_init", "rms_norm", "apply_rope", "embed_lookup", "logits_from_hidden"]


def dense_init(generator: torch.Generator, shape, scale: Optional[float] = None,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Truncated-normal fan-in init (LLaMA-style 0.02 default cap) on the
    generator's device. Same distribution as the reference, not the same
    numbers: parity tests feed both packages the reference's weights."""
    fan_in = shape[0] if len(shape) > 1 else shape[-1]
    std = scale if scale is not None else min(0.02, 1.0 / math.sqrt(fan_in))
    x = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return (x * std).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm in f32 (statistics never in bf16), output in x.dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(x.dtype)


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float):
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32, device=positions.device), exps)
    ang = positions[..., None].float() * freqs  # [..., half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x [B, S, H, hd]; positions [B, S] or [S]."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    if cos.ndim == 2:  # positions [S] → [1, S, 1, half]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # positions [B, S] → [B, S, 1, half]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token embedding (LLaMA convention: no sqrt(d) scaling)."""
    return table[ids].to(dtype)


def logits_from_hidden(h: torch.Tensor, head: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """LM head on the padded vocab → f32 logits; padded slots are −1e30."""
    logits = torch.matmul(h.float(), head.to(h.dtype).float())
    v_pad = head.shape[-1]
    if v_pad > true_vocab:
        logits[..., true_vocab:] = -1e30
    return logits
