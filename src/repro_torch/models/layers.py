"""Shared layers: init, norm, rotary embedding, embed, LM head — the port of
`repro/models/layers.py`, with its numerics kept exactly:

  * `rms_norm` computes in f32 and scales by (1 + weight);
  * RoPE rotates split halves (not interleaved pairs);
  * `embed_lookup` casts to the compute dtype;
  * `logits_from_hidden` multiplies in the compute dtype with f32 output
    (here: both operands upcast before the product, since a torch bf16
    matmul would round its output to bf16) and masks the padded vocab;
  * `conv1d_causal` sums its taps in order in the input dtype (full
    sequence) and contracts the window in f32 (decode).

Under a sharding context the activations are DTensors: the rope tables and
the padded-vocab mask are built as plain tensors and enter as replicated
DTensors (`sharding.replicate_like`), with the same values.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.distributed.sharding import is_dtensor, replicate_like, vocab_island

__all__ = ["dense_init", "rms_norm", "apply_rope", "embed_lookup", "logits_from_hidden",
           "conv1d_causal"]


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
    freqs = torch.pow(float(theta), exps)  # a scalar base: no host→device copy (graph capture)
    ang = positions[..., None].float() * freqs  # [..., half]
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding. x [B, S, H, hd]; positions [B, S] or [S]."""
    cos, sin = _rope_angles(positions, x.shape[-1], theta)
    if cos.ndim == 2:  # positions [S] → [1, S, 1, half]
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:  # positions [B, S] → [B, S, 1, half]
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    cos, sin = replicate_like(cos, x), replicate_like(sin, x)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Token embedding (LLaMA convention: no sqrt(d) scaling). Through
    `F.embedding`, whose backward sums a row's gradients in a fixed order;
    the backward of `table[ids]` accumulates in an order that varies from
    run to run on the CPU, which would break the bitwise-resume contract.
    A vocab-sharded DTensor table looks up each rank's rows
    (`sharding.vocab_island`)."""
    if is_dtensor(table) and any(p.is_shard(0) for p in table.placements):
        return vocab_island(_embed_rows, table, 0, ids).to(dtype)
    return torch.nn.functional.embedding(ids, table).to(dtype)


def _embed_rows(table, ids, first: int, rows: int):
    """The embedding of the ids in [first, first + rows) from the table's
    rows; zero elsewhere."""
    j = ids - first
    ok = (j >= 0) & (j < rows)
    out = torch.nn.functional.embedding(torch.where(ok, j, 0), table)
    return out * ok[..., None].to(out.dtype)


def logits_from_hidden(h: torch.Tensor, head: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """LM head on the padded vocab → f32 logits; padded slots are −1e30."""
    logits = torch.matmul(h.float(), head.to(h.dtype).float())
    v_pad = head.shape[-1]
    if v_pad > true_vocab:
        if is_dtensor(logits):  # a vocab-sharded DTensor: no slice assignment
            pad = torch.arange(v_pad, device=logits.device) >= true_vocab
            logits = torch.where(replicate_like(pad, logits), -1e30, logits)
        else:
            logits[..., true_vocab:] = -1e30
    return logits


def conv1d_causal(x: torch.Tensor, w: torch.Tensor, cache: Optional[torch.Tensor] = None):
    """Depthwise causal 1-D conv. x [B, S, C], w [K, C].

    Full sequence (cache None): left-padded with K − 1 zeros, → (y [B, S, C],
    None). Decode: `cache` [B, K − 1, C] holds the trailing inputs, x is one
    step [B, 1, C]; → (y [B, 1, C], the new window [B, K − 1, C])."""
    k = w.shape[0]
    if cache is None:
        xp = torch.nn.functional.pad(x, (0, 0, k - 1, 0))
        y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :] for i in range(k))
        return y.to(x.dtype), None
    window = torch.cat([cache, x], dim=1)  # [B, K, C]
    y = torch.einsum("bkc,kc->bc", window.float(), w.float())
    return y[:, None, :].to(x.dtype), window[:, 1:, :]
