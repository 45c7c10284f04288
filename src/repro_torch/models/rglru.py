"""Griffin / RecurrentGemma recurrent block — the port of
`repro/models/rglru.py`: RG-LRU + temporal conv + GLU.

Two branches from the residual: (a) linear → GeLU (the gate), (b) linear →
causal conv1d → RG-LRU; merged multiplicatively, then projected out.

RG-LRU per channel:  r_t = σ(W_a u_t)   i_t = σ(W_x u_t)
  a_t = exp(−c·softplus(Λ)·r_t)     (c = 8)
  h_t = a_t·h_{t−1} + sqrt(1 − a_t²)·(i_t ⊙ u_t)

The reference's GeLU is `jax.nn.gelu`, whose default is the tanh
approximation. The full-sequence recurrence is a log-depth scan in f32
(`_scan`, Hillis–Steele: ⌈log2 S⌉ passes of (a, b) ∘ (a', b') =
(a·a', a'·b + b')); the reference's `associative_scan` combines in
another tree order, so the two agree to f32 rounding, not bitwise (the
CPU tests hold the block's output to 1e-5). Decode is the O(1) update on
the carried state, in place on the cache (`decode_rglru`).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.layers import conv1d_causal, dense_init

__all__ = ["init_rglru", "apply_rglru", "init_rglru_cache", "decode_rglru"]

_C = 8.0  # Griffin's fixed recurrence sharpness


def init_rglru(gen: torch.Generator, cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width_
    dt = cfg.master_dtype
    # Λ so that a ∈ (0.9, 0.999) at r = 1 (the paper's init); softplus⁻¹
    u = torch.empty((w,), dtype=torch.float32, device=gen.device)
    u.uniform_(0.9 ** 2, 0.999 ** 2, generator=gen)
    lam = torch.log(torch.expm1(-torch.log(u) / (2.0 * _C)))
    return {
        "w_gate": dense_init(gen, (d, w), dtype=dt),
        "w_x": dense_init(gen, (d, w), dtype=dt),
        "conv_w": dense_init(gen, (cfg.conv_width, w), scale=0.1, dtype=dt),
        "wa_gate": dense_init(gen, (w, w), dtype=dt),
        "wi_gate": dense_init(gen, (w, w), dtype=dt),
        "lam": lam.to(dt),
        "w_out": dense_init(gen, (w, d), dtype=dt),
    }


def _gates(params, u: torch.Tensor):
    uf = u.float()
    r = torch.sigmoid(torch.matmul(uf, params["wa_gate"].float()))
    i = torch.sigmoid(torch.matmul(uf, params["wi_gate"].float()))
    log_a = -_C * torch.nn.functional.softplus(params["lam"].float()) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    return a, b


def _scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t−1} + b_t with h_{−1} = 0 along axis 1, log depth."""
    s = a.shape[1]
    off = 1
    while off < s:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], dim=1)
        off *= 2
    return b


def _branches(params, x, cfg):
    cdt = cfg.compute_dtype
    gate = torch.nn.functional.gelu(torch.matmul(x, params["w_gate"].to(cdt)), approximate="tanh")
    u = torch.matmul(x, params["w_x"].to(cdt))
    return gate, u


def apply_rglru(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence Griffin block. x [B, S, D] → [B, S, D]."""
    cdt = cfg.compute_dtype
    gate, u = _branches(params, x, cfg)
    u, _ = conv1d_causal(u, params["conv_w"].to(cdt))
    a, b = _gates(params, u)
    h = _scan(a, b)
    return torch.matmul(h.to(cdt) * gate, params["w_out"].to(cdt))


def init_rglru_cache(batch: int, cfg, dtype=torch.float32, *, n: Optional[int] = None,
                     device=None) -> dict:
    """Zeroed decode state: lru_state [B, W] f32 and conv_cache [B, K − 1, W]
    in `dtype`, with a leading layer axis of `n` when given."""
    w = cfg.lru_width_
    lead = () if n is None else (n,)
    return {
        "lru_state": torch.zeros(lead + (batch, w), dtype=torch.float32, device=device),
        "conv_cache": torch.zeros(lead + (batch, cfg.conv_width - 1, w), dtype=dtype,
                                  device=device),
    }


def decode_rglru(params: dict, x: torch.Tensor, cache: dict, cfg) -> torch.Tensor:
    """One-token decode. x [B, 1, D] → y [B, 1, D]; the cache's lru_state
    and conv_cache advance in place."""
    cdt = cfg.compute_dtype
    gate, u = _branches(params, x, cfg)
    u, window = conv1d_causal(u, params["conv_w"].to(cdt), cache["conv_cache"])
    a, b = _gates(params, u[:, 0])
    h = a * cache["lru_state"] + b
    y = torch.matmul(h[:, None, :].to(cdt) * gate, params["w_out"].to(cdt))
    cache["lru_state"].copy_(h)
    cache["conv_cache"].copy_(window)
    return y
