"""Mamba-2 (SSD, state-space duality) mixer — the port of
`repro/models/mamba2.py`, chunked matmul formulation.

The SSD recurrence  h_t = exp(a·dt_t)·h_{t−1} + dt_t·B_t x_tᵀ,
y_t = C_tᵀ h_t + D·x_t  is evaluated with the chunked algorithm of
arXiv:2405.21060 §6, in f32: the intra-chunk terms are a masked quadratic
form (matrix products), the state entering each chunk is carried by a
loop over the chunks (the reference's `lax.scan`). The reference wrote no
Pallas kernel for this layer; the port runs it in torch ops, as the
reference left it to XLA.

Decode is the O(1) update on the carried state [B, H, P, N], in place on
the cache (`decode_mamba2`), as `rglru.decode_rglru`: the captured serving
steps replay against the cache's addresses.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import conv1d_causal, dense_init, rms_norm

__all__ = ["init_mamba2", "apply_mamba2", "init_mamba2_cache", "decode_mamba2", "ssd_chunked"]


def init_mamba2(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dt, dev = cfg.master_dtype, gen.device
    # in_proj emits [z (di), x (di), B (n), C (n), dt (h)]
    return {
        "w_in": dense_init(gen, (d, 2 * di + 2 * n + h), dtype=dt),
        "conv_w": dense_init(gen, (cfg.conv_width, di + 2 * n), scale=0.1, dtype=dt),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)).to(dt),
        "D": torch.ones((h,), dtype=dt, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01, device=dev))).to(dt),  # softplus⁻¹
        "gate_norm": torch.zeros((di,), dtype=dt, device=dev),
        "w_out": dense_init(gen, (di, d), dtype=dt),
    }


def _split_in(proj: torch.Tensor, cfg):
    di, n, h = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return torch.split(proj, [di, di, n, n, h], dim=-1)  # z, x, B, C, dt


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum', the lower-triangular decay matrix:
    L[i, j] = sum_{j < m <= i} x[m]  (i ≥ j), −inf above the diagonal."""
    l = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, -torch.inf)


def ssd_chunked(x, dt, a_log, bmat, cmat, d_skip, chunk: int) -> torch.Tensor:
    """SSD forward. x [B, S, H, P], dt [B, S, H], bmat / cmat [B, S, N] → y
    [B, S, H, P] in x's dtype. S must be a multiple of `chunk` (a ragged S
    raises in the reshape, as the reference's does). One B / C group shared
    across heads (Mamba-2's default, G = 1)."""
    b, s, h, p = x.shape
    n = bmat.shape[-1]
    nc = s // chunk
    a = -torch.exp(a_log.float())  # [H], negative
    da = (dt * a[None, None, :]).float()  # [B, S, H]
    xdt = x * dt[..., None]

    # chunked views: c = chunk index, l = position within the chunk
    xr = xdt.reshape(b, nc, chunk, h, p)
    br = bmat.reshape(b, nc, chunk, n)
    cr = cmat.reshape(b, nc, chunk, n)
    dar = da.reshape(b, nc, chunk, h)

    # 1) intra-chunk (quadratic): y_intra[l] = Σ_{m≤l} C_l·B_m decay(l, m) xdt_m
    lmat = torch.exp(_segsum(dar.permute(0, 1, 3, 2)))  # [B, nc, H, L, L]
    cb = torch.einsum("bcln,bcmn->bclm", cr, br)  # [B, nc, L, L]
    y_intra = torch.einsum("bclm,bchlm,bcmhp->bclhp", cb, lmat, xr)

    # 2) chunk-final states: states[c] = Σ_m decay(end, m) B_m xdt_mᵀ
    cum = torch.cumsum(dar, dim=2)
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcln,bclh,bclhp->bchpn", br, decay_end, xr)

    # 3) inter-chunk recurrence over the nc chunks, the state carried in f32
    chunk_decay = torch.exp(torch.sum(dar, dim=2))  # [B, nc, H]
    h_prev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(h_prev)
        h_prev = h_prev * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prevs = torch.stack(entering, dim=1)  # [B, nc, H, P, N] state entering chunk c

    # 4) state → output within the chunk: y_inter[l] = C_l · (decay(l, 0⁻) h_prev)
    decay_in = torch.exp(cum)  # [B, nc, L, H]
    y_inter = torch.einsum("bcln,bclh,bchpn->bclhp", cr, decay_in, h_prevs)

    y = (y_intra + y_inter).reshape(b, s, h, p) + x * d_skip[None, None, :, None]
    return y.to(x.dtype)


def _conv_in(params: dict, x: torch.Tensor, cfg):
    """in_proj, then (z, the conv's input [x, B, C], dt)."""
    proj = torch.matmul(x, params["w_in"].to(cfg.compute_dtype))
    z, xin, bmat, cmat, dt = _split_in(proj, cfg)
    return z, torch.cat([xin, bmat, cmat], dim=-1), dt


def _gate_out(params: dict, y: torch.Tensor, z: torch.Tensor, cfg) -> torch.Tensor:
    cdt = cfg.compute_dtype
    y = rms_norm(y.to(cdt) * F.silu(z), params["gate_norm"], cfg.norm_eps)
    return torch.matmul(y, params["w_out"].to(cdt))


def apply_mamba2(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Full-sequence (training / prefill) Mamba-2 block. x [B, S, D] → [B, S, D].
    S is padded to a multiple of `ssm_chunk` for the SSD and cut back after."""
    b, s, _ = x.shape
    cdt = cfg.compute_dtype
    di, n = cfg.d_inner, cfg.ssm_state
    z, conv_in, dt = _conv_in(params, x, cfg)
    conv_out, _ = conv1d_causal(conv_in, params["conv_w"].to(cdt))
    xin, bmat, cmat = torch.split(F.silu(conv_out), [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())

    pad = (-s) % cfg.ssm_chunk
    if pad:
        xin, bmat, cmat, dt = (F.pad(t, (0, 0, 0, pad)) for t in (xin, bmat, cmat, dt))
    y = ssd_chunked(
        xin.reshape(b, s + pad, cfg.ssm_heads, cfg.ssm_head_dim).float(),
        dt,
        params["A_log"],
        bmat.float(),
        cmat.float(),
        params["D"].float(),
        cfg.ssm_chunk,
    )[:, :s]
    return _gate_out(params, y.reshape(b, s, di), z, cfg)


def init_mamba2_cache(batch: int, cfg, dtype=torch.float32, *, n: Optional[int] = None,
                      device=None) -> dict:
    """Zeroed decode state: ssm_state [B, H, P, N] f32 and conv_cache [B,
    K − 1, d_inner + 2N] in `dtype`, with a leading layer axis of `n` when
    given."""
    di, st = cfg.d_inner, cfg.ssm_state
    lead = () if n is None else (n,)
    return {
        "ssm_state": torch.zeros(lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim, st),
                                 dtype=torch.float32, device=device),
        "conv_cache": torch.zeros(lead + (batch, cfg.conv_width - 1, di + 2 * st), dtype=dtype,
                                  device=device),
    }


def decode_mamba2(params: dict, x: torch.Tensor, cache: dict, cfg) -> torch.Tensor:
    """One-token decode. x [B, 1, D] → y [B, 1, D]; the cache's ssm_state
    and conv_cache advance in place. O(1) a token."""
    b = x.shape[0]
    cdt = cfg.compute_dtype
    di, n = cfg.d_inner, cfg.ssm_state
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    z, conv_in, dt = _conv_in(params, x, cfg)
    conv_out, window = conv1d_causal(conv_in, params["conv_w"].to(cdt), cache["conv_cache"])
    xin, bmat, cmat = torch.split(F.silu(conv_out), [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"].float())[:, 0]  # [B, H]

    a = -torch.exp(params["A_log"].float())
    lam = torch.exp(dt * a[None, :])  # [B, H]
    xh = xin[:, 0].reshape(b, h, p).float()
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, xh, bmat[:, 0].float())
    state = cache["ssm_state"] * lam[..., None, None] + upd
    y = torch.einsum("bn,bhpn->bhp", cmat[:, 0].float(), state)
    y = y + xh * params["D"].float()[None, :, None]
    out = _gate_out(params, y.reshape(b, 1, di), z, cfg)
    cache["ssm_state"].copy_(state)
    cache["conv_cache"].copy_(window)
    return out
