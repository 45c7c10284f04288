"""Mixture-of-Experts FFN — the port of `repro/models/moe.py`: top-k routing
with a capacity per expert, tokens past it dropped (GShard semantics),
SwiGLU experts, and the reference's three aux values.

The reference groups tokens by data-parallel shard; with no sharding
context (one device) that is one group of all B·S tokens, which is what
the port computes. Its semantics, kept exactly:

  * router logits and probabilities in f32; the top k by a stable
    descending sort, so tied probabilities take the lowest expert index
    first (`jax.lax.top_k`'s order; `torch.topk` does not promise it);
    the top k weights renormalised over the k;
  * capacity `cap = int(t·k/E · capacity_factor) + 1`;
  * choice-major priority (every first choice before any second one), and
    within a choice the token order, by a stable sort over expert ids;
  * a kept (token, choice) goes to slot expert·cap + rank; a dropped one
    to a dump row past the buffer, so each kept slot is written once and
    the write is plain indexing (deterministic, no atomics);
  * combine: each choice's expert output × its weight × kept, summed in
    choice order from zero in the compute dtype.

Capacity makes a row's output depend on the other rows of its call: in
serving, every row of a step (dead slots and padding rows included) feeds
the router.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.layers import dense_init

__all__ = ["init_moe", "apply_moe", "AUX_KEYS"]

AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_dropped")


def init_moe(gen: torch.Generator, cfg) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    dt = cfg.master_dtype
    return {
        "router": dense_init(gen, (d, e), dtype=dt),
        "experts_wg": dense_init(gen, (e, d, f), dtype=dt),
        "experts_wu": dense_init(gen, (e, d, f), dtype=dt),
        "experts_wd": dense_init(gen, (e, f, d), dtype=dt),
    }


def capacity(t: int, cfg) -> int:
    """Slots per expert for a call of t tokens (the reference's rule)."""
    return int((t * cfg.n_experts_active / cfg.n_experts) * cfg.capacity_factor) + 1


def apply_moe(params: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, dict]:
    """x [B, S, D] → (y [B, S, D], aux dict of f32 scalars)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    t = b * s
    cdt = cfg.compute_dtype
    dev = x.device
    xt = x.reshape(t, d)

    logits = torch.matmul(xt.float(), params["router"].float())  # [t, E]
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt[:, :k], idx[:, :k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)

    cap = capacity(t, cfg)
    flat_e = top_e.transpose(0, 1).reshape(k * t)  # choice-major
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev))
    pos_sorted = torch.arange(k * t, device=dev) - starts[sorted_e]
    flat_pos = torch.empty_like(pos_sorted).scatter_(0, order, pos_sorted)
    keep = flat_pos < cap  # [k·t]
    slot = flat_e * cap + torch.where(keep, flat_pos, 0)
    dest = torch.where(keep, slot, e * cap)  # dropped → the dump row

    buf = torch.zeros((e * cap + 1, d), dtype=cdt, device=dev)
    xc = xt.to(cdt)
    for j in range(k):
        buf = buf.index_put((dest[j * t:(j + 1) * t],), xc)
    hb = buf[: e * cap].reshape(e, cap, d)
    g = torch.bmm(hb, params["experts_wg"].to(cdt))
    u = torch.bmm(hb, params["experts_wu"].to(cdt))
    out = torch.bmm(torch.nn.functional.silu(g) * u, params["experts_wd"].to(cdt))
    out = out.reshape(e * cap, d)

    y = torch.zeros((t, d), dtype=cdt, device=dev)
    for j in range(k):
        sl = slot[j * t:(j + 1) * t]
        wj = (top_p[:, j] * keep[j * t:(j + 1) * t]).to(cdt)
        y = y + out[sl] * wj[:, None]

    density = torch.nn.functional.one_hot(top_e[:, 0], e).float().mean(dim=0)
    density_proxy = probs.mean(dim=0)
    aux = {
        "moe_aux_loss": e * torch.sum(density * density_proxy) * cfg.aux_loss_weight,
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_loss,
        "moe_dropped": 1.0 - keep.float().mean(),
    }
    return y.reshape(b, s, d), aux
