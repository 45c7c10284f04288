"""Mixture-of-Experts FFN — the port of `repro/models/moe.py`: top-k routing
with a capacity per expert, tokens past it dropped (GShard semantics),
SwiGLU experts, and the reference's three aux values.

The reference groups tokens by data-parallel shard (`_n_groups`): with no
sharding context that is one group of all B·S tokens; under one, each
group routes and dispatches on its own, with its own capacity. Its
semantics, kept exactly:

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

from repro_torch.distributed import sharding as shd
from repro_torch.distributed.sharding import P, active_ctx, is_dtensor, shard, spec_for
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


def _n_groups(t: int) -> int:
    """Token groups: one per data-parallel shard under a sharding context
    (the reference's `_n_groups`), one with none."""
    ctx = active_ctx()
    want = 1
    if ctx is not None:
        want = ctx.axis_size(ctx.batch_axes)
    while want > 1 and t % want:
        want //= 2
    return max(want, 1)


def _route(xt, router, cfg, cap: int):
    """Group-local routing and dispatch of xt [G, t, D] → (hb [G, E, cap, D]
    the capacity buffers in the compute dtype, top_p [G, t, k], keep and
    slot [G, k·t], probs and logits [G, t, E] f32, first [G, t, E] the
    one-hot of each token's first choice)."""
    g, t, d = xt.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    dev = xt.device
    logits = torch.matmul(xt.float(), router.float())  # [G, t, E]
    probs = torch.softmax(logits, dim=-1)
    srt, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = srt[..., :k], idx[..., :k]
    top_p = top_p / torch.clamp(top_p.sum(dim=-1, keepdim=True), min=1e-9)

    flat_e = top_e.transpose(1, 2).reshape(g, k * t)  # choice-major
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = torch.gather(flat_e, 1, order)
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=dev).expand(g, e).contiguous())
    pos_sorted = torch.arange(k * t, device=dev) - torch.gather(starts, 1, sorted_e)
    flat_pos = torch.empty_like(pos_sorted).scatter_(1, order, pos_sorted)
    keep = flat_pos < cap  # [G, k·t]
    slot = flat_e * cap + torch.where(keep, flat_pos, 0)
    dest = torch.where(keep, slot, e * cap)  # dropped → the dump row

    buf = torch.zeros((g, e * cap + 1, d), dtype=cfg.compute_dtype, device=dev)
    xc = xt.to(cfg.compute_dtype)
    rows = torch.arange(g, device=dev)[:, None]
    for j in range(k):
        buf = buf.index_put((rows, dest[:, j * t:(j + 1) * t]), xc)
    hb = buf[:, : e * cap].reshape(g, e, cap, d)
    first = torch.nn.functional.one_hot(top_e[..., 0], e).float()
    return hb, top_p, keep, slot, probs, logits, first


def _experts(hb, wg, wu, wd):
    """SwiGLU of each expert over its rows of every group: hb [G, E, C, D]
    and weights [E, ·, ·] (a rank's local experts) → [G, E, C, D]."""
    g, e, c, d = hb.shape
    x = hb.transpose(0, 1).reshape(e, g * c, d)
    out = torch.bmm(torch.nn.functional.silu(torch.bmm(x, wg)) * torch.bmm(x, wu), wd)
    return out.reshape(e, g, c, d).transpose(0, 1)


def _combine(out, slot, top_p, keep):
    """Each choice's expert output × its weight × kept, summed in choice
    order from zero: out [G, E, C, D] → y [G, t, D]."""
    g, e, c, d = out.shape
    k, t = top_p.shape[-1], top_p.shape[1]
    out = out.reshape(g, e * c, d)
    y = torch.zeros((g, t, d), dtype=out.dtype, device=out.device)
    for j in range(k):
        sl = slot[:, j * t:(j + 1) * t]
        wj = (top_p[..., j] * keep[:, j * t:(j + 1) * t]).to(out.dtype)
        y = y + torch.gather(out, 1, sl[..., None].expand(g, t, d)) * wj[..., None]
    return y


def _grad_placements(w_pl, act_pl):
    """A replicated weight's gradient placements inside an island whose
    activations are split over some mesh dims: partial sums on those dims
    (each rank saw only its groups), the weight's own placement elsewhere."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if a.is_shard() and w.is_replicate() else w
                 for w, a in zip(w_pl, act_pl))


def apply_moe(params: dict, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, dict]:
    """x [B, S, D] → (y [B, S, D], aux dict of f32 scalars).

    Under a sharding context x is a DTensor: the tokens form one group per
    data-parallel shard (`moe_groups`), routing and dispatch run group-local
    in a `local_map` island, the capacity buffers go to `moe_dispatch`
    (experts over 'model' when E divides it), the expert SwiGLU runs as an
    island over each rank's local experts, and the outputs are gathered
    back to the groups for the combine."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    g = _n_groups(b * s)
    t = b * s // g
    cap = capacity(t, cfg)
    cdt = cfg.compute_dtype
    wg, wu, wd = (params[n].to(cdt) for n in ("experts_wg", "experts_wu", "experts_wd"))
    if not is_dtensor(x):
        hb, top_p, keep, slot, probs, logits, first = _route(
            x.reshape(g, t, d), params["router"], cfg, cap)
        y = _combine(_experts(hb, wg, wu, wd), slot, top_p, keep)
    else:
        from torch.distributed.tensor.experimental import local_map

        mesh = x.device_mesh
        xt = shard(shard(x, "hidden").reshape(g, t, d), "moe_groups")
        gp = tuple(xt.placements)
        rep = shd.placements(P(None, None), mesh)
        router = params["router"]
        hb, top_p, keep, slot, probs, logits, first = local_map(
            lambda xt_, r_: _route(xt_, r_, cfg, cap), out_placements=(gp,) * 7,
            in_placements=(gp, rep), in_grad_placements=(gp, _grad_placements(rep, gp)),
            device_mesh=mesh, redistribute_inputs=True)(xt, router)
        hb = shard(hb, "moe_dispatch")
        hp = tuple(hb.placements)
        # experts over 'model' where E divides it (the reference's _expert_shard)
        wpl = shd.placements(P("model" if e % shd.active_ctx().axis_size("model") == 0
                               else None, None, None), mesh)
        out = local_map(_experts, out_placements=(hp,), in_placements=(hp, wpl, wpl, wpl),
                        in_grad_placements=(hp,) + (_grad_placements(wpl, hp),) * 3,
                        device_mesh=mesh, redistribute_inputs=True)(hb, wg, wu, wd)
        out = shard(out, "moe_dispatch")
        op = shd.placements(P(*spec_for("moe_groups", (g, t, d)), None), mesh)
        y = local_map(_combine, out_placements=(gp,), in_placements=(op, gp, gp, gp),
                      device_mesh=mesh, redistribute_inputs=True)(out, slot, top_p, keep)

    aux = {
        "moe_aux_loss": e * torch.sum(first.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
        * cfg.aux_loss_weight,
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2) * cfg.router_z_loss,
        "moe_dropped": 1.0 - keep.float().mean(),
    }
    return y.reshape(b, s, d), aux
