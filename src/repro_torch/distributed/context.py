"""Context-parallel attention — the port of `repro/distributed/context.py`:
FLASH-D's sigmoid merge across the ranks of a `torch.distributed` group.

Long-context prefill and decode on a sequence-sharded KV cache, built from
two primitives (DESIGN.md §4.1):

`ring_prefill` — a `local_map` island over Q/K/V sharded by sequence
  (`Shard(1)` on the CP axis, and the cache's batch axes). Each rank keeps
  its q shard and its (O, Λ) carry; the KV shards rotate one neighbour a
  hop (`batch_isend_irecv`: send to rank r+1, receive from rank r−1, both
  posted before the hop's kernel so the wire overlaps it). At hop h a
  rank's KV shard sits h shards behind its q shard, so the hop's mask
  offset is h·shard and structured masks prune hops (`choose_ring_schedule`).
  A rank holding a wrapped (future) shard under a causal-family mask
  launches nothing for that hop, but still posts its send and receive.
  Each hop's (O, Λ) is folded into the carry with `merge_pair`; no running
  max crosses the wire, only one KV shard a hop. Forward only, as the
  reference's: inputs that need a gradient raise.

`cp_decode` — each rank clips the global live region [lo, cache_len) to
  its shard (`start` / `hi`, with `_lo_bound` for window and chunk) and
  computes its partial (o_p, λ_p): K2 with `return_lam` (`use_kernel`),
  else the plain `_shard_partial`. A log₂ n XOR butterfly of (O, Λ)-sized
  messages merges the partials; a non-power-of-two axis takes one
  `all_gather` of the partials and `merge_partials`. Every rank merges the
  lower block's partial first (`merge_pair` is commutative in exact
  arithmetic, not in f32), so the replicated output is bitwise equal on
  every rank and greedy tokens cannot part between ranks.

`ring_hop` and `decode_partial` are what one rank computes at one hop or
for its shard; `butterfly_merge` is the order a rank merges in. The ranks
call them, and a one-card run can emulate the ranks with them.

Inputs are DTensors on the mesh, or plain tensors taken as the whole
operand on every rank (then the result comes back whole). Each process
counts what it puts on the wire (`sends`, `sent_bytes`, `send_shapes`,
`gathers`; `reset_wire`), plain counters like the kernels' `launches`.
`repro_torch.core.attention` and `models.transformer` route here through
`maybe_ring_prefill` / `maybe_cp_decode` when the active `ShardingCtx`
sequence-shards the cache (`sharding.cp_axis_for_cache`).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.core.blockwise import NEG_INF, MaskSpec, merge_pair, merge_partials
from repro_torch.distributed.sharding import (
    P,
    active_ctx,
    cp_axis_for_cache,
    cp_batch_axes_for_cache,
    is_dtensor,
    placements,
)

__all__ = [
    "ring_prefill",
    "cp_decode",
    "maybe_ring_prefill",
    "maybe_cp_decode",
    "ring_applicable",
    "cp_decode_applicable",
    "ring_hop",
    "decode_partial",
    "butterfly_merge",
    "reset_wire",
]

_CAUSAL_FAMILY = ("causal", "local", "chunked")

# what this process put on the wire: point-to-point sends, their bytes and
# shapes, and all_gather calls
sends = 0
sent_bytes = 0
send_shapes: collections.Counter = collections.Counter()
gathers = 0


def reset_wire() -> None:
    global sends, sent_bytes, gathers
    sends = sent_bytes = gathers = 0
    send_shapes.clear()


def _resolve_mesh(mesh):
    if mesh is not None:
        return mesh
    ctx = active_ctx()
    if ctx is None or ctx.mesh is None:
        raise ValueError("context-parallel attention needs a mesh (argument or active "
                         "ShardingCtx)")
    return ctx.mesh


def _axis_size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def ring_applicable(q_shape, k_shape, mask: MaskSpec, n_shards: int) -> bool:
    """Can ring_prefill handle these operands? (Static check — used by
    `core.attention.flash_attention` before routing.)"""
    sq, skv = q_shape[1], k_shape[1]
    if n_shards <= 1 or sq % n_shards or skv % n_shards:
        return False
    if mask.kind in _CAUSAL_FAMILY:
        # shard-offset algebra needs aligned q/kv shards (self-attention)
        if sq != skv:
            return False
        if mask.kind == "chunked" and (skv // n_shards) % max(mask.chunk, 1):
            return False  # hop offsets shift chunk boundaries
    return True


def cp_decode_applicable(cache_shape, n_shards: int) -> bool:
    return n_shards > 1 and cache_shape[1] % n_shards == 0


def _post(ops, group):
    """Post ("send" | "recv", tensor, group rank) operations as one batch →
    the requests. Every rank of a hop posts its sends and receives together,
    so no pair waits on the other's order."""
    import torch.distributed as dist

    global sends, sent_bytes
    p2p = []
    for kind, t, peer in ops:
        if kind == "send":
            sends += 1
            sent_bytes += t.numel() * t.element_size()
            send_shapes[tuple(t.shape)] += 1
        p2p.append(dist.P2POp(dist.isend if kind == "send" else dist.irecv, t,
                              dist.get_global_rank(group, peer), group))
    return dist.batch_isend_irecv(p2p)


def _on_mesh(x, mesh, pl):
    """x as a DTensor with placements `pl`: a plain tensor is the whole
    operand on every rank, sliced here with no communication."""
    from torch.distributed.tensor import distribute_tensor

    return x if is_dtensor(x) else distribute_tensor(x, mesh, pl, src_data_rank=None)


# ---------------------------------------------------------------------------
# per-shard forward (one ring hop's local attention)
# ---------------------------------------------------------------------------

def _shard_fwd(q, k, v, *, mask, scale, impl, block_q, block_k, skip):
    """Kernel-layout forward on one KV shard → (o [B,Hq,S,dv] f32, Λ f32).

    impl 'flashd_gpu' launches K1 and 'fa2_gpu' K6 (a CPU tensor raises);
    'flashd' / 'fa2' launch them on a CUDA tensor and take the plain
    version on a CPU tensor; 'flashd_plain' / 'fa2_plain' are the plain
    versions anywhere; 'naive' the O(S²) oracle."""
    from repro_torch.kernels import fa2_fwd, flashd_fwd  # lazy: no cycle

    if impl == "naive":
        from repro_torch.kernels.ref import attention_ref  # lazy: no cycle

        o, lam = attention_ref(q, k, v, mask=mask, scale=scale)
        return o.float(), lam
    family, _, route = impl.partition("_")
    if family not in ("flashd", "fa2") or route not in ("", "gpu", "plain"):
        raise ValueError(f"ring prefill: unknown impl {impl!r}")
    if route == "gpu" or (route == "" and q.is_cuda):
        if family == "flashd":
            o, lam = flashd_fwd.flashd_fwd(q, k, v, mask=mask, scale=scale,
                                           block_k=block_k if skip else None, skip=skip)
        else:
            o, lam = fa2_fwd.fa2_fwd(q, k, v, mask=mask, scale=scale)
    elif family == "flashd":
        o, lam = flashd_fwd.flashd_fwd_plain(q, k, v, mask=mask, scale=scale, block_q=block_q,
                                             block_k=block_k, skip=skip)
    else:
        o, lam = fa2_fwd.fa2_fwd_plain(q, k, v, mask=mask, scale=scale, block_q=block_q,
                                       block_k=block_k)
    return o.float(), lam


def ring_hop(q, k, v, *, idx: int, h: int, mask: MaskSpec, scale: float, impl: str,
             block_q: int, block_k: int, skip: bool = False):
    """What rank `idx` of the ring computes at hop h, in kernel layout (q
    [B, Hq, S_sh, d], the KV shard it holds [B, Hkv, S_sh, ·], which came
    from rank idx − h): (o f32, Λ) of its q shard against that shard, or
    None where the shard is wrapped (idx < h) and strictly future under a
    causal-family mask — then no kernel is launched."""
    if mask.kind in _CAUSAL_FAMILY and idx < h:
        return None
    sq_sh, skv_sh = q.shape[2], k.shape[2]
    hop_mask = dataclasses.replace(
        mask,
        kind="full" if _hop_fully_visible(mask, h, sq_sh, skv_sh) else mask.kind,
        q_offset=mask.q_offset + h * skv_sh,
    )
    return _shard_fwd(q, k, v, mask=hop_mask, scale=scale, impl=impl, block_q=block_q,
                      block_k=block_k, skip=skip)


# ---------------------------------------------------------------------------
# ring prefill
# ---------------------------------------------------------------------------

def ring_prefill(
    q: torch.Tensor,  # [B, Sq, Hq, d]   (model layout, like flash_attention)
    k: torch.Tensor,  # [B, Skv, Hkv, d]
    v: torch.Tensor,  # [B, Skv, Hkv, dv]
    *,
    axis: str,
    mesh=None,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
    impl: str = "flashd",
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    skip: bool = False,
    batch_axes: Optional[Tuple[str, ...]] = None,
) -> torch.Tensor:
    """Context-parallel prefill: per-shard kernels + the cross-rank Λ-merge.

    Returns o [B, Sq, Hq, dv] in q's dtype, sequence-sharded over `axis`
    like q (and batch-sharded over `batch_axes` when given) — whole when q
    was a plain tensor. Wire per hop: one K and one V shard; the (O, Λ)
    carry never moves. Forward only: inputs that need a gradient raise."""
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.kernels.tuning import choose_ring_schedule  # lazy: no cycle

    mesh = _resolve_mesh(mesh)
    n = _axis_size(mesh, axis)
    if not ring_applicable(q.shape, k.shape, mask, n):
        raise ValueError(f"ring_prefill: {tuple(q.shape)}/{tuple(k.shape)} with {mask.kind!r} "
                         f"mask not context-parallelizable over {n} shards")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("ring_prefill is forward only (the ring has no backward, as in the "
                           "reference): run it under torch.no_grad() or inference_mode()")
    if scale is None:
        scale = float(1.0 / (q.shape[-1] ** 0.5))
    sq_sh, skv_sh = q.shape[1] // n, k.shape[1] // n
    sched = choose_ring_schedule(sq_sh, skv_sh, q.shape[-1], v.shape[-1], n_devices=n, mask=mask)
    block_q = min(sched.block_q if block_q is None else block_q, sq_sh)
    block_k = min(sched.block_k if block_k is None else block_k, skv_sh)
    group, idx = mesh.get_group(axis), mesh.get_local_rank(axis)
    hop = dict(mask=mask, scale=scale, impl=impl, block_q=block_q, block_k=block_k, skip=skip)

    def local(q_l, k_l, v_l):
        qk = q_l.transpose(1, 2)  # kernel layout, as views
        kv = (k_l.contiguous(), v_l.contiguous())  # what goes on the wire
        o = lam = None
        for h in range(sched.n_hops):
            nxt, reqs = None, []
            if h < sched.n_hops - 1:  # rotate the KV shard one neighbour over
                nxt = tuple(torch.empty_like(t) for t in kv)
                reqs = _post([("send", kv[0], (idx + 1) % n), ("send", kv[1], (idx + 1) % n),
                              ("recv", nxt[0], (idx - 1) % n), ("recv", nxt[1], (idx - 1) % n)],
                             group)
            part = ring_hop(qk, kv[0].transpose(1, 2), kv[1].transpose(1, 2), idx=idx, h=h,
                            **hop)
            if part is not None:  # hop 0 is live on every rank
                o, lam = part if o is None else merge_pair((o, lam), part)
            for r in reqs:
                r.wait()
            if nxt is not None:
                kv = nxt
        return o.transpose(1, 2).to(q_l.dtype)

    pl = placements(P(batch_axes, axis, None, None), mesh)
    whole = not is_dtensor(q)
    q, k, v = (_on_mesh(x, mesh, pl) for x in (q, k, v))
    o = local_map(local, out_placements=(pl,), in_placements=(pl, pl, pl), device_mesh=mesh,
                  redistribute_inputs=True)(q, k, v)
    return o.full_tensor() if whole else o


def _hop_fully_visible(mask: MaskSpec, h: int, sq_sh: int, skv_sh: int) -> bool:
    """Static: is hop h's whole shard-vs-shard block inside the mask (for
    non-wrapped devices)? Then the kernel runs mask-free ('full')."""
    if h == 0 or mask.kind not in _CAUSAL_FAMILY:
        return False
    hop = dataclasses.replace(mask, q_offset=mask.q_offset + h * skv_sh)
    return hop.block_fully_visible(0, sq_sh, 0, skv_sh)


# ---------------------------------------------------------------------------
# context-parallel decode
# ---------------------------------------------------------------------------

def maybe_cp_decode(q, k_cache, v_cache, cache_len, *, scale=None, window=0,
                    chunk=0, n_splits=None, use_kernel=True):
    """The one selection point for context-parallel decode: returns
    `cp_decode(...)` iff the active ShardingCtx's kv_cache rule seq-shards
    this cache (`sharding.cp_axis_for_cache`), else None — callers fall
    through to their single-device path. The cache's batch sharding (if
    any) is kept inside the island."""
    ctx = active_ctx()
    if ctx is None:
        return None
    axis = cp_axis_for_cache(k_cache.shape)
    if axis is None:
        return None
    return cp_decode(
        q, k_cache, v_cache, cache_len, axis=axis, mesh=ctx.mesh, scale=scale,
        window=window, chunk=chunk, n_splits=n_splits, use_kernel=use_kernel,
        batch_axes=cp_batch_axes_for_cache(k_cache.shape),
    )


def maybe_ring_prefill(q, k, v, *, mask, scale=None, impl="flashd",
                       block_q=None, block_k=None, skip=False):
    """Selection point for context-parallel prefill, the `maybe_cp_decode`
    counterpart: returns `ring_prefill(...)` iff the active ShardingCtx
    opts in (`cp_prefill=True`), its kv_cache rule seq-shards these
    operands, and the ring schedule applies (divisible shards, aligned
    causal-family masks) — else None."""
    ctx = active_ctx()
    if ctx is None or not getattr(ctx, "cp_prefill", False):
        return None
    axis = cp_axis_for_cache(k.shape)
    if axis is None or not ring_applicable(q.shape, k.shape, mask, ctx.axis_size(axis)):
        return None
    return ring_prefill(
        q, k, v, axis=axis, mesh=ctx.mesh, mask=mask, scale=scale, impl=impl,
        block_q=block_q, block_k=block_k, skip=skip,
        batch_axes=cp_batch_axes_for_cache(k.shape),
    )


def _shard_partial(q, k_sh, v_sh, hi, start, scale):
    """Plain per-shard decode partial (o_p [B,Hq,dv] f32, λ_p [B,Hq]) — the
    reference's `_jnp_shard_partial`, the kernel-free analogue of K2's
    split partial. k_sh / v_sh [B, S_sh, Hkv, ·]; keys in [start, hi)."""
    b, hq, d = q.shape
    s_sh, hkv = k_sh.shape[1], k_sh.shape[2]
    g = hq // hkv
    qf = q.float().reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bshd->bhgs", qf, k_sh.float()) * scale
    pos = torch.arange(s_sh, device=q.device)
    keep = (pos[None, :] >= start[:, None]) & (pos[None, :] < hi[:, None])
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.clamp(m, min=NEG_INF / 2)
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    lam = torch.where(l > 0, m_safe + torch.log(torch.clamp(l, min=torch.finfo(torch.float32).tiny)),
                      NEG_INF)
    o = torch.einsum("bhgs,bshd->bhgd", p, v_sh.float())
    o = o * torch.where(l > 0, torch.exp(m_safe - lam), 0.0)[..., None]
    return o.reshape(b, hq, -1), lam.reshape(b, hq)


def decode_partial(q, k_sh, v_sh, cache_len, *, idx: int, scale: float, window: int = 0,
                   chunk: int = 0, n_splits: Optional[int] = None, use_kernel: bool = True,
                   fused: bool = True):
    """Rank idx's decode partial on its cache shard: q [B, Hq, d], k_sh /
    v_sh [B, S_sh, Hkv, ·] (positions idx·S_sh …), cache_len [B] the GLOBAL
    valid length → (o_p [B, Hq, dv] f32, λ_p [B, Hq]). The global live
    region [lo, cache_len) is clipped to the shard; an empty clip gives the
    dead partial (Λ = NEG_INF), a merge identity. `use_kernel`: K2 with
    `start` and `return_lam` (its plain version on a CPU tensor)."""
    from repro_torch.kernels import flashd_decode as k2  # lazy: no cycle

    s_sh = k_sh.shape[1]
    shard_lo = idx * s_sh
    cl = cache_len.long()
    lo = k2._lo_bound(cl, torch.zeros_like(cl), window=window, chunk=chunk)
    start = torch.clamp(lo - shard_lo, 0, s_sh)
    hi = torch.clamp(cl - shard_lo, 0, s_sh)
    if not use_kernel:
        return _shard_partial(q, k_sh, v_sh, hi, start, scale)
    fn = k2.flashd_decode if q.is_cuda else k2.flashd_decode_plain
    o, lam = fn(q, k_sh.transpose(1, 2), v_sh.transpose(1, 2), hi, start=start, scale=scale,
                n_splits=n_splits, fused=fused, return_lam=True)
    return o.float(), lam


def butterfly_merge(mine, theirs, idx: int, step: int):
    """One butterfly round's merge on rank idx with partner idx ^ step: the
    lower block's partial first, so both partners compute the same bits."""
    return merge_pair(theirs, mine) if idx & step else merge_pair(mine, theirs)


def _merge_across(o, lam, idx: int, n: int, group):
    """All-reduce rank partials with the FLASH-D blend: log₂ n XOR rounds of
    (O, Λ) messages, or one all_gather and the tree merge when n is not a
    power of two. Every rank ends with the same bits."""
    global gathers
    if n & (n - 1) == 0:
        step = 1
        while step < n:
            peer = idx ^ step
            o_r, lam_r = torch.empty_like(o), torch.empty_like(lam)
            for r in _post([("send", o, peer), ("send", lam, peer),
                            ("recv", o_r, peer), ("recv", lam_r, peer)], group):
                r.wait()
            o, lam = butterfly_merge((o, lam), (o_r, lam_r), idx, step)
            step *= 2
        return o, lam
    import torch.distributed as dist

    gathers += 1
    o_all = [torch.empty_like(o) for _ in range(n)]
    lam_all = [torch.empty_like(lam) for _ in range(n)]
    dist.all_gather(o_all, o, group=group)
    dist.all_gather(lam_all, lam, group=group)
    return merge_partials(torch.stack(o_all), torch.stack(lam_all))


def cp_decode(
    q: torch.Tensor,  # [B, 1, Hq, d] or [B, Hq, d]
    k_cache: torch.Tensor,  # [B, S, Hkv, d]  — sequence-sharded over `axis`
    v_cache: torch.Tensor,  # [B, S, Hkv, dv]
    cache_len,  # [B] or scalar — GLOBAL valid length
    *,
    axis: str,
    mesh=None,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
    n_splits: Optional[int] = None,
    use_kernel: bool = True,
    fused: bool = True,
    batch_axes: Optional[Tuple[str, ...]] = None,
) -> torch.Tensor:
    """Single-token decode against a seq-sharded cache; rank partials merged
    by the cross-rank butterfly of the FLASH-D blend. Returns o shaped like
    q, replicated over `axis` (batch-sharded over `batch_axes`); whole when
    the cache was a plain tensor.

    Each shard clips the global live region [lo, cache_len) (window / chunk
    raise lo) to its own range; shard-empty shards give dead partials that
    merge as identities, so ragged `cache_len` needs no special case.
    `batch_axes` carries the cache's batch sharding through the island: the
    butterfly reduces over `axis` only."""
    from torch.distributed.tensor.experimental import local_map

    squeezed = q.ndim == 3
    if not squeezed:
        q = q[:, 0]
    b, hq, d = q.shape
    s_max = k_cache.shape[1]
    mesh = _resolve_mesh(mesh)
    n = _axis_size(mesh, axis)
    if not cp_decode_applicable(k_cache.shape, n):
        raise ValueError(f"cp_decode: cache seq {s_max} not shardable over {n}")
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    if not is_dtensor(cache_len):
        cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(b)
    group, idx = mesh.get_group(axis), mesh.get_local_rank(axis)

    def local(q_l, k_l, v_l, cl_l):
        o_p, lam_p = decode_partial(q_l, k_l, v_l, cl_l, idx=idx, scale=scale, window=window,
                                    chunk=chunk, n_splits=n_splits, use_kernel=use_kernel,
                                    fused=fused)
        return _merge_across(o_p, lam_p, idx, n, group)[0].to(q_l.dtype)

    q_pl, kv_pl, cl_pl = (placements(spec, mesh) for spec in (
        P(batch_axes, None, None), P(batch_axes, axis, None, None), P(batch_axes)))
    whole = not is_dtensor(k_cache)
    args = [_on_mesh(x, mesh, pl) for x, pl in ((q, q_pl), (k_cache, kv_pl), (v_cache, kv_pl),
                                                 (cache_len, cl_pl))]
    o = local_map(local, out_placements=(q_pl,), in_placements=(q_pl, kv_pl, kv_pl, cl_pl),
                  device_mesh=mesh, redistribute_inputs=True)(*args)
    if whole:
        o = o.full_tensor()
    return o if squeezed else o[:, None]
