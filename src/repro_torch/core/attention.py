"""Public attention ops — the port of `repro/core/attention.py`.

`flash_attention`  — training / prefill: [B, S, H, d] tensors, differentiable.
`decode_attention` — single-token decode against a KV cache with dynamic
                     length: split-K partials merged with the FLASH-D
                     sigmoid blend (plain PyTorch).
`decode_attention_paged` — the same against a paged pool through a block
                     table (`gather_pages`, then `decode_attention`).
`varlen_attention` — packed rows of many sequences (prefill chunks and
                     decode tokens side by side) against a paged pool; the
                     K4 kernel on the card, a gather + one softmax here.

The plain paged paths zero every gathered position past a sequence's
length before they use it, so table slots past the live pages (the
engine points them at the garbage page 0, which may hold anything) can
never reach a result — the kernels never read them at all.

impl ∈ IMPLS:
  flashd        — a CUDA tensor launches the K1 kernel, a CPU tensor takes
                  the plain tiled recurrence (the default).
  flashd_gpu    — always the kernel; raises on a CPU tensor. The bridge maps
                  the reference's 'flashd_pallas' here.
  flashd_plain  — the plain tiled recurrence on any device (tests and
                  chip_smoke.py hold the kernel against it).
  fa2, fa2_gpu, fa2_plain — the same three routes for the FlashAttention-2
                  baseline (K6 and `blockwise_fa2`).
  naive         — the O(S²) softmax oracle.
  xla           — O(S²) softmax differentiated by autograd, which saves the
                  [B, H, Sq, Skv] probabilities: the reference's training
                  baseline (`_xla_attention`).

Every impl but 'xla' runs through one `torch.autograd.Function`, the
reference's `custom_vjp`: the forward saves (q, k, v, O, Λ) and the
backward is the `attention_bwd` op — K5 on the kernel route, its plain
version otherwise — which recomputes the score tiles from (q, k, Λ), so
nothing [Sq, Skv]-sized is saved.

Under a sharding context (`distributed.sharding`), q, k and v are DTensors
and `flash_attention` runs that same Function in one `local_map` island on
each rank's local heads (K1 / K6 forward and K5 backward on the card):
heads go over 'model' only when both Hq and Hkv divide it — contiguous
shards then keep q head i beside kv head ⌊i/G⌋ — and otherwise the batch
goes over every mesh axis that divides it (the reference's full-DP
fallback). Under a context that opts into prefill context parallelism
(`cp_prefill=True`) and sequence-shards these operands, `flash_attention`
first takes the ring (`distributed.context.maybe_ring_prefill`: per-shard
K1 / K6 and the cross-rank Λ-merge, forward only); `decode_attention`
takes `maybe_cp_decode` on a sequence-sharded cache, with the plain
per-shard partial, as the reference does.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.blockwise import NEG_INF, MaskSpec, merge_partials
from repro_torch.distributed import sharding as shd

__all__ = [
    "flash_attention",
    "decode_attention",
    "decode_attention_paged",
    "gather_pages",
    "varlen_attention",
    "uses_kernel",
    "MaskSpec",
    "IMPLS",
]

IMPLS = ("flashd", "flashd_gpu", "flashd_plain", "fa2", "fa2_gpu", "fa2_plain", "naive", "xla")


def uses_kernel(impl: str, x: torch.Tensor) -> bool:
    """Does `impl` launch the CUDA kernels for tensors like `x`?"""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not ported (have {IMPLS})")
    return impl.endswith("_gpu") or (impl in ("flashd", "fa2") and x.is_cuda)


def _naive(q, k, v, mask: MaskSpec, scale: float):
    """O(S²) softmax with the dead-row convention, model layout in and out
    → (o [B, Sq, Hq, dv], Λ [B, Hq, Sq])."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qf = q.float().transpose(1, 2).reshape(b, hkv, g, sq, d)
    s = torch.einsum("bhgqd,bkhd->bhgqk", qf, k.float()) * scale
    bias = mask.block_bias(torch.arange(sq, device=q.device), torch.arange(k.shape[1], device=q.device))
    if bias is not None:
        s = s + bias
    lam = torch.logsumexp(s, dim=-1)
    dead = lam <= NEG_INF / 2  # no visible key → zero row
    lam = torch.where(dead, NEG_INF, lam)
    p = torch.where(dead[..., None], 0.0, torch.exp(s - lam[..., None]))
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o.reshape(b, hq, sq, -1).transpose(1, 2).to(q.dtype), lam.reshape(b, hq, sq)


def _attention_core_fwd(q, k, v, mask, scale, impl, block_q, block_k, skip):
    """→ (o [B, Sq, Hq, dv] in q.dtype, Λ [B, Hq, Sq] f32) for any impl but xla."""
    if impl == "naive":
        return _naive(q, k, v, mask, scale)
    from repro_torch.kernels import ops  # lazy: avoid import cycle

    family = impl.split("_")[0]  # flashd | fa2
    if uses_kernel(impl, q):  # the kernel keeps its own tiles; skip's block_k ≤ 64
        return ops.get_op("attention_fwd")(q, k, v, mask=mask, scale=scale, impl=family,
                                           block_k=block_k if skip else None, skip=skip)
    return ops.get_fallback("attention_fwd")(q, k, v, mask=mask, scale=scale, impl=family,
                                             block_q=block_q, block_k=block_k, skip=skip)


class _FlashAttention(torch.autograd.Function):
    """The reference's `_attention_core` custom_vjp: save (q, k, v, O, Λ),
    differentiate through the `attention_bwd` op (K5 on the kernel route)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, scale, impl, block_q, block_k, skip):
        o, lam = _attention_core_fwd(q, k, v, mask, scale, impl, block_q, block_k, skip)
        ctx.save_for_backward(q, k, v, o, lam)
        ctx.opts = (mask, scale, impl, block_q, block_k)
        return o

    @staticmethod
    def backward(ctx, do):
        from repro_torch.kernels import ops  # lazy: avoid import cycle

        q, k, v, o, lam = ctx.saved_tensors
        mask, scale, impl, block_q, block_k = ctx.opts
        op = (ops.get_op if uses_kernel(impl, q) else ops.get_fallback)("attention_bwd")
        dq, dk, dv = op(q, k, v, o, lam, do.contiguous(), mask=mask, scale=scale,
                        block_q=block_q, block_k=block_k)
        return dq, dk, dv, None, None, None, None, None, None


def _xla_attention(q, k, v, mask: MaskSpec, scale: float):
    """Plain softmax attention differentiated by autograd — no Function, so
    the [B, H, Sq, Skv] probabilities are saved for the backward. The
    reference's training baseline (its BENCH_train comparison)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if g > 1:  # GQA: materialize the repeated KV heads (baseline semantics)
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    bias = mask.block_bias(torch.arange(sq, device=q.device), torch.arange(skv, device=q.device))
    if bias is not None:
        s = s + bias
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    mask: MaskSpec = MaskSpec("causal"),
    scale: Optional[float] = None,
    impl: str = "flashd",
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    skip: bool = False,
) -> torch.Tensor:
    """Multi-head GQA attention. q [B,Sq,Hq,d]; k,v [B,Skv,Hkv,·] → o [B,Sq,Hq,dv].

    Differentiable in q, k and v. block_q / block_k = None resolves the
    plain path's tiling from the reference heuristics
    (`tuning.choose_prefill_blocks`). The kernels keep their own tiles;
    with skip on K1 is handed `block_k`, which must then be ≤ 64 (the skip
    threshold depends on it). The backward recomputes exact probabilities:
    the forward's skip does not reach it."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected [batch, seq, heads, dim] operands")
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"Hq={q.shape[2]} not a multiple of Hkv={k.shape[2]}")
    if scale is None:
        scale = float(1.0 / math.sqrt(q.shape[-1]))
    uses_kernel(impl, q)  # validates the impl name
    if impl == "xla":
        return _xla_attention(q, k, v, mask, scale)
    from repro_torch.distributed.context import maybe_ring_prefill  # lazy: no cycle

    o_cp = maybe_ring_prefill(q, k, v, mask=mask, scale=scale, impl=impl, block_q=block_q,
                              block_k=block_k, skip=skip)
    if o_cp is not None:
        return o_cp
    if shd.is_dtensor(q):
        return _attention_island(q, k, v, mask, scale, impl, block_q, block_k, skip)
    return _FlashAttention.apply(q, k, v, mask, scale, impl, block_q, block_k, skip)


def _island_spec(ctx, q_shape, k_shape) -> "shd.P":
    """One spec for q, k and v: heads over 'model' when both head counts
    divide it, else the batch over every axis that divides it. The sequence
    stays whole (each rank's attention sees its rows' every key)."""
    b = shd._fit(ctx, q_shape[0], ctx.batch_axes)
    if shd._fit(ctx, q_shape[2], "model") and shd._fit(ctx, k_shape[2], "model"):
        return shd.P(b, None, "model", None)
    return shd.P(shd._fit(ctx, q_shape[0], ctx.batch_axes + ("model",)), None, None, None)


def _attention_island(q, k, v, mask, scale, impl, block_q, block_k, skip):
    """`_FlashAttention` on each rank's shard of DTensors q, k, v: the
    kernels (or, on CPU tensors, their plain versions) see plain local
    tensors, made contiguous so a strided shard is not refused by the
    kernels' 16-byte copy checks."""
    from torch.distributed.tensor.experimental import local_map

    ctx = shd.active_ctx()
    if ctx is None:
        raise RuntimeError("DTensor attention inputs without an active sharding context")
    mesh = q.device_mesh
    pl = shd.placements(_island_spec(ctx, q.shape, k.shape), mesh)

    def local(q_, k_, v_):
        return _FlashAttention.apply(q_.contiguous(), k_.contiguous(), v_.contiguous(), mask,
                                     scale, impl, block_q, block_k, skip)

    return local_map(local, out_placements=(pl,), in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def decode_attention(
    q: torch.Tensor,  # [B, 1, Hq, d] — one new token per sequence
    k_cache: torch.Tensor,  # [B, S_max, Hkv, d]
    v_cache: torch.Tensor,  # [B, S_max, Hkv, dv]
    cache_len: torch.Tensor,  # [B] or scalar — number of valid cache entries
    *,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
    n_splits: Optional[int] = None,
) -> torch.Tensor:
    """Single-step decode in plain PyTorch — the reference's jnp path.

    Scores against the whole cache, then with n_splits > 1 the cache is cut
    along S, each part yields (o_p, Λ_p), and the parts are merged with the
    FLASH-D sigmoid blend (`merge_partials`). n_splits=None takes the
    reference heuristic (`tuning.choose_decode_split`)."""
    b, _, hq, d = q.shape
    s_max, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    from repro_torch.distributed.context import maybe_cp_decode  # lazy: no cycle

    # a sequence-sharded cache: the plain per-shard partials, merged across
    # ranks (the reference's choice, kernel or not)
    o_cp = maybe_cp_decode(q, k_cache, v_cache, cache_len, scale=scale, window=window,
                           chunk=chunk, n_splits=n_splits, use_kernel=False)
    if o_cp is not None:
        return o_cp
    if n_splits is None:
        from repro_torch.kernels.tuning import choose_decode_split  # lazy: no cycle

        n_splits = choose_decode_split(
            s_max, d, v_cache.shape[-1], group=g, window=window, chunk=chunk
        ).n_splits
    n_splits = max(1, min(n_splits, s_max))
    cache_len = torch.as_tensor(cache_len, device=q.device)
    if cache_len.ndim == 0:
        cache_len = cache_len.expand(b)

    qf = q.float().reshape(b, hkv, g, d)
    kf, vf = k_cache.float(), v_cache.float()
    pos = torch.arange(s_max, device=q.device)
    valid = pos[None, :] < cache_len[:, None]  # [B, S]
    if window > 0:
        valid &= pos[None, :] >= (cache_len[:, None] - window)
    if chunk > 0:
        cur = torch.div(cache_len[:, None] - 1, chunk, rounding_mode="floor")
        valid &= torch.div(pos[None, :], chunk, rounding_mode="floor") == cur

    s = torch.einsum("bhgd,bshd->bhgs", qf, kf) * scale  # [B, Hkv, G, S]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    if n_splits <= 1:
        lam = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lam[..., None])
        # rows with no visible key are ZERO, not the uniform-softmax artifact
        p = torch.where(valid[:, None, None, :], p, 0.0)
        o = torch.einsum("bhgs,bshd->bhgd", p, vf)
    else:
        dv = v_cache.shape[-1]
        pad = (-s_max) % n_splits  # padded slots score NEG_INF ⇒ dead
        if pad:
            s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF)
            vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad))
        split = (s_max + pad) // n_splits
        sp = s.reshape(b, hkv, g, n_splits, split).permute(3, 0, 1, 2, 4)
        vp = vf.reshape(b, n_splits, split, hkv, dv).transpose(0, 1)
        m_p = sp.amax(dim=-1)
        m_safe = torch.clamp(m_p, min=NEG_INF / 2)
        p = torch.exp(sp - m_safe[..., None])
        l_p = p.sum(dim=-1)
        tiny = torch.finfo(torch.float32).tiny
        lam_p = torch.where(l_p > 0, m_safe + torch.log(torch.clamp(l_p, min=tiny)), NEG_INF)
        o_p = torch.einsum("pbhgs,pbshd->pbhgd", p, vp)
        o_p = o_p / torch.clamp(l_p, min=tiny)[..., None]
        o, _ = merge_partials(o_p, lam_p)  # FLASH-D split-K merge
    return o.reshape(b, 1, hq, -1).to(q.dtype)


def gather_pages(pages: torch.Tensor, block_tbl: torch.Tensor,
                 scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[P, page, Hkv, ·] pool + [B, N] table → contiguous [B, N·page, Hkv, ·].

    With `scales` ([P, Hkv] f32, a quantized pool's per-(page, head)
    side-band) the gathered view is dequantized to f32."""
    b, n = block_tbl.shape
    _, page, hkv = pages.shape[:3]
    tbl = block_tbl.long()
    out = pages[tbl]  # [B, N, page, Hkv, ·]
    if scales is not None:
        out = out.float() * scales[tbl][:, :, None, :, None]
    return out.reshape(b, n * page, hkv, pages.shape[-1])


def _zero_past(x: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """x [B, S, ...] with positions ≥ length[b] set to 0 (dead table slots
    may point at a page holding anything, NaN included)."""
    keep = torch.arange(x.shape[1], device=x.device)[None, :] < length.reshape(-1, 1)
    keep = keep.reshape(keep.shape + (1,) * (x.ndim - 2))
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def decode_attention_paged(
    q: torch.Tensor,  # [B, 1, Hq, d]
    k_pages: torch.Tensor,  # [P, page, Hkv, d] — global page pool
    v_pages: torch.Tensor,  # [P, page, Hkv, dv]
    block_tbl: torch.Tensor,  # [B, N] int per-sequence block tables
    cache_len: torch.Tensor,  # [B]
    *,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
    n_splits: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32 — quantized pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-step decode against a paged KV cache in plain PyTorch: gather
    the pages into a contiguous [B, N·page, Hkv, ·] view (dequantized with
    the scales), then `decode_attention`."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    b = q.shape[0]
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(-1).expand(b)
    k_cache = _zero_past(gather_pages(k_pages, block_tbl, scales=k_scale), cache_len)
    v_cache = _zero_past(gather_pages(v_pages, block_tbl, scales=v_scale), cache_len)
    return decode_attention(q, k_cache, v_cache, cache_len, scale=scale, window=window,
                            chunk=chunk, n_splits=n_splits)


def varlen_attention(
    q: torch.Tensor,  # [T, Hq, d] — packed query rows from many sequences
    k_pages: torch.Tensor,  # [P, page, Hkv, d] — global page pool
    v_pages: torch.Tensor,  # [P, page, Hkv, dv]
    block_tbl: torch.Tensor,  # [B, N] int per-sequence block tables
    seq_ids: torch.Tensor,  # [T] owning sequence per row (−1 = padding)
    q_pos: torch.Tensor,  # [T] absolute KV position per row (−1 = padding)
    kv_len: torch.Tensor,  # [B] visible KV length per sequence
    *,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
    impl: str = "flashd",
    block_q: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32 — quantized pool
    v_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32
) -> torch.Tensor:
    """Packed varlen attention over a paged KV cache → o [T, Hq, dv].

    Every row attends its own sequence's pages under a causal (× window /
    chunk) mask at its absolute position; padding rows (seq_ids < 0 or
    q_pos < 0) return exact zeros.

    On the kernel path (`uses_kernel(impl, q)`) the rows are padded to a
    `block_q` multiple and K4 runs; segment ALIGNMENT to `block_q` is the
    caller's contract (the engine's packer provides it). block_q=None
    takes `tuning.choose_varlen_blocks`, as the reference does. Otherwise
    this is the reference's plain mirror: each row's sequence is gathered
    to a contiguous view and attended with one softmax."""
    t, hq, d = q.shape
    _, page, hkv, dv = v_pages.shape
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    dev = q.device
    seq_ids = torch.as_tensor(seq_ids, device=dev).long()
    q_pos = torch.as_tensor(q_pos, device=dev).long()
    kv_len = torch.as_tensor(kv_len, device=dev).reshape(-1).long()

    if uses_kernel(impl, q):
        from repro_torch.kernels import ops  # lazy: avoid import cycle

        if block_q is None:
            from repro_torch.kernels.tuning import choose_varlen_blocks

            block_q = choose_varlen_blocks(
                t, d, dv, group=g, page=page,
                kv_itemsize=k_pages.element_size() if k_scale is not None else 4,
            ).block_q
        pad = (-t) % block_q
        if pad:
            q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad))
            seq_ids = torch.nn.functional.pad(seq_ids, (0, pad), value=-1)
            q_pos = torch.nn.functional.pad(q_pos, (0, pad), value=-1)
        o = ops.get_op("varlen")(
            q, k_pages, v_pages, block_tbl, seq_ids, q_pos, kv_len,
            scale=scale, window=window, chunk=chunk, block_q=block_q,
            k_scale=k_scale, v_scale=v_scale,
        )
        return o[:t]

    sid = torch.clamp(seq_ids, min=0)
    k_cache = _zero_past(gather_pages(k_pages, block_tbl, scales=k_scale), kv_len)
    v_cache = _zero_past(gather_pages(v_pages, block_tbl, scales=v_scale), kv_len)
    s_tot = k_cache.shape[1]
    kt = k_cache[sid].float()  # [T, S, Hkv, d]
    vt = v_cache[sid].float()
    qf = q.float().reshape(t, hkv, g, d)

    pos = torch.arange(s_tot, device=dev)
    keep = pos[None, :] < kv_len[sid][:, None]  # sequence boundary
    keep &= pos[None, :] <= q_pos[:, None]  # causal at the row's position
    keep &= (seq_ids >= 0)[:, None]
    if window > 0:
        keep &= q_pos[:, None] - pos[None, :] < window
    if chunk > 0:
        keep &= (torch.div(q_pos[:, None], chunk, rounding_mode="floor")
                 == torch.div(pos[None, :], chunk, rounding_mode="floor"))

    s = torch.einsum("thgd,tshd->thgs", qf, kt) * scale
    s = torch.where(keep[:, None, None, :], s, NEG_INF)
    lam = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lam[..., None])
    # rows with no visible key (padding, empty segments) are ZERO
    p = torch.where(keep[:, None, None, :], p, 0.0)
    o = torch.einsum("thgs,tshd->thgd", p, vt)
    return o.reshape(t, hq, dv).to(q.dtype)
