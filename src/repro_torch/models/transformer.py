"""Decoder LM — the port of `repro/models/transformer.py` for stacks of
`attn` / `attn_nope` mixers with `swiglu` FFNs (the other mixers raise
"not ported", queue item A12).

Parameters are the reference's tree, a plain dict of tensors: `embed`,
`final_norm`, `lm_head`, and `blocks/pos{j}/...` stacked on a leading layer
axis. Where the reference scans that axis, the port loops over it in
Python; attention runs through `repro_torch.core.attention` (on the card:
the K1 kernel for full sequences, K2 for decode on the contiguous cache,
K3 for decode on the paged pool, K4 for the packed mixed step).

Caches: contiguous ([L, B, S, Hkv, hd] per layer group) or paged (a page
pool [L, P, page, Hkv, hd] per layer plus block tables [L, B, N]; every
layer holds the same table). They are updated IN PLACE (`index_put` into
the stacked tensors), where the reference rebuilt them functionally, so
decode and `forward_packed` return the cache object they were given. The
fault-tolerant retry of a later slice (A10) needs the reference's
commit-after-sync discipline back: a step that is retried must not see
its own writes.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.attention import (
    MaskSpec,
    decode_attention,
    decode_attention_paged,
    flash_attention,
    uses_kernel,
    varlen_attention,
)
from repro_torch.devices import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    embed_lookup,
    logits_from_hidden,
    rms_norm,
)

__all__ = [
    "init_lm",
    "apply_lm",
    "lm_loss",
    "init_decode_cache",
    "decode_step_lm",
    "prefill_lm",
    "paged_mixers",
    "packed_mixers_ok",
    "forward_packed",
]

_AUX_KEYS = ("moe_aux_loss", "moe_z_loss", "moe_dropped")
_PORTED_MIXERS = ("attn", "attn_nope")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for any part of `cfg` this slice does not run."""
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder models not ported (A12)")
    if cfg.frontend != "none":
        raise NotImplementedError(f"{cfg.name}: {cfg.frontend} frontend not ported (A12)")
    for mixer, ffn in (*cfg.pattern, *cfg.remainder):
        if mixer not in _PORTED_MIXERS or ffn != "swiglu":
            raise NotImplementedError(
                f"{cfg.name}: layer ({mixer}, {ffn}) not ported (A12); "
                f"this slice runs {_PORTED_MIXERS} + swiglu"
            )


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_attn(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    dt, dev = cfg.master_dtype, gen.device
    p = {
        "wq": dense_init(gen, (d, hq * hd), dtype=dt),
        "wk": dense_init(gen, (d, hkv * hd), dtype=dt),
        "wv": dense_init(gen, (d, hkv * hd), dtype=dt),
        "wo": dense_init(gen, (hq * hd, d), dtype=dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((hq * hd,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((hkv * hd,), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((hd,), dtype=dt, device=dev)
        p["k_norm"] = torch.zeros((hd,), dtype=dt, device=dev)
    return p


def _init_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    dt, dev = cfg.master_dtype, gen.device
    return {
        "norm1": torch.zeros((d,), dtype=dt, device=dev),
        "mixer": _init_attn(gen, cfg),
        "norm2": torch.zeros((d,), dtype=dt, device=dev),
        "ffn": {
            "wg": dense_init(gen, (d, f), dtype=dt),
            "wu": dense_init(gen, (d, f), dtype=dt),
            "wd": dense_init(gen, (f, d), dtype=dt),
        },
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_lm(cfg: ModelConfig, *, device=None, seed: int = 0,
            generator: Optional[torch.Generator] = None) -> dict:
    """Random weights in the reference's tree, drawn on `device` (default the
    card) from `generator` (default: a new one seeded with `seed`). The
    distribution is the reference's; the numbers are torch's."""
    check_ported(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device} for parameters on {dev}")
    dt = cfg.master_dtype
    params: dict = {
        "embed": dense_init(gen, (cfg.padded_vocab, cfg.d_model), scale=0.02, dtype=dt),
        "final_norm": torch.zeros((cfg.d_model,), dtype=dt, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.padded_vocab), dtype=dt)
    if cfg.n_blocks > 0:
        params["blocks"] = _stack([
            {f"pos{j}": _init_block(gen, cfg) for j in range(len(cfg.pattern))}
            for _ in range(cfg.n_blocks)
        ])
    if cfg.remainder:
        params["rem_blocks"] = _stack([
            {f"pos{j}": _init_block(gen, cfg) for j in range(len(cfg.remainder))}
        ])
    return params


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _index(tree, i: int):
    """Layer i of a stacked tree: views, so in-place cache writes land in
    the stacked tensors."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _groups(cfg: ModelConfig):
    out = []
    if cfg.n_blocks > 0:
        out.append(("blocks", cfg.pattern))
    if cfg.remainder:
        out.append(("rem_blocks", cfg.remainder))
    return out


def _qkv(p, x, cfg: ModelConfig, kind: str, positions):
    cdt = cfg.compute_dtype
    hd = cfg.head_dim_
    b, s, _ = x.shape
    q = torch.matmul(x, p["wq"].to(cdt))
    k = torch.matmul(x, p["wk"].to(cdt))
    v = torch.matmul(x, p["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = q.reshape(b, s, cfg.n_heads, hd)
    k = k.reshape(b, s, cfg.n_kv_heads, hd)
    v = v.reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if kind != "attn_nope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _apply_attn(p, x, cfg: ModelConfig, kind: str, positions):
    q, k, v = _qkv(p, x, cfg, kind, positions)
    o = flash_attention(
        q, k, v, mask=MaskSpec("causal"), impl=cfg.attn_impl,  # attn / attn_nope
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k, skip=cfg.attn_skip,
    )
    b, s = x.shape[:2]
    return torch.matmul(o.reshape(b, s, cfg.n_heads * cfg.head_dim_), p["wo"].to(cfg.compute_dtype))


def _apply_swiglu(p, x, cfg: ModelConfig):
    cdt = cfg.compute_dtype
    g = torch.matmul(x, p["wg"].to(cdt))
    u = torch.matmul(x, p["wu"].to(cdt))
    return torch.matmul(torch.nn.functional.silu(g) * u, p["wd"].to(cdt))


def _apply_block(bp: dict, h, cfg: ModelConfig, spec, positions):
    """One (mixer, ffn) block with pre-norms and residuals."""
    mixer, _ = spec
    h = h + _apply_attn(bp["mixer"], rms_norm(h, bp["norm1"], cfg.norm_eps), cfg, mixer, positions)
    return h + _apply_swiglu(bp["ffn"], rms_norm(h, bp["norm2"], cfg.norm_eps), cfg)


def _head(params, cfg: ModelConfig):
    return params["lm_head"] if not cfg.tie_embeddings else params["embed"].T


def _dots_saveable(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat='dots': keep the matrix products,
    recompute the rest (the reference's `dots_with_no_batch_dims_saveable`)."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default, aten.bmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, cfg: ModelConfig):
    """The reference's `_remat` (transformer.py:249) for one block: 'none'
    saves every activation; 'full' keeps only the block's input and
    recomputes the block in the backward (so K1 runs twice per layer and
    step); 'dots' keeps the matrix products too. Values are the same in all
    three. Only where a gradient is being recorded: serving runs `fn`."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    import functools

    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_saveable)
    elif cfg.remat != "full":
        raise ValueError(f"unknown remat {cfg.remat!r} (none, dots, full)")
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


def apply_lm(params: dict, batch: Dict, cfg: ModelConfig, *, last_only: bool = False):
    """Forward pass → (logits [B, S, Vpad] f32, aux dict of zeros).

    last_only=True returns logits for the final position only — the
    reference's prefill forward. Under autograd each block is
    rematerialized as `cfg.remat` says."""
    check_ported(cfg)
    tokens = batch["tokens"]
    h = embed_lookup(params["embed"], tokens, cfg.compute_dtype)
    positions = torch.arange(h.shape[1], device=h.device)
    block = _remat(_apply_block, cfg)
    for key, pattern in _groups(cfg):
        for i in range(params[key]["pos0"]["norm1"].shape[0]):
            bp = _index(params[key], i)
            for j, spec in enumerate(pattern):
                h = block(bp[f"pos{j}"], h, cfg, spec, positions)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    logits = logits_from_hidden(h, _head(params, cfg), cfg.vocab_size)
    return logits, {k: 0.0 for k in _AUX_KEYS}


def lm_loss(params: dict, batch: Dict, cfg: ModelConfig):
    """Causal-LM cross entropy (+ the MoE aux terms, zero for the ported
    stacks) → (loss, metrics); labels == −1 are masked. Differentiable."""
    logits, aux = apply_lm(params, batch, cfg)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    ce = torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)
    loss = ce + aux["moe_aux_loss"] + aux["moe_z_loss"]
    return loss, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# serving: contiguous per-layer caches + one-token decode
# ---------------------------------------------------------------------------

def paged_mixers(cfg: ModelConfig):
    """Mixer kinds that take the paged layout: full-length (global)
    attention caches only — here every ported mixer ('attn', 'attn_nope')."""
    return tuple(
        m for m, _ in (*cfg.pattern, *cfg.remainder)
        if m.startswith("attn") and m not in ("attn_local", "attn_chunked")
    )


def packed_mixers_ok(cfg: ModelConfig) -> bool:
    """Can this stack run the packed varlen mixed step? Every mixer must
    read and write per-sequence state through the paged cache alone:
    global causal attention ('attn', 'attn_nope')."""
    return all(m in ("attn", "attn_nope") for m, _ in (*cfg.pattern, *cfg.remainder))


def init_decode_cache(batch: int, max_len: int, cfg: ModelConfig, *,
                      layout: str = "contiguous", page_size: Optional[int] = None,
                      n_pages: Optional[int] = None, kv_dtype: str = "", device=None) -> dict:
    """Zeroed decode caches in the reference's tree {'blocks': {'pos{j}':
    ...}}, in the compute dtype.

    layout="contiguous": {'k', 'v'}, each [n_blocks, batch, max_len, Hkv, hd].
    layout="paged": {'k_pages', 'v_pages'} [n_blocks, P, page, Hkv, hd] and
    'tbl' [n_blocks, batch, N] int32 (N = ⌈max_len / page⌉), every row
    starting on the garbage page 0. The geometry comes from
    `tuning.choose_page_layout`, sized at (n_pages − 1)·page_size tokens
    when both are given, else at batch·max_len — as the reference. A
    quantized pool (kv_dtype, A8) is not ported."""
    check_ported(cfg)
    if layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    if kv_dtype:
        raise NotImplementedError(f"kv_dtype {kv_dtype!r} not ported (A8)")
    dev = resolve_device(device)
    geom = None
    if layout == "paged":
        from repro_torch.kernels.tuning import choose_page_layout  # lazy: no cycle

        pl_ = choose_page_layout(
            max_len, cfg.head_dim_, cfg.head_dim_,
            group=cfg.n_heads // cfg.n_kv_heads,
            pool_tokens=(n_pages - 1) * page_size if (n_pages and page_size)
            else batch * max_len,
            page_size=page_size,
        )
        geom = (pl_.n_pages, pl_.page_size, pl_.pages_per_seq)

    def layer(n: int) -> dict:
        dt = cfg.compute_dtype
        if geom is None:
            shape = (n, batch, max_len, cfg.n_kv_heads, cfg.head_dim_)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}
        n_p, page, per_seq = geom
        pshape = (n, n_p, page, cfg.n_kv_heads, cfg.head_dim_)
        return {
            "k_pages": torch.zeros(pshape, dtype=dt, device=dev),
            "v_pages": torch.zeros(pshape, dtype=dt, device=dev),
            "tbl": torch.zeros((n, batch, per_seq), dtype=torch.int32, device=dev),
        }

    cache: dict = {}
    for key, pattern in _groups(cfg):
        n = cfg.n_blocks if key == "blocks" else 1
        cache[key] = {f"pos{j}": layer(n) for j in range(len(pattern))}
    return cache


def _decode_attn(p, x, cfg: ModelConfig, kind: str, cache, pos, alive=None):
    """One-token attention against the cache; writes this token's K/V in
    place at slot pos % max_len (contiguous) or through the block table
    (paged). pos [B] absolute position. On the contiguous cache, rows with
    alive == False keep their cache unchanged (prefill_lm's `lengths`); a
    paged pool takes their writes, which land past the row's length (the
    reference's `_freeze_dead_rows` passes pool leaves through too)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, kind, pos[:, None])
    if "k_pages" in cache:
        o = _paged_attn_step(q, k, v, cfg, cache, pos)
        return torch.matmul(o.reshape(b, 1, cfg.n_heads * cfg.head_dim_),
                            p["wo"].to(cfg.compute_dtype))
    k_cache, v_cache = cache["k"], cache["v"]  # [B, S_max, Hkv, hd] views
    write_idx = pos % k_cache.shape[1]
    bidx = torch.arange(b, device=x.device)
    k_new, v_new = k[:, 0], v[:, 0]
    if alive is not None:
        keep = alive[:, None, None]
        k_new = torch.where(keep, k_new, k_cache[bidx, write_idx])
        v_new = torch.where(keep, v_new, v_cache[bidx, write_idx])
    k_cache[bidx, write_idx] = k_new
    v_cache[bidx, write_idx] = v_new
    eff_len = pos + 1
    if uses_kernel(cfg.attn_impl, x):
        from repro_torch.kernels import ops  # lazy: no cycle

        o = ops.get_op("decode")(q, k_cache, v_cache, eff_len)
    else:
        o = decode_attention(q, k_cache, v_cache, eff_len)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim_)
    return torch.matmul(o, p["wo"].to(cfg.compute_dtype))


def _paged_attn_step(q, k, v, cfg: ModelConfig, cache, pos):
    """One-token attention against a paged cache: write the new K/V in place
    into the position's physical page through the block table, then attend
    through the table (K3 on the card). Writes past the table (dead slots
    whose `pos` keeps advancing in the lockstep batch) land on the garbage
    page 0. → o [B, 1, Hq, hd]."""
    b = q.shape[0]
    k_pages, v_pages, tbl = cache["k_pages"], cache["v_pages"], cache["tbl"]
    page, n_tbl = k_pages.shape[1], tbl.shape[1]
    bidx = torch.arange(b, device=q.device)
    page_idx = torch.div(pos, page, rounding_mode="floor")
    pid = torch.where(page_idx < n_tbl, tbl[bidx, torch.clamp(page_idx, max=n_tbl - 1)], 0).long()
    slot = pos % page
    k_pages[pid, slot] = k[:, 0]
    v_pages[pid, slot] = v[:, 0]
    eff_len = pos + 1
    if uses_kernel(cfg.attn_impl, q):
        from repro_torch.kernels import ops  # lazy: no cycle

        return ops.get_op("decode_paged")(q, k_pages, v_pages, tbl, eff_len)
    return decode_attention_paged(q, k_pages, v_pages, tbl, eff_len)


def _decode_block(bp, h, cfg: ModelConfig, spec, cache, pos, alive=None):
    mixer, _ = spec
    x = rms_norm(h, bp["norm1"], cfg.norm_eps)
    h = h + _decode_attn(bp["mixer"], x, cfg, mixer, cache, pos, alive)
    return h + _apply_swiglu(bp["ffn"], rms_norm(h, bp["norm2"], cfg.norm_eps), cfg)


def _run_cached_groups(params: dict, cache: dict, h, cfg: ModelConfig, block_step):
    """Run every stacked block group through `block_step(bp, bc, h, pattern)
    → h`, layer by layer; `bc` holds views of the stacked cache, so the
    step's writes land in `cache` itself."""
    for key, pattern in _groups(cfg):
        for i in range(next(iter(cache[key]["pos0"].values())).shape[0]):  # layer axis
            h = block_step(_index(params[key], i), _index(cache[key], i), h, pattern)
    return h


def _decode_hidden(params, cache, token, pos, cfg: ModelConfig, alive=None):
    """Final-normed hidden state [B, 1, D] of one decode step."""
    h = embed_lookup(params["embed"], token[:, None], cfg.compute_dtype)

    def block_step(bp, bc, h, pattern):
        for j, spec in enumerate(pattern):
            h = _decode_block(bp[f"pos{j}"], h, cfg, spec, bc[f"pos{j}"], pos, alive)
        return h

    h = _run_cached_groups(params, cache, h, cfg, block_step)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def decode_step_lm(params: dict, cache: dict, token: torch.Tensor, pos: torch.Tensor,
                   cfg: ModelConfig):
    """One decode step. token [B], pos [B] → (logits [B, Vpad], cache), the
    cache updated in place."""
    h = _decode_hidden(params, cache, token, pos.long(), cfg)
    return logits_from_hidden(h, _head(params, cfg), cfg.vocab_size)[:, 0], cache


def prefill_lm(params: dict, tokens: torch.Tensor, cache: dict, cfg: ModelConfig,
               *, start_pos: int = 0, lengths: Optional[torch.Tensor] = None):
    """Prefill a decode cache by running the decode step over the prompt, one
    position at a time — exact: the cache equals incremental decoding.
    Returns (logits of the last prompt token [B, Vpad], cache).

    start_pos > 0 prefills a tail at positions [start_pos, start_pos + s),
    the cache already holding the first start_pos positions.

    lengths [B] (each row's real token count ≤ s): rows stop writing the
    cache after their length (the reference's `_freeze_dead_rows`, here a
    masked in-place write) and their logits are those of position
    lengths − 1. The hidden state is captured there and the LM head runs
    once at the end, which gives the logits the reference computes per step."""
    b, s = tokens.shape
    dev = tokens.device
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev).reshape(b)
    h_last = torch.zeros((b, 1, cfg.d_model), dtype=cfg.compute_dtype, device=dev)
    seen = torch.zeros((b,), dtype=torch.bool, device=dev)
    for t in range(s):
        pos = torch.full((b,), start_pos + t, dtype=torch.long, device=dev)
        alive = None if lengths is None else t < lengths
        h = _decode_hidden(params, cache, tokens[:, t], pos, cfg, alive)
        take = (torch.ones_like(seen) if lengths is None else t == lengths - 1)
        h_last = torch.where(take[:, None, None], h, h_last)
        seen = seen | take
    logits = logits_from_hidden(h_last, _head(params, cfg), cfg.vocab_size)[:, 0]
    return torch.where(seen[:, None], logits, 0.0), cache


# ---------------------------------------------------------------------------
# serving: the packed varlen step (prefill chunks and decode rows together)
# ---------------------------------------------------------------------------

def _packed_attn(p, x, cfg: ModelConfig, kind: str, cache, positions, seq_ids, kv_len,
                 block_q: Optional[int]):
    """Packed varlen attention for one layer: write the pack's new K/V in
    place into each row's physical page through the block table (padding
    rows — seq_ids or positions < 0 — and rows past the table write the
    garbage page 0), then attend the pack through `varlen_attention` (K4 on
    the card). x [1, T, D]; positions / seq_ids [T]; kv_len [B]."""
    t = x.shape[1]
    q, k, v = _qkv(p, x, cfg, kind, positions[None])
    k_pages, v_pages, tbl = cache["k_pages"], cache["v_pages"], cache["tbl"]
    page, n_tbl = k_pages.shape[1], tbl.shape[1]
    sid = torch.clamp(seq_ids, min=0)
    page_idx = torch.div(positions, page, rounding_mode="floor")
    in_tbl = (seq_ids >= 0) & (positions >= 0) & (page_idx < n_tbl)
    pid = torch.where(in_tbl, tbl[sid, torch.clamp(page_idx, 0, n_tbl - 1)], 0).long()
    slot = torch.where(positions >= 0, positions % page, 0)
    k_pages[pid, slot] = k[0]
    v_pages[pid, slot] = v[0]
    o = varlen_attention(q[0], k_pages, v_pages, tbl, seq_ids, positions, kv_len,
                         impl=cfg.attn_impl, block_q=block_q)
    return torch.matmul(o.reshape(1, t, cfg.n_heads * cfg.head_dim_), p["wo"].to(cfg.compute_dtype))


def forward_packed(params: dict, tokens: torch.Tensor, seq_ids: torch.Tensor,
                   positions: torch.Tensor, kv_len: torch.Tensor, cache: dict,
                   cfg: ModelConfig, last_rows: torch.Tensor, block_q: Optional[int] = None):
    """One packed varlen step over the whole stack: tokens / seq_ids /
    positions [T] (−1 = padding row), kv_len [B] per-sequence KV length
    AFTER this pack, a paged cache (updated in place). Returns (logits at
    `last_rows` — [B, Vpad] for 1-D rows, [B, R, Vpad] for 2-D rows; garbage
    where rows < 0 — and the cache).

    `block_q` MUST be the granularity the caller aligned segments to (K4
    derives each block's sequence from it); None takes cfg.attn_block_q,
    which only the plain path may leave unset."""
    if not packed_mixers_ok(cfg):
        raise ValueError(f"{cfg.name}: packed step needs a pure global-attention stack")
    dev = params["embed"].device
    seq_ids = torch.as_tensor(seq_ids, device=dev).long()
    positions = torch.as_tensor(positions, device=dev).long()
    kv_len = torch.as_tensor(kv_len, device=dev).long()
    h = embed_lookup(params["embed"], torch.as_tensor(tokens, device=dev).long()[None],
                     cfg.compute_dtype)  # [1, T, D]
    bq = block_q if block_q is not None else cfg.attn_block_q

    def block_step(bp, bc, h, pattern):
        for j, (mixer, _) in enumerate(pattern):
            bpj = bp[f"pos{j}"]
            x = rms_norm(h, bpj["norm1"], cfg.norm_eps)
            h = h + _packed_attn(bpj["mixer"], x, cfg, mixer, bc[f"pos{j}"], positions,
                                 seq_ids, kv_len, bq)
            h = h + _apply_swiglu(bpj["ffn"], rms_norm(h, bpj["norm2"], cfg.norm_eps), cfg)
        return h

    h = _run_cached_groups(params, cache, h, cfg, block_step)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    rows = torch.as_tensor(last_rows, device=dev).long()
    sel = h[0, torch.clamp(rows, min=0)]  # [B, D] or [B, R, D]; rows < 0 garbage
    if rows.ndim == 1:
        return logits_from_hidden(sel[:, None], _head(params, cfg), cfg.vocab_size)[:, 0], cache
    return logits_from_hidden(sel, _head(params, cfg), cfg.vocab_size), cache
