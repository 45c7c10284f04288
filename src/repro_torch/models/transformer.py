"""Decoder LM — the port of `repro/models/transformer.py` for every
attention family of the reference: mixers `attn`, `attn_nope`,
`attn_bidir` (the full mask; decoded as global attention, as the
reference does), `attn_local` (sliding window), `attn_chunked` (causal
within chunks), `rglru` (`models/rglru.py`) and `ssm` (Mamba-2,
`models/mamba2.py`); FFNs `swiglu`, `moe` (`models/moe.py`) and `none`; the
vision frontend's stub (precomputed patch embeddings through `patch_proj`,
prepended to the tokens). `_qkv` / `_apply_attn` also take the
reference's `kv_x` and `kind="cross"`, which the encoder-decoder stack
(`models/encdec.py`) builds on.

Parameters are the reference's tree, a plain dict of tensors: `embed`,
`final_norm`, `lm_head`, and `blocks/pos{j}/...` (and `rem_blocks/pos{j}`
for the pattern's remainder) stacked on a leading layer axis. Where the
reference scans that axis, the port loops over it in Python; attention
runs through `repro_torch.core.attention` (on the card: the K1 kernel for
full sequences under the causal, local or chunked mask, K2 for decode on a
contiguous cache or a ring, K3 for decode on the paged pool, K4 for the
packed mixed step). MoE aux values are summed over layers as the
reference's scan sums them.

Caches: contiguous ([L, B, S, Hkv, hd] per layer group) or paged (a page
pool [L, P, page, Hkv, hd] per global-attention layer plus block tables
[L, B, N]; every paged layer holds the same table; a quantized pool stores
bytes with per-(page, kv head) scales [L, P, Hkv]). Local and chunked
layers keep a ring of min(max_len, window | chunk) slots, contiguous in
either layout: position p sits at slot p mod len, and decode reads the
first min(p + 1, len) slots (local) or p mod len + 1 (chunked) with no
window or chunk passed to the kernel — slot order is not position order.
RG-LRU layers keep lru_state [L, B, W] and conv_cache [L, B, K − 1, W];
Mamba-2 layers ssm_state [L, B, H, P, N] f32 and conv_cache [L, B, K − 1,
d_inner + 2N].

Caches are updated IN PLACE (`index_put` into the stacked tensors), where
the reference rebuilt them functionally, so decode and `forward_packed`
return the cache object they were given. A step writes global K/V only at
positions at or past each sequence's committed length and reads a
position only after writing it; ring slots and recurrent state it
overwrites are not restored by a re-run, so the serving engine backs them
up before a step and puts them back after a faulted one
(`undo_leaves`, `serve/engine.py`).
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
from repro_torch.distributed.context import maybe_cp_decode
from repro_torch.distributed.sharding import (
    P,
    activate,
    active_ctx,
    is_dtensor,
    placements,
    replicate_like,
    shard,
    shard_range,
    spec_for,
    vocab_island,
)
from repro_torch.models import mamba2 as m2
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rg
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
    "forward_hidden",
    "init_decode_cache",
    "decode_step_lm",
    "decode_hidden_lm",
    "logits_lm",
    "prefill_lm",
    "paged_mixers",
    "packed_mixers_ok",
    "forward_packed",
    "undo_leaves",
    "rows_interact",
]

_AUX_KEYS = moe_mod.AUX_KEYS
_RING_MIXERS = ("attn_local", "attn_chunked")
_STATE_MIXERS = ("rglru", "ssm")  # recurrent state: O(1) a sequence, advanced in place
_PORTED_MIXERS = ("attn", "attn_nope", "attn_bidir", *_RING_MIXERS, *_STATE_MIXERS)
_PORTED_FFNS = ("swiglu", "moe", "none")
_FRONTENDS = ("none", "vision", "audio")


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a layer kind or frontend outside the reference's lists."""
    if cfg.frontend not in _FRONTENDS:
        raise NotImplementedError(f"{cfg.name}: unknown frontend {cfg.frontend!r}; the port "
                                  f"runs {_FRONTENDS}")
    for mixer, ffn in (*cfg.pattern, *cfg.remainder):
        if mixer not in _PORTED_MIXERS or ffn not in _PORTED_FFNS:
            raise NotImplementedError(
                f"{cfg.name}: layer ({mixer}, {ffn}) is not a layer kind of the reference; "
                f"the port runs {_PORTED_MIXERS} with {_PORTED_FFNS}"
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


def _init_swiglu(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.master_dtype
    return {
        "wg": dense_init(gen, (d, f), dtype=dt),
        "wu": dense_init(gen, (d, f), dtype=dt),
        "wd": dense_init(gen, (f, d), dtype=dt),
    }


_MIXER_INIT = {"rglru": rg.init_rglru, "ssm": m2.init_mamba2}


def _init_block(gen: torch.Generator, cfg: ModelConfig, spec) -> dict:
    mixer, ffn = spec
    d, dt, dev = cfg.d_model, cfg.master_dtype, gen.device
    p = {"norm1": torch.zeros((d,), dtype=dt, device=dev),
         "mixer": _MIXER_INIT.get(mixer, _init_attn)(gen, cfg)}
    if ffn != "none":
        p["norm2"] = torch.zeros((d,), dtype=dt, device=dev)
        p["ffn"] = moe_mod.init_moe(gen, cfg) if ffn == "moe" else _init_swiglu(gen, cfg)
    return p


def _stack(trees):
    """Stack per-block trees on a new leading axis (one block: a view, so a
    single-block group of a full-width model is not held twice), leaf by
    leaf, taking each leaf out of the per-block trees as it goes: a leaf's
    per-block tensors are freed once stacked, so a full-width model is held
    once plus one stacked leaf (twice over, recurrentgemma-9b's 41.8 GB of
    f32 weights would not fit beside anything else on an 80 GB card)."""
    if isinstance(trees[0], dict):
        return {k: _stack([t.pop(k) for t in trees]) for k in list(trees[0])}
    return trees[0][None] if len(trees) == 1 else torch.stack(trees)


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
    if cfg.frontend == "vision":
        params["patch_proj"] = dense_init(gen, (cfg.d_model, cfg.d_model), dtype=dt)
    for key, pattern in _groups(cfg):
        n = cfg.n_blocks if key == "blocks" else 1
        params[key] = _stack([
            {f"pos{j}": _init_block(gen, cfg, spec) for j, spec in enumerate(pattern)}
            for _ in range(n)
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


def _qkv(p, x, cfg: ModelConfig, kind: str, positions, kv_x=None):
    """q from x, k and v from `kv_x` (default x). RoPE at `positions` for q
    and, when k comes from x, for k; a `kv_x` source is rotated over its
    own arange. `attn_nope` and `cross` take no RoPE."""
    cdt = cfg.compute_dtype
    hd = cfg.head_dim_
    b, s, _ = x.shape
    x = shard(x, "hidden")  # the sequence whole before the column-parallel products
    src = x if kv_x is None else shard(kv_x, "hidden")
    q = torch.matmul(x, p["wq"].to(cdt))
    k = torch.matmul(src, p["wk"].to(cdt))
    v = torch.matmul(src, p["wv"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
        k = k + p["bk"].to(cdt)
        v = v + p["bv"].to(cdt)
    q = _split_heads(q, cfg.n_heads, hd)
    k = _split_heads(k, cfg.n_kv_heads, hd)
    v = _split_heads(v, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if kind not in ("attn_nope", "cross"):
        q = apply_rope(q, positions, cfg.rope_theta)
        k_pos = positions if kv_x is None else torch.arange(src.shape[1], device=src.device)
        k = apply_rope(k, k_pos, cfg.rope_theta)
    return q, k, v


def _split_heads(x, h: int, hd: int):
    """[B, S, H·hd] → [B, S, H, hd]. A DTensor takes the heads spec first:
    an H·hd dim sharded over more ranks than H divides by cannot be
    unflattened."""
    b, s = x.shape[:2]
    if is_dtensor(x):
        spec = spec_for("heads", (b, s, h, hd))
        x = x.redistribute(x.device_mesh, placements(P(*spec[:3]), x.device_mesh))
    return x.reshape(b, s, h, hd)


def _attn_mask(cfg: ModelConfig, kind: str) -> MaskSpec:
    if kind in ("attn_bidir", "cross"):
        return MaskSpec("full")
    if kind == "attn_local":
        return MaskSpec("local", window=cfg.attn_window)
    if kind == "attn_chunked":
        return MaskSpec("chunked", chunk=cfg.attn_chunk)
    return MaskSpec("causal")


def _apply_attn(p, x, cfg: ModelConfig, kind: str, positions, kv_x=None):
    q, k, v = _qkv(p, x, cfg, kind, positions, kv_x)
    q, k, v = shard(q, "heads"), shard(k, "heads"), shard(v, "heads")
    o = flash_attention(
        q, k, v, mask=_attn_mask(cfg, kind), impl=cfg.attn_impl,
        block_q=cfg.attn_block_q, block_k=cfg.attn_block_k, skip=cfg.attn_skip,
    )
    o = shard(o, "heads")
    b, s = x.shape[:2]
    o = o.reshape(b, s, cfg.n_heads * cfg.head_dim_)
    if is_dtensor(o):
        # the sequence whole (a split one — the ring's output, or the heads
        # spec at a batch too small to split — cannot be flattened by the
        # product on the card's torch), then pinned to those placements: the
        # backward brings the gradient back to them before un-merging the
        # heads (a gradient sharded over more ranks than H divides by cannot
        # be unflattened)
        from torch.distributed.tensor import Replicate

        o = o.redistribute(o.device_mesh, tuple(Replicate() if p.is_shard(1) else p
                                                for p in o.placements))
    return torch.matmul(o, p["wo"].to(cfg.compute_dtype))


def _apply_swiglu(p, x, cfg: ModelConfig):
    cdt = cfg.compute_dtype
    x = shard(x, "hidden")
    g = torch.matmul(x, p["wg"].to(cdt))
    u = torch.matmul(x, p["wu"].to(cdt))
    return torch.matmul(shard(torch.nn.functional.silu(g) * u, "ff"), p["wd"].to(cdt))


def _apply_ffn(bp: dict, h, cfg: ModelConfig, ffn: str):
    """The block's FFN half with its pre-norm and residual → (h, aux: the
    MoE aux values [3] f32 in `_AUX_KEYS` order, None for other FFNs)."""
    if ffn == "none":
        return h, None
    x = rms_norm(h, bp["norm2"], cfg.norm_eps)
    if ffn == "swiglu":
        return shard(h + _shard_out(_apply_swiglu(bp["ffn"], x, cfg)), "residual"), None
    y, aux = moe_mod.apply_moe(bp["ffn"], x, cfg)
    return shard(h + _shard_out(y), "residual"), torch.stack([aux[k] for k in _AUX_KEYS])


def _shard_out(y):
    """Reduce-scatter placement: a row-parallel output constrained to the
    seq-sharded residual spec (identity with no sharding context)."""
    ctx = active_ctx()
    if ctx is not None and getattr(ctx, "rs_outputs", False):
        return shard(y, "residual")
    return y


def _apply_block(bp: dict, h, cfg: ModelConfig, spec, positions):
    """One (mixer, ffn) block with pre-norms and residuals → (h, aux [3] or
    None), as `_apply_ffn`."""
    mixer, ffn = spec
    x = shard(rms_norm(h, bp["norm1"], cfg.norm_eps), "hidden")
    if mixer == "rglru":
        y = rg.apply_rglru(bp["mixer"], x, cfg)
    elif mixer == "ssm":
        y = m2.apply_mamba2(bp["mixer"], x, cfg)
    else:
        y = _apply_attn(bp["mixer"], x, cfg, mixer, positions)
    return _apply_ffn(bp, shard(h + _shard_out(y), "residual"), cfg, ffn)


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


def _embed_inputs(params: dict, batch: Dict, cfg: ModelConfig):
    """Token embedding, with the vision stub's patch rows first when the
    batch holds `patch_embeds` [B, P, D]: projected by `patch_proj` in the
    compute dtype and prepended (the reference's `_embed_inputs`)."""
    cdt = cfg.compute_dtype
    h = embed_lookup(params["embed"], batch["tokens"], cdt)
    if cfg.frontend == "vision" and "patch_embeds" in batch:
        patches = torch.matmul(batch["patch_embeds"].to(cdt), params["patch_proj"].to(cdt))
        h = torch.cat([patches, h], dim=1)
    return h


def forward_hidden(params: dict, batch: Dict, cfg: ModelConfig):
    """The stack without the LM head → (final-normed hidden [B, S, D], aux
    dict of f32 scalars: each MoE value summed over the layers of a group
    from zero, then over the groups, as the reference's scans sum them).
    S counts a vision batch's patch rows; positions run over all of it.
    Under autograd each block is rematerialized as `cfg.remat` says."""
    check_ported(cfg)
    h = shard(_embed_inputs(params, batch, cfg), "residual")
    positions = torch.arange(h.shape[1], device=h.device)
    block = _remat(_apply_block, cfg)
    aux = replicate_like(torch.zeros((len(_AUX_KEYS),), dtype=torch.float32, device=h.device), h)
    for key, pattern in _groups(cfg):
        acc = torch.zeros_like(aux)
        for i in range(params[key]["pos0"]["norm1"].shape[0]):
            bp = _index(params[key], i)
            for j, spec in enumerate(pattern):
                h, a = block(bp[f"pos{j}"], h, cfg, spec, positions)
                if a is not None:
                    acc = acc + a
        aux = aux + acc
    return rms_norm(h, params["final_norm"], cfg.norm_eps), dict(zip(_AUX_KEYS, aux.unbind()))


def apply_lm(params: dict, batch: Dict, cfg: ModelConfig, *, last_only: bool = False):
    """Forward pass → (logits [B, S, Vpad] f32, aux dict of f32 scalars).

    last_only=True returns logits for the final position only — the
    reference's prefill forward."""
    h, aux = forward_hidden(params, batch, cfg)
    if last_only:
        h = h[:, -1:]
    h = shard(h, "hidden")
    return shard(logits_from_hidden(h, _head(params, cfg), cfg.vocab_size), "logits"), aux


def lm_loss(params: dict, batch: Dict, cfg: ModelConfig):
    """Causal-LM cross entropy + the MoE aux and z losses → (loss, metrics:
    ce and the three aux values); labels == −1 are masked; the logits of a
    modality prefix (the vision stub's patch rows) are dropped first.
    Differentiable."""
    logits, aux = apply_lm(params, batch, cfg)
    labels = batch["labels"]
    if logits.shape[1] != labels.shape[1]:
        logits = logits[:, logits.shape[1] - labels.shape[1]:]
    ce = masked_ce(logits, labels)
    loss = ce + aux["moe_aux_loss"] + aux["moe_z_loss"]
    return loss, {"ce": ce, **aux}


def _gold_rows(logits, labels, first: int, rows: int):
    """The logit at each label in [first, first + rows) of the vocab shard;
    zero elsewhere."""
    j = labels.long() - first
    ok = (j >= 0) & (j < rows)
    gold = torch.gather(logits, -1, torch.where(ok, j, 0)[..., None])[..., 0]
    return torch.where(ok, gold, 0.0)


def masked_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy of logits [B, S, V] at labels [B, S] over the
    labels ≥ 0 (−1 masks a position).

    Vocab-sharded DTensor logits take the vocab-parallel log-sum-exp (a
    max and a sum of exponentials reduced across the shards, never the
    full logits on one rank) and the gold logit from each rank's vocab
    shard (`sharding.vocab_island`)."""
    mask = (labels >= 0).float()
    safe = torch.clamp(labels, min=0)
    if is_dtensor(logits):
        m = logits.detach().amax(dim=-1, keepdim=True)
        lse = torch.log(torch.sum(torch.exp(logits - m), dim=-1)) + m[..., 0]
    else:
        lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits) and any(p.is_shard(2) for p in logits.placements):
        gold = vocab_island(_gold_rows, logits, 2, safe)
    else:
        gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# serving: contiguous per-layer caches + one-token decode
# ---------------------------------------------------------------------------

def paged_mixers(cfg: ModelConfig):
    """Mixer kinds that take the paged layout: full-length (global)
    attention caches only. Local and chunked layers keep their ring (the
    dense packing of what the layer can see), RG-LRU and Mamba-2 their O(1)
    state. A stack with none (mamba2) takes no pool: its engine serves on
    the contiguous loop, as the reference's does."""
    return tuple(
        m for m, _ in (*cfg.pattern, *cfg.remainder)
        if m.startswith("attn") and m not in _RING_MIXERS
    )


def packed_mixers_ok(cfg: ModelConfig) -> bool:
    """Can this stack run the packed varlen mixed step? Every mixer must
    read and write per-sequence state through the paged cache alone:
    global causal attention ('attn', 'attn_nope'). Ring and recurrent
    layers carry sequential state a packed step cannot replay row by row,
    so engines fall back to the sequential loops for those stacks."""
    return all(m in ("attn", "attn_nope") for m, _ in (*cfg.pattern, *cfg.remainder))


def _ring_len(cfg: ModelConfig, mixer: str, max_len: int) -> int:
    """Slots of a layer's contiguous K/V region: the window or chunk for
    ring layers (capped at max_len), max_len for global ones."""
    if mixer == "attn_local" and cfg.attn_window:
        return min(max_len, cfg.attn_window)
    if mixer == "attn_chunked" and cfg.attn_chunk:
        return min(max_len, cfg.attn_chunk)
    return max_len


def init_decode_cache(batch: int, max_len: int, cfg: ModelConfig, *,
                      layout: str = "contiguous", page_size: Optional[int] = None,
                      n_pages: Optional[int] = None, kv_dtype: str = "", device=None) -> dict:
    """Zeroed decode caches in the reference's tree {'blocks' | 'rem_blocks':
    {'pos{j}': ...}}, in the compute dtype, a leading layer axis on every
    leaf.

    Attention layers: {'k', 'v'} [n, batch, S, Hkv, hd] with S = max_len for
    global layers and the ring length (`_ring_len`) for local / chunked
    ones. RG-LRU layers: {'lru_state' [n, batch, W] f32, 'conv_cache' [n,
    batch, K − 1, W]}; Mamba-2 layers: {'ssm_state' [n, batch, H, P, N] f32,
    'conv_cache' [n, batch, K − 1, d_inner + 2N]}.

    layout="paged" gives each GLOBAL attention layer {'k_pages', 'v_pages'}
    [n, P, page, Hkv, hd] and 'tbl' [n, batch, N] int32 (N = ⌈max_len /
    page⌉), every row starting on the garbage page 0, instead; ring and
    recurrent layers stay as above in the same tree. A stack with no global
    layer has no pool (all contiguous). The geometry comes from
    `tuning.choose_page_layout`, sized at (n_pages − 1)·page_size tokens
    when both are given, else at batch·max_len — as the reference.

    kv_dtype ∈ `quant.available()` stores the pools in that one-byte
    format with per-(page, kv head) f32 scale leaves 'k_scale' / 'v_scale'
    [n, P, Hkv], 1.0 on never-written pages; "" keeps the compute dtype.
    Only paged pools quantize (ValueError for layout="contiguous")."""
    from repro_torch.runtime import quant  # lazy: no cycle

    check_ported(cfg)
    if layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    kv_spec = quant.get_spec(kv_dtype)
    if kv_spec is not None and layout != "paged":
        raise ValueError("kv_dtype quantization requires layout='paged'")
    dev = resolve_device(device)
    geom = None
    if layout == "paged" and paged_mixers(cfg):
        from repro_torch.kernels.tuning import choose_page_layout  # lazy: no cycle

        pl_ = choose_page_layout(
            max_len, cfg.head_dim_, cfg.head_dim_,
            group=cfg.n_heads // cfg.n_kv_heads,
            pool_tokens=(n_pages - 1) * page_size if (n_pages and page_size)
            else batch * max_len,
            page_size=page_size,
            kv_itemsize=quant.kv_itemsize(kv_dtype),
        )
        geom = (pl_.n_pages, pl_.page_size, pl_.pages_per_seq)

    def layer(n: int, mixer: str) -> dict:
        dt = cfg.compute_dtype
        if mixer == "rglru":
            return rg.init_rglru_cache(batch, cfg, dt, n=n, device=dev)
        if mixer == "ssm":
            return m2.init_mamba2_cache(batch, cfg, dt, n=n, device=dev)
        if geom is None or mixer in _RING_MIXERS:
            shape = (n, batch, _ring_len(cfg, mixer, max_len), cfg.n_kv_heads, cfg.head_dim_)
            return {"k": torch.zeros(shape, dtype=dt, device=dev),
                    "v": torch.zeros(shape, dtype=dt, device=dev)}
        n_p, page, per_seq = geom
        pshape = (n, n_p, page, cfg.n_kv_heads, cfg.head_dim_)
        pool_dt = dt if kv_spec is None else kv_spec.dtype
        leaves = {
            "k_pages": torch.zeros(pshape, dtype=pool_dt, device=dev),
            "v_pages": torch.zeros(pshape, dtype=pool_dt, device=dev),
            "tbl": torch.zeros((n, batch, per_seq), dtype=torch.int32, device=dev),
        }
        if kv_spec is not None:
            for name in ("k_scale", "v_scale"):
                leaves[name] = torch.ones((n, n_p, cfg.n_kv_heads), dtype=torch.float32,
                                          device=dev)
        return leaves

    cache: dict = {}
    for key, pattern in _groups(cfg):
        n = cfg.n_blocks if key == "blocks" else 1
        cache[key] = {f"pos{j}": layer(n, mixer) for j, (mixer, _) in enumerate(pattern)}
    return cache


# pool leaves (no batch axis; the physical page axis at 1): the pages and a
# quantized pool's scale side-band, so page copies move bytes and scales
# together and the pool's footprint counts both
POOL_LEAVES = ("k_pages", "v_pages", "k_scale", "v_scale")


def cache_leaves(tree: dict):
    """(leaf name, tensor) pairs of a cache tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from cache_leaves(v)
        else:
            yield k, v


def rows_interact(cfg: ModelConfig) -> bool:
    """Does one row of a step change another's output? Yes on an MoE stack:
    every row of a call, dead slots and padding rows included, competes for
    the experts' capacity."""
    return any(f == "moe" for _, f in (*cfg.pattern, *cfg.remainder))


def undo_leaves(cache: dict, cfg: ModelConfig) -> list:
    """The cache tensors a serving step overwrites where a re-run of the
    step would not rewrite them first: ring K/V and RG-LRU and Mamba-2
    state (a ring slot may be overwritten by a later position of the same
    chunk before an earlier one reads it; a recurrence applied twice is
    wrong). On an MoE stack rows interact (capacity is shared by every row
    of a step, dead slots and padding rows included), so the garbage that
    dead slots read must be the reference's too: every per-batch leaf and
    page 0 of each pool (views) join the list. The engine copies them aside
    before a step and back after a faulted one — the reference discards
    the whole new cache."""
    moe = rows_interact(cfg)
    out = []
    for key, pattern in _groups(cfg):
        for j, (mixer, _) in enumerate(pattern):
            layer = cache[key][f"pos{j}"]
            for name, leaf in layer.items():
                if name in POOL_LEAVES:
                    if moe:
                        out.append(leaf[:, 0])
                elif name != "tbl" and (moe or mixer in _RING_MIXERS or mixer in _STATE_MIXERS):
                    out.append(leaf)
    return out


def _decode_attn(p, x, cfg: ModelConfig, kind: str, cache, pos):
    """One-token attention against the cache; writes this token's K/V in
    place at slot pos % len (contiguous and ring regions) or through the
    block table (paged). pos [B] absolute position. A ring is read over
    its first min(pos + 1, len) slots (local) or pos % len + 1 (chunked),
    with no window or chunk passed on: the slots are not in position
    order. A sequence-sharded cache (context parallel) is read through
    `maybe_cp_decode` — each rank's shard partial (K2 on the kernel
    route), merged across ranks — and any other DTensor cache on each
    rank's shard (`_on_cache_shards`)."""
    b = x.shape[0]
    q, k, v = _qkv(p, x, cfg, kind, pos[:, None])
    if "k_pages" in cache:
        o = _paged_attn_step(q, k, v, cfg, cache, pos)
        return torch.matmul(o.reshape(b, 1, cfg.n_heads * cfg.head_dim_),
                            p["wo"].to(cfg.compute_dtype))
    k_cache, v_cache = cache["k"], cache["v"]  # [B, S_max, Hkv, hd] views
    s_len = k_cache.shape[1]
    write_idx = pos % s_len
    _write_rows(k_cache, v_cache, k, v, write_idx)
    if kind == "attn_local":
        eff_len = torch.clamp(pos + 1, max=s_len)
    elif kind == "attn_chunked":
        eff_len = write_idx + 1
    else:
        eff_len = pos + 1
    use_kernel = uses_kernel(cfg.attn_impl, x)
    o = maybe_cp_decode(q, k_cache, v_cache, eff_len, use_kernel=use_kernel)
    if o is None:
        o = _on_cache_shards(_decode_rows if use_kernel else decode_attention,
                             q, k_cache, v_cache, eff_len)
    o = o.reshape(b, 1, cfg.n_heads * cfg.head_dim_)
    return torch.matmul(o, p["wo"].to(cfg.compute_dtype))


def _decode_rows(q, k_cache, v_cache, eff_len):
    from repro_torch.kernels import ops  # lazy: no cycle

    return ops.get_op("decode")(q, k_cache, v_cache, eff_len)


def _beside_cache(cache):
    """Placements for the operands of a step on DTensor cache [B, S, H, hd]'s
    shards: (those of [B, ·, H, ·] rows — the cache's with the sequence
    whole —, those of a [B] vector)."""
    from torch.distributed.tensor import Replicate, Shard

    rows = tuple(Replicate() if p.is_shard(1) else p for p in cache.placements)
    batch = tuple(Shard(0) if p.is_shard(0) else Replicate() for p in cache.placements)
    return rows, batch


def _write_rows(k_cache, v_cache, k, v, write_idx) -> None:
    """This token's K / V [B, 1, Hkv, hd] into slot write_idx [B] of the
    caches, in place. A DTensor cache is written on each rank's local
    shard: a row whose slot lies in another rank's sequence range writes
    back what the rank's clamped slot already holds."""
    if not is_dtensor(k_cache):
        bidx = torch.arange(k.shape[0], device=k.device)
        k_cache[bidx, write_idx] = k[:, 0]
        v_cache[bidx, write_idx] = v[:, 0]
        return
    mesh = k_cache.device_mesh
    rows_pl, batch_pl = _beside_cache(k_cache)
    w = replicate_like(write_idx, k_cache).redistribute(mesh, batch_pl).to_local()
    first, n = shard_range(k_cache, 1)
    here = ((w >= first) & (w < first + n))[:, None, None]
    slot = torch.clamp(w - first, 0, n - 1)
    for cache, new in ((k_cache, k), (v_cache, v)):
        local = cache.to_local()  # the DTensor's own storage: written in place
        new = new.redistribute(mesh, rows_pl).to_local()[:, 0]
        bidx = torch.arange(local.shape[0], device=local.device)
        local[bidx, slot] = torch.where(here, new, local[bidx, slot])


def _on_cache_shards(fn, q, k_cache, v_cache, eff_len):
    """`fn(q, k_cache, v_cache, eff_len)` → o [B, 1, Hq, dv]; on a DTensor
    cache, on each rank's batch and head shard of plain local tensors (the
    sequence gathered if it was split), with no sharding context active
    inside."""
    if not is_dtensor(k_cache):
        return fn(q, k_cache, v_cache, eff_len)
    from torch.distributed.tensor.experimental import local_map

    rows_pl, batch_pl = _beside_cache(k_cache)

    def local(q_, k_, v_, l_):
        with activate(None):
            return fn(q_.contiguous(), k_, v_, l_)

    return local_map(local, out_placements=(rows_pl,), in_placements=(rows_pl, rows_pl, rows_pl,
                                                                      batch_pl),
                     device_mesh=k_cache.device_mesh, redistribute_inputs=True)(
        q, k_cache, v_cache, replicate_like(eff_len, k_cache))


def _last_writer(dest: torch.Tensor) -> torch.Tensor:
    """For each row of a scatter to indices `dest`, the last row with the
    same index. Taking every row's value from it makes duplicate indices
    write one value, so the scatter stores what a sequential one stores
    (the last write) in whatever order the card applies them."""
    s, order = torch.sort(dest, stable=True)
    return order[torch.searchsorted(s, dest, right=True) - 1]


def _write_pool(cache, k_new, v_new, pid, slot, is_slot0, cfg: ModelConfig) -> None:
    """Write rows k_new / v_new [N, Hkv, hd] at (page pid, slot) of the
    pool, in place. A quantized pool (scale leaves) first scatters the
    slot-0 rows' page scales (`quant.slot0_scale`; every other row is
    routed to the garbage page 0, whose scale no live row reads), then
    quantizes every row with its page's updated scale — so a call that
    writes slot 0 and later slots of one page stores what the sequential
    write order stores (the reference's rule). Only page 0 takes duplicate
    indices (dead slots, padding rows), which an in-place scatter on the
    card lands in any order; on an MoE stack the dead rows that read page
    0 feed the router, so there each duplicate writes its last writer's
    value (`_last_writer`) and page 0 holds what the reference's does."""
    dedupe = rows_interact(cfg)
    k_scale = cache.get("k_scale")
    if k_scale is not None:
        from repro_torch.runtime import quant  # lazy: no cycle

        spec = quant.spec_for_dtype(cache["k_pages"].dtype)
        spid = torch.where(is_slot0, pid, 0)
        sw = _last_writer(spid) if dedupe else None
        for rows, name in ((k_new, "k_scale"), (v_new, "v_scale")):
            leaf = cache[name]
            val = torch.where(is_slot0[:, None], quant.slot0_scale(rows, spec), leaf[0])
            leaf[spid] = val if sw is None else val[sw]
        k_new = quant.quantize_rows(k_new, k_scale[pid], spec)
        v_new = quant.quantize_rows(v_new, cache["v_scale"][pid], spec)
    if dedupe:
        w = _last_writer(pid * cache["k_pages"].shape[1] + slot)
        k_new, v_new = k_new[w], v_new[w]
    cache["k_pages"][pid, slot] = k_new
    cache["v_pages"][pid, slot] = v_new


def _paged_attn_step(q, k, v, cfg: ModelConfig, cache, pos):
    """One-token attention against a paged cache: write the new K/V in place
    into the position's physical page through the block table (quantized
    by the slot-0 rule on a quantized pool, `_write_pool`), then attend
    through the table (K3 on the card). Writes past the table (dead slots
    whose `pos` keeps advancing in the lockstep batch) land on the garbage
    page 0. → o [B, 1, Hq, hd].

    Under a sharding context, as the reference: the pages are gathered
    into the [B, S, Hkv, hd] shape the rules engine reasons about, and a
    sequence-sharded one is read through `maybe_cp_decode`. A DTensor pool
    must be replicated; the step then runs on each rank's whole copy and
    returns a replicated DTensor."""
    if is_dtensor(cache["k_pages"]):
        from torch.distributed.tensor import DTensor, Replicate

        mesh = cache["k_pages"].device_mesh
        whole = [Replicate()] * mesh.ndim
        if any(tuple(leaf.placements) != tuple(whole) for leaf in cache.values()):
            raise ValueError("a paged pool under a sharding context must be replicated")
        local = {name: leaf.to_local() for name, leaf in cache.items()}
        q, k, v, pos = (replicate_like(x, q).redistribute(mesh, whole).to_local()
                        for x in (q, k, v, pos))
        o = _paged_attn_step(q, k, v, cfg, local, pos)
        return DTensor.from_local(o, mesh, whole, run_check=False)
    b = q.shape[0]
    k_pages, v_pages, tbl = cache["k_pages"], cache["v_pages"], cache["tbl"]
    page, n_tbl = k_pages.shape[1], tbl.shape[1]
    bidx = torch.arange(b, device=q.device)
    page_idx = torch.div(pos, page, rounding_mode="floor")
    pid = torch.where(page_idx < n_tbl, tbl[bidx, torch.clamp(page_idx, max=n_tbl - 1)], 0).long()
    slot = pos % page
    _write_pool(cache, k[:, 0], v[:, 0], pid, slot, slot == 0, cfg)
    eff_len = pos + 1
    scales = dict(k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
    if active_ctx() is not None:
        from repro_torch.core.attention import _zero_past, gather_pages  # lazy: no cycle

        o = maybe_cp_decode(q, _zero_past(gather_pages(k_pages, tbl, scales["k_scale"]), eff_len),
                            _zero_past(gather_pages(v_pages, tbl, scales["v_scale"]), eff_len),
                            eff_len, use_kernel=uses_kernel(cfg.attn_impl, q))
        if o is not None:
            return o
    if uses_kernel(cfg.attn_impl, q):
        from repro_torch.kernels import ops  # lazy: no cycle

        return ops.get_op("decode_paged")(q, k_pages, v_pages, tbl, eff_len, **scales)
    return decode_attention_paged(q, k_pages, v_pages, tbl, eff_len, **scales)


def _decode_block(bp, h, cfg: ModelConfig, spec, cache, pos):
    mixer, ffn = spec
    x = rms_norm(h, bp["norm1"], cfg.norm_eps)
    if mixer == "rglru":
        h = h + rg.decode_rglru(bp["mixer"], x, cache, cfg)
    elif mixer == "ssm":
        h = h + m2.decode_mamba2(bp["mixer"], x, cache, cfg)
    else:
        h = h + _decode_attn(bp["mixer"], x, cfg, mixer, cache, pos)
    return _apply_ffn(bp, h, cfg, ffn)[0]


def _run_cached_groups(params: dict, cache: dict, h, cfg: ModelConfig, block_step):
    """Run every stacked block group through `block_step(bp, bc, h, pattern)
    → h`, layer by layer; `bc` holds views of the stacked cache, so the
    step's writes land in `cache` itself."""
    for key, pattern in _groups(cfg):
        for i in range(next(iter(cache[key]["pos0"].values())).shape[0]):  # layer axis
            h = block_step(_index(params[key], i), _index(cache[key], i), h, pattern)
    return h


def _decode_hidden(params, cache, token, pos, cfg: ModelConfig):
    """Final-normed hidden state [B, 1, D] of one decode step. With DTensor
    parameters, a plain token is taken as replicated (pos stays plain: the
    rope tables and the cache islands take it so)."""
    token = replicate_like(token, params["embed"])
    h = embed_lookup(params["embed"], token[:, None], cfg.compute_dtype)

    def block_step(bp, bc, h, pattern):
        for j, spec in enumerate(pattern):
            h = _decode_block(bp[f"pos{j}"], h, cfg, spec, bc[f"pos{j}"], pos)
        return h

    h = _run_cached_groups(params, cache, h, cfg, block_step)
    return rms_norm(h, params["final_norm"], cfg.norm_eps)


def decode_hidden_lm(params: dict, cache: dict, token: torch.Tensor, pos: torch.Tensor,
                     cfg: ModelConfig) -> torch.Tensor:
    """One decode step without the LM head: token [B], pos [B] → the
    final-normed hidden state [B, 1, D], the cache updated in place (the
    step the engine's prefill runs once per prompt position)."""
    return _decode_hidden(params, cache, token, pos.long(), cfg)


def logits_lm(params: dict, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The LM head on final-normed hidden states [B, 1, D] → f32 logits [B, Vpad]
    (plain h beside DTensor parameters is taken as replicated)."""
    h = replicate_like(h, params["embed"])
    return logits_from_hidden(h, _head(params, cfg), cfg.vocab_size)[:, 0]


def decode_step_lm(params: dict, cache: dict, token: torch.Tensor, pos: torch.Tensor,
                   cfg: ModelConfig):
    """One decode step. token [B], pos [B] → (logits [B, Vpad], cache), the
    cache updated in place."""
    return logits_lm(params, decode_hidden_lm(params, cache, token, pos, cfg), cfg), cache


def prefill_lm(params: dict, tokens: torch.Tensor, cache: dict, cfg: ModelConfig,
               *, start_pos: int = 0, lengths: Optional[torch.Tensor] = None):
    """Prefill a decode cache by running the decode step over the prompt, one
    position at a time — exact: the cache equals incremental decoding.
    Returns (logits of the last prompt token [B, Vpad], cache).

    start_pos > 0 prefills a tail at positions [start_pos, start_pos + s),
    the cache already holding the first start_pos positions.

    lengths [B] (each row's real token count ≤ s): past its length a row
    still steps (it feeds an MoE router like any other row), and then its
    per-batch leaves — contiguous and ring K/V, RG-LRU and Mamba-2 state —
    go back to what they held before the step (the reference's
    `_freeze_dead_rows`; pool leaves keep the writes, which land past the
    row's length). Its
    logits are those of position lengths − 1: the hidden state is captured
    there and the LM head runs once at the end, which gives the logits the
    reference computes per step."""
    b, s = tokens.shape
    dev = tokens.device
    const = lambda x: replicate_like(x, params["embed"])  # noqa: E731 — DTensor params
    tokens = const(tokens)
    full = s  # steps before this one keep every row
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=dev).reshape(b)
        full = int(lengths.min())
        lengths = const(lengths)
    h_last = const(torch.zeros((b, 1, cfg.d_model), dtype=cfg.compute_dtype, device=dev))
    seen = const(torch.zeros((b,), dtype=torch.bool, device=dev))
    rows = [leaf for name, leaf in cache_leaves(cache) if name not in POOL_LEAVES]
    for t in range(s):
        pos = torch.full((b,), start_pos + t, dtype=torch.long, device=dev)
        old = None if t < full else [leaf.clone() for leaf in rows]
        h = _decode_hidden(params, cache, tokens[:, t], pos, cfg)
        if old is not None:  # rows past their length: the step's writes are undone
            alive = t < lengths
            for leaf, was in zip(rows, old):
                leaf.copy_(torch.where(alive.reshape((1, -1) + (1,) * (leaf.ndim - 2)), leaf, was))
        take = (torch.ones_like(seen) if lengths is None else t == lengths - 1)
        h_last = torch.where(take[:, None, None], h, h_last)
        seen = seen | take
    return torch.where(seen[:, None], logits_lm(params, h_last, cfg), 0.0), cache


# ---------------------------------------------------------------------------
# serving: the packed varlen step (prefill chunks and decode rows together)
# ---------------------------------------------------------------------------

def _packed_attn(p, x, cfg: ModelConfig, kind: str, cache, positions, seq_ids, kv_len,
                 block_q: Optional[int]):
    """Packed varlen attention for one layer: write the pack's new K/V in
    place into each row's physical page through the block table (padding
    rows — seq_ids or positions < 0 — and rows past the table write the
    garbage page 0; a quantized pool by the slot-0 rule, `_write_pool`),
    then attend the pack through `varlen_attention` (K4 on the card).
    x [1, T, D]; positions / seq_ids [T]; kv_len [B]."""
    t = x.shape[1]
    q, k, v = _qkv(p, x, cfg, kind, positions[None])
    k_pages, v_pages, tbl = cache["k_pages"], cache["v_pages"], cache["tbl"]
    page, n_tbl = k_pages.shape[1], tbl.shape[1]
    sid = torch.clamp(seq_ids, min=0)
    page_idx = torch.div(positions, page, rounding_mode="floor")
    in_tbl = (seq_ids >= 0) & (positions >= 0) & (page_idx < n_tbl)
    pid = torch.where(in_tbl, tbl[sid, torch.clamp(page_idx, 0, n_tbl - 1)], 0).long()
    slot = torch.where(positions >= 0, positions % page, 0)
    _write_pool(cache, k[0], v[0], pid, slot, (slot == 0) & in_tbl, cfg)
    o = varlen_attention(q[0], k_pages, v_pages, tbl, seq_ids, positions, kv_len,
                         impl=cfg.attn_impl, block_q=block_q,
                         k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"))
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
        for j, (mixer, ffn) in enumerate(pattern):
            bpj = bp[f"pos{j}"]
            x = rms_norm(h, bpj["norm1"], cfg.norm_eps)
            h = h + _packed_attn(bpj["mixer"], x, cfg, mixer, bc[f"pos{j}"], positions,
                                 seq_ids, kv_len, bq)
            h = _apply_ffn(bpj, h, cfg, ffn)[0]
        return h

    h = _run_cached_groups(params, cache, h, cfg, block_step)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    rows = torch.as_tensor(last_rows, device=dev).long()
    sel = h[0, torch.clamp(rows, min=0)]  # [B, D] or [B, R, D]; rows < 0 garbage
    if rows.ndim == 1:
        return logits_from_hidden(sel[:, None], _head(params, cfg), cfg.vocab_size)[:, 0], cache
    return logits_from_hidden(sel, _head(params, cfg), cfg.vocab_size), cache
