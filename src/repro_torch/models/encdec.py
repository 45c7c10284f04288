"""Encoder-decoder transformer (the seamless-m4t backbone) — the port of
`repro/models/encdec.py`.

Encoder: bidirectional attention blocks (`attn_bidir`, the full mask, RoPE)
over precomputed audio-frame embeddings — the modality frontend is a stub:
frames enter as [B, T, d_model] and pass `frame_proj`. Decoder: causal
self attention, cross attention to the encoder output (`kind="cross"`: the
full mask, no RoPE, K/V from the memory), SwiGLU. On the card the three
attentions of the forward are K1 (or K6 under `attn_impl` fa2) with the
full or causal mask, Sq ≠ Skv for cross attention, and their gradients K5;
both attentions of a decode step are K2 (a contiguous cache with a
per-row length), as in `transformer.decode_step_lm`. The training forward
carries the reference's `residual` / `logits` shard points (identities with
no sharding context).

Parameters are the reference's tree: `embed`, `frame_proj`, `enc_blocks`
and `dec_blocks` stacked on a leading layer axis (each decoder block adds
`norm_cross` and `cross`), `enc_norm`, `final_norm`, `lm_head`. The decode
cache is {'self_k', 'self_v' [L, B, S, Hkv, hd]; 'cross_k', 'cross_v' [L,
B, T, Hkv, hd]}; a step writes its self K/V in place at `pos`, where the
reference rebuilt the cache, and `fill_cross_cache` replaces the cross
leaves with tensors of the memory's length T, as the reference's does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core.attention import decode_attention, uses_kernel
from repro_torch.devices import resolve_device
from repro_torch.distributed.sharding import replicate_like, shard
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dense_init, embed_lookup, logits_from_hidden, rms_norm
from repro_torch.models.transformer import (
    _AUX_KEYS,
    _apply_attn,
    _apply_ffn,
    _decode_attn,
    _index,
    _init_attn,
    _init_block,
    _remat,
    _stack,
    masked_ce,
)

__all__ = [
    "init_encdec",
    "encode",
    "apply_encdec",
    "encdec_loss",
    "init_encdec_cache",
    "fill_cross_cache",
    "decode_step_encdec",
]

_ENC_SPEC = ("attn_bidir", "swiglu")


def _init_dec_block(gen: torch.Generator, cfg: ModelConfig) -> dict:
    p = _init_block(gen, cfg, ("attn", "swiglu"))
    p["norm_cross"] = torch.zeros((cfg.d_model,), dtype=cfg.master_dtype, device=gen.device)
    p["cross"] = _init_attn(gen, cfg)
    return p


def init_encdec(cfg: ModelConfig, *, device=None, seed: int = 0,
                generator: Optional[torch.Generator] = None) -> dict:
    """Random weights in the reference's tree, drawn on `device` (default the
    card) from `generator` (default: a new one seeded with `seed`), as
    `transformer.init_lm`."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(device=dev).manual_seed(seed)
    if gen.device.type != dev.type:
        raise ValueError(f"generator on {gen.device} for parameters on {dev}")
    d, dt = cfg.d_model, cfg.master_dtype
    return {
        "embed": dense_init(gen, (cfg.padded_vocab, d), scale=0.02, dtype=dt),
        "frame_proj": dense_init(gen, (d, d), dtype=dt),
        "enc_blocks": _stack([_init_block(gen, cfg, _ENC_SPEC)
                              for _ in range(cfg.n_encoder_layers)]),
        "dec_blocks": _stack([_init_dec_block(gen, cfg) for _ in range(cfg.n_layers)]),
        "enc_norm": torch.zeros((d,), dtype=dt, device=dev),
        "final_norm": torch.zeros((d,), dtype=dt, device=dev),
        "lm_head": dense_init(gen, (d, cfg.padded_vocab), dtype=dt),
    }


def _n_layers(blocks: dict) -> int:
    return blocks["norm1"].shape[0]


def _enc_block(bp: dict, h, cfg: ModelConfig, positions):
    x = rms_norm(h, bp["norm1"], cfg.norm_eps)
    h = shard(h + _apply_attn(bp["mixer"], x, cfg, "attn_bidir", positions), "residual")
    return _apply_ffn(bp, h, cfg, "swiglu")[0]


def _dec_block(bp: dict, h, memory, cfg: ModelConfig, positions):
    x = rms_norm(h, bp["norm1"], cfg.norm_eps)
    h = shard(h + _apply_attn(bp["mixer"], x, cfg, "attn", positions), "residual")
    x = rms_norm(h, bp["norm_cross"], cfg.norm_eps)
    h = shard(h + _apply_attn(bp["cross"], x, cfg, "cross", positions, kv_x=memory), "residual")
    return _apply_ffn(bp, h, cfg, "swiglu")[0]


def encode(params: dict, frame_embeds: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frame_embeds [B, T, D] (the stub frontend's output) → memory [B, T, D]
    in the compute dtype. Under autograd each block is rematerialized as
    `cfg.remat` says."""
    cdt = cfg.compute_dtype
    h = shard(torch.matmul(frame_embeds.to(cdt), params["frame_proj"].to(cdt)), "residual")
    positions = torch.arange(h.shape[1], device=h.device)
    block = _remat(_enc_block, cfg)
    for i in range(_n_layers(params["enc_blocks"])):
        h = block(_index(params["enc_blocks"], i), h, cfg, positions)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps)


def apply_encdec(params: dict, batch: Dict, cfg: ModelConfig, *, last_only: bool = False):
    """batch: frame_embeds [B, T, D], tokens [B, S] → (logits [B, S, Vpad]
    f32 — [B, 1, Vpad] with last_only — and the aux dict: the MoE keys at
    zero, as the reference's)."""
    memory = encode(params, batch["frame_embeds"], cfg)
    h = shard(embed_lookup(params["embed"], batch["tokens"], cfg.compute_dtype), "residual")
    positions = torch.arange(h.shape[1], device=h.device)
    block = _remat(_dec_block, cfg)
    for i in range(_n_layers(params["dec_blocks"])):
        h = block(_index(params["dec_blocks"], i), h, memory, cfg, positions)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if last_only:
        h = h[:, -1:]
    h = shard(h, "hidden")
    aux = {k: replicate_like(torch.zeros((), dtype=torch.float32, device=h.device), h)
           for k in _AUX_KEYS}
    return shard(logits_from_hidden(h, params["lm_head"], cfg.vocab_size), "logits"), aux


def encdec_loss(params: dict, batch: Dict, cfg: ModelConfig):
    """Cross entropy of the decoder's logits at `labels` (−1 masked) →
    (loss, metrics: ce and the aux keys at zero). Differentiable."""
    logits, aux = apply_encdec(params, batch, cfg)
    ce = masked_ce(logits, batch["labels"])
    return ce, {"ce": ce, **aux}


# ---------------------------------------------------------------------------
# decode: the self-attention cache written in place, the cross cache once
# ---------------------------------------------------------------------------

def init_encdec_cache(batch: int, max_len: int, mem_len: int, cfg: ModelConfig, *,
                      device=None) -> dict:
    """Zeroed caches in the compute dtype: self K/V of `max_len` positions,
    cross K/V of `mem_len` (`fill_cross_cache` replaces the latter)."""
    dev = resolve_device(device)

    def kv(s: int) -> torch.Tensor:
        return torch.zeros((cfg.n_layers, batch, s, cfg.n_kv_heads, cfg.head_dim_),
                           dtype=cfg.compute_dtype, device=dev)

    return {"self_k": kv(max_len), "self_v": kv(max_len),
            "cross_k": kv(mem_len), "cross_v": kv(mem_len)}


def fill_cross_cache(params: dict, memory: torch.Tensor, cache: dict, cfg: ModelConfig) -> dict:
    """Project the encoder memory [B, T, D] through every decoder layer's
    cross K/V once → the cache with 'cross_k' / 'cross_v' REPLACED by [L, B,
    T, Hkv, hd] tensors (whatever length `init_encdec_cache` gave them), so
    decode attends exactly the T memory rows."""
    cdt = cfg.compute_dtype
    b, t, _ = memory.shape
    cross = params["dec_blocks"]["cross"]

    def project(w: str, bias: str) -> torch.Tensor:
        x = torch.matmul(memory, cross[w].to(cdt)[:, None])  # [L, B, T, Hkv·hd]
        if cfg.qkv_bias:
            x = x + cross[bias].to(cdt)[:, None, None]
        return x.reshape(x.shape[0], b, t, cfg.n_kv_heads, cfg.head_dim_)

    return {**cache, "cross_k": project("wk", "bk"), "cross_v": project("wv", "bv")}


def _cross_decode(p: dict, x, cfg: ModelConfig, k_cache, v_cache, attend):
    """One query row against the cached memory K/V [B, T, Hkv, hd], every
    row of it visible (cache_len T): no RoPE, no q norm, as the reference."""
    cdt = cfg.compute_dtype
    b = x.shape[0]
    q = torch.matmul(x, p["wq"].to(cdt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(cdt)
    q = q.reshape(b, 1, cfg.n_heads, cfg.head_dim_)
    mem_len = torch.full((b,), k_cache.shape[1], dtype=torch.long, device=x.device)
    o = attend(q, k_cache, v_cache, mem_len)
    return torch.matmul(o.reshape(b, 1, cfg.n_heads * cfg.head_dim_), p["wo"].to(cdt))


def decode_step_encdec(params: dict, cache: dict, token: torch.Tensor, pos: torch.Tensor,
                       cfg: ModelConfig):
    """One decoder step against the cached memory. token [B], pos [B] →
    (logits [B, Vpad] f32, cache), the self cache written in place at pos.
    Both attentions run through K2 on the card (`ops.get_op("decode")`),
    the plain `decode_attention` under `flashd_plain` or on the CPU."""
    pos = pos.long()
    h = embed_lookup(params["embed"], token[:, None], cfg.compute_dtype)
    if uses_kernel(cfg.attn_impl, h):
        from repro_torch.kernels import ops  # lazy: no cycle

        attend = ops.get_op("decode")
    else:
        attend = decode_attention
    for i in range(_n_layers(params["dec_blocks"])):
        bp = _index(params["dec_blocks"], i)
        x = rms_norm(h, bp["norm1"], cfg.norm_eps)
        self_kv = {"k": cache["self_k"][i], "v": cache["self_v"][i]}  # views: written in place
        h = h + _decode_attn(bp["mixer"], x, cfg, "attn", self_kv, pos)
        x = rms_norm(h, bp["norm_cross"], cfg.norm_eps)
        h = h + _cross_decode(bp["cross"], x, cfg, cache["cross_k"][i], cache["cross_v"][i],
                              attend)
        h = _apply_ffn(bp, h, cfg, "swiglu")[0]
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return logits_from_hidden(h, params["lm_head"], cfg.vocab_size)[:, 0], cache
