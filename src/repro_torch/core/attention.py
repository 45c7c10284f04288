"""Public attention ops — the port of `repro/core/attention.py`.

`flash_attention`  — prefill: [B, S, H, d] tensors, forward only.
`decode_attention` — single-token decode against a KV cache with dynamic
                     length: split-K partials merged with the FLASH-D
                     sigmoid blend (plain PyTorch).

impl ∈ {'flashd', 'flashd_gpu', 'flashd_plain', 'naive'}:
  flashd        — a CUDA tensor launches the K1 kernel, a CPU tensor takes
                  the plain tiled recurrence (the default).
  flashd_gpu    — always the kernel; raises on a CPU tensor. The bridge maps
                  the reference's 'flashd_pallas' here.
  flashd_plain  — the plain tiled recurrence on any device (tests and
                  chip_smoke.py hold the kernel against it).
  naive         — the O(S²) softmax oracle.

The kernel path is forward-only: it refuses inputs that require grad
(the backward comes with the training slice, A11). 'fa2', 'xla' and the
context-parallel routes (`maybe_ring_prefill`, `maybe_cp_decode`) are not
ported yet (K6, A13).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.blockwise import NEG_INF, MaskSpec, merge_partials

__all__ = ["flash_attention", "decode_attention", "uses_kernel", "MaskSpec", "IMPLS"]

IMPLS = ("flashd", "flashd_gpu", "flashd_plain", "naive")


def uses_kernel(impl: str, x: torch.Tensor) -> bool:
    """Does `impl` launch the CUDA kernels for tensors like `x`?"""
    if impl not in IMPLS:
        raise ValueError(f"attention impl {impl!r} not ported (have {IMPLS})")
    return impl == "flashd_gpu" or (impl == "flashd" and x.is_cuda)


def _naive(q, k, v, mask: MaskSpec, scale: float):
    """O(S²) softmax with the dead-row convention, model layout in and out."""
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
    return o.reshape(b, hq, sq, -1).transpose(1, 2).to(q.dtype)


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

    block_q / block_k = None resolves the plain path's tiling from the
    reference heuristics (`tuning.choose_prefill_blocks`). The kernel keeps
    its own tiles; with skip on it is handed `block_k`, which must then be
    ≤ 64 (the skip threshold depends on it)."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("expected [batch, seq, heads, dim] operands")
    if q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"Hq={q.shape[2]} not a multiple of Hkv={k.shape[2]}")
    if scale is None:
        scale = float(1.0 / math.sqrt(q.shape[-1]))
    if uses_kernel(impl, q):
        from repro_torch.kernels import ops  # lazy: avoid import cycle

        o, _ = ops.get_op("attention_fwd")(
            q, k, v, mask=mask, scale=scale, block_k=block_k if skip else None, skip=skip,
        )
        return o
    if impl == "naive":
        return _naive(q, k, v, mask, scale)
    from repro_torch.kernels.flashd_fwd import flashd_fwd_plain  # lazy: avoid cycle

    o, _ = flashd_fwd_plain(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        mask=mask, scale=scale, block_q=block_q, block_k=block_k, skip=skip,
    )
    return o.transpose(1, 2)


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
