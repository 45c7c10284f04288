"""Blockwise (tiled) FLASH-D in plain PyTorch — the port of
`repro/core/blockwise.py`.

A query block scans KV tiles carrying only (O, Λ):

    W_b = sigmoid(λ_b − Λ_{b−1})          tile weight (paper's w_i per tile)
    Λ_b = λ_b − ln W_b                    running LSE, division-free
    c_b = exp(m_b − Λ_b)                  ≤ 1 ⇒ overflow-impossible
    O_b = O_{b−1}·(1−W_b) + (P_b V_b)·c_b

The reference's functions are single-head and vmapped; here every function
takes any number of leading (broadcastable) batch dims, so one call covers
[B, Hkv, G, S, d] queries against [B, Hkv, 1, S, d] keys. All rows of the
query are processed together: rows are independent, so the q tiling of the
reference changes nothing but which fully-masked tiles it prunes, and a KV
tile masked for every row is an exact identity update here too.

`blockwise_fa2` and `blockwise_backward` come with the FA2 baseline and the
training slice (queue items K6 and K5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

__all__ = [
    "NEG_INF",
    "DEFAULT_SKIP_THETA",
    "MaskSpec",
    "tile_live",
    "blockwise_flashd",
    "merge_pair",
    "merge_partials",
]

NEG_INF = -1e30  # finite stand-in for -inf in masked scores (NaN-safe)
DEFAULT_SKIP_THETA = 6.0  # paper §III-C active-region lower edge
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Structural attention mask, evaluated per (q, k) position block.

    kind:
      'full'    — no mask (encoder / cross attention)
      'causal'  — k_pos <= q_pos
      'local'   — causal sliding window: 0 <= q_pos − k_pos < window
      'chunked' — causal within chunks of `chunk` tokens (llama4-style)
    q_offset: absolute position of q row 0 (decode: cache length).
    """

    kind: str = "causal"
    window: int = 0
    chunk: int = 0
    q_offset: int = 0

    def keep(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> Optional[torch.Tensor]:
        """Bool [len(q_pos), len(k_pos)] of visible pairs, None when all are."""
        if self.kind == "full":
            return None
        qp = (q_pos + self.q_offset)[:, None]
        kp = k_pos[None, :]
        if self.kind == "causal":
            return kp <= qp
        if self.kind == "local":
            return (kp <= qp) & (qp - kp < self.window)
        if self.kind == "chunked":
            return (kp <= qp) & (torch.div(qp, self.chunk, rounding_mode="floor")
                                 == torch.div(kp, self.chunk, rounding_mode="floor"))
        raise ValueError(f"unknown mask kind {self.kind!r}")

    def block_bias(self, q_pos: torch.Tensor, k_pos: torch.Tensor) -> Optional[torch.Tensor]:
        """Additive f32 bias [len(q_pos), len(k_pos)] or None when fully visible."""
        keep = self.keep(q_pos, k_pos)
        if keep is None:
            return None
        zero = torch.zeros((), dtype=torch.float32, device=keep.device)
        return torch.where(keep, zero, torch.full_like(zero, NEG_INF))

    def block_fully_visible(self, q_lo: int, q_hi: int, k_lo: int, k_hi: int) -> bool:
        """Static check: is the [q_lo:q_hi, k_lo:k_hi] tile unmasked?"""
        if self.kind == "full":
            return True
        q_lo, q_hi = q_lo + self.q_offset, q_hi + self.q_offset
        if self.kind == "causal":
            return k_hi - 1 <= q_lo
        if self.kind == "local":
            return (k_hi - 1 <= q_lo) and (q_hi - 1 - k_lo < self.window)
        if self.kind == "chunked":
            return (k_hi - 1 <= q_lo) and (
                q_lo // self.chunk == (q_hi - 1) // self.chunk
                == k_lo // self.chunk == (k_hi - 1) // self.chunk
            )
        raise ValueError(self.kind)

    def block_fully_masked(self, q_lo: int, q_hi: int, k_lo: int, k_hi: int) -> bool:
        """Static check: is the tile entirely masked (skippable)?"""
        if self.kind == "full":
            return False
        q_lo, q_hi = q_lo + self.q_offset, q_hi + self.q_offset
        if self.kind in ("causal", "local", "chunked") and k_lo > q_hi - 1:
            return True
        if self.kind == "local" and q_lo - (k_hi - 1) >= self.window:
            return True
        if self.kind == "chunked" and q_lo // self.chunk > (k_hi - 1) // self.chunk:
            return True
        return False


def tile_live(mask: MaskSpec, iq: int, ik: int, block_q: int, block_k: int, kv_len: int) -> bool:
    """Is tile (iq, ik) possibly inside the mask? The predicate the Hopper
    forward kernel evaluates per CTA and the plain versions use to prune
    (`kv_len` bounds the key axis for 'full' masks)."""
    if mask.kind in ("causal", "local", "chunked"):
        live = ik * block_k <= iq * block_q + block_q - 1 + mask.q_offset
        if mask.kind == "local":
            live = live and (iq * block_q + mask.q_offset) - (ik * block_k + block_k - 1) < mask.window
        if mask.kind == "chunked":
            live = live and ((iq * block_q + mask.q_offset) // mask.chunk
                             <= (ik * block_k + block_k - 1) // mask.chunk)
        return live
    return ik * block_k < kv_len


def _tile_stats(s: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-row (m_safe, p, λ_b) of a score tile with NaN-safe full-mask rows."""
    m = s.amax(dim=-1)
    m_safe = torch.clamp(m, min=NEG_INF / 2)  # fully-masked row ⇒ exp() = 0 below
    p = torch.exp(s - m_safe[..., None])
    l = p.sum(dim=-1)
    lam = m_safe + torch.log(torch.clamp(l, min=_TINY))
    lam = torch.where(l > 0, lam, torch.full_like(lam, NEG_INF))
    return m_safe, p, lam


def blockwise_flashd(
    q: torch.Tensor,  # [..., Sq, d]
    k: torch.Tensor,  # [..., Skv, d]   (leading dims broadcast against q's)
    v: torch.Tensor,  # [..., Skv, dv]
    *,
    mask: MaskSpec = MaskSpec("full"),
    scale: Optional[float] = None,
    block_q: int = 128,
    block_k: int = 128,
    skip: bool = False,
    skip_theta: float = DEFAULT_SKIP_THETA,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled FLASH-D forward. Returns (O [..., Sq, dv], Λ [..., Sq]) in f32.

    `skip=True` applies the tile-level criterion of the paper's [−6, 11]
    active region: a row whose tile max lies below Λ − θ − ln(block_k)
    keeps its carry. The threshold depends on `block_k`, so a kernel is
    compared with this function at its own block_k. `block_q` only sets
    which tiles are pruned as fully masked for every row."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    sq, skv = q.shape[-2], k.shape[-2]
    qf, kf, vf = q.float(), k.float(), v.float()
    lead = torch.broadcast_shapes(q.shape[:-2], k.shape[:-2])
    dv = v.shape[-1]
    o = torch.zeros(*lead, sq, dv, dtype=torch.float32, device=q.device)
    lam = torch.full((*lead, sq), NEG_INF, dtype=torch.float32, device=q.device)
    if sq == 0:
        return o, lam
    ln_bk = math.log(block_k)
    q_pos = torch.arange(sq, device=q.device)
    n_qb = -(-sq // block_q)
    for ik in range(-(-skv // block_k)):
        # a tile dead for every q block is an exact identity update: prune it
        if not any(tile_live(mask, iq, ik, block_q, block_k, skv) for iq in range(n_qb)):
            continue
        k0, k1 = ik * block_k, min((ik + 1) * block_k, skv)
        s = torch.matmul(qf, kf[..., k0:k1, :].transpose(-1, -2)) * scale
        keep = mask.keep(q_pos, torch.arange(k0, k1, device=q.device))
        if keep is not None:
            s = torch.where(keep, s, torch.full_like(s, NEG_INF))
        m_b, p, lam_b = _tile_stats(s)

        delta = lam_b - lam
        w = torch.sigmoid(delta)
        lam_new = lam_b - torch.nn.functional.logsigmoid(delta)  # logaddexp, no division
        tile_dead = lam_b <= NEG_INF / 2
        first = lam <= NEG_INF / 2
        w = torch.where(tile_dead, 0.0, torch.where(first, 1.0, w))
        lam_new = torch.where(tile_dead, lam, torch.where(first, lam_b, lam_new))
        c = torch.where(tile_dead, 0.0, torch.exp(m_b - lam_new))  # ≤ 1 always
        o_new = o * (1.0 - w)[..., None] + torch.matmul(p, vf[..., k0:k1, :]) * c[..., None]
        if skip:
            skip_row = (m_b - lam < -(skip_theta + ln_bk)) & ~first
            o_new = torch.where(skip_row[..., None], o, o_new)
            lam_new = torch.where(skip_row, lam, lam_new)
        o, lam = o_new, lam_new
    return o, lam


def merge_pair(a, b):
    """One FLASH-D blend of two attention partials: (o_a, Λ_a) ⊕ (o_b, Λ_b).

    o = o_a + (o_b − o_a)·σ(Λ_b − Λ_a). Associative and commutative in
    (O, Λ); dead partials (Λ ≤ NEG_INF/2) are identity elements."""
    o_a, lam_a = a
    o_b, lam_b = b
    dead_b = lam_b <= NEG_INF / 2
    dead_a = lam_a <= NEG_INF / 2
    w = torch.sigmoid(lam_b - lam_a)
    w = torch.where(dead_b, 0.0, torch.where(dead_a, 1.0, w))
    o = o_a + (o_b - o_a) * w[..., None]
    ln_w1 = torch.nn.functional.logsigmoid(lam_a - lam_b)  # ln(1−w)
    lam = torch.where(dead_b, lam_a, torch.where(dead_a, lam_b, lam_a - ln_w1))
    return o, lam


def merge_partials(o_parts: torch.Tensor, lam_parts: torch.Tensor):
    """FLASH-D merge of split-K partials: o_parts [P, ..., dv], lam_parts
    [P, ...] → (o, Λ), reduced as the reference's log-depth pairwise tree
    (odd leftovers ride up to the next level)."""
    o, lam = o_parts, lam_parts
    while o.shape[0] > 1:
        n = o.shape[0]
        half = n // 2
        pair = merge_pair(
            (o[0: 2 * half: 2], lam[0: 2 * half: 2]),
            (o[1: 2 * half: 2], lam[1: 2 * half: 2]),
        )
        if n % 2:
            o = torch.cat([pair[0], o[-1:]], dim=0)
            lam = torch.cat([pair[1], lam[-1:]], dim=0)
        else:
            o, lam = pair
    return o[0], lam[0]
