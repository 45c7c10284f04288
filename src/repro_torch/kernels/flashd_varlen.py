"""K4 — packed varlen FLASH-D over a paged KV cache on the H100, and its
plain PyTorch version.

Replaces the Pallas TPU kernel
`repro/kernels/flashd_varlen.py::flashd_varlen_pallas` (`_varlen_kernel`,
`_varlen_partial`, the carry blend `_merge_into_carry`). The CUDA source
is `csrc/flashd_varlen.cu`.

The packing contract is the reference's: q [T, Hq, d] holds segments of
many sequences, each aligned to `block_q` rows, so every q block belongs
to one sequence (`seq_ids[::block_q]`); padding rows carry seq_id −1 and
q_pos −1 and come back as exact zeros. A prefill chunk is a segment of
q_len rows, a decode token a one-row segment: one kernel for the mixed
serving step.

Design. The TPU's (q block, kv head, logical page) grid carried (acc, Λ)
along the sequential page axis, with the table lookup in the DMA
descriptors. Here a CTA owns ≤ 32 of a q block's block_q·G rows of one kv
head and loops over the block's sequence's pages itself, reading
tbl[seq, ip] only for pages below kv_len, in tiles of ≤ 64 keys with K1's
tile body; each tile's normalized partial is blended into the carry with
the sigmoid merge. A page no row of the CTA can see is skipped (the
reference's conservative rule); a whole padding block reads nothing.

Bound. A mixed step has few query rows per sequence, so the work is close
to one pass over the live pages — memory bandwidth bounds it, as for
decode — and a long whole prompt tips it toward K1's operation bound. The
products are f32 FMA on the CUDA cores (G can be 1); tensor cores are
later work.

`launches` counts wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.blockwise import NEG_INF, merge_pair
from repro_torch.kernels.flashd_decode import _DTYPE_CODES, check_pool

__all__ = ["flashd_varlen", "flashd_varlen_plain", "launches"]

launches = 0
_fn = None


def flashd_varlen_plain(
    q: torch.Tensor,  # [T, Hq, d] — packed, block_q-aligned segments
    k_pages: torch.Tensor,  # [P, page, Hkv, d] — global page pool
    v_pages: torch.Tensor,  # [P, page, Hkv, dv]
    block_tbl: torch.Tensor,  # [B, N] int
    seq_ids: torch.Tensor,  # [T] int (−1 = padding row)
    q_pos: torch.Tensor,  # [T] int absolute position in KV space (−1 = padding)
    kv_len: torch.Tensor,  # [B] int per-sequence visible KV length
    *,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
    block_q: int,
    k_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32 — int8 pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K4's function in plain PyTorch: for every q block, the logical pages
    of its sequence in order, each page's normalized partial
    (`_varlen_partial`) blended into the (acc, Λ) carry. Positions past a
    sequence's kv_len are zeroed before use (dead table slots may point at
    a page holding anything). → o [T, Hq, dv] in q.dtype."""
    t, hq, d = q.shape
    _, page, hkv, dv = v_pages.shape
    n_tbl = block_tbl.shape[1]
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    if t % block_q:
        raise ValueError(f"packed length {t} not a multiple of block_q={block_q}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    dev = q.device
    nb = t // block_q
    seq_ids = torch.as_tensor(seq_ids, device=dev).long()
    q_pos = torch.as_tensor(q_pos, device=dev).long().reshape(nb, block_q)
    kv_len = torch.as_tensor(kv_len, device=dev).reshape(-1).long()
    tbl = block_tbl.long()
    blk_seq = seq_ids[::block_q]
    seq = torch.clamp(blk_seq, min=0)
    blk_len = torch.where(blk_seq >= 0, kv_len[seq], 0)  # [nb]; padding blocks see nothing

    qf = q.float().reshape(nb, block_q, hkv, g, d).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(nb, hkv, block_q * g, d)  # rows ordered (t, g), as the TPU tile
    rows_pos = q_pos.repeat_interleave(g, dim=1)[:, None, :, None]  # [nb, 1, R, 1]
    acc = torch.zeros((nb, hkv, block_q * g, dv), dtype=torch.float32, device=dev)
    lam = torch.full((nb, hkv, block_q * g), NEG_INF, dtype=torch.float32, device=dev)
    for ip in range(n_tbl):
        lo = ip * page
        pid = tbl[seq, ip]  # [nb]
        pos = lo + torch.arange(page, device=dev)
        inside = (pos[None, :] < blk_len[:, None])[:, :, None, None]  # [nb, page, 1, 1]
        k = k_pages[pid].float()
        v = v_pages[pid].float()
        if k_scale is not None:  # dequant in the tile: one scale per (page, head)
            k = k * k_scale[pid][:, None, :, None]
            v = v * v_scale[pid][:, None, :, None]
        k = torch.where(inside, k, 0.0).permute(0, 2, 1, 3)  # [nb, Hkv, page, d]
        v = torch.where(inside, v, 0.0).permute(0, 2, 1, 3)
        s = torch.einsum("bhrd,bhkd->bhrk", qf, k) * scale
        keep = (pos[None, None, None, :] < blk_len[:, None, None, None]) & (
            pos[None, None, None, :] <= rows_pos)
        if window > 0:
            keep &= rows_pos - pos[None, None, None, :] < window
        if chunk > 0:
            keep &= (torch.div(rows_pos, chunk, rounding_mode="floor")
                     == torch.div(pos, chunk, rounding_mode="floor")[None, None, None, :])
        s = torch.where(keep, s, NEG_INF)
        m_safe = torch.clamp(s.amax(dim=-1), min=NEG_INF / 2)
        p = torch.exp(s - m_safe[..., None])
        l = p.sum(dim=-1)
        lam_p = torch.where(
            l > 0, m_safe + torch.log(torch.clamp(l, min=torch.finfo(torch.float32).tiny)),
            NEG_INF,
        )
        c = torch.where(l > 0, torch.exp(m_safe - lam_p), 0.0)
        o_p = torch.einsum("bhrk,bhkd->bhrd", p, v) * c[..., None]
        acc, lam = merge_pair((acc, lam), (o_p, lam_p))
    o = acc.reshape(nb, hkv, block_q, g, dv).permute(0, 2, 1, 3, 4)
    return o.reshape(t, hq, dv).to(q.dtype)


def _launcher():
    global _fn
    if _fn is None:
        from repro_torch.kernels._build import load

        fn = load("flashd_varlen").flashd_varlen_launch
        P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        fn.argtypes = [P] * 10 + [L] * 11 + [I] * 11 + [F, P]
        fn.restype = I
        _fn = fn
    return _fn


def _int32_on(name: str, x: torch.Tensor, n: int, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"flashd_varlen: {name} must be a tensor on {device}")
    if x.numel() != n:
        raise ValueError(f"flashd_varlen: {name} has {x.numel()} entries, expected {n}")
    return x.reshape(n).to(torch.int32).contiguous()


def flashd_varlen(
    q: torch.Tensor,  # [T, Hq, d] — any strides with a contiguous head dim
    k_pages: torch.Tensor,  # [P, page, Hkv, d]
    v_pages: torch.Tensor,  # [P, page, Hkv, d]
    block_tbl: torch.Tensor,  # [B, N] int32, on the card
    seq_ids: torch.Tensor,  # [T] int, on the card
    q_pos: torch.Tensor,  # [T] int, on the card
    kv_len: torch.Tensor,  # [B] int, on the card
    *,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
    block_q: int,
    k_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32 — int8 pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K4. Returns o [T, Hq, d] in q.dtype. T must be a multiple of
    `block_q`, the granularity the packer aligned segments to."""
    global launches
    t, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    kv_type, ks, vs = check_pool("flashd_varlen", q, k_pages, v_pages, block_tbl,
                                 k_scale, v_scale)
    if block_tbl.ndim != 2 or hq % hkv or block_q < 1 or t % block_q:
        raise ValueError(f"flashd_varlen: q {tuple(q.shape)}, table {tuple(block_tbl.shape)}, "
                         f"Hkv {hkv}, block_q {block_q} (T must be a multiple of block_q)")
    dev = q.device
    b, n_tbl = block_tbl.shape
    seq_ids = _int32_on("seq_ids", seq_ids, t, dev)
    q_pos = _int32_on("q_pos", q_pos, t, dev)
    kv_len = _int32_on("kv_len", kv_len, b, dev)
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    o = torch.empty((t, hq, d), dtype=q.dtype, device=dev)
    rc = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
        block_tbl.data_ptr(), seq_ids.data_ptr(), q_pos.data_ptr(), kv_len.data_ptr(),
        None if ks is None else ks.data_ptr(), None if vs is None else vs.data_ptr(),
        q.stride(0), q.stride(1), o.stride(0), o.stride(1),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2), block_tbl.stride(0),
        t, hq, hkv, n_tbl, page, block_q, d, _DTYPE_CODES[q.dtype], kv_type, window, chunk,
        float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"flashd_varlen: CUDA error {rc} at launch")
    return o
