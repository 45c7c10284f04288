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
descriptors. Here one launch runs a CTA per (q block × row group of 64
live rows, kv head, kv split), the split count from shapes only
(`gpu_varlen_splits`); a row group takes up to 64 / (block_q·G)
consecutive blocks of one sequence, so a whole prompt at block_q 8 fills
four warps. A split is a run of logical positions, and a CTA
reads only the part of its run below kv_len that some row of its can see
(the reference's conservative rules), staging K/V by 16-byte cp.async
through the table. Rows with q_pos < 0 are not computed: one CTA writes
them as exact zeros, and an all-padding block is only those zeros. A CTA
with fewer than 16 live rows per kv head (decode rows, short verify
segments) runs K3's CUDA-core body, masking each row at its own q_pos; one
with 16 or more (prefill chunks, whole prompts) runs the tensor cores
(`csrc/attn_tc.cuh`'s products: bf16 with P rounded to bf16, f32 as
3xTF32) with K1's FLASH-D carry. The last CTA of a (row group, kv head) to
arrive blends the live partials in split order, so repeated calls are
bitwise equal. Every operand's base and strides must be multiples of 16
bytes (`check_copy_alignment`).

Bound. A mixed step has few query rows per sequence, so the work is close
to one pass over the live pages — memory bandwidth bounds it, as for
decode — and a long whole prompt tips it toward K1's operation bound.

`launches` counts wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.blockwise import NEG_INF, merge_pair
from repro_torch.kernels.flashd_decode import CTAS_PER_SM, H100_SMS, _DTYPE_CODES, check_pool

__all__ = ["flashd_varlen", "flashd_varlen_plain", "gpu_varlen_splits", "launches"]

ROW_GROUP = 64  # live rows per CTA (RB in the source): four 16-row mma tiles
MAX_GROUP_BLOCKS = 8  # a row group takes at most 8 q blocks of one sequence
SPLIT_STEP = 64  # a split is a multiple of 64 positions: one tile or chunk …
MAX_SPLITS = 64  # … and there are at most 64 of them (the merge holds their weights)

launches = 0
_fn = None


def _row_groups(block_q: int, group: int):
    """(row groups a q block, q blocks a row group, partial rows a CTA):
    a block of block_q·G ≥ 64 rows is cut into groups of 64; smaller blocks
    join up to 64 / (block_q·G) of them (at most MAX_GROUP_BLOCKS)."""
    rows = block_q * group
    bpg = min(MAX_GROUP_BLOCKS, max(1, ROW_GROUP // rows))
    return -(-rows // ROW_GROUP), bpg, min(ROW_GROUP, rows * bpg)


def gpu_varlen_splits(n_blocks: int, block_q: int, group: int, hkv: int, s_max: int,
                      n_sm: int = H100_SMS) -> int:
    """K4's split count, a function of shapes only (no device sync): the
    CTAs of a split that can hold rows (row groups × Hkv, counting groups
    of joined blocks as one) get enough splits to put CTAS_PER_SM CTAs on
    every SM, a split being a multiple of SPLIT_STEP positions, at most
    MAX_SPLITS of them. At the mixed step's pack (T 64, block_q 8, G 2, Hkv
    8, S 512) that is 8 splits of 64; a pack of four 512-token prompts at
    block_q 8 (64 groups of 4 blocks) takes 2 splits of 256."""
    rg, bpg, _ = _row_groups(block_q, group)
    ctas = -(-n_blocks // bpg) * rg * hkv
    want = -(-CTAS_PER_SM * n_sm // max(ctas, 1))
    split = max(-(-s_max // want), -(-s_max // MAX_SPLITS))
    split = max(-(-split // SPLIT_STEP) * SPLIT_STEP, SPLIT_STEP)
    return -(-max(s_max, 1) // split)


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
    k_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32 — byte pool (int8, fp8)
    v_scale: Optional[torch.Tensor] = None,
    n_splits: Optional[int] = None,
) -> torch.Tensor:
    """K4's function in plain PyTorch: for every q block, its sequence's
    positions in runs, each run's normalized partial (`_varlen_partial`)
    blended in order into the (acc, Λ) carry. The default run is a page,
    the reference's per-page carry; `n_splits` takes the kernel's order,
    runs of ⌈N·page / n_splits⌉ positions. Positions past a sequence's
    kv_len are zeroed before use (dead table slots may point at a page
    holding anything). → o [T, Hq, dv] in q.dtype."""
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
    from repro_torch.core.attention import gather_pages  # lazy: no cycle

    dev = q.device
    nb = t // block_q
    s_max = n_tbl * page
    run = page if n_splits is None else -(-s_max // max(1, min(n_splits, s_max)))
    seq_ids = torch.as_tensor(seq_ids, device=dev).long()
    q_pos = torch.as_tensor(q_pos, device=dev).long().reshape(nb, block_q)
    kv_len = torch.as_tensor(kv_len, device=dev).reshape(-1).long()
    blk_seq = seq_ids[::block_q]
    seq = torch.clamp(blk_seq, min=0)
    blk_len = torch.where(blk_seq >= 0, kv_len[seq], 0)  # [nb]; padding blocks see nothing
    kc = gather_pages(k_pages, block_tbl, scales=k_scale)  # [B, S, Hkv, d], dequantized
    vc = gather_pages(v_pages, block_tbl, scales=v_scale)

    qf = q.float().reshape(nb, block_q, hkv, g, d).permute(0, 2, 1, 3, 4)
    qf = qf.reshape(nb, hkv, block_q * g, d)  # rows ordered (t, g), as the TPU tile
    rows_pos = q_pos.repeat_interleave(g, dim=1)[:, None, :, None]  # [nb, 1, R, 1]
    acc = torch.zeros((nb, hkv, block_q * g, dv), dtype=torch.float32, device=dev)
    lam = torch.full((nb, hkv, block_q * g), NEG_INF, dtype=torch.float32, device=dev)
    for lo in range(0, s_max, run):
        pos = torch.arange(lo, min(lo + run, s_max), device=dev)
        inside = (pos[None, :] < blk_len[:, None])[:, :, None, None]  # [nb, run, 1, 1]
        k = torch.where(inside, kc[seq, lo:lo + run].float(), 0.0).permute(0, 2, 1, 3)
        v = torch.where(inside, vc[seq, lo:lo + run].float(), 0.0).permute(0, 2, 1, 3)
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
        fn.argtypes = [P] * 13 + [L] * 11 + [I] * 16 + [F, P]
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
    q: torch.Tensor,  # [T, Hq, d] — 16-byte strides, a contiguous head dim
    k_pages: torch.Tensor,  # [P, page, Hkv, d] — 16-byte strides
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
    k_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32 — byte pool (int8, fp8)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K4. Returns o [T, Hq, d] in q.dtype. T must be a multiple of
    `block_q`, the granularity the packer aligned segments to. The split
    count is `gpu_varlen_splits` for this card."""
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
    g = hq // hkv
    s_max = n_tbl * page
    nb = t // block_q
    n_splits = gpu_varlen_splits(nb, block_q, g, hkv, s_max,
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
    split = -(-s_max // n_splits)
    rg, bpg, rb = _row_groups(block_q, g)  # the launcher checks them against its tile
    o = torch.empty((t, hq, d), dtype=q.dtype, device=dev)
    o_part = lam_part = arrivals = None
    if n_splits > 1:
        nbr = nb * rg
        o_part = torch.empty((n_splits, nbr, hkv, rb, d), dtype=torch.float32, device=dev)
        lam_part = torch.empty((n_splits, nbr, hkv, rb), dtype=torch.float32, device=dev)
        arrivals = torch.empty((nbr * hkv,), dtype=torch.int32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    rc = _launcher()(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), o.data_ptr(),
        block_tbl.data_ptr(), seq_ids.data_ptr(), q_pos.data_ptr(), kv_len.data_ptr(),
        ptr(ks), ptr(vs), ptr(o_part), ptr(lam_part), ptr(arrivals),
        q.stride(0), q.stride(1), o.stride(0), o.stride(1),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2), block_tbl.stride(0),
        t, hq, hkv, n_tbl, page, block_q, d, _DTYPE_CODES[q.dtype], kv_type, window, chunk,
        rg, bpg, rb, n_splits, split, float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"flashd_varlen: CUDA error {rc} at launch")
    return o
