"""K2 and K3 — FLASH-D split-K decode on the H100, contiguous and paged,
and their plain PyTorch versions.

K2 replaces the Pallas TPU kernel
`repro/kernels/flashd_decode.py::flashd_decode_pallas` (fused
`_decode_fused_kernel`, unfused `_decode_unfused_kernel`, shared
`_split_partial`, `_lo_bound`, `_split_live`, `_merge_into_carry`). K3
(`flashd_decode_paged`) replaces `flashd_decode_paged_pallas`
(`_decode_paged_kernel`). Both live in `csrc/flashd_decode.cu`.

Bound. One query row per head: decode is a pass over the live KV bytes,
so memory bandwidth bounds it (live K/V bytes over 3.35 TB/s). G = Hq/Hkv
can be 1, below any tensor-core tile, so the dot products are f32 FMA.

K2's design keeps HBM busy. On the TPU the splits were the innermost
sequential grid axis with the merge carry in VMEM. Here one launch runs a
CTA per (split, kv head, batch row): `gpu_decode_splits` sizes the splits
from (B, Hkv, S_max, the SM count) so that 2–4 CTAs sit on every SM; each
CTA copies its split's live K and V rows (by stride — the reference's
per-layer, per-step transpose copy of the whole cache at `ops.py:210`
disappears) into shared memory with 16-byte asynchronous copies, all in
flight at once, then reads 16 bytes a lane for the scores (reduced by
shuffles over the lanes of a row) and for P·V (registers per warp, then a
fixed-order sum over warps). The last CTA of each (batch row, kv head) to
finish — an arrival counter picks it — blends the partials with the
sigmoid in split order, the same order as the fused Pallas carry, so
repeated calls are bitwise equal. `fused=False` instead merges the
partials with the port's `merge_partials` tree, so the two orders can be
held against each other. Every operand's base and batch / head / row
strides must be multiples of 16 bytes (`check_copy_alignment`).

K3 (`flashd_decode_paged`) is the same kernel over a page pool
[P, page, Hkv, d]: one launch of a CTA per (split, kv head, batch row), the
splits sized by `gpu_decode_splits` over S_max = N·page, so a split is a run
of logical positions — several small pages, or a part of a 64-token page.
The thread that copies row i reads the table entry tbl[b, i // page]
itself (the TPU resolved it in its DMA descriptors), only for live rows, so
dead slots (page 0 in the engine) are never followed. An int8 pool with
per-(page, head) f32 scales is staged as bytes and dequantized as it is
read, before the scores. The partials merge in split order in the launch,
as K2's. Same bound as K2.

`launches` counts K2 wrapper calls that launched the kernel;
`paged_launches` counts K3 wrapper calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.blockwise import NEG_INF, merge_pair, merge_partials
from repro_torch.kernels.flashd_fwd import check_copy_alignment, check_no_grad, check_operands

__all__ = [
    "flashd_decode",
    "flashd_decode_plain",
    "gpu_decode_splits",
    "flashd_decode_paged",
    "flashd_decode_paged_plain",
    "MAX_GROUP",
    "launches",
    "paged_launches",
]

MAX_GROUP = 8  # G_MAX in the source
CTAS_PER_SM = 4  # K2's target of split CTAs per SM
SPLIT_STEP = 16  # K2's default splits: multiples of 16 positions …
MAX_ROWS = 64  # … up to the rows a CTA stages at once (k2 chunk)
H100_SMS = 132

launches = 0
paged_launches = 0
_fns = None


def gpu_decode_splits(b: int, hkv: int, s_max: int, n_sm: int = H100_SMS) -> int:
    """K2's and K3's split count (K3: s_max = N·page), a function of shapes
    only (no device sync).

    The TPU heuristic (`tuning.choose_decode_split`) sized splits for VMEM;
    here the point is enough CTAs to keep every SM's copies in flight: the
    (B · Hkv) rows of the grid get ⌈CTAS_PER_SM · n_sm / (B · Hkv)⌉ splits
    each, a split being a multiple of SPLIT_STEP positions between
    SPLIT_STEP and MAX_ROWS. At the engine's decode shape (B 4, Hkv 8,
    S_max 512) that is 16 splits of 32: 512 CTAs, 3.9 per SM."""
    if s_max <= 1:
        return 1
    want = -(-CTAS_PER_SM * n_sm // max(b * hkv, 1))
    split = -(-s_max // want)
    split = min(max(-(-split // SPLIT_STEP) * SPLIT_STEP, SPLIT_STEP), MAX_ROWS)
    return -(-s_max // split)


def _lo_bound(cache_len, start, *, window: int, chunk: int):
    lo = torch.clamp(start, min=0)
    if window > 0:
        lo = torch.maximum(lo, cache_len - window)
    if chunk > 0:
        lo = torch.maximum(lo, torch.div(cache_len - 1, chunk, rounding_mode="floor") * chunk)
    return lo


def flashd_decode_plain(
    q: torch.Tensor,  # [B, Hq, d]
    k_cache: torch.Tensor,  # [B, Hkv, S_max, d]
    v_cache: torch.Tensor,  # [B, Hkv, S_max, dv]
    cache_len: torch.Tensor,  # [B] int
    *,
    scale: Optional[float] = None,
    n_splits: Optional[int] = None,
    window: int = 0,
    chunk: int = 0,
    start: Optional[torch.Tensor] = None,
    fused: bool = True,
    return_lam: bool = False,
):
    """The kernel's function in plain PyTorch: `_split_partial` per split,
    then the in-order carry (`fused=True`) or the `merge_partials` tree.
    n_splits=None takes the reference's `tuning.choose_decode_split`."""
    b, hq, d = q.shape
    _, hkv, s_max, dv = v_cache.shape
    g = hq // hkv
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    if n_splits is None:
        from repro_torch.kernels.tuning import choose_decode_split

        n_splits = choose_decode_split(s_max, d, dv, group=g, window=window, chunk=chunk).n_splits
    n_splits = max(1, min(n_splits, s_max))
    split = -(-s_max // n_splits)
    dev = q.device
    cache_len = torch.as_tensor(cache_len, device=dev).reshape(b, 1).long()
    start = (torch.zeros_like(cache_len) if start is None
             else torch.as_tensor(start, device=dev).reshape(b, 1).long())
    lo_bound = _lo_bound(cache_len, start, window=window, chunk=chunk)
    qf = q.float().reshape(b, hkv, g, d)

    o_parts, lam_parts = [], []
    for ip in range(n_splits):
        lo, hi = ip * split, min((ip + 1) * split, s_max)
        pos = torch.arange(lo, max(hi, lo), device=dev)
        s = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache[:, :, lo:hi].float()) * scale
        keep = (pos[None, :] >= lo_bound) & (pos[None, :] < cache_len)  # [B, split]
        s = torch.where(keep[:, None, None, :], s, NEG_INF)
        m = s.amax(dim=-1) if s.shape[-1] else torch.full(s.shape[:-1], NEG_INF, device=dev)
        m_safe = torch.clamp(m, min=NEG_INF / 2)
        p = torch.exp(s - m_safe[..., None])
        l = p.sum(dim=-1)
        lam = torch.where(
            l > 0, m_safe + torch.log(torch.clamp(l, min=torch.finfo(torch.float32).tiny)),
            NEG_INF,
        )
        pv = torch.einsum("bhgs,bhsd->bhgd", p, v_cache[:, :, lo:hi].float())
        c = torch.where(l > 0, torch.exp(m_safe - lam), 0.0)  # ⇒ pv·c = softmax·V
        o_parts.append(pv * c[..., None])
        lam_parts.append(lam)

    if fused:  # the TPU kernel's sequential carry, in split order
        acc = (torch.zeros_like(o_parts[0]), torch.full_like(lam_parts[0], NEG_INF))
        for part in zip(o_parts, lam_parts):
            acc = merge_pair(acc, part)
        o, lam = acc
    else:
        o, lam = merge_partials(torch.stack(o_parts), torch.stack(lam_parts))
    o = o.reshape(b, hq, dv).to(q.dtype)
    if return_lam:
        return o, lam.reshape(b, hq)
    return o


def _launchers():
    global _fns
    if _fns is None:
        from repro_torch.kernels._build import load

        lib = load("flashd_decode")
        P, L, I, F = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
        decode_fn = lib.flashd_decode_launch
        decode_fn.argtypes = [P] * 10 + [L] * 8 + [I] * 11 + [F, P]
        decode_fn.restype = I
        paged_fn = lib.flashd_decode_paged_launch
        paged_fn.argtypes = [P] * 11 + [L] * 9 + [I] * 13 + [F, P]
        paged_fn.restype = I
        _fns = (decode_fn, paged_fn)
    return _fns


def _device_lengths(name: str, x: torch.Tensor, b: int, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"flashd_decode: {name} must be a tensor on {device} "
                         "(a host value would need a copy per call)")
    if x.numel() != b:
        raise ValueError(f"flashd_decode: {name} has {x.numel()} entries for batch {b}")
    return x.reshape(b).to(torch.int32).contiguous()


def flashd_decode(
    q: torch.Tensor,  # [B, Hq, d]  — 16-byte strides, a contiguous head dim
    k_cache: torch.Tensor,  # [B, Hkv, S_max, d]  — e.g. a transposed [B, S, Hkv, d] view
    v_cache: torch.Tensor,  # [B, Hkv, S_max, d]
    cache_len: torch.Tensor,  # [B] int, on the card
    *,
    scale: Optional[float] = None,
    n_splits: Optional[int] = None,
    window: int = 0,
    chunk: int = 0,
    start: Optional[torch.Tensor] = None,  # [B] inclusive lower bound
    fused: bool = True,
    return_lam: bool = False,
):
    """Launch K2. Returns o [B, Hq, d] in q.dtype (and Λ [B, Hq] f32 with
    return_lam). n_splits=None takes `gpu_decode_splits` for this card."""
    global launches
    b, hq, d = q.shape
    _, hkv, s_max, dv = v_cache.shape
    check_operands("flashd_decode", (q, k_cache, v_cache), d)
    check_copy_alignment("flashd_decode", (q, k_cache, v_cache))
    check_no_grad(q, k_cache, v_cache)
    if k_cache.shape != (b, hkv, s_max, d) or dv != d or hq % hkv:
        raise ValueError(f"flashd_decode: shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)} (needs d == dv, Hq % Hkv == 0)")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"flashd_decode: group {hq // hkv} > {MAX_GROUP} not built")
    dev = q.device
    cache_len = _device_lengths("cache_len", cache_len, b, dev)
    start = None if start is None else _device_lengths("start", start, b, dev)
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    if n_splits is None:
        n_splits = gpu_decode_splits(b, hkv, s_max,
                                     torch.cuda.get_device_properties(dev).multi_processor_count)
    n_splits = max(1, min(n_splits, s_max))
    split = -(-s_max // n_splits)
    rows = min(-(-split // 4) * 4, MAX_ROWS)  # the CTA's chunk: the split, or 64-row chunks

    o_part = torch.empty((n_splits, b, hq, dv), dtype=torch.float32, device=dev)
    lam_part = torch.empty((n_splits, b, hq), dtype=torch.float32, device=dev)
    o = lam = arrivals = None
    if fused:
        o = torch.empty((b, hq, dv), dtype=q.dtype, device=dev)
        lam = torch.empty((b, hq), dtype=torch.float32, device=dev) if return_lam else None
        arrivals = torch.empty((b * hkv,), dtype=torch.int32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = _launchers()[0](
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(), ptr(start),
        o_part.data_ptr(), lam_part.data_ptr(), ptr(o), ptr(lam), ptr(arrivals),
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        b, hq, hkv, s_max, d, int(q.dtype == torch.bfloat16), n_splits, split, rows,
        window, chunk, float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"flashd_decode: CUDA error {rc} at launch")
    if not fused:
        o, lam = merge_partials(o_part, lam_part)
        o = o.to(q.dtype)
    return (o, lam) if return_lam else o


# ---------------------------------------------------------------------------
# K3: paged variant — K2's kernel with its rows through the block table
# ---------------------------------------------------------------------------

def flashd_decode_paged_plain(
    q: torch.Tensor,  # [B, Hq, d]
    k_pages: torch.Tensor,  # [P, page, Hkv, d] — global page pool
    v_pages: torch.Tensor,  # [P, page, Hkv, dv]
    block_tbl: torch.Tensor,  # [B, N] int — physical page of logical page j
    cache_len: torch.Tensor,  # [B] int
    *,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
    k_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32 — int8 pool
    v_scale: Optional[torch.Tensor] = None,
    n_splits: Optional[int] = None,
) -> torch.Tensor:
    """K3's function in plain PyTorch: gather the table's pages (dequantized
    with the scales), zero every position past cache_len (dead table slots
    may point at a page holding anything), then `flashd_decode_plain` with
    the in-order carry over `n_splits` runs of ⌈N·page / n_splits⌉
    positions. The default, one split per page, is the reference's
    per-page carry; the kernel's own order is
    `n_splits=gpu_decode_splits(B, Hkv, N·page, SMs)`."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    from repro_torch.core.attention import _zero_past, gather_pages  # lazy: no cycle

    b, n_tbl = block_tbl.shape
    cache_len = torch.as_tensor(cache_len, device=q.device).reshape(b)
    kc = _zero_past(gather_pages(k_pages, block_tbl, scales=k_scale), cache_len)
    vc = _zero_past(gather_pages(v_pages, block_tbl, scales=v_scale), cache_len)
    return flashd_decode_plain(
        q, kc.transpose(1, 2), vc.transpose(1, 2), cache_len, scale=scale,
        n_splits=n_tbl if n_splits is None else n_splits, window=window, chunk=chunk,
        fused=True,
    )


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def check_pool(name: str, q: torch.Tensor, k_pages: torch.Tensor, v_pages: torch.Tensor,
               block_tbl: torch.Tensor, k_scale, v_scale):
    """Checks shared by the paged kernels (K3, K4), which copy q rows and
    pool rows by 16-byte cp.async (`check_copy_alignment`). Returns the
    pool's dtype code and the scales as contiguous f32 (or None)."""
    check_operands(name, (q,), q.shape[-1])
    check_no_grad(q, k_pages, v_pages)
    for t in (k_pages, v_pages, block_tbl):
        if t.device != q.device:
            raise ValueError(f"{name}: operands must be on one device ({q.device})")
    if k_pages.shape != v_pages.shape or k_pages.dtype != v_pages.dtype:
        raise ValueError(f"{name}: k/v pools differ: {tuple(k_pages.shape)} {k_pages.dtype}, "
                         f"{tuple(v_pages.shape)} {v_pages.dtype} (needs d == dv)")
    if k_pages.shape[-1] != q.shape[-1] or k_pages.stride(-1) != 1 or v_pages.stride(-1) != 1:
        raise ValueError(f"{name}: pool head dim {k_pages.shape[-1]} (q {q.shape[-1]}) must "
                         "match and be contiguous")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("k_scale and v_scale must be passed together")
    if quantized != (k_pages.dtype == torch.int8) or (
            not quantized and k_pages.dtype != q.dtype):
        raise ValueError(f"{name}: pool dtype {k_pages.dtype} with q {q.dtype}: an int8 pool "
                         "needs k_scale/v_scale, any other pool q's dtype")
    check_copy_alignment(name, (q, k_pages, v_pages))
    if block_tbl.dtype != torch.int32 or not block_tbl.is_contiguous():
        raise ValueError(f"{name}: block_tbl must be a contiguous int32 tensor on the card")
    if not quantized:
        return _DTYPE_CODES[k_pages.dtype], None, None
    p, hkv = k_pages.shape[0], k_pages.shape[2]
    scales = []
    for sc in (k_scale, v_scale):
        if sc.shape != (p, hkv) or sc.device != q.device:
            raise ValueError(f"{name}: scales must be [P={p}, Hkv={hkv}] on {q.device}")
        scales.append(sc.float().contiguous())
    return 2, scales[0], scales[1]


def flashd_decode_paged(
    q: torch.Tensor,  # [B, Hq, d] — 16-byte strides, a contiguous head dim
    k_pages: torch.Tensor,  # [P, page, Hkv, d] — 16-byte strides
    v_pages: torch.Tensor,  # [P, page, Hkv, d]
    block_tbl: torch.Tensor,  # [B, N] int32, on the card
    cache_len: torch.Tensor,  # [B] int, on the card
    *,
    scale: Optional[float] = None,
    window: int = 0,
    chunk: int = 0,
    k_scale: Optional[torch.Tensor] = None,  # [P, Hkv] f32 — int8 pool
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K3. Returns o [B, Hq, d] in q.dtype; the splits are
    `gpu_decode_splits(B, Hkv, N·page, SMs)` for this card."""
    global paged_launches
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    n_tbl = block_tbl.shape[1] if block_tbl.ndim == 2 else -1
    kv_type, ks, vs = check_pool("flashd_decode_paged", q, k_pages, v_pages, block_tbl,
                                 k_scale, v_scale)
    if block_tbl.shape != (b, n_tbl) or n_tbl < 1 or hq % hkv:
        raise ValueError(f"flashd_decode_paged: q {tuple(q.shape)}, table "
                         f"{tuple(block_tbl.shape)}, Hkv {hkv}")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"flashd_decode_paged: group {hq // hkv} > {MAX_GROUP} not built")
    dev = q.device
    cache_len = _device_lengths("cache_len", cache_len, b, dev)
    if scale is None:
        scale = float(1.0 / (d ** 0.5))
    s_max = n_tbl * page
    n_splits = gpu_decode_splits(b, hkv, s_max,
                                 torch.cuda.get_device_properties(dev).multi_processor_count)
    split = -(-s_max // n_splits)
    rows = min(-(-split // 4) * 4, MAX_ROWS)
    o_part = torch.empty((n_splits, b, hq, d), dtype=torch.float32, device=dev)
    lam_part = torch.empty((n_splits, b, hq), dtype=torch.float32, device=dev)
    o = torch.empty((b, hq, d), dtype=q.dtype, device=dev)
    arrivals = torch.empty((b * hkv,), dtype=torch.int32, device=dev)
    rc = _launchers()[1](
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tbl.data_ptr(),
        cache_len.data_ptr(), None if ks is None else ks.data_ptr(),
        None if vs is None else vs.data_ptr(),
        o_part.data_ptr(), lam_part.data_ptr(), o.data_ptr(), arrivals.data_ptr(),
        q.stride(0), q.stride(1),
        k_pages.stride(0), k_pages.stride(1), k_pages.stride(2),
        v_pages.stride(0), v_pages.stride(1), v_pages.stride(2), block_tbl.stride(0),
        b, hq, hkv, n_tbl, page, d, _DTYPE_CODES[q.dtype], kv_type, n_splits, split, rows,
        window, chunk, float(scale), torch.cuda.current_stream(dev).cuda_stream,
    )
    paged_launches += 1
    if rc != 0:
        raise RuntimeError(f"flashd_decode_paged: CUDA error {rc} at launch")
    return o
