"""K2 — FLASH-D split-K decode on the H100, and its plain PyTorch version.

Replaces the Pallas TPU kernel
`repro/kernels/flashd_decode.py::flashd_decode_pallas` (fused
`_decode_fused_kernel`, unfused `_decode_unfused_kernel`, shared
`_split_partial`, `_lo_bound`, `_split_live`, `_merge_into_carry`). The
CUDA source is `csrc/flashd_decode.cu`. The paged variant (K3,
`flashd_decode_paged_pallas`) is the next slice.

Design. On the TPU the splits were the innermost sequential grid axis with
the merge carry in VMEM. Here each call is two launches: parallel split
CTAs over (split, kv head, batch row) that read only the live part of
their split from the [B, S_max, Hkv, d] cache (by stride — the reference's
per-layer, per-step transpose copy of the whole cache at `ops.py:210`
disappears) and write (o_p, λ_p) partials; then a merge kernel that blends
them with the sigmoid in split order, the same order as the fused Pallas
carry. `fused=False` instead merges the partials with the port's
`merge_partials` tree, so the two orders can be held against each other.

Bound. One query row per head: decode is a pass over the live KV bytes, so
memory bandwidth bounds it. G = Hq/Hkv can be 1, below any tensor-core
tile, so the dot products are f32 FMA; each K row is read once for all G
heads of its group, and splits of `GPU_SPLIT` positions spread one long
sequence over many SMs.

`launches` counts wrapper calls that launched the kernel pair (split
kernel, then the merge kernel when fused).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.core.blockwise import NEG_INF, merge_pair, merge_partials
from repro_torch.kernels.flashd_fwd import check_operands, check_no_grad

__all__ = [
    "flashd_decode",
    "flashd_decode_plain",
    "gpu_decode_splits",
    "GPU_SPLIT",
    "MAX_GROUP",
    "launches",
]

GPU_SPLIT = 128  # cache positions per split CTA when n_splits is not given
MAX_GROUP = 8  # G_MAX in the source

launches = 0
_fns = None


def gpu_decode_splits(s_max: int) -> int:
    """The kernel's own split count: ⌈S_max / GPU_SPLIT⌉ (the TPU heuristic
    in `tuning.choose_decode_split` sized splits for VMEM; here the point is
    enough CTAs per sequence to fill the SMs)."""
    return max(1, -(-s_max // GPU_SPLIT))


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
        split_fn = lib.flashd_decode_split_launch
        split_fn.argtypes = [P] * 7 + [L] * 8 + [I] * 10 + [F, P]
        split_fn.restype = I
        merge_fn = lib.flashd_decode_merge_launch
        merge_fn.argtypes = [P] * 4 + [I] * 5 + [P]
        merge_fn.restype = I
        _fns = (split_fn, merge_fn)
    return _fns


def _device_lengths(name: str, x: torch.Tensor, b: int, device) -> torch.Tensor:
    if not isinstance(x, torch.Tensor) or x.device != device:
        raise ValueError(f"flashd_decode: {name} must be a tensor on {device} "
                         "(a host value would need a copy per call)")
    if x.numel() != b:
        raise ValueError(f"flashd_decode: {name} has {x.numel()} entries for batch {b}")
    return x.reshape(b).to(torch.int32).contiguous()


def flashd_decode(
    q: torch.Tensor,  # [B, Hq, d]  — any strides with a contiguous head dim
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
    return_lam). n_splits=None takes `gpu_decode_splits(S_max)`."""
    global launches
    b, hq, d = q.shape
    _, hkv, s_max, dv = v_cache.shape
    check_operands("flashd_decode", (q, k_cache, v_cache), d)
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
    n_splits = gpu_decode_splits(s_max) if n_splits is None else n_splits
    n_splits = max(1, min(n_splits, s_max))
    split = -(-s_max // n_splits)

    o_part = torch.empty((n_splits, b, hq, dv), dtype=torch.float32, device=dev)
    lam_part = torch.empty((n_splits, b, hq), dtype=torch.float32, device=dev)
    split_fn, merge_fn = _launchers()
    stream = torch.cuda.current_stream(dev).cuda_stream
    is_bf16 = int(q.dtype == torch.bfloat16)
    rc = split_fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cache_len.data_ptr(),
        None if start is None else start.data_ptr(),
        o_part.data_ptr(), lam_part.data_ptr(),
        q.stride(0), q.stride(1),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        b, hq, hkv, s_max, d, is_bf16, n_splits, split, window, chunk,
        float(scale), stream,
    )
    launches += 1
    if rc != 0:
        raise RuntimeError(f"flashd_decode: CUDA error {rc} at the split launch")
    if not fused:
        o, lam = merge_partials(o_part, lam_part)
        o = o.to(q.dtype)
        return (o, lam) if return_lam else o
    o = torch.empty((b, hq, dv), dtype=q.dtype, device=dev)
    lam = torch.empty((b, hq), dtype=torch.float32, device=dev) if return_lam else None
    rc = merge_fn(
        o_part.data_ptr(), lam_part.data_ptr(), o.data_ptr(),
        None if lam is None else lam.data_ptr(),
        n_splits, b, hq, dv, is_bf16, stream,
    )
    if rc != 0:
        raise RuntimeError(f"flashd_decode: CUDA error {rc} at the merge launch")
    return (o, lam) if return_lam else o

