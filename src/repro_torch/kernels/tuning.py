"""Tile / split / page heuristics — copied verbatim from
`repro/kernels/tuning.py`, so the plain versions and the engine make the
reference's choices and engine-level parity is exact.

These closed forms were sized for a TPU core's VMEM; on the H100 they
only decide what the plain versions and the reference-facing APIs do. The
Hopper kernels' own tiles and splits live in their launch configs
(`kernels/flashd_fwd.py`, `kernels/flashd_decode.py`). `measure_best` /
`measured_decode_split` (timed on the JAX backend) come with later
slices.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.blockwise import MaskSpec

__all__ = [
    "PrefillTiling",
    "DecodeSplit",
    "RingSchedule",
    "PageLayout",
    "VarlenBlocks",
    "choose_prefill_blocks",
    "choose_decode_split",
    "choose_ring_schedule",
    "choose_page_size",
    "choose_page_layout",
    "choose_cache_policy",
    "choose_varlen_blocks",
    "bucket_pow2",
    "padded_rows",
    "prefill_vmem_bytes",
    "decode_vmem_bytes",
    "VMEM_BUDGET_BYTES",
]

# ~16 MB VMEM per TPU core (v4/v5e); leave headroom for double buffering,
# spills and the compiler's own scratch.
VMEM_BYTES_PER_CORE = 16 * 1024 * 1024
VMEM_BUDGET_BYTES = VMEM_BYTES_PER_CORE // 2

_LANE = 128  # MXU/VPU lane width — tiles want multiples of this
_MIN_BLOCK = 8  # f32 sublane minimum


@dataclasses.dataclass(frozen=True)
class PrefillTiling:
    block_q: int
    block_k: int


@dataclasses.dataclass(frozen=True)
class DecodeSplit:
    n_splits: int
    split: int


@dataclasses.dataclass(frozen=True)
class RingSchedule:
    """Static schedule for ring context-parallel prefill (DESIGN.md §4.1).

    n_hops    — live hops; hop h puts each device's KV shard h shards
                behind its q shard, so structured masks make distant hops
                statically dead (a prefix of the ring suffices).
    block_q/k — per-shard kernel tiling (from the prefill heuristics at
                the shard shape).
    """

    n_hops: int
    block_q: int
    block_k: int


def prefill_vmem_bytes(block_q: int, block_k: int, d: int, dv: int) -> int:
    """f32 working set of one fwd grid step: q + k + v + acc + Λ + scores."""
    words = (
        block_q * d          # q tile
        + block_k * d        # k tile
        + block_k * dv       # v tile
        + block_q * dv       # acc scratch
        + block_q            # Λ scratch
        + block_q * block_k  # score tile
    )
    return 4 * words


def decode_vmem_bytes(
    split: int, d: int, dv: int, group: int, *, kv_itemsize: int = 4
) -> int:
    """Working set of one decode grid step: q + k + v + carry + scores.

    Everything is f32 except the K/V split, which is `kv_itemsize` bytes
    per element (1 for an int8/fp8 quantized page pool). A quantized tile
    also DMAs its per-page scale side-band (two f32 scalars)."""
    f32_words = (
        group * d            # q block
        + group * dv         # acc carry
        + group              # Λ carry
        + group * split      # score tile
    )
    kv_words = split * d + split * dv  # k split + v split
    side_band = 2 * 4 if kv_itemsize < 4 else 0  # k/v page scales
    return 4 * f32_words + kv_itemsize * kv_words + side_band


def _shrink_to_lane(n: int) -> int:
    """Largest multiple of _LANE ≤ n (or n itself when already below one lane)."""
    if n <= _LANE:
        return max(n, 1)
    return (n // _LANE) * _LANE


def choose_prefill_blocks(
    sq: int,
    skv: int,
    d: int,
    dv: Optional[int] = None,
    *,
    vmem_budget: int = VMEM_BUDGET_BYTES,
) -> PrefillTiling:
    """Heuristic (block_q, block_k) for the tiled forward.

    Starts from the 512×512 sweet spot (MXU-saturating, small Λ overhead)
    and halves the larger block until the working set fits the budget.
    Blocks are clamped to the sequence lengths (short sequences should not
    pad to a full tile)."""
    dv = d if dv is None else dv
    block_q = min(512, max(sq, 1))
    block_k = min(512, max(skv, 1))
    while (
        prefill_vmem_bytes(block_q, block_k, d, dv) > vmem_budget
        and max(block_q, block_k) > _MIN_BLOCK
    ):
        if block_q >= block_k:
            block_q = max(_MIN_BLOCK, _shrink_to_lane(block_q // 2))
        else:
            block_k = max(_MIN_BLOCK, _shrink_to_lane(block_k // 2))
    return PrefillTiling(block_q=block_q, block_k=block_k)


def choose_decode_split(
    s_max: int,
    d: int,
    dv: Optional[int] = None,
    *,
    group: int = 1,
    window: int = 0,
    chunk: int = 0,
    vmem_budget: int = VMEM_BUDGET_BYTES,
    kv_itemsize: int = 4,
) -> DecodeSplit:
    """Heuristic (n_splits, split) for split-K decode.

    The fused kernel walks splits sequentially with a VMEM carry, so the
    split length trades DMA pipelining granularity against VMEM footprint:
    long splits amortize issue overhead, short splits let masked (dead)
    regions be skipped at finer grain. Target 512 positions per split —
    shrunk until the KV block fits the budget, and never longer than the
    live mask region (window / chunk caches only ever attend that many).
    `kv_itemsize` is the stored K/V element width (1 for a quantized
    pool) — smaller elements let more positions fit one split."""
    dv = d if dv is None else dv
    s_max = max(s_max, 1)
    live = s_max
    if window > 0:
        live = min(live, window)
    if chunk > 0:
        live = min(live, chunk)

    split = min(512, s_max)
    while (
        decode_vmem_bytes(split, d, dv, group, kv_itemsize=kv_itemsize)
        > vmem_budget
        and split > _MIN_BLOCK
    ):
        split = max(_MIN_BLOCK, _shrink_to_lane(split // 2))
    # a split longer than the live region wastes masked work at its edges
    if live < split:
        split = max(_MIN_BLOCK, min(split, _shrink_to_lane(live) or live))
    n_splits = max(1, -(-s_max // split))
    split = -(-s_max // n_splits)  # actual padded split length
    return DecodeSplit(n_splits=n_splits, split=split)


def choose_ring_schedule(
    sq_shard: int,
    skv_shard: int,
    d: int,
    dv: Optional[int] = None,
    *,
    n_devices: int,
    mask: MaskSpec = MaskSpec("causal"),
    vmem_budget: int = VMEM_BUDGET_BYTES,
) -> RingSchedule:
    """Heuristic ring schedule for context-parallel prefill.

    At hop h every device's resident KV shard sits exactly h shards behind
    its q shard (canonical +1 ring rotation), so the hop's mask offset is
    the *static* value h·skv_shard and hop liveness is decidable at trace
    time: causal masks keep all n hops (wrapped shards are future ⇒ dead
    per-device, handled dynamically), a sliding window keeps only hops with
    h·S − (S−1) < window, chunked keeps hops inside the q chunk. Dead hops
    are a suffix of the ring (offsets grow monotonically), so the schedule
    is just the live-prefix length — later hops skip both the kernel and
    the KV wire transfer entirely.
    """
    n_hops = n_devices
    if mask.kind in ("causal", "local", "chunked"):
        n_hops = 0
        for h in range(n_devices):
            hop = dataclasses.replace(mask, q_offset=mask.q_offset + h * skv_shard)
            if hop.block_fully_masked(0, sq_shard, 0, skv_shard):
                break
            n_hops = h + 1
    tiling = choose_prefill_blocks(
        sq_shard, skv_shard, d, dv, vmem_budget=vmem_budget
    )
    return RingSchedule(
        n_hops=max(n_hops, 1), block_q=tiling.block_q, block_k=tiling.block_k
    )


@dataclasses.dataclass(frozen=True)
class PageLayout:
    """Paged KV-cache geometry (DESIGN.md §3.4): `page_size` tokens per
    page, `n_pages` pages in the pool (page 0 is the reserved garbage
    page), `pages_per_seq` block-table width covering max_len."""

    page_size: int
    n_pages: int
    pages_per_seq: int


def choose_page_size(
    max_len: int,
    d: int,
    dv: Optional[int] = None,
    *,
    group: int = 1,
    window: int = 0,
    chunk: int = 0,
    vmem_budget: int = VMEM_BUDGET_BYTES,
    kv_itemsize: int = 4,
) -> int:
    """Heuristic page size for the paged decode kernel.

    A page doubles as the kernel's split: each grid step DMAs one
    (page, d) K/V block through the block-table indirection and merges it
    into the FLASH-D carry. The competing pressures:

      * kernel: long pages amortize DMA issue overhead and keep the MXU
        fed — same force as the decode split heuristic;
      * allocator: internal fragmentation wastes up to page−1 tokens per
        live sequence, so serving many short sequences wants small pages;
      * radix cache: only FULL pages are cacheable, so a max-length
        sequence must span ≥ 2 pages or the prefix cache can never index
        anything (one page per sequence means the lone page is never
        "full" until the sequence retires at exactly max_len).

    We take the decode-split answer (VMEM-fitted, ≤ live mask region),
    cap it at 64 tokens — at that size the fragmentation bound is ≤ 63
    tokens/seq while a [64, d] tile still fills an MXU pass for d ≥ 128 —
    and additionally at max_len // 2 whenever max_len ≥ 16 (the ≥ 2 pages
    guarantee above; below 16 tokens a useful cache granule doesn't exist
    and kernel efficiency wins), then round down to a power of two so page
    arithmetic (pos // page, pos % page) stays cheap on the scalar core."""
    split = choose_decode_split(
        max_len, d, dv, group=group, window=window, chunk=chunk,
        vmem_budget=vmem_budget, kv_itemsize=kv_itemsize,
    ).split
    size = min(64, split, max(max_len, 1))
    if max_len >= 16:
        size = min(size, max_len // 2)
    return max(_MIN_BLOCK // 2, 1 << (max(size, 1).bit_length() - 1))


def choose_page_layout(
    max_len: int,
    d: int,
    dv: Optional[int] = None,
    *,
    group: int = 1,
    pool_tokens: int,
    page_size: Optional[int] = None,
    vmem_budget: int = VMEM_BUDGET_BYTES,
    kv_itemsize: int = 4,
) -> PageLayout:
    """Full pool geometry for a token budget: pages covering `pool_tokens`
    plus the reserved garbage page (id 0, the write target of dead batch
    slots — never allocated)."""
    page = page_size or choose_page_size(
        max_len, d, dv, group=group, vmem_budget=vmem_budget,
        kv_itemsize=kv_itemsize,
    )
    n_pages = max(2, -(-pool_tokens // page) + 1)
    return PageLayout(
        page_size=page, n_pages=n_pages, pages_per_seq=-(-max_len // page)
    )


def choose_cache_policy(
    n_pages: int,
    page_size: int,
    *,
    min_free_pages: Optional[int] = None,
    max_cached_pages: Optional[int] = None,
):
    """Retention heuristics for the radix prefix cache (DESIGN.md §3.6).

    The cache trades pool headroom for prefill reuse, and the two knobs
    bound each side of that trade:

      * min_free_pages — eviction watermark. Donations evict LRU entries
        until this many pages are physically free, so a fresh admission
        usually finds pages without paying eviction latency on its own
        critical path. Default: 1/16 of the pool (≥ 1) — small enough
        that a hot shared prefix survives, large enough that the common
        single-page admission never blocks on eviction.
      * max_cached_pages — hard cap on retained pages. Default: the whole
        usable pool — retention is free (cached pages are reclaimed on
        demand before anything else gives), so the only reason to cap
        below that is to bound the host-side tree walk; callers serving
        adversarial (never-repeating) traffic can set it low or to 0 to
        disable retention.

    Explicit values are honored as given (0 is meaningful: a 0 watermark
    never proactively evicts; a 0 cap disables retention)."""
    from repro_torch.runtime.kvcache import CachePolicy  # lazy: no cycle

    if min_free_pages is None:
        min_free_pages = max(1, n_pages // 16)
    if max_cached_pages is None:
        max_cached_pages = max(n_pages - 1, 0)
    return CachePolicy(
        min_free_pages=min_free_pages, max_cached_pages=max_cached_pages
    )


@dataclasses.dataclass(frozen=True)
class VarlenBlocks:
    """Tiling for the packed varlen kernel (DESIGN.md §3.5): `block_q`
    packed rows per q tile (segments are aligned to this, so it is also the
    per-sequence padding granularity of the packed layout)."""

    block_q: int


def varlen_vmem_bytes(
    block_q: int, page: int, d: int, dv: int, group: int,
    *, kv_itemsize: int = 4,
) -> int:
    """Working set of one varlen grid step: q + k + v + carry + scores.
    The q tile carries `group` heads per row (GQA rows collapse into the
    score matmul), the KV block is one page — stored at `kv_itemsize`
    bytes per element (1 when the page pool is quantized, plus the
    two-scalar f32 scale side-band)."""
    rows = block_q * group
    f32_words = (
        rows * d          # q tile
        + rows * dv       # acc carry
        + rows            # Λ carry
        + rows * page     # score tile
    )
    kv_words = page * d + page * dv  # k page + v page
    side_band = 2 * 4 if kv_itemsize < 4 else 0  # k/v page scales
    return 4 * f32_words + kv_itemsize * kv_words + side_band


def choose_varlen_blocks(
    total_tokens: int,
    d: int,
    dv: Optional[int] = None,
    *,
    group: int = 1,
    page: int = 64,
    segment_hint: Optional[int] = None,
    vmem_budget: int = VMEM_BUDGET_BYTES,
    kv_itemsize: int = 4,
) -> VarlenBlocks:
    """Heuristic block_q for the packed varlen kernel.

    Larger q tiles amortize the page DMA over more rows, but every
    SEGMENT of the pack pads to a block multiple — a decode row (q_len 1)
    wastes block_q − 1 rows — so the tile must be sized to the typical
    segment, not the pack: `segment_hint` is the caller's expected tokens
    per segment (the scheduler passes 1 when decode rows share its packs,
    the prefill chunk when they don't, and K+1 when speculative verify
    segments dominate — a K=4 draft chain in a 128-row tile would waste
    123 rows, in its pow2 bucket (floor `_MIN_BLOCK`) it wastes ≤ 3;
    default: the whole pack, the single-segment case). Start from
    min(128, bucket(hint)) and halve until the working set fits the
    budget; floor at the f32 sublane minimum so alignment waste stays
    proportionate."""
    dv = d if dv is None else dv
    hint = max(min(segment_hint or total_tokens, total_tokens), 1)
    block_q = min(128, bucket_pow2(hint, lo=_MIN_BLOCK))
    while (
        varlen_vmem_bytes(block_q, page, d, dv, group, kv_itemsize=kv_itemsize)
        > vmem_budget
        and block_q > _MIN_BLOCK
    ):
        block_q = max(_MIN_BLOCK, block_q // 2)
    return VarlenBlocks(block_q=block_q)


def padded_rows(seg_len: int, block_q: int) -> int:
    """Pack rows one segment of `seg_len` tokens occupies: the packed
    layout aligns every segment to a `block_q` multiple so each q tile
    owns exactly one sequence (kernels/flashd_varlen.py). The engine's
    packer and the waste-pinning tests share this so the padding
    arithmetic can't drift between them."""
    if seg_len <= 0:
        return 0
    return -(-seg_len // block_q) * block_q


def bucket_pow2(n: int, *, lo: int = 8, hi: Optional[int] = None) -> int:
    """Smallest power of two ≥ n (clamped to [lo, hi]).

    The static-shape bucketing primitive (DESIGN.md §3.5): padding dynamic
    lengths — prompt lengths, packed-batch sizes — up to a power of two
    bounds the number of distinct compiled programs at O(log max_len)
    instead of one per distinct length. `hi` caps the bucket (a length
    already at the cap compiles exactly one program); a cap SMALLER than
    `n` would silently truncate the caller's batch, so it raises."""
    n = max(int(n), 1)
    if hi is not None and hi < n:
        raise ValueError(f"bucket_pow2: hi={hi} < n={n} would truncate")
    b = max(1 << (n - 1).bit_length(), lo)
    if hi is not None:
        b = min(b, hi)
    return b
