"""Serving runtime of the port: the paged KV allocator (a copy of
`repro/runtime/kvcache.py`). The reference's checkpoint and resilience
modules come with later slices (A10, A11)."""

from repro_torch.runtime.kvcache import (
    CachePolicy,
    CowCopy,
    PagedKVAllocator,
    PageError,
    PrefixMatch,
    pages_for,
)

__all__ = ["CachePolicy", "CowCopy", "PagedKVAllocator", "PageError", "PrefixMatch", "pages_for"]
